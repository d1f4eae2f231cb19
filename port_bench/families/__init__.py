"""One module per model family: `families/<family>.py`, found by the file
name that a configuration file's `"family"` key gives (`danet` where the
key is absent; `harness/spec.py::load_family`). The serve harness
(`harness/serve.py`) does everything a serve cell does, and asks the
family for what one model does. A family module gives:

- `kinds`: the traffic kinds it has a harness for (`serve_closed`,
  `train_steps`);
- `configs(config, traffic, overrides) -> (port_cfg, ref_cfg)`: the port's
  and the reference's configuration from the configuration file, the
  traffic mix's operating point over it, and `overrides` (the CPU tests'
  small sizes) over both;
- `image_hw(cfg) -> (H, W)`: the size of the images a request carries;
- `port_server(cfg, ref_cfg, seed, dtype, device, smpl) -> predict`: the
  port's own serving entry with the seed's weights (the reference model's
  state dict, loaded as a checkpoint); `predict(images)` returns at least
  `para`, `vertices` and `joints`;
- `reference_model(ref_cfg, seed, device, served_dtype) -> nn.Module`: the
  plain reference under `port_bench/reference/` with the seed's weights
  (`harness/weights.py::fill_weights_`), rounded to `served_dtype`;
- `reference_outputs(model, smpl_t, images, block) -> {"para",
  "vertices", "joints"}`: fp32, in blocks of `block` images;
- `leaves(model)`: the draws, as `(tensor, 'n' or 'u', scale, shift)`,
  for the floating tensors that `fill_weights_`'s generic rules do not
  cover; `output_layers`: a regex of the module names whose weights start
  near zero (the heads); `left_to_construction`: the floating tensors,
  by name, that keep what the constructor made.

A new model adds its family module, its configuration file under
`configs/`, its plain reference under `reference/`, and its cells' traffic
and limits files; no file of the harness changes.
"""
