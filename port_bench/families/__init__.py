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

A serve family may also give these, each of which defaults to what DaNet
and HMR 2.0 do (`harness/serve.py`, set-up and `compare`, never the
timed window):

- `para_blocks(cfg) -> ((lo, hi), ...)`: the column blocks of `para` that
  the answer gaps and nearest ratios read, each against its own spread.
  Default `serve.PARA_BLOCKS`, ((0, 3), (3, 13), (13, 229)): camera,
  shape, rotations. For every family `compare` raises ValueError, naming
  the family and the first column left out or read twice, unless the
  blocks tile `para`'s columns from 0 to its width in order.
- `answers_per_image(cfg) -> n`: answers an image gives, as people in a
  frame. Default 1. `para` then holds B·n rows, image-major (the n
  answers of image 0 first), and every other compared output B·n rows or
  B (one an image, as a score map); the readings go over the answers.
  `serve_imgs_per_s` still counts images.
- `body_arrays(cfg)` and `body_to_device(arrays, device)`: the body model
  that `port_server`, the control and `reference_outputs` are given (as
  `smpl`, `smpl_t`), made by the family from a seed of its own. Default
  `serve.smpl_arrays()` (the synthetic SMPL) and the reference's
  `smpl.loader.to_torch`.
- `compared`: the names of the outputs compared, each read as `<out>`,
  `<out>_nearest`, `<out>_not_nearest` and `<out>_unexplained`, and
  `para` also as `para_median` and `para_p10`. Default `serve.COMPARED`,
  ("para", "vertices", "joints").
- `reference_conditioned`: true for a model that makes a discrete choice
  on the card (which patches are people). `compare` then runs the
  reference once for each sampled request, not once for each distinct
  batch, as `reference_outputs(model, smpl_t, images, block,
  served=<that request's outputs>)`, so it reads the port's choice there
  and answers for the same people; under the key `readings` it may return
  numbers of its own ({name: value}, the larger the worse, such as how far
  a chosen patch's reference score lies below the reference's own K-th
  best), merged into the readings, the largest over the requests. The
  controls make their own choice (`served` not given), which then
  conditions the fp32 reference. Default false: one reference for each
  distinct sampled batch, from the images alone.

A new model adds its family module, its configuration file under
`configs/`, its plain reference under `reference/`, and its cells' traffic
and limits files; no file of the harness changes. The toy families under
`tests/families/` use the interface: `toy.py` the required attributes
alone, `toy_people.py` (several people an image, a whole-body model of
its own, a score map compared, picks made on the card) every optional
one.
"""
