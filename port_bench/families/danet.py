"""The DaNet family: HRNet or PoseResNet IUV estimator, K1's part crops,
the GCN-refined SMPL regressor (the port's `models/danet.py::DaNet`
behind `serve.py::Predictor`; the reference's copy under
`port_bench/reference/models/danet.py`). A configuration file holds the
reference YAML's sections as JSON with lower-case keys: `danet`
(DaNetConfig's fields, `refinement` nested) and `solver`. A traffic mix
may override `danet` fields of the operating point it runs
(`compute_dtype`, `part_head_chunks`). The interface is
`families/__init__.py`'s; `harness/train.py` is DaNet's training harness."""

from __future__ import annotations

import re

import torch

from port_bench.harness.weights import derive_seed, fill_weights_, round_to_

kinds = ("serve_closed", "train_steps")
# the regressor's output layers (the body net's camera and shape layer, the
# rotation and position heads), which start near zero as a fresh HMR-style
# regressor does
output_layers = re.compile(r"iuv2smpl\.smpl_para_Outs\.(body_net\.\d+\.final_layer|pose_regressors\.\d+\.1"
                           r"|coord_regressors\.\d+\.1)$")
# the GCN's edge importance (ones), the STN's learned ratio and offset and
# the part mask, as the reference's constructor makes them
left_to_construction = ("iuv2smpl.smpl_para_Outs.edge_importance", "img2iuv.learned_ratio",
                        "img2iuv.learned_offset", "img2iuv.part_mask_t")


def leaves(model) -> list:
    """The generic rules draw every leaf of DaNet that gets a draw."""
    return []


def danet_fields(config: dict, traffic: dict) -> dict:
    """DaNetConfig keyword arguments of the configuration with the traffic
    mix's operating point over it (`refinement` still a dict)."""
    fields = dict(config["danet"])
    fields.update(traffic.get("danet", {}))
    return fields


def build_config(module, config: dict, traffic: dict, overrides: dict | None = None):
    """A `Config` of `module` (the port's `config` module or the
    reference's copy) from a configuration file and a traffic mix;
    `overrides` replaces DaNetConfig fields (the CPU tests' small sizes)."""
    fields = danet_fields(config, traffic)
    fields.update(overrides or {})
    refinement = module.RefinementConfig(**fields.pop("refinement", {}))
    danet = module.DaNetConfig(refinement=refinement, **fields)
    solver = config.get("solver", {})
    solver = module.SolverConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in solver.items()})
    return module.Config(solver=solver, danet=danet)


def configs(config: dict, traffic: dict, overrides: dict | None = None) -> tuple:
    from danet_densepose2smpl_tpu_torch import config as port_config
    from port_bench.reference import config as ref_config

    return (build_config(port_config, config, traffic, overrides),
            build_config(ref_config, config, traffic, overrides))


def image_hw(cfg) -> tuple[int, int]:
    return cfg.danet.img_size, cfg.danet.img_size


def reference_model(cfg, seed: int, device, served_dtype: torch.dtype = torch.float32):
    """The reference DaNet of `cfg` on `device` with the seed's weights,
    rounded to `served_dtype` (`round_to_`)."""
    from port_bench.reference.models.danet import DaNet

    torch.manual_seed(derive_seed(seed, "module-init"))   # leaves without a draw (constants) alike each time
    with torch.device(device):
        model = DaNet(cfg.danet)
    drawn = fill_weights_(model, seed, leaves(model), output_layers, left_to_construction)
    return round_to_(drawn, served_dtype)


def port_server(cfg_port, ref_cfg, seed: int, dtype: torch.dtype, device, smpl):
    """The system under test: the port's `Predictor.predict` with the
    seed's weights (the reference model's state dict, loaded as a
    checkpoint) and `smpl`'s arrays."""
    from danet_densepose2smpl_tpu_torch.models.danet import DaNet
    from danet_densepose2smpl_tpu_torch.serve import Predictor
    from danet_densepose2smpl_tpu_torch.smpl.loader import SMPLModel

    weights = reference_model(ref_cfg, seed, device).state_dict()
    with torch.device(device):
        model = DaNet(cfg_port.danet)
    model.load_state_dict(weights)
    del weights
    predictor = Predictor(device, dtype, model=model, smpl=SMPLModel(*smpl))
    return predictor.predict


def reference_outputs(model, smpl_t, images: torch.Tensor, block: int) -> dict:
    """The reference's para, vertices and joints of `images`, in blocks of
    `block` images, fp32."""
    from port_bench.reference.smpl.model import smpl_forward

    outs = {k: [] for k in ("para", "vertices", "joints")}
    for i in range(0, images.shape[0], block):
        out = model(images[i:i + block].float())
        body = smpl_forward(smpl_t, out["pred_shape"], out["pred_rotmat"])
        outs["para"].append(out["para"])
        outs["vertices"].append(body.vertices)
        outs["joints"].append(body.joints)
    return {k: torch.cat(v) for k, v in outs.items()}


def port_step(cfg, ref_cfg, seed: int, device, smpl, atlas, template):
    """The system under test of the training cells: the port's training
    state and step, with the seed's weights."""
    from danet_densepose2smpl_tpu_torch.kernels.rasterizer import IUVRenderer
    from danet_densepose2smpl_tpu_torch.models.danet import DaNet
    from danet_densepose2smpl_tpu_torch.smpl.densepose_atlas import DensePoseAtlas
    from danet_densepose2smpl_tpu_torch.smpl.loader import SMPLModel
    from danet_densepose2smpl_tpu_torch.train.step import create_train_state, make_train_step

    weights = reference_model(ref_cfg, seed, device).state_dict()
    with torch.device(device):
        model = DaNet(cfg.danet)
    model.load_state_dict(weights)
    del weights
    model = model.to(memory_format=torch.channels_last)
    state = create_train_state(model, cfg)
    renderer = IUVRenderer(DensePoseAtlas(*atlas), 224, cfg.danet.heatmap_size, cull_verts=template)
    step = make_train_step(model, SMPLModel(*smpl), cfg, renderer=renderer)
    return state, step
