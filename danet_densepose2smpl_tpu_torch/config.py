"""The configuration dataclasses of the port, and the YAML loader.

A copy of the JAX package's `core/config.py` classes with the same fields
and defaults (pinned by `tests/test_torch_config.py`), so that code driving
the port imports only the port. Frozen dataclasses, passed explicitly.
`load_config` reads the reference's YAML layout (`configs/*.yaml`) with
`yaml.safe_load` and applies dotted overrides.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class SolverConfig:
    base_lr: float = 1e-4
    steps: tuple = (0, 30000, 60000)   # LR decays 10x at each step boundary
    max_iter: int = 500000
    optimizer: str = "adam"


@dataclass(frozen=True)
class RefinementConfig:
    refine_on: bool = True
    stack_num: int = 1
    feat_dim: int = 128
    gcn_num_layer: int = 3
    pos_intersupv: bool = True


@dataclass(frozen=True)
class DaNetConfig:
    """Model architecture and loss-weight operating point (the reference
    YAML's `DANET:` block)."""

    img_size: int = 224
    heatmap_size: int = 56
    num_patches: int = 24
    decomposed: bool = True
    input_mode: str = "iuv"          # 'iuv' | 'iuv_gt' | 'iuv_feat' | 'iuv_gt_feat' | 'feat' | 'seg'
    use_6d_rot: bool = True
    iuv_regressor: str = "hrnet"     # 'hrnet' | 'resnet'
    glo_num_layers: int = 18         # body-net ResNet depth
    limb_num_layers: int = 18        # limb-net ResNet depth
    smpl_model_type: str = "neutral"
    gtcam_for_repj: bool = True
    gtshape_for_repj: bool = True

    # loss weights
    index_weights: float = 2.0             # 15-part ann seg CE
    part_weights: float = 0.3              # 25-patch point CE
    point_regression_weights: float = 0.5  # sparse UV smooth-l1
    smpl_pose_weights: float = 60.0
    smpl_betas_weights: float = 0.06
    proj_kps_weights: float = 300.0
    kps3d_weights: float = 300.0
    verts_weights: float = 0.0
    orthogonal_weights: float = 0.0
    joint_position_weights: float = 1.0
    stn_kps_weights: float = 1.0
    stn_hm_weights: float = 0.0

    # STN (joint-centric RoI pooling)
    stn_center_jitter: float = 0.1
    stn_scale_jitter: float = 0.2
    stn_part_vis_score: float = 0.5
    use_learned_ratio: bool = True
    partdrop_rate: float = 0.3

    refine_strategy: str = "gcn"     # 'gcn' | 'gcn_direct' | 'lstm' | 'lstm_direct'
    refinement: RefinementConfig = field(default_factory=RefinementConfig)

    # backbone
    msres_num_layers: int = 50       # PoseResNet depth when iuv_regressor='resnet'
    hrnet_width: int = 48
    hrnet_pad_channels: bool = False  # zero-pad the 48/96-ch HRNet branches to 64/128

    # numerics
    compute_dtype: str = "float32"   # 'bfloat16': mixed-precision training forward
    remat_backbone: bool = False     # recompute the IUV backbone in the backward (train mode)
    remat_scope: str = "backbone"    # 'backbone' (one checkpoint) | 'modules' (each HRNet module) | 'early' (not stage 4)
    fused_part_head: bool = False    # the port's eval path always runs the K1 kernel
    part_head_chunks: int = 1        # 24 % N == 0; training crops + heads N part chunks in turn

    def __post_init__(self):
        supported_modes = ("iuv", "iuv_gt", "iuv_feat", "iuv_gt_feat", "feat", "seg")
        if self.input_mode not in supported_modes:
            raise ValueError(
                f"input_mode '{self.input_mode}' is not implemented; supported: "
                f"{supported_modes}. 'rgb' is deliberately rejected: the "
                "reference's inference path for it is broken (see PARITY.md)."
            )
        if self.refine_strategy not in ("gcn", "gcn_direct", "lstm", "lstm_direct"):
            raise ValueError(
                f"unknown refine_strategy '{self.refine_strategy}' "
                "(supported: gcn, gcn_direct, lstm, lstm_direct)"
            )
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"unknown compute_dtype '{self.compute_dtype}' (supported: float32, bfloat16)"
            )
        if self.iuv_regressor not in ("hrnet", "resnet"):
            raise ValueError(
                f"unknown iuv_regressor '{self.iuv_regressor}' (supported: hrnet, resnet)"
            )
        if self.remat_scope not in ("backbone", "modules", "early"):
            raise ValueError(
                f"unknown remat_scope '{self.remat_scope}' "
                "(supported: backbone, modules, early)"
            )
        if self.part_head_chunks < 1 or self.num_patches % self.part_head_chunks:
            raise ValueError(
                f"part_head_chunks={self.part_head_chunks} must divide "
                f"num_patches={self.num_patches}"
            )


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 16
    num_epochs: int = 10
    pretr_step: int = 5000           # IUV-only pretrain steps (two-stage schedule)
    openpose_train_weight: float = 0.0
    gt_train_weight: float = 1.0
    noise_factor: float = 0.4
    rot_factor: float = 30.0
    scale_factor: float = 0.25
    checkpoint_steps: int = 20000
    summary_steps: int = 100
    vis_interval: int = 1000
    test_steps: int = 10000
    train_data: str = "h36m_dp"      # 'h36m_dp' | 'h36m_coco_itw'
    seed: int = 0
    prefetch_workers: int = -1       # -1 = core-count-aware default, 0 = synchronous


@dataclass(frozen=True)
class Config:
    solver: SolverConfig = field(default_factory=SolverConfig)
    danet: DaNetConfig = field(default_factory=DaNetConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


def default_config() -> Config:
    return Config()


def _lower_keys(d: dict) -> dict:
    return {k.lower(): v for k, v in d.items()}


def load_config(yaml_path: str | None = None, overrides: dict | None = None) -> Config:
    """A Config from the defaults, a reference-layout YAML file and dotted
    overrides ({'train.batch_size': 64, ...}).

    Read sections: SOLVER, DANET (with REFINEMENT; INIMG_SIZE is img_size),
    TRAIN's BATCH_SIZE. Other keys (Detectron legacy, the HR_MODEL /
    MSRES_MODEL architecture blocks whose values are the defaults) are
    skipped."""
    cfg = default_config()
    if yaml_path is not None:
        import yaml

        with open(yaml_path) as f:
            raw = yaml.safe_load(f) or {}

        if "SOLVER" in raw:
            s = _lower_keys(raw["SOLVER"])
            cfg = replace(cfg, solver=replace(
                cfg.solver,
                base_lr=float(s.get("base_lr", cfg.solver.base_lr)),
                steps=tuple(s.get("steps", cfg.solver.steps)),
                max_iter=int(s.get("max_iter", cfg.solver.max_iter)),
                optimizer=str(s.get("type", cfg.solver.optimizer)).lower(),
            ))
        if "DANET" in raw:
            danet_fields = {f.name for f in dataclasses.fields(DaNetConfig)}
            kw = {}
            for k, v in _lower_keys(raw["DANET"]).items():
                k = {"inimg_size": "img_size"}.get(k, k)
                if k == "refinement":
                    r = _lower_keys(v)
                    kw["refinement"] = RefinementConfig(
                        refine_on=bool(r.get("refine_on", True)),
                        stack_num=int(r.get("stack_num", 1)),
                        feat_dim=int(r.get("feat_dim", 128)),
                        gcn_num_layer=int(r.get("gcn_num_layer", 3)),
                        pos_intersupv=bool(r.get("pos_intersupv", True)),
                    )
                elif k in danet_fields:
                    kw[k] = v
            cfg = replace(cfg, danet=replace(cfg.danet, **kw))
        if "TRAIN" in raw:
            t = _lower_keys(raw["TRAIN"])
            if "batch_size" in t:
                cfg = replace(cfg, train=replace(cfg.train, batch_size=int(t["batch_size"])))

    for dotted, v in (overrides or {}).items():
        section, name = dotted.split(".", 1)
        cfg = replace(cfg, **{section: replace(getattr(cfg, section), **{name: v})})
    return cfg


__all__ = ["Config", "DaNetConfig", "RefinementConfig", "SolverConfig", "TrainConfig", "load_config"]
