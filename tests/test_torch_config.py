"""The port's own configuration dataclasses and constants against the JAX
package's: every copied constant equal, every dataclass with the same field
names and defaults. (`tests/test_torch_slice.py::test_port_imports_no_jax`
shows that the port imports nothing of the JAX package.)

`jax_cfg` is the one way the port's tests hand a configuration to the JAX
package: they build the port's config and convert it here."""

import dataclasses

import numpy as np
import pytest

from danet_densepose2smpl_tpu import constants as jconst
from danet_densepose2smpl_tpu.core import config as jconfig

from danet_densepose2smpl_tpu_torch import config, constants

CLASSES = ["Config", "DaNetConfig", "RefinementConfig", "SolverConfig", "TrainConfig"]
CONSTANTS = ["FOCAL_LENGTH", "IMG_RES", "JOINT_MAP_TO_EXTENDED", "H36M_TO_J17", "H36M_TO_J14",
             "J24_TO_J17", "J24_TO_J14", "J24_TO_J19", "J24_TO_JCOCO", "NUM_DP_PATCHES", "NUM_DP_PARTS",
             "IUV_CHANNELS", "ANN_CHANNELS", "INDEX2ANN_GROUPS", "IMG_NORM_MEAN", "IMG_NORM_STD",
             "SMPL_JOINTS_FLIP_PERM", "SMPL_POSE_FLIP_PERM", "J24_FLIP_PERM", "OP25_FLIP_PERM", "J49_FLIP_PERM"]


def jax_cfg(cfg):
    """The JAX package's config object with the same values as the port's
    `cfg` (any of the dataclasses, nested ones converted too)."""
    cls = getattr(jconfig, type(cfg).__name__)
    return cls(**{f.name: jax_cfg(v) if dataclasses.is_dataclass(v) else v
                  for f in dataclasses.fields(cfg) for v in (getattr(cfg, f.name),)})


def _shape(cls):
    """[(name, default)] of a dataclass, nested dataclass defaults expanded."""
    out = []
    for f in dataclasses.fields(cls):
        default = f.default_factory() if f.default_factory is not dataclasses.MISSING else f.default
        if dataclasses.is_dataclass(default):
            default = (type(default).__name__, _shape(type(default)))
        out.append((f.name, default))
    return out


@pytest.mark.parametrize("name", CONSTANTS + ["index2ann_matrix"])
def test_constant_equal(name):
    ours, theirs = getattr(constants, name), getattr(jconst, name)
    if name == "index2ann_matrix":
        ours, theirs = ours(), theirs()
    if isinstance(theirs, np.ndarray):
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
        np.testing.assert_array_equal(ours, theirs)
    else:
        assert type(ours) is type(theirs) and ours == theirs


@pytest.mark.parametrize("name", CLASSES)
def test_dataclass_fields_and_defaults_equal(name):
    ours, theirs = getattr(config, name), getattr(jconfig, name)
    assert _shape(ours) == _shape(theirs)
    assert ours.__dataclass_params__.frozen and theirs.__dataclass_params__.frozen


def test_jax_cfg_round_trip_and_validation():
    cfg = config.Config(danet=config.DaNetConfig(img_size=64, heatmap_size=16, refinement=config.RefinementConfig(
        stack_num=2)), solver=config.SolverConfig(optimizer="sgd"))
    j = jax_cfg(cfg)
    assert isinstance(j, jconfig.Config) and isinstance(j.danet.refinement, jconfig.RefinementConfig)
    assert dataclasses.asdict(j) == dataclasses.asdict(cfg)
    for kw in ({"input_mode": "rgb"}, {"refine_strategy": "mlp"}, {"compute_dtype": "float16"},
               {"iuv_regressor": "vit"}, {"remat_scope": "all"}, {"part_head_chunks": 5}):
        with pytest.raises(ValueError):
            config.DaNetConfig(**kw)
        with pytest.raises(ValueError):
            jconfig.DaNetConfig(**kw)

