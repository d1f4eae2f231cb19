"""PyTorch port vs the JAX package: copied tables and the serving-path ops.

Inputs are made with numpy from a seed and handed to both sides. Ops are
held at fp32 noise (1e-5 unless stated)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from danet_densepose2smpl_tpu.models import iuv_estimator as jest
from danet_densepose2smpl_tpu.models.smpl_regressor import default_mean_params as jax_mean_params
from danet_densepose2smpl_tpu.ops import imwarp as jimwarp
from danet_densepose2smpl_tpu.ops import structure as jstructure
from danet_densepose2smpl_tpu.ops.iuvmap import iuvmap_clean as jax_iuvmap_clean
from danet_densepose2smpl_tpu.ops.keypoints import soft_argmax_2d as jax_soft_argmax
from danet_densepose2smpl_tpu.ops.rotations import rot6d_to_rotmat as jax_rot6d
from danet_densepose2smpl_tpu.smpl.loader import synthetic_smpl_model as jax_synthetic_smpl
from danet_densepose2smpl_tpu.smpl.model import smpl_forward as jax_smpl_forward

from danet_densepose2smpl_tpu_torch.constants import J24_TO_J19
from danet_densepose2smpl_tpu_torch.models import iuv_estimator as est
from danet_densepose2smpl_tpu_torch.models.smpl_regressor import default_mean_params
from danet_densepose2smpl_tpu_torch.ops import imwarp, structure
from danet_densepose2smpl_tpu_torch.ops.iuvmap import iuvmap_clean
from danet_densepose2smpl_tpu_torch.ops.keypoints import soft_argmax_2d
from danet_densepose2smpl_tpu_torch.ops.rotations import rot6d_to_rotmat
from danet_densepose2smpl_tpu_torch.smpl.loader import synthetic_smpl_model, to_torch
from danet_densepose2smpl_tpu_torch.smpl.model import smpl_forward

torch.set_num_threads(1)
ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name", [
    "SMPL_PARENT", "SMPL_CHILD2", "SMPL_EDGES", "DP2SMPL_MAPPING", "smpl2dp_channel_mask",
    "rot2pos_adjacency", "pos2rot_adjacency", "refine_edge_mask",
])
def test_structure_tables_equal(name):
    ours, theirs = getattr(structure, name), getattr(jstructure, name)
    if callable(ours):
        ours, theirs = ours(), theirs()
    assert ours.dtype == theirs.dtype
    np.testing.assert_array_equal(ours, theirs)


def test_smpl2dp_part_equal():
    assert structure.SMPL2DP_PART == jstructure.SMPL2DP_PART


def test_synthetic_smpl_arrays_equal():
    ours, theirs = synthetic_smpl_model(seed=3), jax_synthetic_smpl(seed=3)
    assert ours.num_verts == theirs.num_verts == 6890
    for field in ours._fields:
        a, b = getattr(ours, field), getattr(theirs, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


def test_mean_params_and_stn_constants_equal():
    for a, b in zip(default_mean_params(), jax_mean_params()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(est.LEARNED_RATIO, jest.LEARNED_RATIO)
    np.testing.assert_array_equal(est.LEARNED_OFFSET, jest.LEARNED_OFFSET)


def test_rot6d_to_rotmat(rng):
    x = rng.randn(40, 6).astype(np.float32)
    np.testing.assert_allclose(rot6d_to_rotmat(_t(x)).numpy(), np.asarray(jax_rot6d(jnp.asarray(x))),
                               atol=ATOL)


def test_soft_argmax_2d(rng):
    hm = rng.randn(2, 16, 12, 24).astype(np.float32)
    got = soft_argmax_2d(_t(hm), temperature=10.0).numpy()
    exp = np.asarray(jax_soft_argmax(jnp.asarray(hm), temperature=10.0))
    # pixel coordinates up to 15: fp32 noise of the weighted sum
    np.testing.assert_allclose(got, exp, atol=1e-4)


def test_iuvmap_clean(rng):
    u, v, idx = (rng.randn(2, 8, 8, 25).astype(np.float32) for _ in range(3))
    ann = rng.randn(2, 8, 8, 15).astype(np.float32)
    idx[0, 0, 0, :] = 1.0  # a tie: both sides take the first index
    got = iuvmap_clean(_t(u), _t(v), _t(idx), _t(ann))
    exp = jax_iuvmap_clean(*(jnp.asarray(a) for a in (u, v, idx, ann)))
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_axis_weights(rng, dtype):
    centers = rng.uniform(-0.9, 0.9, (2, 24)).astype(np.float32)
    scales = rng.uniform(0.1, 1.2, (2, 24)).astype(np.float32)
    got = imwarp._axis_weights(_t(centers), _t(scales), 20, 16, getattr(torch, dtype))
    exp = jimwarp._axis_weights(jnp.asarray(centers), jnp.asarray(scales), 20, 16,
                                jnp.float32 if dtype == "float64" else getattr(jnp, dtype))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(exp, np.float32), atol=ATOL)


def test_separable_crop(rng):
    img = rng.rand(2, 12, 10, 5).astype(np.float32)
    centers = rng.uniform(-0.6, 0.6, (2, 24, 2)).astype(np.float32)
    scales = rng.uniform(0.2, 0.9, (2, 24)).astype(np.float32)
    got = imwarp.separable_crop(_t(img), _t(centers), _t(scales), 8).numpy()
    exp = jimwarp.separable_crop(jnp.asarray(img), jnp.asarray(centers), jnp.asarray(scales), 8)
    np.testing.assert_allclose(got, np.asarray(exp), atol=ATOL)


def test_point_sample(rng):
    maps = rng.rand(2, 9, 7, 24).astype(np.float32)
    pts = rng.uniform(-1.3, 1.3, (2, 24, 2)).astype(np.float32)  # some fall outside
    got = est.point_sample(_t(maps), _t(pts)).numpy()
    exp = jest.point_sample(jnp.asarray(maps), jnp.asarray(pts))
    np.testing.assert_allclose(got, np.asarray(exp), atol=ATOL)


def test_stn_affine_params_with_hidden_parts(rng):
    centers = rng.uniform(-0.8, 0.8, (3, 24, 2)).astype(np.float32)
    hidden = rng.rand(3, 24) < 0.4
    hidden[:, 0] = True  # the root must not fall back
    ratio, offset = jest.LEARNED_RATIO, jest.LEARNED_OFFSET
    for h in (None, hidden):
        theta, scale = est.stn_affine_params(_t(centers), _t(ratio), _t(offset),
                                               None if h is None else _t(h))
        etheta, escale = jest.stn_affine_params(jnp.asarray(centers), jnp.asarray(ratio),
                                                jnp.asarray(offset),
                                                None if h is None else jnp.asarray(h))
        np.testing.assert_allclose(theta.numpy(), np.asarray(etheta), atol=ATOL)
        np.testing.assert_allclose(scale.numpy(), np.asarray(escale), atol=ATOL)


def test_smpl_forward_full_body(rng):
    model = synthetic_smpl_model()
    betas = rng.randn(2, 10).astype(np.float32)
    rotmats = np.asarray(jax_rot6d(jnp.asarray(rng.randn(2 * 24, 6).astype(np.float32))))
    rotmats = rotmats.reshape(2, 24, 3, 3)
    transl = rng.randn(2, 3).astype(np.float32)
    got = smpl_forward(to_torch(model, "cpu"), _t(betas), _t(rotmats), _t(transl))
    exp = jax_smpl_forward(model, jnp.asarray(betas), jnp.asarray(rotmats), jnp.asarray(transl))
    assert got.vertices.shape == (2, 6890, 3)
    for name in ("vertices", "joints", "smpl_joints", "joints_j19"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(exp, name)),
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("name", ["SMPL_CHILD2", "SMPL_PARENT", "J24_TO_J19"])
def test_device_table_is_the_table_made_once(name):
    table = J24_TO_J19 if name == "J24_TO_J19" else getattr(structure, name)
    got = structure.device_table(table, "cpu")
    assert got.dtype == torch.long and got.device == torch.device("cpu") and not got.is_inference()
    np.testing.assert_array_equal(got.numpy(), table)
    assert structure.device_table(table, torch.device("cpu")) is got
    with torch.inference_mode():
        assert structure.device_table(table, "cpu") is got


@pytest.mark.parametrize("path", ["stn_affine_params", "smpl_forward"])
def test_tables_first_made_while_serving_take_a_backward_later(monkeypatch, rng, path):
    """A table first asked for under `torch.inference_mode()` (as
    `Predictor.predict` runs) is no inference tensor, so the same path run
    later with autograd saves it for its backward."""
    monkeypatch.setattr(structure, "_DEVICE_TABLES", {})
    if path == "stn_affine_params":
        centers = _t(rng.uniform(-0.8, 0.8, (2, 24, 2)).astype(np.float32))
        ratio, offset = _t(est.LEARNED_RATIO), _t(est.LEARNED_OFFSET)

        def run(grad):
            r, o = ratio.clone().requires_grad_(grad), offset.clone().requires_grad_(grad)
            theta, scale = est.stn_affine_params(centers, r, o)
            return theta.sum() + scale.sum(), (r, o)
    else:
        model = to_torch(synthetic_smpl_model(300), "cpu")
        betas = _t(rng.randn(2, 10).astype(np.float32))
        rotmats = rot6d_to_rotmat(_t(rng.randn(2 * 24, 6).astype(np.float32))).reshape(2, 24, 3, 3)

        def run(grad):
            b, r = betas.clone().requires_grad_(grad), rotmats.clone().requires_grad_(grad)
            out = smpl_forward(model, b, r)
            return out.vertices.sum() + out.joints_j19.sum(), (b, r)

    with torch.inference_mode():
        served, _ = run(False)
    assert structure._DEVICE_TABLES and not any(t.is_inference() for _, t in structure._DEVICE_TABLES.values())
    loss, leaves = run(True)
    loss.backward()
    assert torch.equal(loss.detach(), served)
    assert all(leaf.grad is not None and torch.isfinite(leaf.grad).all() for leaf in leaves)
