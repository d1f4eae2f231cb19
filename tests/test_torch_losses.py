"""The port's GT preparation and loss pieces against the JAX package on the
CPU: projection and the WLS camera fit, rotations and `smpl_forward_aa`,
the IUV codec, the crop variants and grid sampling, every loss function,
`part_iuv_gt_crops`, `compute_losses` in both modes and `prepare_targets`.

Inputs are made with numpy from a seed. Everything runs in float64 on both
sides, so the bar is f64 noise (rtol 1e-10) unless a test says otherwise."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from danet_densepose2smpl_tpu.kernels.rasterizer import IUVRenderer as JIUVRenderer
from danet_densepose2smpl_tpu.models import losses as JL
from danet_densepose2smpl_tpu.ops import imwarp as jimwarp
from danet_densepose2smpl_tpu.ops import projection as jproj
from danet_densepose2smpl_tpu.ops.iuvmap import iuv_img2map as jax_img2map
from danet_densepose2smpl_tpu.ops.keypoints import gaussian_heatmaps as jax_heatmaps
from danet_densepose2smpl_tpu.ops.rotations import batch_rodrigues as jax_rodrigues
from danet_densepose2smpl_tpu.smpl.densepose_atlas import synthetic_densepose_atlas as jax_atlas
from danet_densepose2smpl_tpu.smpl.loader import synthetic_smpl_model as jax_synthetic_smpl
from danet_densepose2smpl_tpu.smpl.model import smpl_forward_aa as jax_smpl_forward_aa
from danet_densepose2smpl_tpu.train import objective as jobjective
from danet_densepose2smpl_tpu.train.prepare import prepare_targets as jax_prepare_targets

from danet_densepose2smpl_tpu_torch.config import Config, DaNetConfig
from danet_densepose2smpl_tpu_torch.data.synthetic import synthetic_raw_batch
from danet_densepose2smpl_tpu_torch.kernels.rasterizer import IUVRenderer
from danet_densepose2smpl_tpu_torch.models import losses as L
from danet_densepose2smpl_tpu_torch.ops import imwarp, projection
from danet_densepose2smpl_tpu_torch.ops.iuvmap import iuv_img2map
from danet_densepose2smpl_tpu_torch.ops.keypoints import gaussian_heatmaps
from danet_densepose2smpl_tpu_torch.ops.rotations import batch_rodrigues
from danet_densepose2smpl_tpu_torch.smpl.densepose_atlas import synthetic_densepose_atlas
from danet_densepose2smpl_tpu_torch.smpl.loader import synthetic_smpl_model, to_torch
from danet_densepose2smpl_tpu_torch.smpl.model import smpl_forward_aa
from danet_densepose2smpl_tpu_torch.train import objective
from danet_densepose2smpl_tpu_torch.train.prepare import prepare_targets
from danet_densepose2smpl_tpu_torch.train.step import batch_to_device
from test_torch_config import jax_cfg

torch.set_num_threads(1)
TOL = dict(rtol=1e-10, atol=1e-12)
CFG = DaNetConfig(img_size=64, heatmap_size=16)


@pytest.fixture(autouse=True)
def x64_mode():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ours, theirs, rtol=TOL["rtol"], atol=TOL["atol"], err_msg=""):
    np.testing.assert_allclose(ours.detach().numpy() if torch.is_tensor(ours) else ours,
                               np.asarray(theirs), rtol=rtol, atol=atol, err_msg=err_msg)


def _iuv_image(rng, b, s, p_bad=0.0):
    """A rendered-looking IUV image: patch id / 24, U, V; with `p_bad` some
    pixels carry an id outside 0..24."""
    part = rng.randint(0, 25, (b, s, s)).astype(np.float64)
    part = np.where(rng.rand(b, s, s) < p_bad, rng.choice([-1.0, 25.0, 30.0], (b, s, s)), part)
    fg = (part > 0).astype(np.float64)
    return np.stack([part / 24.0, rng.rand(b, s, s) * fg, rng.rand(b, s, s) * fg], -1)


# --------------------------------------------------------------------------
# tables and ops
# --------------------------------------------------------------------------

def test_part_selection_tables_equal():
    for ours, theirs in zip(objective._part_selection_tables(), jobjective._part_selection_tables()):
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)


def test_iuv_img2map_out_of_range_ids(rng):
    img = _iuv_image(rng, 2, 12, p_bad=0.1)
    for ours, theirs in zip(iuv_img2map(_t(img)), jax_img2map(jnp.asarray(img))):
        _close(ours, theirs)


def test_grid_sample_and_crop_variants(rng):
    images = rng.rand(2, 10, 12, 5)
    grid = rng.uniform(-1.2, 1.2, (2, 3, 7, 2))
    exp = jax.vmap(jimwarp.grid_sample_bilinear)(jnp.asarray(images), jnp.asarray(grid))
    _close(imwarp.grid_sample_bilinear(_t(images), _t(grid)), exp)

    feats = rng.rand(2, 12, 12, 4)
    pix = rng.rand(2, 12, 12, 24, 6)
    centers, scales = rng.uniform(-0.6, 0.6, (2, 24, 2)), rng.uniform(0.2, 0.9, (2, 24))
    _close(imwarp.separable_crop_concat(_t(feats), _t(centers), _t(scales), 8),
           jimwarp.separable_crop_concat(jnp.asarray(feats), jnp.asarray(centers), jnp.asarray(scales), 8))
    _close(imwarp.separable_crop_pixel_major(_t(pix), _t(centers), _t(scales), 8),
           jimwarp.separable_crop_pixel_major(jnp.asarray(pix), jnp.asarray(centers), jnp.asarray(scales), 8))


def test_projection_and_translation_fit(rng):
    b = 3
    joints = rng.randn(b, 49, 3) * 0.4
    kp2d = np.concatenate([rng.uniform(20, 200, (b, 49, 2)), rng.rand(b, 49, 1)], -1)
    kp2d[2, :, 2] = 0.0                          # all-masked sample: the damping keeps it finite
    ours = projection.estimate_translation(_t(joints), _t(kp2d), img_size=224.0)
    theirs = jproj.estimate_translation(jnp.asarray(joints), jnp.asarray(kp2d), img_size=224.0)
    assert torch.isfinite(ours).all()
    _close(ours, theirs, rtol=1e-9, atol=1e-12)

    rot = rng.randn(b, 3, 3)
    trans = rng.randn(b, 3) + np.array([0, 0, 10.0])
    center = rng.rand(b, 2) * 100
    _close(projection.perspective_projection(_t(joints), _t(rot), _t(trans), 5000.0, _t(center)),
           jproj.perspective_projection(jnp.asarray(joints), jnp.asarray(rot), jnp.asarray(trans), 5000.0,
                                        jnp.asarray(center)), rtol=1e-10, atol=1e-9)


def test_rodrigues_and_smpl_forward_aa(rng):
    aa = rng.randn(5, 3) * 0.8
    aa[0] = 0.0                                   # theta = 0: the eps-shifted norm
    _close(batch_rodrigues(_t(aa)), jax_rodrigues(jnp.asarray(aa)))
    jsmpl = jax_synthetic_smpl(num_verts=500, seed=3)
    betas, pose = rng.randn(2, 10) * 0.5, rng.randn(2, 72) * 0.3
    ours = smpl_forward_aa(to_torch(synthetic_smpl_model(num_verts=500, seed=3), "cpu", torch.float64),
                           _t(betas), _t(pose))
    theirs = jax_smpl_forward_aa(jsmpl, jnp.asarray(betas), jnp.asarray(pose))
    for name in ("vertices", "joints", "smpl_joints"):
        _close(getattr(ours, name), getattr(theirs, name), rtol=1e-10, atol=1e-12)


def test_gaussian_heatmaps(rng):
    kps = rng.uniform(-0.3, 1.3, (2, 24, 2))
    for ours, theirs in zip(gaussian_heatmaps(_t(kps), 16), jax_heatmaps(jnp.asarray(kps), 16)):
        _close(ours, theirs)


def test_cross_entropy_int(rng):
    """Against JAX everywhere; against F.cross_entropy for in-range labels;
    zero for out-of-range labels (ignored, never clamped)."""
    logits = rng.randn(3, 5, 7)
    labels = rng.randint(-2, 9, (3, 5))
    ours = L.cross_entropy_int(_t(logits), _t(labels))
    _close(ours, JL.cross_entropy_int(jnp.asarray(logits), jnp.asarray(labels)))
    ok = (labels >= 0) & (labels < 7)
    ref = F.cross_entropy(_t(logits).reshape(-1, 7), _t(np.clip(labels, 0, 6)).reshape(-1),
                          reduction="none").reshape(3, 5)
    _close(ours[_t(ok)], ref[_t(ok)].numpy())
    assert (ours[_t(~ok)] == 0).all()


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

def _loss_inputs(rng, b=3, s=8):
    maps = {k: rng.randn(b, s, s, c) for k, c in (("u", 25), ("v", 25), ("index", 25), ("ann", 15))}
    gt = _iuv_image(rng, b, s)
    has = np.array([1.0, 0.0, 1.0])[:b]
    return maps, gt, has


def _dp(rng, b=3, n=20, s=8):
    return {
        "x": rng.uniform(0, s, (b, n)), "y": rng.uniform(0, s, (b, n)),
        "i_points": rng.randint(0, 25, (b, n)).astype(np.int32),
        "u_points": rng.rand(b, 25, n), "v_points": rng.rand(b, 25, n),
        "point_weights": (rng.rand(b, 25, n) > 0.5).astype(np.float64),
        "ann_labels": rng.randint(0, 15, (b, s, s)).astype(np.int32),
    }


LOSS_CASES = ["body_uv", "partial_uv", "dp_uvia", "stn", "stn_heatmap", "smpl_param", "keypoint_2d",
              "keypoint_3d", "vertex", "cam", "orthogonal", "aux_rotation", "aux_position", "reproject"]


@pytest.mark.parametrize("case", LOSS_CASES)
def test_loss_function_matches_jax(case, rng):
    cfg = DaNetConfig(heatmap_size=8, orthogonal_weights=0.1, stn_hm_weights=0.5)
    b = 3
    maps, gt, has = _loss_inputs(rng)
    rot = rng.randn(b, 24, 3, 3)
    j = lambda x: jnp.asarray(x)  # noqa: E731
    if case == "body_uv":
        g = jax_img2map(j(gt))
        ours = L.body_uv_losses(*(_t(maps[k]) for k in ("u", "v", "index", "ann")),
                                *iuv_img2map(_t(gt)), _t(has), cfg)
        theirs = JL.body_uv_losses(*(j(maps[k]) for k in ("u", "v", "index", "ann")), *g, j(has), jax_cfg(cfg))
    elif case == "partial_uv":
        pred, pgt = rng.randn(b, 24, 6, 6, 3, 7), rng.rand(b, 24, 6, 6, 3, 7)
        ours, theirs = L.partial_uv_losses(_t(pred), _t(pgt), _t(has), cfg), JL.partial_uv_losses(j(pred), j(pgt), j(has), jax_cfg(cfg))
    elif case == "dp_uvia":
        dp = _dp(rng)
        ours = L.dp_uvia_losses(*(_t(maps[k]) for k in ("u", "v", "index", "ann")),
                                {k: _t(v) for k, v in dp.items()}, _t(has), cfg)
        theirs = JL.dp_uvia_losses(*(j(maps[k]) for k in ("u", "v", "index", "ann")),
                                   {k: j(v) for k, v in dp.items()}, j(has), jax_cfg(cfg))
    elif case in ("stn", "stn_heatmap"):
        kps = np.concatenate([rng.uniform(-1, 1, (b, 24, 2)), rng.rand(b, 24, 1)], -1)
        if case == "stn":
            c = rng.uniform(-1, 1, (b, 24, 2))
            ours, theirs = L.stn_losses(_t(c), _t(kps), cfg), JL.stn_losses(j(c), j(kps), jax_cfg(cfg))
        else:
            hm = rng.rand(b, 8, 8, 24)
            ours, theirs = L.stn_heatmap_loss(_t(hm), _t(kps), cfg), JL.stn_heatmap_loss(j(hm), j(kps), jax_cfg(cfg))
    elif case == "smpl_param":
        args = (rot, rng.randn(b, 24, 3, 3), rng.randn(b, 10), rng.randn(b, 10))
        ours = L.smpl_param_losses(_t(args[0]), _t(args[2]), _t(args[1]), _t(args[3]), _t(has), cfg)
        theirs = JL.smpl_param_losses(j(args[0]), j(args[2]), j(args[1]), j(args[3]), j(has), jax_cfg(cfg))
    elif case == "keypoint_2d":
        pred, kp = rng.randn(b, 49, 2), np.concatenate([rng.randn(b, 49, 2), rng.rand(b, 49, 1)], -1)
        ours, theirs = L.keypoint_2d_loss(_t(pred), _t(kp), 0.3, 1.0), JL.keypoint_2d_loss(j(pred), j(kp), 0.3, 1.0)
    elif case == "keypoint_3d":
        pred, kp = rng.randn(b, 49, 3), np.concatenate([rng.randn(b, 24, 3), rng.rand(b, 24, 1)], -1)
        ours, theirs = L.keypoint_3d_loss(_t(pred), _t(kp), _t(has)), JL.keypoint_3d_loss(j(pred), j(kp), j(has))
    elif case == "vertex":
        a, c = rng.randn(b, 30, 3), rng.randn(b, 30, 3)
        ours, theirs = L.vertex_loss(_t(a), _t(c), _t(has)), JL.vertex_loss(j(a), j(c), j(has))
    elif case == "cam":
        a, c = rng.randn(b, 3), rng.randn(b, 3)
        ours, theirs = L.cam_losses(_t(a), _t(c), _t(has)), JL.cam_losses(j(a), j(c), j(has))
    elif case == "orthogonal":
        ours, theirs = L.orthogonal_loss(_t(rot), cfg), JL.orthogonal_loss(j(rot), jax_cfg(cfg))
    elif case == "aux_rotation":
        a, c = rng.randn(b, 216), rng.randn(b, 216)
        ours, theirs = L.aux_rotation_loss(_t(a), _t(c), _t(has), cfg), JL.aux_rotation_loss(j(a), j(c), j(has), jax_cfg(cfg))
    elif case == "aux_position":
        a, c = rng.randn(b, 24, 3), rng.randn(b, 24, 3)
        ours, theirs = L.aux_position_loss(_t(a), _t(c), _t(has), cfg), JL.aux_position_loss(j(a), j(c), j(has), jax_cfg(cfg))
    else:
        joints, cam = rng.randn(b, 49, 3) * 0.3, np.abs(rng.randn(b, 3)) + 0.5
        ours, theirs = L.reproject(_t(joints), _t(cam), 224.0), JL.reproject(j(joints), j(cam), 224.0)
    ours = ours if isinstance(ours, tuple) else (ours,)
    theirs = theirs if isinstance(theirs, tuple) else (theirs,)
    assert len(ours) == len(theirs)
    for a, c in zip(ours, theirs):
        _close(a, c)


def test_part_iuv_gt_crops(rng):
    gt = _iuv_image(rng, 2, 12)
    theta = np.zeros((2, 24, 2, 3))
    theta[..., 0, 0] = theta[..., 1, 1] = rng.uniform(0.2, 0.9, (2, 24))
    theta[..., :, 2] = rng.uniform(-0.6, 0.6, (2, 24, 2))
    ours = objective.part_iuv_gt_crops(*iuv_img2map(_t(gt))[:3], _t(theta))
    theirs = jobjective.part_iuv_gt_crops(*jax_img2map(jnp.asarray(gt))[:3], jnp.asarray(theta))
    assert ours.shape == (2, 24, 12, 12, 3, 7)
    _close(ours, theirs)


# --------------------------------------------------------------------------
# GT preparation and the loss assembly
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def prepared():
    """The raw synthetic batch prepared by both packages (400-vertex
    synthetic SMPL, its soup atlas rendered at 16x16), in f64."""
    jax.config.update("jax_enable_x64", True)
    cfg = Config(danet=CFG)
    raw = synthetic_raw_batch(cfg, 3, seed=7, num_dp_points=20)
    raw["has_smpl"] = np.array([1.0, 0.0, 1.0], np.float32)
    raw["has_dp"] = np.array([0.0, 1.0, 0.0], np.float32)
    raw["is_dp_dataset"] = np.array([0.0, 1.0, 0.0], np.float32)
    raw["opt_betas"][0, 0] = 4.0                    # an extreme pseudo-fit: zeroed
    smpl = synthetic_smpl_model(num_verts=400, seed=1)
    # 2D keypoints that the merged fits explain (the synthetic ones are
    # random and fit cameras behind the body): their joints under a
    # weak-perspective camera of scale 0.9, plus noise
    fit = np.where(raw["has_smpl"][:, None] > 0, raw["pose"], raw["opt_pose"])
    joints = smpl_forward_aa(to_torch(smpl, "cpu", torch.float64), _t(raw["betas"]).double(),
                             _t(fit).double()).joints.numpy()
    tz = 2 * 5000.0 / (64 * 0.9)
    kp = joints[..., :2] / (joints[..., 2:] + tz) * 5000.0 / 32.0
    raw["keypoints"][..., :2] = (kp + np.random.RandomState(8).randn(*kp.shape) * 0.01).astype(np.float32)
    jsmpl = jax_synthetic_smpl(num_verts=400, seed=1)
    jbatch = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64) if a.dtype == np.float32 else jnp.asarray(a), raw)
    theirs = jax_prepare_targets(jax_cfg(cfg), jsmpl, jbatch, renderer=JIUVRenderer(jax_atlas(jsmpl), 64, 16, chunk=256))
    ours = prepare_targets(cfg, to_torch(smpl, "cpu"), batch_to_device(raw, "cpu", torch.float64),
                           renderer=IUVRenderer(synthetic_densepose_atlas(smpl), 64, 16, chunk=256))
    jax.config.update("jax_enable_x64", False)
    return cfg, ours, theirs, to_torch(smpl, "cpu"), jsmpl


def test_prepare_targets_matches_jax(prepared):
    _, ours, theirs, _, _ = prepared
    new = ("opt_pose", "opt_betas", "opt_rotmat", "target_verts", "target_cam", "target_smpl_kps",
           "valid_fit", "has_iuv", "uv_image_gt")
    assert set(ours) == set(theirs)
    for k in new:
        _close(ours[k], theirs[k], rtol=1e-9, atol=1e-10, err_msg=k)
    # samples 0 and 2 render a body; sample 1 is a DensePose-dataset sample
    cover = (ours["uv_image_gt"][..., 0] > 0).double().mean((1, 2))
    assert cover[0] > 0 and cover[2] > 0 and cover[1] == 0, cover


@pytest.mark.parametrize("pretrain_mode", [False, True])
def test_compute_losses_matches_jax(prepared, pretrain_mode, rng):
    """Every term of `compute_losses` on model-shaped random outputs, both
    modes, with the train-only aux lists."""
    cfg, ours_b, theirs_b, smpl, jsmpl = prepared
    b, s = 3, 16
    raw = {k: rng.randn(b, s, s, c) for k, c in (("u", 25), ("v", 25), ("index", 25), ("ann", 15),
                                                  ("heatmaps", 24))}
    raw["stn_centers"] = rng.uniform(-1, 1, (b, 24, 2))
    theta = np.zeros((b, 24, 2, 3))
    theta[..., 0, 0] = theta[..., 1, 1] = rng.uniform(0.2, 0.9, (b, 24))
    theta[..., :, 2] = rng.uniform(-0.6, 0.6, (b, 24, 2))
    raw["stn_theta"] = theta
    raw["part_iuv"] = rng.randn(b, 24, s, s, 3, 7)
    rot = np.asarray(jax_rodrigues(jnp.asarray(rng.randn(b * 24, 3) * 0.3))).reshape(b, 24, 3, 3)
    cam = np.abs(rng.randn(b, 3)) * 0.2 + np.array([0.8, 0, 0])
    para = np.concatenate([cam, rng.randn(b, 10) * 0.3, rot.reshape(b, -1)], 1)
    out = {"iuv_raw": raw, "pred_cam": para[:, :3], "pred_shape": para[:, 3:13], "pred_rotmat": rot,
           "joint_rotation": [rng.randn(b, 216)], "joint_position": [rng.randn(b, 24, 3), rng.randn(b, 24, 3)]}

    def conv(tree, fn):
        if isinstance(tree, dict):
            return {k: conv(v, fn) for k, v in tree.items()}
        if isinstance(tree, list):
            return [conv(v, fn) for v in tree]
        return fn(tree)

    dcfg = DaNetConfig(img_size=64, heatmap_size=16, stn_hm_weights=0.5, orthogonal_weights=0.1, verts_weights=0.2)
    jax.config.update("jax_enable_x64", True)
    t_total, t_losses = jobjective.compute_losses(jax_cfg(dcfg), jsmpl, conv(out, jnp.asarray), theirs_b,
                                                  pretrain_mode=pretrain_mode, openpose_weight=0.2)
    total, losses = objective.compute_losses(dcfg, smpl, conv(out, _t), ours_b,
                                             pretrain_mode=pretrain_mode, openpose_weight=0.2)
    assert list(losses) == list(t_losses)
    for k in losses:
        _close(losses[k], t_losses[k], rtol=1e-9, atol=1e-12, err_msg=k)
    _close(total, t_total, rtol=1e-9)
    assert ("smpl_pose" in losses) != pretrain_mode and "loss_pU" in losses and "loss_Udp" in losses
