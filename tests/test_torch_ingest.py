"""The port's ingest on the card (`ops/imwarp.affine_grid` / `affine_crop`,
`data/pipeline.py`) against the JAX package on the CPU, and its three
callers: the pose eval harness, the LSP eval and the training step.

Inputs are made with numpy from a seed. Bars: f64 1e-12 (crop_thetas,
affine_crop) and 1e-9 relative (the pose harness, as
`tests/test_torch_eval.py` holds it); f32 1e-5 (crop_thetas, affine_crop
on [0, 1] images) and 1e-4 on the normalized scale (device_preprocess /
_train on smooth frames, as the JAX package's own tests use them); against
the port's host crop (cv2's `warpAffine` bit for bit), the bars of
`tests/test_data.py`'s device-crop test: interior median < 0.005, 95th
percentile < 0.01, max < 0.05. On white-noise frames the fp32 sample
positions of either package move values by ~1e-4 from an f64 evaluation;
the port must stay within twice the JAX package's distance."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from danet_densepose2smpl_tpu.data import pipeline as jpipeline
from danet_densepose2smpl_tpu.data.dataset import NpzDataset as JNpzDataset
from danet_densepose2smpl_tpu.data.loader import ResumableLoader as JResumableLoader
from danet_densepose2smpl_tpu.eval import harness as jharness
from danet_densepose2smpl_tpu.ops import imwarp as jimwarp
from danet_densepose2smpl_tpu.smpl.loader import synthetic_smpl_model as jax_synthetic_smpl

from danet_densepose2smpl_tpu_torch.config import Config, DaNetConfig
from danet_densepose2smpl_tpu_torch.constants import IMG_NORM_MEAN, IMG_NORM_STD
from danet_densepose2smpl_tpu_torch.data import pipeline
from danet_densepose2smpl_tpu_torch.data.dataset import NpzDataset
from danet_densepose2smpl_tpu_torch.data.loader import ResumableLoader
from danet_densepose2smpl_tpu_torch.data.synthetic import synthetic_raw_batch, write_synthetic_dataset
from danet_densepose2smpl_tpu_torch.data.transforms import crop, flip_img
from danet_densepose2smpl_tpu_torch.eval import harness
from danet_densepose2smpl_tpu_torch.eval.lsp import run_lsp_eval
from danet_densepose2smpl_tpu_torch.kernels.rasterizer import IUVRenderer
from danet_densepose2smpl_tpu_torch.models.danet import DaNet
from danet_densepose2smpl_tpu_torch.ops import imwarp
from danet_densepose2smpl_tpu_torch.serve import random_init_
from danet_densepose2smpl_tpu_torch.smpl.densepose_atlas import synthetic_densepose_atlas
from danet_densepose2smpl_tpu_torch.smpl.loader import synthetic_smpl_model
from danet_densepose2smpl_tpu_torch.train.step import batch_to_device, create_train_state, make_train_step

torch.set_num_threads(1)
H, W, S, B = 180, 160, 64, 6


@pytest.fixture
def x64_mode():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _t(a):
    return torch.from_numpy(np.array(a))


def _boxes(seed, b=B):
    """Centres, scales, rotations (+-40 degrees), flips and channel noise
    of `b` crops inside an H x W frame."""
    rng = np.random.RandomState(seed)
    centers = np.stack([rng.uniform(60, 100, b), rng.uniform(70, 110, b)], 1).astype(np.float32)
    return (centers, rng.uniform(0.4, 0.7, b).astype(np.float32), rng.uniform(-40, 40, b).astype(np.float32),
            (np.arange(b) % 2).astype(np.float32), rng.uniform(0.6, 1.4, (b, 3)).astype(np.float32))


def _smooth_frames(b=B):
    """Smooth uint8 frames (gradients, no wrap), as the JAX package's device
    crop tests draw them: the same frame, flipped in y, flipped in x."""
    yy, xx = np.mgrid[0:H, 0:W]
    img = np.stack([yy, xx, (yy + xx) * 0.7], -1).astype(np.uint8)
    return np.stack([img, img[::-1].copy(), img[:, ::-1].copy()] * (b // 3))


def _jax_preprocess(train, frames, c, s, r, f, pn):
    if train:
        return np.asarray(jpipeline.device_preprocess_train(
            jnp.asarray(frames), jnp.asarray(c), jnp.asarray(s), jnp.asarray(r), jnp.asarray(f), jnp.asarray(pn),
            out_size=S))
    return np.asarray(jpipeline.device_preprocess(jnp.asarray(frames), jnp.asarray(c), jnp.asarray(s), out_size=S))


def _port_preprocess(train, frames, c, s, r, f, pn):
    if train:
        return pipeline.device_preprocess_train(_t(frames), _t(c), _t(s), _t(r), _t(f), _t(pn), out_size=S).numpy()
    return pipeline.device_preprocess(_t(frames), _t(c), _t(s), out_size=S).numpy()


# --------------------------------------------------------------------------
# the crop: thetas, grids, samples
# --------------------------------------------------------------------------

@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
def test_crop_thetas_and_affine_crop_match_jax(f64, request):
    """`crop_thetas` with and without rotation (the closed-form inverse of
    get_transform against JAX's LU inverse), and `affine_crop` of K crops
    of each image (the grid elementwise against JAX's HIGHEST einsum)."""
    if f64:
        request.getfixturevalue("x64_mode")
    dt, tol = (np.float64, 1e-12) if f64 else (np.float32, 1e-5)
    c, s, r, _, _ = (a.astype(dt) for a in _boxes(1))
    for rots in (None, r):
        got = pipeline.crop_thetas(_t(c), _t(s), (H, W), None if rots is None else _t(rots), out_size=S)
        want = np.asarray(jpipeline.crop_thetas(jnp.asarray(c), jnp.asarray(s), (H, W),
                                                None if rots is None else jnp.asarray(rots), out_size=S))
        assert got.dtype == (torch.float64 if f64 else torch.float32) and got.shape == (B, 2, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    rng = np.random.RandomState(2)
    images = rng.rand(3, 50, 60, 4).astype(dt)
    theta = (np.eye(2, 3)[None, None] * 0.8 + rng.randn(3, 5, 2, 3) * 0.3).astype(dt)   # some reach outside
    got = imwarp.affine_crop(_t(images), _t(theta), 20)
    want = np.asarray(jimwarp.affine_crop(jnp.asarray(images), jnp.asarray(theta), 20))
    assert got.shape == (3, 5, 20, 20, 4) and (want == 0).any()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    np.testing.assert_allclose(imwarp.affine_grid(_t(theta), 20).numpy(),
                               np.asarray(jimwarp.affine_grid(jnp.asarray(theta), 20)), rtol=0, atol=tol)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_device_preprocess_matches_jax_f32(train):
    """fp32 crops of uint8 frames against JAX's: within 1e-4 on the
    normalized scale on smooth frames; on white-noise frames, no farther
    from an f64 evaluation (the port's own f64 path, held to JAX above)
    than twice JAX's distance."""
    c, s, r, f, pn = _boxes(3)
    frames = _smooth_frames()
    got = _port_preprocess(train, frames, c, s, r, f, pn)
    assert got.dtype == np.float32 and got.shape == (B, S, S, 3)
    np.testing.assert_allclose(got, _jax_preprocess(train, frames, c, s, r, f, pn), rtol=0, atol=1e-4)

    noise = np.random.RandomState(4).randint(0, 256, (B, H, W, 3)).astype(np.uint8)
    c64, s64 = _t(c).double(), _t(s).double()
    theta = pipeline.crop_thetas(c64, s64, (H, W), _t(r).double() if train else None, out_size=S)
    exact = imwarp.affine_crop(_t(noise).double() / (1.0 if train else 255.0), theta[:, None], S)[:, 0]
    if train:
        exact = torch.where(_t(f).bool()[:, None, None, None], exact.flip(2), exact)
        exact = torch.clamp(exact * _t(pn).double()[:, None, None, :], 0, 255) / 255.0
    exact = ((exact - _t(IMG_NORM_MEAN).double()) / _t(IMG_NORM_STD).double()).numpy()
    ours = np.abs(_port_preprocess(train, noise, c, s, r, f, pn) - exact).max()
    theirs = np.abs(_jax_preprocess(train, noise, c, s, r, f, pn) - exact).max()
    assert ours <= 2 * theirs, (ours, theirs)


def test_device_preprocess_train_f64_matches_jax(x64_mode):
    """With f64 boxes and noise (the f64 training step's batch), the
    training crop of uint8 frames is f64 in both packages, sampled from
    fp32 frames with an fp32 fraction (JAX's design). The two thetas (the
    closed-form inverse here, JAX's LU) part by an f64 ulp, and where a
    box's sample fractions sit on an fp32 rounding boundary (at 0 degrees
    they share one fraction per row or column, so a whole row can) the
    fraction rounds apart: such values move by at most one fp32 ulp of
    255, x the noise, on the normalized scale (box 0 here: 2% of its
    values). The rotated boxes are equal."""
    rng = np.random.RandomState(7)
    frames = rng.randint(0, 256, (4, 90, 80, 3)).astype(np.uint8)
    c = rng.uniform(30, 50, (4, 2)).astype(np.float32).astype(np.float64)
    s = rng.uniform(0.25, 0.35, 4).astype(np.float32).astype(np.float64)
    r, f = np.array([0.0, 21.0, 0.0, -35.0]), np.array([0.0, 0.0, 1.0, 1.0])
    pn = rng.uniform(0.6, 1.4, (4, 3)).astype(np.float32).astype(np.float64)
    got = pipeline.device_preprocess_train(_t(frames), _t(c), _t(s), _t(r), _t(f), _t(pn), out_size=S).numpy()
    want = np.asarray(jpipeline.device_preprocess_train(jnp.asarray(frames), jnp.asarray(c), jnp.asarray(s),
                                                        jnp.asarray(r), jnp.asarray(f), jnp.asarray(pn), out_size=S))
    assert got.dtype == want.dtype == np.float64
    ulp = np.spacing(np.float32(255.0)) * pn.max() / 255.0 / IMG_NORM_STD.min()
    np.testing.assert_allclose(got, want, rtol=0, atol=ulp * 1.001)
    np.testing.assert_array_equal(got[[1, 3]], want[[1, 3]])
    assert (got != want).mean() < 0.05


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_device_preprocess_matches_host_crop(train):
    """The crop on the card against the host path it replaces (the port's
    `data/transforms.crop`, cv2's warpAffine bit for bit; flip, noise and
    normalization as `NpzDataset` applies them), in the interior."""
    c, s, r, f, pn = _boxes(5)
    frames = _smooth_frames()
    got = _port_preprocess(train, frames, c, s, r, f, pn)
    for i in range(B):
        ref = crop(frames[i].astype(np.float32), c[i], float(s[i]), (S, S), rot=float(r[i]) if train else 0.0)
        if train:
            ref = flip_img(ref) if f[i] else ref
            ref = np.clip(ref * pn[i], 0, 255)
        ref = (ref / 255.0 - IMG_NORM_MEAN) / IMG_NORM_STD
        diff = np.abs(got[i, 2:-2, 2:-2] - ref[2:-2, 2:-2])
        assert np.median(diff) < 0.005 and np.percentile(diff, 95) < 0.01 and diff.max() < 0.05, (i, diff.max())


# --------------------------------------------------------------------------
# the callers: the pose harness, the LSP eval, the training step
# --------------------------------------------------------------------------

def _stand_in_infer(img, xp):
    """f64 para from the images (tests/test_data.py's stand-in): the
    camera fixed, the betas the images' mean x 1e-3 (summed in f64: the
    crops are fp32 in both packages), every rotation the identity; so the
    crop is live in the metrics."""
    b = img.shape[0]
    if xp is jnp:
        cam, rot = jnp.tile(jnp.asarray([[0.9, 0.0, 0.0]]), (b, 1)), jnp.tile(jnp.eye(3).reshape(1, 9), (b, 24))
        mean = jnp.mean(img.astype(jnp.float64), axis=(1, 2, 3))
        return jnp.concatenate([cam, jnp.tile(mean[:, None] * 1e-3, (1, 10)), rot], 1)
    cam = torch.tensor([[0.9, 0.0, 0.0]], dtype=torch.float64).expand(b, 3)
    rot = torch.eye(3, dtype=torch.float64).reshape(1, 9).repeat(b, 24)
    return torch.cat([cam, (img.double().mean(dim=(1, 2, 3))[:, None] * 1e-3).repeat(1, 10), rot], 1)


def _f64_labels(batches):
    """The loader's batches with centre, scale and the GT in f64, so the
    JAX package computes its thetas and its Procrustes in f64, as the port
    does (JAX centres fp32 GT in fp32 before the f64 alignment)."""
    for b, batch in batches:
        yield b, batch | {k: batch[k].astype(np.float64) for k in ("center", "scale", "pose", "betas", "pose_3d")}


def test_run_pose_eval_device_preprocess_matches_jax_f64(tmp_path, x64_mode):
    """`run_pose_eval(device_preprocess=True)` on the raw frames of a
    written dataset, against JAX's in f64 (1e-9 relative), and against the
    port's own host-crop path (atol 5e-4 m); the crop needs a device."""
    npz, img_dir = write_synthetic_dataset(str(tmp_path), n=6)
    jreg = harness.synthetic_h36m_regressor(300, seed=1)

    def batches(cls, loader_cls, raw):
        ds = cls(npz, img_dir, name="h36m-p2", is_train=False, heatmap_size=16, return_raw=raw)
        return _f64_labels(loader_cls(ds, 3, shuffle=False, drop_last=False).epoch(0))

    jres = jharness.run_pose_eval(lambda img: _stand_in_infer(img, jnp), batches(JNpzDataset, JResumableLoader, True),
                                  "h36m-p2", jax_synthetic_smpl(num_verts=300, seed=0), jreg, log_every=0,
                                  device_preprocess=True)
    smpl = synthetic_smpl_model(num_verts=300, seed=0)
    res = harness.run_pose_eval(lambda img: _stand_in_infer(img, torch), batches(NpzDataset, ResumableLoader, True),
                                "h36m-p2", smpl, jreg, log_every=0, device_preprocess=True, device="cpu")
    host = harness.run_pose_eval(lambda img: _stand_in_infer(img, torch),
                                 batches(NpzDataset, ResumableLoader, False), "h36m-p2", smpl, jreg, log_every=0)
    assert res.mpjpe.dtype == np.float64 and res.mpjpe.shape == (6,) and np.isfinite(res.mpjpe).all()
    np.testing.assert_allclose(res.mpjpe, jres.mpjpe, rtol=1e-9)
    np.testing.assert_allclose(res.pa_mpjpe, jres.pa_mpjpe, rtol=1e-9)
    np.testing.assert_allclose(res.mpjpe, host.mpjpe, rtol=0, atol=5e-4)
    assert not np.array_equal(res.mpjpe, host.mpjpe)      # the two crops differ: the path is live
    with pytest.raises(ValueError, match="device="):
        harness.run_pose_eval(None, [], "h36m-p2", smpl, jreg, device_preprocess=True)


def test_run_lsp_eval_device_preprocess(tmp_path):
    """`run_lsp_eval(device_preprocess=True)` on raw frames prints and
    returns the scores of the same eval fed the crops that
    `device_preprocess` makes of those frames (the JAX CLI's LSP path has
    no raw-frame mode to hold it against); the crop needs a device."""
    from danet_densepose2smpl_tpu_torch.cli.eval import with_gt_masks

    npz, img_dir, annot_dir = write_synthetic_dataset(str(tmp_path), n=2, img_size=96, with_lsp_masks=True)
    smpl = synthetic_smpl_model(num_verts=200, seed=0)
    paras = np.concatenate([np.tile([[0.8, 0.0, 0.0]], (2, 1)), np.random.RandomState(6).randn(2, 10) * 0.3,
                            np.tile(np.eye(3).reshape(1, 9), (2, 24))], 1).astype(np.float32)

    def infer(img):      # the crops move the camera, so they must agree
        return _t(paras) + torch.cat([1e-2 * img.mean(dim=(1, 2, 3))[:, None], torch.zeros(2, 228)], 1)

    ds = NpzDataset(npz, img_dir, name="lsp", is_train=False, heatmap_size=16, return_raw=True)
    raw = list(with_gt_masks(ResumableLoader(ds, 2, shuffle=False).epoch(0), annot_dir))
    cropped = [(b, batch | {"img": pipeline.device_preprocess(_t(batch["raw_img"]), _t(batch["center"]),
                                                             _t(batch["scale"]))}) for b, batch in raw]
    got = run_lsp_eval(infer, raw, smpl, img_size=32, log_every=0, device_preprocess=True, device="cpu")
    want = run_lsp_eval(infer, cropped, smpl, img_size=32, log_every=0)
    assert got == want and all(0.0 <= v <= 1.0 for v in got.values()) and got["Accuracy"] < 1.0
    with pytest.raises(ValueError, match="device="):
        run_lsp_eval(infer, raw, smpl, img_size=32, device_preprocess=True)


def test_train_step_on_raw_frames_equals_step_on_their_crops():
    """One f64 step on a batch of raw frames (the crop, flip and noise on
    the model's device, inside the step) equals the same step on the batch
    whose img is `device_preprocess_train` of those frames: losses,
    parameters and BatchNorm statistics. JAX's step on a raw batch is held
    by `tests/test_torch_train.py::test_train_step_matches_jax_f64`."""
    cfg = Config(danet=DaNetConfig(img_size=64, heatmap_size=16, hrnet_width=18))
    rng = np.random.RandomState(8)
    raw = synthetic_raw_batch(cfg, 2, seed=9, num_dp_points=20)
    del raw["img"]
    raw |= {"raw_img": rng.randint(0, 256, (2, 90, 70, 3)).astype(np.uint8),
            "center": np.array([[35.0, 45.0], [30.0, 50.0]], np.float32),
            "scale": np.array([0.3, 0.35], np.float32), "rot_angle": np.array([0.0, 17.0], np.float32),
            "is_flipped": np.array([1.0, 0.0], np.float32),
            "pixel_noise": rng.uniform(0.6, 1.4, (2, 3)).astype(np.float32)}
    smpl = synthetic_smpl_model()
    model = random_init_(DaNet(cfg.danet), seed=3).double()
    runs = []
    for crop_first in (False, True):
        batch = batch_to_device(raw, "cpu", torch.float64)
        assert batch["raw_img"].dtype == torch.uint8
        if crop_first:
            batch["img"] = pipeline.device_preprocess_train(
                batch.pop("raw_img"), batch["center"], batch["scale"], batch["rot_angle"], batch["is_flipped"],
                batch.pop("pixel_noise"), out_size=64)
            assert batch["img"].dtype == torch.float64       # f64 pixel_noise
        state = create_train_state(copy.deepcopy(model), cfg)
        step = make_train_step(state.model, smpl, cfg, renderer=IUVRenderer(synthetic_densepose_atlas(smpl), 64, 16))
        state, metrics = step(state, batch, torch.Generator().manual_seed(5))
        runs.append((metrics, state.model.state_dict()))
    (m0, sd0), (m1, sd1) = runs
    assert set(m0) == set(m1) and all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)
