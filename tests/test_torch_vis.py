"""The port's visualization against the JAX package's: `iuv_map2img`,
`render_shaded`, the demo's frame preparation against cv2, the drawing
helpers against cv2 pixel for pixel, the grid and panel helpers, and the
Trainer's vis step (`_save_vis`) on host-cropped and raw batches.

Bars: `iuv_map2img` and the panel helpers equal; `render_shaded` in f64
within 1e-12 with at most 1e-4 of the pixels exempt, in fp32 the
foregrounds differ on at most 1e-3 of the pixels and the shades agree
within 1e-6 where both have a face, but on at most 1e-3 of the pixels
(depth ties an ulp decides); the frame within 1e-3 of cv2 on the 0-255
scale; drawn pixels equal."""

import os

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from danet_densepose2smpl_tpu.constants import IMG_NORM_MEAN as J_MEAN, IMG_NORM_STD as J_STD
from danet_densepose2smpl_tpu.kernels.rasterizer import render_shaded as jax_render_shaded
from danet_densepose2smpl_tpu.ops.iuvmap import iuv_map2img as jax_iuv_map2img
from danet_densepose2smpl_tpu.smpl import densepose_atlas as jatlas
from danet_densepose2smpl_tpu.smpl import smpl_forward_aa as jax_smpl_forward_aa
from danet_densepose2smpl_tpu.smpl.loader import synthetic_smpl_model as jax_synthetic_smpl
from danet_densepose2smpl_tpu.utils import vis as jvis

from danet_densepose2smpl_tpu_torch.config import Config, DaNetConfig, TrainConfig
from danet_densepose2smpl_tpu_torch.data.dataset import NpzDataset
from danet_densepose2smpl_tpu_torch.data.image_io import read_png
from danet_densepose2smpl_tpu_torch.data.pipeline import device_preprocess_train
from danet_densepose2smpl_tpu_torch.data.synthetic import write_synthetic_dataset
from danet_densepose2smpl_tpu_torch.data.transforms import demo_frame, pad_to_square
from danet_densepose2smpl_tpu_torch.kernels import rasterizer as R
from danet_densepose2smpl_tpu_torch.ops.iuvmap import iuv_map2img
from danet_densepose2smpl_tpu_torch.ops.structure import DP2SMPL_MAPPING
from danet_densepose2smpl_tpu_torch.smpl.densepose_atlas import synthetic_densepose_atlas
from danet_densepose2smpl_tpu_torch.smpl.loader import synthetic_smpl_model
from danet_densepose2smpl_tpu_torch.train.fits_dict import FitsDict
from danet_densepose2smpl_tpu_torch.train.trainer import Trainer
from danet_densepose2smpl_tpu_torch.utils import vis

torch.set_num_threads(1)
S = 64


@pytest.fixture
def x64_mode():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


# --------------------------------------------------------------------------
# iuv_map2img and the panel helpers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["plain", "ann", "mapping"])
def test_iuv_map2img_matches_jax(case):
    rng = np.random.RandomState(0)
    k = 7 if case == "mapping" else 25
    u, v = rng.rand(2, 3, 9, 11, k).astype(np.float32)
    i = rng.randn(3, 9, 11, k).astype(np.float32)
    ann = rng.randn(3, 9, 11, 15).astype(np.float32) if case == "ann" else None
    mapping = [0] + list(DP2SMPL_MAPPING[5]) if case == "mapping" else None
    got = iuv_map2img(*(torch.from_numpy(a) for a in (u, v, i)),
                      ann_map=None if ann is None else torch.from_numpy(ann), ind_mapping=mapping).numpy()
    want = np.asarray(jax_iuv_map2img(u, v, i, ann_map=ann, ind_mapping=mapping))
    assert got.shape == (3, 9, 11, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if case == "ann":
        assert (got[..., 0] == 0).mean() > 0.03          # background forced where the ann argmax is 0


def test_panel_helpers_match_jax(x64_mode):
    rng = np.random.RandomState(1)
    img = rng.randn(S, S, 3).astype(np.float32)
    np.testing.assert_array_equal(vis.denormalize_image(img), jvis.denormalize_image(img))
    iuv = rng.uniform(-0.2, 1.2, (S, S, 3))
    np.testing.assert_array_equal(vis.iuv_to_rgb(iuv), jvis.iuv_to_rgb(iuv))
    parts = rng.uniform(-0.2, 1.2, (24, 16, 16, 3)).astype(np.float32)
    np.testing.assert_array_equal(vis.part_grid(parts), jvis.part_grid(parts))
    hm = rng.randn(16, 16, 24).astype(np.float32)
    hm[..., 3] = 0.5                                           # a flat tile
    np.testing.assert_array_equal(vis.heatmap_grid(hm), jvis.heatmap_grid(hm))
    # cleaned partial stacks (one-hot index, masked U/V), f32 and f64
    for dt in (np.float32, np.float64):
        idx = np.eye(7, dtype=dt)[rng.randint(0, 7, (24, 16, 16))]
        stack = np.stack([idx * rng.rand(24, 16, 16, 7), idx * rng.rand(24, 16, 16, 7), idx], axis=-2).astype(dt)
        got = vis.partial_iuv_images(stack)
        assert got.shape == (24, 16, 16, 3) and got.dtype == dt
        np.testing.assert_array_equal(got, jvis.partial_iuv_images(stack))


def test_tile_scales_by_integer_factors_and_refuses_others():
    a = np.full((16, 16, 3), 0.5)
    b = np.linspace(0, 1, 64 * 96).reshape(64, 96)
    out = vis.tile([[a, b]], 64)
    assert out.shape == (64, 64 + 96, 3) and out.dtype == np.uint8
    assert (out[:, :64] == 128).all()
    np.testing.assert_array_equal(out[:, 64:, 1], np.round(255 * b).astype(np.uint8))
    two = vis.tile([[a], [a, a]], 32)
    assert two.shape == (64, 64, 3) and (two[:32, 32:] == 0).all()
    with pytest.raises(ValueError, match="integer factor"):
        vis.tile([[np.zeros((24, 24, 3))]], 64)


# --------------------------------------------------------------------------
# drawing: pixel for pixel as cv2 draws (the JAX helpers call cv2)
# --------------------------------------------------------------------------

def test_draw_skeleton_and_points_equal_cv2():
    rng = np.random.RandomState(2)
    for t in range(60):
        h, w = rng.randint(20, 90, 2)
        img = rng.rand(h, w, 3).astype(np.float32)
        lo = -40 if t % 2 else -400
        joints = np.stack([rng.uniform(lo, w - lo, 24), rng.uniform(lo, h - lo, 24)], 1)
        got, want = vis.draw_skeleton(img, joints), jvis.draw_skeleton(img, joints)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        pts = np.stack([rng.uniform(-5, w + 5, 24), rng.uniform(-5, h + 5, 24)], 1)
        np.testing.assert_array_equal(vis.draw_points(img, pts), jvis.draw_points(img, pts))
        r = int(rng.randint(1, 6))
        np.testing.assert_array_equal(vis.draw_points(img, pts, color=(0.3, 1.0, 0.0), radius=r),
                                      jvis.draw_points(img, pts, color=(0.3, 1.0, 0.0), radius=r))


def test_line_and_circle_pixels_equal_cv2():
    """The primitives on random segments (far off the frame too) and discs
    of radius 0-5 cut by the frame's edges."""
    rng = np.random.RandomState(3)
    white = np.array([255, 255, 255], np.uint8)
    for t in range(1500):
        h, w = (int(x) for x in rng.randint(3, 70, 2))
        lo = -30 if t % 3 else -3000
        p1, p2 = (tuple(int(x) for x in rng.randint(lo, max(h, w) - lo, 2)) for _ in range(2))
        want = cv2.line(np.zeros((h, w, 3), np.uint8), p1, p2, (255, 255, 255), 1)
        got = np.zeros((h, w, 3), np.uint8)
        vis._paint(got, vis.line_pixels(w, h, p1, p2), white)
        np.testing.assert_array_equal(got, want, err_msg=f"line {p1} {p2} on {w}x{h}")
        c, r = tuple(int(x) for x in rng.randint(-6, max(h, w) + 6, 2)), int(rng.randint(0, 6))
        want = cv2.circle(np.zeros((h, w, 3), np.uint8), c, r, (255, 255, 255), -1)
        got = np.zeros((h, w, 3), np.uint8)
        vis._paint(got, vis.circle_pixels(w, h, c, r), white)
        np.testing.assert_array_equal(got, want, err_msg=f"circle {c} r={r} on {w}x{h}")


# --------------------------------------------------------------------------
# the demo's frame preparation
# --------------------------------------------------------------------------

@pytest.mark.parametrize("w,h", [(448, 448), (300, 200), (200, 300), (100, 100), (640, 480)])
def test_demo_frame_matches_cv2(w, h):
    """The JAX demo's copyMakeBorder + resize + normalize (cli/demo.py:73-79)."""
    img = np.random.RandomState(w + h).randint(0, 256, (h, w, 3)).astype(np.uint8)
    f = img.astype(np.float32)
    side = max(h, w)
    square = cv2.copyMakeBorder(f, 0, side - h, 0, side - w, cv2.BORDER_CONSTANT)
    np.testing.assert_array_equal(pad_to_square(f), square)
    want = ((cv2.resize(square, (224, 224)) / 255.0 - J_MEAN) / J_STD).astype(np.float32)
    got = demo_frame(img)
    assert got.shape == (224, 224, 3) and got.dtype == np.float32
    assert np.abs(got - want).max() * 255 * J_STD.max() <= 1e-3


# --------------------------------------------------------------------------
# render_shaded
# --------------------------------------------------------------------------

def _shaded_scene(mesh: str):
    """B=2 posed synthetic SMPL bodies (500 vertices) or closed test meshes
    (local faces, the real mesh's kind), and their cameras."""
    rng = np.random.RandomState(4)
    if mesh == "smpl":
        smpl = jax_synthetic_smpl(500, seed=0)
        verts = np.asarray(jax_smpl_forward_aa(smpl, jnp.asarray(rng.randn(2, 10) * 0.5, jnp.float32),
                                               jnp.asarray(rng.randn(2, 72) * 0.3, jnp.float32)).vertices)
        faces = np.asarray(smpl.faces)
    else:
        v, faces = jatlas.closed_test_mesh(500, seed=0)
        verts = np.stack([v * (1 + 0.1 * rng.randn()) + rng.randn(3) * 0.05 for _ in range(2)]).astype(np.float32)
    cam = np.array([[2.5, 0.02, -0.05], [2.2, -0.04, 0.03]], np.float32)   # bodies of ~1/3 of the frame
    return np.array(verts), faces.astype(np.int64), cam


@pytest.mark.parametrize("mesh", ["smpl", "closed"])
@pytest.mark.parametrize("yaw", [0.0, 90.0])
def test_render_shaded_matches_jax_f64(mesh, yaw, x64_mode):
    verts, faces, cam = _shaded_scene(mesh)
    got = R.render_shaded(torch.from_numpy(verts).double(), torch.from_numpy(faces), torch.from_numpy(cam).double(),
                          out_size=S, orig_size=float(S), yaw_deg=yaw).numpy()
    want = np.asarray(jax_render_shaded(jnp.asarray(verts, jnp.float64), jnp.asarray(faces),
                                        jnp.asarray(cam, jnp.float64), out_size=S, orig_size=float(S), yaw_deg=yaw))
    assert got.shape == (2, S, S) and got.dtype == np.float64
    off = np.abs(got - want) > 1e-12
    assert off.mean() <= 1e-4, off.mean()
    fg = want > 0
    assert 0.02 < fg.mean() < 0.98 and (got[fg] >= 0.35 - 1e-12).all() and (got <= 1.0).all()


@pytest.mark.parametrize("mesh", ["smpl", "closed"])
@pytest.mark.parametrize("yaw", [0.0, 90.0])
def test_render_shaded_matches_jax_f32(mesh, yaw):
    verts, faces, cam = _shaded_scene(mesh)
    got = R.render_shaded(torch.from_numpy(verts), torch.from_numpy(faces), torch.from_numpy(cam),
                          out_size=S, orig_size=float(S), yaw_deg=yaw).numpy()
    want = np.asarray(jax_render_shaded(jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(cam),
                                        out_size=S, orig_size=float(S), yaw_deg=yaw))
    assert got.shape == (2, S, S) and got.dtype == np.float32
    assert ((got > 0) != (want > 0)).mean() <= 1e-3
    # where both have a face, the shades agree within 1e-6 but on the
    # pixels of a depth tie that an ulp decides (the other face's shade),
    # which the same 1e-3 of the pixels bounds
    both = (got > 0) & (want > 0)
    assert both.mean() > 0.02
    assert (both & (np.abs(got - want) > 1e-6)).mean() <= 1e-3


def test_render_shaded_yaw_turns_the_view_and_keeps_the_centre():
    """A side view differs from the front view; yaw 360 gives the front
    view back to fp32 rounding."""
    verts, faces, cam = (torch.from_numpy(a) for a in _shaded_scene("closed"))
    front = R.render_shaded(verts, faces, cam, out_size=S, orig_size=float(S))
    side = R.render_shaded(verts, faces, cam, out_size=S, orig_size=float(S), yaw_deg=90.0)
    round_trip = R.render_shaded(verts.double(), faces, cam.double(), out_size=S, orig_size=float(S), yaw_deg=360.0)
    assert ((front > 0) != (side > 0)).float().mean() > 0.01
    assert ((front > 0) != (round_trip > 0)).float().mean() <= 1e-3
    assert R.rasterize_flat.launches == 0                 # CPU tensors run the plain version


# --------------------------------------------------------------------------
# the Trainer's vis step
# --------------------------------------------------------------------------

def _trainer(tmp_path, raw: bool):
    npz, img_dir = write_synthetic_dataset(str(tmp_path / "data"), n=4, with_dp=True, img_size=96)
    ds = NpzDataset(npz, img_dir, name="h36m", heatmap_size=S // 4, return_raw=raw)
    cfg = Config(danet=DaNetConfig(img_size=S, heatmap_size=S // 4, hrnet_width=18),
                 train=TrainConfig(batch_size=4, vis_interval=1, prefetch_workers=0))
    smpl = synthetic_smpl_model(num_verts=300, seed=0)
    renderer = R.IUVRenderer(synthetic_densepose_atlas(smpl, seed=0), orig_size=S, out_size=S // 4)
    return Trainer(cfg, ds if raw else _Crop64(ds), smpl, renderer, FitsDict.from_datasets({"h36m": ds}),
                   str(tmp_path / "run"), device="cpu")


@pytest.mark.parametrize("raw", [False, True], ids=["host_crop", "raw"])
def test_save_vis_writes_both_sheets_with_jax_input_panels(tmp_path, raw):
    trainer = _trainer(tmp_path, raw)
    batch = trainer._device_batch(next(iter(trainer.loader.epoch(0)))[1])
    assert ("raw_img" in batch) == raw
    model = trainer.state.model
    model.train()
    rows, sheets = trainer.vis_panels(batch)
    assert model.training                                   # the train/eval state comes back
    assert [t for t, _ in rows] == ["input / GT kps / STN", "pred IUV", "rendered IUV (pred)", "pred mesh overlay"]
    assert [t for t, _ in sheets] == ["24-part partial IUV (pred)", "24 joint heatmaps"]
    assert all(len(p) == 4 for _, p in rows) and sheets[0][1].shape == sheets[1][1].shape == (64, 96, 3)

    # the input row: JAX's helpers on the same images, keypoints and STN centres
    if raw:
        imgs = device_preprocess_train(batch["raw_img"], batch["center"], batch["scale"], batch["rot_angle"],
                                       batch["is_flipped"], batch["pixel_noise"], out_size=S)
    else:
        imgs = batch["img"]
    model.eval()
    with torch.no_grad():
        centers = model(imgs)["iuv_raw"]["stn_centers"].numpy()
    model.train()
    kps = batch["smpl_2dkps"].numpy()
    for k, panel in enumerate(rows[0][1]):
        want = jvis.draw_points(jvis.draw_skeleton(jvis.denormalize_image(imgs[k].numpy()),
                                                   0.5 * S * (kps[k, :, :2] + 1.0)),
                                0.5 * S * (centers[k] + 1.0))
        np.testing.assert_array_equal(panel, want)
    for _, panels in rows[1:]:
        assert all(p.shape[-1] == 3 and np.isfinite(p).all() and p.min() >= 0 and p.max() <= 1 for p in panels)

    trainer._save_vis(batch, 12)
    main = read_png(str(tmp_path / "run" / "vis" / "step_0000012.png"))
    parts = read_png(str(tmp_path / "run" / "vis" / "step_0000012_parts.png"))
    assert main.shape == (4 * S, 4 * S, 3) and parts.shape == (64, 2 * 96, 3)
    np.testing.assert_array_equal(main[:S, S:2 * S], vis.to_uint8(rows[0][1][1]))
    assert sorted(os.listdir(tmp_path / "run" / "vis")) == ["step_0000012.png", "step_0000012_parts.png"]


class _Crop64:
    """Host-cropped samples at the model's 64 px."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i, rng=None):
        from danet_densepose2smpl_tpu_torch.data.transforms import resize_bilinear

        item = self.ds.__getitem__(i, rng=rng)
        item["img"] = resize_bilinear(item["img"], (S, S))
        return item

