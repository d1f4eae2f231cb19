"""The port's demo (`cli/demo.py`) against the body of the JAX demo's
`infer` (`cli/demo.py:59-68` of the JAX package, rebuilt here: the JAX
CLI's matplotlib figure is not comparable), on the same weights carried
across with `port.state_dict_from_flax`, in f64 (JAX's x64): a narrow
HRNet (W18) DaNet at 64 px, the synthetic 500-vertex SMPL body and its
atlas. Then the CLI end to end on the CPU: one PNG per input whose tiles
are the panels it returned, and its refusal without a card.

Bars: every panel within 1e-9; the renders (the IUV render and the two
shaded views) within 1e-9 but on at most 1e-4 of their pixels, where a
vertex an ulp away moves an edge across a pixel centre."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from danet_densepose2smpl_tpu.kernels.rasterizer import IUVRenderer as JIUVRenderer
from danet_densepose2smpl_tpu.kernels.rasterizer import render_shaded as jax_render_shaded
from danet_densepose2smpl_tpu.models.danet import DaNet as JDaNet
from danet_densepose2smpl_tpu.ops.iuvmap import iuv_map2img as jax_iuv_map2img
from danet_densepose2smpl_tpu.smpl.densepose_atlas import synthetic_densepose_atlas as jax_atlas
from danet_densepose2smpl_tpu.smpl.loader import synthetic_smpl_model as jax_smpl_model
from danet_densepose2smpl_tpu.smpl.model import smpl_forward as jax_smpl_forward
from danet_densepose2smpl_tpu.utils import vis as jvis

from danet_densepose2smpl_tpu_torch.cli import demo
from danet_densepose2smpl_tpu_torch.config import DaNetConfig
from danet_densepose2smpl_tpu_torch.data.image_io import read_png, read_rgb, write_png
from danet_densepose2smpl_tpu_torch.data.transforms import demo_frame
from danet_densepose2smpl_tpu_torch.kernels import rasterizer as R
from danet_densepose2smpl_tpu_torch.kernels.part_crop_head import fused_part_predict
from danet_densepose2smpl_tpu_torch.models.danet import DaNet
from danet_densepose2smpl_tpu_torch.port import state_dict_from_flax
from danet_densepose2smpl_tpu_torch.smpl.densepose_atlas import synthetic_densepose_atlas
from danet_densepose2smpl_tpu_torch.smpl.loader import synthetic_smpl_model, to_torch
from danet_densepose2smpl_tpu_torch.utils import vis

from test_torch_config import jax_cfg
from test_torch_nn import randomize

torch.set_num_threads(1)
SIZE = 64
CFG = DaNetConfig(img_size=SIZE, heatmap_size=SIZE // 4, hrnet_width=18)
YAML = f"DANET:\n  INIMG_SIZE: {SIZE}\n  HEATMAP_SIZE: {SIZE // 4}\n  HRNET_WIDTH: 18\n"
FRAMES = ((90, 60), (48, 80), (64, 64))          # (width, height)
PIXEL_BAR = 1e-4


@pytest.fixture(scope="module")
def flax_variables():
    """Randomized variables whose camera and shape head (the body net's
    final layer) is scaled by 1e-3, its scale bias raised by 1.6: the
    random network then predicts a camera near (2.5, 0, 0) and a body in
    the frame (unscaled, it puts the body hundreds of frames away and
    every render is empty)."""
    v = randomize(JDaNet(jax_cfg(CFG), train=False), jnp.zeros((1, SIZE, SIZE, 3), jnp.float32), seed=5)
    head = v["params"]["iuv2smpl"]["body_net"]["final_layer"]
    head["kernel"] = head["kernel"] * np.float32(1e-3)
    head["bias"] = head["bias"] * np.float32(1e-3) + np.eye(13, dtype=np.float32)[0] * np.float32(1.6)
    return v


@pytest.fixture
def x64_mode():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def write_frames(d) -> list:
    """Random RGB PNG frames of the `FRAMES` sizes under `d`."""
    rng = np.random.RandomState(0)
    paths = []
    for i, (w, h) in enumerate(FRAMES):
        paths.append(str(d / f"frame_{i}.png"))
        write_png(paths[-1], rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
    return paths


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64)
                        if np.issubdtype(np.asarray(a).dtype, np.floating) else a, tree)


def _within(got, want, what, pixel_axis=None):
    """Within 1e-9; for a render, on all but PIXEL_BAR of its pixels."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    off = np.abs(got - want) > 1e-9
    if pixel_axis is None:
        assert not off.any(), (what, np.abs(got - want).max())
    else:
        off = off.any(axis=pixel_axis) if pixel_axis else off
        assert off.mean() <= PIXEL_BAR, (what, off.mean())


def test_demo_matches_jax_infer_f64(tmp_path, flax_variables, x64_mode):
    """`demo_outputs` and the panels of each frame against JAX's `infer`
    body and `vis` helpers, f64, on the frames the demo prepares."""
    smpl, jsmpl = synthetic_smpl_model(500, seed=0), jax_smpl_model(500, seed=0)
    atlas, jatlas = synthetic_densepose_atlas(smpl, seed=0), jax_atlas(jsmpl, seed=0)

    model = DaNet(CFG)
    model.load_state_dict(state_dict_from_flax(flax_variables, CFG), strict=True)
    model = model.double()
    smpl_t = to_torch(smpl, "cpu", torch.float64)
    renderer = R.IUVRenderer(atlas, orig_size=SIZE, out_size=SIZE // 4)
    faces = torch.as_tensor(smpl.faces.astype(np.int64))

    jmodel = JDaNet(jax_cfg(CFG), train=False)
    jvars, jsmpl64 = _f64(flax_variables), _f64(jsmpl)
    jrenderer = JIUVRenderer(jatlas, orig_size=SIZE, out_size=SIZE // 4)
    jfaces = jnp.asarray(jsmpl.faces)

    @jax.jit
    def infer(variables, img):                   # the JAX demo's infer, shaded views at the config's size
        out = jmodel.apply(variables, img)
        u, v, i, a = out["iuv_clean"]
        iuv_img = jax_iuv_map2img(u, v, i, a)
        para = out["para"]
        smpl_out = jax_smpl_forward(jsmpl64, para[:, 3:13], para[:, 13:].reshape(-1, 24, 3, 3))
        rendered = jrenderer(smpl_out.vertices, para[:, :3])
        shaded = jax_render_shaded(smpl_out.vertices, jfaces, para[:, :3], out_size=SIZE, orig_size=float(SIZE))
        shaded_side = jax_render_shaded(smpl_out.vertices, jfaces, para[:, :3], out_size=SIZE,
                                        orig_size=float(SIZE), yaw_deg=90.0)
        return iuv_img, out["part_iuv_clean"], rendered, para, shaded, shaded_side

    for path in write_frames(tmp_path):
        norm = demo_frame(read_rgb(path), SIZE)[None].astype(np.float64)
        with torch.no_grad():
            res = demo.demo_outputs(model, smpl_t, renderer, faces, torch.from_numpy(norm), SIZE)
        j_iuv, j_part, j_rendered, j_para, j_shaded, j_side = (np.asarray(a) for a in infer(jvars, jnp.asarray(norm)))
        assert res["para"].dtype == torch.float64 and res["shaded"].shape == (1, SIZE, SIZE)
        _within(res["para"], j_para, "para")
        _within(res["iuv_img"], j_iuv, "iuv_img")
        _within(res["part_iuv"], j_part, "part_iuv")
        _within(res["rendered"], j_rendered, "rendered", pixel_axis=-1)
        _within(res["shaded"], j_shaded, "shaded", pixel_axis=0)
        _within(res["shaded_side"], j_side, "shaded_side", pixel_axis=0)
        assert (j_shaded > 0).mean() > 0.02 and (j_side > 0).mean() > 0.01 and (j_rendered > 0).any()

        host = {k: v[0].numpy() for k, v in res.items()}
        panels = vis.demo_panels(norm[0], host["iuv_img"], vis.partial_iuv_images(host["part_iuv"]),
                                 host["rendered"], host["shaded"], host["shaded_side"])
        want = [jvis.denormalize_image(norm[0]), jvis.iuv_to_rgb(j_iuv[0]),
                jvis.iuv_to_rgb(j_rendered[0]), jvis.part_grid(jvis.partial_iuv_images(j_part[0])),
                np.repeat(j_shaded[0][..., None], 3, -1), np.repeat(j_side[0][..., None], 3, -1)]
        assert [t for t, _ in panels] == list(vis.DEMO_PANELS)
        for (title, got), w in zip(panels, want):
            _within(got, w, title, pixel_axis=-1 if title in vis.DEMO_PANELS[2:3] + vis.DEMO_PANELS[4:] else None)


def test_demo_cli_writes_the_panels(tmp_path, capsys):
    """`cli.demo.main` on the CPU over a directory of frames: one PNG per
    input, each tile equal to round(255 * panel) (in f64) at its offset,
    nearest scaled to the input's height; the JAX line per image; no kernel
    launch on CPU tensors."""
    (tmp_path / "cfg.yaml").write_text(YAML)
    frames = tmp_path / "frames"
    frames.mkdir()
    write_frames(frames)
    fused_part_predict.launches = R.rasterize_flat.launches = 0
    results = demo.main(["--cpu", "--synthetic-assets", "--num_verts", "500", "--cfg", str(tmp_path / "cfg.yaml"),
                         "--imglist", str(frames), "--out_dir", str(tmp_path / "out"), "--use_opendr"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(results) == len(FRAMES) == len(lines)
    assert fused_part_predict.launches == 0 and R.rasterize_flat.launches == 0
    for res, line in zip(results, lines):
        assert line.startswith(f"{res['path']} -> {res['out_path']}  cam=[")
        img = read_png(res["out_path"])
        widths = [SIZE, SIZE, SIZE, 6 * (SIZE // 4), SIZE, SIZE]    # the part grid: 4 x 6 tiles of 16 px
        assert img.shape == (SIZE, sum(widths), 3) and img.std() > 0
        x = 0
        for (title, panel), w in zip(res["panels"], widths):
            f = SIZE // panel.shape[0]
            assert f * panel.shape[1] == w, title
            want = np.round(255 * np.clip(panel.astype(np.float64), 0, 1)).astype(np.uint8)
            np.testing.assert_array_equal(img[::f, x:x + w:f], want, err_msg=title)
            np.testing.assert_array_equal(img[:, x:x + w], np.repeat(np.repeat(want, f, 0), f, 1), err_msg=title)
            x += w


def test_demo_cli_refuses_without_a_card_or_input(tmp_path, monkeypatch):
    (tmp_path / "cfg.yaml").write_text(YAML)
    path = write_frames(tmp_path)[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main(["--synthetic-assets", "--num_verts", "500", "--cfg", str(tmp_path / "cfg.yaml"),
                   "--img", path, "--out_dir", str(tmp_path / "out")])
    with pytest.raises(SystemExit, match="no input images"):
        demo.main(["--cpu", "--synthetic-assets", "--num_verts", "500", "--cfg", str(tmp_path / "cfg.yaml"),
                   "--imglist", str(tmp_path / "empty"), "--out_dir", str(tmp_path / "out")])
