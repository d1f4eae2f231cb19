"""The port's eval path against the JAX package on the CPU: Procrustes and
MPJPE, the streaming segmentation scores, the pose harness (`make_eval_step`
with the 3DPW gendered branch, `run_pose_eval` with the H36M-P2 per-action
table), `uncrop` against cv2, and the LSP segmentation eval in both of its
modes against `cli/eval.py::run_lsp_eval`.

Inputs are made with numpy from a seed; the f64 cases run JAX with x64 on.
Bars: 1e-9 relative on the pose metrics in f64 (SVDs and sums of two
libraries), exact equality on label maps and counts."""

import argparse
import os

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from danet_densepose2smpl_tpu.cli.eval import run_lsp_eval as jax_run_lsp_eval
from danet_densepose2smpl_tpu.data.dataset import NpzDataset
from danet_densepose2smpl_tpu.data.loader import ResumableLoader
from danet_densepose2smpl_tpu.data.synthetic import write_synthetic_dataset
from danet_densepose2smpl_tpu.data.transforms import get_transform as jax_get_transform
from danet_densepose2smpl_tpu.data.transforms import uncrop as jax_uncrop
from danet_densepose2smpl_tpu.eval import harness as jharness
from danet_densepose2smpl_tpu.eval import metrics as jmetrics
from danet_densepose2smpl_tpu.ops import procrustes as jprocrustes
from danet_densepose2smpl_tpu.ops.rotations import batch_rodrigues as jax_rodrigues
from danet_densepose2smpl_tpu.smpl import smpl_forward_aa as jax_smpl_forward_aa
from danet_densepose2smpl_tpu.smpl.loader import synthetic_smpl_model as jax_synthetic_smpl

from danet_densepose2smpl_tpu_torch.config import Config, DaNetConfig
from danet_densepose2smpl_tpu_torch.data.transforms import get_transform, uncrop
from danet_densepose2smpl_tpu_torch.eval import harness, metrics
from danet_densepose2smpl_tpu_torch.eval.lsp import run_lsp_eval
from danet_densepose2smpl_tpu_torch.ops import procrustes
from danet_densepose2smpl_tpu_torch.parallel import Mesh
from danet_densepose2smpl_tpu_torch.smpl.loader import synthetic_smpl_model

from test_torch_config import jax_cfg

torch.set_num_threads(1)
NV = 300
RENDER = 96      # the LSP test's render size


@pytest.fixture
def x64_mode():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# Procrustes, MPJPE, segmentation scores
# --------------------------------------------------------------------------

def _point_sets(case, rng):
    s2 = rng.randn(4, 14, 3)
    if case == "random":
        s1 = rng.randn(4, 14, 3)
    elif case == "similar":        # a rotated, scaled, shifted copy plus noise
        rot = np.asarray(jax_rodrigues(jnp.asarray(rng.randn(4, 3))))
        s1 = 1.7 * np.einsum("bij,bnj->bni", rot, s2) + rng.randn(4, 1, 3) + 1e-3 * rng.randn(4, 14, 3)
    elif case == "reflection":     # the best orthogonal map is a mirror: the det-sign fix
        s1 = s2 * np.array([-1.0, 1.0, 1.0]) + 1e-2 * rng.randn(4, 14, 3)
    else:                          # zero variance: a constant point set, and an all-zero pair
        s1 = np.repeat(rng.randn(4, 1, 3), 14, axis=1)
        s1[0], s2[0] = 0.0, 0.0
    return s1, s2


@pytest.mark.parametrize("case", ["random", "similar", "reflection", "zero_variance"])
def test_procrustes_matches_jax(case, rng, x64_mode):
    s1, s2 = _point_sets(case, rng)
    exp_hat = np.asarray(jprocrustes.similarity_align(jnp.asarray(s1), jnp.asarray(s2)))
    exp_err = np.asarray(jprocrustes.reconstruction_error(jnp.asarray(s1), jnp.asarray(s2)))
    got_hat = procrustes.similarity_align(_t(s1), _t(s2)).numpy()
    got_err = procrustes.reconstruction_error(_t(s1), _t(s2)).numpy()
    assert np.isfinite(got_hat).all() and np.isfinite(got_err).all()
    np.testing.assert_allclose(got_hat, exp_hat, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got_err, exp_err, rtol=1e-9, atol=1e-12)
    if case == "similar":
        assert got_err.max() < 1e-2
    if case == "zero_variance":
        assert got_err[0] == 0.0
    # f32 runs too, within f32 noise
    got32 = procrustes.reconstruction_error(_t(s1).float(), _t(s2).float()).numpy()
    np.testing.assert_allclose(got32, exp_err, rtol=1e-4, atol=1e-5)


def test_compute_mpjpe_matches_jax(rng, x64_mode):
    pred, gt = rng.randn(5, 14, 3) * 0.3, rng.randn(5, 14, 3) * 0.3
    exp = [np.asarray(a) for a in jmetrics.compute_mpjpe(jnp.asarray(pred), jnp.asarray(gt))]
    got = [a.numpy() for a in metrics.compute_mpjpe(_t(pred), _t(gt))]
    for g, e in zip(got, exp):
        np.testing.assert_allclose(g, e, rtol=1e-9)


def test_segmentation_scores_match_jax(rng):
    ours, theirs = metrics.SegmentationScores(7), jmetrics.SegmentationScores(num_classes=7)
    for _ in range(3):
        pred = rng.randint(0, 8, (30, 40))
        gt = rng.randint(0, 8, (30, 40))
        gt[rng.rand(30, 40) < 0.1] = 255          # labels outside the classes count for accuracy only
        ours.update(_t(pred), _t(gt))
        theirs.update(pred, gt)
    assert ours.accuracy == theirs.accuracy
    np.testing.assert_array_equal(ours.f1, theirs.f1)
    tp, fp, fn = ours.counts()
    np.testing.assert_array_equal(np.stack([tp, fp, fn]), np.stack([theirs.tp, theirs.fp, theirs.fn]))
    # `keep` drops pixels from the class counts but not from the accuracy
    kept = metrics.SegmentationScores(7)
    keep = gt != 255
    kept.update(_t(pred), _t(gt), keep=_t(keep))
    ref = jmetrics.SegmentationScores(num_classes=7)
    ref.update(pred[keep], gt[keep])
    np.testing.assert_array_equal(np.stack(kept.counts()), np.stack([ref.tp, ref.fp, ref.fn]))
    assert kept.total == gt.size


# --------------------------------------------------------------------------
# the pose harness
# --------------------------------------------------------------------------

def _pose_batches(n_batches, b, seed, f64=True):
    rng = np.random.RandomState(seed)
    dt = np.float64 if f64 else np.float32
    out = []
    for i in range(n_batches):
        out.append({
            "img": np.zeros((b, 8, 8, 3), dt),
            "pose": (rng.randn(b, 72) * 0.2).astype(dt),
            "betas": (rng.randn(b, 10) * 0.3).astype(dt),
            "gender": rng.randint(0, 2, b).astype(np.int32),
            "pose_3d": np.concatenate([rng.randn(b, 24, 3) * 0.2, np.ones((b, 24, 1))], -1).astype(dt),
            "sample_index": np.arange(i * b, (i + 1) * b, dtype=np.int32),
        })
    return out


def _fixed_para(b, seed):
    """A batch of plausible para: camera, shape and rotations of small poses."""
    rng = np.random.RandomState(seed)
    rot = np.asarray(jax_rodrigues(jnp.asarray(rng.randn(b * 24, 3) * 0.2))).reshape(b, 216)
    return np.concatenate([np.tile([0.9, 0.0, 0.0], (b, 1)), rng.randn(b, 10) * 0.3, rot], 1)


@pytest.mark.parametrize("gendered", [False, True])
def test_make_eval_step_matches_jax_f64(gendered, x64_mode):
    """One step on fixed para in f64, within 1e-9 relative: the neutral
    prediction against pose_3d, and the 3DPW branch against gendered GT
    meshes (distinct male and female models)."""
    b = 4
    para = _fixed_para(b, 1)
    batch = _pose_batches(1, b, 2)[0]
    jreg = harness.synthetic_h36m_regressor(NV, seed=1)
    np.testing.assert_array_equal(jreg, jharness.synthetic_h36m_regressor(NV, seed=1))
    models = [(jax_synthetic_smpl(NV, seed=s), synthetic_smpl_model(NV, seed=s)) for s in (0, 3, 4)]
    mh, mg = np.arange(14) + 3, np.arange(14)
    jstep = jharness.make_eval_step(lambda img: jnp.asarray(para), models[0][0], jreg, mh, mg, gendered,
                                    models[1][0], models[2][0])
    (jm, jpa), jp = jstep(*(jnp.asarray(batch[k]) for k in ("img", "pose", "betas", "gender", "pose_3d")))
    step = harness.make_eval_step(lambda img: _t(para), models[0][1], jreg, mh, mg, gendered,
                                  models[1][1], models[2][1])
    (m, pa), p = step(_t(batch["img"]), batch["pose"], batch["betas"], batch["gender"], batch["pose_3d"])
    assert m.dtype == torch.float64 and m.shape == (b,)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-9)
    np.testing.assert_allclose(pa.numpy(), np.asarray(jpa), rtol=1e-9)


def test_run_pose_eval_per_action_matches_jax(x64_mode, capsys):
    """h36m-p2 over 3 batches: per-sample errors, the per-action table, the
    log lines and the summary agree with the JAX harness. Each batch's
    images carry its index, which picks its para (the JAX step is traced
    once)."""
    b = 4
    batches = _pose_batches(3, b, 5)
    for i, bt in enumerate(batches):
        bt["img"][:, 0, 0, 0] = i
    names = np.array([f"images/S9_{act}.5427_{i:04d}.jpg" for i, act in
                      enumerate(["Walking", "Eating", "Posing"] * 4)])
    jreg = harness.synthetic_h36m_regressor(NV, seed=2)
    paras = np.stack([_fixed_para(b, 10 + i) for i in range(3)])

    jres = jharness.run_pose_eval(lambda img: jnp.asarray(paras)[img[0, 0, 0, 0].astype(jnp.int32)],
                                  list(enumerate(batches)), "h36m-p2", jax_synthetic_smpl(NV), jreg,
                                  imgnames=names, log_every=1)
    jout = capsys.readouterr().out
    res = harness.run_pose_eval(lambda img: _t(paras[int(img[0, 0, 0, 0])]), enumerate(batches), "h36m-p2",
                                synthetic_smpl_model(NV), jreg, imgnames=names, log_every=1)
    out = capsys.readouterr().out
    np.testing.assert_allclose(res.mpjpe, jres.mpjpe, rtol=1e-9)
    np.testing.assert_allclose(res.pa_mpjpe, jres.pa_mpjpe, rtol=1e-9)
    assert set(res.per_action) == set(jres.per_action) == {"Walking", "Eating", "Posing"}
    for act in res.per_action:
        np.testing.assert_allclose(res.per_action[act], jres.per_action[act], rtol=1e-9)
    assert out.count("batch ") == 3 and out == jout
    summary = res.summary("h36m-p2")
    assert summary == jres.summary("h36m-p2") and "per-action PA-MPJPE:" in summary
    assert harness.h36m_action_of("a/b/S9_Eating.123_1.jpg") == "Eating"


def test_unported_eval_options_raise():
    """mesh= (data-parallel eval, item 19) is ported
    (`tests/test_torch_parallel.py`): a batch its ranks do not divide
    raises before any collective. device_preprocess
    (item 16) is ported: it needs the device the crop runs on, and then
    the step takes raw uint8 frames with their centres and scales and
    hands the model normalized 224 px crops (`tests/test_torch_ingest.py`
    holds its results against JAX's)."""
    two = Mesh(0, 2, torch.device("cpu"), "gloo")
    odd = list(enumerate(_pose_batches(1, 3, 3)))
    with pytest.raises(ValueError, match="does not divide over 2 ranks"):
        harness.run_pose_eval(None, odd, "h36m-p1", synthetic_smpl_model(NV), np.zeros((17, NV)), mesh=two)
    step = harness.make_eval_step(None, synthetic_smpl_model(NV), np.zeros((17, NV)), np.arange(14), np.arange(14),
                                  False, mesh=two)
    with pytest.raises(ValueError, match="does not divide over 2 ranks"):
        step(*(odd[0][1][k] for k in ("img", "pose", "betas", "gender", "pose_3d")))
    with pytest.raises(ValueError, match="device="):
        harness.run_pose_eval(None, [], "h36m-p1", synthetic_smpl_model(NV), None, device_preprocess=True)
    with pytest.raises(ValueError, match="device="):
        harness.make_eval_step(None, None, None, None, None, False, device_preprocess=True)
    seen = []

    def infer(img):
        seen.append((img.dtype, tuple(img.shape)))
        return _t(_fixed_para(2, 1))

    batch = _pose_batches(1, 2, 3)[0]
    step = harness.make_eval_step(infer, synthetic_smpl_model(NV), harness.synthetic_h36m_regressor(NV), np.arange(14),
                                  np.arange(14), False, device_preprocess=True, device="cpu")
    frames = np.random.RandomState(4).randint(0, 256, (2, 50, 40, 3)).astype(np.uint8)
    (m, pa), _ = step(_t(frames), batch["pose"], batch["betas"], batch["gender"], batch["pose_3d"],
                      np.array([[20.0, 25.0], [18.0, 30.0]], np.float32), np.array([0.2, 0.15], np.float32))
    assert seen == [(torch.float32, (2, 224, 224, 3))] and bool(torch.isfinite(m).all() & torch.isfinite(pa).all())


# --------------------------------------------------------------------------
# uncrop and the LSP eval
# --------------------------------------------------------------------------

@pytest.mark.parametrize("res", [224, 56])
def test_uncrop_equals_cv2(res):
    """Pixel for pixel against the JAX `uncrop` (cv2.warpAffine,
    INTER_NEAREST) on random centres, scales and original shapes, in one
    batched call."""
    rng = np.random.RandomState(res)
    b = 12
    imgs = rng.randint(0, 7, (b, res, res)).astype(np.uint8)
    shapes = rng.randint(150, 420, (b, 2))
    centers = np.stack([rng.uniform(0, shapes[:, 1]), rng.uniform(0, shapes[:, 0])], 1)
    centers[:4] = np.round(centers[:4] * 2) / 2        # dyadic frames: many exact halves to round
    scales = rng.uniform(0.5, 2.5, b)
    scales[:4] = [0.56, 1.12, 2.24, 0.875]
    got = uncrop(_t(imgs), centers, scales, shapes)
    for i in range(b):
        exp = jax_uncrop(imgs[i], centers[i], scales[i], tuple(shapes[i]))
        assert got[i].dtype == torch.uint8 and tuple(got[i].shape) == tuple(shapes[i])
        np.testing.assert_array_equal(got[i].numpy(), exp)
    np.testing.assert_array_equal(get_transform(centers[0], scales[0], (res, res), 30.0),
                                  jax_get_transform(centers[0], scales[0], (res, res), 30.0))


class _Batches:
    """The loader interface of the JAX `run_lsp_eval` over fixed batches."""

    def __init__(self, batches):
        self.batches = batches

    def epoch(self, epoch):
        return list(enumerate(self.batches))


def _final_lines(out):
    lines = out.splitlines()
    i = lines.index("*** Final Results ***")
    return lines[i:i + 5]


def _reference_lsp_scores(images):
    """The four Final Results of the reference's accumulators
    (`cli/eval.py:179-267`), unrounded, over (pred_mask, pred_parts,
    gt_mask, gt_parts) numpy maps, parts with 255 as ignore."""
    acc = n = parts_acc = parts_n = 0
    tp, fp, fn = np.zeros(2), np.zeros(2), np.zeros(2)
    ptp, pfp, pfn = np.zeros(7), np.zeros(7), np.zeros(7)
    for pm, pp, gm, gp in images:
        acc += (gm == pm).sum()
        n += gm.size
        for c in range(2):
            cg, cp = gm == c, pm == c
            tp[c] += (cg & cp).sum()
            fp[c] += (~cg & cp).sum()
            fn[c] += (cg & ~cp).sum()
        for c in range(7):
            cg, cp = gp == c, (pp == c) & (gp != 255)
            ptp[c] += (cg & cp).sum()
            pfp[c] += (~cg & cp).sum()
            pfn[c] += (cg & ~cp).sum()
        parts_acc += (np.where(gp == 255, 0, gp) == np.where(pp == 255, 0, pp)).sum()
        parts_n += gp.size

    def f1(t, p, m):
        return float((2 * t / np.maximum(2 * t + p + m, 1)).mean())

    return {"Accuracy": acc / n, "F1": f1(tp, fp, fn), "Parts Accuracy": parts_acc / parts_n,
            "Parts F1 (BG)": f1(ptp, pfp, pfn)}


@pytest.mark.parametrize("gt_arrays", [True, False])
def test_run_lsp_eval_matches_jax_f64(gt_arrays, tmp_path, capsys, x64_mode, monkeypatch):
    """Both modes against the JAX CLI's `run_lsp_eval` on the synthetic LSP
    fixture, in f64, with the fixed-para infer_fn of
    tests/test_eval_harness.py:194-202: with the annotation PNGs (read here
    into `gt_mask` / `gt_parts` arrays) and the rendered-GT fallback. Every
    pasted-back map equals the JAX one pixel for pixel; the returned values
    are within 1e-12 of the reference's accumulators over the JAX maps, and
    the printed lines are identical. The render is RENDER px (the CLI's is
    `cfg.danet.img_size`), which keeps the f64 rasters of the test small."""
    import danet_densepose2smpl_tpu.data.transforms as jtransforms
    import danet_densepose2smpl_tpu_torch.eval.lsp as lsp

    jmaps, maps = [], []     # JAX: image by image; the port: one list a call

    def jrecord(*a):
        jmaps.append(jax_uncrop(*a))
        return jmaps[-1]

    def record(*a):
        maps.append(uncrop(*a))
        return maps[-1]

    monkeypatch.setattr(jtransforms, "uncrop", jrecord)
    monkeypatch.setattr(lsp, "uncrop", record)
    npz, img_dir, annot_dir = write_synthetic_dataset(str(tmp_path), n=4, with_lsp_masks=True)
    ds = NpzDataset(npz, img_dir, name="lsp", is_train=False, heatmap_size=16)
    batches = []
    for _, bt in ResumableLoader(ds, 2, shuffle=False, drop_last=False).epoch(0):
        bt = {k: v.astype(np.float64) if isinstance(v, np.ndarray) and v.dtype == np.float32 else v
              for k, v in bt.items()}
        batches.append(bt)
    jsmpl, smpl = jax_synthetic_smpl(NV), synthetic_smpl_model(NV)
    rotmat = np.asarray(jax_rodrigues(jnp.zeros((24, 3), jnp.float64))).reshape(216)
    para = np.concatenate([[0.9, 0.0, 0.0], np.zeros(10), rotmat])
    mean = np.tile(para[None], (2, 1))
    mean[1, :3] = [0.85, 0.03, -0.02]        # two cameras, so the crops differ

    args = argparse.Namespace(annot_dir=annot_dir if gt_arrays else None, vertex_texture=None,
                              cube_parts=None, log_freq=1)
    cfg = jax_cfg(Config(danet=DaNetConfig(img_size=RENDER)))
    jax_run_lsp_eval(args, cfg, None, lambda img: jnp.asarray(mean[:img.shape[0]]), jsmpl, ds, _Batches(batches))
    jout = capsys.readouterr().out

    if gt_arrays:
        for bt in batches:
            bt["gt_mask"] = [cv2.imread(os.path.join(annot_dir, n), 0) for n in bt["maskname"]]
            bt["gt_parts"] = [cv2.imread(os.path.join(annot_dir, n), 0) for n in bt["partname"]]
    got = run_lsp_eval(lambda img: _t(mean[:img.shape[0]]), enumerate(batches), smpl, RENDER, log_every=1)
    out = capsys.readouterr().out
    assert ("falling back" in out) == ("falling back" in jout) == (not gt_arrays)
    assert _final_lines(out) == _final_lines(jout)
    assert [ln for ln in out.splitlines() if ln.startswith("batch ")] == \
        [ln for ln in jout.splitlines() if ln.startswith("batch ")]

    kinds = 2 if gt_arrays else 4        # pred mask, pred parts (, GT mask, GT parts)
    jit, it, images = iter(jmaps), iter(maps), []
    for bt in batches:
        nb = len(bt["img"])
        jb = [next(jit) for _ in range(nb * kinds)]
        pb = [next(it) for _ in range(kinds)]
        for i in range(nb):
            for k in range(kinds):
                np.testing.assert_array_equal(pb[k][i].numpy(), jb[i * kinds + k])
            pm, pp = jb[i * kinds] > 0, jb[i * kinds + 1]
            if gt_arrays:
                gm, gp = bt["gt_mask"][i] > 0, bt["gt_parts"][i]
            else:
                gm, gp = jb[i * kinds + 2] > 0, jb[i * kinds + 3]
            images.append((pm, pp, gm, gp))
    assert next(jit, None) is None and next(it, None) is None
    ref = _reference_lsp_scores(images)
    assert [f"{name}: {value:.6f}" for name, value in ref.items()] == _final_lines(jout)[1:]
    for name, value in ref.items():
        assert abs(got[name] - value) <= 1e-12, (name, got[name], value)
    assert 0.0 < got["Accuracy"] < 1.0 and got["F1"] > 0.0
