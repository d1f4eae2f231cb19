"""The port's COCO keypoint eval against the JAX package on the CPU: the
OKS AP (`eval/metrics.keypoint_oks_ap`, `rescore_detections`) against JAX's
and against `tests/cocoeval_oracle.py` (a literal transcription of
pycocotools' COCOeval) on randomized multi-person fixtures with crowds;
the harness (`eval/coco_harness.py`): `make_coco_step` in f64 with and
without the foreground confidences, `run_coco_eval` with a stand-in model
with and without a COCO GT json, and the helpers.

Bars: the AP stats equal to 1e-12; keypoints to 1e-6 px and confidences
to 1e-9 in f64."""

import copy
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from danet_densepose2smpl_tpu.eval import coco_harness as jcoco
from danet_densepose2smpl_tpu.eval import metrics as jmetrics
from danet_densepose2smpl_tpu.smpl.loader import synthetic_smpl_model as jax_synthetic_smpl

from danet_densepose2smpl_tpu_torch.data.dataset import NpzDataset
from danet_densepose2smpl_tpu_torch.data.loader import ResumableLoader
from danet_densepose2smpl_tpu_torch.data.synthetic import write_synthetic_dataset
from danet_densepose2smpl_tpu_torch.eval import coco_harness, metrics
from danet_densepose2smpl_tpu_torch.smpl.loader import synthetic_smpl_model

from cocoeval_oracle import oracle_keypoint_eval
from test_coco_ap_oracle import STATS, _fixture, _rand_dt, _rand_gt

torch.set_num_threads(1)
NV = 300


@pytest.fixture
def x64_mode():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def test_coco_constants_match_jax():
    np.testing.assert_array_equal(metrics.COCO_KP_SIGMAS, jmetrics.COCO_KP_SIGMAS)
    np.testing.assert_array_equal(metrics.OKS_THRS, jmetrics.OKS_THRS)
    np.testing.assert_array_equal(metrics.REC_THRS, jmetrics.REC_THRS)
    assert metrics.MAX_DETS == jmetrics.MAX_DETS and metrics.AREA_RNG == jmetrics.AREA_RNG


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 11, "edges"])
def test_keypoint_oks_ap_matches_jax_and_oracle(seed):
    """Multi-person images with crowd regions, keypoint-less GT, boxes on
    the area boundaries, more than MAX_DETS detections and score ties; and
    hand-built edges (an image of crowd GT only, of detections only, of GT
    only). The port's rescoring and AP against JAX's and the oracle's."""
    if seed == "edges":
        rng = np.random.RandomState(7)
        gts = [_rand_gt(rng, 0, "crowd"), _rand_gt(rng, 1, "normal"), _rand_gt(rng, 3, "empty_kp"),
               _rand_gt(rng, 3, "normal")]
        dts = [_rand_dt(rng, 0, gts[0]), _rand_dt(rng, 2), _rand_dt(rng, 3, gts[3], jitter=0.5)]
    else:
        dts, gts = _fixture(seed)
    for d in dts:
        d["box_score"] = float(np.random.RandomState(len(d["keypoints"])).rand()) + 0.5
    ours = metrics.rescore_detections(copy.deepcopy(dts))
    theirs = jmetrics.rescore_detections(copy.deepcopy(dts))
    assert [d["score"] for d in ours] == [d["score"] for d in theirs]
    got = metrics.keypoint_oks_ap(copy.deepcopy(ours), copy.deepcopy(gts))
    want = jmetrics.keypoint_oks_ap(copy.deepcopy(theirs), copy.deepcopy(gts))
    oracle = oracle_keypoint_eval(copy.deepcopy(ours), copy.deepcopy(gts), metrics.COCO_KP_SIGMAS)
    assert sorted(got) == sorted(STATS)
    for s in STATS:
        np.testing.assert_allclose(got[s], want[s], rtol=0, atol=1e-12, err_msg=s)
        np.testing.assert_allclose(got[s], oracle[s], rtol=0, atol=1e-12, err_msg=s)


def _para(b, seed):
    """f64 para of small random poses, cameras of varied scale and shift."""
    from danet_densepose2smpl_tpu_torch.ops.rotations import batch_rodrigues

    rng = np.random.RandomState(seed)
    rot = batch_rodrigues(torch.from_numpy(rng.randn(b * 24, 3) * 0.2)).reshape(b, 216).numpy()
    cam = np.stack([rng.uniform(0.6, 1.1, b), rng.randn(b) * 0.1, rng.randn(b) * 0.1], 1)
    return np.concatenate([cam, rng.randn(b, 10) * 0.3, rot], 1)


@pytest.mark.parametrize("fg_conf", [False, True])
def test_make_coco_step_matches_jax_f64(fg_conf, x64_mode):
    """SMPL joints -> COCO-17 -> projection with tz = 2f/(S s + 1e-9) ->
    (with fg_conf) the foreground probability sampled at each joint, in
    f64 against JAX's jitted step."""
    b, res = 4, 224
    para = _para(b, 1)
    fg = np.random.RandomState(2).rand(b, 56, 56)
    if fg_conf:
        jstep = jcoco.make_coco_step(lambda img: (jnp.asarray(para), jnp.asarray(fg)), jax_synthetic_smpl(NV),
                                     img_res=res, fg_conf=True)
        step = coco_harness.make_coco_step(lambda img: (torch.from_numpy(para), torch.from_numpy(fg)),
                                           synthetic_smpl_model(NV), img_res=res, fg_conf=True)
    else:
        jstep = jcoco.make_coco_step(lambda img: jnp.asarray(para), jax_synthetic_smpl(NV), img_res=res)
        step = coco_harness.make_coco_step(lambda img: torch.from_numpy(para), synthetic_smpl_model(NV),
                                           img_res=res)
    jkp, jconf = (np.asarray(a) for a in jstep(jnp.zeros((b, 8, 8, 3))))
    kp, conf = step(torch.zeros(b, 8, 8, 3))
    assert kp.dtype == torch.float64 and kp.shape == (b, 17, 2) and conf.shape == (b, 17)
    inside = ((jkp > 0) & (jkp < res)).all(-1)
    assert inside.mean() > 0.5                 # most joints land in the crop, where fg is sampled
    np.testing.assert_allclose(kp.numpy(), jkp, rtol=0, atol=1e-6)
    np.testing.assert_allclose(conf.numpy(), jconf, rtol=0, atol=1e-9)
    if not fg_conf:
        assert (conf == 1).all()


def test_coco_helpers_match_jax(tmp_path):
    rng = np.random.RandomState(3)
    for _ in range(4):
        coords, center, scale = rng.rand(17, 2) * 224, rng.uniform(50, 300, 2), rng.uniform(0.5, 2.0)
        np.testing.assert_allclose(coco_harness.transform_preds(coords, center, scale, (224, 224)),
                                   jcoco.transform_preds(coords, center, scale, (224, 224)), rtol=1e-12)
    for name in ("val2014/COCO_val2014_000000397133.jpg", "images/im_0042.png", "a/b7c12.jpg"):
        assert coco_harness.image_id_from_name(name) == jcoco.image_id_from_name(name)
    gt = {"categories": [{"id": 1, "name": "person"}, {"id": 2, "name": "dog"}],
          "annotations": [{"image_id": 5, "category_id": 1, "keypoints": list(rng.rand(51)), "area": 90.0,
                           "bbox": [1, 2, 3, 4], "iscrowd": 1},
                          {"image_id": 6, "category_id": 2, "keypoints": [0] * 51, "area": 1.0, "bbox": [0, 0, 1, 1]},
                          {"image_id": 6, "category_id": 1, "keypoints": list(rng.rand(51)), "area": 50.0,
                           "bbox": [0, 0, 5, 10]}]}
    path = tmp_path / "gt.json"
    path.write_text(json.dumps(gt))
    ours, theirs = coco_harness.load_coco_gt(str(path)), jcoco.load_coco_gt(str(path))
    assert len(ours) == len(theirs) == 2
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("with_json", [False, True], ids=["npz_gt", "coco_gt_json"])
def test_run_coco_eval_matches_jax(with_json, tmp_path, x64_mode):
    """Two batches of a written dataset through a stand-in model whose
    cameras and foreground probabilities depend on the images: the same
    predictions and the same AP dict as JAX's, GT from the npz keypoints
    or from a COCO json (with a crowd region and a second person)."""
    npz, img_dir = write_synthetic_dataset(str(tmp_path), n=6, img_size=96)
    paras = _para(6, 4)
    gt_json = None
    if with_json:
        rng = np.random.RandomState(5)
        anns = [{"image_id": i, "category_id": 1, "area": 4000.0 + 100 * i, "bbox": [10.0, 10.0, 60.0, 70.0],
                 "keypoints": np.concatenate([rng.uniform(10, 80, (17, 2)), np.full((17, 1), 2)], 1).ravel().tolist()}
                for i in range(6)]
        anns += [{"image_id": 2, "category_id": 1, "area": 900.0, "bbox": [0.0, 0.0, 30.0, 30.0],
                  "keypoints": [0] * 51, "iscrowd": 1}]
        gt_json = str(tmp_path / "gt.json")
        with open(gt_json, "w") as f:
            json.dump({"categories": [{"id": 1, "name": "person"}], "annotations": anns}, f)

    def jax_infer(img):
        k = jnp.mean(img.astype(jnp.float64), axis=(1, 2, 3))
        p = jnp.asarray(paras)[:img.shape[0]]
        return p.at[:, 0].add(0.1 * k), jnp.clip(0.5 + 0.1 * jnp.asarray(img[..., 0]).astype(jnp.float64), 0, 1)

    def infer(img):
        k = img.double().mean(dim=(1, 2, 3))
        p = torch.from_numpy(paras)[:img.shape[0]].clone()
        p[:, 0] += 0.1 * k
        return p, torch.clamp(0.5 + 0.1 * img[..., 0].double(), 0, 1)

    from danet_densepose2smpl_tpu.data.dataset import NpzDataset as JNpzDataset
    from danet_densepose2smpl_tpu.data.loader import ResumableLoader as JResumableLoader

    ds, jds = (cls(npz, img_dir, name="coco", is_train=False, heatmap_size=16) for cls in (NpzDataset, JNpzDataset))
    ap, preds = coco_harness.run_coco_eval(infer, ResumableLoader(ds, 3, shuffle=False, drop_last=False).epoch(0),
                                           synthetic_smpl_model(NV), img_res=224, log_every=0,
                                           imgnames=ds.imgname, gt_json=gt_json, fg_conf=True)
    jap, jpreds = jcoco.run_coco_eval(jax_infer, JResumableLoader(jds, 3, shuffle=False, drop_last=False).epoch(0),
                                      jax_synthetic_smpl(NV), img_res=224, log_every=0,
                                      imgnames=jds.imgname, gt_json=gt_json, fg_conf=True)
    assert preds.shape == (6, 17, 3)
    np.testing.assert_allclose(preds[..., :2], jpreds[..., :2], rtol=0, atol=1e-6)
    np.testing.assert_allclose(preds[..., 2], jpreds[..., 2], rtol=0, atol=1e-9)
    assert len(set(np.round(preds[..., 2].mean(1), 6))) > 1      # the confidences order the detections
    assert sorted(ap) == sorted(STATS)
    for s in STATS:
        np.testing.assert_allclose(ap[s], jap[s], rtol=0, atol=1e-12, err_msg=s)
