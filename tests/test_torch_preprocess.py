"""The port's offline DensePose-COCO preprocessing (`data/preprocess.py`,
`cli/preprocess.py`) and the surface lookups of
`smpl/densepose_methods.py` against the JAX package's, on a synthetic
densepose_coco json (`data/synthetic.py::write_synthetic_dp_coco_json`:
crowd records, compressed and uncompressed RLE, empty mask slots,
keypoint-less and over-196-point annotations, records without DensePose
labels), and the converted npz through the port's `NpzDataset` and
loader."""

import json

import numpy as np
import pytest

from danet_densepose2smpl_tpu.cli.preprocess import main as jax_cli
from danet_densepose2smpl_tpu.data import preprocess as jpre
from danet_densepose2smpl_tpu.smpl import densepose_methods as jdm
from danet_densepose2smpl_tpu.smpl.densepose_atlas import synthetic_densepose_atlas as jax_atlas
from danet_densepose2smpl_tpu.smpl.loader import synthetic_smpl_model as jax_smpl

from danet_densepose2smpl_tpu_torch.cli.preprocess import main as port_cli
from danet_densepose2smpl_tpu_torch.data import preprocess as pre
from danet_densepose2smpl_tpu_torch.data.dataset import NpzDataset
from danet_densepose2smpl_tpu_torch.data.loader import ResumableLoader
from danet_densepose2smpl_tpu_torch.data.synthetic import (
    DP_COCO_KINDS,
    _dp_coco_annotation,
    write_synthetic_dp_coco_json,
)
from danet_densepose2smpl_tpu_torch.smpl import densepose_methods as dm
from danet_densepose2smpl_tpu_torch.smpl.densepose_atlas import synthetic_densepose_atlas
from danet_densepose2smpl_tpu_torch.smpl.loader import synthetic_smpl_model


def _bad_json(path, convertible: bool = False):
    """A NO-GO json; `convertible`: only with errors the converter copies
    through (malformed mask lists), so --force converts it."""
    rng = np.random.RandomState(1)
    good = _dp_coco_annotation(rng, 1, 100, "plain")
    ragged = dict(_dp_coco_annotation(rng, 2, 100, "plain"), dp_x=[1.0])
    orphan = _dp_coco_annotation(rng, 3, 999, "plain")
    no_v = {k: v for k, v in _dp_coco_annotation(rng, 4, 100, "plain").items() if k != "dp_V"}
    short_kps = dict(_dp_coco_annotation(rng, 5, 100, "plain"), keypoints=[1.0] * 50)
    bad_masks = dict(_dp_coco_annotation(rng, 6, 100, "plain"), dp_masks=[[]] * 13)
    no_counts = dict(_dp_coco_annotation(rng, 7, 100, "plain"), dp_masks=[{"size": [256, 256]}] + [[]] * 13)
    db = {"images": [{"id": 100, "file_name": "a.png"}, {"file_name": "no_id.png"}],
          "annotations": [good, ragged, orphan, no_v, short_kps, bad_masks, no_counts]}
    if convertible:
        db = {"images": db["images"][:1], "annotations": [good, bad_masks, no_counts]}
    with open(path, "w") as f:
        json.dump(db, f)


def test_kp_coco2smpl_matches_jax():
    rng = np.random.RandomState(0)
    assert pre.COCO17_TO_GT24 == jpre.COCO17_TO_GT24 and pre.BBOX_SCALE_FACTOR == jpre.BBOX_SCALE_FACTOR
    assert pre.SMPL_FROM_COCO_DIRECT == jpre.SMPL_FROM_COCO_DIRECT
    for _ in range(200):
        kps = np.stack([rng.uniform(0, 300, 17), rng.uniform(0, 300, 17), rng.randint(0, 3, 17)], 1)
        kps[rng.rand(17) < 0.3, 2] = 0
        np.testing.assert_array_equal(pre.kp_coco2smpl(kps), jpre.kp_coco2smpl(kps))


def test_db_coco_extract_matches_jax(tmp_path):
    """Every npz column equal to the JAX converter's, with and without an
    image prefix."""
    src = tmp_path / "dp.json"
    write_synthetic_dp_coco_json(str(src), 40)
    for prefix in ("", "train2014"):
        n = pre.db_coco_extract(str(src), str(tmp_path / "port.npz"), img_prefix=prefix)
        jn = jpre.db_coco_extract(str(src), str(tmp_path / "jax.npz"), img_prefix=prefix)
        assert n == jn == 35                      # the 5 records without DensePose labels are dropped
        got, want = np.load(tmp_path / "port.npz", allow_pickle=True), np.load(tmp_path / "jax.npz", allow_pickle=True)
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            if k == "dp_annot":
                assert list(got[k]) == list(want[k])
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["part"][..., 2] == 0).all(-1).sum() >= 5   # the keypoint-less records have zero parts


def test_check_dp_coco_json_matches_jax(tmp_path):
    """Stats, warnings and errors of the preflight, equal to JAX's, on a
    GO json and on a NO-GO one."""
    ok, bad, forced = tmp_path / "ok.json", tmp_path / "bad.json", tmp_path / "forced.json"
    write_synthetic_dp_coco_json(str(ok), 40)
    _bad_json(bad)
    _bad_json(forced, convertible=True)
    for path, go in ((ok, True), (bad, False), (forced, False)):
        for max_report in (10, 3):
            rep = pre.check_dp_coco_json(str(path), max_report=max_report)
            assert rep == jpre.check_dp_coco_json(str(path), max_report=max_report)
            assert rep["ok"] is go
    s = pre.check_dp_coco_json(str(ok))["stats"]
    assert s["crowd_with_dp"] == 5 and s["over_196_points"] == 5 and s["no_keypoints"] == 10
    assert s["rle_compressed"] > 0 and s["rle_uncompressed"] > 0 and s["rle_empty_slots"] > 0
    assert pre.check_dp_coco_json(str(ok))["warnings"]
    assert pre.check_dp_coco_json(str(tmp_path / "bad.json"))["errors"]


def test_preprocess_cli_exit_codes_and_output_match_jax(tmp_path, capsys):
    """GO converts and exits 0; NO-GO exits 1 (with --check, and without
    --force); --force converts anyway and exits 1. The printed report is
    the JAX CLI's."""
    ok, bad, forced = tmp_path / "ok.json", tmp_path / "bad.json", tmp_path / "forced.json"
    write_synthetic_dp_coco_json(str(ok), 16)
    _bad_json(bad)
    _bad_json(forced, convertible=True)
    cases = (
        (["--json", str(ok), "--out", str(tmp_path / "ok_{}.npz")], 0, True),
        (["--json", str(ok), "--check"], 0, False),
        (["--json", str(bad), "--check"], 1, False),
        (["--json", str(bad), "--out", str(tmp_path / "bad_{}.npz")], 1, False),
        (["--json", str(forced), "--out", str(tmp_path / "forced_{}.npz"), "--force"], 1, True),
    )
    for argv, rc, writes in cases:
        outs = {}
        for name, cli in (("port", port_cli), ("jax", jax_cli)):
            assert cli([a.format(name) for a in argv]) == rc, (name, argv)
            outs[name] = capsys.readouterr().out.replace(f"_{name}.npz", ".npz")
        assert outs["port"] == outs["jax"]
        assert ("NO-GO" in outs["port"]) == (rc == 1)
        out = [a for a in argv if a.endswith(".npz")]
        if out:
            assert (tmp_path / out[0].format("port")).exists() == writes
            if writes:
                got = np.load(tmp_path / out[0].format("port"), allow_pickle=True)
                want = np.load(tmp_path / out[0].format("jax"), allow_pickle=True)
                np.testing.assert_array_equal(got["scale"], want["scale"])
                assert list(got["dp_annot"]) == list(want["dp_annot"])


def test_converted_npz_trains_through_the_loader(tmp_path):
    """The converted npz through `NpzDataset` (frames written as PNG) and
    the loader: a batch with the DensePose blobs of every sample (no
    degenerate boxes: the preflight warns of those)."""
    src, img_dir = tmp_path / "dp.json", tmp_path / "images"
    write_synthetic_dp_coco_json(str(src), 16, n_images=4, kinds=DP_COCO_KINDS[:-1], img_dir=str(img_dir))
    assert port_cli(["--json", str(src), "--out", str(tmp_path / "dp.npz")]) == 0
    ds = NpzDataset(str(tmp_path / "dp.npz"), str(img_dir), name="dp_coco", heatmap_size=16)
    assert len(ds) == 14                       # 2 of 16 without DensePose labels
    _, batch = next(iter(ResumableLoader(ds, 4, seed=0).epoch(0)))
    assert batch["img"].shape == (4, 224, 224, 3) and np.isfinite(batch["img"]).all()
    assert (batch["has_dp"] == 1).all()
    dp = batch["dp_dict"]
    assert dp["ann_labels"].shape == (4, 16, 16) and dp["i_points"].shape == (4, 196)
    assert dp["point_weights"].shape == (4, 25, 196) and dp["point_weights"].sum() > 0
    assert batch["smpl_2dkps"].shape == (4, 24, 3)


@pytest.fixture(scope="module")
def atlases():
    return synthetic_densepose_atlas(synthetic_smpl_model(500, seed=0)), jax_atlas(jax_smpl(500, seed=0))


def test_iuv_to_face_bc_and_fbc_to_surface_match_jax(atlases):
    """Random chart points (inside some face, and off every chart: the
    nearest-corner fallback), then the surface point on random vertices."""
    atlas, jatlas = atlases
    for k in atlas._fields:
        np.testing.assert_array_equal(getattr(atlas, k), getattr(jatlas, k))
    rng = np.random.RandomState(5)
    verts = rng.randn(500, 3)
    fallbacks = 0
    patches = np.unique(atlas.face_indices)
    for t in range(120):
        i = int(rng.choice(patches))
        u, v = (rng.uniform(1.2, 2.0, 2) if t % 4 == 0 else rng.rand(2))
        got, want = dm.iuv_to_face_bc(atlas, i, u, v), jdm.iuv_to_face_bc(jatlas, i, u, v)
        assert got == want
        fallbacks += sorted(got[1:]) == [0.0, 0.0, 1.0]
        np.testing.assert_array_equal(dm.fbc_to_surface(atlas, got[0], got[1:], verts),
                                      jdm.fbc_to_surface(jatlas, want[0], want[1:], verts))
    assert fallbacks >= 30
