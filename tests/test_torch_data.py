"""The port's host ingest against the JAX package on the CPU: the YAML
config loader, the asset loaders (SMPL pickle and npz, the DensePose atlas
and UV symmetry .mat files, SPIN mean params), the RLE codec, PNG files
against cv2, the training crop, resize and nearest remap against cv2, the
DensePose annotation blobs, `NpzDataset` and `MixedDataset` items, and the
resumable and prefetching loaders.

Every file is written by the test. Bars: equality (bit for bit on images,
labels and batches) except where a bar is stated: the crop within 1e-2 on
the 0-255 scale of cv2's `warpAffine(INTER_LINEAR)` (bit-equal at widths
that are a multiple of 16), the resize within 1e-4 of `cv2.resize`."""

import dataclasses
import glob
import os
import pickle
import struct
import sys
import types
import zlib

import cv2
import numpy as np
import pytest
import scipy.io
import scipy.sparse
import torch

from danet_densepose2smpl_tpu.core.config import load_config as jax_load_config
from danet_densepose2smpl_tpu.data import dp_annot as jdp
from danet_densepose2smpl_tpu.data import loader as jloader
from danet_densepose2smpl_tpu.data import mixed as jmixed
from danet_densepose2smpl_tpu.data import rle as jrle
from danet_densepose2smpl_tpu.data import synthetic as jsynthetic
from danet_densepose2smpl_tpu.data import transforms as jtf
from danet_densepose2smpl_tpu.data.dataset import NpzDataset as JNpzDataset
from danet_densepose2smpl_tpu.models.smpl_regressor import load_mean_params as jax_load_mean_params
from danet_densepose2smpl_tpu.smpl import densepose_methods as jdm
from danet_densepose2smpl_tpu.smpl.densepose_atlas import load_densepose_atlas as jax_load_atlas
from danet_densepose2smpl_tpu.smpl.loader import load_smpl_model as jax_load_smpl

from danet_densepose2smpl_tpu_torch.config import load_config
from danet_densepose2smpl_tpu_torch.data import dp_annot, image_io, loader, mixed, rle, transforms
from danet_densepose2smpl_tpu_torch.data.dataset import NpzDataset
from danet_densepose2smpl_tpu_torch.data.synthetic import write_synthetic_dataset
from danet_densepose2smpl_tpu_torch.models.smpl_regressor import load_mean_params
from danet_densepose2smpl_tpu_torch.smpl import densepose_methods as dm
from danet_densepose2smpl_tpu_torch.smpl.densepose_atlas import load_densepose_atlas
from danet_densepose2smpl_tpu_torch.smpl.loader import (
    load_smpl_model,
    save_smpl_npz,
    synthetic_smpl_model,
)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))


def assert_tree_equal(a, b, path=""):
    """Nested dicts / lists / arrays / scalars equal bit for bit, dtypes
    included."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, str):
        assert a == b, path
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)


# --------------------------------------------------------------------------
# config and assets
# --------------------------------------------------------------------------

@pytest.mark.parametrize("path", [None] + CONFIGS, ids=lambda p: os.path.basename(p) if p else "defaults")
def test_load_config_matches_jax(path):
    """Every shipped YAML (and none), with the CLI's kind of dotted
    overrides, gives the JAX package's config field for field; `yaml` and
    the reader agree."""
    overrides = {"train.batch_size": 3, "danet.img_size": 64, "danet.heatmap_size": 16,
                 "train.train_data": "single", "danet.compute_dtype": "bfloat16"}
    for ov in (None, overrides):
        assert dataclasses.asdict(load_config(path, ov)) == dataclasses.asdict(jax_load_config(path, ov))


class _ChumpyArray:
    """Stands for a chumpy `Ch`: its pickled state keeps the array as `x`."""

    def __init__(self, x):
        self.x = x


def _write_official_pkl(path, model):
    """An official-style SMPL .pkl: chumpy arrays whose module does not
    exist where it is loaded, a scipy sparse J_regressor, posedirs as
    (V, 3, 207), faces as uint32."""
    fake = types.ModuleType("chumpy_fake_for_test")
    _ChumpyArray.__module__, _ChumpyArray.__qualname__ = fake.__name__, "Ch"
    fake.Ch = _ChumpyArray
    sys.modules[fake.__name__] = fake
    try:
        raw = {
            "v_template": _ChumpyArray(model.v_template.astype(np.float64)),
            "shapedirs": _ChumpyArray(np.concatenate([model.shapedirs, model.shapedirs], -1)),  # 20 betas
            "posedirs": model.posedirs.astype(np.float64),
            "J_regressor": scipy.sparse.csc_matrix(model.J_regressor.astype(np.float64)),
            "weights": _ChumpyArray(model.lbs_weights),
            "f": model.faces.astype(np.uint32),
        }
        with open(path, "wb") as f:
            pickle.dump(raw, f, protocol=2)
    finally:
        del sys.modules[fake.__name__]


@pytest.mark.parametrize("kind", ["pkl", "dir", "npz"])
def test_load_smpl_model_matches_jax(kind, tmp_path):
    model = synthetic_smpl_model(num_verts=300, seed=2)
    extra = str(tmp_path / "J_regressor_extra.npy")
    np.save(extra, model.J_regressor_extra)
    if kind == "npz":
        path = str(tmp_path / "smpl.npz")
        save_smpl_npz(model, path)
        kw = {}
    else:
        _write_official_pkl(tmp_path / "SMPL_NEUTRAL.pkl", model)
        path = str(tmp_path if kind == "dir" else tmp_path / "SMPL_NEUTRAL.pkl")
        kw = {"j_regressor_extra_path": extra}
    ours, theirs = load_smpl_model(path, **kw), jax_load_smpl(path, **kw)
    assert ours._fields == theirs._fields
    for name, a, b in zip(ours._fields, ours, theirs):
        assert_tree_equal(a, b, name)
    if kind != "npz":
        np.testing.assert_array_equal(ours.J_regressor, model.J_regressor)
        np.testing.assert_array_equal(ours.J_regressor_extra, model.J_regressor_extra)
        assert ours.shapedirs.shape == model.shapedirs.shape


def test_load_densepose_atlas_matches_jax(tmp_path):
    """A `UV_Processed.mat` of the official layout (1-based MATLAB
    indices), through scipy.io."""
    rng = np.random.RandomState(3)
    nd, nf = 50, 80
    path = str(tmp_path / "UV_Processed.mat")
    scipy.io.savemat(path, {
        "All_vertices": rng.randint(1, 301, (1, nd)).astype(np.float64),
        "All_Faces": rng.randint(1, nd + 1, (nf, 3)).astype(np.float64),
        "All_FaceIndices": rng.randint(1, 25, (nf, 1)).astype(np.float64),
        "U_norm": rng.rand(nd, 1), "V_norm": rng.rand(nd, 1),
    })
    ours, theirs = load_densepose_atlas(path), jax_load_atlas(path)
    for name, a, b in zip(ours._fields, ours, theirs):
        assert_tree_equal(a, b, name)
    np.testing.assert_array_equal(ours.face_textures, theirs.face_textures)


def _write_symmetry_mat(path, rng):
    u_cells, v_cells = np.empty((1, 24), dtype=object), np.empty((1, 24), dtype=object)
    for i in range(24):
        u_cells[0, i], v_cells[0, i] = rng.rand(256, 256), rng.rand(256, 256)
    scipy.io.savemat(str(path), {"U_transforms": u_cells, "V_transforms": v_cells})


def _flip_inputs(rng, n=64):
    return (rng.randint(0, 25, n).astype(np.float64), np.concatenate([rng.rand(n - 2), [0.0, 1.0]]),
            np.concatenate([rng.rand(n - 2), [1.0, 0.0]]), rng.rand(n) * 255, rng.rand(n) * 255,
            rng.randint(0, 15, (256, 256)).astype(np.uint8))


def test_uv_symmetry_load_and_flip_match_jax(tmp_path, monkeypatch):
    """The official-layout table loads as JAX loads it, flips annotations as
    JAX does, and `find_uv_symmetry` resolves like JAX: explicit path (a
    missing one raises), $DANET_UV_SYMMETRY, none (a warning, None). The
    synthetic table flips alike and warns."""
    rng = np.random.RandomState(4)
    mat = tmp_path / "UV_symmetry_transforms.mat"
    _write_symmetry_mat(mat, rng)
    sym, jsym = dm.load_uv_symmetry(str(mat)), jdm.load_uv_symmetry(str(mat))
    assert_tree_equal(tuple(sym), tuple(jsym))
    args = _flip_inputs(rng)
    for table, jtable in ((sym, jsym), (dm.synthetic_uv_symmetry(), jdm.synthetic_uv_symmetry())):
        assert_tree_equal(tuple(table), tuple(jtable))
        with pytest.warns(UserWarning) if table.synthetic else _nothing():
            got = dm.get_symmetric_densepose(*args, table)
        assert_tree_equal(got, jdm.get_symmetric_densepose(*args, jtable))

    with pytest.raises(FileNotFoundError):
        dm.find_uv_symmetry(str(tmp_path / "missing.mat"))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DANET_UV_SYMMETRY", str(mat))
    assert_tree_equal(tuple(dm.find_uv_symmetry()), tuple(jsym))
    monkeypatch.delenv("DANET_UV_SYMMETRY")
    with pytest.warns(UserWarning, match="NOT be flip-augmented"):
        assert dm.find_uv_symmetry() is None


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("from_file", [False, True])
def test_load_mean_params_matches_jax(from_file, tmp_path):
    path = None
    if from_file:
        rng = np.random.RandomState(5)
        path = str(tmp_path / "smpl_mean_params.npz")
        np.savez(path, pose=rng.randn(144), shape=rng.randn(1, 10), cam=rng.randn(3))
    assert_tree_equal(tuple(load_mean_params(path)), tuple(jax_load_mean_params(path)))


# --------------------------------------------------------------------------
# RLE and image files
# --------------------------------------------------------------------------

def test_rle_codec_matches_jax():
    """Round trips of masks with runs at both ends, compressed counts both
    ways, and the 14-part decode, against the JAX codec."""
    rng = np.random.RandomState(6)
    masks = [(rng.rand(37, 23) < 0.3).astype(np.uint8), np.ones((16, 16), np.uint8),
             np.zeros((9, 5), np.uint8)]
    blob = np.zeros((37, 23), np.uint8)
    blob[5:30, 3:20] = 1
    masks.append(blob)
    for m in masks:
        enc = rle.encode_rle(m)
        assert enc == jrle.encode_rle(m)
        np.testing.assert_array_equal(rle.decode_rle(enc), m)
        packed = rle.compress_counts(enc["counts"])
        assert packed == jrle.compress_counts(enc["counts"])
        assert rle._uncompress_counts(packed) == enc["counts"]
        np.testing.assert_array_equal(rle.decode_rle({"size": enc["size"], "counts": packed.decode()}), m)
    parts = []
    for p in range(14):
        mm = np.zeros((256, 256), np.uint8)
        y0, x0 = rng.randint(0, 200, 2)
        mm[y0:y0 + 60, x0:x0 + 60] = 1
        parts.append(rle.encode_rle(mm) if p % 5 else [])
    np.testing.assert_array_equal(rle.decode_dp_masks(parts), jrle.decode_dp_masks(parts))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _encode_png_filtered(img: np.ndarray, color: int) -> bytes:
    """A PNG whose rows cycle through the five filter types (0 None, 1 Sub,
    2 Up, 3 Average, 4 Paeth), filtered here by the PNG specification."""
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, -1).astype(np.int64)
    raw = bytearray()
    prior = np.zeros(w * bpp, np.int64)
    for y in range(h):
        kind, cur = y % 5, rows[y]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        pred = {0: np.zeros_like(cur), 1: left, 2: prior, 3: (left + prior) // 2,
                4: np.array([_paeth(*t) for t in zip(left, prior, upleft)])}[kind]
        raw += bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes()
        prior = cur

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (image_io.PNG_SIGNATURE + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("color,channels", [(0, 1), (2, 3), (4, 2), (6, 4)], ids=["gray", "rgb", "gray+alpha", "rgba"])
def test_png_read_all_filters_equals_cv2(color, channels, tmp_path):
    """Files whose rows use every filter type, read here and by
    `cv2.imread`: the same pixels, bit for bit (`read_png` as the file
    holds them, `read_rgb` as the dataset reads them)."""
    rng = np.random.RandomState(color)
    base = np.cumsum(rng.randint(0, 9, (31, 45, channels)), axis=1)   # smooth rows and random ones
    img = np.where(rng.rand(31, 1, 1) < 0.5, base, rng.randint(0, 256, base.shape)).astype(np.uint8)
    img = img[..., 0] if channels == 1 else img
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_encode_png_filtered(img, color))
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    want = want if want.ndim == 2 else want[..., 2::-1] if want.shape[2] >= 3 else want
    got = image_io.read_png(path)
    if color == 4:       # cv2 keeps gray+alpha as two channels; the reader keeps the gray
        want = want[..., 0]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(image_io.read_rgb(path), cv2.imread(path)[:, :, ::-1])


@pytest.mark.parametrize("shape", [(33, 47), (33, 47, 3), (256, 256, 3)])
def test_png_write_read_round_trips_with_cv2(shape, tmp_path):
    """What the port writes, cv2 reads bit for bit; what cv2 writes (its own
    filter choice), the port reads bit for bit."""
    img = (np.random.RandomState(7).rand(*shape) * 255).astype(np.uint8)
    ours, theirs = str(tmp_path / "ours.png"), str(tmp_path / "cv2.png")
    image_io.write_png(ours, img)
    got = cv2.imread(ours, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(got if img.ndim == 2 else got[..., ::-1], img)
    cv2.imwrite(theirs, img if img.ndim == 2 else img[..., ::-1])
    np.testing.assert_array_equal(image_io.read_png(theirs), img)
    np.testing.assert_array_equal(image_io.read_rgb(theirs), cv2.imread(theirs)[:, :, ::-1])


@pytest.mark.parametrize("channels", [1, 2, 3, 4], ids=["gray", "gray+alpha", "rgb", "rgba"])
def test_read_gray_equals_cv2_grayscale(channels, tmp_path):
    """A label PNG read as `cv2.imread(path, 0)` reads it (the LSP GT):
    gray as it is; colour through libpng's fixed-point rgb-to-gray,
    bit for bit, grays (R == G == B) unchanged."""
    rng = np.random.RandomState(channels)
    img = rng.randint(0, 256, (23, 37, channels)).astype(np.uint8)
    if channels >= 3:
        img[:5, :5, :3] = img[:5, :5, :1]          # gray pixels in a colour file
    path = str(tmp_path / "label.png")
    if channels == 2:
        with open(path, "wb") as f:
            f.write(_encode_png_filtered(img, 4))
    else:
        cv2.imwrite(path, img[..., 0] if channels == 1 else img[..., [2, 1, 0, 3][:channels]])
    want = cv2.imread(path, 0)
    got = image_io.read_gray(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_read_image_jpeg_and_refusals(tmp_path):
    """A JPEG goes through PIL (close to cv2's decoder, another libjpeg);
    a file of another format raises."""
    img = (np.random.RandomState(8).rand(40, 50, 3) * 255).astype(np.uint8)
    path = str(tmp_path / "x.jpg")
    cv2.imwrite(path, img[..., ::-1])
    got = image_io.read_rgb(path)
    want = cv2.imread(path)[:, :, ::-1]
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(np.float32) - want).mean() < 2.0
    bad = tmp_path / "x.bmp"
    cv2.imwrite(str(bad), img)
    with pytest.raises(ValueError, match="neither PNG nor JPEG"):
        image_io.read_rgb(str(bad))


# --------------------------------------------------------------------------
# transforms and DensePose annotations
# --------------------------------------------------------------------------

@pytest.mark.parametrize("res,rot", [((224, 224), 0.0), ((224, 224), 23.7), ((224, 224), -61.0),
                                     ((56, 48), 12.5), ((37, 75), -8.0)])
def test_crop_matches_cv2(res, rot):
    """`crop` against the JAX one (`cv2.warpAffine`, INTER_LINEAR,
    BORDER_CONSTANT) on noise images, boxes reaching past the borders:
    bit for bit at widths that are multiples of 16 (cv2's vector loop),
    within 1e-2 elsewhere (its scalar tail rounds the sample position
    differently)."""
    rng = np.random.RandomState(int(abs(rot) * 10) + res[1])
    for _ in range(3):
        h, w = rng.randint(60, 320, 2)
        img = (rng.rand(h, w, 3) * 255).astype(np.float32)
        center = np.array([w / 2, h / 2]) + rng.randn(2) * 40
        scale = rng.uniform(0.3, 2.2)
        got, want = transforms.crop(img, center, scale, res, rot), jtf.crop(img, center, scale, res, rot)
        assert got.shape == want.shape and got.dtype == want.dtype == np.float32
        if res[1] % 16 == 0:
            np.testing.assert_array_equal(got, want)
        else:
            assert np.abs(got - want).max() <= 1e-2


def test_resize_bilinear_matches_cv2():
    rng = np.random.RandomState(9)
    for (h, w), size in (((224, 224), (64, 64)), ((224, 224), (100, 100)), ((50, 70), (120, 90))):
        img = (rng.rand(h, w, 3) * 255).astype(np.float32)
        got = transforms.resize_bilinear(img, size)
        assert got.shape == (*size, 3)
        assert np.abs(got - cv2.resize(img, (size[1], size[0]))).max() <= 1e-4


def test_point_flip_and_rotation_helpers_match_jax():
    rng = np.random.RandomState(10)
    for rot in (0.0, 17.5):
        c, s = rng.uniform(80, 200, 2), rng.uniform(0.5, 1.5)
        for inv in (False, True):
            np.testing.assert_array_equal(transforms.transform_point([33.3, 71.9], c, s, (224, 224), inv, rot),
                                          jtf.transform_point([33.3, 71.9], c, s, (224, 224), inv, rot))
            pts = rng.uniform(0, 250, (30, 2))
            np.testing.assert_array_equal(transforms.transform_points(pts, c, s, (224, 224), inv, rot),
                                          jtf.transform_points(pts, c, s, (224, 224), inv, rot))
    for n in (49, 24):
        kp = rng.randn(n, 3)
        np.testing.assert_array_equal(transforms.flip_kp(kp), jtf.flip_kp(kp))
    pose = rng.randn(72)
    np.testing.assert_array_equal(transforms.flip_pose(pose), jtf.flip_pose(pose))
    np.testing.assert_array_equal(transforms.rot_aa_np(pose[:3], -33.0), jtf.rot_aa_np(pose[:3], -33.0))
    img = rng.rand(5, 7, 3)
    np.testing.assert_array_equal(transforms.flip_img(img), jtf.flip_img(img))


def test_remap_nearest_equals_cv2():
    """Random maps, half-integers and coordinates outside the label image
    included: `cv2.remap(INTER_NEAREST, BORDER_CONSTANT)` exactly."""
    rng = np.random.RandomState(11)
    labels = rng.randint(0, 15, (256, 256)).astype(np.uint8)
    for halves in (False, True):
        gx = rng.uniform(-20, 280, (56, 56)).astype(np.float32)
        gy = rng.uniform(-20, 280, (56, 56)).astype(np.float32)
        if halves:
            gx, gy = (np.round(g * 2) / 2 for g in (gx, gy))
            gx[0, :4] = gy[0, :4] = [-0.5, 0.5, 254.5, 255.5]
        want = cv2.remap(labels, gx, gy, interpolation=cv2.INTER_NEAREST, borderMode=cv2.BORDER_CONSTANT,
                         borderValue=0)
        np.testing.assert_array_equal(dp_annot.remap_nearest(labels, gx, gy), want)


@pytest.mark.parametrize("flip", [False, True])
def test_dp_annot_process_matches_jax(flip, tmp_path):
    """The DensePose blobs of the synthetic annotations (with the official
    table's flip) equal the JAX package's (which remaps with cv2)."""
    npz, _ = write_synthetic_dataset(str(tmp_path), n=4, with_dp=True, img_size=256)
    annots = np.load(npz, allow_pickle=True)["dp_annot"]
    rng = np.random.RandomState(12)
    mat = tmp_path / "sym.mat"
    _write_symmetry_mat(mat, rng)
    sym, jsym = (dm.load_uv_symmetry(str(mat)), jdm.load_uv_symmetry(str(mat))) if flip else (None, None)
    for ann in annots:
        center, scale = rng.uniform(100, 156, 2), rng.uniform(0.7, 1.3)
        for m in (56, 16):
            got = dp_annot.dp_annot_process(ann, m, 224, center, scale, flip=flip, uv_symmetry=sym)
            assert_tree_equal(got, jdp.dp_annot_process(ann, m, 224, center, scale, flip=flip, uv_symmetry=jsym))
    assert_tree_equal(dp_annot.empty_dp_dict(16), jdp.empty_dp_dict(16))


# --------------------------------------------------------------------------
# datasets and loaders
# --------------------------------------------------------------------------

def test_write_synthetic_dataset_matches_jax(tmp_path):
    """The same columns as the JAX writer's (the image names aside: PNG
    here, JPEG there), and PNG pixels equal to the seed's draws."""
    kw = dict(n=5, seed=3, img_size=64, with_dp=True, gendered=True, with_lsp_masks=True)
    ours = write_synthetic_dataset(str(tmp_path / "ours"), **kw)
    theirs = jsynthetic.write_synthetic_dataset(str(tmp_path / "jax"), **kw)
    a, b = np.load(ours[0], allow_pickle=True), np.load(theirs[0], allow_pickle=True)
    assert sorted(a) == sorted(b)
    for k in a:
        if k == "imgname":
            assert [str(n) for n in a[k]] == [f"im_{i:04d}.png" for i in range(5)]
        elif k == "dp_annot":
            assert_tree_equal(list(a[k]), list(b[k]))
        else:
            assert_tree_equal(a[k], b[k], k)
    rng = np.random.RandomState(3)
    for i in range(5):
        np.testing.assert_array_equal(image_io.read_png(os.path.join(ours[1], f"im_{i:04d}.png")),
                                      (rng.rand(64, 64, 3) * 255).astype(np.uint8))
    for name in ("mask_0002.png", "part_0004.png"):      # the LSP annotation PNGs, read by cv2
        np.testing.assert_array_equal(cv2.imread(os.path.join(ours[2], name), cv2.IMREAD_UNCHANGED),
                                      image_io.read_png(os.path.join(ours[2], name)))
        assert cv2.imread(os.path.join(theirs[2], name), cv2.IMREAD_UNCHANGED) is not None


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """Three port-written datasets (PNG images that cv2 and the port read
    alike): plain SPIN rows with 3D, DensePose rows, DensePose rows with
    the official-layout symmetry table (flip on)."""
    d = tmp_path_factory.mktemp("datasets")
    plain = write_synthetic_dataset(str(d / "plain"), n=12, seed=1, img_size=200, gendered=True)
    dp = write_synthetic_dataset(str(d / "dp"), n=12, seed=2, img_size=256, with_dp=True)
    _write_symmetry_mat(d / "sym.mat", np.random.RandomState(13))
    return plain, dp, str(d / "sym.mat")


def _pair(datasets, which, **kw):
    plain, dp, mat = datasets
    npz, img_dir = plain if which == "plain" else dp
    extra, jextra = {}, {}
    if which == "dp_flip":
        extra, jextra = {"uv_symmetry": dm.load_uv_symmetry(mat)}, {"uv_symmetry": jdm.load_uv_symmetry(mat)}
    return (NpzDataset(npz, img_dir, name=which, heatmap_size=16, **extra, **kw),
            JNpzDataset(npz, img_dir, name=which, heatmap_size=16, **jextra, **kw))


@pytest.mark.parametrize("which", ["plain", "dp", "dp_flip"])
def test_npz_dataset_items_match_jax(which, datasets):
    """Items of the same rows under the same RandomState seeds equal the
    JAX package's bit for bit: crops (cv2 there), flips, rotations, noise,
    keypoints, poses, DensePose blobs. The seeds cover flipped and
    rotated rows (DP rows never rotate, and flip only with the table)."""
    ours, theirs = _pair(datasets, which)
    seen = set()
    for index, seed in ((0, 0), (3, 5), (7, 11), (11, 2), (5, 19), (2, 23)):
        a = ours.__getitem__(index, rng=np.random.RandomState(seed))
        b = theirs.__getitem__(index, rng=np.random.RandomState(seed))
        assert_tree_equal(a, b, f"{which}[{index}]")
        seen.add((bool(a["is_flipped"]), bool(a["rot_angle"] != 0)))
    if which == "plain":
        assert {(True, True), (False, False)} <= seen or len(seen) >= 3, seen
    if which == "dp":
        assert seen == {(False, False)}
    if which == "dp_flip":
        assert (True, False) in seen


def test_npz_dataset_eval_mode_and_return_raw(datasets):
    """Eval-mode items equal JAX's; with `return_raw` (the frames for the
    crop on the card), in eval and in train mode, so are the items: the
    raw frame (uint8 RGB) bit for bit, the channel noise and every
    augmented label exactly, and no host crop."""
    ours, theirs = _pair(datasets, "plain", is_train=False, ignore_3d=True)
    assert_tree_equal(ours.__getitem__(4, rng=np.random.RandomState(0)),
                      theirs.__getitem__(4, rng=np.random.RandomState(0)))
    seen = set()
    for which, kw in (("plain", {"is_train": False}), ("plain", {}), ("dp_flip", {})):
        ours, theirs = _pair(datasets, which, return_raw=True, **kw)
        for index, seed in ((0, 0), (3, 5), (7, 11), (11, 2)):
            a = ours.__getitem__(index, rng=np.random.RandomState(seed))
            b = theirs.__getitem__(index, rng=np.random.RandomState(seed))
            assert "img" not in a and a["raw_img"].dtype == np.uint8 and a["pixel_noise"].dtype == np.float32
            assert_tree_equal(a, b, f"{which}[{index}]")
            seen.add((bool(a["is_flipped"]), bool(a["rot_angle"] != 0)))
    assert (True, False) in seen and any(rot for _, rot in seen), seen


def test_collate_refuses_frames_of_mixed_sizes(tmp_path):
    """Raw frames of two sizes cannot form one batch for the crop on the
    card: the loader says so (and names --device_preprocess), where
    numpy's stack would give its own message."""
    a = write_synthetic_dataset(str(tmp_path / "a"), n=2, seed=1, img_size=64)
    b = write_synthetic_dataset(str(tmp_path / "b"), n=2, seed=2, img_size=80)
    parts = [NpzDataset(*a, name="a", return_raw=True), NpzDataset(*b, name="b", return_raw=True)]

    class Both:                  # rows 0-1 of frames of 64 px, rows 2-3 of 80 px
        def __len__(self):
            return 4

        def __getitem__(self, i, rng=None):
            return parts[i // 2].__getitem__(i % 2, rng=rng)

    batches = loader.ResumableLoader(Both(), 4, shuffle=False).epoch(0)
    with pytest.raises(ValueError, match="raw_img.*same size.*--device_preprocess"):
        next(batches)
    same = loader.ResumableLoader(NpzDataset(*a, name="a", return_raw=True), 2, shuffle=False)
    _, batch = next(same.epoch(0))
    assert batch["raw_img"].shape == (2, 64, 64, 3) and batch["raw_img"].dtype == np.uint8


def test_mixed_dataset_draws_match_jax(datasets):
    (a, ja), (b, jb) = _pair(datasets, "plain"), _pair(datasets, "dp")
    sizes = {"h36m": 12, "coco": 12, "mpii": 6}
    assert mixed.itw_partition(sizes) == jmixed.itw_partition(sizes)
    assert mixed.H36M_DP_PARTITION == jmixed.H36M_DP_PARTITION
    ours = mixed.MixedDataset({"h36m": a, "dp_coco": b}, mixed.H36M_DP_PARTITION)
    theirs = jmixed.MixedDataset({"h36m": ja, "dp_coco": jb}, jmixed.H36M_DP_PARTITION)
    assert len(ours) == len(theirs)
    names = set()
    for i in range(8):
        x, y = ours.__getitem__(i, rng=np.random.RandomState(i)), theirs.__getitem__(i, rng=np.random.RandomState(i))
        assert_tree_equal(x, y, f"mixed[{i}]")
        names.add(x["dataset_name"])
    assert names == {"h36m", "dp_coco"}


def _batches(it):
    return [(b, batch) for b, batch in it]


@pytest.mark.parametrize("drop_last,num_shards", [(True, 1), (False, 1), (True, 2)])
def test_resumable_loader_matches_jax(drop_last, num_shards, datasets):
    """The port's loader gives JAX's batches, byte for byte, for two epochs,
    per shard, and from a mid-epoch batch."""
    ours, theirs = _pair(datasets, "dp_flip")
    for shard in range(num_shards):
        kw = dict(batch_size=4, seed=3, drop_last=drop_last, shard_id=shard, num_shards=num_shards)
        a, b = loader.ResumableLoader(ours, **kw), jloader.ResumableLoader(theirs, **kw)
        assert a.num_batches() == b.num_batches()
        for epoch in (0, 1):
            np.testing.assert_array_equal(a.permutation(epoch), b.permutation(epoch))
            got, want = _batches(a.epoch(epoch)), _batches(b.epoch(epoch))
            assert [g[0] for g in got] == [w[0] for w in want]
            for (_, x), (_, y) in zip(got, want):
                assert_tree_equal(x, y)
        resumed = _batches(a.epoch(1, start_batch=1))
        assert [r[0] for r in resumed] == [w[0] for w in want[1:]]
        for (_, x), (_, y) in zip(resumed, want[1:]):
            assert_tree_equal(x, y)


@pytest.mark.parametrize("workers", [1, 3])
def test_prefetch_loader_matches_and_resumes(workers, datasets):
    ours, _ = _pair(datasets, "plain")
    base = loader.ResumableLoader(ours, batch_size=3, seed=5)
    pre = loader.PrefetchLoader(base, depth=2, workers=workers)
    assert pre.num_batches() == base.num_batches()
    for start in (0, 2):
        got, want = _batches(pre.epoch(1, start)), _batches(base.epoch(1, start))
        assert [g[0] for g in got] == [w[0] for w in want] == list(range(start, 4))
        for (_, x), (_, y) in zip(got, want):
            assert_tree_equal(x, y)


class _Failing:
    """A dataset whose sample 5 cannot be read."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i, rng=None):
        if i == 5:
            raise FileNotFoundError("sample 5")
        return self.ds.__getitem__(i, rng=rng)


def test_prefetch_loader_surfaces_errors_and_stops_early(datasets):
    """A producer's exception reaches the consumer; a consumer that stops
    after one batch stops the producer thread."""
    import threading

    ours, _ = _pair(datasets, "plain")
    pre = loader.PrefetchLoader(loader.ResumableLoader(_Failing(ours), batch_size=4, seed=0, shuffle=False),
                                depth=1, workers=2)
    with pytest.raises(FileNotFoundError, match="sample 5"):
        _batches(pre.epoch(0))
    before = threading.active_count()
    pre = loader.PrefetchLoader(loader.ResumableLoader(ours, batch_size=2, seed=0), depth=1, workers=2)
    it = pre.epoch(0)
    next(it)
    it.close()
    assert threading.active_count() <= before

