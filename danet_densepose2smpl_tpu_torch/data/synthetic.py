"""Synthetic fixtures (numpy): the raw training batch, the SPIN-format
dataset on disk, and a densepose_coco json for the offline preprocessing.

`synthetic_raw_batch` and `write_synthetic_dataset` are copies of the JAX
package's `data/synthetic.py` functions (the JAX `data` package imports
JAX); the same seed gives the same arrays and columns, pinned by tests.
The dataset's images are PNG, written without cv2.
`write_synthetic_dp_coco_json` is the port's own.
"""

from __future__ import annotations

import json
import os

import numpy as np

from danet_densepose2smpl_tpu_torch.config import Config


def synthetic_raw_batch(cfg: Config, batch_size: int, seed: int = 0, num_dp_points: int = 196):
    """A raw training batch, BEFORE `train.prepare.prepare_targets`: GT
    pose/betas and the fits-lookup results (opt_pose/opt_betas/opt_valid),
    no opt_rotmat/uv_image_gt, so the step runs the full in-step target
    preparation (pseudo-fit merge, SMPL forwards, WLS camera fits, keypoint
    projection, GT IUV raster)."""
    rng = np.random.RandomState(seed)
    b = batch_size
    s = cfg.danet.heatmap_size
    res = cfg.danet.img_size
    return {
        "img": rng.rand(b, res, res, 3).astype(np.float32),
        "keypoints": np.concatenate(
            [rng.uniform(-1, 1, (b, 49, 2)), np.ones((b, 49, 1))], -1
        ).astype(np.float32),
        "pose": (rng.randn(b, 72) * 0.3).astype(np.float32),
        "betas": (rng.randn(b, 10) * 0.5).astype(np.float32),
        "pose_3d": np.concatenate(
            [rng.randn(b, 24, 3) * 0.3, np.ones((b, 24, 1))], -1
        ).astype(np.float32),
        "smpl_2dkps": np.concatenate(
            [rng.uniform(-1, 1, (b, 24, 2)), np.ones((b, 24, 1))], -1
        ).astype(np.float32),
        "opt_pose": (rng.randn(b, 72) * 0.3).astype(np.float32),
        "opt_betas": (rng.randn(b, 10) * 0.5).astype(np.float32),
        "opt_valid": np.ones(b, np.float32),
        "is_dp_dataset": np.zeros(b, np.float32),
        "has_smpl": np.ones(b, np.float32),
        "has_dp": np.zeros(b, np.float32),
        "has_pose_3d": np.ones(b, np.float32),
        "dp_dict": {
            "x": rng.uniform(0, s, (b, num_dp_points)).astype(np.float32),
            "y": rng.uniform(0, s, (b, num_dp_points)).astype(np.float32),
            "i_points": rng.randint(0, 25, (b, num_dp_points)).astype(np.int32),
            "u_points": rng.rand(b, 25, num_dp_points).astype(np.float32),
            "v_points": rng.rand(b, 25, num_dp_points).astype(np.float32),
            "point_weights": (rng.rand(b, 25, num_dp_points) > 0.5).astype(np.float32),
            "ann_labels": rng.randint(0, 15, (b, s, s)).astype(np.int32),
        },
    }


def write_synthetic_dataset(
    out_dir: str,
    n: int = 16,
    seed: int = 0,
    img_size: int = 256,
    with_smpl: bool = True,
    with_pose3d: bool = True,
    with_dp: bool = False,
    gendered: bool = False,
    with_lsp_masks: bool = False,
):
    """Write a SPIN-format npz and PNG images (`im_0000.png`, ...) to
    `out_dir`; return (npz_path, img_dir), plus annot_dir with
    `with_lsp_masks`.

    The columns mirror the reference's label archives
    (`datasets/base_dataset.py:35-111`): imgname, center, scale, pose,
    shape, S, part, openpose, optionally dp_annot/smpl_2dkps/gender and the
    LSP mask/part PNG names. The JAX package draws the same numbers in the
    same order and writes the same pixels as JPEG."""
    from danet_densepose2smpl_tpu_torch.data.image_io import write_png
    from danet_densepose2smpl_tpu_torch.data.rle import encode_rle

    rng = np.random.RandomState(seed)
    img_dir = os.path.join(out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)

    names = []
    for i in range(n):
        img = (rng.rand(img_size, img_size, 3) * 255).astype(np.uint8)
        name = f"im_{i:04d}.png"
        write_png(os.path.join(img_dir, name), img)
        names.append(name)

    cols = {
        "imgname": np.array(names),
        "center": np.tile([img_size / 2, img_size / 2], (n, 1)).astype(np.float64),
        "scale": rng.uniform(0.8, 1.2, n),
        "part": np.concatenate(
            [rng.uniform(60, img_size - 60, (n, 24, 2)), np.ones((n, 24, 1))], -1
        ),
        "openpose": np.zeros((n, 25, 3)),
    }
    if with_smpl:
        cols["pose"] = (rng.randn(n, 72) * 0.2).astype(np.float64)
        cols["shape"] = (rng.randn(n, 10) * 0.5).astype(np.float64)
        cols["has_smpl"] = np.ones(n, np.float32)
    if with_pose3d:
        cols["S"] = np.concatenate(
            [rng.randn(n, 24, 3) * 0.3, np.ones((n, 24, 1))], -1
        ).astype(np.float64)
    if gendered:
        cols["gender"] = np.array(["m" if rng.rand() < 0.5 else "f" for _ in range(n)])
    if with_dp:
        annots = []
        for i in range(n):
            npts = rng.randint(20, 60)
            masks = []
            for p in range(14):
                mm = np.zeros((256, 256), np.uint8)
                if rng.rand() < 0.6:
                    y0, x0 = rng.randint(0, 200, 2)
                    mm[y0 : y0 + 40, x0 : x0 + 40] = 1
                masks.append(encode_rle(mm))
            annots.append(
                {
                    "bbox": [60.0, 60.0, float(img_size - 120), float(img_size - 120)],
                    "dp_masks": masks,
                    "dp_I": rng.randint(1, 25, npts).astype(float).tolist(),
                    "dp_U": rng.rand(npts).tolist(),
                    "dp_V": rng.rand(npts).tolist(),
                    "dp_x": rng.uniform(0, 255, npts).tolist(),
                    "dp_y": rng.uniform(0, 255, npts).tolist(),
                }
            )
        cols["dp_annot"] = np.array(annots, dtype=object)
        cols["smpl_2dkps"] = np.concatenate(
            [rng.uniform(60, img_size - 60, (n, 24, 2)), np.ones((n, 24, 1))], -1
        )

    annot_dir = None
    if with_lsp_masks:
        # upi-s1h-style GT annotation PNGs (reference eval.py:232,252):
        # maskname -> binary silhouette, partname -> 0..6 labels with a
        # 255-ignore border
        annot_dir = os.path.join(out_dir, "annots")
        os.makedirs(annot_dir, exist_ok=True)
        masknames, partnames = [], []
        for i in range(n):
            m = np.zeros((img_size, img_size), np.uint8)
            y0, x0 = rng.randint(40, 120, 2)
            m[y0 : y0 + 100, x0 : x0 + 100] = 1
            pth = np.zeros((img_size, img_size), np.uint8)
            pth[m > 0] = rng.randint(1, 7, (m > 0).sum())
            pth[y0 : y0 + 4] = 255  # ignore strip
            mn, pn = f"mask_{i:04d}.png", f"part_{i:04d}.png"
            write_png(os.path.join(annot_dir, mn), m * 255)
            write_png(os.path.join(annot_dir, pn), pth)
            masknames.append(mn)
            partnames.append(pn)
        cols["maskname"] = np.array(masknames)
        cols["partname"] = np.array(partnames)

    npz_path = os.path.join(out_dir, "labels.npz")
    np.savez(npz_path, **cols)
    return (npz_path, img_dir, annot_dir) if with_lsp_masks else (npz_path, img_dir)


DP_COCO_KINDS = ("plain", "crowd", "compressed", "no_kps", "empty_kps", "many", "no_dp", "odd")


def _dp_coco_annotation(rng: np.random.RandomState, aid: int, image_id: int, kind: str) -> dict:
    """One densepose_coco annotation of the kind named: 'plain'; 'crowd'
    (iscrowd with DensePose labels); 'compressed' (every mask a compressed
    RLE string; other kinds mix both variants); 'no_kps' (no keypoints
    key); 'empty_kps' (an empty list); 'many' (over 196 points); 'no_dp'
    (no DensePose labels: the converter drops it); 'odd' (a patch id, a
    point and a U out of range and a zero-width box: preflight warnings)."""
    from danet_densepose2smpl_tpu_torch.data.rle import compress_counts, encode_rle

    ann = {"id": aid, "image_id": image_id, "iscrowd": int(kind == "crowd"),
           "bbox": [float(v) for v in rng.uniform(5, 60, 2)] + [float(v) for v in rng.uniform(30, 150, 2)]}
    kps = np.stack([rng.uniform(0, 200, 17), rng.uniform(0, 200, 17), rng.randint(0, 3, 17)], 1)
    ann["keypoints"] = kps.reshape(-1).tolist()
    ann["num_keypoints"] = int((kps[:, 2] > 0).sum())
    if kind == "no_dp":
        return ann
    if kind == "no_kps":
        del ann["keypoints"]
    if kind == "empty_kps":
        ann["keypoints"] = []
    masks = []
    for _ in range(14):
        if rng.rand() < 0.4:
            masks.append([])
            continue
        m = np.zeros((256, 256), np.uint8)
        y0, x0 = rng.randint(0, 200, 2)
        m[y0:y0 + rng.randint(5, 56), x0:x0 + rng.randint(5, 56)] = 1
        rle = encode_rle(m)
        if kind == "compressed" or rng.rand() < 0.3:
            rle = {"size": rle["size"], "counts": compress_counts(rle["counts"]).decode("ascii")}
        masks.append(rle)
    ann["dp_masks"] = masks
    n = rng.randint(210, 260) if kind == "many" else rng.randint(1, 120)
    ann["dp_I"] = rng.randint(1, 25, n).astype(float).tolist()
    ann["dp_U"] = rng.rand(n).tolist()
    ann["dp_V"] = rng.rand(n).tolist()
    ann["dp_x"] = rng.uniform(0, 256, n).tolist()
    ann["dp_y"] = rng.uniform(0, 256, n).tolist()
    if kind == "odd":
        ann["dp_I"][0] = 25.0
        ann["dp_x"][0] = 300.0
        ann["dp_U"][0] = 1.5
        ann["bbox"][2] = 0.0
    return ann


def write_synthetic_dp_coco_json(path: str, n: int, seed: int = 0, n_images: int = 6, kinds=DP_COCO_KINDS,
                                 img_dir: str | None = None, frame_size=(240, 320)) -> dict:
    """Write a densepose_coco json of `n` annotations over `n_images`
    frames (`COCO_train2014_<i>.png`), the `kinds` in turn (see
    `_dp_coco_annotation`), and return it; with `img_dir`, also the frames
    as random RGB PNGs of `frame_size` (height, width)."""
    from danet_densepose2smpl_tpu_torch.data.image_io import write_png

    rng = np.random.RandomState(seed)
    h, w = frame_size
    db = {"images": [{"id": 100 + i, "file_name": f"COCO_train2014_{i:012d}.png", "height": h, "width": w}
                     for i in range(n_images)],
          "annotations": [_dp_coco_annotation(rng, i + 1, 100 + i % n_images, kinds[i % len(kinds)])
                          for i in range(n)]}
    with open(path, "w") as f:
        json.dump(db, f)
    if img_dir is not None:
        os.makedirs(img_dir, exist_ok=True)
        for im in db["images"]:
            write_png(os.path.join(img_dir, im["file_name"]), rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
    return db
