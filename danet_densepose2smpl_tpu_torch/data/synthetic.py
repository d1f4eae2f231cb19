"""Synthetic fixtures (numpy): the raw training batch and the SPIN-format
dataset on disk.

Copies of the JAX package's `data/synthetic.py::synthetic_raw_batch` and
`write_synthetic_dataset` (the JAX `data` package imports JAX); the same
seed gives the same arrays and columns, pinned by tests. The dataset's
images are PNG, written without cv2.
"""

from __future__ import annotations

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
