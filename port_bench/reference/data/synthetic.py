"""The raw training batch of the port's `data/synthetic.py`, frozen: the
same seed gives the same arrays."""

from __future__ import annotations

import numpy as np

from port_bench.reference.config import Config


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
