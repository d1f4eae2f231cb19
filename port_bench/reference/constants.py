"""Joint conventions and constants of the port.

A copy of the values the port uses from the JAX package's `constants.py`
(SPIN's 49-joint convention, the DensePose channel counts and the eval
joint selectors), pinned equal to the originals by
`tests/test_torch_config.py`.
"""

from __future__ import annotations

import numpy as np

FOCAL_LENGTH = 5000.0
IMG_RES = 224

# ImageNet normalization of the RGB crops.
IMG_NORM_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMG_NORM_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

# Row i of the extended (24 native SMPL + 21 surface + 9 regressed) joint
# set that supplies joint i of the 49-joint convention.
JOINT_MAP_TO_EXTENDED = np.array(
    [
        # 25 OpenPose joints
        24, 12, 17, 19, 21, 16, 18, 20, 0, 2,
        5, 8, 1, 4, 7, 25, 26, 27, 28, 29,
        30, 31, 32, 33, 34,
        # 24 GT joints
        8, 5, 45, 46, 4, 7, 21, 19, 17, 16,
        18, 20, 47, 48, 49, 50, 51, 52, 53, 24,
        26, 25, 28, 27,
    ],
    dtype=np.int32,
)

# 17 H36M joints -> LSP-style ordering (the first 14 are the LSP joints).
H36M_TO_J17 = np.array([6, 5, 4, 1, 2, 3, 16, 15, 14, 11, 12, 13, 8, 10, 0, 7, 9], dtype=np.int32)
H36M_TO_J14 = H36M_TO_J17[:14]

# 24 GT joints -> the 17 / 14 / 19 subsets.
J24_TO_J17 = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 18, 14, 16, 17], dtype=np.int32)
J24_TO_J14 = J24_TO_J17[:14]
J24_TO_J19 = np.concatenate([J24_TO_J14, np.arange(19, 24, dtype=np.int32)])

# 24 GT joints -> the 17 COCO keypoints (nose, eyes, ears, shoulders, ...).
J24_TO_JCOCO = np.array([19, 20, 21, 22, 23, 9, 8, 10, 7, 11, 6, 3, 2, 4, 1, 5, 0], dtype=np.int32)

# Horizontal flip: the left/right swap of the 24 SMPL joints, its expansion
# to the 72-dim axis-angle pose, and the swaps of the 24 GT, 25 OpenPose
# and 49 joints.
SMPL_JOINTS_FLIP_PERM = np.array(
    [0, 2, 1, 3, 5, 4, 6, 8, 7, 9, 11, 10, 12, 14, 13, 15, 17, 16, 19, 18, 21, 20, 23, 22],
    dtype=np.int32,
)
SMPL_POSE_FLIP_PERM = (3 * SMPL_JOINTS_FLIP_PERM[:, None] + np.arange(3)[None, :]).reshape(-1)
J24_FLIP_PERM = np.array(
    [5, 4, 3, 2, 1, 0, 11, 10, 9, 8, 7, 6, 12, 13, 14, 15, 16, 17, 18, 19, 21, 20, 23, 22],
    dtype=np.int32,
)
OP25_FLIP_PERM = np.array(
    [0, 1, 5, 6, 7, 2, 3, 4, 8, 12, 13, 14, 9, 10, 11, 16, 15, 18, 17, 22, 23, 24, 19, 20, 21],
    dtype=np.int32,
)
J49_FLIP_PERM = np.concatenate([OP25_FLIP_PERM, 25 + J24_FLIP_PERM])

NUM_DP_PATCHES = 24      # DensePose surface patches (I in 1..24; 0 = background)
NUM_DP_PARTS = 14        # coarse body parts of the AnnIndex head (+1 background)
IUV_CHANNELS = NUM_DP_PATCHES + 1    # 25
ANN_CHANNELS = NUM_DP_PARTS + 1      # 15

# Grouping of the 25 patch channels into the 15 AnnIndex channels:
# background, torso (1, 2), hands and feet, then the upper and lower limbs
# with left and right, front and back merged.
INDEX2ANN_GROUPS = (
    (0,), (1, 2), (3,), (4,), (5,), (6,), (7, 9), (8, 10),
    (11, 13), (12, 14), (15, 17), (16, 18), (19, 21), (20, 22), (23, 24),
)


def index2ann_matrix() -> np.ndarray:
    """(25, 15) 0/1 matrix mapping patch-index channels to ann channels."""
    m = np.zeros((IUV_CHANNELS, ANN_CHANNELS), dtype=np.float32)
    for ann_ch, patches in enumerate(INDEX2ANN_GROUPS):
        for p in patches:
            m[p, ann_ch] = 1.0
    return m
