"""SPIN-format npz datasets with per-sample augmentation (port of the JAX
package's `data/dataset.py`, reference `datasets/base_dataset.py`).

npz columns (imgname, center, scale, pose, shape, S, part, openpose,
smpl_2dkps, dp_annot, gender, ...) with per-key fallbacks; augmentation =
flip 1/2, channel noise, +-2*rot_factor rotation (zeroed w.p. 0.6),
+-scale_factor scaling; rotation forced to 0 for DensePose samples. Each
sample's augmentation comes from the `RandomState` its caller passes, so a
loader that derives it from (seed, epoch, slot) replays a resumed epoch
exactly. Items are numpy dicts with channels-last RGB crops, normalized,
or with `return_raw` the decoded frame as uint8 for the crop on the card
(`data/pipeline.py`). Images are read without cv2 (`data/image_io.py`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from danet_densepose2smpl_tpu_torch.constants import (
    IMG_NORM_MEAN,
    IMG_NORM_STD,
    IMG_RES,
    SMPL_JOINTS_FLIP_PERM,
)
from danet_densepose2smpl_tpu_torch.data.dp_annot import dp_annot_process, empty_dp_dict
from danet_densepose2smpl_tpu_torch.data.image_io import read_rgb
from danet_densepose2smpl_tpu_torch.data.transforms import (
    crop,
    flip_img,
    flip_kp,
    flip_pose,
    rot_aa_np,
    transform_points,
)


@dataclass
class AugmentConfig:
    noise_factor: float = 0.4
    rot_factor: float = 30.0
    scale_factor: float = 0.25
    flip_prob: float = 0.5
    rot_zero_prob: float = 0.6


class NpzDataset:
    """One npz-backed dataset.

    `return_raw` emits the decoded full frame (`raw_img`, uint8 RGB) and
    the channel noise (`pixel_noise`, float32) in place of `img`: the crop,
    flip, noise and normalization then run on the card
    (`data/pipeline.device_preprocess[_train]`), and batches need frames of
    one size. The labels are still augmented here."""

    def __init__(
        self,
        npz_path: str,
        img_dir: str | None,
        name: str = "",
        is_train: bool = True,
        heatmap_size: int = 56,
        ignore_3d: bool = False,
        use_augmentation: bool = True,
        augment: AugmentConfig | None = None,
        uv_symmetry=None,
        return_raw: bool = False,
    ):
        self.return_raw = return_raw
        self.name = name or os.path.basename(npz_path)
        self.img_dir = img_dir
        self.is_train = is_train
        self.heatmap_size = heatmap_size
        self.augment = augment or AugmentConfig()
        self.use_augmentation = use_augmentation
        # DensePose flip symmetry tables; without them DP samples never flip
        self.uv_symmetry = uv_symmetry

        data = np.load(npz_path, allow_pickle=True)
        self.imgname = data["imgname"]
        n = len(self.imgname)
        self.scale = data["scale"]
        self.center = data["center"]

        if "pose" in data and "shape" in data:
            self.pose = data["pose"].astype(np.float64)
            self.betas = data["shape"].astype(np.float64)
            self.has_smpl = data["has_smpl"] if "has_smpl" in data else np.ones(n, np.float32)
        else:
            self.pose = np.zeros((n, 72))
            self.betas = np.zeros((n, 10))
            self.has_smpl = np.zeros(n, np.float32)
        if ignore_3d:
            self.has_smpl = np.zeros(n, np.float32)

        self.smpl_2dkps = data["smpl_2dkps"] if "smpl_2dkps" in data else None
        self.dp_annot = data["dp_annot"] if "dp_annot" in data else None
        self.has_dp = np.ones(n, np.float32) if self.dp_annot is not None else np.zeros(n, np.float32)

        self.pose_3d = data["S"] if "S" in data else None
        self.has_pose_3d = 0 if (self.pose_3d is None or ignore_3d) else 1

        kp_gt = data["part"] if "part" in data else np.zeros((n, 24, 3))
        kp_op = data["openpose"] if "openpose" in data else np.zeros((n, 25, 3))
        self.keypoints = np.concatenate([kp_op, kp_gt], axis=1)

        if "gender" in data:
            self.gender = np.array([0 if str(g) == "m" else 1 for g in data["gender"]], np.int32)
        else:
            self.gender = -np.ones(n, np.int32)

        self.maskname = data["maskname"] if "maskname" in data else None
        self.partname = data["partname"] if "partname" in data else None

    def __len__(self):
        return len(self.imgname)

    # --- augmentation -------------------------------------------------------

    def _augm_params(self, rng: np.random.RandomState):
        flip, pn, rot, sc = 0, np.ones(3), 0.0, 1.0
        if self.is_train and self.use_augmentation:
            a = self.augment
            if rng.uniform() <= a.flip_prob:
                flip = 1
            pn = rng.uniform(1 - a.noise_factor, 1 + a.noise_factor, 3)
            rot = float(np.clip(rng.randn() * a.rot_factor, -2 * a.rot_factor, 2 * a.rot_factor))
            sc = float(np.clip(rng.randn() * a.scale_factor + 1, 1 - a.scale_factor, 1 + a.scale_factor))
            if rng.uniform() <= a.rot_zero_prob:
                rot = 0.0
        return flip, pn, rot, sc

    def _load_image(self, index: int) -> np.ndarray:
        """RGB uint8 (H, W, 3)."""
        path = os.path.join(self.img_dir or "", str(self.imgname[index]))
        if not os.path.isfile(path):
            raise FileNotFoundError(path)
        return read_rgb(path)

    def _j2d_processing(self, kp, center, scale, rot, flip):
        kp = kp.copy()
        kp[:, :2] = transform_points(kp[:, :2] + 1, center, scale, (IMG_RES, IMG_RES), rot=rot)
        kp[:, :-1] = 2.0 * kp[:, :-1] / IMG_RES - 1.0
        if flip:
            kp = flip_kp(kp)
        return kp.astype(np.float32)

    def __getitem__(self, index: int, rng: np.random.RandomState | None = None) -> dict:
        rng = rng or np.random.RandomState()
        item = {}
        scale = float(self.scale[index])
        center = np.asarray(self.center[index], dtype=np.float64).copy()

        flip, pn, rot, sc = self._augm_params(rng)
        if self.has_dp[index]:
            rot = 0.0

        img = self._load_image(index)
        orig_shape = np.array(img.shape[:2], np.int32)

        if self.has_dp[index]:
            if flip and self.uv_symmetry is None:
                # flip symmetry needs the DensePose symmetry tables; keep
                # annotations consistent by disabling flip for DP rows
                flip = 0
            dp_dict = dp_annot_process(
                self.dp_annot[index], self.heatmap_size, IMG_RES, center, sc * scale,
                flip=bool(flip), uv_symmetry=self.uv_symmetry,
            )
        else:
            dp_dict = empty_dp_dict(self.heatmap_size)
        item["dp_dict"] = dp_dict

        pose = self.pose[index].copy() if self.has_smpl[index] else np.zeros(72)
        betas = self.betas[index].copy() if self.has_smpl[index] else np.zeros(10)

        if self.return_raw:
            # the augmentation the card replays on the frame
            item["raw_img"] = img
            item["pixel_noise"] = pn.astype(np.float32)
        else:
            rgb = crop(img.astype(np.float32), center, sc * scale, (IMG_RES, IMG_RES), rot=rot)
            if flip:
                rgb = flip_img(rgb)
            rgb = np.clip(rgb * pn[None, None, :], 0, 255) / 255.0
            item["img"] = ((rgb - IMG_NORM_MEAN) / IMG_NORM_STD).astype(np.float32)

        pose[:3] = rot_aa_np(pose[:3], rot)
        if flip:
            pose = flip_pose(pose)
        item["pose"] = pose.astype(np.float32)
        item["betas"] = betas.astype(np.float32)

        if self.smpl_2dkps is not None:
            kps = self._j2d_processing(self.smpl_2dkps[index].copy(), center, sc * scale, rot, flip=0)
            kps[kps[:, 2] == 0] = 0
            if flip:
                kps = kps[SMPL_JOINTS_FLIP_PERM]
                kps[:, 0] = -kps[:, 0]
            item["smpl_2dkps"] = kps.astype(np.float32)
        else:
            item["smpl_2dkps"] = np.zeros((24, 3), np.float32)

        if self.has_pose_3d:
            S = self.pose_3d[index].copy()
            if rot != 0:
                rad = -rot * np.pi / 180
                sn, cs = np.sin(rad), np.cos(rad)
                R = np.array([[cs, -sn, 0], [sn, cs, 0], [0, 0, 1.0]])
                S[:, :-1] = S[:, :-1] @ R.T
            if flip:
                S = flip_kp(S)
            item["pose_3d"] = S.astype(np.float32)
        else:
            item["pose_3d"] = np.zeros((24, 4), np.float32)

        item["keypoints"] = self._j2d_processing(self.keypoints[index].copy(), center, sc * scale, rot, flip)

        item["has_dp"] = np.float32(self.has_dp[index])
        item["has_smpl"] = np.float32(self.has_smpl[index])
        item["has_pose_3d"] = np.float32(self.has_pose_3d)
        item["scale"] = np.float32(sc * scale)
        item["center"] = center.astype(np.float32)
        item["orig_shape"] = orig_shape
        item["is_flipped"] = np.float32(flip)
        item["rot_angle"] = np.float32(rot)
        item["gender"] = self.gender[index]
        item["sample_index"] = np.int32(index)
        item["dataset_name"] = self.name
        item["maskname"] = str(self.maskname[index]) if self.maskname is not None else ""
        item["partname"] = str(self.partname[index]) if self.partname is not None else ""
        return item
