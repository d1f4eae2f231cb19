"""Pseudo-ground-truth SMPL fits store (port of the JAX package's
`train/fits_dict.py`, reference `train/fits_dict.py`, SPIN final/static
fits).

Per-dataset (N, 82) arrays of [pose(72), betas(10)] plus a valid-fit
flag; `lookup` applies the sample's rotation and flip to the stored pose so
the pseudo-label matches the augmented image. DaNet never writes back (no
in-the-loop SMPLify), so the store is read-only after construction.
"""

from __future__ import annotations

import os

import numpy as np

from danet_densepose2smpl_tpu_torch.data.transforms import flip_pose, rot_aa_np


class FitsDict:
    def __init__(self, fits: dict, valid: dict | None = None):
        """fits: {dataset_name: (N, 82) array}; valid: {name: (N,) uint8}."""
        self.fits = {k: np.asarray(v, np.float32) for k, v in fits.items()}
        self.valid = {
            k: (np.asarray(valid[k], np.uint8) if valid and k in valid else np.ones(len(v), np.uint8))
            for k, v in self.fits.items()
        }

    @classmethod
    def from_files(cls, names: list, final_fits_dir: str, static_fits_dir: str | None = None):
        """Per-dataset fits by the reference's fallback chain
        (`fits_dict.py:23-43`): h36m .npy (GT, always valid), else SPIN
        final-fits .npz (pose/betas/valid_fit), else static fits .npy."""
        fits, valid = {}, {}
        for name in names:
            npy = os.path.join(final_fits_dir, name + ".npy")
            npz = os.path.join(final_fits_dir, name + ".npz")
            if name == "h36m" and os.path.isfile(npy):
                fits[name] = np.load(npy)
            elif os.path.isfile(npz):
                d = np.load(npz)
                fits[name] = np.concatenate([d["pose"], d["betas"]], axis=1)
                valid[name] = d["valid_fit"]
            elif static_fits_dir is not None:
                fits[name] = np.load(os.path.join(static_fits_dir, name + "_fits.npy"))
            else:
                raise FileNotFoundError(f"no fits for dataset {name}")
        return cls(fits, valid)

    @classmethod
    def from_datasets(cls, datasets: dict):
        """From the datasets' own GT (synthetic/fixture mode): valid where
        the dataset has SMPL labels."""
        fits, valid = {}, {}
        for name, ds in datasets.items():
            fits[name] = np.concatenate([ds.pose, ds.betas], axis=1).astype(np.float32)
            valid[name] = ds.has_smpl.astype(np.uint8)
        return cls(fits, valid)

    def lookup(self, names, indices, rot_angles, is_flipped):
        """Batch lookup with the augmentation applied. Returns (pose
        (B, 72), betas (B, 10), valid (B,))."""
        b = len(indices)
        pose = np.zeros((b, 72), np.float32)
        betas = np.zeros((b, 10), np.float32)
        valid = np.zeros(b, np.float32)
        for n, (ds, i) in enumerate(zip(names, indices)):
            row = self.fits[ds][int(i)]
            p = row[:72].copy()
            r = float(rot_angles[n])
            if r != 0:
                p[:3] = rot_aa_np(p[:3], r)
            if is_flipped[n]:
                p = flip_pose(p)
            pose[n] = p
            betas[n] = row[72:]
            valid[n] = float(self.valid[ds][int(i)])
        return pose, betas, valid
