"""Probabilistic multi-dataset mixing (port of the JAX package's
`data/mixed.py`, reference `datasets/mixed_dataset.py`).

Two menus:
  'h36m_dp'      : {h36m: 0.5, dp_coco: 0.5}
  'h36m_coco_itw': {h36m: 0.3, lsp-orig/mpii/lspet/coco: 0.6 split by size,
                    mpi-inf-3dhp: 0.1}
Each draw picks a dataset by cumulative partition, then the sample at the
permutation index, wrapped into that dataset (`mixed_dataset.py:47-51`).
"""

from __future__ import annotations

import numpy as np

H36M_DP_PARTITION = {"h36m": 0.5, "dp_coco": 0.5}
ITW_DATASETS = ("lsp-orig", "mpii", "lspet", "coco")


def itw_partition(sizes: dict) -> dict:
    """The 'h36m_coco_itw' menu: 30% h36m, 60% in-the-wild split
    proportionally to dataset size, 10% mpi-inf-3dhp
    (reference mixed_dataset.py:27-45)."""
    itw_total = sum(sizes[n] for n in ITW_DATASETS if n in sizes)
    part = {"h36m": 0.3}
    for n in ITW_DATASETS:
        if n in sizes:
            part[n] = 0.6 * sizes[n] / itw_total
    part["mpi-inf-3dhp"] = 0.1
    return part


class MixedDataset:
    """Draws samples from member datasets by fixed probabilities."""

    def __init__(self, datasets: dict, partition: dict):
        self.names = [n for n in partition if n in datasets]
        self.datasets = [datasets[n] for n in self.names]
        probs = np.array([partition[n] for n in self.names], dtype=np.float64)
        self.probs = probs / probs.sum()
        self.cum = np.cumsum(self.probs)
        self.length = max(len(d) for d in self.datasets)

    def __len__(self):
        return self.length

    def __getitem__(self, index: int, rng: np.random.RandomState | None = None) -> dict:
        rng = rng or np.random.RandomState()
        p = rng.uniform()
        ds_idx = min(int(np.searchsorted(self.cum, p)), len(self.datasets) - 1)
        ds = self.datasets[ds_idx]
        item = ds.__getitem__(index % len(ds), rng=rng)
        item["dataset_idx"] = np.int32(ds_idx)
        item["dataset_name"] = self.names[ds_idx]
        return item
