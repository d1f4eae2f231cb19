"""SMPL kinematic-structure tables and skeleton-graph adjacency (numpy).

Copy of the tables the serving path needs from the JAX package's
`ops/structure.py`; tests pin them equal to the originals. `device_table`
gives a table as an index tensor on a device, made once.
"""

from __future__ import annotations

import numpy as np
import torch

NUM_SMPL_JOINTS = 24

# Parent of each of the 24 SMPL joints in the kinematic tree (root=0 self).
SMPL_PARENT = np.array(
    [0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21],
    dtype=np.int32,
)

# Second child of each joint (leaves point back into their chain).
SMPL_CHILD2 = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 10, 11, 15, 16, 17, 15, 18, 19, 20, 21, 22, 23, 22, 23],
    dtype=np.int32,
)

# The 23 bone edges (parent, child) of the tree.
SMPL_EDGES = np.stack([SMPL_PARENT[1:], np.arange(1, NUM_SMPL_JOINTS, dtype=np.int32)], axis=1)

# SMPL joint -> DensePose patch ids covering it.
SMPL2DP_PART = (
    (1, 2), (8, 10), (7, 9), (1, 2), (8, 10, 12, 14), (7, 9, 11, 13),
    (1, 2), (12, 14, 5), (11, 13, 6), (1, 2), (12, 14, 5), (11, 13, 6),
    (1, 2, 23, 24), (15, 17), (16, 18), (23, 24), (15, 17), (16, 18),
    (15, 17, 19, 21), (16, 18, 20, 22), (19, 21, 4), (20, 22, 3),
    (19, 21, 4), (20, 22, 3),
)

# The fixed 6-patch simplified stack per joint of the partial IUV heads.
DP2SMPL_MAPPING = np.array(
    [
        [7, 8, 9, 10, 1, 2], [1, 2, 8, 10, 12, 14], [1, 2, 7, 9, 11, 13],
        [7, 8, 9, 10, 1, 2], [1, 2, 8, 10, 12, 14], [1, 2, 7, 9, 11, 13],
        [7, 8, 9, 10, 1, 2], [8, 10, 12, 14, 5, 5], [7, 9, 11, 13, 6, 6],
        [7, 8, 9, 10, 1, 2], [8, 10, 12, 14, 5, 5], [7, 9, 11, 13, 6, 6],
        [1, 2, 23, 24, 23, 24], [1, 2, 15, 17, 19, 21], [1, 2, 16, 18, 20, 22],
        [1, 2, 23, 24, 23, 24], [1, 2, 15, 17, 19, 21], [1, 2, 16, 18, 20, 22],
        [1, 2, 15, 17, 19, 21], [1, 2, 16, 18, 20, 22], [15, 17, 19, 21, 4, 4],
        [16, 18, 20, 22, 3, 3], [15, 17, 19, 21, 4, 4], [16, 18, 20, 22, 3, 3],
    ],
    dtype=np.int32,
)

# Extra symmetric links of the 2-neighbour refinement mask: hip-hip/spine
# and collar/neck.
REFINE_EXTRA_LINKS = ((1, 2), (1, 3), (2, 3), (13, 14), (12, 13), (12, 14))


_DEVICE_TABLES: dict = {}


def device_table(table: np.ndarray, device) -> torch.Tensor:
    """The constant integer array `table` as an int64 tensor on `device`,
    made on the first call for that pair and the same tensor after.

    Indexing with a numpy array or a Python list copies it from pageable
    host memory on every call, and that copy waits for the device's queue to
    drain. The tensor is made outside inference mode, so a table first
    asked for while serving can be saved for an autograd backward later.
    """
    key = (id(table), torch.device(device))
    hit = _DEVICE_TABLES.get(key)
    if hit is None:
        with torch.inference_mode(False):
            made = torch.as_tensor(table, dtype=torch.long, device=device)
        # the entry holds `table` itself, so its id is not reused; where two
        # threads race, both return the first entry stored
        hit = _DEVICE_TABLES.setdefault(key, (table, made))
    return hit[1]


def hop_distance(num_nodes: int, edges: np.ndarray, max_hop: int) -> np.ndarray:
    """All-pairs hop distance on an undirected graph, inf beyond max_hop."""
    A = np.zeros((num_nodes, num_nodes))
    A[edges[:, 0], edges[:, 1]] = 1
    A[edges[:, 1], edges[:, 0]] = 1
    dist = np.full((num_nodes, num_nodes), np.inf)
    power = np.eye(num_nodes)
    for d in range(max_hop + 1):
        mask = (power > 0) & np.isinf(dist)
        dist[mask] = d
        power = power @ A + power
    return dist


def smpl_chains() -> list:
    """Ancestor chain (self -> ... -> root) per joint."""
    chains = []
    for i in range(NUM_SMPL_JOINTS):
        chain = [i]
        p = i
        while p != 0:
            p = int(SMPL_PARENT[p])
            chain.append(p)
        chains.append(chain)
    return chains


def rot2pos_adjacency() -> np.ndarray:
    """Row-normalized (24, 24): each joint attends to its strict ancestors."""
    A = np.zeros((NUM_SMPL_JOINTS, NUM_SMPL_JOINTS))
    for i, chain in enumerate(smpl_chains()):
        A[i, chain] = 1
        A[i, i] = 0
    deg = A.sum(axis=1)
    dinv = np.divide(1.0, deg, out=np.zeros_like(deg), where=deg > 0)
    return (dinv[:, None] * A).astype(np.float32)


def pos2rot_adjacency() -> np.ndarray:
    """Row-normalized (24, 24): each joint attends to its tree children,
    parent and itself."""
    A = np.zeros((NUM_SMPL_JOINTS, NUM_SMPL_JOINTS))
    for i in range(NUM_SMPL_JOINTS):
        A[i, SMPL_PARENT[i]] = 1
        A[i, i] = 1
    for j in range(1, NUM_SMPL_JOINTS):
        A[int(SMPL_PARENT[j]), j] = 1
    deg = A.sum(axis=1)
    return ((1.0 / deg)[:, None] * A).astype(np.float32)


def refine_edge_mask() -> np.ndarray:
    """(24, 24) 0/1 mask of learnable refinement edges: the 2-hop skeleton
    neighbourhood plus extra links, self-loops excluded."""
    dist = hop_distance(NUM_SMPL_JOINTS, SMPL_EDGES, 2)
    A = (dist <= 2).astype(np.float32)
    for a, b in ((12, 17), (12, 16)):
        A[a, b] = A[b, a] = 1.0
    for a, b in REFINE_EXTRA_LINKS:
        A[a, b] = A[b, a] = 1.0
    np.fill_diagonal(A, 0.0)
    return A


def smpl2dp_channel_mask() -> np.ndarray:
    """(24, 25) 0/1: patch-index channels covering each SMPL joint."""
    m = np.zeros((NUM_SMPL_JOINTS, 25), dtype=np.float32)
    for j, patches in enumerate(SMPL2DP_PART):
        for p in patches:
            m[j, p] = 1.0
    return m
