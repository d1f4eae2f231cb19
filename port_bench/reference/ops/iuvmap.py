"""IUV map codec of the reference (a frozen copy of the port's
`ops/iuvmap.py::iuvmap_clean` and `iuv_img2map`).

"img" form: (B, H, W, 3) channels (I/24, U, V); "maps" form: per-channel
stacks (B, H, W, 25) for U/V/Index and a 15-channel ann stack.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from port_bench.reference.constants import IUV_CHANNELS, NUM_DP_PATCHES, index2ann_matrix


def one_hot_argmax(x: torch.Tensor) -> torch.Tensor:
    """one_hot(argmax(x, -1)) in x's dtype. `torch.argmax` returns the first
    maximal index, as `jnp.argmax` does."""
    return F.one_hot(torch.argmax(x, dim=-1), x.shape[-1]).to(x.dtype)


def iuvmap_clean(u_map, v_map, index_map, ann_map=None):
    """One-hot-ify predicted logit stacks, channels last (..., 25) (ann:
    (..., 15)); U/V are masked to the winning index channel."""
    index_oh = one_hot_argmax(index_map).to(u_map.dtype)
    ann_oh = None if ann_map is None else one_hot_argmax(ann_map).to(u_map.dtype)
    return index_oh * u_map, index_oh * v_map, index_oh, ann_oh


def iuv_img2map(uv_images: torch.Tensor):
    """IUV image (B, H, W, 3) -> (U, V, Index, Ann) stacks. round(I*24)
    recovers the patch id; an id outside 0..24 gives an all-zero one-hot
    row, as `jax.nn.one_hot` does. Ann merges patch channels by the fixed
    (25, 15) grouping matrix."""
    part_id = torch.round(uv_images[..., 0] * NUM_DP_PATCHES).long()
    chans = torch.arange(IUV_CHANNELS, device=uv_images.device)
    index_oh = (part_id[..., None] == chans).to(uv_images.dtype)
    u = index_oh * uv_images[..., 1:2]
    v = index_oh * uv_images[..., 2:3]
    ann = index_oh @ torch.as_tensor(index2ann_matrix(), dtype=uv_images.dtype, device=uv_images.device)
    return u, v, index_oh, ann
