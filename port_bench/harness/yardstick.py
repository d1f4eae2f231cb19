"""The yardstick: the H100's peaks, K1's bound from its shapes, and the
FLOPs of the reference at a cell's shapes.

One peak per precision, whatever implements the work (NVIDIA's data sheet,
H100 SXM, dense, at the full 700 W): bf16 989 TFLOP/s; fp32 495 TFLOP/s,
the TF32 tensor-core rate, the highest at which the card does arithmetic
on fp32 inputs (a kernel that beats a 3xTF32 or an FFMA bound still reads
under 100%); HBM 3.35 TB/s. A share is stated beside the card's power
limit, which the run records.

K1's counts are a frozen copy of `chip_smoke.py::k1_bound`'s: its inputs
and output once, the separable crop over the interpolation weights'
nonzeros and the grouped 3x3 conv. FLOPs are counted once, from the
reference (`torch.utils.flop_counter.FlopCounterMode` over its matrix
products and convolutions), with the part crops counted over their taps'
nonzero weights (`reference.ops.imwarp.counting_crops`), so `mfu` reads
the same work whatever computes it.
"""

from __future__ import annotations

import contextlib

import torch

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
PEAK_BYTES_PER_S = 3.35e12
K1_PARTS_OUT = 21   # 3 x part_dim (U, V, index of 7 channels) per part


def k1_counts(call: tuple, elt_bytes: int) -> tuple[int, int]:
    """(bytes, operations) of one K1 launch from the reference's crop call
    (B, H, W, C, S, K, nnz(wy), nnz(wx)), its tensors `elt_bytes` wide:
    feats (B, H, W, C), wy (B, K, S, H), wx (B, K, S, W), the kernel
    (3, 3, C, K O), the bias (K O) and the output (B, K, S, S, O)."""
    b, h, w, c, s, k, ny, nx = call
    o = K1_PARTS_OUT
    n_bytes = elt_bytes * (b * h * w * c + b * k * s * h + b * k * s * w + 9 * c * k * o + k * o
                           + b * k * s * s * o)
    crop = 2 * c * (w * ny + s * nx)
    conv = 2 * b * k * s * s * o * 9 * c
    return n_bytes, crop + conv


def k1_bound_s(call: tuple, dtype: str) -> tuple[float, str]:
    """(seconds, 'bytes' or 'operations'): the least time of one K1 launch."""
    elt = 2 if dtype == "bfloat16" else 4
    n_bytes, ops = k1_counts(call, elt)
    by_bytes, by_ops = n_bytes / PEAK_BYTES_PER_S, ops / PEAK_FLOPS[dtype]
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


@contextlib.contextmanager
def counting_flops():
    """Count the reference's FLOPs inside the block: yields a dict whose
    'flops' (matrix products and convolutions, forward and backward, plus
    the crops over their nonzeros) and 'crops' (the crop calls) are set
    when the block ends."""
    from torch.utils.flop_counter import FlopCounterMode

    from port_bench.reference.ops.imwarp import counting_crops

    result = {}
    counter = FlopCounterMode(display=False)
    with counting_crops() as crops, counter:
        yield result
    result["flops"] = counter.get_total_flops() + crops.flops
    result["crops"] = list(crops.calls)


def power_limit_w() -> float | None:
    """The card's power limit in W (nvidia-smi), or None where it cannot
    be read."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
