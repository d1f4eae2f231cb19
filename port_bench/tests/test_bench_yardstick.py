"""The yardstick's counts against hand counts at small shapes."""

import torch
import torch.nn.functional as F

from port_bench.harness import yardstick
from port_bench.reference.ops.imwarp import separable_crop_concat


def test_k1_counts_by_hand():
    # B=2, 8x8 features of C=4, S=4 crops of K=24 parts, 6 and 5 nonzero taps
    call = (2, 8, 8, 4, 4, 24, 6, 5)
    n_bytes, ops = yardstick.k1_counts(call, 2)
    o = 21
    assert n_bytes == 2 * (2 * 8 * 8 * 4 + 2 * 24 * 4 * 8 + 2 * 24 * 4 * 8 + 9 * 4 * 24 * o + 24 * o
                           + 2 * 24 * 4 * 4 * o)
    assert ops == 2 * 4 * (8 * 6 + 4 * 5) + 2 * 2 * 24 * 4 * 4 * o * 9 * 4
    bound, by = yardstick.k1_bound_s(call, "bfloat16")
    assert by == "bytes" and bound == n_bytes / 3.35e12
    bound32, _ = yardstick.k1_bound_s(call, "float32")
    assert bound32 == 2 * n_bytes / 3.35e12


def test_flops_of_conv_linear_and_crop_by_hand():
    x = torch.randn(2, 3, 8, 8)
    w = torch.randn(5, 3, 3, 3)
    lin = torch.randn(7, 11)
    feats = torch.randn(2, 8, 8, 4)
    # two parts: one inside the map (2 nonzero taps a row), one half outside
    centers = torch.tensor([[[0.1, -0.2], [0.9, 0.95]]]).expand(2, 2, 2)
    scales = torch.tensor([[0.3, 0.5]]).expand(2, 2)
    with yardstick.counting_flops() as c:
        F.conv2d(x, w, padding=1)
        torch.randn(4, 11) @ lin.T
        separable_crop_concat(feats, centers, scales, 4)
    conv = 2 * 2 * 5 * 8 * 8 * 3 * 9
    linear = 2 * 4 * 11 * 7
    (b, h, wd, ch, s, k, ny, nx), = c["crops"]
    assert (b, h, wd, ch, s, k) == (2, 8, 8, 4, 4, 2)
    # nonzeros of the dense interpolation matrices, as chip_smoke's k1_bound counts them
    def dense(center, scale, n):
        o = (2.0 * torch.arange(s) + 1.0) / s - 1.0
        u = (scale[..., None] * o + center[..., None] + 1.0) * (n / 2.0) - 0.5
        return (1.0 - (u[..., :, None] - torch.arange(n)).abs()).clamp(0.0, 1.0)
    assert ny == int((dense(centers[..., 1], scales, 8) != 0).sum())
    assert nx == int((dense(centers[..., 0], scales, 8) != 0).sum())
    assert c["flops"] == conv + linear + 2 * 4 * (8 * ny + 4 * nx)


def test_crop_equals_interpolation_matrices():
    feats = torch.randn(2, 9, 7, 3, dtype=torch.float64)
    centers = torch.rand(2, 24, 2, dtype=torch.float64) * 2.4 - 1.2
    scales = torch.rand(2, 24, dtype=torch.float64) * 0.8 + 0.05
    got = separable_crop_concat(feats, centers, scales, 5)

    def dense(center, scale, n):
        o = (2.0 * torch.arange(5, dtype=torch.float64) + 1.0) / 5 - 1.0
        u = (scale[..., None] * o + center[..., None] + 1.0) * (n / 2.0) - 0.5
        return (1.0 - (u[..., :, None] - torch.arange(n, dtype=torch.float64)).abs()).clamp(0.0, 1.0)

    wy, wx = dense(centers[..., 1], scales, 9), dense(centers[..., 0], scales, 7)
    want = torch.einsum("bkpw,bkowc->bopkc", wx, torch.einsum("bkoh,bhwc->bkowc", wy, feats)).reshape(2, 5, 5, -1)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
