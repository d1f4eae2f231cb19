"""The port's fused crop + partial-head (K1): its plain version against the
JAX kernel and the JAX separable path on the CPU, the bf16 kernel's packed
weight operand, its device dispatch, and (on a card only) the CUDA kernels
against the plain version."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from danet_densepose2smpl_tpu.kernels.part_crop_head import fused_part_predict as jax_fused

from danet_densepose2smpl_tpu_torch.kernels.part_crop_head import (
    BF16_MAX_PIXELS,
    CHUNK32_COST,
    SMEM_TWO_BLOCKS,
    bf16_chunk,
    bf16_plan,
    load_library,
    fused_part_predict,
    pack_head_weights,
    part_crop_head_plain,
)
from danet_densepose2smpl_tpu_torch.nn.iuv_head import PartialIUVHead
from danet_densepose2smpl_tpu_torch.ops.imwarp import _axis_weights, separable_crop

from test_part_crop_head import reference_path

torch.set_num_threads(1)
# the JAX test's own bar (tests/test_part_crop_head.py)
ATOL = 2e-5


def _inputs(rng, b=2, h=16, w=16, c=8, k=24, o=21, s=8):
    """The scales of tests/test_part_crop_head.py."""
    feats = rng.rand(b, h, w, c).astype(np.float32)
    centers = rng.uniform(-0.6, 0.6, (b, k, 2)).astype(np.float32)
    scales = rng.uniform(0.2, 0.9, (b, k)).astype(np.float32)
    kernel = (rng.randn(3, 3, c, k * o) * 0.1).astype(np.float32)
    bias = (rng.randn(k * o) * 0.1).astype(np.float32)
    return feats, centers, scales, kernel, bias, s


def _weights(centers, scales, h, w, s, dtype=torch.float32):
    c, sc = torch.from_numpy(centers), torch.from_numpy(scales)
    return (_axis_weights(c[..., 1], sc, h, s, dtype), _axis_weights(c[..., 0], sc, w, s, dtype))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def test_plain_matches_jax_kernel_interpret(rng):
    feats, centers, scales, kernel, bias, s = _inputs(rng)
    h, w = feats.shape[1:3]
    wy, wx = _weights(centers, scales, h, w, s)
    got = part_crop_head_plain(torch.from_numpy(feats), wy, wx, torch.from_numpy(kernel),
                               torch.from_numpy(bias), s).numpy()
    exp = np.asarray(jax_fused(
        jnp.asarray(feats), jnp.asarray(wy.numpy()), jnp.asarray(wx.numpy()),
        jnp.asarray(kernel), jnp.asarray(bias), s, interpret=True))
    assert got.shape == exp.shape == (2, 24, s, s, 21)
    np.testing.assert_allclose(got, exp, atol=ATOL)


def test_plain_matches_jax_separable_path_dense_weights(rng):
    """Arbitrary dense interpolation matrices, not only 2-tap bilinear ones."""
    feats, _, _, kernel, bias, s = _inputs(rng)
    b, h, w, _ = feats.shape
    wy = rng.rand(b, 24, s, h).astype(np.float32) / h
    wx = rng.rand(b, 24, s, w).astype(np.float32) / w
    got = fused_part_predict(*(torch.from_numpy(a) for a in (feats, wy, wx, kernel, bias)), s).numpy()
    exp = np.asarray(jax_fused(*(jnp.asarray(a) for a in (feats, wy, wx, kernel, bias)), s,
                               interpret=True))
    np.testing.assert_allclose(got, exp, atol=ATOL)


def test_wrapper_on_cpu_matches_separable_path_and_never_launches(rng):
    feats, centers, scales, kernel, bias, s = _inputs(rng)
    h, w = feats.shape[1:3]
    wy, wx = _weights(centers, scales, h, w, s)
    before = fused_part_predict.launches
    got = fused_part_predict(torch.from_numpy(feats), wy, wx, torch.from_numpy(kernel),
                             torch.from_numpy(bias), s).numpy()
    assert fused_part_predict.launches == before == 0
    exp = np.asarray(reference_path(jnp.asarray(feats), jnp.asarray(centers), jnp.asarray(scales),
                                    jnp.asarray(kernel), jnp.asarray(bias), s))
    np.testing.assert_allclose(got, exp, atol=ATOL)


def test_wrapper_refuses_other_devices(rng):
    feats, centers, scales, kernel, bias, s = _inputs(rng)
    args = [torch.from_numpy(a).to("meta") for a in (feats, kernel, bias)]
    wy, wx = (t.to("meta") for t in _weights(centers, scales, 16, 16, s))
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_part_predict(args[0], wy, wx, args[1], args[2], s)


def test_partial_head_fused_entry_matches_grouped_conv(rng):
    """PartialIUVHead.fused (crop + conv in one call) equals the standard
    entry on the concatenated crops, from the same weights."""
    feats, centers, scales, _, _, s = _inputs(rng)
    head = PartialIUVHead(feats.shape[-1])
    torch.nn.init.normal_(head.weight, std=0.1, generator=torch.Generator().manual_seed(0))
    torch.nn.init.normal_(head.bias, std=0.1, generator=torch.Generator().manual_seed(1))
    h, w = feats.shape[1:3]
    wy, wx = _weights(centers, scales, h, w, s)
    f = torch.from_numpy(feats)
    crops = separable_crop(f, torch.from_numpy(centers), torch.from_numpy(scales), s)
    b, k = crops.shape[:2]
    with torch.no_grad():
        exp = head(crops.permute(0, 1, 4, 2, 3).reshape(b, -1, s, s))
        got = head.fused(f, wy, wx)
    assert got.shape == exp.shape == (b, k, s, s, 3, 7)
    np.testing.assert_allclose(got.numpy(), exp.numpy(), atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2), ("float64", 0.0)])
def test_cuda_kernel_matches_plain(rng, cuda_device, dtype, tol):
    """The kernel against its plain version on the card, fed both by bilinear
    `_axis_weights` matrices and by random dense ones. bf16 is held relative
    to max|ref|. f64 has no kernel: on the card it runs the plain version,
    bit for bit, and launches nothing."""
    launched = 0 if dtype == "float64" else 1
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    dt = getattr(torch, dtype)
    feats, centers, scales, kernel, bias, s = _inputs(rng, b=2, h=56, w=56, c=48, s=56)
    b, h, w, _ = feats.shape
    wy, wx = _weights(centers, scales, h, w, s, dt)
    dense = (torch.from_numpy(rng.rand(b, 24, s, h) / h), torch.from_numpy(rng.rand(b, 24, s, w) / w))
    f, kern, bi = (torch.from_numpy(a).to(cuda_device, dt) for a in (feats, kernel, bias))
    for wy_, wx_ in ((wy, wx), dense):
        wy_, wx_ = wy_.to(cuda_device, dt), wx_.to(cuda_device, dt)
        before = fused_part_predict.launches
        got = fused_part_predict(f, wy_, wx_, kern, bi, s)
        torch.cuda.synchronize()
        assert fused_part_predict.launches == before + launched
        ref = part_crop_head_plain(f, wy_, wx_, kern, bi, s)
        assert launched or torch.equal(got, ref)
        err = (got.double() - ref.double()).abs().max().item()
        scale = ref.double().abs().max().item() if dtype == "bfloat16" else 1.0
        assert err <= tol * scale, (dtype, err, scale)


@pytest.mark.parametrize("requires", ["feats", "kernel"])
def test_backward_refuses_on_cpu(rng, requires):
    """K1 has no backward: on the CPU, as on the card, the result carries a
    grad_fn whose backward raises, instead of a result that silently lost
    its gradient. Without grad (serving) it runs as before."""
    feats, centers, scales, kernel, bias, s = _inputs(rng)
    h, w = feats.shape[1:3]
    wy, wx = _weights(centers, scales, h, w, s)
    f, k = torch.from_numpy(feats), torch.from_numpy(kernel)
    (f if requires == "feats" else k).requires_grad_(True)
    out = fused_part_predict(f, wy, wx, k, torch.from_numpy(bias), s)
    assert out.requires_grad
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 32"):
        out.sum().backward()
    with torch.no_grad():
        assert not fused_part_predict(f, wy, wx, k, torch.from_numpy(bias), s).requires_grad


@pytest.mark.parametrize("c,o", [(48, 21), (8, 21), (20, 5)])
def test_packed_weights_im2col_gemm_matches_plain_f64(rng, c, o):
    """The bf16 kernel's GEMM, written out: the crop zero-padded in x, y and
    C, its nine taps side by side in (dy, dx, c) order, times the packed B
    operand, plus the bias, is the plain version's grouped conv. C not a
    multiple of 16 and O not a multiple of 8 are padded with zeros."""
    feats, centers, scales, kernel, bias, s = _inputs(rng, h=12, w=12, c=c, o=o, s=9)
    h, w = feats.shape[1:3]
    wy, wx = _weights(centers, scales, h, w, s, torch.float64)
    f, kern, bi = (torch.from_numpy(a).double() for a in (feats, kernel, bias))
    k = wy.shape[1]
    packed = pack_head_weights(kern, k)
    npad, cpad = packed.shape[1], packed.shape[2] // 9
    assert packed.shape == (k, npad, 9 * cpad) and packed.is_contiguous()
    assert cpad % 16 == 0 and c <= cpad < c + 16 and npad % 24 == 0 and o <= npad < o + 24
    assert not packed[:, o:].any() and not packed.reshape(k, npad, 9, cpad)[..., c:].any()

    crop = torch.einsum("bkpw,bkowc->bkopc", wx, torch.einsum("bkoh,bhwc->bkowc", wy, f))
    padded = F.pad(crop, (0, cpad - c, 1, 1, 1, 1))               # C, then x, then y
    cols = torch.cat([padded[:, :, dy:dy + s, dx:dx + s] for dy in range(3) for dx in range(3)], -1)
    gemm = torch.einsum("bkyxq,knq->bkyxn", cols, packed)
    assert not gemm[..., o:].any()
    got = gemm[..., :o] + bi.reshape(k, o)[None, :, None, None, :]
    ref = part_crop_head_plain(f, wy, wx, kern, bi, s)
    assert got.shape == ref.shape == (2, k, s, s, o)
    assert (got - ref).abs().max().item() <= 1e-12


@pytest.mark.parametrize("dense", [False, True], ids=["bilinear", "dense"])
def test_plain_bf16_matches_jax_kernel_interpret(rng, dense):
    """The rounding points the bf16 kernel keeps: the port's plain version in
    bf16 against the JAX kernel in bf16 (interpret mode), on the same bf16
    inputs, within 2e-2 of max|ref|."""
    feats, centers, scales, kernel, bias, s = _inputs(rng)
    b, h, w, _ = feats.shape
    if dense:
        wy, wx = torch.from_numpy(rng.rand(b, 24, s, h) / h), torch.from_numpy(rng.rand(b, 24, s, w) / w)
    else:
        wy, wx = _weights(centers, scales, h, w, s)
    args = [t.to(torch.bfloat16) for t in (torch.from_numpy(feats), wy, wx, torch.from_numpy(kernel),
                                           torch.from_numpy(bias))]
    got = part_crop_head_plain(*args, s)
    assert got.dtype == torch.bfloat16
    exp = jax_fused(*(jnp.asarray(a.float().numpy()).astype(jnp.bfloat16) for a in args), s, interpret=True)
    assert exp.dtype == jnp.bfloat16
    exp = np.asarray(exp.astype(jnp.float32)).astype(np.float64)
    err = np.abs(got.double().numpy() - exp).max()
    assert got.shape == exp.shape == (b, 24, s, s, 21)
    assert err <= 2e-2 * np.abs(exp).max(), (err, np.abs(exp).max())


BF16_PLANS = [(48, (8, 16)), (64, (8, 32)), (72, (8, 32)), (200, (8, 32)), (256, (8, 32)), (264, (8, 32))]


@pytest.mark.parametrize("c,plan", BF16_PLANS)
def test_bf16_plan_choices(c, plan):
    """The bf16 kernel's channel chunk at C channels: the chunk of 16 or 32
    whose count of chunks costs least (a chunk of 32 costs CHUNK32_COST
    chunks of 16). The tile rows need the library's shared-memory layout:
    `test_cuda_bf16_plan_rows`."""
    chunk = bf16_chunk(c)
    assert chunk == plan[1]
    cost = {16: -(-c // 16), 32: -(-c // 32) * CHUNK32_COST}
    assert cost[chunk] == min(cost.values())


@pytest.mark.cuda
@pytest.mark.parametrize("c,plan", BF16_PLANS)
def test_cuda_bf16_plan_rows(cuda_device, c, plan):
    """The bf16 kernel's tile rows at the serving shape (56x56xC features,
    S=56, O=21): the tallest tile (at most 8 rows) whose pixels the warps'
    MMA tiles hold and whose shared memory, by the library's own layout,
    lets two blocks share an SM; S=57 (the odd shapes) keeps the choice."""
    assert bf16_plan(56, 56, c, 56, 21) == plan == bf16_plan(57, 57, c, 57, 5)
    rows, chunk = plan
    smem_bytes = load_library()[0].part_crop_head_bf16_bytes
    assert rows * 56 <= BF16_MAX_PIXELS and smem_bytes(rows, 56, 56, 21, chunk) <= SMEM_TWO_BLOCKS
    assert rows == 8 or (rows + 1) * 56 > BF16_MAX_PIXELS or smem_bytes(rows + 1, 56, 56, 21, chunk) > SMEM_TWO_BLOCKS


@pytest.mark.parametrize("dense", [False, True], ids=["bilinear", "dense"])
def test_x_interpolation_as_banded_mma_matches_plain_f64(rng, dense):
    """The bf16 kernel's x-interpolation, written out: for each group of 16
    crop columns whose taps span at most 32 feature columns, the group's A
    tile A[x][j] = wx[x][wlo + j] (wlo its first tap column) times the 32
    y-interpolated columns from wlo (zero past the row) is wx @ tmp for
    those columns (f64, 1e-12); the other groups (dense matrices) are
    summed tap by tap, as the kernel's CUDA-core path does."""
    b, h, w, s, c = 1, 56, 56, 56, 16
    feats = torch.from_numpy(rng.rand(b, h, w, c))
    if dense:
        wy, wx = torch.from_numpy(rng.rand(b, 24, s, h) / h), torch.from_numpy(rng.rand(b, 24, s, w) / w)
    else:
        centers = torch.from_numpy(rng.uniform(-0.6, 0.6, (b, 24, 2)))
        scales = torch.from_numpy(rng.uniform(0.2, 0.9, (b, 24)))
        wy = _axis_weights(centers[..., 1], scales, h, s, torch.float64)
        wx = _axis_weights(centers[..., 0], scales, w, s, torch.float64)
    tmp = torch.einsum("bkoh,bhwc->bkowc", wy, feats)                 # (B, K, S, W, C)
    ref = torch.einsum("bkpw,bkowc->bkopc", wx, tmp)
    got, mma_groups = torch.empty_like(ref), 0
    for k in range(24):
        for x0 in range(0, s, 16):
            band = wx[0, k, x0:x0 + 16]
            nz = band.nonzero()[:, 1]
            lo, hi = (int(nz.min()), int(nz.max())) if len(nz) else (0, -1)
            if 0 <= hi - lo < 32:
                a = torch.zeros(16, 32, dtype=torch.float64)
                a[:len(band), :min(32, w - lo)] = band[:, lo:lo + 32]
                window = F.pad(tmp[0, k, :, lo:lo + 32], (0, 0, 0, 32 - min(32, w - lo)))
                got[0, k, :, x0:x0 + 16] = torch.einsum("xj,ojc->oxc", a, window)[:, :len(band)]
                mma_groups += 1
            else:
                got[0, k, :, x0:x0 + 16] = torch.einsum("xw,owc->oxc", band, tmp[0, k])
    assert (got - ref).abs().max().item() <= 1e-12
    assert mma_groups == (0 if dense else 24 * 4)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [8, 20, 72, 201])
def test_cuda_bf16_kernel_odd_shapes(rng, cuda_device, c):
    """The tensor-core kernel where nothing is a multiple of its tiles: S=57
    (a ragged pixel tile, unaligned output spans), C=8, 20, 72 and 201
    (partial last chunks; 20 and 201 are not whole 16-byte chunks), O=5,
    B=1; bilinear and dense weights, against the plain version at 2e-2 of
    max|ref|."""
    feats, centers, scales, kernel, bias, s = _inputs(rng, b=1, h=57, w=57, c=c, o=5, s=57)
    b, h, w, _ = feats.shape
    dt = torch.bfloat16
    wy, wx = _weights(centers, scales, h, w, s, dt)
    dense = (torch.from_numpy(rng.rand(b, 24, s, h) / h), torch.from_numpy(rng.rand(b, 24, s, w) / w))
    f, kern, bi = (torch.from_numpy(a).to(cuda_device, dt) for a in (feats, kernel, bias))
    for wy_, wx_ in ((wy, wx), dense):
        wy_, wx_ = wy_.to(cuda_device, dt), wx_.to(cuda_device, dt)
        before = fused_part_predict.launches
        got = fused_part_predict(f, wy_, wx_, kern, bi, s)
        torch.cuda.synchronize()
        assert fused_part_predict.launches == before + 1
        ref = part_crop_head_plain(f, wy_, wx_, kern, bi, s)
        err = (got.double() - ref.double()).abs().max().item()
        assert got.shape == (b, 24, s, s, 5)
        assert err <= 2e-2 * ref.double().abs().max().item(), (c, err)
