"""K1's fp32 kernel (`part_crop_head_f32_kernel<CH>`, the conv in 3xTF32 on
the tensor cores): its arithmetic emulated on the CPU against the plain
version, its split weight operand, its plan, and (on a card only) the kernel
against the plain version."""

import pytest
import torch
import torch.nn.functional as F

from danet_densepose2smpl_tpu_torch.kernels.part_crop_head import (
    F32_CHUNK_COST,
    F32_CHUNKS,
    F32_MAX_PIXELS,
    SMEM_TWO_BLOCKS,
    TF32_DEPTH,
    f32_chunk,
    f32_plan,
    fused_part_predict,
    load_library,
    pack_head_weights,
    part_crop_head_plain,
    tf32_round,
    tf32_split,
)
from danet_densepose2smpl_tpu_torch.ops.imwarp import _axis_weights

torch.set_num_threads(1)
K = 24   # parts
BAR = 1e-4   # the fp32 kernel against the plain version (TF32 off)


def _inputs(rng, b, hw, c, o, s, dense, dtype=torch.float32):
    """feats in [0, 1), N(0, 0.1) weights and bias, the scale of the serving
    path's K1 tests; bilinear `_axis_weights` or dense interpolation
    matrices."""
    feats = torch.from_numpy(rng.rand(b, hw, hw, c))
    if dense:
        wy = torch.from_numpy(rng.rand(b, K, s, hw) / hw)
        wx = torch.from_numpy(rng.rand(b, K, s, hw) / hw)
    else:
        centers = torch.from_numpy(rng.uniform(-0.6, 0.6, (b, K, 2)))
        scales = torch.from_numpy(rng.uniform(0.2, 0.9, (b, K)))
        wy = _axis_weights(centers[..., 1], scales, hw, s, torch.float64)
        wx = _axis_weights(centers[..., 0], scales, hw, s, torch.float64)
    kernel = torch.from_numpy(rng.randn(3, 3, c, K * o) * 0.1)
    bias = torch.from_numpy(rng.randn(K * o) * 0.1)
    return [t.to(dtype).contiguous() for t in (feats, wy, wx, kernel, bias)]


def _crop(feats, wy, wx):
    """The crop as the kernel builds it: y- then x-interpolation, in the
    inputs' dtype."""
    tmp = torch.einsum("bkoh,bhwc->bkowc", wy, feats)
    return torch.einsum("bkpw,bkowc->bkopc", wx, tmp)            # (B, K, S, S, C)


def _im2col(crop, c0, width):
    """Channels c0..c0 + width of the crop (zero past C), zero-padded in x
    and y, its nine taps side by side in (dy, dx, c) order: (B, K, S, S, 9 *
    width), the GEMM depth of one chunk."""
    s, c = crop.shape[2], crop.shape[-1]
    part = F.pad(crop[..., c0:c0 + width], (0, max(0, c0 + width - c), 1, 1, 1, 1))
    return torch.cat([part[:, :, dy:dy + s, dx:dx + s] for dy in range(3) for dx in range(3)], -1)


@pytest.mark.parametrize("dense", [False, True], ids=["bilinear", "dense"])
@pytest.mark.parametrize("c,o", [(48, 21), (64, 21), (72, 21), (256, 21), (264, 21), (8, 5)])
def test_3xtf32_gemm_emulation_holds_the_bar(rng, c, o, dense):
    """The fp32 kernel's conv, emulated: per channel chunk (`f32_chunk`), the
    im2col GEMM of the fp32 crop split into TF32 big + small (round to
    nearest, ties away, as `cvt.rna.tf32.f32`) against the split weight
    planes of `pack_head_weights(split=True)`: A_small B_big + A_big B_small
    + A_big B_big in fp32, plus the bias. It holds the 1e-4 bar against the
    plain version in fp32; single-pass TF32 (A_big B_big) is printed for
    the record."""
    b, hw, s = (1, 12, 9) if c > 64 else (2, 12, 9)
    feats, wy, wx, kernel, bias = _inputs(rng, b, hw, c, o, s, dense)
    ref = part_crop_head_plain(feats, wy, wx, kernel, bias, s).double()
    crop = _crop(feats, wy, wx)
    chunk = f32_chunk(c)
    planes = pack_head_weights(kernel, K, chunk, split=True)     # (2, K, chunks, Npad, 9 * chunk)
    emulated = torch.zeros(b, K, s, s, planes.shape[3])
    single = torch.zeros_like(emulated)
    for n in range(planes.shape[2]):
        a_big, a_small = tf32_split(_im2col(crop, n * chunk, chunk))
        b_big, b_small = planes[0, :, n], planes[1, :, n]
        gemm = lambda a, w: torch.einsum("bkyxq,knq->bkyxn", a, w)   # noqa: E731
        emulated += gemm(a_small, b_big) + gemm(a_big, b_small) + gemm(a_big, b_big)
        single += gemm(a_big, b_big)
    bias_ = bias.reshape(K, o)[None, :, None, None, :]
    got = (emulated[..., :o] + bias_).double()
    err = (got - ref).abs().max().item()
    err_single = ((single[..., :o] + bias_).double() - ref).abs().max().item()
    print(f"C={c} O={o} {'dense' if dense else 'bilinear'}: 3xTF32 max abs err {err!r} (bar {BAR}, margin "
          f"{BAR / max(err, 1e-30)!r}x); single-pass TF32 {err_single!r}")
    assert not emulated[..., o:].any()
    assert err <= BAR, (err, err_single)


@pytest.mark.parametrize("c,o", [(48, 21), (8, 21), (20, 5), (72, 21), (256, 21)])
def test_split_packed_weights_im2col_gemm_matches_plain_f64(rng, c, o):
    """The fp32 kernel's B operand, written out: big + small of
    `pack_head_weights(split=True)`, chunk by chunk through an im2col GEMM
    in f64, plus the bias, is the plain version's grouped conv to 1e-12, on
    weights of at most 21 significant bits (which big + small holds
    exactly); on any fp32 weights big + small is within 2^-22 of each. C
    and O are padded with zeros."""
    feats, wy, wx, _, bias = _inputs(rng, 2, 12, c, o, 9, dense=False, dtype=torch.float64)
    kernel = torch.from_numpy(rng.randint(-2 ** 20, 2 ** 20, (3, 3, c, K * o)) / 2.0 ** 23)
    chunk = f32_chunk(c)
    planes = pack_head_weights(kernel.float(), K, chunk, split=True)
    n_chunks, npad = -(-c // chunk), -(-o // 24) * 24
    assert planes.shape == (2, K, n_chunks, npad, 9 * chunk) and planes.dtype == torch.float32
    assert planes.is_contiguous() and not planes[:, :, :, o:].any()
    assert not (planes.view(torch.int32) & 0x1FFF).any()             # both planes are TF32 values
    packed = planes.double().sum(0)
    crop = _crop(feats, wy, wx)
    gemm = sum(torch.einsum("bkyxq,knq->bkyxn", _im2col(crop, n * chunk, chunk), packed[:, n])
               for n in range(n_chunks))
    assert not gemm[..., o:].any()
    got = gemm[..., :o] + bias.reshape(K, o)[None, :, None, None, :]
    ref = part_crop_head_plain(feats, wy, wx, kernel, bias, 9)
    assert (got - ref).abs().max().item() <= 1e-12
    w = torch.from_numpy(rng.randn(4096)).float()
    big, small = tf32_split(w)
    assert ((big.double() + small.double() - w.double()).abs() <= 2.0 ** -22 * w.double().abs()).all()


@pytest.mark.parametrize("chunk", [None, 12])
def test_split_packing_needs_whole_k_steps(chunk):
    """`pack_head_weights(split=True)` packs chunk by chunk in whole k-steps
    of the m16n8k8 MMA: no chunk, or one that is not a multiple of 8,
    raises."""
    with pytest.raises(ValueError, match="chunk"):
        pack_head_weights(torch.zeros(3, 3, 16, K * 21), K, chunk, split=True)


def test_tf32_round_is_rna():
    """`tf32_round` keeps 10 mantissa bits, rounds to nearest with ties away
    from zero (as `cvt.rna.tf32.f32`), and keeps zeros and infinities."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -20, 1 + 1.5 * ulp, 0.0, -0.0,
                      float("inf"), -float("inf"), 3.0e38], dtype=torch.float32)
    got = tf32_round(x)
    want = [1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 0.0, -0.0, float("inf"), -float("inf")]
    assert got[:8].tolist() == want
    assert torch.signbit(got[5]) and (got[8] - x[8]).abs() <= 2.0 ** -11 * x[8]
    assert not (got.view(torch.int32) & 0x1FFF).any()


F32_CHUNK_CASES = [(8, 8), (20, 8), (48, 16), (64, 16), (72, 16), (200, 16), (201, 16), (256, 16), (264, 16)]


@pytest.mark.parametrize("c,chunk", F32_CHUNK_CASES)
def test_f32_chunk_rule(c, chunk):
    """The fp32 kernel's channel chunk at C channels: the one of 8, 16
    (each a multiple of the MMA depth) whose count of chunks costs least,
    a chunk costing F32_CHUNK_COST (measured) chunks of 16. The tile rows
    need the library: `test_cuda_f32_plan_rows`."""
    assert f32_chunk(c) == chunk
    assert all(ch % TF32_DEPTH == 0 for ch in F32_CHUNKS)
    cost = {ch: -(-c // ch) * F32_CHUNK_COST[ch] for ch in F32_CHUNKS}
    assert cost[chunk] == min(cost.values())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("c,chunk", F32_CHUNK_CASES)
def test_cuda_f32_plan_rows(cuda_device, c, chunk):
    """The fp32 kernel's tile rows at the serving shape (56x56xC, S=56,
    O=21): the tallest tile (at most 8 rows) whose pixels the warps' MMA
    tiles hold and whose shared memory, by the library's own layout, lets
    two blocks share an SM; S=57 keeps the chunk."""
    rows, got = f32_plan(56, 56, c, 56, 21)
    assert got == chunk == f32_plan(57, 57, c, 57, 5)[1]
    smem_bytes = load_library()[0].part_crop_head_f32_bytes
    assert rows * 56 <= F32_MAX_PIXELS and smem_bytes(rows, 56, 56, 21, chunk) <= SMEM_TWO_BLOCKS
    assert rows == 8 or smem_bytes(rows + 1, 56, 56, 21, chunk) > SMEM_TWO_BLOCKS


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,c,o", [(1, 56, c, 21) for c in (8, 20, 48, 64, 72, 200, 201, 256, 264)]
                         + [(1, 57, c, 5) for c in (8, 20, 201)] + [(16, 56, 256, 21)])
def test_cuda_f32_kernel_matches_plain(rng, cuda_device, b, s, c, o):
    """The fp32 kernel against its plain version on the card (TF32 off), at
    the widths of every config and where nothing is a multiple of its tiles
    (S=57, O=5, partial last chunks), bilinear and dense weights: 1e-4, one
    launch each."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    for dense in (False, True):
        args = [t.to(cuda_device) for t in _inputs(rng, b, s, c, o, s, dense)]
        before = fused_part_predict.launches
        got = fused_part_predict(*args, s)
        torch.cuda.synchronize()
        assert fused_part_predict.launches == before + 1
        ref = part_crop_head_plain(*args, s)
        assert got.shape == (b, K, s, s, o) and got.dtype == torch.float32
        err = (got.double() - ref.double()).abs().max().item()
        assert err <= BAR, (c, dense, err)


def test_cpu_tensor_takes_the_plain_version_in_fp32(rng):
    """On a CPU tensor the wrapper runs the plain version, in fp32 as in
    every dtype, and launches nothing."""
    args = _inputs(rng, 1, 12, 20, 5, 9, dense=False)
    before = fused_part_predict.launches
    got = fused_part_predict(*args, 9)
    assert fused_part_predict.launches == before
    assert torch.equal(got, part_crop_head_plain(*args, 9))
