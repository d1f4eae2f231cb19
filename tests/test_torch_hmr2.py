"""HMR 2.0 in the port (`models/hmr2.py`, `nn/vit.py`,
`nn/pose_transformer.py`, `nn/attention.py`) against the benchmark's plain
reference (`port_bench/reference/models/hmr2.py`, written from the
published equations; explicit matmul + softmax attention), on the same
seeded state dict, at a tiny size: 2 blocks of width 64 with 4 heads, 2
decoder layers of width 32, a 64x64 input cut to 64x48 (12 tokens).

Also: `attend`'s plain route against PyTorch's SDPA on the CPU; the
published configuration built on the `meta` device; `Predictor` serving the
tiny model in fp32 and bf16; its spans and attention counts under a
recording profiler; HMR 2.0's 6D reading. One thread, no JAX; the card's
fused route is `-m cuda` (this file imports no JAX, so it runs there with
`python -m pytest --noconftest -m cuda tests/test_torch_hmr2.py`).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from danet_densepose2smpl_tpu_torch.models.hmr2 import HMR2, HMR2Config
from danet_densepose2smpl_tpu_torch.nn.attention import attend, fused_route
from danet_densepose2smpl_tpu_torch.ops.rotations import rot6d_rows_to_rotmat, rot6d_to_rotmat
from danet_densepose2smpl_tpu_torch.serve import Predictor
from danet_densepose2smpl_tpu_torch.smpl.loader import synthetic_smpl_model, to_torch
from danet_densepose2smpl_tpu_torch.smpl.model import smpl_forward
from danet_densepose2smpl_tpu_torch.utils import profiling
from port_bench.families import hmr2 as family
from port_bench.reference.models.hmr2 import HMR2Config as ReferenceConfig
from port_bench.reference.models.hmr2 import rot6d_rows_to_rotmat as reference_rot6d_rows
from port_bench.reference.smpl.loader import to_torch as reference_to_torch
from port_bench.reference.smpl.model import smpl_forward as reference_smpl_forward

TINY = dict(image_size=64, embed_dim=64, depth=2, num_heads=4, mlp_dim=256, dec_dim=32, dec_depth=2,
            dec_heads=2, dec_dim_head=16, dec_mlp_dim=32)
SEED = 2 ** 31 + 21
CPU = torch.device("cpu")
SMPL = synthetic_smpl_model(500)
# fp32 port against the fp32 reference: the same products in another order
# (the port adds the two position rows before the tokens and splits heads by
# views) round apart by an fp32 ulp or two of outputs of magnitude ~1;
# measured 6.0e-8 on para and 1.2e-7 on the vertices, so 2e-6 holds 16x
# room, a hundredth of how far two images' answers lie apart (0.015 at
# this size, the readouts starting near zero).
FP32_BAR = 2e-6
# bf16 serving against the fp32 reference on the same bf16-rounded inputs:
# weights and activations rounded to 8 bits through 2 blocks and 2 decoder
# layers; measured 3.8e-4 on para, so 4e-3 (10x), under the 0.015 between
# two images.
BF16_BAR = 4e-3


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.RECORDER.clear()
    yield
    profiling.RECORDER.clear()
    torch.set_num_threads(threads)


def tiny_pair():
    """(port, reference) at the tiny size, the port loaded with the
    reference's seeded state dict."""
    reference = family.reference_model(ReferenceConfig(**TINY), SEED, CPU).eval()
    port = HMR2(HMR2Config(**TINY)).eval()
    port.load_state_dict(reference.state_dict())
    return port, reference


def images(b=3):
    return torch.from_numpy(np.random.RandomState(5).randn(b, 64, 64, 3).astype(np.float32))


@pytest.mark.parametrize("dtype,bar", [(torch.float64, 1e-10), (torch.float32, FP32_BAR)])
def test_port_matches_the_reference(dtype, bar):
    port, reference = tiny_pair()
    port, reference = port.to(dtype), reference.to(dtype)
    x = images().to(dtype)
    with torch.no_grad():
        got, want = port(x), reference(x)
        body = smpl_forward(to_torch(SMPL, CPU, dtype), got["pred_shape"], got["pred_rotmat"])
        ref_body = reference_smpl_forward(reference_to_torch(SMPL, CPU, dtype), want["pred_shape"],
                                          want["pred_rotmat"])
    assert got["para"].shape == (3, 229) and got["pred_rotmat"].shape == (3, 24, 3, 3)
    for k in ("para", "pred_cam", "pred_shape", "pred_rotmat"):
        assert got[k].dtype == dtype
        assert (got[k] - want[k]).abs().max().item() <= bar, k
    assert (body.vertices - ref_body.vertices).abs().max().item() <= bar
    assert (body.joints - ref_body.joints).abs().max().item() <= bar
    # the answers vary with the image (the bar is not met by a constant)
    assert (want["para"][0] - want["para"][1]).abs().max().item() > 1e3 * bar


@pytest.mark.parametrize("lq,lk", [(12, 12), (1, 12), (1, 1)])
def test_attend_plain_route_matches_sdpa(lq, lk):
    """The plain route (here, the CPU's) against PyTorch's SDPA, which the
    fused route calls on the card: f64 to 1e-12; bf16 inputs computed in
    fp32 and rounded once, within a bf16 ulp of SDPA in fp32."""
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 4, n, 16, generator=g, dtype=torch.float64) for n in (lq, lk, lk))
    assert not fused_route(q, k, v)
    assert (attend(q, k, v) - F.scaled_dot_product_attention(q, k, v)).abs().max().item() < 1e-12
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    got = attend(qb, kb, vb)
    want = F.scaled_dot_product_attention(qb.float(), kb.float(), vb.float())
    assert got.dtype == torch.bfloat16
    assert ((got.float() - want).abs() <= 2 ** -8 * want.abs() + 1e-6).all()


@pytest.mark.cuda
def test_attend_fused_route_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fused route runs on the card only")
    g = torch.Generator(device="cuda").manual_seed(3)
    for heads, lq, lk, d in ((16, 192, 192, 80), (8, 1, 192, 64), (8, 1, 1, 64)):
        q, k, v = (torch.randn(4, heads, n, d, generator=g, device="cuda") for n in (lq, lk, lk))
        qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
        assert fused_route(qb, kb, vb)
        want = F.scaled_dot_product_attention(qb.float(), kb.float(), vb.float())
        assert ((attend(qb, kb, vb).float() - want).abs() <= 2 ** -7 * want.abs() + 2e-3).all()


def test_published_config_on_meta():
    """The published sizes: 670,459,037 parameters (the trunk 630,912,000:
    patch embedding 984,320, positions 193 x 1280, 32 blocks of
    19,677,440, the last norm 2,560; the head 39,547,037: 6 layers of
    6,563,840 and the token embedding, position and readouts), 192 tokens
    from the 256x192 cut, 16 heads of 80, a decoder of 8 heads of 64 with
    a 1280-wide context; the state dict's names are 4D-Humans'."""
    with torch.device("meta"):
        model = HMR2()
        tokens = model.backbone.patch_embed(torch.empty(2, 3, 256, 192))
    cfg = model.cfg
    assert cfg.trunk_hw == (256, 192) and model.backbone.patch_embed.num_patches == 192
    assert tokens.shape == (2, 192, 1280)
    assert model.backbone.pos_embed.shape == (1, 193, 1280) and len(model.backbone.blocks) == 32
    assert sum(p.numel() for p in model.backbone.parameters()) == 630_912_000
    assert sum(p.numel() for p in model.parameters()) == 670_459_037
    block = model.backbone.blocks[0]
    assert block.attn.heads == 16 and block.attn.qkv.weight.shape == (3840, 1280)
    assert block.mlp.fc1.weight.shape == (5120, 1280)
    layer = model.smpl_head.transformer.transformer.layers[0]
    assert len(model.smpl_head.transformer.transformer.layers) == 6
    assert layer[0].fn.heads == 8 and layer[0].fn.to_qkv.weight.shape == (1536, 1024)
    assert layer[1].fn.to_kv.weight.shape == (1024, 1280) and layer[1].fn.to_q.weight.shape == (512, 1024)
    assert layer[2].fn.net[0].weight.shape == (1024, 1024)
    keys = set(model.state_dict())
    assert {"backbone.patch_embed.proj.weight", "backbone.pos_embed", "backbone.blocks.31.attn.qkv.bias",
            "backbone.blocks.0.mlp.fc2.weight", "backbone.last_norm.weight",
            "smpl_head.transformer.to_token_embedding.weight", "smpl_head.transformer.pos_embedding",
            "smpl_head.transformer.transformer.layers.5.1.fn.to_kv.weight",
            "smpl_head.transformer.transformer.layers.0.0.fn.to_out.0.weight",
            "smpl_head.transformer.transformer.layers.0.2.fn.net.3.bias",
            "smpl_head.transformer.transformer.layers.0.2.norm.weight", "smpl_head.decpose.weight",
            "smpl_head.init_body_pose", "smpl_head.init_betas", "smpl_head.init_cam"} <= keys


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_predictor_serves_tiny_hmr2(dtype):
    port, reference = tiny_pair()
    predictor = Predictor("cpu", dtype, model=port, smpl=SMPL)
    head = predictor.model.smpl_head
    assert all(getattr(head, n).dtype == torch.float32 for n in head.CONSTANTS)
    assert predictor.model.backbone.pos_embed.dtype == dtype
    x = images()
    out = predictor.predict(x.numpy())
    with torch.no_grad():
        want = reference(x.to(dtype).float())
    assert set(out) == {"para", "pred_cam", "pred_shape", "pred_rotmat", "vertices", "joints"}
    assert all(v.dtype == torch.float32 and torch.isfinite(v).all() for v in out.values())
    assert out["vertices"].shape == (3, 500, 3) and out["joints"].shape == (3, 49, 3)
    bar = FP32_BAR if dtype == torch.float32 else BF16_BAR
    assert (out["para"] - want["para"]).abs().max().item() <= bar


def test_spans_and_attention_counts():
    """Under a recording profiler a request records `hmr2.backbone` and
    `hmr2.head` under `serve.model`, one `vit.attention` per block under the
    trunk, and one 'attn.plain' count per attention call (a block's, and a
    decoder layer's two) on the CPU."""
    port, _ = tiny_pair()
    predictor = Predictor("cpu", torch.float32, model=port, smpl=SMPL)
    with profile(activities=[ProfilerActivity.CPU]):
        predictor.predict(images(2).numpy())
    (item,) = profiling.recorded_items()
    spans = [(s["name"], s["parent"]) for s in item["spans"]]
    assert spans == ([("serve.request", None), ("serve.model", "serve.request"),
                      ("hmr2.backbone", "serve.model")] + [("vit.attention", "hmr2.backbone")] * 2
                     + [("hmr2.head", "serve.model"), ("serve.smpl", "serve.request")])
    assert item["counts"] == {"attn.plain": 2 + 2 * 2}


def test_rot6d_rows_reading():
    """HMR 2.0's reading: (1, 0, 0, 0, 1, 0) is the identity; it is the
    port's column reading of the values interleaved; the port's identity
    (1, 0, 0, 1, 0, 0) read this way is degenerate (a1 parallel to a2); and
    it agrees with the reference's copy of 4D-Humans' code."""
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0], dtype=torch.float64)
    assert torch.equal(rot6d_rows_to_rotmat(ident), torch.eye(3, dtype=torch.float64))
    x = torch.from_numpy(np.random.RandomState(0).randn(5, 24, 6))
    got = rot6d_rows_to_rotmat(x)
    interleaved = torch.stack([x[..., :3], x[..., 3:]], dim=-1).flatten(-2)
    assert (got - rot6d_to_rotmat(interleaved)).abs().max().item() < 1e-14
    assert (got - reference_rot6d_rows(x)).abs().max().item() < 1e-14
    eye = got.transpose(-1, -2) @ got
    assert (eye - torch.eye(3, dtype=torch.float64)).abs().max().item() < 1e-12
    port_identity = torch.tensor([1.0, 0.0, 0.0, 1.0, 0.0, 0.0], dtype=torch.float64)
    assert torch.linalg.cross(port_identity[:3], port_identity[3:], dim=-1).abs().max().item() == 0
