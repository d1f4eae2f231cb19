"""The one-pass eval BatchNorm (+ residual, + ReLU): `nn.layers.bn_act` and
the kernel `kernels/bn_act.py`.

On the CPU every call takes the plain route, which must be today's
composition bit for bit (`torch.equal`): the module's BatchNorm forward,
then the add, then F.relu, for `BasicBlock`, `Bottleneck`, `BNReLU`, a
downsample and an `HRModule`, in eval and in train mode; a narrow HRNet's
upsampled fuse terms (`up` 2, 4, 8) are the parent's conv, BatchNorm,
nn.Upsample, add and ReLU. With the card check stood in (`layers.on_card`)
and the launch recorded, every call in eval with autograd off takes the
kernel route where x and the BatchNorm share a dtype (bf16 or fp32) or
fp32 x meets bf16 statistics, x and the residual in the layout
`kernels.bn_act.prepare` makes (with `up` > 1: channels-last, C a
multiple of the vector); train mode, grad on, the CPU, fp64, fp16 and
bf16 x into fp32 statistics take the plain route; each call on the card
is counted into the span recorder's open item.

On the card (`cuda` marker; this file imports no JAX, so it runs there
with `python -m pytest --noconftest -m cuda tests/test_torch_bn_act.py`):
the kernel against its plain version on every (C, H, W) of the bn_act
calls of a W48 and a ResNet-50 request, in bf16 and fp32, with and
without residual and ReLU, channels-last and NCHW, plus odd C; at served
batches, whose grids take several strides; on fp32 x into bf16
statistics, other layouts and an unaligned view; the upsampling instance
on every served fuse shape (C, up) at the served batches, an odd batch
and an unaligned view; and each serve cell's `Predictor` outputs with the
kernel against the plain route, within the cell's limits
(`port_bench/limits`).
"""

import copy
import json
from pathlib import Path

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from danet_densepose2smpl_tpu_torch.kernels import bn_act as kernel
from danet_densepose2smpl_tpu_torch.nn import layers
from danet_densepose2smpl_tpu_torch.nn.hrnet import HRModule, PoseHighResolutionNet
from danet_densepose2smpl_tpu_torch.nn.layers import BasicBlock, BNReLU, Bottleneck, _downsample, bn, bn_act
from danet_densepose2smpl_tpu_torch.utils import profiling
from danet_densepose2smpl_tpu_torch.utils.profiling import annotate, recorded_items

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


def randomize_bn_(module: nn.Module, seed: int) -> nn.Module:
    """BatchNorm statistics and affines away from their defaults."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            c = m.num_features
            m.running_mean.copy_(torch.randn(c, generator=g) * 0.3)
            m.running_var.copy_(torch.rand(c, generator=g) + 0.5)
            m.weight.data.copy_(torch.rand(c, generator=g) + 0.5)
            m.bias.data.copy_(torch.randn(c, generator=g) * 0.3)
    return module


def old_basic(m, x):
    r = x if m.downsample is None else old_downsample(m.downsample, x)
    y = F.relu(m.bn1.plain_forward(m.conv1(x)))
    y = m.bn2.plain_forward(m.conv2(y))
    return F.relu(y + r)


def old_bottleneck(m, x):
    r = x if m.downsample is None else old_downsample(m.downsample, x)
    y = F.relu(m.bn1.plain_forward(m.conv1(x)))
    y = F.relu(m.bn2.plain_forward(m.conv2(y)))
    y = m.bn3.plain_forward(m.conv3(y))
    return F.relu(y + r)


def old_downsample(m, x):
    return m[1].plain_forward(m[0](x))


def old_bnrelu(m, x):
    return F.relu(m[1].plain_forward(m[0](x)))


def old_hrmodule(m, xs):
    """HRModule's forward before `bn_act`: each fuse term as a Sequential,
    summed in branch order, then ReLU."""
    ys = [branch(x) for branch, x in zip(m.branches, xs)]
    outs = []
    for row in m.fuse_layers:
        acc = None
        for f, y in zip(row, ys):
            y = f(y)
            acc = y if acc is None else acc + y
        outs.append(F.relu(acc))
    return outs


def case(name):
    """(module, old forward, input) of a small case."""
    x = torch.randn(2, 16, 9, 9, generator=torch.Generator().manual_seed(3))
    if name == "basic":
        return BasicBlock(16, 16), old_basic, x
    if name == "basic_downsample":
        return BasicBlock(16, 24, stride=2), old_basic, x
    if name == "bottleneck":
        return Bottleneck(16, 8, stride=2), old_bottleneck, x
    if name == "bnrelu":
        return BNReLU(16, 24, 3, 2), old_bnrelu, x
    if name == "downsample":
        return _downsample(16, 32, 2, 1), old_downsample, x
    xs = [torch.randn(2, c, s, s, generator=torch.Generator().manual_seed(c)) for c, s in ((8, 16), (16, 8), (24, 4))]
    return HRModule(3, (1, 1, 1), (8, 16, 24)), old_hrmodule, xs


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", ["basic", "basic_downsample", "bottleneck", "bnrelu", "downsample", "hrmodule"])
def test_plain_route_is_todays_composition(name, train):
    """Off the card `bn_act` is the module's BatchNorm, the add and F.relu
    in today's order: equal outputs, and in train mode equal running
    statistics and gradients."""
    module, old, x = case(name)
    randomize_bn_(module, seed=1).train(train)
    twin = copy.deepcopy(module)
    xs = x if isinstance(x, list) else [x]
    a = [t.clone().requires_grad_(train) for t in xs]
    b = [t.clone().requires_grad_(train) for t in xs]
    got = module(a if isinstance(x, list) else a[0])
    want = old(twin, b if isinstance(x, list) else b[0])
    got, want = (got, want) if isinstance(got, list) else ([got], [want])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    for (n1, t1), (_, t2) in zip(module.state_dict().items(), twin.state_dict().items()):
        assert torch.equal(t1, t2), n1
    if train:
        sum(g.square().sum() for g in got).backward()
        sum(w.square().sum() for w in want).backward()
        for (n1, p1), (_, p2) in zip(module.named_parameters(), twin.named_parameters()):
            assert torch.equal(p1.grad, p2.grad), n1
        assert all(torch.equal(t1.grad, t2.grad) for t1, t2 in zip(a, b))


def test_plain_kernel_version_matches_the_module_in_f64():
    """`bn_act_plain` (the kernel's arithmetic) is the eval BatchNorm, add and
    ReLU, to f64 rounding."""
    m = randomize_bn_(bn(12), seed=4).double().eval()
    x = torch.randn(3, 12, 5, 7, dtype=torch.float64)
    r = torch.randn(3, 12, 5, 7, dtype=torch.float64)
    stats = (m.running_mean, m.running_var, m.weight, m.bias)
    want = F.relu(m.plain_forward(x) + r)
    got = kernel.bn_act_plain(x, *stats, m.eps, r, True)
    assert torch.allclose(got, want, rtol=1e-13, atol=1e-13)
    assert torch.equal(kernel.bn_act_plain(x, *stats, m.eps), kernel.bn_act_plain(x, *stats, m.eps, None, False))


@pytest.mark.parametrize("shape", [(3, 12, 5, 7), (4, 12, 10)], ids=["4d", "3d"])
def test_plain_kernel_version_is_the_promoted_module_for_bf16_statistics(shape):
    """fp32 x into bf16 statistics (the GCN's BatchNorm1d in bf16 serving):
    `bn_act_plain` forms the scale in bf16, as `_eval_bn_promoted` does,
    bit for bit."""
    m = randomize_bn_(bn(12) if len(shape) == 4 else layers.BatchNorm1d(12), seed=5).bfloat16().eval()
    x = torch.randn(*shape, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        want = m.plain_forward(x)
    got = kernel.bn_act_plain(x, m.running_mean, m.running_var, m.weight, m.bias, m.eps)
    assert got.dtype == want.dtype == torch.float32 and torch.equal(got, want)


def test_layouts_the_kernel_takes():
    x = torch.randn(2, 12, 5, 7)
    cl = x.contiguous(memory_format=torch.channels_last)
    assert kernel.run_length(x) == 35 and kernel.run_length(cl) == 1
    assert kernel.run_length(torch.randn(4, 6, 1, 1).contiguous(memory_format=torch.channels_last)) == 1
    assert kernel.run_length(torch.randn(4, 24, 10)) == 10 and kernel.run_length(torch.randn(4, 6)) == 1
    assert kernel.run_length(x.transpose(2, 3)) is None
    assert kernel.prepare(cl, None) == (cl, None, 1)
    got, none, inner = kernel.prepare(x, x)
    assert got is x and none is x and inner == 35


@pytest.mark.parametrize("case", ["transposed", "residual_channels_last", "residual_nchw", "3d_transposed"])
def test_prepare_copies_other_layouts_to_the_kernels(case):
    """x in a layout the kernel has not becomes channels-last (4-d) or
    contiguous, the residual takes x's layout; values unchanged."""
    x = torch.randn(2, 12, 5, 7)
    r = torch.randn(2, 12, 5, 7)
    if case == "transposed":
        x, r, want = x.transpose(2, 3), r.transpose(2, 3), 1
    elif case == "residual_channels_last":
        r, want = r.contiguous(memory_format=torch.channels_last), 35
    elif case == "residual_nchw":
        x, want = x.contiguous(memory_format=torch.channels_last), 1
    else:
        x, r, want = torch.randn(4, 10, 6).transpose(0, 2), torch.randn(6, 10, 4), 4
    px, pr, inner = kernel.prepare(x, r)
    assert inner == want and kernel.run_length(px) == kernel.run_length(pr) == want
    assert torch.equal(px, x) and torch.equal(pr, r)


@pytest.mark.parametrize("case", ["dtype", "shape", "channels"])
def test_prepare_refuses_what_the_kernel_cannot_compute(case):
    x = torch.randn(2, 8, 3, 3)
    r = {"dtype": x.bfloat16(), "shape": x[:1], "channels": None}[case]
    if case == "channels":
        x = torch.randn(1, kernel.MAX_CHANNELS + 1, 1, 1)
    with pytest.raises(ValueError):
        kernel.prepare(x, r)


@pytest.fixture
def stand_in_card(monkeypatch):
    """`layers.on_card` true for every tensor, and a launch that records its
    calls and runs the plain version on what `prepare` hands the kernel."""
    calls = []

    def launch(x, mean, var, weight, bias, eps, residual=None, relu=False, up=1):
        x, residual, inner = kernel.prepare(x, residual, up)
        calls.append((x.dtype, var.dtype, residual is not None, relu, inner))
        return kernel.bn_act_plain(x, mean, var, weight, bias, eps, residual, relu, up)

    monkeypatch.setattr(layers, "on_card", lambda t: True)
    monkeypatch.setattr(kernel, "launch", launch)
    profiling.RECORDER.clear()
    yield calls
    profiling.RECORDER.clear()


def routed(m, x, residual=None, relu=True, up=1):
    """bn_act inside a recorded item: (output, the item's route counts)."""
    with profile(activities=[ProfilerActivity.CPU]):
        with annotate("serve.request"):
            y = bn_act(m, x, residual, relu, up)
    return y, recorded_items()[-1]["counts"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eval_without_autograd_takes_the_kernel(stand_in_card, dtype):
    m = randomize_bn_(bn(8), seed=2).to(dtype).eval()
    x = torch.randn(2, 8, 4, 4).to(dtype).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        y, counts = routed(m, x, x.clone())
    assert stand_in_card == [(dtype, dtype, True, True, 1)] and counts == {"bn_act.fused": 1}
    assert torch.equal(y, kernel.bn_act_plain(x, m.running_mean, m.running_var, m.weight, m.bias, m.eps, x, True))
    with torch.no_grad():                                 # no_grad as inference_mode
        m(x)
    assert len(stand_in_card) == 2 and stand_in_card[1] == (dtype, dtype, False, False, 1)


@pytest.mark.parametrize("condition", ["mixed", "layout", "residual_layout"])
def test_eval_without_autograd_takes_the_kernel_in_every_layout_and_dtype_flow(stand_in_card, condition):
    """x fp32 into bf16 statistics (flax's flow, `_eval_bn_promoted`), a
    layout the kernel has not, a residual in another layout than x's: the
    kernel, on x and the residual in its layout, counted as fused; the
    module's forward, the add and the ReLU give the same values (to the
    kernel's one rounding)."""
    m = randomize_bn_(bn(8), seed=2).eval()
    x = torch.randn(2, 8, 4, 4).contiguous(memory_format=torch.channels_last)
    r = x.clone()
    if condition == "mixed":
        m = m.bfloat16()
    elif condition == "layout":
        x = x.transpose(2, 3)
        r = r.transpose(2, 3)
    else:
        r = r.contiguous()
    with torch.no_grad():
        y, counts = routed(m, x, r)
        want = F.relu(m.plain_forward(x) + r)
    stats = torch.bfloat16 if condition == "mixed" else torch.float32
    assert stand_in_card == [(torch.float32, stats, True, True, 1)] and counts == {"bn_act.fused": 1}
    assert y.dtype == want.dtype and torch.allclose(y, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("condition", ["train", "grad", "fp64", "fp16", "widening"])
def test_every_other_call_takes_the_plain_route(stand_in_card, condition):
    """Train mode, autograd on, fp64, fp16, bf16 x into fp32 statistics
    (whose output widens to fp32): the plain route, the same ops as before,
    counted as plain."""
    m = randomize_bn_(bn(8), seed=2).eval()
    x = torch.randn(2, 8, 4, 4).contiguous(memory_format=torch.channels_last)
    r = x.clone()
    if condition == "train":
        m.train()
    elif condition == "fp64":
        m, x, r = m.double(), x.double(), r.double()
    elif condition == "fp16":
        m, x, r = m.half(), x.half(), r.half()
    elif condition == "widening":
        x, r = x.bfloat16(), r.bfloat16()
    twin = copy.deepcopy(m)
    with torch.set_grad_enabled(condition == "grad"):
        y, counts = routed(m, x, r)
        want = F.relu(twin.plain_forward(x) + r)
    assert stand_in_card == [] and counts == {"bn_act.plain": 1}
    assert torch.equal(y, want)
    assert all(torch.equal(a, b) for a, b in zip(m.state_dict().values(), twin.state_dict().values()))


def test_the_cpu_takes_the_plain_route_uncounted():
    profiling.RECORDER.clear()
    m = randomize_bn_(bn(8), seed=2).eval()
    x = torch.randn(2, 8, 4, 4)
    with torch.inference_mode():
        y, counts = routed(m, x, None, True)
    assert counts == {} and torch.equal(y, F.relu(m.plain_forward(x)))
    profiling.RECORDER.clear()


# --- the upsampling instance (HRNet's fuse terms) -----------------------------

NARROW_STAGES = (
    (1, 2, (1, 1), (8, 16)),
    (1, 3, (1, 1, 1), (8, 16, 24)),
    (2, 4, (1, 1, 1, 1), (8, 16, 24, 32)),
)


def parent_hrmodule(m, xs):
    """HRModule's forward as the parent ran it: the higher-res terms through
    `bn_act`, each lower-res term its Sequential (conv, BatchNorm,
    nn.Upsample) and `acc + y`, then F.relu per row."""
    ys = [branch(x) for branch, x in zip(m.branches, xs)]
    outs = []
    for i, row in enumerate(m.fuse_layers):
        acc = None
        for j, (f, y) in enumerate(zip(row, ys)):
            if j < i:
                *steps, last = f
                for step in steps:
                    y = bn_act(step[1], step[0](y), relu=True)
                acc = bn_act(last[1], last[0](y), residual=acc)
                continue
            y = f(y)
            acc = y if acc is None else acc + y
        outs.append(F.relu(acc))
    return outs


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_hrnet_upsampled_terms_are_the_parents_composition(train, monkeypatch):
    """A narrow four-branch HRNet (fuse terms at `up` 2, 4 and 8, ReLU folded
    into a row's last term) against the same weights run through the
    parent's HRModule forward: equal outputs bit for bit, and in train mode
    equal running statistics and gradients."""
    torch.manual_seed(0)
    net = randomize_bn_(PoseHighResolutionNet(NARROW_STAGES), seed=6).train(train)
    twin = copy.deepcopy(net)
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(7))
    a, b = x.clone().requires_grad_(train), x.clone().requires_grad_(train)
    got = net(a)
    with monkeypatch.context() as patch:
        patch.setattr(HRModule, "forward", parent_hrmodule)
        want = twin(b)
    assert torch.equal(got, want)
    for (n1, t1), (_, t2) in zip(net.state_dict().items(), twin.state_dict().items()):
        assert torch.equal(t1, t2), n1
    if train:
        got.square().sum().backward()
        want.square().sum().backward()
        for (n1, p1), (_, p2) in zip(net.named_parameters(), twin.named_parameters()):
            assert torch.equal(p1.grad, p2.grad), n1
        assert torch.equal(a.grad, b.grad)


def up_case(dtype=torch.float32, c=16, up=2, channels_last=True, seed=8):
    """(eval BatchNorm, low-res x, full-res residual) of a fuse term."""
    g = torch.Generator().manual_seed(seed)
    m = randomize_bn_(bn(c), seed=seed).to(dtype).eval()
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    x = torch.randn(2, c, 3, 5, generator=g).to(dtype).contiguous(memory_format=fmt)
    r = torch.randn(2, c, 3 * up, 5 * up, generator=g).to(dtype).contiguous(memory_format=fmt)
    return m, x, r


def composition(m, x, r, relu, up):
    """The parent's fuse term: the module's BatchNorm, nn.Upsample, the add
    to the sum so far (`acc + y`), the row's ReLU."""
    y = r + nn.Upsample(scale_factor=up, mode="nearest")(m.plain_forward(x))
    return F.relu(y) if relu else y


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16], ids=["f64", "fp32", "bf16"])
@pytest.mark.parametrize("up", [2, 4, 8])
def test_plain_kernel_version_upsampled_is_the_composition(dtype, up):
    """`bn_act_plain(up=)`, the kernel's arithmetic: in f64 exactly its own
    BatchNorm, the nearest upsample, the add and the ReLU (no rounding
    between them), and the module's composition to f64 rounding; in fp32
    and bf16 the composition within the card tests' bars (the kernel
    rounds once, the composition after the BatchNorm and after the add)."""
    m, x, r = up_case(dtype, up=up)
    stats = (m.running_mean, m.running_var, m.weight, m.bias)
    with torch.no_grad():
        for relu in (False, True):
            got = kernel.bn_act_plain(x, *stats, m.eps, r, relu, up)
            want = composition(m, x, r, relu, up)
            assert got.shape == r.shape and got.dtype == dtype
            if dtype == torch.float64:
                own = F.interpolate(kernel.bn_act_plain(x, *stats, m.eps), scale_factor=up, mode="nearest") + r
                assert torch.equal(got, F.relu(own) if relu else own)
                assert torch.allclose(got, want, rtol=1e-13, atol=1e-13)
            else:
                gap = (got.double() - want.double()).abs().max() / want.double().abs().max()
                assert gap <= BARS[dtype], (relu, gap)


@pytest.mark.parametrize("case", ["shape", "dtype", "none", "not_a_power", "nchw", "channels"])
def test_prepare_refuses_upsampled_inputs_it_cannot_take(case):
    """With `up` > 1 the residual has to be x's shape times `up` in x's
    dtype, `up` a power of two, both channels-last, C a multiple of the
    vector."""
    m, x, r = up_case(c=16 if case != "channels" else 6, up=2, channels_last=case != "nchw")
    up = 3 if case == "not_a_power" else 2
    if case == "shape":
        r = r[:, :, :-2]
    elif case == "dtype":
        r = r.double()
    elif case == "none":
        r = None
    elif case == "not_a_power":
        r = F.interpolate(r, scale_factor=1.5, mode="nearest")
    with pytest.raises(ValueError):
        kernel.prepare(x, r, up)
    assert kernel.prepare(*up_case(up=2)[1:], 2)[2] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("up", [2, 4, 8])
def test_upsampled_eval_without_autograd_takes_the_kernel(stand_in_card, dtype, up):
    """An upsampled fuse term in eval with autograd off: the kernel, counted
    as fused and as up-fused, its output of the residual's shape and
    layout."""
    m, x, r = up_case(dtype, up=up)
    for relu in (False, True):
        stand_in_card.clear()
        with torch.inference_mode():
            y, counts = routed(m, x, r, relu, up)
        assert stand_in_card == [(dtype, dtype, True, relu, 1)]
        assert counts == {"bn_act.fused": 1, "bn_act.up_fused": 1}
        assert torch.equal(y, kernel.bn_act_plain(x, m.running_mean, m.running_var, m.weight, m.bias, m.eps, r, relu,
                                                  up))


@pytest.mark.parametrize("condition", ["train", "grad", "fp64", "nchw", "channels"])
def test_upsampled_every_other_call_takes_the_plain_route(stand_in_card, condition):
    """Train mode, autograd on, fp64, an NCHW layout, C not a multiple of
    the vector: the plain route, the parent's ops bit for bit, counted as
    plain and as up-plain; train mode updates the statistics as before."""
    m, x, r = up_case(torch.float64 if condition == "fp64" else torch.float32, c=6 if condition == "channels" else 16,
                      up=4, channels_last=condition != "nchw")
    if condition == "train":
        m.train()
    twin = copy.deepcopy(m)
    with torch.set_grad_enabled(condition == "grad"):
        y, counts = routed(m, x, r, True, 4)
        want = composition(twin, x, r, True, 4)
    assert stand_in_card == [] and counts == {"bn_act.plain": 1, "bn_act.up_plain": 1}
    assert torch.equal(y, want)
    assert all(torch.equal(a, b) for a, b in zip(m.state_dict().values(), twin.state_dict().values()))


def test_upsampled_on_the_cpu_is_the_composition_uncounted():
    profiling.RECORDER.clear()
    m, x, r = up_case(up=8)
    with torch.inference_mode():
        y, counts = routed(m, x, r, True, 8)
        assert counts == {} and torch.equal(y, composition(m, x, r, True, 8))
        with pytest.raises(ValueError):
            bn_act(m, x, None, True, 8)
    profiling.RECORDER.clear()


# --- on the card ------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel is CUDA C++ (csrc/bn_act.cu)")
    return torch.device("cuda", 0)


def served_calls(dev) -> set:
    """(C, H, W) of every kernel call of one bf16 request (B=2) of
    HRNet-W48 and of configs/danet_resnet.yaml: the backbones', the heads'
    and the regressor's blocks."""
    from danet_densepose2smpl_tpu_torch.config import load_config
    from danet_densepose2smpl_tpu_torch.serve import Predictor

    seen, launch = set(), kernel.launch

    def recording(x, *args):
        seen.add((x.shape[1], *(tuple(x.shape[2:]) + (1, 1))[:2]))
        return launch(x, *args)

    images = torch.rand(2, 224, 224, 3)
    kernel.launch = recording
    try:
        for cfg in (None, load_config(str(ROOT / "configs" / "danet_resnet.yaml")).danet):
            Predictor(dev, torch.bfloat16, cfg, seed=0).predict(images)
    finally:
        kernel.launch = launch
    return seen


BARS = {torch.bfloat16: 1e-2, torch.float32: 1e-5}   # over max|ref|: a bf16 rounding, fp32 ulps


def kernel_error(x, stats, res, relu) -> float:
    """The kernel's largest gap from `bn_act_plain` over max|ref|; its
    output keeps x's shape, dtype and (a layout the kernel has) strides."""
    got = kernel.launch(x, *stats, 1e-5, res, relu)
    ref = kernel.bn_act_plain(x, *stats, 1e-5, res, relu)
    assert got.shape == x.shape and got.dtype == x.dtype
    if kernel.run_length(x) is not None:
        assert got.stride() == x.stride()
    return ((got.double() - ref.double()).abs().max() / ref.double().abs().max()).item()


def random_stats(c, dtype, dev, g):
    return [(torch.randn(c, device=dev, generator=g) * 0.1).to(dtype),
            (torch.rand(c, device=dev, generator=g) + 0.5).to(dtype),
            (torch.rand(c, device=dev, generator=g) + 0.5).to(dtype),
            (torch.randn(c, device=dev, generator=g) * 0.1).to(dtype)]


@pytest.mark.cuda
def test_kernel_matches_plain_on_every_served_shape(card):
    shapes = sorted(served_calls(card) | {(21, 7, 5), (3, 5, 3), (12, 56, 56)})
    assert len(shapes) > 20
    g = torch.Generator(device=card).manual_seed(0)
    for c, h, w in shapes:
        for dtype, bar in BARS.items():
            st = random_stats(c, dtype, card, g)
            for fmt in (torch.channels_last, torch.contiguous_format):
                x = torch.randn(2, c, h, w, device=card, generator=g).to(dtype).contiguous(memory_format=fmt)
                r = torch.randn(2, c, h, w, device=card, generator=g).to(dtype).contiguous(memory_format=fmt)
                for res in (None, r):
                    for relu in (False, True):
                        err = kernel_error(x, st, res, relu)
                        assert err <= bar, ((c, h, w), dtype, fmt, res is not None, relu, err)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 48, 56, 56), (64, 64, 112, 112), (64, 21, 57, 55)],
                         ids=["w48_b256", "stem_b64", "odd_b64"])
def test_kernel_matches_plain_at_served_batches(card, shape):
    """Served batches, whose grids walk the tensor in several strides (the
    channel carry of `Steps.grid`), in both layouts, both dtypes, with a
    residual and ReLU; and an odd C, whose vectors cross channels."""
    g = torch.Generator(device=card).manual_seed(1)
    for dtype, bar in BARS.items():
        st = random_stats(shape[1], dtype, card, g)
        for fmt in (torch.channels_last, torch.contiguous_format):
            x = torch.randn(shape, device=card, generator=g).to(dtype).contiguous(memory_format=fmt)
            r = torch.randn(shape, device=card, generator=g).to(dtype).contiguous(memory_format=fmt)
            for res, relu in ((None, False), (r, True)):
                err = kernel_error(x, st, res, relu)
                assert err <= bar, (shape, dtype, fmt, res is not None, relu, err)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["gcn_bf16_statistics", "transposed", "residual_other_layout", "unaligned"])
def test_kernel_on_the_other_inputs_bn_act_hands_it(card, case):
    """fp32 x into bf16 statistics (the GCN's (B, 24 nodes, F) BatchNorm1d:
    the scale in bf16, as `_eval_bn_promoted`); x or the residual in
    another layout (copied to the kernel's); an unaligned view (the scalar
    instance)."""
    g = torch.Generator(device=card).manual_seed(2)
    if case == "gcn_bf16_statistics":
        x = torch.randn(256, 24, 128, device=card, generator=g)
        m = randomize_bn_(layers.BatchNorm1d(24), seed=3).bfloat16().eval().to(card)
        with torch.no_grad():
            want = m.plain_forward(x)
        st = [m.running_mean, m.running_var, m.weight, m.bias]
        got = kernel.launch(x, *st, m.eps)
        assert got.dtype == torch.float32
        assert ((got - want).abs().max() / want.abs().max()).item() <= BARS[torch.float32]
        assert kernel_error(x, st, None, True) <= BARS[torch.float32]
        return
    for dtype, bar in BARS.items():
        st = random_stats(48, dtype, card, g)
        x = torch.randn(8, 48, 28, 28, device=card, generator=g).to(dtype)
        r = torch.randn(8, 48, 28, 28, device=card, generator=g).to(dtype)
        if case == "transposed":
            x, r = x.transpose(2, 3), r.transpose(2, 3)
        elif case == "residual_other_layout":
            x = x.contiguous(memory_format=torch.channels_last)
        else:
            x = torch.randn(8 * 48 * 28 * 28 + 1, device=card, generator=g).to(dtype)[1:].view(8, 48, 28, 28)
            assert x.data_ptr() % 16 != 0
        assert kernel_error(x, st, r, True) <= bar, (case, dtype)
    torch.cuda.synchronize()


# (C, up) of every upsampled fuse term of a W48 request; the output is the
# branch's 56 >> b pixels square, x that over up
SERVED_FUSE = [(48, 2), (48, 4), (48, 8), (96, 2), (96, 4), (192, 2)]
FUSE_SIDE = {48: 56, 96: 28, 192: 14}


def up_kernel_error(x, st, r, relu, up) -> float:
    """The upsampling instance's largest gap from `bn_act_plain` over
    max|ref|; its output keeps the residual's shape, dtype and strides."""
    got = kernel.launch(x, *st, 1e-5, r, relu, up)
    ref = kernel.bn_act_plain(x, *st, 1e-5, r, relu, up)
    assert got.shape == r.shape and got.dtype == r.dtype and got.stride() == r.stride()
    return ((got.double() - ref.double()).abs().max() / ref.double().abs().max()).item()


def fuse_inputs(b, c, side, up, dtype, dev, g):
    cl = torch.channels_last
    x = torch.randn(b, c, side // up, side // up, device=dev, generator=g).to(dtype).contiguous(memory_format=cl)
    r = torch.randn(b, c, side, side, device=dev, generator=g).to(dtype).contiguous(memory_format=cl)
    return x, r


@pytest.mark.cuda
@pytest.mark.parametrize("batch,dtype", [(256, torch.bfloat16), (64, torch.float32)], ids=["bf16_b256", "fp32_b64"])
def test_upsampled_kernel_matches_plain_on_every_served_fuse_shape(card, batch, dtype):
    g = torch.Generator(device=card).manual_seed(3)
    for c, up in SERVED_FUSE:
        st = random_stats(c, dtype, card, g)
        x, r = fuse_inputs(batch, c, FUSE_SIDE[c], up, dtype, card, g)
        for relu in (False, True):
            err = up_kernel_error(x, st, r, relu, up)
            assert err <= BARS[dtype], (c, up, relu, err)
        del x, r
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["odd_batch", "unaligned", "bf16_statistics"])
def test_upsampled_kernel_on_the_other_inputs(card, case):
    """An odd batch (blocks' runs that start and end inside rows); an
    unaligned view (the scalar instance); fp32 x into bf16 statistics (the
    scale in bf16)."""
    g = torch.Generator(device=card).manual_seed(4)
    if case == "bf16_statistics":
        st = [t.bfloat16() for t in random_stats(48, torch.float32, card, g)]
        x, r = fuse_inputs(37, 48, 56, 4, torch.float32, card, g)
        assert up_kernel_error(x, st, r, True, 4) <= BARS[torch.float32]
        return
    for dtype, bar in BARS.items():
        for c, up in SERVED_FUSE:
            st = random_stats(c, dtype, card, g)
            if case == "odd_batch":
                x, r = fuse_inputs(37, c, FUSE_SIDE[c], up, dtype, card, g)
            else:
                s, b = FUSE_SIDE[c], 3
                xs = torch.randn(b * s * s * c // (up * up) + 1, device=card, generator=g).to(dtype)
                rs = torch.randn(b * s * s * c + 1, device=card, generator=g).to(dtype)
                x = xs[1:].view(b, s // up, s // up, c).permute(0, 3, 1, 2)
                r = rs[1:].view(b, s, s, c).permute(0, 3, 1, 2)
                assert x.data_ptr() % 16 != 0 and kernel.takes_up(x, r)
            for relu in (False, True):
                err = up_kernel_error(x, st, r, relu, up)
                assert err <= bar, (case, dtype, c, up, relu, err)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["w48-serve-bf16-b256", "r50-serve-fp32-b64", "w48-serve-fp32-b64"])
def test_predictor_with_the_kernel_within_the_cell_limits(card, workload, monkeypatch):
    """One batch of the cell's traffic through its `Predictor`, with the
    kernel and with `bn_act` refused (the plain route): the readings the
    cell's limits file names, the plain route in the reference's place."""
    from danet_densepose2smpl_tpu_torch import config as port_config
    from port_bench.harness import serve, spec
    from port_bench.reference import config as ref_config

    cell = spec.load_cell(workload)
    cfg = spec.build_config(port_config, cell.config, cell.traffic)
    ref_cfg = spec.build_config(ref_config, cell.config, cell.traffic)
    dtype = serve.DTYPES[cell.traffic["dtype"]]
    predict = serve.port_server(cfg, ref_cfg, 11, dtype, card, serve.smpl_arrays())
    images = serve.make_pool(cell.traffic, cfg.danet.img_size, 11, card)[0]
    fused = predict(images)
    launches = kernel.launches
    monkeypatch.setattr(layers, "kernel_dtypes", lambda m, x: False)
    plain = predict(images)
    assert kernel.launches == launches > 0
    readings = {}
    own = torch.arange(images.shape[0], device=card)
    for k in serve.COMPARED:
        got, ref = fused[k].float(), plain[k].float()
        blocks = serve.PARA_BLOCKS if k == "para" else None
        gaps = serve.image_gaps(got, ref, blocks)
        ratios = serve.nearest_ratios(got, ref, own, blocks)
        readings |= {k: gaps.max().item(), f"{k}_nearest": ratios.max().item(),
                     f"{k}_not_nearest": (ratios > 1).double().mean().item(),
                     f"{k}_unexplained": serve.unexplained(got, ref)}
        if k == "para":
            readings |= {"para_median": gaps.median().item(), "para_p10": torch.quantile(gaps, 0.1).item()}
    limits = json.loads((ROOT / "port_bench" / "limits" / f"{workload}.json").read_text())
    assert all(readings[k] <= v for k, v in limits.items()), {k: (readings[k], v) for k, v in limits.items()}
