"""The serve cells: one client in a closed loop, requests back to back.

Set-up builds the port's serving entry of the cell's model family
(`families/<family>.py::port_server`; for DaNet `Predictor.predict`) with
the seed's weights (made on the device, `harness.weights`) and the
family's body model (the synthetic SMPL arrays by default), makes a pool
of distinct image batches of the family's image size on the device and
warms up on them. The window
sends requests until `seconds` have passed: a request is the entry called
on the next batch of the pool, and its latency runs from the call to the
end of its `torch.cuda.synchronize()`. A sample of
the finished requests, drawn from the seed as the window goes (a
reservoir), is kept; once the window has closed (and the profiled slice,
with `--trace 1`), the peak memory is read, the port is freed, and the
plain reference of the family recomputes each sampled request from the
same images and weights (and, for a family whose reference is
conditioned, the port's choices in that request): the family's compared
outputs, `para`, `vertices` and `joints` by default, are compared. The
family's optional attributes and their defaults are listed in
`families/__init__.py`.
"""

from __future__ import annotations

import gc
import math
import random
import statistics
import time
from pathlib import Path

import torch

from port_bench.harness import spec
from port_bench.harness.precision import computed_in
from port_bench.harness.trace import profile_slice, sync
from port_bench.harness.weights import derive_seed
from port_bench.harness.yardstick import counting_flops

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
COMPARED = ("para", "vertices", "joints")
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def make_pool(traffic: dict, hw, seed: int, device) -> torch.Tensor:
    """(pool, B, H, W, 3) normalized RGB batches in the served dtype, made
    on the device from the seed, `hw` (H, W) or one side of a square:
    uniform pixels, ImageNet-normalized; or,
    where the traffic gives `images`, a pixel is per image a brightness
    per channel and a contrast times a smooth field (normal draws on a
    `grid` x `grid` lattice per channel, upsampled bicubically), plus
    uniform grain, clipped to [0, 1]: images that differ in their colours
    and their large-scale layout, as photographs do, and not only in
    their noise."""
    import torch.nn.functional as F

    h, w = (hw, hw) if isinstance(hw, int) else hw
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, "images"))
    shape = (traffic["pool"], traffic["batch"], h, w, 3)
    look = traffic.get("images")
    if look is None:
        pixels = torch.rand(shape, generator=gen, device=device)
    else:
        n, g = shape[0] * shape[1], look["grid"]

        def uniform(lo_hi, *size):
            lo, hi = lo_hi
            return lo + (hi - lo) * torch.rand(size, generator=gen, device=device)

        field = F.interpolate(torch.randn((n, 3, g, g), generator=gen, device=device),
                              size=(h, w), mode="bicubic", align_corners=False)
        grain = torch.rand((n, h, w, 3), generator=gen, device=device) - 0.5
        pixels = (uniform(look["brightness"], n, 1, 1, 3) + uniform(look["contrast"], n, 1, 1, 1)
                  * field.permute(0, 2, 3, 1) + look["grain"] * grain).clamp_(0.0, 1.0).view(shape)
    mean = torch.tensor(IMAGENET_MEAN, device=device)
    std = torch.tensor(IMAGENET_STD, device=device)
    return ((pixels - mean) / std).to(DTYPES[traffic["dtype"]])


def smpl_arrays():
    from port_bench.reference.smpl.loader import synthetic_smpl_model

    return synthetic_smpl_model()


def family_name(family) -> str:
    return Path(family.__file__).stem


def body_on(family, arrays, device):
    """`arrays` as the reference's body model on `device`: the family's
    `body_to_device`, else the reference's SMPL `to_torch`."""
    from port_bench.reference.smpl.loader import to_torch

    return getattr(family, "body_to_device", to_torch)(arrays, device)


def port_server(cfg_port, ref_cfg, seed: int, dtype: torch.dtype, device, smpl):
    """DaNet's serving entry (`families/danet.py::port_server`), by the
    name that callers outside the harness use."""
    from port_bench.families.danet import port_server as danet_server

    return danet_server(cfg_port, ref_cfg, seed, dtype, device, smpl)


def control_server(family, ref_cfg, seed: int, dtype: torch.dtype, device, body, kind: str, block: int):
    """The family's reference put in the port's place, computed in `kind`
    (a precision below the cell's): the control of the comparison. A
    conditioned reference makes its own choices here, and `compare`
    conditions the fp32 reference on them."""
    model = family.reference_model(ref_cfg, seed, device, dtype).eval()
    body_t = body_on(family, body, device)

    @torch.no_grad()
    def serve(images):
        with computed_in(kind, model):
            return family.reference_outputs(model, body_t, images, block)

    return serve


# the blocks of `para` read against their own spread: camera, shape, rotations
PARA_BLOCKS = ((0, 3), (3, 13), (13, 229))


def para_blocks(family, cfg, width: int) -> tuple:
    """The column blocks of `para` that `image_gaps` and `nearest_ratios`
    read, each against its own spread: the family's `para_blocks(cfg)`,
    else `PARA_BLOCKS`. Raises ValueError, naming the family and the first
    column left out or read twice, unless they tile columns 0 to `width`
    in order, so that no column goes unread."""
    blocks = tuple(map(tuple, family.para_blocks(cfg))) if hasattr(family, "para_blocks") else PARA_BLOCKS
    at, fault = 0, None
    for lo, hi in blocks:
        if lo > at:
            fault = f"column {at} is left out"
        elif lo < at:
            fault = f"column {lo} is read twice"
        elif hi <= lo:
            fault = f"block ({lo}, {hi}) is empty"
        if fault:
            break
        at = hi
    else:
        if at < width:
            fault = f"column {at} is left out"
        elif at > width:
            fault = f"the blocks run past column {width - 1}"
    if fault:
        raise ValueError(f"model family '{family_name(family)}': para_blocks {blocks} do not tile the "
                         f"{width} columns of para: {fault}")
    return blocks


def image_gaps(got: torch.Tensor, ref: torch.Tensor, blocks=None) -> torch.Tensor:
    """(N,) each answer's largest gap in an output (N, ...), over the spread
    of the reference's answers (a column's median distance of an answer
    from the column's median over the sampled answers, widest over the
    columns, and at least a thousandth of the block's largest magnitude),
    so a gap reads against how much answers typically differ from one
    another; with `blocks` (column ranges), each block against its own
    spread. Inf where the port's answer is missing or not finite."""
    ref = ref.flatten(1).double()
    if got.shape[0] != ref.shape[0] or got[0].numel() != ref.shape[1]:
        return torch.full((ref.shape[0],), float("inf"), dtype=torch.float64, device=ref.device)
    diff = (got.flatten(1).double() - ref).abs()
    spread = (ref - ref.median(dim=0).values).abs().median(dim=0).values
    gap = torch.zeros(ref.shape[0], dtype=torch.float64, device=ref.device)
    for lo, hi in blocks or ((0, ref.shape[1]),):
        scale = torch.maximum(spread[lo:hi].max(), 1e-3 * ref[:, lo:hi].abs().max()).clamp_min(1e-30)
        gap = torch.maximum(gap, diff[:, lo:hi].amax(dim=1) / scale)
    return torch.where(torch.isfinite(gap), gap, torch.full_like(gap, float("inf")))


def nearest_ratios(got: torch.Tensor, refs: torch.Tensor, own: torch.Tensor, blocks=None) -> torch.Tensor:
    """(N,) each answer's distance to its own reference answer over its
    distance to the nearest other reference answer: under 1 where the
    answer is nearer its own than any other. `got` (N, ...) answers,
    `refs` (U, ...) the U distinct reference answers of the sample, `own`
    (N,) the index into `refs` of each answer's own. Euclidean over the
    columns, each block of columns (`blocks`) over its spread as in
    `image_gaps`. Inf where an answer is missing or not finite."""
    refs = refs.flatten(1).double()
    n = own.shape[0]
    if refs.shape[0] < 2 or got.shape[0] != n or got[0].numel() != refs.shape[1]:
        return torch.full((n,), float("inf"), dtype=torch.float64, device=refs.device)
    got = got.flatten(1).double()
    spread = (refs - refs.median(dim=0).values).abs().median(dim=0).values
    scale = torch.ones(refs.shape[1], dtype=torch.float64, device=refs.device)
    for lo, hi in blocks or ((0, refs.shape[1]),):
        scale[lo:hi] = torch.maximum(spread[lo:hi].max(), 1e-3 * refs[:, lo:hi].abs().max()).clamp_min(1e-30)
    dist = torch.cdist(got / scale, refs / scale)
    rows = torch.arange(n, device=refs.device)
    mine = dist[rows, own].clone()
    dist[rows, own] = float("inf")
    ratio = mine / dist.min(dim=1).values.clamp_min(1e-300)
    return torch.where(torch.isfinite(ratio), ratio, torch.full_like(ratio, float("inf")))


def unexplained(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The share of the reference answers' variation from answer to answer
    that the port's answers leave unexplained: for each column of an
    output (N, ...), the sum of squared gaps over the sum of squared
    distances of the reference's answers from their mean, the median over
    the columns that vary (inf where an answer is missing or not
    finite)."""
    got, ref = got.flatten(1).double(), ref.flatten(1).double()
    if got.shape != ref.shape:
        return float("inf")
    var = ((ref - ref.mean(dim=0)) ** 2).sum(dim=0)
    err = ((got - ref) ** 2).sum(dim=0)
    varies = var > 1e-12 * var.max()
    share = (err[varies] / var[varies]).median().item() if bool(varies.any()) else float("inf")
    return share if share == share else float("inf")


def answer_rows(family, k: str, rows: int, images: int, answers: int) -> None:
    """Raises ValueError, naming the family, unless the reference's output
    `k` holds one row for each image or one for each answer (`answers`
    an image), and `para` one for each answer."""
    if rows in (images * answers, images) and (k != "para" or rows == images * answers):
        return
    raise ValueError(f"model family '{family_name(family)}': its reference's '{k}' holds {rows} rows for "
                     f"{images} images of {answers} answers each: an output holds one row an image or one an "
                     f"answer, and para one an answer")


def compare(family, served: list, ref_cfg, seed: int, dtype: torch.dtype, device, body, pool,
            block: int) -> tuple:
    """({number: reading}, {'flops_per_image', 'k1_call'}) over the answers
    of the sampled requests. An image gives the family's
    `answers_per_image(cfg)` answers (1 by default), so an output holds a
    row for each answer, image-major, or one for each image. The family's
    reference computes each distinct sampled batch once; a conditioned
    reference (`reference_conditioned`) computes each sampled request
    once, given that request's served outputs, so it answers for the
    choices the port made on the card, and the readings of its own that
    it returns under `readings` (the larger the worse) are merged in, the
    largest over the requests.
    Readings, for each output k that the family compares (`compared`,
    default `COMPARED`): `k`, the widest answer gap
    (`image_gaps`); `k_nearest`, the largest of `nearest_ratios` (over 1
    where an answer lies nearer another reference answer of the sample
    than its own), and `k_not_nearest`, the share of answers for which it
    is over 1; `k_unexplained` (`unexplained`); and the median and the
    10th percentile of the answers' `para` gaps, `para` read in its
    blocks (`para_blocks`, which have to tile it). Each cell's limits file
    names the readings it compares. With random weights many of the
    model's hard decisions, the argmax of the index maps and the part
    visibility threshold, sit on a knife's edge, and the answers vary
    little from image to image, so an answer's gap swings with rounding:
    the low percentiles read where the decisions agree, and the shares
    read the sample as a whole. The yardstick's counts come from the
    reference's first computed request: its FLOPs, and K1's call where
    the reference made part crops (none: no `k1_call`)."""
    model = family.reference_model(ref_cfg, seed, device, dtype).eval()
    body_t = body_on(family, body, device)
    conditioned = getattr(family, "reference_conditioned", False)
    answers = family.answers_per_image(ref_cfg) if hasattr(family, "answers_per_image") else 1
    counts, readings = {}, {}

    def reference(images, **given):
        if counts:
            return family.reference_outputs(model, body_t, images, block, **given)
        with counting_flops() as c:
            out = family.reference_outputs(model, body_t, images, block, **given)
        counts["flops_per_image"] = c["flops"] / images.shape[0]
        calls = c["crops"]
        if calls:
            b = sum(call[0] for call in calls)
            counts["k1_call"] = (b, *calls[0][1:6], sum(call[6] for call in calls),
                                 sum(call[7] for call in calls))
        return out

    with torch.no_grad(), computed_in("fp32", model):
        if conditioned:
            refs = [reference(pool[slot], served=out) for slot, out in served]
            for ref in refs:
                for name, value in ref.pop("readings", {}).items():   # NaN reads as inf
                    readings[name] = max(readings.get(name, -math.inf), value if value == value else math.inf)
        else:
            slots = sorted({slot for slot, _ in served})
            by_slot = {slot: reference(pool[slot]) for slot in slots}
            refs = [by_slot[slot] for slot, _ in served]
    b = pool.shape[1]
    blocks = para_blocks(family, ref_cfg, refs[0]["para"].flatten(1).shape[1])
    for k in getattr(family, "compared", COMPARED):
        rows = refs[0][k].shape[0]
        answer_rows(family, k, rows, b, answers)
        r = torch.cat([ref[k] for ref in refs])
        got = torch.cat([out[k].float() if out[k].shape == ref[k].shape else torch.full_like(ref[k], float("inf"))
                         for (_, out), ref in zip(served, refs)])
        if conditioned:   # the sample's distinct reference answers
            r_all, own = torch.unique(r, dim=0, return_inverse=True)
        else:
            r_all = torch.cat([by_slot[slot][k] for slot in slots])
            own = torch.cat([slots.index(slot) * rows + torch.arange(rows, device=device) for slot, _ in served])
        k_blocks = blocks if k == "para" else None
        gaps = image_gaps(got, r, k_blocks).cpu()
        finite = bool(torch.isfinite(gaps).all())
        readings[k] = gaps.max().item()
        ratios = nearest_ratios(got, r_all, own, k_blocks)
        readings[f"{k}_nearest"] = ratios.max().item()
        readings[f"{k}_not_nearest"] = (ratios > 1).double().mean().item()
        readings[f"{k}_unexplained"] = unexplained(got, r)
        if k == "para":
            readings["para_median"] = gaps.median().item() if finite else float("inf")
            readings["para_p10"] = torch.quantile(gaps, 0.1).item() if finite else float("inf")
    return readings, counts


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        overrides: dict | None = None, server: str = "port", wrap=None) -> dict:
    """One run of a serve cell (see the module docstring). `server` is
    'port', or a control precision ('tf32', 'fp8') in whose place the
    reference serves; `wrap(predict) -> predict` plants a fault in the
    served path (the checks of the comparison)."""
    t = cell.traffic
    family = cell.family
    cfg, ref_cfg = family.configs(cell.config, t, overrides)
    dtype = DTYPES[t["dtype"]]
    block = t["reference_block"]
    marks = [("start", time.perf_counter())]
    # the body model that the port and the reference share
    body = family.body_arrays(ref_cfg) if hasattr(family, "body_arrays") else smpl_arrays()
    marks.append(("body model", time.perf_counter()))
    if server == "port":
        predict = family.port_server(cfg, ref_cfg, seed, dtype, device, body)
    else:
        predict = control_server(family, ref_cfg, seed, dtype, device, body, server, block)
    if wrap is not None:
        predict = wrap(predict)
    marks.append(("model", time.perf_counter()))
    pool = make_pool(t, family.image_hw(cfg), seed, device)
    marks.append(("pool", time.perf_counter()))
    for i in range(t["warmup"]):
        predict(pool[i % len(pool)])
        sync(device)
    marks.append(("warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    setup_parts = f"imports and device {marks[0][1] - t_start:.2f} s, " + ", ".join(
        f"{name} {b - a:.2f} s" for (_, a), (name, b) in zip(marks, marks[1:]))

    keep = t["check_requests"]
    pick = random.Random(derive_seed(seed, "sample"))
    served, latency, dispatch = [], [], []
    n = 0
    t0 = time.perf_counter()
    while True:
        slot = n % len(pool)
        ts = time.perf_counter()
        out = predict(pool[slot])
        td = time.perf_counter()
        sync(device)
        te = time.perf_counter()
        latency.append(te - ts)
        dispatch.append(td - ts)
        # reservoir sample of the finished requests
        if len(served) < keep:
            served.append((slot, out))
        else:
            j = pick.randrange(n + 1)
            if j < keep:
                served[j] = (slot, out)
        del out
        n += 1
        if te - t0 >= seconds:
            break
    wall = te - t0

    slice_trace = None
    if trace:
        slots = iter(range(n, n + t["slice_requests"] + 1))
        slice_trace = profile_slice(lambda: predict(pool[next(slots) % len(pool)]), t["slice_requests"],
                                    t["batch"], device)
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    del predict
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    readings, counts = compare(family, served, ref_cfg, seed, dtype, device, body, pool, block)
    check_s = time.perf_counter() - t_check
    b = t["batch"]
    ms = [x * 1e3 for x in latency]
    p95 = statistics.quantiles(ms, n=100, method="inclusive")[94] if len(ms) > 1 else ms[0]
    return {
        "kind": "serve",
        "attempted": n,
        "setup_s": setup_s,
        "end_to_end": {"serve_imgs_per_s": n * b / wall, "serve_p95_ms": p95},
        "readings": readings,
        "memory_peak_bytes": peak,
        "notes": [f"serve: {n} requests of B={b} {t['dtype']} in {wall!r} s; latency median "
                  f"{statistics.median(ms)!r} ms, p95 {p95!r} ms over {len(ms)} requests; "
                  f"reference check of {len(served)} requests in {check_s!r} s",
                  f"set-up {setup_s!r} s: {setup_parts}"],
        "ctx": {"kind": "serve", "dtype": t["dtype"], "items": n, "images": n * b, "wall_s": wall,
                "dispatch_s": dispatch, "slice": slice_trace, **counts},
    }
