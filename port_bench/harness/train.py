"""The train cell: training steps back to back from raw batches. The
training harness is DaNet's (`families/danet.py` builds its
configurations, weights and the port's training state).

Set-up makes the seed's weights on the device, builds the port's training
state (the model and its Adam) and its step (`make_train_step`, the closed
atlas with culling for the GT raster) and stages a few distinct raw
batches on the device: the frozen `synthetic_raw_batch` with keypoints
that its fits explain, rows in blocks by source (the traffic's `sources`:
rows with SMPL and 3D GT first, then in-the-wild rows with 2D keypoints
only, as a batch concatenated from per-source loaders is laid out), and
uint8 frames with the SPIN augmentation's crop, rotation, flip and
channel noise, so `train.ingest` runs in the step. It
then drives that state through its first three steps on three distinct
batches, through the window's own call, and reads what they did: each
step's loss, the first gradient as Adam holds it (its first moment after
one step over 1 - b1), and each leaf's change after the three. The window
runs on from step four, without a synchronize between steps; the last one
ends in one. Once the window has closed (and the profiled slice), the
peak memory is read, the port is freed, and the plain reference takes the
same three steps from the same weights and batches, in fp32.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from port_bench.families.danet import configs, port_step, reference_model
from port_bench.harness import spec
from port_bench.harness.precision import computed_in
from port_bench.harness.trace import profile_slice, sync
from port_bench.harness.weights import derive_seed
from port_bench.harness.yardstick import counting_flops

CHECKED_STEPS = 3
# the loss terms that no hard decision of the model reaches: the global IUV
# maps against the GT render, computed from the heads' raw logits
IUV_TERMS = ("loss_U", "loss_V", "loss_IndexUV", "loss_segAnn")


def _tensors(tree, device):
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    t = torch.as_tensor(tree, device=device)
    return t.float() if t.is_floating_point() else t


def source_flags(traffic: dict) -> dict:
    """{flag: (B,) float32} of the rows in blocks by source, in the order of
    `traffic['sources']`, each block `share` of the batch (rounded)."""
    b, sources = traffic["batch"], traffic["sources"]
    edges = np.round(np.cumsum([0.0] + [src["share"] for src in sources]) * b).astype(int)
    edges[-1] = b
    flags = {}
    for key in ("has_smpl", "has_pose_3d"):
        flags[key] = np.concatenate([np.full(hi - lo, src[key], np.float32)
                                     for src, lo, hi in zip(sources, edges[:-1], edges[1:])])
    return flags


def make_batches(ref_cfg, traffic: dict, seed: int, device, smpl) -> list:
    """`traffic['distinct_batches']` raw batches of `traffic['batch']` rows
    on the device (see the module docstring)."""
    from port_bench.reference.data.synthetic import synthetic_raw_batch
    from port_bench.reference.smpl.loader import to_torch
    from port_bench.reference.smpl.model import smpl_forward_aa

    b, frame = traffic["batch"], traffic["frame"]
    res = ref_cfg.danet.img_size
    smpl64 = to_torch(smpl, device, torch.float64)
    aug = traffic["augment"]
    batches = []
    for i in range(traffic["distinct_batches"]):
        raw = synthetic_raw_batch(ref_cfg, b, seed=derive_seed(seed, "batch", i) % 2 ** 32)
        raw.pop("img")
        raw.update(source_flags(traffic))
        batch = _tensors(raw, device)
        gen = torch.Generator(device=device).manual_seed(derive_seed(seed, "frames", i))

        def u(*shape):
            return torch.rand(shape, generator=gen, device=device)

        # 2D keypoints that the fits explain: their joints under a weak-
        # perspective camera of scale 0.9, plus noise of 0.01
        fit = torch.where(batch["has_smpl"][:, None] > 0, batch["pose"], batch["opt_pose"]).double()
        joints = smpl_forward_aa(smpl64, batch["betas"].double(), fit).joints
        tz = 2 * 5000.0 / (res * 0.9)
        kp = joints[..., :2] / (joints[..., 2:] + tz) * 5000.0 / (res / 2)
        noise = torch.randn(kp.shape, generator=gen, device=device, dtype=torch.float64) * 0.01
        batch["keypoints"][..., :2] = (kp + noise).float()
        # the frames and the SPIN augmentation (base_dataset.augm_params)
        batch["raw_img"] = torch.randint(0, 256, (b, frame, frame, 3), generator=gen, device=device,
                                         dtype=torch.uint8)
        batch["center"] = frame / 2 + (u(b, 2) - 0.5) * aug["center_jitter_px"]
        sf, rf, nf = aug["scale_factor"], aug["rot_factor"], aug["noise_factor"]
        gauss = torch.randn(b, 2, generator=gen, device=device)
        batch["scale"] = aug["base_scale"] * (gauss[:, 0] * sf + 1).clamp(1 - sf, 1 + sf)
        rot = (gauss[:, 1] * rf).clamp(-2 * rf, 2 * rf)
        batch["rot_angle"] = torch.where(u(b) <= aug["rot_zero_share"], torch.zeros_like(rot), rot)
        batch["is_flipped"] = (u(b) < 0.5).float()
        batch["pixel_noise"] = 1 - nf + 2 * nf * u(b, 3)
        batches.append(batch)
    return batches


def step_generator(seed: int, index: int, device) -> torch.Generator:
    """The train-mode noise of step `index` (jitter, PartDrop)."""
    return torch.Generator(device=device).manual_seed(derive_seed(seed, "noise", index))


def first_gradients(optimizer, params: dict) -> dict:
    """{leaf: the gradient of the first step as the optimizer got it}: an
    Adam's first moment after one step over 1 - b1 (zero for a leaf it
    holds no state of)."""
    b1 = {id(p): group["betas"][0] for group in optimizer.param_groups for p in group["params"]}
    state = optimizer.state
    return {k: state[p]["exp_avg"] / (1 - b1[id(p)]) if p in state else torch.zeros_like(p)
            for k, p in params.items()}


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tensors.items()}


def leaf_gaps(got: dict, ref: dict, keys=None) -> dict:
    """{leaf: the gap between the port's and the reference's norm of the
    leaf, over the reference's norm of that leaf or of the median leaf,
    whichever is larger}; inf for a leaf the port lacks or that is not
    finite."""
    keys = list(ref) if keys is None else keys
    median = float(np.median([ref[k] for k in ref]))
    out = {}
    for k in keys:
        g = got.get(k, float("nan"))
        out[k] = abs(g - ref[k]) / max(ref[k], median, 1e-30) if np.isfinite(g) else float("inf")
    return out


class _ControlState:
    def __init__(self, model, optimizer):
        self.model, self.optimizer, self.step = model, optimizer, 0


def control_step(ref_cfg, seed: int, device, smpl, atlas, template, kind: str, chunk: int):
    """The reference put in the port's place, computed in `kind` (a
    precision below the cell's): the control of the comparison, with the
    port step's interface."""
    from port_bench.reference.kernels.rasterizer import IUVRenderer
    from port_bench.reference.smpl.loader import to_torch
    from port_bench.reference.train.step import make_optimizer, make_train_step

    model = reference_model(ref_cfg, seed, device)
    state = _ControlState(model, make_optimizer(ref_cfg, model.parameters()))
    renderer = IUVRenderer(atlas, 224, ref_cfg.danet.heatmap_size, chunk=chunk, cull_verts=template)
    ref_step = make_train_step(model, to_torch(smpl, device), ref_cfg, renderer=renderer)

    def step(st, batch, generator=None):
        with computed_in(kind, model):
            loss, losses = ref_step(st.optimizer, st.step, batch, generator)
        st.step += 1
        return st, {**losses, "loss_total": loss}

    return state, step


def reference_steps(ref_cfg, seed: int, device, smpl, atlas, template, batches, chunk: int) -> dict:
    """The reference's first CHECKED_STEPS steps from the seed's weights,
    in fp32: losses, first gradients and changes per leaf, and the FLOPs
    of one step per image."""
    from port_bench.reference.kernels.rasterizer import IUVRenderer
    from port_bench.reference.smpl.loader import to_torch
    from port_bench.reference.train.step import make_optimizer, make_train_step

    model = reference_model(ref_cfg, seed, device)
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    opt = make_optimizer(ref_cfg, model.parameters())
    renderer = IUVRenderer(atlas, 224, ref_cfg.danet.heatmap_size, chunk=chunk, cull_verts=template)
    step = make_train_step(model, to_torch(smpl, device), ref_cfg, renderer=renderer)
    losses = []
    with computed_in("fp32", model):
        for i in range(CHECKED_STEPS):
            if i == 0:
                with counting_flops() as c:
                    loss, terms = step(opt, i, batches[i], step_generator(seed, i, device))
                flops = c["flops"] / batches[i]["raw_img"].shape[0]
                grads = leaf_norms({k: p.grad for k, p in model.named_parameters()})
                iuv = float(sum(terms[k] for k in IUV_TERMS))
            else:
                loss, _ = step(opt, i, batches[i % len(batches)], step_generator(seed, i, device))
            losses.append(float(loss))
    change = leaf_norms({k: p.detach() - start[k] for k, p in model.named_parameters()})
    return {"losses": losses, "iuv": iuv, "grads": grads, "change": change, "flops_per_image": flops}


def relative_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30) if np.isfinite(a) else float("inf")


def readings_of(got: dict, ref: dict) -> tuple[dict, str]:
    """({number: reading}, a note naming the worst leaves): the worst
    step's loss gap over the reference's loss; the first step's gap of the
    IUV terms (IUV_TERMS); the median leaf's gap of the first gradient's
    norm; the worst and the median leaf's gap of the change after three
    steps, over the leaves whose reference gradient is at least a
    thousandth of the median leaf's."""
    loss = max(relative_gap(a, b) for a, b in zip(got["losses"], ref["losses"]))
    median_grad = float(np.median(list(ref["grads"].values())))
    moved = [k for k, v in ref["grads"].items() if v >= 1e-3 * median_grad]
    grad = leaf_gaps(got["grads"], ref["grads"])
    change = leaf_gaps(got["change"], ref["change"], moved)
    worst_g, worst_c = max(grad, key=grad.get), max(change, key=change.get)
    note = (f"worst gradient leaf {worst_g} ({grad[worst_g]!r}), worst change leaf {worst_c} "
            f"({change[worst_c]!r}); {len(ref['grads']) - len(moved)} of {len(ref['grads'])} leaves left out of "
            f"the change (reference gradient under a thousandth of the median leaf's)")
    return {"loss": loss, "loss_iuv1": relative_gap(got["iuv"], ref["iuv"]),
            "grad_median": float(np.median(list(grad.values()))),
            "change": change[worst_c], "change_median": float(np.median(list(change.values())))}, note


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        overrides: dict | None = None, wrap=None, server: str = "port", reference_chunk: int = 256) -> dict:
    """One run of the train cell (see the module docstring). `server` is
    'port', or a control precision ('fp8') in which the reference takes
    the port's place; `wrap(step) -> step` plants a fault in the trained
    path (the checks of the comparison)."""
    from port_bench.reference.smpl.densepose_atlas import closed_synthetic_atlas
    from port_bench.reference.smpl.loader import synthetic_smpl_model

    t = cell.traffic
    cfg, ref_cfg = configs(cell.config, t, overrides)
    marks = [("start", time.perf_counter())]
    smpl = synthetic_smpl_model()
    atlas, template = closed_synthetic_atlas(smpl.num_verts)
    marks.append(("smpl and atlas", time.perf_counter()))
    if server == "port":
        state, step = port_step(cfg, ref_cfg, seed, device, smpl, atlas, template)
    else:
        state, step = control_step(ref_cfg, seed, device, smpl, atlas, template, server, reference_chunk)
    if wrap is not None:
        step = wrap(step)
    marks.append(("model", time.perf_counter()))
    batches = make_batches(ref_cfg, t, seed, device, smpl)
    marks.append(("batches", time.perf_counter()))
    nb, b = len(batches), t["batch"]

    def one(i, terms=None):
        metrics = step(state, batches[i % nb], step_generator(seed, i, device))[1]
        if terms is not None:
            terms.update(metrics)
        return metrics["loss_total"]

    params = dict(state.model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    got = {"losses": []}
    for i in range(CHECKED_STEPS):
        terms = {}
        got["losses"].append(float(one(i, terms)))
        if i == 0:
            got["iuv"] = float(sum(terms[k] for k in IUV_TERMS))
            got["grads"] = leaf_norms(first_gradients(state.optimizer, params))
    got["change"] = leaf_norms({k: p.detach() - start[k] for k, p in params.items()})
    del start
    marks.append(("checked steps", time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    setup_parts = f"imports and device {marks[0][1] - t_start:.2f} s, " + ", ".join(
        f"{name} {b_ - a:.2f} s" for (_, a), (name, b_) in zip(marks, marks[1:]))

    losses = []
    i = CHECKED_STEPS
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        losses.append(one(i))
        i += 1
    sync(device)
    wall = time.perf_counter() - t0
    n = len(losses)
    failed = int(sum(not bool(torch.isfinite(x)) for x in losses))
    del losses

    slice_trace = None
    if trace:
        steps = iter(range(i, i + t["slice_steps"] + 1))
        slice_trace = profile_slice(lambda: one(next(steps)), t["slice_steps"], b, device, sync_each=False)
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    del state, step, one, params
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    ref = reference_steps(ref_cfg, seed, device, smpl, atlas, template, batches, reference_chunk)
    check_s = time.perf_counter() - t_check
    readings, leaves = readings_of(got, ref)
    notes = [f"train: {n} steps of B={b} in {wall!r} s ({wall / max(n, 1) * 1e3!r} ms a step); losses of "
             f"the first {CHECKED_STEPS} steps {got['losses']} (reference {ref['losses']}); reference "
             f"check in {check_s!r} s; {leaves}", f"set-up {setup_s!r} s: {setup_parts}"]
    if slice_trace is not None:
        notes.append(f"profiled slice: {slice_trace.window_s / slice_trace.items * 1e3!r} ms a step, the device "
                     f"busy {slice_trace.busy_s() / slice_trace.items * 1e3!r} ms of it")
    return {
        "kind": "train",
        "attempted": n,
        "failed": failed,
        "setup_s": setup_s,
        "end_to_end": {"train_imgs_per_s": n * b / wall},
        "readings": readings,
        "memory_peak_bytes": peak,
        "notes": notes,
        "ctx": {"kind": "train", "dtype": cfg.danet.compute_dtype, "items": n, "images": n * b,
                "wall_s": wall, "slice": slice_trace, "flops_per_image": ref["flops_per_image"]},
    }
