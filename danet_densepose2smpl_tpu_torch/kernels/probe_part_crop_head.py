"""Where the time of the bf16 K1 kernel goes, on the card (a probe; no path
calls it).

    python -m danet_densepose2smpl_tpu_torch.kernels.probe_part_crop_head [--widths 48,64,256]
        [--sweep | --ab SOURCE]

By default it builds a copy of `csrc/part_crop_head.cu` in which thread 0
of every block adds `clock64()` deltas per phase into a `__device__` array,
runs it once at each width at the serving shape (B=64, 56x56xC bf16
features, S=56, 24 parts, 21 outputs, bilinear weights), checks its output
against the plain version's bf16 bar (2e-2 of max|ref|), and prints each
phase's share of the summed block time beside the call's time by CUDA
events. Blocks sharing an SM overlap, so a phase's block time includes the
cycles the other block took meanwhile. Insertion points are found by text;
an edit of the source that moved one fails loudly.

`--sweep` times the kernel at every (tile rows, channel chunk) that fits
(the measurement behind `bf16_plan`); `--ab SOURCE` times the launch of
this source's library against that of another source of the same C
entry (a variant of it), in turns in one process.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import numpy as np
import torch

from danet_densepose2smpl_tpu_torch.kernels import part_crop_head as K1
from danet_densepose2smpl_tpu_torch.kernels.build import BUILD_DIR, CSRC, NVCC_FLAGS, _compile, find_nvcc
from danet_densepose2smpl_tpu_torch.ops.imwarp import _axis_weights

def _tick(i: int) -> str:
    return f"c1 = clock64(); if (tid == 0) atomicAdd(&g_phase[{i}], c1 - c0); c0 = c1;\n"


# The kernel's phases: per tile, per channel chunk, the y-interpolation, a
# barrier, the x-interpolation, a barrier, the MMAs; per tile the epilogue.
PHASES = ("block set-up", "MMA of the chunks before the last (and the tile start)", "y-interpolation",
          "barrier: tmp whole", "weight tile issued, x-interpolation", "barrier: crop and weights whole",
          "MMA of the last chunk", "epilogue barrier", "bias, round, stage", "stage barrier", "store")
N_PHASES = len(PHASES)
_B1 = "        __syncthreads();   // tmp is whole; every warp is done with the last MMAs\n"
_B2 = "        cp_async_wait<0>();\n        __syncthreads();   // the crop and the weight tile are whole\n"
_E1 = "      __syncthreads();   // every warp is done reading the crop: the output stage takes its bytes\n"
_E2 = "      __syncthreads();\n      if (whole) {"
# (text of the source, what replaces it), in order; each text occurs once.
# A phase's clock runs from the previous tick to its own.
EDITS = (
    ("namespace {\n", f"__device__ unsigned long long g_phase[{N_PHASES}];\n\nnamespace {{\n"),
    ("  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n",
     "  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n  long long c0 = clock64(), c1;\n"),
    ("  bool weights_ready = false;\n", "  bool weights_ready = false;\n  " + _tick(0)),
    ("        const int cbase = cc * CH;\n", "        const int cbase = cc * CH;\n        " + _tick(1)),
    (_B1, "        " + _tick(2) + _B1 + "        " + _tick(3)),
    (_B2, "        " + _tick(4) + _B2 + "        " + _tick(5)),
    (_E1, "      " + _tick(6) + _E1 + "      " + _tick(7)),
    (_E2, "      " + _tick(8) + "      __syncthreads();\n      " + _tick(9) + "      if (whole) {"),
    ("      // the next pass or tile rebuilds", "      " + _tick(10) + "      // the next pass or tile rebuilds"),
)


def instrumented_source(src: str) -> str:
    for text, new in EDITS:
        if src.count(text) != 1:
            raise RuntimeError(f"probe: not found once in the source: {text!r}")
        src = src.replace(text, new)
    return src + ('\nextern "C" int read_phases(unsigned long long* h) {\n'
                  "  return int(cudaMemcpyFromSymbol(h, g_phase, sizeof(g_phase)));\n}\n")


def _inputs(b, c, s, k, o, seed, dev):
    rng = np.random.RandomState(seed)
    feats = torch.from_numpy(rng.rand(b, s, s, c))
    centers = torch.from_numpy(rng.uniform(-0.6, 0.6, (b, k, 2)))
    scales = torch.from_numpy(rng.uniform(0.2, 0.9, (b, k)))
    wy = _axis_weights(centers[..., 1], scales, s, s, torch.float64)
    wx = _axis_weights(centers[..., 0], scales, s, s, torch.float64)
    kernel = torch.from_numpy(rng.randn(3, 3, c, k * o) * 0.1)
    bias = torch.from_numpy(rng.randn(k * o) * 0.1)
    return [t.to(dev, torch.bfloat16).contiguous() for t in (feats, wy, wx, kernel, bias)]


def _launcher(lib, args, s, plan):
    """The library's entry, `part_crop_head_bf16(..., rows, chunk, stream)`, at
    `plan` = (rows, chunk), else the wrapper's `bf16_plan`."""
    lib.part_crop_head_bf16.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    feats, wy, wx, kernel, bias = args
    b, h, w, c = feats.shape
    k, o = wy.shape[1], kernel.shape[-1] // wy.shape[1]
    rows, chunk = plan or K1.bf16_plan(h, w, c, s, o)
    wpack = K1.pack_head_weights(kernel, k, chunk)
    out = torch.empty((b, k, s, s, o), dtype=torch.bfloat16, device=feats.device)

    def launch():
        err = lib.part_crop_head_bf16(feats.data_ptr(), wy.data_ptr(), wx.data_ptr(), wpack.data_ptr(),
                                      bias.data_ptr(), out.data_ptr(), b, h, w, c, s, k, o, rows, chunk,
                                      torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"probe kernel launch failed: cudaError {err}")

    return launch, out, f"rows {rows}, chunk {chunk}"


def probe(lib, c, batch=64, seed=2) -> None:
    dev = torch.device("cuda")
    s, k, o = 56, 24, 21
    args = _inputs(batch, c, s, k, o, seed, dev)
    launch, out, plan = _launcher(lib, args, s, None)
    launch()   # warm-up: its phase sums are read as a baseline
    torch.cuda.synchronize()
    before = (ctypes.c_ulonglong * N_PHASES)()
    lib.read_phases(before)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    launch()
    end.record()
    torch.cuda.synchronize()
    after = (ctypes.c_ulonglong * N_PHASES)()
    lib.read_phases(after)
    cycles = [after[i] - before[i] for i in range(N_PHASES)]
    total = sum(cycles)
    ref = K1.part_crop_head_plain(*args, s).double()
    err, ref_max = (out.double() - ref).abs().max().item(), ref.abs().max().item()
    print(f"probe: C={c} ({plan}), B={batch}: {start.elapsed_time(end)!r} ms (CUDA events, instrumented); "
          f"max abs err vs plain {err!r} (bar {2e-2 * ref_max!r}); {total / (batch * k)!r} cycles a block")
    for name, n in zip(PHASES, cycles):
        print(f"probe: C={c}: {name}: {n} block cycles, {n / total!r} of the total")
    if not err <= 2e-2 * ref_max:
        raise SystemExit("the instrumented kernel disagrees with the plain version")


def _cuda_ms(fn, n: int) -> float:
    """Mean ms per call of `fn()` over `n` calls after one warm-up, CUDA events."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def sweep(widths, batch: int = 64, seed: int = 2, calls: int = 20) -> None:
    """The real library's bf16 kernel at every (rows, chunk) that fits one
    block, at each width: its time (CUDA events, means of `calls` calls, two
    turns, the second in reverse order), its error against the plain
    version, and the wrapper's route beside them."""
    lib = K1.load_library()[0]
    dev = torch.device("cuda")
    s, k, o = 56, 24, 21
    for c in widths:
        args = _inputs(batch, c, s, k, o, seed, dev)
        ref = K1.part_crop_head_plain(*args, s).double()
        bar = 2e-2 * ref.abs().max().item()
        cpad = -(-c // 16) * 16
        plans = [(rows, chunk) for rows in (4, 6, 7, 8) for chunk in K1.BF16_CHUNKS if chunk <= max(cpad, 16)
                 if rows * s <= K1.BF16_MAX_PIXELS and lib.part_crop_head_bf16_bytes(rows, s, s, o, chunk) <= 227 * 1024]
        runs = {plan: _launcher(lib, args, s, plan) for plan in plans}
        runs["route"] = (lambda: K1.fused_part_predict(*args, s), None, "the wrapper's route")
        times = {plan: [] for plan in runs}
        for order in (list(runs), list(runs)[::-1]):
            for plan in order:
                times[plan].append(_cuda_ms(runs[plan][0], calls))
        for plan, (launch, out, label) in runs.items():
            out = launch() if out is None else out
            err = (out.double() - ref).abs().max().item()
            smem = lib.part_crop_head_bf16_bytes(plan[0], s, s, o, plan[1]) if plan != "route" else None
            print(f"sweep: C={c} {label}: {times[plan]} ms (smem {smem} bytes), max abs err {err!r} (bar {bar!r})")
            if not err <= bar:
                raise SystemExit(f"C={c} {label} disagrees with the plain version")


def ab(other: Path, widths, turns: int = 12, calls: int = 20, batch: int = 64, seed: int = 2) -> dict:
    """The launch alone of this tree's library against that of the K1 source
    at `other` (a variant with the same C entry), at B=64 bf16, in `turns`
    turns in one process (each turn `calls` calls by CUDA events, the order
    alternating), both at the wrapper's plan. Returns {C: (the other's median
    ms, this tree's median ms)}."""
    lib_o, log = _compile(other, [find_nvcc()], NVCC_FLAGS, BUILD_DIR)
    for line in log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"ab: {other}: {line.strip()}")
    lib_t = K1.load_library()[0]
    s, k, o = 56, 24, 21
    out = {}
    for c in widths:
        args = _inputs(batch, c, s, k, o, seed, torch.device("cuda"))
        runs = [_launcher(lib_o, args, s, None), _launcher(lib_t, args, s, None)]
        times = ([], [])
        for turn in range(turns):
            for i in ((0, 1) if turn % 2 == 0 else (1, 0)):
                times[i].append(_cuda_ms(runs[i][0], calls))
        ref = K1.part_crop_head_plain(*args, s).double()
        bar = 2e-2 * ref.abs().max().item()
        errs = [(r[1].double() - ref).abs().max().item() for r in runs]
        med = [float(np.median(t)) for t in times]
        print(f"ab: C={c} B={batch}: {other} ({runs[0][2]}) median {med[0]!r} ms of {times[0]}; this tree "
              f"({runs[1][2]}) median {med[1]!r} ms of {times[1]}; this tree / other {med[1] / med[0]!r}; "
              f"max abs errs vs plain {errs} (bar {bar!r})")
        if not max(errs) <= bar:
            raise SystemExit(f"ab: C={c}: a library disagrees with the plain version")
        out[c] = tuple(med)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--widths", default="48,64,256", help="comma-separated channel counts")
    ap.add_argument("--sweep", action="store_true",
                    help="time this tree's kernel at every (rows, chunk) that fits, instead of probing")
    ap.add_argument("--ab", type=Path, metavar="SOURCE",
                    help="time this tree's launch against that of another K1 source, in turns, instead of probing")
    a = ap.parse_args(argv)
    widths = [int(x) for x in a.widths.split(",")]
    print(f"probe: card {card()}")
    if a.sweep:
        return sweep(widths)
    if a.ab:
        return ab(a.ab, widths)
    source = CSRC / "part_crop_head.cu"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src_path, lib_path = BUILD_DIR / "probe_part_crop_head.cu", BUILD_DIR / "libprobe_part_crop_head.so"
    src_path.write_text(instrumented_source(source.read_text()))
    subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(lib_path), str(src_path)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    print(f"probe: {source} instrumented")
    for c in widths:
        probe(lib, c)


if __name__ == "__main__":
    main()
