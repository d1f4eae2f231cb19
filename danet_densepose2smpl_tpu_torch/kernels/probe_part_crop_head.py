"""Where the time of the bf16 K1 kernel goes, on the card (a probe; no path
calls it).

    python -m danet_densepose2smpl_tpu_torch.kernels.probe_part_crop_head

Builds a copy of `csrc/part_crop_head.cu` in which thread 0 of every block
adds `clock64()` deltas per phase into a `__device__` array, runs it once
at the serving shape (B=64, 56x56x48 bf16 features, S=56, 24 parts, 21
outputs, bilinear weights), checks that its output equals the real
kernel's, and prints each phase's share of the summed block time beside
the call's time by CUDA events. Two blocks share an SM, so a phase's
block time includes the cycles the other block took meanwhile.
"""

from __future__ import annotations

import ctypes
import subprocess

import numpy as np
import torch

from danet_densepose2smpl_tpu_torch.kernels import part_crop_head as K1
from danet_densepose2smpl_tpu_torch.kernels.build import BUILD_DIR, CSRC, NVCC_FLAGS, find_nvcc
from danet_densepose2smpl_tpu_torch.ops.imwarp import _axis_weights

PHASES = ("block set-up, tile start", "y lists and items", "row steps: barrier", "row steps: copies issued",
          "row steps: interpolation", "last barrier", "MMA and epilogue", "store")


def _tick(i: int) -> str:
    return f"c1 = clock64(); if (tid == 0) atomicAdd(&g_phase[{i}], c1 - c0); c0 = c1;\n"


_STEP_TOP = "      cp_async_wait<0>();\n      __syncthreads();\n      if (i + 1 < n_items) issue(i + 1);\n"
_LAST = "    cp_async_wait<0>();   // the weight tile, when no row had a tap\n    __syncthreads();\n"
_STORE_END = ("    for (int e = head + n_vec * 8 + tid; e < total; e += kThreads) dst[e] = ostage[mis + e];\n"
              "    __syncthreads();\n")
# (text of the source, what replaces it), in order; each text occurs once.
# A phase's clock runs from the previous tick to its own.
_EDITS = (
    ("namespace {\n", "__device__ unsigned long long g_phase[8];\n\nnamespace {\n"),
    ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
     "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n  long long c0 = clock64(), c1;\n"),
    ("    const int y0 = t * rows, rv = min(rows, S - y0);\n",
     "    const int y0 = t * rows, rv = min(rows, S - y0);\n    " + _tick(0)),
    ("    // Crop build, a row a step", "    " + _tick(1) + "    // Crop build, a row a step"),
    (_STEP_TOP, "      " + _tick(4) + "      cp_async_wait<0>();\n      __syncthreads();\n      " + _tick(2)
     + "      if (i + 1 < n_items) issue(i + 1);\n      " + _tick(3)),
    (_LAST, "    " + _tick(4) + _LAST + "    " + _tick(5)),
    ("    // The tile's rows are one contiguous span", "    " + _tick(6) + "    // The tile's rows are one contiguous span"),
    (_STORE_END, _STORE_END + "    " + _tick(7)),
)


def instrumented_source() -> str:
    src = (CSRC / "part_crop_head.cu").read_text()
    for text, new in _EDITS:
        if src.count(text) != 1:
            raise RuntimeError(f"probe: not found once in part_crop_head.cu: {text!r}")
        src = src.replace(text, new)
    return src + ('\nextern "C" int read_phases(unsigned long long* h) {\n'
                  "  return int(cudaMemcpyFromSymbol(h, g_phase, sizeof(g_phase)));\n}\n")


def main(batch: int = 64, seed: int = 2) -> None:
    dev = torch.device("cuda")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src_path, lib_path = BUILD_DIR / "probe_part_crop_head.cu", BUILD_DIR / "libprobe_part_crop_head.so"
    src_path.write_text(instrumented_source())
    subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(lib_path), str(src_path)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.part_crop_head_bf16.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]

    rng = np.random.RandomState(seed)
    b, h, c, s, k, o = batch, 56, 48, 56, 24, 21
    feats = torch.from_numpy(rng.rand(b, h, h, c))
    centers = torch.from_numpy(rng.uniform(-0.6, 0.6, (b, k, 2)))
    scales = torch.from_numpy(rng.uniform(0.2, 0.9, (b, k)))
    wy = _axis_weights(centers[..., 1], scales, h, s, torch.float64)
    wx = _axis_weights(centers[..., 0], scales, h, s, torch.float64)
    kernel = torch.from_numpy(rng.randn(3, 3, c, k * o) * 0.1)
    bias = torch.from_numpy(rng.randn(k * o) * 0.1)
    args = [t.to(dev, torch.bfloat16).contiguous() for t in (feats, wy, wx, kernel, bias)]
    wpack = K1.pack_head_weights(args[3], k)
    out = torch.empty((b, k, s, s, o), dtype=torch.bfloat16, device=dev)

    def launch():
        err = lib.part_crop_head_bf16(args[0].data_ptr(), args[1].data_ptr(), args[2].data_ptr(),
                                      wpack.data_ptr(), args[4].data_ptr(), out.data_ptr(),
                                      b, h, h, c, s, k, o, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"probe kernel launch failed: cudaError {err}")

    launch()   # warm-up: its phase sums are read as a baseline
    torch.cuda.synchronize()
    before = (ctypes.c_ulonglong * 8)()
    lib.read_phases(before)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    launch()
    end.record()
    torch.cuda.synchronize()
    after = (ctypes.c_ulonglong * 8)()
    lib.read_phases(after)
    cycles = [after[i] - before[i] for i in range(8)]
    total = sum(cycles)
    same = torch.equal(out, K1.fused_part_predict(*args, s))
    print(f"probe: bf16 K1, B={b}: {start.elapsed_time(end)!r} ms (CUDA events, instrumented); output equal "
          f"to the real kernel's: {same}; {total / (b * k * -(-s // 4))!r} block cycles a (block, tile) "
          f"at 4-row tiles")
    for name, n in zip(PHASES, cycles):
        print(f"probe: {name}: {n} block cycles, {n / total!r} of the total")
    if not same:
        raise SystemExit("the instrumented kernel disagrees with the real one")


if __name__ == "__main__":
    main()
