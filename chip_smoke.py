"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from the
sources in the checkout and drives the serving slice (full HRNet-W48 DaNet
+ SMPL, seeded random weights), the training slice (the full DaNet
training step), the eval path, the training CLI and the eval CLIs on the
card, then the demo, the training visualization and the offline
preprocessing, then the other architectures (the ResNet-50 backbone,
whose 256 channels K1 takes in chunks, the other refinements, the
GlobalPredictor and the HMR baseline), the input-mode ablations, the
chunked crop + head in training and data parallel, and last backbone
rematerialisation, the padded HRNet, the checkpoint preflight, the native
RLE codec and the profiling module. The synthetic raw batches get 2D
keypoints that their poses explain (`posed_keypoints`), so the fitted
cameras frame body-sized silhouettes. In phases:

  0. environment: a CUDA card of capability 9.0, versions, the card's name
     and power limit, whether yaml, PIL (and its JPEG decoder) and
     torchvision import; build both kernels (one nvcc each, started together)
     and print the compilers' `-Xptxas -v` reports; for each K1 kernel its
     registers, spill stores and the count of tensor-core instructions
     (HMMA/HGMMA) in the built library's SASS (`cuobjdump --dump-sass`):
     the bf16 kernel's two instances (channel chunks of 16 and 32) and the
     fp32 (3xTF32) kernel's two (chunks of 8 and 16) must have some and spill
     nothing, the f64 (scalar) kernel none;
  1. the kernel against its plain PyTorch version at the production shape
     (B=8, 56x56x48, S=56, 24 parts, 21 outputs), fed by bilinear
     `_axis_weights` matrices and by random dense ones: fp32 (TF32 off)
     max abs error <= 1e-4, bf16 <= 2e-2 * max|ref|, f64 (small shape)
     <= 1e-10; and bf16 where nothing is a multiple of the tensor-core
     kernel's tiles (B=1, S=57, C=8 and 20, 5 outputs);
  2. the whole slice in f64 on the card against the same model on the CPU
     (B=2, 224 px): para and vertices within atol 1e-6 / rtol 1e-9; then
     fp32 `Predictor` on the card against that f64 result, para within the
     weight bridge's fp32 bar (atol 0.05, rtol 1e-3), and, for the record,
     the model under PyTorch's TF32 defaults;
  3. serving: `Predictor` in bf16 answers requests of B=64 (the main
     path); the outputs are finite and shaped right, and every request
     launched the kernel; then 3 timed requests of B=256 after a warm-up
     (the size of `bench.py::bench_inference`); one request of each batch
     under `torch.profiler`: kernel time, the card's idle share, the
     serve.model and serve.smpl ranges, and K1's device time inside it;
  4. at B=64 bf16, by CUDA events in turns: the kernel, its plain version,
     and the unfused route the port has (`separable_crop_concat`, then
     `PartialIUVHead.forward`: cuDNN's grouped conv, channels_last; a
     yardstick only, never called on the path) with its conv alone; the
     profiler's device time of the kernel alone (without the wrapper's
     weight packing); the phase-1 check once more at that batch; the tile
     rows and channel chunk (`bf16_plan`); the launch alone (weights packed
     once), 12 turns of 20 calls, beside the C=48 A/B against the earlier
     kernel's library recorded in PERF.md §6 (`kernels/
     probe_part_crop_head.py --ab SOURCE` repeats it);
  5. the rasterizer kernel against its plain version at the training shape
     (B=128, 56x56, 13,776 faces; vertices from `smpl_forward_aa` of
     synthetic poses, cameras from `prepare_targets`): (a) the soup atlas
     through `rasterize_flat`, (a64) the closed atlas through
     `rasterize_flat` at B=64 (the call of phase 7's 'pallas' backend), (b)
     the closed atlas with culling through `rasterize_flat_culled`, (c) the
     closed atlas through `rasterize_flat_masked` with `backface_mask`,
     (b64) and (c64) the same at the main path's B=64, (d) f64 at B=2, (e)
     the closed test mesh (local faces, the real mesh's kind) through
     `rasterize_flat`, and (t) an exact depth tie between a live and a dead
     filler face through `rasterize_flat_culled`. At most 1e-5 of the pixels
     may differ, foreground must cover > 2%; then, for (a)-(c), (a64),
     (b64), (c64) and (e),
     the fp32 pair kernel must equal the tile kernel bit for bit, and the
     times of the entry, the tile kernel (fp64's route, the yardstick) and
     the plain version (CUDA events, turns); the pairs the kernel
     enumerated must equal `pixel_spans`' count and be at least
     `raster_bound`'s exact-box count, with how they spread over the faces;
  6. one training step in f64, card against CPU: full W48 at 64 px, B=4,
     soup atlas, PartDrop and jitter off, the same seeded weights and batch;
     every loss term, every gradient and the parameters after one Adam
     step agree at the stated tolerances, and the raster kernel launched;
  7. bf16 mixed-precision training at full size (`DaNetConfig()`, 224 px,
     B=64, the closed atlas with culling): 1 warm-up and 5 timed steps (the
     main path), then one step each in `pretrain_mode` and through the
     'pallas' and 'pallas_bandrange' renderer backends; the launch counts
     are zeroed before each of these paths and read after it; losses
     finite, parameters moved, one raster launch a step at least; imgs/s
     and peak memory; then two more steps under `torch.profiler` (kernel
     time per step, the stage spans, the 25 largest kernels);
  8. eval: (a) the banded raster (K3, `rasterize_flat_banded`) against its
     plain version and bit-equal to the `rasterize_flat` kernel at 224x224,
     B=16 fp32 and B=2 f64, with `PartRenderer`'s 2-channel texture on two
     meshes of the real counts (the synthetic SMPL body under posed
     cameras, and the closed test mesh), with the pairs the kernel
     enumerated against `pixel_spans` and the exact boxes; (b) the times of
     K3, of `rasterize_flat`, of the tile kernel and of the plain version
     (CUDA events, turns); (c) the same on the eval's own render, then
     `run_lsp_eval` through `Predictor` in bf16 over 4 batches of B=16
     with `PartRenderer('pallas_banded')` and with 'auto': the same printed
     metrics, and K1 and the raster launched once per batch for the
     prediction and once for the rendered-GT fallback; (d) `run_pose_eval`
     on h36m-p2 (finite MPJPE / PA-MPJPE, the per-action table) and the
     harness in f64, card against CPU, within 1e-9 relative. One more pass
     of each eval runs under `torch.profiler`: host and kernel time by
     stage range, and the card's idle share;
  9. the training CLI: (a) `cli.train.main` in-process with
     `--synthetic-data --num_samples 256 --batch_size 64 --bf16
     --pretr_step 1 --num_epochs 1 --summary_steps 1 --vis_interval 0` and
     the default config (224 px, W48): it writes its SPIN-format dataset
     (PNG) and trains 4 steps (1 pretrain, 3 full) through the resumable
     loader, the prefetcher and the Trainer, the raster counts zeroed just
     before and read just after; losses finite, 4 metrics rows (the first
     without `smpl_pose`), `rasterize_flat` launched each step, a
     checkpoint and config.json written; imgs/s by summary window; (b) the
     same run through a `Trainer` whose loader is watched: host ms waiting
     for each batch against each step's window, the third step (with the
     wait for the next batch) under `torch.profiler` (kernel time and the
     card's idle share), and one batch assembled by the host alone, on one
     thread and on the prefetcher's decode threads (in 4 steps the first
     step's warm-up hides ingest; this is its steady pace); (c) a Trainer
     cut after step 2 (its time
     budget, checkpoints every 2 steps) and a fresh one on the same
     directory: it resumes at (epoch 0, batch 2, step 2), steps 3-4 get
     (b)'s batches bit for bit, and the parameters end within 2 lr a step
     of (b)'s (Adam moves a parameter by at most ~lr a step, so runs whose
     nondeterministic cuDNN backward disagree on a gradient's sign part by
     at most that);
 10. the eval CLIs and the ingest on the card, in-process, default config,
     over synthetic datasets written under build/chip_smoke_eval and
     removed: (a) `cli.eval.main` with `--dataset h36m-p2 --synthetic-data
     --num_samples 64 --batch_size 16 --bf16`, then the same with
     `--device_preprocess`: finite MPJPE / PA-MPJPE and the per-action
     table, K1 launched once a batch, imgs/s of the eval pass (host clock;
     the summaries are printed, not compared: the random-init network
     magnifies the two crops' bilinear differences); (b) `--dataset lsp`
     with its GT PNGs: the four Final Results lines finite and in [0, 1],
     K1 and the raster launched once a batch; (c) `cli.eval_coco.main`: the
     AP table finite and in [0, 1] (or -1), K1 once a batch; (d)
     `device_preprocess` and `device_preprocess_train` at B=64 on 256 px
     uint8 frames against their CPU runs, within 1e-4 on the normalized
     scale with PyTorch's TF32 switches on around them, and their times by
     CUDA events; (e) `cli.train.main` as in phase 9 (a) plus
     `--device_preprocess` (4 steps: losses finite, 4 metric rows,
     `rasterize_flat` each step), then the host ms to assemble one raw
     B=64 batch on one thread and on the prefetcher's decode threads
     (batches 0-3, in turns), beside phase 9 (b)'s host-crop figure of
     the same call;
 11. the demo, the training visualization and the offline preprocessing,
     over files written under build/chip_smoke_demo and removed: (a)
     `render_shaded` (the demo's shaded views: one `rasterize_flat` call
     per image, a 1-channel face texture) on the full synthetic SMPL body
     (6,890 vertices, 13,776 faces) under cameras fitted to posed
     keypoints, B=4, 224 px, yaw 0 and 90, against its plain version on
     the CPU (the shading, then the banded plain raster, bit-identical to
     `rasterize_flat_plain`; at most PIXELS_OFF_MAX of the pixels differ,
     foreground > 2%), then its time by CUDA events at B=1 and B=4 beside the raster
     calls alone and the plain version, the pairs enumerated and
     `raster_bound`'s bound; (b) `cli.demo.main` in-process with the
     default config (HRNet-W48, 224 px), seeded random weights and
     synthetic assets over 8 PNG frames of 448x448, 300x200, 200x300 and
     640x480 px, once in fp32 and once with `--bf16`: one readable,
     non-constant composite per input with tiles of the expected sizes, K1
     launched once and `rasterize_flat` three times per image (counts
     zeroed before each run, read after), and the host ms per image after
     the first by `demo.*` range; (c) `Trainer._save_vis` at full width
     (bf16) on a B=64 host-cropped batch and on a raw
     (`--device_preprocess`) batch: both PNGs written, K1 once and the
     raster 5 times (the IUV render and 4 shaded views), and its ms; (d)
     `cli.preprocess` on a synthetic densepose_coco json of 256
     annotations: GO, the npz written, and one B=64 batch with DensePose
     blobs assembled from it by `NpzDataset`;
 12. slice D's architectures: (a) K1 at the ResNet backbone's width
     (56x56x256; the kernels take the channels in chunks) against its
     plain version, bilinear and dense weights: B=64 bf16 within 2e-2 of
     max|ref|, B=16 fp32 within 1e-4 (TF32 off), B=2 f64 within 1e-10, and
     B=1 at C=264, 200, 201 and 72 (partial last chunks); then its time at
     B=64 bf16 by CUDA events (medians of two turns of 20 calls) beside its
     earlier time, the plain version, the unfused route and its conv alone, the
     launch alone at the wrapper's plan and at each channel chunk, and its
     bound; (b)
     `configs/danet_resnet.yaml` (ResNet-50 backbone, seeded random
     weights): f64 B=2 on the card against the CPU (para atol 1e-6, rtol
     1e-9), fp32 `Predictor` against that f64 result (atol 0.05, rtol
     1e-3), and 8 bf16 requests of B=64 with K1 launched once each, imgs/s,
     one under `torch.profiler`; (c) `cli.train --cfg
     configs/danet_resnet.yaml` in-process as phase 9 (a) (4 steps, B=64,
     bf16: finite losses, `rasterize_flat` each step), then 2 steps of
     phase 7's main path on that config (closed atlas, culling:
     `rasterize_flat_masked` each step); (d) 'gcn_direct', 'lstm',
     'lstm_direct', `decomposed=False` and `refine_on=False` on the
     HRNet-W48 backbone: f64 B=2 card against CPU (atol 1e-6, rtol 1e-9),
     then one bf16 request of B=64 (finite; K1 once, none without
     `decomposed`); (e) `cli.eval --regressor hmr` on h36m-p2 and lsp, B=16
     over 64 synthetic rows, fp32: finite metrics, imgs/s, no K1 launch,
     one raster a batch for lsp; and `cli.eval_coco --regressor hmr`
     refuses;
 13. the input-mode ablations on HRNet-W48 at 224 px, seeded random
     weights: (a) the eval forward of 'iuv_gt', 'iuv_feat', 'iuv_gt_feat',
     'feat' and 'seg' (the GT modes given a synthetic GT IUV image and GT
     keypoints) in f64 at B=2, card against CPU (para atol 1e-6, rtol
     1e-9; K1 once for 'seg', never for the others); (b) one bf16
     `Predictor` request of B=64 for 'iuv' (the comparison), 'iuv_feat',
     'feat' and 'seg' after a warm-up request: finite, K1 once for 'iuv'
     and 'seg' and never for the feature modes, its host ms; `Predictor`
     refuses the two GT modes; (c) for 'iuv' and each ablation, a warm-up
     and 2 timed bf16 steps of B=64 on the closed atlas with culling:
     finite losses, `rasterize_flat_masked` once a step, a finite non-zero
     `stn_ratio` gradient in 'iuv_gt', ms/step and the peak GiB; (d) one
     f64 'iuv_gt' step at 224 px, B=4, card against CPU, the render cast to
     f64: every loss term and the `stn_ratio` gradient within 1e-9
     relative; (e) `cli.train` in-process with a YAML of `INPUT_MODE:
     'iuv_gt_feat'` (4 steps, B=64, bf16, the synthetic SPIN rows,
     `--vis_interval 4`): finite losses, `rasterize_flat` once a step, the
     vis step's one skip line and no PNG; `cli.eval` with an 'iuv_gt' YAML
     refuses;
 14. the last two modules: (a) `cli.train --cfg configs/danet_tpu_b128.yaml
     --raster_cull` in-process as in phase 9 (a) (B=128, bf16,
     part_head_chunks 3, 4 steps; the synthetic soup atlas cannot be
     culled, so `rasterize_flat` renders once a step), then the culled
     bf16 B=128 step on the closed atlas with part_head_chunks 3 and 1
     (a warm-up and 2 timed steps each: ms/step, peak GiB, K4 once a
     step), then the chunked f64 step (W48, 64 px, B=4, the closed atlas
     culled) on the card against the CPU and against the one-shot step on
     the card; (b) data parallel at one NCCL rank: `cli.train
     --data_parallel` at B=64 bf16 (4 steps), the culled bf16 B=64 step
     plain and data-parallel in turns (ms/step), the f64 step at one rank
     against the plain one; (c) two processes on cuda:0 in a gloo process
     group (CUDA tensors): the data-parallel f64 step (W48, 64 px, PartDrop
     and jitter on) of a global batch of 8 whose masks differ between the
     halves against one process's step on the card, the ranks' parameters
     bit-equal after Adam, K4 once per rank, and `make_eval_step(mesh=)`
     against one rank. f64 bars: losses rtol 1e-9, gradients 1e-9 of each
     tensor's largest entry (+1e-12), BatchNorm statistics rtol 1e-9, atol
     1e-10.
 15. the last refusals: (a) backbone rematerialisation: the culled bf16
     step at B=128 (default config, closed atlas) without remat and under
     `remat_scope` 'backbone', 'modules' and 'early' (a warm-up and 2 timed
     steps each: ms/step, peak GiB, K4 once a step, the CUDA RNG state
     untouched), one B=384 step under 'modules' (finite losses, peak GiB),
     the f64 step (W48, 64 px, B=4, noise on) under each scope against no
     remat on the card (phase 14's bars, `num_batches_tracked` equal), two
     gloo ranks on cuda:0 with 'modules' against one process without
     remat, as phase 14 (c), and `cli.train --remat` in-process (4 steps,
     B=64, bf16); (b) the padded HRNet (`hrnet_pad_channels`): K1 at C=64
     and C=48 against its plain version, bilinear and dense weights (B=64
     bf16 within 2e-2 of max|ref|, B=16 fp32 within 1e-4 with TF32 off, B=2
     f64 within 1e-10; C=48 at B=1), its time at B=64 bf16, C=64, as phase
     12 (a) has it beside its earlier time, with the launch at C=48 in the
     same turns (and their ratio);
     the padded DaNet f64 B=2 on the card against the CPU (para atol 1e-6,
     rtol 1e-9), 8 bf16 requests of B=64 padded and W48 in turns (imgs/s,
     K1 once each), one culled bf16 B=64 step (ms, peak GiB); (c)
     `cli.port --check` on a synthetic reference .pt (GO, then NO-GO with
     a key dropped), the host ms to decode a B=64 batch's DensePose masks
     with the C++ codec and with numpy (bit-equal), and
     `utils.profiling.trace` around one request in a process of its own
     (device kernels and the annotated range in its Chrome trace; late in
     this process, after phase 14, the profiler recorded no device
     events).
 16. K1's fp32 kernel (`part_crop_head_f32_kernel<CH>`, the conv in 3xTF32
     on the tensor cores), which `Predictor`, `cli.eval`, `cli.eval_coco`
     and `cli.demo` run by default; it runs after phase 13, before 14 and
     15 (after phase 14's NCCL group and spawned ranks torch.profiler has
     recorded no device event): (a) against its plain version with
     TF32 off, bilinear and dense weights, within 1e-4: B=1 at C=8, 20, 48,
     64, 72, 200, 201, 256, 264 (S=56, O=21) and at C=8, 20, 201 (S=57,
     O=5), B=64 at C=48, B=16 at C=256; (b) at B=64 fp32 and C=48, 64, 256,
     by CUDA events in turns (medians of two turns): the wrapper, the plain
     version (3 calls), the unfused route (TF32 off) and its conv alone,
     then the launch alone at `f32_plan`, at each channel chunk and of the
     scalar kernel it replaced (the C entry `part_crop_head`, dtype 0), the
     kernel's device ms by torch.profiler, both bounds (3xTF32 at 495
     TFLOP/s, FFMA at 67) and a check that it beats the scalar kernel; (c)
     8 fp32 `Predictor` requests of B=64 on HRNet-W48, the padded HRNet and
     configs/danet_resnet.yaml (K1 at C=48, 64, 256; launches counted):
     host ms and imgs/s, then one profiled request each: kernel ms, the
     fp32 kernel's device ms inside it (its name must show) and the idle
     share, beside the scalar kernel's time from (b).

Any failed check raises and the exit code is non-zero. The last three lines
of standard output are the card's name and power limit, one JSON object
describing each kernel (with the path its launch count was read from;
`rasterize_flat` also has `cli_launches` and
`cli_device_preprocess_launches`, its counts in phase 9 (a) and 10 (e);
`part_crop_head` has `cli_eval_launches`, its counts in phase 10 (a)-(c);
the raster entry of the LSP CLI has `cli_eval_lsp_launches`; the K1 and
`rasterize_flat` entries have `demo_launches` and `vis_launches`, their
counts in phase 11 (b) and (c), and `rasterize_flat` has `shaded`, phase
11 (a)'s numbers; phase 12 adds `resnet` to `part_crop_head` (K1 at
C=256: its launches on the ResNet-50 serving path and (a)'s numbers) with
`arch_launches` (d), `resnet_cli_launches` and `hmr_lsp_launches` to
`rasterize_flat`, and `resnet_launches` to `rasterize_flat_masked`; phase
13 adds `input_mode_launches` to `part_crop_head` (b) and to
`rasterize_flat_masked` (c), and `input_mode_cli_launches` to
`rasterize_flat` (e); phase 14 adds `b128_cli_launches` and
`dp_cli_launches` to `rasterize_flat` (a), (b), and
`b128_chunks_launches` and `dp_launches` to `rasterize_flat_masked`;
phase 15 adds `pad` to `part_crop_head` (K1 at C=64: its launches on the
padded serving path and (b)'s numbers) and `remat_launches` to
`rasterize_flat_masked` (a); phase 16 adds `fp32` to `part_crop_head`: at
each C, the fp32 kernel's launches in (c) and (b)'s numbers), and
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import copy
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "danet_densepose2smpl_tpu_torch/csrc/part_crop_head.cu"
KERNEL_REPLACES = "danet_densepose2smpl_tpu/kernels/part_crop_head.py:65"
RASTER_SOURCE = "danet_densepose2smpl_tpu_torch/csrc/rasterizer.cu"
RASTER_REPLACES = {   # entry point -> the TPU kernel it replaces
    "rasterize_flat": "danet_densepose2smpl_tpu/kernels/rasterizer_pallas.py:143",
    "rasterize_flat_banded": "danet_densepose2smpl_tpu/kernels/rasterizer_pallas.py:323",
    "rasterize_flat_masked": "danet_densepose2smpl_tpu/kernels/rasterizer_pallas.py:446",
}
SERVE_BATCH, SERVE_REQUESTS = 64, 8
SERVE_BIG_BATCH, SERVE_BIG_REQUESTS = 256, 3
RASTER_BATCH, TRAIN_BATCH, TRAIN_STEPS = 128, 64, 5
EVAL_BATCH, EVAL_BATCHES = 16, 4
PIXELS_OFF_MAX = 1e-5     # fraction of raster pixels allowed to differ from the plain version
# fp32 serving's para error against f64 on the CPU (phases 2 and 12 (b))
# when fp32 K1 ran the scalar kernel: this script at commit 953cbf6 on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6)
FP32_SERVING_ERR_WAS = {"w48": 0.006006514698584264, "resnet": 1.2554476236381618e-07, "run": "commit 953cbf6"}
# NVIDIA H100 SXM data sheet peaks (dense): the bound of each kernel
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}   # tensor cores; fp32 outside them
# fp32 operations of one (pixel, face) candidate in the raster: three edge
# functions (2 subtractions, a product and a fused multiply-add each), their
# three sign products, three divisions and the depth (a product and two
# fused multiply-adds)
RASTER_OPS_PER_CANDIDATE = 3 * 5 + 3 + 3 + 5


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def k1_inputs(b, h, w, c, s, dtype, device, seed, dense=False, o=21, boxes=False):
    """Inputs of the scale of tests/test_part_crop_head.py; with `boxes`
    (bilinear only), also the part centres and scales of the matrices."""
    from danet_densepose2smpl_tpu_torch.ops.imwarp import _axis_weights

    rng = np.random.RandomState(seed)
    k = 24
    feats = torch.from_numpy(rng.rand(b, h, w, c))
    if dense:
        wy = torch.from_numpy(rng.rand(b, k, s, h) / h)
        wx = torch.from_numpy(rng.rand(b, k, s, w) / w)
    else:
        centers = torch.from_numpy(rng.uniform(-0.6, 0.6, (b, k, 2)))
        scales = torch.from_numpy(rng.uniform(0.2, 0.9, (b, k)))
        wy = _axis_weights(centers[..., 1], scales, h, s, torch.float64)
        wx = _axis_weights(centers[..., 0], scales, w, s, torch.float64)
    kernel = torch.from_numpy(rng.randn(3, 3, c, k * o) * 0.1)
    bias = torch.from_numpy(rng.randn(k * o) * 0.1)
    args = [t.to(device=device, dtype=dtype).contiguous() for t in (feats, wy, wx, kernel, bias)]
    return (args, centers.to(device), scales.to(device)) if boxes else args


def posed_keypoints(cfg, smpl, raw: dict, seed: int, scale: float = 0.9) -> dict:
    """`raw` with 2D keypoints that its GT fits explain: their joints under
    a weak-perspective camera of scale `scale`, plus noise of 0.01 (the
    synthetic keypoints are random and fit cameras behind the body)."""
    from danet_densepose2smpl_tpu_torch.smpl.loader import to_torch
    from danet_densepose2smpl_tpu_torch.smpl.model import smpl_forward_aa

    fit = np.where(raw["has_smpl"][:, None] > 0, raw["pose"], raw["opt_pose"])
    joints = smpl_forward_aa(to_torch(smpl, "cpu", torch.float64), torch.from_numpy(raw["betas"]).double(),
                             torch.from_numpy(fit).double()).joints.numpy()
    res = cfg.danet.img_size
    tz = 2 * 5000.0 / (res * scale)
    kp = joints[..., :2] / (joints[..., 2:] + tz) * 5000.0 / (res / 2)
    raw["keypoints"][..., :2] = (kp + np.random.RandomState(seed).randn(*kp.shape) * 0.01).astype(np.float32)
    return raw


def phase0_environment():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        sys.exit(2)
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        print(f"chip_smoke: needs a Hopper card (capability 9.0), found {cap}", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, REPO)
    from danet_densepose2smpl_tpu_torch.kernels import part_crop_head, rasterizer

    print(f"phase 0: python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, capability {cap}")
    print(f"phase 0: nvidia-smi: {card_line()}")
    for name, version in import_probe().items():
        print(f"phase 0: import {name}: {version}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:   # one nvcc per source, both at once
        logs = list(pool.map(lambda mod: mod.load_library()[1], (part_crop_head, rasterizer)))
    print(f"phase 0: built {KERNEL_SOURCE} and {RASTER_SOURCE} in {time.perf_counter() - t0:.2f} s")
    for source, log in zip((KERNEL_SOURCE, RASTER_SOURCE), logs):
        print(f"phase 0: ptxas report of {source}:")
        for line in log.strip().splitlines():
            print(f"    {line}")
    reports = kernel_reports(part_crop_head.load_library()[0]._name, logs[0])
    for name, r in reports.items():
        print(f"phase 0: K1 {name}: {r['registers']} registers, {r['spill_stores']} bytes of spill stores, "
              f"{r['mma']} tensor-core instructions (HMMA/HGMMA) in the SASS")
    tc = {}
    for kind, chunks in (("bf16", part_crop_head.BF16_CHUNKS), ("f32", part_crop_head.F32_CHUNKS)):
        for chunk in chunks:   # the bf16 and the fp32 (3xTF32) kernel's instances, one per channel chunk
            name = f"part_crop_head_{kind}_kernel<{chunk}>"
            r = tc[name] = reports.get(name)
            check(r is not None and r["mma"] > 0 and r["spill_stores"] == 0,
                  f"the {kind} K1 kernel {name} runs on the tensor cores and spills nothing: {r}")
    r = reports.get("part_crop_head_kernel<double>")
    check(r is not None and r["mma"] == 0, f"the f64 K1 kernel is the scalar one: {r}")
    return tc


def import_probe() -> dict:
    """{module: version, or why it does not import} for the optional modules
    the port's host code may use: yaml (`config.load_config`), PIL (JPEG
    images) and torchvision (unused)."""
    import importlib

    out = {}
    for name in ("yaml", "PIL", "torchvision"):
        try:
            out[name] = getattr(importlib.import_module(name), "__version__", "imports (no __version__)")
        except ImportError as e:
            out[name] = f"does not import ({e})"
    if not out["PIL"].startswith("does not"):
        from PIL import features

        out["PIL"] += f", JPEG decoder {features.check('jpg')}"
    return out


def kernel_reports(lib_path: str, log: str) -> dict:
    """{K1 kernel: {registers, spill_stores, mma}} from the ptxas report and
    the count of HMMA/HGMMA instructions in cuobjdump's SASS of the library."""
    from danet_densepose2smpl_tpu_torch.kernels.build import find_nvcc

    def short(mangled):
        m = re.search(r"part_crop_head_(bf16|f32)_kernelILi(\d+)E", mangled)   # one instance per channel chunk
        if m:
            return f"part_crop_head_{m.group(1)}_kernel<{m.group(2)}>"
        m = re.search(r"part_crop_head_kernelI([fd])E", mangled)
        return f"part_crop_head_kernel<{'float' if m.group(1) == 'f' else 'double'}>" if m else mangled

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = short(m.group(1))
            out[name] = {"registers": None, "spill_stores": None, "mma": 0}
        elif name and (m := re.search(r"(\d+) bytes spill stores", line)):
            out[name]["spill_stores"] = int(m.group(1))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name]["registers"] = int(m.group(1))
    cuobjdump = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", lib_path], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    fn = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = short(m.group(1))
        elif fn in out and re.search(r"\bH(G)?MMA\b", line):
            out[fn]["mma"] += 1
    return out


def phase1_kernel_vs_plain(dev):
    from danet_densepose2smpl_tpu_torch.kernels.part_crop_head import (
        fused_part_predict,
        part_crop_head_plain,
    )

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cases = [("float32", torch.float32, 8, 56, 48, 21), ("bfloat16", torch.bfloat16, 8, 56, 48, 21),
             ("float64", torch.float64, 2, 16, 8, 21),
             # nothing a multiple of the tensor-core kernel's tiles
             ("bfloat16", torch.bfloat16, 1, 57, 8, 5), ("bfloat16", torch.bfloat16, 1, 57, 20, 5)]
    for name, dt, b, hw, c, o in cases:
        for dense in (False, True):
            feats, wy, wx, kernel, bias = k1_inputs(b, hw, hw, c, hw, dt, dev, seed=1, dense=dense, o=o)
            got = fused_part_predict(feats, wy, wx, kernel, bias, hw)
            torch.cuda.synchronize()
            ref = part_crop_head_plain(feats, wy, wx, kernel, bias, hw)
            err = (got.double() - ref.double()).abs().max().item()
            ref_max = ref.double().abs().max().item()
            tol = {"float32": 1e-4, "bfloat16": 2e-2 * ref_max, "float64": 1e-10}[name]
            weights = "dense" if dense else "bilinear"
            print(f"phase 1: K1 {name} B={b} {hw}x{hw}x{c} S={hw} O={o} {weights} weights: max abs err "
                  f"{err!r} (max|ref| {ref_max!r}, tolerance {tol!r})")
            check(got.shape == (b, 24, hw, hw, o) and bool(torch.isfinite(got).all()),
                  f"K1 {name} output shape/finite")
            check(err <= tol, f"K1 {name} {weights}: {err} > {tol}")


def phase2_slice_f64(dev):
    from danet_densepose2smpl_tpu_torch.kernels.part_crop_head import fused_part_predict
    from danet_densepose2smpl_tpu_torch.models.danet import DaNet
    from danet_densepose2smpl_tpu_torch.serve import random_init_
    from danet_densepose2smpl_tpu_torch.smpl.loader import synthetic_smpl_model, to_torch
    from danet_densepose2smpl_tpu_torch.smpl.model import smpl_forward

    cpu_model = random_init_(DaNet(), seed=0).double()
    gpu_model = copy.deepcopy(cpu_model).to(dev, memory_format=torch.channels_last)
    smpl = synthetic_smpl_model()
    x = torch.from_numpy(np.random.RandomState(3).rand(2, 224, 224, 3))
    outs = {}
    for where, model, d in (("cpu", cpu_model, torch.device("cpu")), ("cuda", gpu_model, dev)):
        before = fused_part_predict.launches
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = model(x.to(d))
            verts = smpl_forward(to_torch(smpl, d, torch.float64), out["pred_shape"],
                                 out["pred_rotmat"]).vertices
        if d.type == "cuda":
            torch.cuda.synchronize()
            check(fused_part_predict.launches > before, "the f64 slice on the card launched K1")
        outs[where] = (out["para"].cpu(), verts.cpu())
        print(f"phase 2: f64 slice on {where}: {time.perf_counter() - t0:.2f} s")
    for i, name in enumerate(("para", "vertices")):
        a, b = outs["cuda"][i], outs["cpu"][i]
        check(bool(torch.isfinite(a).all()), f"f64 {name} finite")
        err = (a - b).abs().max().item()
        print(f"phase 2: {name} {tuple(a.shape)} card vs CPU max abs err {err!r} "
              f"(max|cpu| {b.abs().max().item()!r})")
        check(torch.allclose(a, b, atol=1e-6, rtol=1e-9), f"f64 {name} card vs CPU")

    # fp32 serving on the card against the f64 CPU result, at the weight
    # bridge's fp32 bar (tests/test_port_e2e.py::test_e2e_port_resnet_f32:
    # atol 0.05, rtol 1e-3): the model alone under PyTorch's TF32 defaults
    # (cuDNN convolutions may use TF32, matmuls not), for the record, then
    # `Predictor`, which turns TF32 off for fp32
    from danet_densepose2smpl_tpu_torch.serve import Predictor

    predictor = Predictor(dev, torch.float32, seed=0)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    try:
        with torch.inference_mode():
            tf32 = predictor.model(x.to(dev, torch.float32))["para"].double().cpu()
        para32 = predictor.predict(x.float())["para"].double().cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    ref = outs["cpu"][0]
    print(f"phase 2: fp32 on the card vs f64 on the CPU, para max abs err: the model under PyTorch's TF32 defaults "
          f"{(tf32 - ref).abs().max().item()!r} (within the bar: {torch.allclose(tf32, ref, atol=0.05, rtol=1e-3)}); "
          f"Predictor (TF32 off) {(para32 - ref).abs().max().item()!r} (bar: atol 0.05, rtol 1e-3; with the scalar "
          f"fp32 K1 kernel {FP32_SERVING_ERR_WAS['w48']!r}, {FP32_SERVING_ERR_WAS['run']})")
    check(bool(torch.isfinite(para32).all()) and torch.allclose(para32, ref, atol=0.05, rtol=1e-3),
          "fp32 serving para card vs f64 CPU")


def phase3_serving(dev, card) -> int:
    from danet_densepose2smpl_tpu_torch.kernels.part_crop_head import fused_part_predict
    from danet_densepose2smpl_tpu_torch.serve import Predictor

    predictor = Predictor(dev, torch.bfloat16, seed=0)
    images = torch.from_numpy(
        np.random.RandomState(5).rand(SERVE_BATCH, 224, 224, 3).astype(np.float32)
    ).to(dev, torch.bfloat16)
    predictor.predict(images)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()

    fused_part_predict.launches = 0
    t0 = time.perf_counter()
    outs = [predictor.predict(images) for _ in range(SERVE_REQUESTS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = fused_part_predict.launches

    shapes = {"para": (SERVE_BATCH, 229), "pred_cam": (SERVE_BATCH, 3), "pred_shape": (SERVE_BATCH, 10),
              "pred_rotmat": (SERVE_BATCH, 24, 3, 3), "vertices": (SERVE_BATCH, 6890, 3),
              "joints": (SERVE_BATCH, 49, 3)}
    for out in outs:
        for key, shape in shapes.items():
            check(tuple(out[key].shape) == shape, f"serving {key} shape {tuple(out[key].shape)}")
            check(bool(torch.isfinite(out[key]).all()), f"serving {key} finite")
    check(launches >= SERVE_REQUESTS, f"K1 launched {launches} times for {SERVE_REQUESTS} requests")
    print(f"phase 3: served {SERVE_REQUESTS} requests of B={SERVE_BATCH} bf16 in {dt!r} s: "
          f"{SERVE_BATCH * SERVE_REQUESTS / dt!r} imgs/s (host clock, ends in synchronize); "
          f"K1 launches {launches}; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; card {card}")
    profile_request(lambda: predictor.predict(images), SERVE_BATCH, card)

    big = torch.from_numpy(
        np.random.RandomState(6).rand(SERVE_BIG_BATCH, 224, 224, 3).astype(np.float32)
    ).to(dev, torch.bfloat16)
    predictor.predict(big)  # warm-up at this batch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [predictor.predict(big) for _ in range(SERVE_BIG_REQUESTS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for out in outs:
        for key, shape in shapes.items():
            shape = (SERVE_BIG_BATCH, *shape[1:])
            check(tuple(out[key].shape) == shape and bool(torch.isfinite(out[key]).all()),
                  f"serving B={SERVE_BIG_BATCH} {key}")
    print(f"phase 3: served {SERVE_BIG_REQUESTS} requests of B={SERVE_BIG_BATCH} bf16 in {dt!r} s: "
          f"{dt / SERVE_BIG_REQUESTS * 1e3!r} ms a request, {SERVE_BIG_BATCH * SERVE_BIG_REQUESTS / dt!r} imgs/s "
          f"(host clock, ends in synchronize; after one warm-up request); card {card}")
    profile_request(lambda: predictor.predict(big), SERVE_BIG_BATCH, card)
    return launches


def profile_request(fn, batch: int, card) -> None:
    """One serving request under torch.profiler: host time, kernel time and
    the card's idle share, by range (serve.model, serve.smpl), and K1's
    device time inside it."""
    events = profile_ranges(fn, "serve.", f"one bf16 request of B={batch}", card)
    k1_ms = sum(e.self_device_time_total for e in events if "part_crop_head_bf16_kernel" in e.key) / 1e3
    print(f"profile: K1 (part_crop_head_bf16_kernel) inside it: {k1_ms!r} ms on the card")


def phase4_timing(dev, card) -> dict:
    from danet_densepose2smpl_tpu_torch.kernels.part_crop_head import (
        bf16_plan,
        fused_part_predict,
        part_crop_head_plain,
    )
    from danet_densepose2smpl_tpu_torch.nn.iuv_head import PartialIUVHead
    from danet_densepose2smpl_tpu_torch.ops.imwarp import separable_crop_concat

    args, centers, scales = k1_inputs(SERVE_BATCH, 56, 56, 48, 56, torch.bfloat16, dev, seed=2, boxes=True)
    feats, _, _, kernel, bias = args
    # the unfused route the port has (the training path's): the crops in
    # device memory, then cuDNN's grouped conv, with K1's weights
    head = PartialIUVHead(48).to(dev, torch.bfloat16, memory_format=torch.channels_last)
    head.weight.data.copy_(kernel.permute(3, 2, 0, 1))
    head.bias.data.copy_(bias)
    crops = separable_crop_concat(feats, centers, scales, 56).permute(0, 3, 1, 2)
    calls = {
        "kernel": lambda: fused_part_predict(*args, 56),
        "plain": lambda: part_crop_head_plain(*args, 56),
        "unfused": lambda: head(separable_crop_concat(feats, centers, scales, 56).permute(0, 3, 1, 2)),
        "unfused conv": lambda: head(crops),
    }
    times = {name: [] for name in calls}
    with torch.no_grad():
        for name in ("plain", "kernel", "unfused", "unfused conv", "unfused conv", "unfused", "kernel", "plain"):
            times[name].append(cuda_ms(calls[name], 5 if name == "plain" else 20))
        by_kernel = device_ms_by_kernel(calls["kernel"], 10)
        alone = [v for key, v in by_kernel.items() if "part_crop_head_bf16_kernel" in key]
        check(len(alone) == 1, f"the profiler sees the bf16 kernel: {by_kernel}")
        ms = {name: min(t) for name, t in times.items()}
        print(f"phase 4: K1 B={SERVE_BATCH} bf16 (CUDA events, mean of 20 calls, plain 5, after a warm-up, in turns; "
              f"TF32 off): kernel {times['kernel']} ms, plain {times['plain']} ms, unfused route "
              f"{times['unfused']} ms, its conv alone {times['unfused conv']} ms; the kernel alone on the card "
              f"(torch.profiler, 10 calls) {alone[0]!r} ms; card {card}")
        # the same check as phase 1, at the batch and dtype the serving path uses
        got, ref = calls["kernel"]().double(), calls["plain"]().double()
        unfused = calls["unfused"]().reshape(got.shape).double()
    err, ref_max = (got - ref).abs().max().item(), ref.abs().max().item()
    err_u = (unfused - ref).abs().max().item()
    print(f"phase 4: K1 vs plain at B={SERVE_BATCH} bf16: max abs err {err!r} (max|ref| {ref_max!r}, "
          f"tolerance {2e-2 * ref_max!r}); the unfused route vs plain {err_u!r}")
    check(err <= 2e-2 * ref_max, f"K1 bf16 B={SERVE_BATCH}: {err} > {2e-2 * ref_max}")
    check(err_u <= 2e-2 * ref_max, f"the unfused route computes K1's function: {err_u}")
    bound_ms, bound_by = k1_bound(args, 56)
    plan = bf16_plan(56, 56, 48, 56, 21)
    print(f"phase 4: K1 bound {bound_ms!r} ms ({bound_by}); tile rows and channel chunk {plan}; library call: none "
          f"(no one PyTorch call computes the crop and the grouped conv)")
    # the launch alone, beside the A/B recorded against the earlier library
    launch = k1_launch(args, 56, plan)
    launch_ms = [cuda_ms(launch, 20) for _ in range(12)]
    was_ms, this_ms, was = K1_AB_MS
    print(f"phase 4: C=48 launch alone (weights packed once), 12 turns of 20 calls: median "
          f"{float(np.median(launch_ms))!r} ms of {launch_ms}; recorded A/B ({was}): the earlier library "
          f"{was_ms} ms, this kernel {this_ms} ms; card {card}")
    return {"ms": ms["kernel"], "plain_ms": ms["plain"], "max_abs_err": err, "bound_ms": bound_ms,
            "bound_by": bound_by, "unfused_ms": ms["unfused"], "unfused_conv_ms": ms["unfused conv"],
            "device_ms": alone[0], "plan": plan}


def cuda_ms(fn, n):
    """Mean ms per call of `fn()` over `n` calls after one warm-up, CUDA events."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def tie_scene(dev):
    """4,000 faces, one image at S=16: face 0 is back-facing (dead), face 1
    the same triangle wound the other way (live), both at z = 4 with dyadic
    barycentrics, so their depths tie exactly; the other faces lie behind
    the camera. With fewer live faces than the culled budget, face 0 fills
    the compacted prefix after face 1, and face 1 must win the tie."""
    n = 4000
    verts = torch.zeros(1, 3 * n, 3, device=dev)
    verts[0, :3] = torch.tensor([[0.0, 0.0, 4.0], [8.0, 0.0, 4.0], [0.0, 8.0, 4.0]])
    verts[0, 3:, 2] = -1.0
    faces = torch.arange(3 * n, device=dev).reshape(n, 3)
    faces[1] = torch.tensor([0, 2, 1])
    tex = torch.from_numpy(np.random.RandomState(0).rand(n, 3).astype(np.float32) + 0.5).to(dev)
    return verts, faces, tex


def phase5_raster(dev, card) -> dict:
    from danet_densepose2smpl_tpu_torch.config import Config
    from danet_densepose2smpl_tpu_torch.data.synthetic import synthetic_raw_batch
    from danet_densepose2smpl_tpu_torch.kernels import rasterizer as R
    from danet_densepose2smpl_tpu_torch.smpl.densepose_atlas import (
        closed_synthetic_atlas,
        closed_test_mesh,
        synthetic_densepose_atlas,
    )
    from danet_densepose2smpl_tpu_torch.smpl.loader import synthetic_smpl_model, to_torch
    from danet_densepose2smpl_tpu_torch.train.prepare import prepare_targets
    from danet_densepose2smpl_tpu_torch.train.step import batch_to_device

    cfg = Config()
    smpl = synthetic_smpl_model()
    raw = posed_keypoints(cfg, smpl, synthetic_raw_batch(cfg, RASTER_BATCH, seed=1), seed=2)
    prep = prepare_targets(cfg, to_torch(smpl, dev), batch_to_device(raw, dev))
    verts, cam = prep["target_verts"], prep["target_cam"]
    soup = R.IUVRenderer(synthetic_densepose_atlas(smpl), 224, 56)
    closed_atlas, template = closed_synthetic_atlas(smpl.num_verts)
    closed = R.IUVRenderer(closed_atlas, 224, 56, cull_verts=template)
    check(closed.cull, "the closed atlas orients with no conflicted edge")
    ts, _, vpx_s = soup.project(verts, cam)
    tc, dp_c, vpx_c = closed.project(verts, cam)
    fs, texs, fc, texc = ts["faces"], ts["face_tex"], tc["faces"], tc["face_tex"]
    mask = R.backface_mask(dp_c, cam, fc)
    live = closed.live_fraction(verts, cam)
    budget = R.cull_budget(fc.shape[0], 1024, 0.55)
    culled_skip, filler = R.culled_face_sets(vpx_c, fc, budget)
    # the closed test mesh (local faces, the real SMPL mesh's kind) at the training shape
    mesh_v, mesh_f = closed_test_mesh(smpl.num_verts)
    rng = np.random.RandomState(33)
    mesh_b = np.stack([mesh_v * (1 + 0.1 * rng.randn()) + rng.randn(3) * 0.05 for _ in range(RASTER_BATCH)])
    vpx_m = R.project_weak_perspective(torch.as_tensor(mesh_b, dtype=torch.float32, device=dev),
                                       torch.tensor([[0.9, 0.02, -0.03]], device=dev).expand(RASTER_BATCH, 3))
    fm = torch.as_tensor(mesh_f.astype(np.int64), device=dev)
    texm = torch.as_tensor(rng.rand(len(mesh_f), 3).astype(np.float32) * 0.9 + 0.1, device=dev)
    print(f"phase 5: B={RASTER_BATCH} S=56 F={fs.shape[0]}; fitted camera scale min {cam[:, 0].min().item()!r} "
          f"max {cam[:, 0].max().item()!r}; closed atlas live_fraction min {live.min().item()!r} mean "
          f"{live.mean().item()!r} max {live.max().item()!r} (budget {budget} faces = "
          f"{budget / fc.shape[0]!r}); backface_mask culls {mask.float().mean().item()!r} of the faces")
    chunk = 128   # the plain version's (B, S*S, chunk) temporaries
    tv, tf, tt = tie_scene(dev)
    half = TRAIN_BATCH

    # key: (what, kernel, plain, the kernel's inputs as R._launch takes them, or None: not timed)
    runs = {
        "a": ("soup atlas, rasterize_flat",
              lambda: R.rasterize_flat(vpx_s, fs, texs, 56),
              lambda: R.rasterize_flat_plain(vpx_s, fs, texs, 56, chunk=chunk),
              (vpx_s, fs, texs, {})),
        "a64": (f"closed atlas, rasterize_flat (the 'pallas' backend's call), B={half}",
                lambda: R.rasterize_flat(vpx_c[:half], fc, texc, 56),
                lambda: R.rasterize_flat_plain(vpx_c[:half], fc, texc, 56, chunk=chunk),
                (vpx_c[:half], fc, texc, {})),
        "b": ("closed atlas, rasterize_flat_culled",
              lambda: R.rasterize_flat_culled(vpx_c, fc, texc, 56, 224.0, 1024, 0.55),
              lambda: R.rasterize_flat_culled_plain(vpx_c, fc, texc, 56, 224.0, chunk, 0.55),
              (vpx_c, fc, texc, {"skip": culled_skip, "ties_last": filler})),
        "b64": (f"closed atlas, rasterize_flat_culled, B={half}",
                lambda: R.rasterize_flat_culled(vpx_c[:half], fc, texc, 56, 224.0, 1024, 0.55),
                lambda: R.rasterize_flat_culled_plain(vpx_c[:half], fc, texc, 56, 224.0, chunk, 0.55),
                (vpx_c[:half], fc, texc, {"skip": culled_skip[:half], "ties_last": filler[:half]})),
        "c": ("closed atlas, rasterize_flat_masked with backface_mask",
              lambda: R.rasterize_flat_masked(vpx_c, fc, texc, 56, cull_mask=mask),
              lambda: R.rasterize_flat_plain(vpx_c, fc, texc, 56, chunk=chunk, skip=mask),
              (vpx_c, fc, texc, {"skip": mask})),
        "c64": (f"closed atlas, rasterize_flat_masked with backface_mask, B={half} (the main path's batch)",
                lambda: R.rasterize_flat_masked(vpx_c[:half], fc, texc, 56, cull_mask=mask[:half]),
                lambda: R.rasterize_flat_plain(vpx_c[:half], fc, texc, 56, chunk=chunk, skip=mask[:half]),
                (vpx_c[:half], fc, texc, {"skip": mask[:half]})),
        "d": ("soup atlas, rasterize_flat, f64, B=2",
              lambda: R.rasterize_flat(vpx_s[:2].double(), fs, texs, 56),
              lambda: R.rasterize_flat_plain(vpx_s[:2].double(), fs, texs, 56, chunk=chunk), None),
        "e": ("closed test mesh, rasterize_flat",
              lambda: R.rasterize_flat(vpx_m, fm, texm, 56),
              lambda: R.rasterize_flat_plain(vpx_m, fm, texm, 56, chunk=chunk),
              (vpx_m, fm, texm, {})),
        "t": ("exact depth tie, live vs filler face, rasterize_flat_culled",
              lambda: R.rasterize_flat_culled(tv, tf, tt, 16, 16.0, 1024, 0.55),
              lambda: R.rasterize_flat_culled_plain(tv, tf, tt, 16, 16.0, 1024, 0.55), None),
    }
    errs = {}
    for key, (what, kernel, plain, _) in runs.items():
        got = kernel()
        torch.cuda.synchronize()
        exp = plain()
        off = (got != exp).any(-1)
        n_off, frac = int(off.sum()), off.float().mean().item()
        shown = (exp[..., 0] > 0).float()
        cover, empty = shown.mean().item(), int((shown.mean((1, 2)) == 0).sum())
        err = (got.double() - exp.double()).abs().max().item()
        errs[key] = err
        print(f"phase 5: ({key}) {what}: {n_off} of {off.numel()} pixels differ ({frac!r}), "
              f"max abs err {err!r}, foreground {cover!r}, {empty} empty images of {got.shape[0]}")
        check(tuple(got.shape) == tuple(exp.shape) and bool(torch.isfinite(got).all()), f"raster ({key}) shape")
        check(frac <= PIXELS_OFF_MAX, f"raster ({key}): {frac} of the pixels differ")
        check(cover > 0.02 and empty == 0, f"raster ({key}): foreground {cover}, {empty} empty images")
    tie = runs["t"][1]()[0][runs["t"][2]()[0, ..., 0] > 0]
    check(bool((tie == tt[1]).all()), "the exact tie goes to the live face")

    # times, in turns: the entry (the pair kernel), its plain version, and the
    # tile kernel that fp64 runs (the yardstick of the pair kernel)
    times = {}
    for key, (what, kernel, plain, spec) in runs.items():
        if spec is None:
            continue
        v, f, tex, kw = spec
        tiles = lambda: R._launch(v, f, tex, 56, 224.0, route="tiles", **kw)   # noqa: E731
        check(torch.equal(kernel(), tiles()), f"raster ({key}): the pair kernel and the tile kernel differ")
        t = {"plain": [], "kernel": [], "tiles": []}
        for turn in ("plain", "kernel", "tiles", "tiles", "kernel", "plain"):
            t[turn].append(cuda_ms(plain, 1) if turn == "plain" else cuda_ms(kernel if turn == "kernel" else tiles, 20))
        _, pairs = R._launch(v, f, tex, 56, 224.0, with_pairs=True, **kw)
        pairs = int(pairs.item())
        mirror, stats = pair_stats(v, f, 56, kw.get("skip"))
        exact = exact_box_pairs(v, f, 56, skip=kw.get("skip"))
        bnd = raster_bound(v, f, tex, 56, skip=kw.get("skip"))
        times[key] = (min(t["kernel"]), min(t["plain"]), bnd)
        print(f"phase 5: ({key}) B={v.shape[0]} fp32 {what}: kernel {t['kernel']} ms, tile kernel {t['tiles']} ms, "
              f"plain {t['plain']} ms (CUDA events, mean of 20 / 1 call after a warm-up, turns "
              f"plain/kernel/tiles/tiles/kernel/plain, plain chunk {chunk}); bound {bnd!r} (ms, by); "
              f"library call: none; card {card}")
        print(f"phase 5: ({key}) pairs the kernel enumerated {pairs} (pixel_spans: {mirror}), in the exact boxes "
              f"(raster_bound) {exact}: {pairs / max(exact, 1)!r}x; {stats}")
        check(pairs == mirror, f"raster ({key}): the kernel's pairs {pairs} != pixel_spans' {mirror}")
        check(pairs >= exact, f"raster ({key}): {pairs} pairs enumerated < {exact} in the exact boxes")
    return {"rasterize_flat": (*times["a64"][:2], errs["a64"], *times["a64"][2]),
            "rasterize_flat_masked": (*times["c64"][:2], errs["c64"], *times["c64"][2])}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, n_ops: float, kind: str) -> tuple[float, str]:
    """(ms, 'bytes' or 'operations'): the least time of the H100 for work
    that moves `n_bytes` and does `n_ops` operations of `kind`."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = n_ops / PEAK_OPS_PER_S[kind] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def k1_bound(args, s, route: str = "bf16") -> tuple[float, str]:
    """K1's inputs and output once, and its operations on these inputs: the
    separable crop over the interpolation matrices' nonzeros (the kernel
    skips zeros) and the grouped 3x3 conv, at the peak of the route: 'bf16'
    (both on the bf16 tensor cores), 'tf32x3' (the fp32 kernel: the crop on
    the CUDA cores, the conv as three TF32 passes on the tensor cores) or
    'fp32' (both as FMAs on the CUDA cores)."""
    feats, wy, wx, kernel, bias = args
    b, h, w, c = feats.shape
    o = kernel.shape[-1] // 24
    crop = 2 * c * (w * int((wy != 0).sum()) + s * int((wx != 0).sum()))
    conv = 2 * b * 24 * s * s * o * 9 * c
    n_bytes = nbytes(*args) + b * 24 * s * s * o * feats.element_size()
    if route == "bf16":
        return bound(n_bytes, crop + conv, "bf16")
    passes, kind = (3, "tf32") if route == "tf32x3" else (1, "fp32")
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = (crop / PEAK_OPS_PER_S["fp32"] + passes * conv / PEAK_OPS_PER_S[kind]) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def exact_box_pairs(verts_px, faces, s, orig_size=224.0, skip=None) -> int:
    """(pixel centre, face) pairs whose centre lies in the face's exact
    bounding box, over the faces that can cover a pixel (not skipped)."""
    from danet_densepose2smpl_tpu_torch.kernels import rasterizer as R

    tri = verts_px[:, faces, :]
    box = R.face_boxes(tri[..., :2].float() * (s / orig_size), tri[..., 2])
    shown = box[..., 0] < 1e30
    if skip is not None:
        shown &= ~skip
    # pixel centres j + 0.5 inside [box min + 1, box max - 1] (face_boxes widens by a pixel)
    lo, hi = (box[..., 0::2] + 0.5).ceil().clamp(0, s), (box[..., 1::2] - 1.5).floor().add(1).clamp(0, s)
    return int(((hi - lo).clamp_min(0).prod(-1) * shown).sum().item())


def raster_bound(verts_px, faces, face_tex, s, orig_size=224.0, skip=None) -> tuple[float, str]:
    """A raster's inputs and output once, and RASTER_OPS_PER_CANDIDATE fp32
    operations for each (pixel centre, face) pair whose pixel centre lies
    in the face's bounding box, over the faces that can cover a pixel."""
    pairs = exact_box_pairs(verts_px, faces, s, orig_size, skip)
    out_bytes = verts_px.shape[0] * s * s * face_tex.shape[-1] * face_tex.element_size()
    inputs = nbytes(verts_px, faces, face_tex) + (nbytes(skip) if skip is not None else 0)
    return bound(inputs + out_bytes, pairs * RASTER_OPS_PER_CANDIDATE, "fp32")


def pair_stats(verts_px, faces, s, skip=None, orig_size=224.0) -> tuple[int, str]:
    """(the pairs the pair kernel enumerates, by `pixel_spans`; a line on
    how they spread over the faces)."""
    from danet_densepose2smpl_tpu_torch.kernels import rasterizer as R

    tri = verts_px[:, faces, :]
    _, count = R.pixel_spans(tri[..., :2].float() * (s / orig_size), tri[..., 2], s, skip)
    busy = count[count > 0].double()
    q = torch.quantile(busy[:: max(1, busy.numel() // 1_000_000)], torch.tensor([0.5, 0.99], device=busy.device,
                                                                                dtype=torch.float64)).tolist()
    return int(count.sum()), (f"pairs per face with any: median {q[0]!r}, p99 {q[1]!r}, largest "
                              f"{int(busy.max())}, mean {busy.mean().item()!r}; faces with none "
                              f"{(count == 0).double().mean().item()!r}")


def phase6_step_f64(dev):
    from danet_densepose2smpl_tpu_torch.config import Config, DaNetConfig
    from danet_densepose2smpl_tpu_torch.data.synthetic import synthetic_raw_batch
    from danet_densepose2smpl_tpu_torch.kernels import rasterizer as R
    from danet_densepose2smpl_tpu_torch.models.danet import DaNet
    from danet_densepose2smpl_tpu_torch.serve import random_init_
    from danet_densepose2smpl_tpu_torch.smpl.densepose_atlas import synthetic_densepose_atlas
    from danet_densepose2smpl_tpu_torch.smpl.loader import synthetic_smpl_model
    from danet_densepose2smpl_tpu_torch.train.step import batch_to_device, create_train_state, make_train_step

    cfg = Config(danet=DaNetConfig(img_size=64, heatmap_size=16, partdrop_rate=0.0,
                                   stn_center_jitter=0.0, stn_scale_jitter=0.0))
    smpl = synthetic_smpl_model()
    atlas = synthetic_densepose_atlas(smpl)
    raw = posed_keypoints(cfg, smpl, synthetic_raw_batch(cfg, 4, seed=2), seed=3)
    base = random_init_(DaNet(cfg.danet), seed=0).double()
    res = {}
    for where, d in (("cpu", torch.device("cpu")), ("cuda", dev)):
        model = copy.deepcopy(base).to(d)
        state = create_train_state(model, cfg)
        step = make_train_step(model, smpl, cfg, renderer=R.IUVRenderer(atlas, 64, 16))
        batch = batch_to_device(raw, d, torch.float64)
        R.rasterize_flat.launches = R.rasterize_flat_masked.launches = 0
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        if d.type == "cuda":
            torch.cuda.synchronize()
            launches = (R.rasterize_flat.launches, R.rasterize_flat_masked.launches)
            check(launches[0] >= 1, f"the f64 step on the card launched rasterize_flat: {launches}")
        print(f"phase 6: f64 step on {where}: {time.perf_counter() - t0:.2f} s, "
              f"loss_total {metrics['loss_total'].item()!r}")
        res[where] = ({k: v.item() for k, v in metrics.items()},
                      {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                      {n: p.detach().cpu() for n, p in model.named_parameters()})
    print(f"phase 6: raster launches (rasterize_flat, rasterize_flat_masked) in the card's step: {launches}")
    (lc, gc, pc), (lg, gg, pg) = res["cpu"], res["cuda"]
    check(lc.keys() == lg.keys(), "the same loss terms")
    loss_err = max(abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-30) for k in lc if lc[k] != 0)
    check(all(lg[k] == 0 for k in lc if lc[k] == 0), "zero loss terms stay zero")
    # a gradient may differ by 1e-9 of its tensor's largest entry plus 1e-12
    # (the heatmap head's bias has an exact gradient of 0, ~1e-15 in floats)
    grad_err = max((gg[n] - gc[n]).abs().max().item() / (1e-9 * gc[n].abs().max().item() + 1e-12) for n in gc)
    # Adam's first update is lr * g / (|g| + 1e-8), a sign wherever |g| >> 1e-8:
    # tight where the gradient stands far above its error bar, else <= 2 lr
    lr = cfg.solver.base_lr
    param_err = max(torch.where(gc[n].abs() >= 1e-6 * gc[n].abs().max(), (pg[n] - pc[n]).abs(), 0.0)
                    .max().item() for n in pc)
    param_all = max((pg[n] - pc[n]).abs().max().item() for n in pc)
    print(f"phase 6: {len(lc)} loss terms, max rel err {loss_err!r} (tolerance 1e-9); {len(gc)} gradients, "
          f"worst err / (1e-9 max|grad| + 1e-12) {grad_err!r} (tolerance 1); params after Adam max abs err "
          f"{param_err!r} where |grad| >= 1e-6 max|grad| (tolerance 1e-9), {param_all!r} anywhere "
          f"(tolerance 2 lr = {2 * lr!r})")
    check(loss_err <= 1e-9, f"f64 losses card vs CPU: {loss_err}")
    check(grad_err <= 1.0, f"f64 gradients card vs CPU: {grad_err}")
    check(param_err <= 1e-9 and param_all <= 2 * lr + 1e-12, f"f64 params after Adam card vs CPU: {param_err}")


def profile_steps(step, state, batch, gen, card, n=2):
    """`n` train steps under torch.profiler: the stage ranges of
    `make_train_step` and the kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()   # inside: the profiler's start and its trace processing stay out
        for _ in range(n):
            step(state, batch, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    events = prof.key_averages()
    on_card = [e for e in events if e.device_type == DeviceType.CUDA]
    kernel_ms = sum(e.self_device_time_total for e in on_card
                    if not getattr(e, "is_user_annotation", False)
                    and not e.key.startswith(("train.", "Optimizer."))) / 1e3 / n
    print(f"profile: {n} bf16 steps B={TRAIN_BATCH}: {wall_ms!r} ms/step on the host clock (profiler on), "
          f"{kernel_ms!r} ms/step of kernel time; card {card}")
    for e in events:
        if e.key.startswith("train."):
            # the host-side range sums the kernels it launched; the same
            # range on the card spans its first to last kernel, gaps included
            kind = ("span on the card" if e.device_type == DeviceType.CUDA
                    else "kernels launched inside (the backward runs on autograd's thread)")
            print(f"profile: {e.key}: {e.device_time_total / 1e3 / n!r} ms/step, {kind}")
    print(events.table(sort_by="self_device_time_total", row_limit=25, max_name_column_width=60))


def profile_ranges(fn, prefix: str, what: str, card):
    """Run `fn()` once under torch.profiler; print its host-clock time, the
    kernel time inside it and the card's idle share, and for each
    `record_function` range whose name starts with `prefix`, the host time
    spent in it and the device time of the kernels launched inside it.
    Returns the profiler's `key_averages()`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernel_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
                    and not e.key.startswith(prefix)) / 1e3
    print(f"profile: {what}: {wall_ms!r} ms on the host clock (profiler on), {kernel_ms!r} ms of kernel time, "
          f"device idle {1 - kernel_ms / wall_ms!r}; card {card}")
    for e in events:
        if e.key.startswith(prefix) and e.device_type == DeviceType.CPU:
            print(f"profile: {e.key}: host {e.cpu_time_total / 1e3!r} ms, kernels launched inside "
                  f"{e.device_time_total / 1e3!r} ms, {e.count} calls")
    return events


def device_ms_by_kernel(fn, n) -> dict:
    """{kernel name (first 60 characters): ms per call of `fn()`} over `n`
    calls after one warm-up, from torch.profiler's device times: what the
    card spent, without the host's launch overhead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / 1e3 / n for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def raster_launches(fn):
    """Run `fn()` with the raster launch counts zeroed just before it; return
    (its result, {entry: launches} read just after it)."""
    from danet_densepose2smpl_tpu_torch.kernels import rasterizer as R

    R.rasterize_flat.launches = R.rasterize_flat_masked.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {"rasterize_flat": R.rasterize_flat.launches,
                 "rasterize_flat_masked": R.rasterize_flat_masked.launches}


def phase7_train_bf16(dev, card) -> dict:
    from danet_densepose2smpl_tpu_torch.config import Config, DaNetConfig
    from danet_densepose2smpl_tpu_torch.data.synthetic import synthetic_raw_batch
    from danet_densepose2smpl_tpu_torch.kernels import rasterizer as R
    from danet_densepose2smpl_tpu_torch.models.danet import DaNet
    from danet_densepose2smpl_tpu_torch.serve import random_init_
    from danet_densepose2smpl_tpu_torch.smpl.densepose_atlas import closed_synthetic_atlas
    from danet_densepose2smpl_tpu_torch.smpl.loader import synthetic_smpl_model, to_torch
    from danet_densepose2smpl_tpu_torch.train.prepare import prepare_targets
    from danet_densepose2smpl_tpu_torch.train.step import batch_to_device, create_train_state, make_train_step

    cfg = Config(danet=DaNetConfig(compute_dtype="bfloat16"))
    smpl = synthetic_smpl_model()
    atlas, template = closed_synthetic_atlas(smpl.num_verts)
    renderer = R.IUVRenderer(atlas, 224, 56, cull_verts=template)
    check(renderer.cull, "culling is on for the closed atlas")
    model = random_init_(DaNet(cfg.danet), seed=0).to(dev, memory_format=torch.channels_last)
    state = create_train_state(model, cfg)
    step = make_train_step(model, smpl, cfg, renderer=renderer)
    gen = torch.Generator(device=dev).manual_seed(0)
    batches = [batch_to_device(posed_keypoints(cfg, smpl, synthetic_raw_batch(cfg, TRAIN_BATCH, seed=10 + i),
                                               seed=20 + i), dev)
               for i in range(TRAIN_STEPS + 1)]
    state, warm = step(state, batches[0], gen)    # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    start = {n: p.detach().clone() for n, p in model.named_parameters()}

    # the main path: the training step as a user runs it, 5 steps timed
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    metrics, main = raster_launches(lambda: [step(state, b, gen)[1] for b in batches[1:]])
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    paths = {"main": main}
    pre, paths["pretrain_mode"] = raster_launches(
        lambda: make_train_step(model, smpl, cfg, renderer=renderer, pretrain_mode=True)(state, batches[0], gen)[1])
    other = {}
    for backend in ("pallas", "pallas_bandrange"):
        r = R.IUVRenderer(atlas, 224, 56, cull_verts=template, backend=backend)
        other[backend], paths[backend] = raster_launches(
            lambda: make_train_step(model, smpl, cfg, renderer=r)(state, batches[1], gen)[1])
    profile_steps(step, state, batches[2], gen, card)

    for i, m in enumerate([warm] + metrics + [pre] + list(other.values())):
        bad = [k for k, v in m.items() if not bool(torch.isfinite(v))]
        check(not bad, f"bf16 step {i}: non-finite {bad}")
    check("smpl_pose" not in pre and "loss_U" in pre, "pretrain_mode runs the IUV losses only")
    moved = max((p.detach() - start[n]).abs().max().item() for n, p in model.named_parameters())
    check(moved > 0, "the parameters moved")
    check(main["rasterize_flat_masked"] >= TRAIN_STEPS and main["rasterize_flat"] == 0,
          f"main path: raster launches {main} in {TRAIN_STEPS} steps")
    check(paths["pretrain_mode"]["rasterize_flat_masked"] >= 1, f"pretrain_mode: {paths['pretrain_mode']}")
    check(paths["pallas"]["rasterize_flat"] >= 1, f"the 'pallas' backend: {paths['pallas']}")
    check(paths["pallas_bandrange"]["rasterize_flat_masked"] >= 1,
          f"the 'pallas_bandrange' backend: {paths['pallas_bandrange']}")
    prep = prepare_targets(cfg, to_torch(smpl, dev), batches[1], renderer=renderer)
    live = renderer.live_fraction(prep["target_verts"], prep["target_cam"])
    cover = (prep["uv_image_gt"][..., 0] > 0).float().mean().item() if "uv_image_gt" in prep else None
    for i, m in enumerate([warm] + metrics):
        top = sorted(((v.item(), k) for k, v in m.items() if k != "loss_total"), reverse=True)[:3]
        print(f"phase 7: step {i} ({'warm-up' if i == 0 else 'timed'}): loss_total "
              f"{m['loss_total'].item()!r}; largest terms {[(k, v) for v, k in top]}")
    print(f"phase 7: bf16 train B={TRAIN_BATCH} 224 px: pretrain {pre['loss_total'].item()!r}, via 'pallas' "
          f"{other['pallas']['loss_total'].item()!r}, via 'pallas_bandrange' "
          f"{other['pallas_bandrange']['loss_total'].item()!r}; params moved up to {moved!r}; "
          f"live_fraction max {live.max().item()!r}; GT foreground {cover!r}")
    print(f"phase 7: {TRAIN_STEPS} steps in {dt!r} s: {TRAIN_BATCH * TRAIN_STEPS / dt!r} imgs/s "
          f"(host clock, ends in synchronize); {dt / TRAIN_STEPS * 1e3!r} ms/step; peak memory "
          f"{peak:.2f} GiB; raster launches by path {paths}; card {card}")
    return paths


def eval_batches(seed: int, n: int, b: int, res: int = 224) -> list:
    """`n` eval batches of `b` synthetic ImageNet-normalized images, each
    with its original frame (a shape of 200-400 px per side drawn from the
    seed, and a centre and scale whose box covers most of the shorter side,
    as a person crop does), GT pose and betas, gender, pose_3d and sample
    indices."""
    rng = np.random.RandomState(seed)
    mean, std = np.array([0.485, 0.456, 0.406]), np.array([0.229, 0.224, 0.225])
    out = []
    for i in range(n):
        shapes = rng.randint(200, 401, (b, 2))                       # (H, W)
        wh = shapes[:, ::-1].astype(np.float64)
        out.append({
            "img": ((rng.rand(b, res, res, 3) - mean) / std).astype(np.float32),
            "center": wh / 2 + rng.uniform(-0.1, 0.1, (b, 2)) * wh,
            "scale": shapes.min(1) / 200.0 * rng.uniform(0.8, 1.0, b),
            "orig_shape": shapes,
            "pose": (rng.randn(b, 72) * 0.2).astype(np.float32),
            "betas": (rng.randn(b, 10) * 0.3).astype(np.float32),
            "gender": rng.randint(0, 2, b).astype(np.int32),
            "pose_3d": np.concatenate([rng.randn(b, 24, 3) * 0.2, np.ones((b, 24, 1))], -1).astype(np.float32),
            "sample_index": np.arange(i * b, (i + 1) * b, dtype=np.int32),
        })
    return out


def phase8_eval(dev, card) -> dict:
    from danet_densepose2smpl_tpu_torch.config import Config
    from danet_densepose2smpl_tpu_torch.constants import H36M_TO_J14, J24_TO_J14
    from danet_densepose2smpl_tpu_torch.data.synthetic import synthetic_raw_batch
    from danet_densepose2smpl_tpu_torch.eval.harness import make_eval_step, run_pose_eval, synthetic_h36m_regressor
    from danet_densepose2smpl_tpu_torch.eval.lsp import run_lsp_eval
    from danet_densepose2smpl_tpu_torch.kernels import rasterizer as R
    from danet_densepose2smpl_tpu_torch.kernels.part_crop_head import fused_part_predict
    from danet_densepose2smpl_tpu_torch.kernels.part_renderer import vertex_parts_from_lbs
    from danet_densepose2smpl_tpu_torch.ops.rotations import batch_rodrigues
    from danet_densepose2smpl_tpu_torch.serve import Predictor
    from danet_densepose2smpl_tpu_torch.smpl.densepose_atlas import closed_test_mesh
    from danet_densepose2smpl_tpu_torch.smpl.loader import synthetic_smpl_model, to_torch
    from danet_densepose2smpl_tpu_torch.smpl.model import smpl_forward
    from danet_densepose2smpl_tpu_torch.train.prepare import prepare_targets
    from danet_densepose2smpl_tpu_torch.train.step import batch_to_device

    # (a) K3 against its plain version and the rasterize_flat kernel at 224 x 224
    # with PartRenderer's [silhouette, part] texture, on two meshes of the real
    # counts (6,890 vertices, 13,776 faces): the synthetic SMPL model under
    # posed cameras (its faces join random vertices: the LSP path's mesh
    # here), and the closed test mesh (local faces, the real SMPL mesh's kind)
    cfg = Config()
    smpl = synthetic_smpl_model()
    raw = posed_keypoints(cfg, smpl, synthetic_raw_batch(cfg, EVAL_BATCH, seed=30), seed=31)
    prep = prepare_targets(cfg, to_torch(smpl, dev), batch_to_device(raw, dev))
    part = vertex_parts_from_lbs(smpl)[smpl.faces[:, 0]].astype(np.float32)
    closed_v, closed_f = closed_test_mesh(smpl.num_verts)
    rng = np.random.RandomState(32)
    vb = np.stack([closed_v * (1 + 0.1 * rng.randn()) + rng.randn(3) * 0.05 for _ in range(EVAL_BATCH)])
    closed_part = 1 + np.clip((closed_v[closed_f[:, 0], 1] + 1.05) / 2.1 * 6, 0, 5).astype(np.int64)
    cam = torch.tensor([[0.9, 0.02, -0.03]], device=dev).expand(EVAL_BATCH, 3)
    meshes = {
        "synthetic SMPL": (R.project_weak_perspective(prep["target_verts"], prep["target_cam"], 224.0),
                           smpl.faces, part),
        "closed mesh": (R.project_weak_perspective(torch.as_tensor(vb, dtype=torch.float32, device=dev), cam, 224.0),
                        closed_f, closed_part.astype(np.float32)),
    }
    s = 224
    err, times = None, {}
    for mesh, (vpx, f, p) in meshes.items():
        faces = torch.as_tensor(f.astype(np.int64), device=dev)
        tex = torch.as_tensor(np.stack([np.ones_like(p), p], 1), device=dev)
        meshes[mesh] = (vpx, faces, tex)
        for what, v in ((f"fp32, B={EVAL_BATCH}", vpx), ("f64, B=2", vpx[:2].double())):
            got = R.rasterize_flat_banded(v, faces, tex, s)
            flat = R.rasterize_flat(v, faces, tex, s)
            torch.cuda.synchronize()
            plain = R.rasterize_flat_banded_plain(v, faces, tex, s, 224.0, 256)
            off = (got != plain).any(-1)
            frac = off.float().mean().item()
            shown = (plain[..., 0] > 0).float()
            cover, empty = shown.mean().item(), int((shown.mean((1, 2)) == 0).sum())
            e = (got.double() - plain.double()).abs().max().item()
            err = e if err is None else max(err, e)
            print(f"phase 8: (a) K3 {mesh}, {what}, S={s}, F={faces.shape[0]}: {int(off.sum())} of {off.numel()} "
                  f"pixels differ from the plain version ({frac!r}), max abs err {e!r}; bit-equal to the "
                  f"rasterize_flat kernel: {torch.equal(got, flat)}; foreground {cover!r}, {empty} empty images")
            check(tuple(got.shape) == (v.shape[0], s, s, 2) and bool(torch.isfinite(got).all()), f"K3 {what} shape")
            check(frac <= PIXELS_OFF_MAX, f"K3 {mesh} {what}: {frac} of the pixels differ from the plain version")
            check(torch.equal(got, flat), f"K3 {mesh} {what}: not bit-equal to the rasterize_flat kernel")
            check(cover > 0.02 and empty == 0, f"K3 {mesh} {what}: foreground {cover}, {empty} empty images")
        _, pairs = R._launch(vpx, faces, tex, s, 224.0, with_pairs=True)
        pairs = int(pairs.item())
        mirror, stats = pair_stats(vpx, faces, s)
        exact = exact_box_pairs(vpx, faces, s)
        print(f"phase 8: (a) {mesh}, B={EVAL_BATCH}: pairs the kernel enumerated {pairs} (pixel_spans: {mirror}), "
              f"in the exact boxes (raster_bound) {exact}: {pairs / max(exact, 1)!r}x; {stats}")
        check(pairs == mirror, f"K3 {mesh}: the kernel's pairs {pairs} != pixel_spans' {mirror}")
        check(pairs >= exact, f"K3 {mesh}: {pairs} pairs enumerated < {exact} in the exact boxes")

        # (b) times at B=16 fp32, in turns: the entry (the pair kernel), the
        # rasterize_flat entry, and the tile kernel (fp64's route, the pair
        # kernel's yardstick)
        calls = {
            "K3": lambda: R.rasterize_flat_banded(vpx, faces, tex, s),
            "rasterize_flat": lambda: R.rasterize_flat(vpx, faces, tex, s),
            "tiles": lambda: R._launch(vpx, faces, tex, s, 224.0, route="tiles"),
        }
        check(torch.equal(calls["tiles"](), calls["K3"]()), f"K3 {mesh}: the tile kernel differs from the entry")
        t = {k: [] for k in (*calls, "plain")}
        for turn in ("K3", "rasterize_flat", "tiles", "plain", "K3", "rasterize_flat", "tiles", "plain"):
            if turn == "plain":
                t[turn].append(cuda_ms(lambda: R.rasterize_flat_banded_plain(vpx, faces, tex, s, 224.0, 256), 1))
            else:
                t[turn].append(cuda_ms(calls[turn], 20))
        times[mesh] = t
        for name in ("K3", "rasterize_flat"):
            print(f"phase 8: (b) {mesh}, {name}: device time per call by kernel (torch.profiler, 10 calls): "
                  f"{device_ms_by_kernel(calls[name], 10)}")
        bnd = raster_bound(vpx, faces, tex, s)
        print(f"phase 8: (b) {mesh}, B={EVAL_BATCH} S={s} fp32: K3 {t['K3']} ms; "
              f"rasterize_flat {t['rasterize_flat']} ms; "
              f"tile kernel {t['tiles']} ms; plain (chunk 256) {t['plain']} ms (CUDA events, mean of 20 / 1 after a "
              f"warm-up, in turns); bound {bnd!r} (ms, by); library call: none; card {card}")
    vpx, faces, tex = meshes["synthetic SMPL"]
    bound_ms, bound_by = raster_bound(vpx, faces, tex, s)
    t = times["synthetic SMPL"]

    # (c) LSP eval through Predictor (bf16), both PartRenderer backends. Seed 1:
    # its random regressor predicts cameras that keep part of the body in the
    # crop (seed 0's predicted scale is negative, and every render is empty)
    predictor = Predictor(dev, torch.bfloat16, seed=1)
    batches = eval_batches(40, EVAL_BATCHES, EVAL_BATCH)

    def infer(img):
        return predictor.predict(img)["para"]

    para0 = infer(torch.from_numpy(batches[0]["img"]))     # warm-up
    cams = para0[:, :3]
    torch.cuda.synchronize()
    print(f"phase 8: (c) predicted cameras of batch 0: scale min {cams[:, 0].min().item()!r} max "
          f"{cams[:, 0].max().item()!r}")
    # the render the LSP eval pays: batch 0's predicted bodies, as PartRenderer projects them
    verts0 = smpl_forward(to_torch(smpl, dev, para0.dtype), para0[:, 3:13], para0[:, 13:].reshape(-1, 24, 3, 3))
    vpx0 = R.project_weak_perspective(verts0.vertices, cams, 224.0)
    _, faces_s, tex_s = meshes["synthetic SMPL"]
    img0 = R.rasterize_flat_banded(vpx0, faces_s, tex_s, s)
    check(torch.equal(img0, R.rasterize_flat(vpx0, faces_s, tex_s, s)),
          "K3 on the eval's predicted bodies: not bit-equal to the rasterize_flat kernel")
    check(torch.equal(img0, R._launch(vpx0, faces_s, tex_s, s, 224.0, route="tiles")),
          "K3 on the eval's predicted bodies: the pair kernel and the tile kernel differ")
    own_plain = lambda: R.rasterize_flat_banded_plain(vpx0, faces_s, tex_s, s, 224.0, 256)   # noqa: E731
    check(torch.equal(img0, own_plain()), "K3 on the eval's predicted bodies: not bit-equal to its plain version")
    own_calls = {"K3": lambda: R.rasterize_flat_banded(vpx0, faces_s, tex_s, s),
                 "rasterize_flat": lambda: R.rasterize_flat(vpx0, faces_s, tex_s, s),
                 "tiles": lambda: R._launch(vpx0, faces_s, tex_s, s, 224.0, route="tiles"), "plain": own_plain}
    own = {name: [] for name in own_calls}
    for name in ("K3", "rasterize_flat", "tiles", "plain", "plain", "tiles", "rasterize_flat", "K3"):
        own[name].append(cuda_ms(own_calls[name], 1 if name == "plain" else 20))
    _, pairs = R._launch(vpx0, faces_s, tex_s, s, 224.0, with_pairs=True)
    _, stats = pair_stats(vpx0, faces_s, s)
    print(f"phase 8: (c) the eval's render of batch 0's predicted bodies, B={EVAL_BATCH} S={s}: K3 {own['K3']} ms, "
          f"rasterize_flat {own['rasterize_flat']} ms, tile kernel {own['tiles']} ms, plain version (banded, on "
          f"the card, chunk 256) {own['plain']} ms (CUDA events, mean of 20 / 1 call, in turns); bound {raster_bound(vpx0, faces_s, tex_s, s)!r} (ms, by); foreground "
          f"{(img0[..., 0] > 0).float().mean().item()!r}; pairs enumerated {int(pairs.item())}, in the exact boxes "
          f"{exact_box_pairs(vpx0, faces_s, s)}; {stats}; card {card}")
    expected = {  # one K1 launch a batch; one raster launch for the prediction and one for the GT fallback
        "pallas_banded": {"part_crop_head": EVAL_BATCHES, "rasterize_flat_banded": 2 * EVAL_BATCHES,
                          "rasterize_flat": 0},
        "auto": {"part_crop_head": EVAL_BATCHES, "rasterize_flat_banded": 0, "rasterize_flat": 2 * EVAL_BATCHES},
    }
    results, counts = [], {}
    for backend in ("pallas_banded", "auto", "auto", "pallas_banded"):    # in turns
        fused_part_predict.launches = R.rasterize_flat.launches = R.rasterize_flat_banded.launches = 0
        t0 = time.perf_counter()
        results.append(run_lsp_eval(infer, enumerate(batches), smpl, backend=backend, log_every=0))
        dt = time.perf_counter() - t0          # the final metrics are read on the host: synchronized
        counts[backend] = {"part_crop_head": fused_part_predict.launches,
                           "rasterize_flat_banded": R.rasterize_flat_banded.launches,
                           "rasterize_flat": R.rasterize_flat.launches}
        print(f"phase 8: (c) LSP eval, PartRenderer('{backend}'), {EVAL_BATCHES} batches of B={EVAL_BATCH} "
              f"bf16: {EVAL_BATCHES * EVAL_BATCH / dt!r} imgs/s (host clock); launches {counts[backend]}; "
              f"{results[-1]}; card {card}")
        check(counts[backend] == expected[backend], f"LSP eval via '{backend}': launches {counts[backend]}")
    check(all(r == results[0] for r in results), "both backends, every run, print the same metrics")
    profile_ranges(lambda: run_lsp_eval(infer, enumerate(batches), smpl, backend="pallas_banded", log_every=0),
                   "lsp.", f"(c) LSP eval, PartRenderer('pallas_banded'), {EVAL_BATCHES} batches of B={EVAL_BATCH} "
                   "bf16", card)

    # (d) pose eval, h36m-p2, and the harness in f64 card against CPU
    jreg = synthetic_h36m_regressor(smpl.num_verts)
    acts = ("Walking", "Eating", "Posing", "Greeting")
    names = np.array([f"images/S9_{acts[i % 4]}.5427_{i:05d}.jpg" for i in range(EVAL_BATCHES * EVAL_BATCH)])
    fused_part_predict.launches = 0
    t0 = time.perf_counter()
    res = run_pose_eval(infer, enumerate(batches), "h36m-p2", smpl, jreg, imgnames=names, log_every=0)
    dt = time.perf_counter() - t0
    print(f"phase 8: (d) pose eval h36m-p2, {EVAL_BATCHES} batches of B={EVAL_BATCH} bf16: "
          f"{EVAL_BATCHES * EVAL_BATCH / dt!r} imgs/s (host clock); K1 launches {fused_part_predict.launches}")
    print(res.summary("h36m-p2"))
    check(res.mpjpe.shape == (EVAL_BATCHES * EVAL_BATCH,) and bool(np.isfinite(res.mpjpe).all())
          and bool(np.isfinite(res.pa_mpjpe).all()), "pose eval: finite per-sample MPJPE and PA-MPJPE")
    check(set(res.per_action) == set(acts), f"pose eval: per-action table {sorted(res.per_action)}")
    check(fused_part_predict.launches == EVAL_BATCHES, f"pose eval: K1 launches {fused_part_predict.launches}")
    profile_ranges(lambda: run_pose_eval(infer, enumerate(batches), "h36m-p2", smpl, jreg, imgnames=names,
                                         log_every=0),
                   "pose.", f"(d) pose eval h36m-p2, {EVAL_BATCHES} batches of B={EVAL_BATCH} bf16", card)
    rng = np.random.RandomState(41)
    rot = batch_rodrigues(torch.from_numpy(rng.randn(EVAL_BATCH * 24, 3) * 0.2)).reshape(EVAL_BATCH, 216)
    para = torch.cat([torch.tensor([[0.9, 0.0, 0.0]], dtype=torch.float64).expand(EVAL_BATCH, 3),
                      torch.from_numpy(rng.randn(EVAL_BATCH, 10) * 0.3), rot], 1)
    bt = batches[0]
    worst = 0.0
    for gendered in (False, True):
        male, female = synthetic_smpl_model(seed=3), synthetic_smpl_model(seed=4)
        outs = []
        for d in ("cpu", dev):
            step = make_eval_step(lambda img, d=d: para.to(d), smpl, jreg, H36M_TO_J14, J24_TO_J14, gendered,
                                  male, female)
            (m, pa), _ = step(None, bt["pose"], bt["betas"], bt["gender"], bt["pose_3d"])
            outs.append((m.cpu(), pa.cpu()))
        for a, b in zip(outs[1], outs[0]):
            worst = max(worst, ((a - b).abs() / b.abs()).max().item())
    print(f"phase 8: (d) harness f64 card vs CPU on fixed para (pose_3d and 3DPW gendered branches): "
          f"max rel err {worst!r} (tolerance 1e-9)")
    check(worst <= 1e-9, f"f64 harness card vs CPU: {worst}")
    return {"ms": min(t["K3"]), "plain_ms": min(t["plain"]), "max_abs_err": err, "bound_ms": bound_ms,
            "bound_by": bound_by, "launches": counts["pallas_banded"]["rasterize_flat_banded"]}


class TimedLoader:
    """A trainer's loader, watched: the host seconds the consumer waits in
    the epoch iterator for each batch, the clock when each batch arrives, a
    copy of the fields of each batch that the resume check compares, and an
    optional call at each batch (a profiler's `step`)."""

    KEYS = ("sample_index", "rot_angle", "is_flipped", "img")

    def __init__(self, loader, on_batch=None):
        self.loader, self.on_batch = loader, on_batch
        self.waits, self.times, self.batches = [], [], []

    def epoch(self, epoch: int, start_batch: int = 0):
        it = self.loader.epoch(epoch, start_batch)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    b, batch = next(it)
                except StopIteration:
                    return
                t1 = time.perf_counter()
                self.waits.append(t1 - t0)
                self.times.append(t1)
                self.batches.append({k: np.array(batch[k]) for k in self.KEYS})
                if self.on_batch is not None:
                    self.on_batch()
                yield b, batch
        finally:
            it.close()


def phase9_train_cli(dev, card) -> dict:
    """The training CLI on the card at full size (`DaNetConfig()`, 224 px,
    W48, bf16, B=64 over 256 synthetic SPIN-format samples: 1 pretrain and 3
    full steps), then its resume: a Trainer stopped at step 2 and a fresh one
    on the same workdir against an uninterrupted run."""
    import dataclasses
    import shutil
    import tempfile

    from danet_densepose2smpl_tpu_torch.cli import train as cli_train
    from danet_densepose2smpl_tpu_torch.train.trainer import Trainer

    def metric_rows(workdir):
        with open(os.path.join(workdir, "metrics.jsonl")) as f:
            return [json.loads(line) for line in f]

    root = os.path.join(REPO, "build", "chip_smoke_train")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    saved_tempdir, tempfile.tempdir = tempfile.tempdir, root    # the CLI writes its dataset there
    steps, batch = 4, TRAIN_BATCH
    torch.cuda.reset_peak_memory_stats(dev)
    argv = ["--synthetic-data", "--num_samples", str(steps * batch), "--batch_size", str(batch), "--bf16",
            "--pretr_step", "1", "--num_epochs", "1", "--summary_steps", "1", "--vis_interval", "0",
            "--log_dir", root]
    try:
        # (a) the main path: python -m danet_densepose2smpl_tpu_torch.cli.train, in-process
        t0 = time.perf_counter()
        trainer, launches = raster_launches(lambda: cli_train.main(argv + ["--name", "cli"]))
        wall = time.perf_counter() - t0
        workdir = os.path.join(root, "cli")
        rows = metric_rows(workdir)
        check(trainer.state.step == steps, f"the CLI ran {trainer.state.step} steps, not {steps}")
        check(len(rows) == steps and "smpl_pose" not in rows[0] and all("smpl_pose" in r for r in rows[1:]),
              f"metrics.jsonl: {len(rows)} rows, pretrain first: {[sorted(r)[:3] for r in rows]}")
        check(all(np.isfinite(v) for r in rows for v in r.values()), "every logged value is finite")
        check(launches["rasterize_flat"] >= steps and launches["rasterize_flat_masked"] == 0,
              f"the CLI's raster launches {launches} in {steps} steps")
        check(os.path.isfile(os.path.join(workdir, "checkpoints", f"ckpt_{steps:09d}.pt"))
              and os.path.isfile(os.path.join(workdir, "config.json")), "the CLI wrote its checkpoint and config")
        rates = [r["imgs_per_sec"] for r in rows]
        print(f"phase 9: (a) cli.train {' '.join(argv)}: {steps} steps in {wall!r} s of command (dataset, "
              f"model init and checkpoint included); loss_total {[r['loss_total'] for r in rows]}; raster "
              f"launches {launches}; imgs/s by summary window {rates} (mean of windows 2-{steps}: "
              f"{float(np.mean(rates[1:]))!r}); peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} "
              f"GiB; card {card}")

        # (b) an uninterrupted run, its third step (with the wait for the next
        # batch) under torch.profiler, and (c) a run stopped at step 2 and
        # resumed, checkpoints every 2 steps; on the CLI's dataset and config
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile, schedule

        args = cli_train.build_parser().parse_args(argv + ["--name", "unused"])
        _, cfg, train_ds, smpl, renderer, fits = cli_train.setup(args)

        def trainer_on(name, cfg):
            t = Trainer(cfg, train_ds, smpl, renderer, fits, os.path.join(root, name), device=dev)
            t.loader = TimedLoader(t.loader)
            return t

        whole = trainer_on("whole", cfg)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=2, warmup=1, active=1, repeat=1)) as prof:
            whole.loader.on_batch = prof.step
            whole.train()
        windows = [r["step_time_s"] for r in metric_rows(os.path.join(root, "whole"))]
        events = prof.key_averages()
        kernel_ms = sum(e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA
                        and not getattr(e, "is_user_annotation", False) and not e.key.startswith("train.")) / 1e3
        wall_ms = (whole.loader.times[3] - whole.loader.times[2]) * 1e3
        ranges = {e.key: round(e.cpu_time_total / 1e3, 3) for e in events
                  if e.key.startswith("train.") and e.device_type == DeviceType.CPU}
        # the host's own pace: one batch assembled on this thread, and on the
        # prefetcher's decode pool, with no step beside it
        prefetch = whole.loader.loader
        perm = prefetch.loader.permutation(0)
        t0 = time.perf_counter()
        prefetch.loader._fetch(0, 0, perm)
        alone_ms = (time.perf_counter() - t0) * 1e3
        with ThreadPoolExecutor(prefetch.workers) as pool:
            t0 = time.perf_counter()
            prefetch.loader._fetch(0, 1, perm, pool)
            pool_ms = (time.perf_counter() - t0) * 1e3
        print(f"phase 9: (b) one batch of B={batch} assembled by the host alone: {alone_ms!r} ms on one thread, "
              f"{pool_ms!r} ms on the prefetcher's {prefetch.workers} decode threads ({os.cpu_count()} CPUs)")
        print(f"phase 9: (b) uninterrupted Trainer, {steps} steps: host ms waiting in the loader's epoch iterator "
              f"{[w * 1e3 for w in whole.loader.waits]}; ms of each summary window (the step, with its wait) "
              f"{[w * 1e3 for w in windows]}; step 3 under torch.profiler (from its batch to the next): "
              f"{wall_ms!r} ms on the host clock, {kernel_ms!r} ms of kernel time, device idle "
              f"{1 - kernel_ms / wall_ms!r}; host ms by range {ranges}; card {card}")

        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, checkpoint_steps=2))
        first = trainer_on("resumed", cfg)
        first._out_of_time = lambda: first.state.step >= 2
        first.train()
        second = trainer_on("resumed", cfg)
        check(tuple(second.resume) == (0, 2, 2), f"resume point {second.resume}, expected (0, 2, 2)")
        second.train()
        check(second.state.step == steps, f"the resumed run ended at step {second.state.step}")
        for i, (got, exp) in enumerate(zip(second.loader.batches, whole.loader.batches[2:])):
            for k in TimedLoader.KEYS:
                check(np.array_equal(got[k], exp[k]), f"resumed step {i + 3}: {k} differs from the uninterrupted run")
        check(len(second.loader.batches) == steps - 2, f"the resumed run took {len(second.loader.batches)} batches")
        pw = dict(whole.state.model.named_parameters())
        diffs = {n: (p.detach() - pw[n].detach()).abs().max().item() for n, p in second.state.model.named_parameters()}
        worst, moved = max(diffs.values()), sum(d > 0 for d in diffs.values())
        bw = dict(whole.state.model.named_buffers())
        buf = max(((b.double() - bw[n].double()).abs().max() / bw[n].double().abs().max().clamp_min(1e-30)).item()
                  for n, b in second.state.model.named_buffers() if b.is_floating_point())
        lr = cfg.solver.base_lr
        print(f"phase 9: (c) resumed at {tuple(second.resume)}; steps 3-{steps} fed the uninterrupted run's batches "
              f"bit for bit ({', '.join(TimedLoader.KEYS)}); parameters after step {steps} vs the uninterrupted "
              f"run: max abs diff {worst!r} ({moved} of {len(diffs)} tensors differ at all; tolerance 2 lr x "
              f"{steps} steps = {2 * lr * steps!r}), BatchNorm statistics max rel diff {buf!r}")
        # Adam moves a parameter by at most ~lr a step, so runs whose
        # nondeterministic cuDNN backward disagrees on a gradient's sign
        # part by at most 2 lr a step
        check(worst <= 2 * lr * steps, f"resumed parameters {worst} from the uninterrupted run's")
        return {"launches": launches["rasterize_flat"], "alone_ms": alone_ms, "pool_ms": pool_ms}
    finally:
        tempfile.tempdir = saved_tempdir
        shutil.rmtree(root, ignore_errors=True)


def timed_calls(module, name: str, log: list):
    """Replace `module.name` with a wrapper that appends the host seconds of
    each call to `log` (the eval pass inside a CLI, without its set-up);
    returns a function that puts the original back."""
    real = getattr(module, name)

    def wrapper(*args, **kw):
        t0 = time.perf_counter()
        out = real(*args, **kw)
        log.append(time.perf_counter() - t0)       # the pass ends in host reads of its metrics
        return out

    setattr(module, name, wrapper)
    return lambda: setattr(module, name, real)


def phase10_eval_cli(dev, card, host_crop: dict) -> dict:
    """The eval entry points and the ingest on the card, in-process, at the
    default config (HRNet-W48, 224 px, seeded random weights) over synthetic
    SPIN-format datasets written under build/chip_smoke_eval and removed."""
    import shutil
    import tempfile

    from danet_densepose2smpl_tpu_torch.cli import eval as cli_eval
    from danet_densepose2smpl_tpu_torch.cli import eval_coco as cli_eval_coco
    from danet_densepose2smpl_tpu_torch.cli import train as cli_train
    from danet_densepose2smpl_tpu_torch.data.pipeline import device_preprocess, device_preprocess_train
    from danet_densepose2smpl_tpu_torch.eval import coco_harness, harness, lsp

    root = os.path.join(REPO, "build", "chip_smoke_eval")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    saved_tempdir, tempfile.tempdir = tempfile.tempdir, root     # the CLIs write their datasets there
    n, b = EVAL_BATCHES * EVAL_BATCH, EVAL_BATCH
    data = ["--synthetic-data", "--num_samples", str(n), "--batch_size", str(b)]
    out = {}
    try:
        # (a) cli.eval, h36m-p2, bf16: the host crop, then the crop on the card
        for raw in (False, True):
            passes = []
            restore = timed_calls(harness, "run_pose_eval", passes)
            try:
                argv = ["--dataset", "h36m-p2", *data, "--bf16", "--log_freq", "0"] + (["--device_preprocess"] if raw else [])
                res, counts = launch_counts(lambda: cli_eval.main(argv)["pose"])
            finally:
                restore()
            print(res.summary("h36m-p2"))
            print(f"phase 10: (a) cli.eval {' '.join(argv)}: {n / passes[0]!r} imgs/s over the eval pass (host "
                  f"clock, {passes[0]!r} s); launches {counts}; card {card}")
            check(res.mpjpe.shape == (n,) and bool(np.isfinite(res.mpjpe).all() and np.isfinite(res.pa_mpjpe).all()),
                  f"cli.eval h36m-p2 (device_preprocess {raw}): finite per-sample MPJPE and PA-MPJPE")
            check(len(res.per_action) > 0 and all(np.isfinite(v).all() for v in res.per_action.values()),
                  "cli.eval h36m-p2: a finite per-action table")
            check(counts["part_crop_head"] == EVAL_BATCHES, f"cli.eval h36m-p2: K1 launches {counts}")
            out["pose_dp" if raw else "pose"] = {"imgs_per_s": n / passes[0], "k1": counts["part_crop_head"]}

        # (b) cli.eval, lsp, bf16, the GT PNGs: one K1 launch and one raster a batch
        passes = []
        restore = timed_calls(lsp, "run_lsp_eval", passes)
        try:
            argv = ["--dataset", "lsp", *data, "--bf16", "--log_freq", "0"]
            scores, counts = launch_counts(lambda: cli_eval.main(argv)["lsp"])
        finally:
            restore()
        rasters = counts["rasterize_flat"] + counts["rasterize_flat_banded"]
        print(f"phase 10: (b) cli.eval {' '.join(argv)}: {scores}; {n / passes[0]!r} imgs/s over the eval pass "
              f"(host clock); launches {counts}; card {card}")
        check(len(scores) == 4 and all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in scores.values()),
              f"cli.eval lsp: the four Final Results lines {scores}")
        check(counts["part_crop_head"] == EVAL_BATCHES and rasters == EVAL_BATCHES,
              f"cli.eval lsp: launches {counts}, expected {EVAL_BATCHES} of K1 and of the raster")
        out["lsp"] = {"imgs_per_s": n / passes[0], "k1": counts["part_crop_head"], "raster": rasters,
                      "raster_entry": max(("rasterize_flat", "rasterize_flat_banded"), key=lambda k: counts[k])}

        # (c) cli.eval_coco (fp32, as the JAX CLI runs it)
        passes = []
        restore = timed_calls(coco_harness, "run_coco_eval", passes)
        try:
            (ap, preds), counts = launch_counts(lambda: cli_eval_coco.main(data))
        finally:
            restore()
        print(f"phase 10: (c) cli.eval_coco {' '.join(data)}: AP {ap}; {n / passes[0]!r} imgs/s over the eval pass "
              f"(host clock); launches {counts}; card {card}")
        check(preds.shape == (n, 17, 3) and bool(np.isfinite(preds).all()), "cli.eval_coco: finite predictions")
        check(all(np.isfinite(v) and (v == -1.0 or 0.0 <= v <= 1.0) for v in ap.values()),
              f"cli.eval_coco: the AP table {ap}")
        check(counts["part_crop_head"] == EVAL_BATCHES, f"cli.eval_coco: K1 launches {counts}")
        out["coco"] = {"imgs_per_s": n / passes[0], "k1": counts["part_crop_head"]}

        # (d) the crops on the card against their CPU runs, at B=64 on 256 px
        # frames, with PyTorch's TF32 switches on around them (the functions
        # must keep their geometry out of TF32 themselves), then their times
        rng = np.random.RandomState(50)
        bt = TRAIN_BATCH
        frames = torch.from_numpy(rng.randint(0, 256, (bt, 256, 256, 3)).astype(np.uint8))
        centers = torch.from_numpy(rng.uniform(100, 156, (bt, 2)).astype(np.float32))
        scales = torch.from_numpy(rng.uniform(0.9, 1.3, bt).astype(np.float32))
        rots = torch.from_numpy(np.where(rng.rand(bt) < 0.6, 0.0, rng.uniform(-60, 60, bt)).astype(np.float32))
        flips = torch.from_numpy((rng.rand(bt) < 0.5).astype(np.float32))
        noise = torch.from_numpy(rng.uniform(0.6, 1.4, (bt, 3)).astype(np.float32))
        calls = {
            "device_preprocess": lambda x, *a: device_preprocess(x, a[0], a[1]),
            "device_preprocess_train": lambda x, *a: device_preprocess_train(x, *a, out_size=224),
        }
        cpu_args = (centers, scales, rots, flips, noise)
        gpu_frames, gpu_args = frames.to(dev), tuple(a.to(dev) for a in cpu_args)
        tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            for name, fn in calls.items():
                got = fn(gpu_frames, *gpu_args)
                want = fn(frames, *cpu_args)
                err = (got.cpu() - want).abs().max().item()
                ms = [cuda_ms(lambda: fn(gpu_frames, *gpu_args), 20) for _ in range(2)]
                moved = frames.numel() + got.numel() * got.element_size()
                print(f"phase 10: (d) {name}, B={bt}, 256 px uint8 -> 224 px fp32: card vs CPU max abs err {err!r} "
                      f"(tolerance 1e-4, TF32 switches on); {ms} ms a call (CUDA events, mean of 20, twice); "
                      f"{moved / 2**20:.1f} MiB in and out, {moved / PEAK_BYTES_PER_S * 1e3!r} ms at 3.35 TB/s; "
                      f"device time by kernel {device_ms_by_kernel(lambda: fn(gpu_frames, *gpu_args), 5)}; "
                      f"card {card}")
                check(tuple(got.shape) == (bt, 224, 224, 3) and got.dtype == torch.float32,
                      f"{name}: shape {tuple(got.shape)} {got.dtype}")
                check(err <= 1e-4, f"{name}: card vs CPU {err}")
                out[name] = {"ms": min(ms), "max_abs_err": err}
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

        # (e) cli.train as in phase 9 (a), with --device_preprocess, 4 steps;
        # then the host's own pace on raw batches, beside phase 9 (b)'s
        steps = 4
        argv = ["--synthetic-data", "--num_samples", str(steps * bt), "--batch_size", str(bt), "--bf16",
                "--pretr_step", "1", "--num_epochs", "1", "--summary_steps", "1", "--vis_interval", "0",
                "--log_dir", root, "--name", "raw", "--device_preprocess"]
        trainer, counts = launch_counts(lambda: cli_train.main(argv))
        with open(os.path.join(root, "raw", "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        print(f"phase 10: (e) cli.train {' '.join(argv)}: loss_total {[r['loss_total'] for r in rows]}; imgs/s by "
              f"summary window {[r['imgs_per_sec'] for r in rows]}; launches {counts}; card {card}")
        check(trainer.state.step == steps and len(rows) == steps, f"cli.train --device_preprocess: {len(rows)} rows")
        check(all(np.isfinite(v) for r in rows for v in r.values()), "cli.train --device_preprocess: finite values")
        check(counts["rasterize_flat"] >= steps, f"cli.train --device_preprocess: raster launches {counts}")
        loader = trainer.loader.loader if hasattr(trainer.loader, "workers") else trainer.loader
        perm = loader.permutation(0)
        workers = getattr(trainer.loader, "workers", 1)
        alone_ms, pool_ms = [], []
        with ThreadPoolExecutor(workers) as pool:
            for b_idx, threads in enumerate((1, workers, workers, 1)):      # in turns, batches 0-3
                t0 = time.perf_counter()
                batch = loader._fetch(0, b_idx, perm, pool if threads > 1 else None)
                (pool_ms if threads > 1 else alone_ms).append((time.perf_counter() - t0) * 1e3)
        check(batch["raw_img"].dtype == np.uint8 and "img" not in batch, "raw batches carry uint8 frames, no crop")
        print(f"phase 10: (e) one raw batch of B={bt} ({batch['raw_img'].nbytes / 2**20:.1f} MiB of frames) "
              f"assembled by the host alone: {alone_ms} ms on one thread, {pool_ms} ms on the prefetcher's "
              f"{workers} decode threads (batches 0-3 in turns; {os.cpu_count()} CPUs); with the host crop "
              f"(phase 9 (b), this call): {host_crop['alone_ms']!r} ms and {host_crop['pool_ms']!r} ms")
        out["train"] = {"alone_ms": alone_ms, "pool_ms": pool_ms, "raster": counts["rasterize_flat"]}
        return out
    finally:
        tempfile.tempdir = saved_tempdir
        shutil.rmtree(root, ignore_errors=True)


DEMO_FRAMES = ((448, 448), (300, 200), (200, 300), (640, 480)) * 2     # (width, height): 8 frames
DP_JSON_ANNOTATIONS = 256


class RangeClock:
    """A stand-in for the port's span (`utils.profiling.annotate`) in a
    module that imports it: it opens the real span and appends the host ms
    of each use to `ms[name]`."""

    def __init__(self):
        self.ms = {}

    def __call__(self, name):
        import contextlib

        from danet_densepose2smpl_tpu_torch.utils.profiling import annotate

        @contextlib.contextmanager
        def timed():
            t0 = time.perf_counter()
            with annotate(name):
                yield
            self.ms.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)

        return timed()


def phase11_demo_vis(dev, card) -> dict:
    """(a) `render_shaded` on the card against its plain version on the CPU;
    (b) the demo CLI in-process in fp32 and bf16; (c) the Trainer's vis step
    on a host-cropped and a raw batch; (d) the offline DensePose-COCO
    preprocessing CLI. Data under build/chip_smoke_demo, removed."""
    import shutil
    import tempfile

    from danet_densepose2smpl_tpu_torch.cli import demo as cli_demo
    from danet_densepose2smpl_tpu_torch.cli import preprocess as cli_preprocess
    from danet_densepose2smpl_tpu_torch.cli import train as cli_train
    from danet_densepose2smpl_tpu_torch.config import Config
    from danet_densepose2smpl_tpu_torch.data.dataset import NpzDataset
    from danet_densepose2smpl_tpu_torch.data.image_io import read_png, write_png
    from danet_densepose2smpl_tpu_torch.data.loader import ResumableLoader
    from danet_densepose2smpl_tpu_torch.data.synthetic import (
        DP_COCO_KINDS,
        synthetic_raw_batch,
        write_synthetic_dp_coco_json,
    )
    from danet_densepose2smpl_tpu_torch.kernels import rasterizer as R
    from danet_densepose2smpl_tpu_torch.kernels.part_crop_head import fused_part_predict
    from danet_densepose2smpl_tpu_torch.smpl.loader import synthetic_smpl_model, to_torch
    from danet_densepose2smpl_tpu_torch.train.prepare import prepare_targets
    from danet_densepose2smpl_tpu_torch.train.step import batch_to_device
    from danet_densepose2smpl_tpu_torch.train.trainer import Trainer
    from danet_densepose2smpl_tpu_torch.utils.vis import DEMO_PANELS

    def counted(fn):
        """fn() with K1's and `rasterize_flat`'s launch counts zeroed just
        before it; (its result, the counts read just after it)."""
        fused_part_predict.launches = R.rasterize_flat.launches = 0
        got = fn()
        torch.cuda.synchronize()
        return got, {"part_crop_head": fused_part_predict.launches, "rasterize_flat": R.rasterize_flat.launches}

    out = {}
    # (a) render_shaded: the full synthetic SMPL body (6,890 vertices,
    # 13,776 faces) under the cameras prepare_targets fits to posed
    # keypoints, B=4, 224 px, the card against the plain version on the CPU
    cfg = Config()
    smpl = synthetic_smpl_model()
    raw = posed_keypoints(cfg, smpl, synthetic_raw_batch(cfg, 4, seed=60), seed=61)
    prep = prepare_targets(cfg, to_torch(smpl, dev), batch_to_device(raw, dev))
    verts, cam = prep["target_verts"], prep["target_cam"]
    faces = torch.as_tensor(smpl.faces.astype(np.int64), device=dev)
    shaded = {}
    for yaw in (0.0, 90.0):
        got, counts = counted(lambda: R.render_shaded(verts, faces, cam, yaw_deg=yaw))
        # the plain version on the CPU: the shading, then per image the
        # banded plain raster (bit-identical to `rasterize_flat_plain`,
        # tests/test_torch_raster.py, and ~10x faster on these faces)
        vpx_c, shade_c = R.shaded_faces(verts.cpu(), faces.cpu(), cam.cpu(), yaw_deg=yaw)
        plain_ms = []
        for i in range(4):
            t0 = time.perf_counter()
            img = R.rasterize_flat_banded_plain(vpx_c[i:i + 1], faces.cpu(), shade_c[i][:, None], 224, 224.0)
            plain_ms.append((time.perf_counter() - t0) * 1e3)
            exp = img if i == 0 else torch.cat([exp, img])
        exp = exp[..., 0]
        off = got.cpu() != exp
        frac = off.double().mean().item()
        fg = (exp > 0).double()
        err = (got.cpu().double() - exp.double()).abs().max().item()
        print(f"phase 11: (a) render_shaded yaw {yaw}, B=4, 224 px, {faces.shape[0]} faces: {int(off.sum())} of "
              f"{off.numel()} pixels differ from the plain version on the CPU ({frac!r}), max abs err {err!r}, "
              f"foreground {fg.mean().item()!r} (per image {fg.mean((1, 2)).tolist()}); launches {counts}")
        check(tuple(got.shape) == (4, 224, 224) and bool(torch.isfinite(got).all()), "render_shaded: shape")
        check(counts["rasterize_flat"] == 4, f"render_shaded: {counts} for 4 images")
        check(frac <= PIXELS_OFF_MAX, f"render_shaded yaw {yaw}: {frac} of the pixels differ")
        check(fg.mean().item() > 0.02 and bool((fg.mean((1, 2)) > 0).all()), f"render_shaded yaw {yaw}: foreground")
        for b in (1, 4):
            v, c = verts[:b], cam[:b]
            ms = [cuda_ms(lambda: R.render_shaded(v, faces, c, yaw_deg=yaw), 20) for _ in range(2)]
            vpx, shade = R.shaded_faces(v, faces, c, yaw_deg=yaw)
            tex = [shade[i][:, None].contiguous() for i in range(b)]
            raster_ms = [cuda_ms(lambda: [R._launch(vpx[i:i + 1], faces, tex[i], 224, 224.0) for i in range(b)], 20)
                         for _ in range(2)]
            pairs = sum(int(R._launch(vpx[i:i + 1], faces, tex[i], 224, 224.0, with_pairs=True)[1].item())
                        for i in range(b))
            exact = sum(exact_box_pairs(vpx[i:i + 1], faces, 224) for i in range(b))
            bnd = bound(nbytes(v, faces, c) + b * 224 * 224 * 4, exact * RASTER_OPS_PER_CANDIDATE, "fp32")
            shaded[(yaw, b)] = {"ms": min(ms), "raster_ms": min(raster_ms), "plain_ms": sum(plain_ms[:b]),
                                "bound_ms": bnd[0], "bound_by": bnd[1], "pairs": pairs, "max_abs_err": err}
            print(f"phase 11: (a) render_shaded yaw {yaw} B={b}: {ms} ms a call (CUDA events, mean of 20, twice; "
                  f"shading + {b} rasterize_flat calls), the raster calls alone {raster_ms} ms; the plain raster "
                  f"on the CPU {sum(plain_ms[:b])!r} ms (host clock, banded, {b} call(s) of {plain_ms}); pairs the "
                  f"kernel enumerated {pairs}, {exact} in the exact boxes; bound {bnd!r} (ms, by); library call: "
                  f"none; card {card}")
    out["shaded"] = shaded

    root = os.path.join(REPO, "build", "chip_smoke_demo")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    saved_tempdir, tempfile.tempdir = tempfile.tempdir, root      # cli.train's setup writes its datasets there
    try:
        # (b) the demo CLI, in-process, default config (W48, 224 px), seeded
        # random weights and synthetic assets, over 8 PNG frames of mixed sizes
        frames = os.path.join(root, "frames")
        os.makedirs(frames)
        rng = np.random.RandomState(70)
        for i, (w, h) in enumerate(DEMO_FRAMES):
            write_png(os.path.join(frames, f"frame_{i}_{w}x{h}.png"), rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
        widths = [224, 224, 224, 336, 224, 224]          # the part grid is 4 x 6 tiles of 56 px
        demo = {}
        for mode in ("fp32", "bf16"):
            argv = ["--synthetic-assets", "--imglist", frames, "--out_dir", os.path.join(root, f"out_{mode}")]
            argv += ["--bf16"] if mode == "bf16" else []
            clock = RangeClock()
            real, cli_demo.annotate = cli_demo.annotate, clock
            try:
                t0 = time.perf_counter()
                results, counts = counted(lambda: cli_demo.main(argv))
                wall = time.perf_counter() - t0
            finally:
                cli_demo.annotate = real
            check(len(results) == len(DEMO_FRAMES), f"demo {mode}: {len(results)} composites")
            for r in results:
                img = read_png(r["out_path"])
                check(img.shape == (224, sum(widths), 3) and img.std() > 0, f"demo {mode}: {r['out_path']} {img.shape}")
                check([t for t, _ in r["panels"]] == list(DEMO_PANELS), f"demo {mode}: panels")
                check([p.shape[1] * 224 // p.shape[0] for _, p in r["panels"]] == widths, f"demo {mode}: tile sizes")
                check(bool(np.isfinite(r["para"]).all()), f"demo {mode}: para finite")
            n = len(DEMO_FRAMES)
            check(counts == {"part_crop_head": n, "rasterize_flat": 3 * n},
                  f"demo {mode}: launches {counts}, expected {n} of K1 and {3 * n} of rasterize_flat")
            per_image = {k: float(np.mean(v[1:])) for k, v in clock.ms.items()}
            demo[mode] = {"launches": counts, "ms_by_range": per_image}
            print(f"phase 11: (b) cli.demo {' '.join(argv)}: {n} composites of 224 x {sum(widths)} px in {wall!r} s "
                  f"(model build included); launches {counts}; host ms per image after the first, by range "
                  f"{per_image} (each: {clock.ms}); card {card}")
        out["demo"] = demo

        # (c) the Trainer's vis step at full width, bf16, B=64, on the batch of
        # the host crop and on a raw batch (--device_preprocess)
        vis = {}
        argv = ["--synthetic-data", "--num_samples", str(TRAIN_BATCH), "--batch_size", str(TRAIN_BATCH), "--bf16",
                "--vis_interval", "1", "--log_dir", root, "--name", "vis"]
        _, tcfg, ds, tsmpl, renderer, fits = cli_train.setup(cli_train.build_parser().parse_args(argv))
        _, _, raw_ds, _, _, _ = cli_train.setup(cli_train.build_parser().parse_args(argv + ["--device_preprocess"]))
        trainer = Trainer(tcfg, ds, tsmpl, renderer, fits, os.path.join(root, "vis"), device=dev)
        for name, d in (("host_crop", ds), ("raw", raw_ds)):
            batch = trainer._device_batch(next(iter(ResumableLoader(d, TRAIN_BATCH, seed=0).epoch(0)))[1])
            check(("raw_img" in batch) == (name == "raw"), f"vis {name}: batch keys")
            _, counts = counted(lambda: trainer._save_vis(batch, 1))
            t0 = time.perf_counter()
            trainer._save_vis(batch, 2)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            main_png = read_png(os.path.join(root, "vis", "vis", "step_0000002.png"))
            parts_png = read_png(os.path.join(root, "vis", "vis", "step_0000002_parts.png"))
            print(f"phase 11: (c) Trainer._save_vis, bf16, B={TRAIN_BATCH} batch ({name}): {ms!r} ms (host clock, the "
                  f"second call, ends in the PNG writes); launches {counts}; sheets {main_png.shape} and "
                  f"{parts_png.shape}; card {card}")
            check(main_png.shape == (4 * 224, 4 * 224, 3) and main_png.std() > 0, f"vis {name}: {main_png.shape}")
            check(parts_png.shape == (224, 2 * 336, 3) and parts_png.std() > 0, f"vis {name}: {parts_png.shape}")
            check(counts == {"part_crop_head": 1, "rasterize_flat": 5},
                  f"vis {name}: launches {counts}, expected 1 of K1 and 5 of rasterize_flat (the IUV render, 4 shaded)")
            vis[name] = {"launches": counts, "ms": ms}
        out["vis"] = vis

        # (d) the offline preprocessing: a synthetic densepose_coco json of
        # 256 annotations -> GO, the npz, one batch through NpzDataset
        src, img_dir = os.path.join(root, "dp_coco.json"), os.path.join(root, "dp_images")
        write_synthetic_dp_coco_json(src, DP_JSON_ANNOTATIONS, n_images=32, img_dir=img_dir,
                                     kinds=DP_COCO_KINDS[:-1])          # no degenerate boxes
        npz = os.path.join(root, "dp_coco.npz")
        t0 = time.perf_counter()
        rc = cli_preprocess.main(["--json", src, "--out", npz])
        pre_ms = (time.perf_counter() - t0) * 1e3
        check(rc == 0 and os.path.isfile(npz), f"cli.preprocess: exit code {rc}")
        dp_ds = NpzDataset(npz, img_dir, name="dp_coco", heatmap_size=56)
        t0 = time.perf_counter()
        _, batch = next(iter(ResumableLoader(dp_ds, TRAIN_BATCH, seed=0).epoch(0)))
        batch_ms = (time.perf_counter() - t0) * 1e3
        check(batch["img"].shape == (TRAIN_BATCH, 224, 224, 3) and bool((batch["has_dp"] == 1).all())
              and batch["dp_dict"]["point_weights"].sum() > 0, "cli.preprocess: a batch with DensePose blobs")
        print(f"phase 11: (d) cli.preprocess on {DP_JSON_ANNOTATIONS} annotations: GO, {len(dp_ds)} samples in "
              f"{pre_ms!r} ms (host); one B={TRAIN_BATCH} batch with DensePose blobs from NpzDataset in "
              f"{batch_ms!r} ms (host, one thread)")
        out["preprocess"] = {"samples": len(dp_ds), "ms": pre_ms}
        return out
    finally:
        tempfile.tempdir = saved_tempdir
        shutil.rmtree(root, ignore_errors=True)


RESNET_CFG = "configs/danet_resnet.yaml"
ARCH_REQUEST_BATCH = 64


def launch_counts(fn):
    """fn() with K1's and the rasters' launch counts zeroed just before it;
    (its result, the counts read just after it)."""
    from danet_densepose2smpl_tpu_torch.kernels import rasterizer as R
    from danet_densepose2smpl_tpu_torch.kernels.part_crop_head import fused_part_predict

    fused_part_predict.launches = 0
    R.rasterize_flat.launches = R.rasterize_flat_banded.launches = R.rasterize_flat_masked.launches = 0
    res = fn()
    torch.cuda.synchronize()
    return res, {"part_crop_head": fused_part_predict.launches, "rasterize_flat": R.rasterize_flat.launches,
                 "rasterize_flat_banded": R.rasterize_flat_banded.launches,
                 "rasterize_flat_masked": R.rasterize_flat_masked.launches}


def phase12_archs(dev, card) -> dict:
    """Slice D's architectures on the card: K1 at the ResNet backbone's 256
    channels, the ResNet-50 DaNet through `Predictor` and `cli.train`, the
    other refinements and the GlobalPredictor, and the HMR baseline through
    `cli.eval` (see the module docstring, phase 12)."""
    out = {"k1": phase12_k1_wide(dev, card)}
    out.update(phase12_models(dev, card))
    return out


def k1_launch(args, s, plan=None, scalar=False):
    """A function that launches one K1 kernel alone on `args` (the wrapper's
    checks, plan and weight packing done once, here): for bf16 or fp32 args
    the tensor-core kernel of that dtype at `plan` = (tile rows, channel
    chunk) if given, else the wrapper's `bf16_plan` / `f32_plan`; with
    `scalar`, the scalar kernel (fp32 or f64) through the C entry
    `part_crop_head`. Its output buffer is `.out`."""
    from danet_densepose2smpl_tpu_torch.kernels.part_crop_head import (
        _SCALAR_DTYPE_CODE,
        bf16_plan,
        f32_plan,
        load_library,
        pack_head_weights,
    )

    feats, wy, wx, kernel, bias = args
    b, h, w, c = feats.shape
    k, o = wy.shape[1], kernel.shape[-1] // wy.shape[1]
    out = torch.empty((b, k, s, s, o), dtype=feats.dtype, device=feats.device)
    lib = load_library()[0]
    ptrs = (feats.data_ptr(), wy.data_ptr(), wx.data_ptr())
    if scalar:
        kern = kernel.reshape(3, 3, c, k, o).permute(3, 0, 1, 2, 4).contiguous()   # (K, 3, 3, C, O)

        def call(stream):
            return lib.part_crop_head(_SCALAR_DTYPE_CODE[feats.dtype], *ptrs, kern.data_ptr(), bias.data_ptr(),
                                      out.data_ptr(), b, h, w, c, s, k, o, stream)
    else:
        f32 = feats.dtype == torch.float32
        rows, chunk = plan or (f32_plan if f32 else bf16_plan)(h, w, c, s, o)
        wpack = pack_head_weights(kernel, k, chunk, split=f32)
        entry = lib.part_crop_head_f32 if f32 else lib.part_crop_head_bf16

        def call(stream):
            return entry(*ptrs, wpack.data_ptr(), bias.data_ptr(), out.data_ptr(), b, h, w, c, s, k, o, rows, chunk,
                         stream)

    def launch():
        err = call(torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"K1 launch: cudaError {err}")

    launch.out = out
    return launch


# K1's earlier times at B=64 bf16 on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md §6): the ring layout's chunked kernel at C=256 (commit 9163c73),
# its all-of-C kernel at C=64 (commit d34c60c)
K1_WAS_MS = {256: (8.841, "the ring layout at 9163c73"), 64: (2.658, "the ring layout at d34c60c")}
# and the C=48 A/B of the launch alone (medians of 12 turns in one process:
# the ring layout's library at d34c60c, this kernel's; PERF.md §6)
K1_AB_MS = (1.161, 0.834, "the ring layout at d34c60c against this kernel, PERF.md §6")


def k1_check_cases(phase: str, dev, cases, seed: int, errors: dict | None = None) -> float:
    """K1 against its plain version on each (dtype, B, S, C, O) case, fed by
    bilinear and by dense interpolation matrices: fp32 (TF32 off) within
    1e-4, bf16 within 2e-2 of max|ref|, f64 within 1e-10. Returns the first
    bf16 case's error on bilinear weights; `errors`, if given, gets every
    case's error by (dtype, B, S, C, O, weights)."""
    from danet_densepose2smpl_tpu_torch.kernels.part_crop_head import (
        bf16_plan,
        f32_plan,
        fused_part_predict,
        part_crop_head_plain,
    )

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    first = None
    for name, b, hw, c, o in cases:
        dt = getattr(torch, name)
        for dense in (False, True):
            args = k1_inputs(b, hw, hw, c, hw, dt, dev, seed=seed, dense=dense, o=o)
            got = fused_part_predict(*args, hw)
            torch.cuda.synchronize()
            ref = part_crop_head_plain(*args, hw)
            err, ref_max = (got.double() - ref.double()).abs().max().item(), ref.double().abs().max().item()
            tol = {"float32": 1e-4, "bfloat16": 2e-2 * ref_max, "float64": 1e-10}[name]
            weights = "dense" if dense else "bilinear"
            plan = {"bfloat16": bf16_plan, "float32": f32_plan}.get(name)
            plan = f", tile rows and chunk {plan(hw, hw, c, hw, o)}" if plan else ""
            print(f"phase {phase}: K1 {name} B={b} {hw}x{hw}x{c} S={hw} O={o} {weights} weights: max abs err {err!r} "
                  f"(max|ref| {ref_max!r}, tolerance {tol!r}{plan})")
            check(got.shape == (b, 24, hw, hw, o) and bool(torch.isfinite(got).all()), f"K1 {name} C={c}: shape")
            check(err <= tol, f"K1 {name} C={c} {weights}: {err} > {tol}")
            if first is None and name == "bfloat16" and not dense:
                first = err
            if errors is not None:
                errors[(name, b, hw, c, o, weights)] = err
            del got, ref, args
    return first


def k1_timing(phase: str, dev, card, c: int, beside: dict | None = None) -> dict:
    """K1 at B=64 bf16 on 56x56xC: the wrapper, its plain version, the
    unfused route (`separable_crop_concat`, then cuDNN's grouped conv) and
    its conv alone in turns, then the launch alone (weights packed once) at
    the wrapper's plan and at each channel chunk, with the `beside` launches,
    in turns: medians of two turns of 20 calls (the plain version 3), CUDA
    events, beside the kernel's earlier time and its bound."""
    from danet_densepose2smpl_tpu_torch.kernels.part_crop_head import (
        BF16_CHUNKS,
        bf16_plan,
        bf16_rows,
        fused_part_predict,
        part_crop_head_plain,
    )
    from danet_densepose2smpl_tpu_torch.nn.iuv_head import PartialIUVHead
    from danet_densepose2smpl_tpu_torch.ops.imwarp import separable_crop_concat

    args, centers, scales = k1_inputs(ARCH_REQUEST_BATCH, 56, 56, c, 56, torch.bfloat16, dev, seed=2, boxes=True)
    feats, _, _, kernel, bias = args
    head = PartialIUVHead(c).to(dev, torch.bfloat16, memory_format=torch.channels_last)
    head.weight.data.copy_(kernel.permute(3, 2, 0, 1))
    head.bias.data.copy_(bias)
    crops = separable_crop_concat(feats, centers, scales, 56).permute(0, 3, 1, 2)
    calls = {
        "kernel": lambda: fused_part_predict(*args, 56),
        "plain": lambda: part_crop_head_plain(*args, 56),
        "unfused": lambda: head(separable_crop_concat(feats, centers, scales, 56).permute(0, 3, 1, 2)),
        "unfused conv": lambda: head(crops),
    }
    plan = bf16_plan(56, 56, c, 56, 21)
    launches = {"plan": k1_launch(args, 56, plan)}
    for chunk in BF16_CHUNKS:
        launches[f"chunk {chunk}"] = k1_launch(args, 56, (bf16_rows(56, 56, 21, chunk), chunk))
    launches.update(beside or {})
    times = {name: [] for name in [*calls, *launches]}
    with torch.no_grad():
        for name in ("plain", "kernel", "unfused", "unfused conv", "unfused conv", "unfused", "kernel", "plain"):
            times[name].append(cuda_ms(calls[name], 3 if name == "plain" else 20))
        for order in (list(launches), list(launches)[::-1]):
            for name in order:
                times[name].append(cuda_ms(launches[name], 20))
        ref = calls["plain"]().double()
    ref_max = ref.abs().max().item()
    for chunk in BF16_CHUNKS:
        err = (launches[f"chunk {chunk}"].out.double() - ref).abs().max().item()
        check(err <= 2e-2 * ref_max, f"K1 C={c} in chunks of {chunk}: {err} > {2e-2 * ref_max}")
    bound_ms, bound_by = k1_bound(args, 56)
    ms = {name: float(np.median(t)) for name, t in times.items()}
    was_ms, was = K1_WAS_MS.get(c, (None, None))
    print(f"phase {phase}: K1 B={ARCH_REQUEST_BATCH} bf16 56x56x{c} (CUDA events, medians of two turns of 20 calls, "
          f"plain 3; TF32 off): kernel {times['kernel']} ms (was {was_ms} ms, {was}), plain {times['plain']} ms, "
          f"unfused route {times['unfused']} ms, its conv alone {times['unfused conv']} ms; the launch alone "
          f"(weights packed once) at the plan {plan} (tile rows, chunk) {times['plan']} ms, "
          + ", ".join(f"{name} {times[name]} ms" for name in launches if name != "plan")
          + f"; bound {bound_ms!r} ms ({bound_by}); card {card}")
    launch_ms = {name: ms[name] for name in launches}
    del args, feats, kernel, bias, head, crops, calls, launches, ref
    torch.cuda.empty_cache()
    return {"ms": ms["kernel"], "plain_ms": ms["plain"], "unfused_ms": ms["unfused"],
            "unfused_conv_ms": ms["unfused conv"], "device_ms": ms["plan"], "bound_ms": bound_ms,
            "bound_by": bound_by, "plan": plan, "launch_ms": launch_ms}


def phase12_k1_wide(dev, card) -> dict:
    """(a): K1 at C=256, 264, 200, 201 and 72 against its plain version, and
    its time at B=64 bf16, C=256, beside the plain version and the unfused
    route."""
    cases = [("bfloat16", 64, 56, 256, 21), ("float32", 16, 56, 256, 21), ("float64", 2, 56, 256, 21),
             ("bfloat16", 1, 56, 264, 21), ("float32", 1, 56, 264, 21), ("float64", 1, 56, 264, 21),
             ("bfloat16", 1, 56, 200, 21), ("float32", 1, 56, 200, 21), ("float64", 1, 56, 200, 21),
             ("bfloat16", 1, 57, 201, 5), ("float64", 1, 57, 201, 5),
             ("bfloat16", 1, 56, 72, 21), ("float32", 1, 56, 72, 21), ("float64", 1, 56, 72, 21)]
    err = k1_check_cases("12: (a)", dev, cases, seed=3)
    return {**k1_timing("12: (a)", dev, card, 256), "max_abs_err": err}


def phase12_models(dev, card) -> dict:
    """(b)-(e): the ResNet-50 DaNet through `Predictor`, `cli.train` and the
    training step, the other regressors, the HMR baseline in `cli.eval`."""
    import dataclasses
    import shutil
    import tempfile

    from danet_densepose2smpl_tpu_torch.cli import eval as cli_eval
    from danet_densepose2smpl_tpu_torch.cli import eval_coco as cli_eval_coco
    from danet_densepose2smpl_tpu_torch.cli import train as cli_train
    from danet_densepose2smpl_tpu_torch.config import Config, DaNetConfig, RefinementConfig, load_config
    from danet_densepose2smpl_tpu_torch.data.synthetic import synthetic_raw_batch
    from danet_densepose2smpl_tpu_torch.eval import harness, lsp
    from danet_densepose2smpl_tpu_torch.kernels import rasterizer as R
    from danet_densepose2smpl_tpu_torch.models.danet import DaNet
    from danet_densepose2smpl_tpu_torch.serve import Predictor, random_init_
    from danet_densepose2smpl_tpu_torch.smpl.densepose_atlas import closed_synthetic_atlas
    from danet_densepose2smpl_tpu_torch.smpl.loader import synthetic_smpl_model
    from danet_densepose2smpl_tpu_torch.train.step import batch_to_device, create_train_state, make_train_step

    out = {}
    # (b) configs/danet_resnet.yaml (ResNet-50 backbone) through Predictor
    cfg = load_config(os.path.join(REPO, RESNET_CFG)).danet
    check(cfg.iuv_regressor == "resnet" and cfg.msres_num_layers == 50, f"{RESNET_CFG}: {cfg.iuv_regressor}")
    x = torch.from_numpy(np.random.RandomState(3).rand(2, 224, 224, 3))
    cpu_model = random_init_(DaNet(cfg), seed=0).double()
    gpu_model = copy.deepcopy(cpu_model).to(dev, memory_format=torch.channels_last)
    with torch.inference_mode():
        ref = cpu_model(x)["para"]
        got, counts = launch_counts(lambda: gpu_model(x.to(dev))["para"].cpu())
    err = (got - ref).abs().max().item()
    print(f"phase 12: (b) {RESNET_CFG}, f64 B=2 224 px: para card vs CPU max abs err {err!r} (max|cpu| "
          f"{ref.abs().max().item()!r}; bar atol 1e-6, rtol 1e-9); launches {counts}")
    check(counts["part_crop_head"] == 1 and torch.allclose(got, ref, atol=1e-6, rtol=1e-9), "resnet f64 card vs CPU")
    del gpu_model, cpu_model
    para32 = Predictor(dev, torch.float32, cfg=cfg, seed=0).predict(x.float())["para"].double().cpu()
    err32 = (para32 - ref).abs().max().item()
    print(f"phase 12: (b) fp32 Predictor (TF32 off) on the card vs f64 on the CPU: para max abs err {err32!r} "
          f"(bar: atol 0.05, rtol 1e-3; with the scalar fp32 K1 kernel {FP32_SERVING_ERR_WAS['resnet']!r}, "
          f"{FP32_SERVING_ERR_WAS['run']})")
    check(bool(torch.isfinite(para32).all()) and torch.allclose(para32, ref, atol=0.05, rtol=1e-3),
          "resnet fp32 serving vs f64")
    predictor = Predictor(dev, torch.bfloat16, cfg=cfg, seed=0)
    images = torch.from_numpy(np.random.RandomState(5).rand(SERVE_BATCH, 224, 224, 3).astype(np.float32)
                              ).to(dev, torch.bfloat16)
    predictor.predict(images)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, counts = launch_counts(lambda: [predictor.predict(images) for _ in range(SERVE_REQUESTS)])
    dt = time.perf_counter() - t0
    for res in outs:
        check(tuple(res["para"].shape) == (SERVE_BATCH, 229) and tuple(res["vertices"].shape) == (SERVE_BATCH, 6890, 3)
              and all(bool(torch.isfinite(v).all()) for v in res.values()), "resnet bf16 serving: shapes, finite")
    check(counts["part_crop_head"] == SERVE_REQUESTS, f"resnet serving: K1 launches {counts}")
    print(f"phase 12: (b) served {SERVE_REQUESTS} requests of B={SERVE_BATCH} bf16 ({RESNET_CFG}) in {dt!r} s: "
          f"{SERVE_BATCH * SERVE_REQUESTS / dt!r} imgs/s (host clock, ends in synchronize); launches {counts}; "
          f"card {card}")
    profile_request(lambda: predictor.predict(images), SERVE_BATCH, card)
    out["serve"] = {"launches": counts["part_crop_head"], "imgs_per_s": SERVE_BATCH * SERVE_REQUESTS / dt}
    del predictor, outs, images
    torch.cuda.empty_cache()

    root = os.path.join(REPO, "build", "chip_smoke_archs")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    saved_tempdir, tempfile.tempdir = tempfile.tempdir, root     # the CLIs write their datasets there
    try:
        # (c) cli.train --cfg configs/danet_resnet.yaml (soup atlas: rasterize_flat), then
        # the training step's main path on that config (closed atlas, culling: K4)
        steps = 4
        argv = ["--cfg", os.path.join(REPO, RESNET_CFG), "--synthetic-data", "--num_samples", str(steps * TRAIN_BATCH),
                "--batch_size", str(TRAIN_BATCH), "--bf16", "--pretr_step", "1", "--num_epochs", "1",
                "--summary_steps", "1", "--vis_interval", "0", "--log_dir", root, "--name", "resnet"]
        t0 = time.perf_counter()
        trainer, counts = launch_counts(lambda: cli_train.main(argv))
        wall = time.perf_counter() - t0
        with open(os.path.join(root, "resnet", "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        check(trainer.state.step == steps and len(rows) == steps, f"cli.train resnet: {len(rows)} rows")
        check(all(np.isfinite(v) for r in rows for v in r.values()), "cli.train resnet: every logged value finite")
        check(counts["rasterize_flat"] >= steps, f"cli.train resnet: raster launches {counts}")
        print(f"phase 12: (c) cli.train {' '.join(argv)}: {steps} steps in {wall!r} s of command; loss_total "
              f"{[r['loss_total'] for r in rows]}; imgs/s by window {[r['imgs_per_sec'] for r in rows]}; launches "
              f"{counts}; card {card}")
        out["cli_train"] = counts
        del trainer
        tcfg = Config(danet=dataclasses.replace(cfg, compute_dtype="bfloat16"))
        smpl = synthetic_smpl_model()
        atlas, template = closed_synthetic_atlas(smpl.num_verts)
        renderer = R.IUVRenderer(atlas, 224, 56, cull_verts=template)
        model = random_init_(DaNet(tcfg.danet), seed=0).to(dev, memory_format=torch.channels_last)
        state = create_train_state(model, tcfg)
        step = make_train_step(model, smpl, tcfg, renderer=renderer)
        gen = torch.Generator(device=dev).manual_seed(0)
        batches = [batch_to_device(posed_keypoints(tcfg, smpl, synthetic_raw_batch(tcfg, TRAIN_BATCH, seed=30 + i),
                                                   seed=40 + i), dev) for i in range(3)]
        step(state, batches[0], gen)   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics, counts = launch_counts(lambda: [step(state, bt, gen)[1] for bt in batches[1:]])
        dt = time.perf_counter() - t0
        check(all(bool(torch.isfinite(v)) for m in metrics for v in m.values()), "resnet bf16 step: finite losses")
        check(counts["rasterize_flat_masked"] >= 2 and counts["part_crop_head"] == 0,
              f"resnet bf16 step: launches {counts} in 2 steps")
        print(f"phase 12: (c) train step, {RESNET_CFG}, bf16 B={TRAIN_BATCH}, closed atlas with culling: 2 steps in "
              f"{dt!r} s ({2 * TRAIN_BATCH / dt!r} imgs/s, host clock); loss_total "
              f"{[m['loss_total'].item() for m in metrics]}; launches {counts}; card {card}")
        out["train_step"] = counts
        del model, state, step, batches
        torch.cuda.empty_cache()

        # (d) the other regressors (HRNet-W48 backbone): f64 card vs CPU at B=2,
        # then one bf16 request of B=64
        archs = {"gcn_direct": DaNetConfig(refine_strategy="gcn_direct"), "lstm": DaNetConfig(refine_strategy="lstm"),
                 "lstm_direct": DaNetConfig(refine_strategy="lstm_direct"), "global": DaNetConfig(decomposed=False),
                 "refine_off": DaNetConfig(refinement=RefinementConfig(refine_on=False))}
        out["archs"] = {}
        for name, acfg in archs.items():
            cpu_model = random_init_(DaNet(acfg), seed=1).double()
            gpu_model = copy.deepcopy(cpu_model).to(dev, memory_format=torch.channels_last)
            with torch.inference_mode():
                ref = cpu_model(x)["para"]
                got = gpu_model(x.to(dev))["para"].cpu()
            err = (got - ref).abs().max().item()
            del cpu_model, gpu_model
            predictor = Predictor(dev, torch.bfloat16, cfg=acfg, seed=1)
            images = torch.from_numpy(np.random.RandomState(6).rand(ARCH_REQUEST_BATCH, 224, 224, 3).astype(np.float32))
            res, counts = launch_counts(lambda: predictor.predict(images.to(dev, torch.bfloat16)))
            t0 = time.perf_counter()
            predictor.predict(images.to(dev, torch.bfloat16))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            print(f"phase 12: (d) {name}: f64 B=2 para card vs CPU max abs err {err!r} (max|cpu| "
                  f"{ref.abs().max().item()!r}); bf16 request of B={ARCH_REQUEST_BATCH}: {ms!r} ms (host clock, the "
                  f"second), launches {counts}; card {card}")
            check(torch.allclose(got, ref, atol=1e-6, rtol=1e-9), f"{name}: f64 card vs CPU")
            check(tuple(res["para"].shape) == (ARCH_REQUEST_BATCH, 229)
                  and all(bool(torch.isfinite(v).all()) for v in res.values()), f"{name}: bf16 request finite")
            check(counts["part_crop_head"] == (1 if acfg.decomposed else 0), f"{name}: K1 launches {counts}")
            out["archs"][name] = {"k1": counts["part_crop_head"], "ms": ms}
            del predictor, res
            torch.cuda.empty_cache()

        # (e) the HMR baseline through cli.eval, fp32 (--bf16 is ignored for it),
        # h36m-p2 and lsp; cli.eval_coco refuses it
        n, b = EVAL_BATCHES * EVAL_BATCH, EVAL_BATCH
        coco_argv = ["--regressor", "hmr", "--synthetic-data", "--num_samples", str(n), "--batch_size", str(b)]
        data = coco_argv + ["--log_freq", "0"]
        out["hmr"] = {}
        for dataset, module, fn_name in (("h36m-p2", harness, "run_pose_eval"), ("lsp", lsp, "run_lsp_eval")):
            passes = []
            restore = timed_calls(module, fn_name, passes)
            try:
                res, counts = launch_counts(lambda: cli_eval.main(["--dataset", dataset, *data]))
            finally:
                restore()
            if dataset == "lsp":
                values = list(res["lsp"].values())
                check(len(values) == 4 and all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in values),
                      f"hmr lsp: {res['lsp']}")
                check(counts["rasterize_flat"] + counts["rasterize_flat_banded"] == EVAL_BATCHES,
                      f"hmr lsp: launches {counts}")
                summary = res["lsp"]
            else:
                pose = res["pose"]
                check(bool(np.isfinite(pose.mpjpe).all() and np.isfinite(pose.pa_mpjpe).all())
                      and pose.mpjpe.shape == (n,), "hmr h36m-p2: finite MPJPE / PA-MPJPE")
                summary = {"MPJPE mm": pose.mpjpe_mm, "PA-MPJPE mm": pose.pa_mpjpe_mm}
            check(counts["part_crop_head"] == 0, f"hmr {dataset}: K1 launches {counts}")
            print(f"phase 12: (e) cli.eval --dataset {dataset} {' '.join(data)}: {summary}; {n / passes[0]!r} imgs/s "
                  f"over the eval pass (host clock, fp32); launches {counts}; card {card}")
            out["hmr"][dataset] = {"imgs_per_s": n / passes[0], "launches": counts}
        try:
            cli_eval_coco.main(coco_argv)
            refused = None
        except ValueError as e:
            refused = str(e)
        check(refused is not None and "runs DaNet only" in refused, f"cli.eval_coco --regressor hmr: {refused}")
        print(f"phase 12: (e) cli.eval_coco --regressor hmr refuses: {refused}")
        return out
    finally:
        tempfile.tempdir = saved_tempdir
        shutil.rmtree(root, ignore_errors=True)


INPUT_MODES = ("iuv_gt", "iuv_feat", "iuv_gt_feat", "feat", "seg")
GT_INPUT_MODES = ("iuv_gt", "iuv_gt_feat")


def gt_render_inputs(b: int, s: int, seed: int):
    """A synthetic GT IUV image (B, S, S, 3) and GT SMPL keypoints
    (B, 24, 3) in [-0.8, 0.8], f64, for the GT modes' forward."""
    rng = np.random.RandomState(seed)
    part = rng.randint(0, 25, (b, s, s)).astype(np.float64)
    uv = np.stack([part / 24, rng.rand(b, s, s) * (part > 0), rng.rand(b, s, s) * (part > 0)], -1)
    kps = np.concatenate([rng.uniform(-0.8, 0.8, (b, 24, 2)), np.ones((b, 24, 1))], -1)
    return torch.from_numpy(uv), torch.from_numpy(kps)


def gt_forward_kwargs(mode: str, uv, kps) -> dict:
    if mode == "iuv_gt":
        return {"uv_image_gt": uv, "smpl_kps_gt": kps}
    return {"uv_image_gt": uv} if mode == "iuv_gt_feat" else {}


def phase13_input_modes(dev, card) -> dict:
    """The input-mode ablations at full size (HRNet-W48, 224 px): the eval
    forward card vs CPU, bf16 serving, the culled bf16 train step, an f64
    'iuv_gt' step card vs CPU and `cli.train` in 'iuv_gt_feat' (see the
    module docstring, phase 13)."""
    import contextlib
    import io
    import shutil
    import tempfile

    from danet_densepose2smpl_tpu_torch.cli import eval as cli_eval
    from danet_densepose2smpl_tpu_torch.cli import train as cli_train
    from danet_densepose2smpl_tpu_torch.config import Config, DaNetConfig
    from danet_densepose2smpl_tpu_torch.data.synthetic import synthetic_raw_batch
    from danet_densepose2smpl_tpu_torch.kernels import rasterizer as R
    from danet_densepose2smpl_tpu_torch.models.danet import DaNet
    from danet_densepose2smpl_tpu_torch.serve import Predictor, random_init_
    from danet_densepose2smpl_tpu_torch.smpl.densepose_atlas import closed_synthetic_atlas, synthetic_densepose_atlas
    from danet_densepose2smpl_tpu_torch.smpl.loader import synthetic_smpl_model
    from danet_densepose2smpl_tpu_torch.train.step import batch_to_device, create_train_state, make_train_step

    out = {"forward": {}, "serve": {}, "train": {}}
    # (a) each mode's eval forward in f64, card against CPU
    x = torch.from_numpy(np.random.RandomState(3).rand(2, 224, 224, 3))
    uv, kps = gt_render_inputs(2, 56, seed=4)
    for mode in INPUT_MODES:
        cpu_model = random_init_(DaNet(DaNetConfig(input_mode=mode)), seed=2).double()
        gpu_model = copy.deepcopy(cpu_model).to(dev, memory_format=torch.channels_last)
        kw = gt_forward_kwargs(mode, uv, kps)
        with torch.inference_mode():
            ref = cpu_model(x, **kw)["para"]
            got, counts = launch_counts(
                lambda: gpu_model(x.to(dev), **{k: v.to(dev) for k, v in kw.items()})["para"].cpu())
        err = (got - ref).abs().max().item()
        print(f"phase 13: (a) {mode}: f64 B=2 224 px eval para card vs CPU max abs err {err!r} (max|cpu| "
              f"{ref.abs().max().item()!r}; bar atol 1e-6, rtol 1e-9); launches {counts}")
        check(torch.allclose(got, ref, atol=1e-6, rtol=1e-9), f"{mode}: f64 card vs CPU")
        check(counts["part_crop_head"] == (1 if mode == "seg" else 0), f"{mode}: K1 launches {counts}")
        out["forward"][mode] = {"err": err, "k1": counts["part_crop_head"]}
        del cpu_model, gpu_model

    # (b) one bf16 serving request of B=64 per servable mode ('iuv' for comparison)
    images = torch.from_numpy(np.random.RandomState(6).rand(SERVE_BATCH, 224, 224, 3).astype(np.float32)
                              ).to(dev, torch.bfloat16)
    for mode in ("iuv", "iuv_feat", "feat", "seg"):
        predictor = Predictor(dev, torch.bfloat16, cfg=DaNetConfig(input_mode=mode), seed=2)
        predictor.predict(images)   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, counts = launch_counts(lambda: predictor.predict(images))
        ms = (time.perf_counter() - t0) * 1e3
        check(tuple(res["para"].shape) == (SERVE_BATCH, 229)
              and all(bool(torch.isfinite(v).all()) for v in res.values()), f"{mode}: bf16 request finite")
        check(counts["part_crop_head"] == (1 if mode in ("iuv", "seg") else 0), f"{mode}: K1 launches {counts}")
        print(f"phase 13: (b) {mode}: bf16 request of B={SERVE_BATCH}: {ms!r} ms (host clock, after a warm-up "
              f"request, ends in synchronize); launches {counts}; card {card}")
        out["serve"][mode] = {"ms": ms, "k1": counts["part_crop_head"]}
        del predictor, res
        torch.cuda.empty_cache()
    del images
    for mode in GT_INPUT_MODES:
        try:
            Predictor(dev, torch.bfloat16, cfg=DaNetConfig(input_mode=mode))
            refused = None
        except ValueError as e:
            refused = str(e)
        check(refused is not None and f"input_mode='{mode}'" in refused, f"Predictor {mode}: {refused}")
        print(f"phase 13: (b) Predictor refuses {mode}: {refused}")

    # (c) two culled bf16 B=64 steps of each mode on the closed atlas ('iuv' for comparison)
    smpl = synthetic_smpl_model()
    atlas, template = closed_synthetic_atlas(smpl.num_verts)
    renderer = R.IUVRenderer(atlas, 224, 56, cull_verts=template)
    base = Config(danet=DaNetConfig(compute_dtype="bfloat16"))
    batches = [batch_to_device(posed_keypoints(base, smpl, synthetic_raw_batch(base, TRAIN_BATCH, seed=50 + i),
                                               seed=60 + i), dev) for i in range(3)]
    for mode in ("iuv",) + INPUT_MODES:
        tcfg = Config(danet=DaNetConfig(input_mode=mode, compute_dtype="bfloat16"))
        model = random_init_(DaNet(tcfg.danet), seed=0).to(dev, memory_format=torch.channels_last)
        state = create_train_state(model, tcfg)
        step = make_train_step(model, smpl, tcfg, renderer=renderer)
        gen = torch.Generator(device=dev).manual_seed(0)
        step(state, batches[0], gen)   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        metrics, counts = launch_counts(lambda: [step(state, b, gen)[1] for b in batches[1:]])
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        check(all(bool(torch.isfinite(v)) for m in metrics for v in m.values()), f"{mode} bf16 step: finite losses")
        check(counts["rasterize_flat_masked"] == 2 and counts["part_crop_head"] == 0,
              f"{mode} bf16 step: launches {counts} in 2 steps")
        ratio_grad = None
        if mode == "iuv_gt":
            g = model.img2iuv.learned_ratio.grad
            ratio_grad = g.abs().sum().item()
            check(bool(torch.isfinite(g).all()) and ratio_grad > 0, f"iuv_gt: stn_ratio gradient {ratio_grad}")
        print(f"phase 13: (c) {mode}: 2 culled bf16 steps of B={TRAIN_BATCH}: {dt / 2 * 1e3!r} ms/step (host "
              f"clock, ends in synchronize), peak {peak!r} GiB; loss_total "
              f"{[m['loss_total'].item() for m in metrics]}; launches {counts}"
              + (f"; sum |d loss / d stn_ratio| {ratio_grad!r}" if ratio_grad is not None else "")
              + f"; card {card}")
        out["train"][mode] = {"ms_per_step": dt / 2 * 1e3, "peak_gib": peak,
                              "launches": counts["rasterize_flat_masked"]}
        del model, state, step, metrics
        torch.cuda.empty_cache()
    del batches

    # (d) one f64 'iuv_gt' step, card against CPU; the render's fp32 texture
    # values cast to f64 (exact: the flat raster copies them), so the oracle's
    # maps and crops run in f64, as tests/test_torch_input_modes*.py have them
    cfg = Config(danet=DaNetConfig(input_mode="iuv_gt", partdrop_rate=0.0, stn_center_jitter=0.0,
                                   stn_scale_jitter=0.0))
    raw = posed_keypoints(cfg, smpl, synthetic_raw_batch(cfg, 4, seed=2), seed=3)
    base_model = random_init_(DaNet(cfg.danet), seed=0).double()
    soup = R.IUVRenderer(synthetic_densepose_atlas(smpl), 224, 56)
    res = {}
    for where, d in (("cpu", torch.device("cpu")), ("cuda", dev)):
        model = copy.deepcopy(base_model).to(d)
        state = create_train_state(model, cfg)
        step = make_train_step(model, smpl, cfg, renderer=lambda verts, cam: soup(verts, cam).double())
        state, metrics = step(state, batch_to_device(raw, d, torch.float64))
        res[where] = ({k: v.item() for k, v in metrics.items()}, model.img2iuv.learned_ratio.grad.cpu())
    (lc, gc), (lg, gg) = res["cpu"], res["cuda"]
    loss_err = max(abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-30) for k in lc if lc[k] != 0)
    ratio_err = (gg - gc).abs().max().item() / gc.abs().max().item()
    print(f"phase 13: (d) f64 iuv_gt step 224 px B=4: {len(lc)} loss terms, max rel err card vs CPU {loss_err!r} "
          f"(tolerance 1e-9); stn_ratio gradient max rel err {ratio_err!r} (max|grad| {gc.abs().max().item()!r})")
    check(lc.keys() == lg.keys() and all(lg[k] == 0 for k in lc if lc[k] == 0), "iuv_gt f64: the same loss terms")
    check(loss_err <= 1e-9, f"iuv_gt f64 losses card vs CPU: {loss_err}")
    check(gc.abs().max().item() > 0 and ratio_err <= 1e-9, f"iuv_gt f64 stn_ratio gradient: {ratio_err}")
    out["f64_loss_err"] = loss_err
    del base_model, state, step

    # (e) cli.train in 'iuv_gt_feat' (4 steps, one vis interval); cli.eval refuses 'iuv_gt'
    root = os.path.join(REPO, "build", "chip_smoke_modes")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    saved_tempdir, tempfile.tempdir = tempfile.tempdir, root     # the CLI writes its dataset there
    try:
        yamls = {}
        for mode in GT_INPUT_MODES:
            yamls[mode] = os.path.join(root, f"{mode}.yaml")
            with open(yamls[mode], "w") as f:
                f.write(f"DANET:\n  INPUT_MODE: '{mode}'\n")
        steps = 4
        argv = ["--cfg", yamls["iuv_gt_feat"], "--synthetic-data", "--num_samples", str(steps * TRAIN_BATCH),
                "--batch_size", str(TRAIN_BATCH), "--bf16", "--pretr_step", "1", "--num_epochs", "1",
                "--summary_steps", "1", "--vis_interval", str(steps), "--log_dir", root, "--name", "gt_feat"]
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            trainer, counts = launch_counts(lambda: cli_train.main(argv))
        wall = time.perf_counter() - t0
        print(log.getvalue(), end="")
        with open(os.path.join(root, "gt_feat", "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        check(trainer.cfg.danet.input_mode == "iuv_gt_feat", f"cli.train mode {trainer.cfg.danet.input_mode}")
        check(trainer.state.step == steps and len(rows) == steps, f"cli.train iuv_gt_feat: {len(rows)} rows")
        check(all(np.isfinite(v) for r in rows for v in r.values()), "cli.train iuv_gt_feat: every value finite")
        check(counts["rasterize_flat"] == steps, f"cli.train iuv_gt_feat: raster launches {counts}")
        check(log.getvalue().count("vis skipped: input_mode='iuv_gt_feat'") == 1
              and not os.path.exists(os.path.join(root, "gt_feat", "vis")), "cli.train iuv_gt_feat: the vis skip")
        print(f"phase 13: (e) cli.train {' '.join(argv)}: {steps} steps in {wall!r} s of command; loss_total "
              f"{[r['loss_total'] for r in rows]}; imgs/s by window {[r['imgs_per_sec'] for r in rows]}; launches "
              f"{counts}; card {card}")
        out["cli_train"] = counts
        del trainer
        try:
            cli_eval.main(["--cfg", yamls["iuv_gt"], "--dataset", "h36m-p2", "--synthetic-data", "--num_samples",
                           "4", "--batch_size", "2"])
            refused = None
        except ValueError as e:
            refused = str(e)
        check(refused is not None and "input_mode='iuv_gt'" in refused, f"cli.eval iuv_gt: {refused}")
        print(f"phase 13: (e) cli.eval with INPUT_MODE 'iuv_gt' refuses: {refused}")
        return out
    finally:
        tempfile.tempdir = saved_tempdir
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


B128_CFG = "configs/danet_tpu_b128.yaml"
B128_BATCH = 128
DP_GLOBAL_BATCH, DP_RANKS = 8, 2
F64_QUIET = dict(partdrop_rate=0.0, stn_center_jitter=0.0, stn_scale_jitter=0.0)


def f64_case(batch: int, seed: int, **cfg_kw):
    """The f64 step checks' case: W48 at 64 px (heatmap 16), `batch` posed
    synthetic raw samples, the closed atlas with culling (K4 on the card),
    seeded random weights on the CPU. Returns (cfg, raw, smpl, renderer,
    base model)."""
    from danet_densepose2smpl_tpu_torch.config import Config, DaNetConfig
    from danet_densepose2smpl_tpu_torch.data.synthetic import synthetic_raw_batch
    from danet_densepose2smpl_tpu_torch.kernels import rasterizer as R
    from danet_densepose2smpl_tpu_torch.models.danet import DaNet
    from danet_densepose2smpl_tpu_torch.serve import random_init_
    from danet_densepose2smpl_tpu_torch.smpl.densepose_atlas import closed_synthetic_atlas
    from danet_densepose2smpl_tpu_torch.smpl.loader import synthetic_smpl_model

    cfg = Config(danet=DaNetConfig(img_size=64, heatmap_size=16, **cfg_kw))
    smpl = synthetic_smpl_model()
    atlas, template = closed_synthetic_atlas(smpl.num_verts)
    renderer = R.IUVRenderer(atlas, 64, 16, cull_verts=template)
    check(renderer.cull, "culling is on for the closed atlas")
    raw = posed_keypoints(cfg, smpl, synthetic_raw_batch(cfg, batch, seed=seed), seed=seed + 1)
    return cfg, raw, smpl, renderer, random_init_(DaNet(cfg.danet), seed=0).double()


def f64_step(cfg, raw, smpl, renderer, base, device, mesh=None, gen_seed=None) -> dict:
    """One f64 step of `base`'s weights under `cfg` on `device` (this rank's
    rows of `raw` with `mesh`): metrics, gradients, parameters after Adam
    and BatchNorm statistics on the CPU, and the launch counts of the step."""
    from danet_densepose2smpl_tpu_torch.models.danet import DaNet
    from danet_densepose2smpl_tpu_torch.parallel import replicate, shard_batch
    from danet_densepose2smpl_tpu_torch.train.step import batch_to_device, create_train_state, make_train_step

    model = DaNet(cfg.danet).double()
    model.load_state_dict(base.state_dict())
    model = model.to(device)
    if mesh is not None:
        replicate(model, mesh)
        raw = shard_batch(raw, mesh)
    state = create_train_state(model, cfg)
    step = make_train_step(model, smpl, cfg, renderer=renderer, mesh=mesh)
    batch = batch_to_device(raw, device, torch.float64)
    gen = None if gen_seed is None else torch.Generator(device=device).manual_seed(gen_seed)
    (state, metrics), counts = launch_counts(lambda: step(state, batch, gen))
    return {"metrics": {k: v.item() for k, v in metrics.items()},
            "grads": {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
            "params": {n: p.detach().cpu() for n, p in model.named_parameters()},
            "stats": {n: b.detach().cpu() for n, b in model.named_buffers()
                      if n.endswith(("running_mean", "running_var"))},
            "tracked": {n: b.item() for n, b in model.named_buffers() if n.endswith("num_batches_tracked")},
            "launches": counts}


def f64_errors(got: dict, ref: dict) -> dict:
    """The worst error of each kind over its bar (at most 1 passes): losses
    rtol 1e-9; gradients 1e-9 of their tensor's largest entry + 1e-12 (the
    heatmap head's bias has an exact gradient of 0); BatchNorm statistics
    rtol 1e-9, atol 1e-10."""
    check(got["metrics"].keys() == ref["metrics"].keys(), "the same loss terms")
    return {
        "losses": max(abs(got["metrics"][k] - v) / (1e-9 * abs(v) + 1e-300) for k, v in ref["metrics"].items()),
        "gradients": max(((got["grads"][n] - g).abs().max() / (1e-9 * g.abs().max() + 1e-12)).item()
                         for n, g in ref["grads"].items()),
        "statistics": max(((got["stats"][n] - b).abs() / (1e-9 * b.abs() + 1e-10)).max().item()
                          for n, b in ref["stats"].items()),
    }


def dp_eval_case(device, mesh=None):
    """The pose eval step of an eval-mode f64 W48 model at 64 px on a
    global batch of 8 (each rank's rows with `mesh`): (mpjpe, pa, para) on
    the CPU."""
    from danet_densepose2smpl_tpu_torch.config import DaNetConfig
    from danet_densepose2smpl_tpu_torch.eval.harness import make_eval_step, synthetic_h36m_regressor
    from danet_densepose2smpl_tpu_torch.models.danet import DaNet
    from danet_densepose2smpl_tpu_torch.serve import random_init_
    from danet_densepose2smpl_tpu_torch.smpl.loader import synthetic_smpl_model

    model = random_init_(DaNet(DaNetConfig(img_size=64, heatmap_size=16)), seed=1).double().to(device)
    smpl = synthetic_smpl_model()
    rng = np.random.RandomState(3)
    b = DP_GLOBAL_BATCH
    args = (rng.rand(b, 64, 64, 3), rng.randn(b, 72) * 0.2, rng.randn(b, 10) * 0.3, np.zeros(b, np.int32),
            np.concatenate([rng.randn(b, 24, 3) * 0.3, np.ones((b, 24, 1))], -1))
    step = make_eval_step(lambda img: model(torch.as_tensor(img, device=device))["para"], smpl,
                          synthetic_h36m_regressor(smpl.num_verts, seed=1), np.arange(14), np.arange(14), False,
                          mesh=mesh)
    (mpjpe, pa), para = step(*args)
    return mpjpe.cpu(), pa.cpu(), para.cpu()


def dp_case(**cfg_kw):
    """Phase 14 (c)'s global batch: W48 f64 at 64 px, default PartDrop and
    STN jitter (and `cfg_kw`), 8 rows whose masks differ between the two
    ranks' halves."""
    case = f64_case(DP_GLOBAL_BATCH, seed=30, **cfg_kw)
    raw = case[1]
    raw["has_smpl"] = np.array([1, 1, 1, 1, 1, 0, 0, 1], np.float32)
    raw["has_dp"] = np.array([0, 1, 0, 0, 1, 1, 0, 1], np.float32)
    raw["is_dp_dataset"] = np.array([0, 0, 0, 0, 1, 0, 1, 0], np.float32)
    raw["has_pose_3d"] = np.array([1, 0, 1, 1, 0, 0, 1, 0], np.float32)
    return case


def phase14_rank(rank: int, world: int, port: int, out_dir: str, device: str, cfg_kw: dict | None = None) -> None:
    """Phase 14 (c), one rank: a process on `device` (cuda:0 for every rank)
    in a gloo process group (the environment torchrun would give it), the
    data-parallel f64 step on its rows of `dp_case(**cfg_kw)` and the
    data-parallel eval."""
    from danet_densepose2smpl_tpu_torch.parallel import make_mesh

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0", MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    dev = torch.device(device)
    mesh = make_mesh(dev, backend="gloo")
    try:
        out = f64_step(*dp_case(**(cfg_kw or {})), dev, mesh=mesh, gen_seed=7)
        out["eval"] = dp_eval_case(dev, mesh)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        mesh.close()


def timed_steps(step, state, batches, gen, dev) -> tuple[float, float, list]:
    """A warm-up step on batches[0], then the others timed (host clock, ends
    in synchronize) with the peak memory: (ms/step, peak GiB, metrics)."""
    step(state, batches[0], gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    metrics = [step(state, b, gen)[1] for b in batches[1:]]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return dt / (len(batches) - 1) * 1e3, torch.cuda.max_memory_allocated(dev) / 2**30, metrics


def cli_train_run(dev, card, root: str, name: str, argv: list, steps: int, label: str):
    """`cli.train.main(argv)` in-process under `root/name`, the launch
    counts zeroed just before it and read just after: `steps` metric rows,
    every value finite, one raster a step and no K1, a checkpoint at the
    last step. Returns (trainer, counts, imgs/s by window)."""
    from danet_densepose2smpl_tpu_torch.cli import train as cli_train

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    trainer, counts = launch_counts(lambda: cli_train.main(argv + ["--name", name, "--log_dir", root]))
    wall = time.perf_counter() - t0
    with open(os.path.join(root, name, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    check(trainer.state.step == steps and len(rows) == steps, f"{name}: {len(rows)} rows in {steps} steps")
    check(all(np.isfinite(v) for r in rows for v in r.values()), f"{name}: every logged value finite")
    check(counts["rasterize_flat"] + counts["rasterize_flat_masked"] == steps and counts["part_crop_head"] == 0,
          f"{name}: launches {counts} in {steps} steps")
    check(os.path.isfile(os.path.join(root, name, "checkpoints", f"ckpt_{steps:09d}.pt")), f"{name}: checkpoint")
    rates = [r["imgs_per_sec"] for r in rows]
    print(f"{label}: cli.train {' '.join(argv)}: {steps} steps in {wall!r} s of command; loss_total "
          f"{[r['loss_total'] for r in rows]}; imgs/s by window {rates}; peak "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30!r} GiB; launches {counts}; card {card}")
    return trainer, counts, rates


def phase14_chunks_dp(dev, card) -> dict:
    """The last two modules (see the module docstring, phase 14): the
    chunked crop + head in training (`configs/danet_tpu_b128.yaml`) and
    data-parallel training and eval."""
    import shutil
    import socket
    import tempfile

    import torch.multiprocessing as mp

    from danet_densepose2smpl_tpu_torch.config import load_config
    from danet_densepose2smpl_tpu_torch.data.synthetic import synthetic_raw_batch
    from danet_densepose2smpl_tpu_torch.kernels import rasterizer as R
    from danet_densepose2smpl_tpu_torch.models.danet import DaNet
    from danet_densepose2smpl_tpu_torch.parallel import make_mesh
    from danet_densepose2smpl_tpu_torch.serve import random_init_
    from danet_densepose2smpl_tpu_torch.smpl.densepose_atlas import closed_synthetic_atlas
    from danet_densepose2smpl_tpu_torch.smpl.loader import synthetic_smpl_model
    from danet_densepose2smpl_tpu_torch.train.step import batch_to_device, create_train_state, make_train_step

    out = {}
    root = os.path.join(REPO, "build", "chip_smoke_chunks_dp")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    saved_tempdir, tempfile.tempdir = tempfile.tempdir, root     # the CLI writes its dataset there

    def cli_run(name, argv, steps, batch):
        return cli_train_run(dev, card, root, name, argv, steps, "phase 14")

    try:
        # (a) the chunked crop + head: cli.train on the repo's B=128 config,
        # in-process (the synthetic soup atlas cannot be culled: --raster_cull
        # switches itself off with a warning and K2 renders)
        steps = 4
        cfg_path = os.path.join(REPO, B128_CFG)
        argv = ["--cfg", cfg_path, "--raster_cull", "--synthetic-data", "--num_samples", str(steps * B128_BATCH),
                "--batch_size", str(B128_BATCH), "--pretr_step", "1", "--num_epochs", "1", "--summary_steps", "1",
                "--vis_interval", "0"]
        trainer, counts, rates = cli_run("b128", argv, steps, B128_BATCH)
        d = trainer.cfg.danet
        check(d.part_head_chunks == 3 and d.compute_dtype == "bfloat16" and trainer.cfg.train.batch_size == 128,
              f"{B128_CFG}: chunks {d.part_head_chunks}, {d.compute_dtype}, B={trainer.cfg.train.batch_size}")
        out["b128_cli"] = {"launches": counts, "imgs_per_sec": rates}
        del trainer
        torch.cuda.empty_cache()

        # the culled bf16 B=128 step (closed atlas) with 3 chunks and in one shot
        smpl = synthetic_smpl_model()
        atlas, template = closed_synthetic_atlas(smpl.num_verts)
        renderer = R.IUVRenderer(atlas, 224, 56, cull_verts=template)
        base_cfg = load_config(cfg_path)
        batches = [batch_to_device(posed_keypoints(base_cfg, smpl, synthetic_raw_batch(base_cfg, B128_BATCH,
                                                                                       seed=70 + i), seed=80 + i), dev)
                   for i in range(3)]
        out["b128_step"] = {}
        for chunks in (3, 1):
            cfg = load_config(cfg_path, overrides={"danet.part_head_chunks": chunks})
            model = random_init_(DaNet(cfg.danet), seed=0).to(dev, memory_format=torch.channels_last)
            state = create_train_state(model, cfg)
            step = make_train_step(model, smpl, cfg, renderer=renderer)
            gen = torch.Generator(device=dev).manual_seed(0)
            (ms, peak, metrics), counts = launch_counts(lambda: timed_steps(step, state, batches, gen, dev))
            check(all(bool(torch.isfinite(v)) for m in metrics for v in m.values()), f"chunks {chunks}: finite")
            check(counts["rasterize_flat_masked"] == 3 and counts["part_crop_head"] == 0,
                  f"chunks {chunks}: launches {counts} in 3 steps")
            print(f"phase 14: (a) culled bf16 step, B={B128_BATCH}, part_head_chunks={chunks}: {ms!r} ms/step "
                  f"(2 steps after a warm-up, host clock, ends in synchronize), peak {peak!r} GiB; loss_total "
                  f"{[m['loss_total'].item() for m in metrics]}; launches {counts} (warm-up included); card {card}")
            out["b128_step"][chunks] = {"ms_per_step": ms, "peak_gib": peak, "launches": counts}
            del model, state, step, metrics
            torch.cuda.empty_cache()
        del batches

        # the chunked f64 step: card vs CPU, and chunked vs one-shot on the card
        case = f64_case(4, seed=2, part_head_chunks=3, **F64_QUIET)
        cfg3, raw, smpl64, renderer64, base = case
        one_cfg = load_config(None, overrides={"danet.img_size": 64, "danet.heatmap_size": 16,
                                               **{f"danet.{k}": v for k, v in F64_QUIET.items()}})
        t0 = time.perf_counter()
        cpu3 = f64_step(*case, torch.device("cpu"))
        cpu_s = time.perf_counter() - t0
        card3 = f64_step(*case, dev)
        card1 = f64_step(one_cfg, raw, smpl64, renderer64, base, dev)
        vs_cpu, vs_one = f64_errors(card3, cpu3), f64_errors(card3, card1)
        print(f"phase 14: (a) f64 step W48 64 px B=4, part_head_chunks=3 (CPU step {cpu_s:.1f} s): card vs CPU "
              f"worst error / bar {vs_cpu}; chunked vs one-shot on the card {vs_one}; launches {card3['launches']}")
        check(max(vs_cpu.values()) <= 1 and max(vs_one.values()) <= 1, "f64 chunked step bars")
        check(card3["launches"]["rasterize_flat_masked"] == 1, f"f64 chunked step: {card3['launches']}")
        out["f64_chunks"] = {"vs_cpu": vs_cpu, "vs_one_shot": vs_one}

        # (b) data parallel at one rank over NCCL: cli.train --data_parallel
        steps = 4
        argv = ["--data_parallel", "--synthetic-data", "--num_samples", str(steps * TRAIN_BATCH), "--batch_size",
                str(TRAIN_BATCH), "--bf16", "--pretr_step", "1", "--num_epochs", "1", "--summary_steps", "1",
                "--vis_interval", "0"]
        trainer, counts, rates = cli_run("dp", argv, steps, TRAIN_BATCH)
        check(trainer.mesh is not None and trainer.mesh.size == 1 and trainer.mesh.backend == "nccl",
              f"cli.train --data_parallel: mesh {trainer.mesh}")
        out["dp_cli"] = {"launches": counts, "imgs_per_sec": rates}
        del trainer
        torch.cuda.empty_cache()

        # the culled bf16 B=64 step, plain and at one NCCL rank, in turns
        mesh = make_mesh(dev)
        try:
            cfg = load_config(None, overrides={"danet.compute_dtype": "bfloat16"})
            batches = [batch_to_device(posed_keypoints(cfg, smpl, synthetic_raw_batch(cfg, TRAIN_BATCH, seed=90 + i),
                                                       seed=95 + i), dev) for i in range(3)]
            model = random_init_(DaNet(cfg.danet), seed=0).to(dev, memory_format=torch.channels_last)
            state = create_train_state(model, cfg)
            steps_by = {"plain": make_train_step(model, smpl, cfg, renderer=renderer),
                        "dp": make_train_step(model, smpl, cfg, renderer=renderer, mesh=mesh)}
            gen = torch.Generator(device=dev).manual_seed(0)
            turns = {"plain": [], "dp": []}
            for name in ("plain", "dp", "dp", "plain"):
                ms, peak, metrics = timed_steps(steps_by[name], state, batches, gen, dev)
                check(all(bool(torch.isfinite(v)) for m in metrics for v in m.values()), f"{name}: finite")
                turns[name].append(ms)
            print(f"phase 14: (b) culled bf16 step B={TRAIN_BATCH}, plain vs data-parallel at one NCCL rank, in "
                  f"turns (ms/step, 2 steps after a warm-up each): {turns}; card {card}")
            out["world1_ms"] = turns
            del model, state, steps_by, batches
            torch.cuda.empty_cache()

            # the f64 step at one NCCL rank vs the plain one (B=4, noise on)
            case = f64_case(4, seed=40)
            plain = f64_step(*case, dev, gen_seed=7)
            dp = f64_step(*case, dev, mesh=mesh, gen_seed=7)
            err = f64_errors(dp, plain)
            print(f"phase 14: (b) f64 step W48 64 px B=4 at one NCCL rank vs plain: worst error / bar {err}; "
                  f"launches {dp['launches']}")
            check(max(err.values()) <= 1, "f64 step at one rank vs plain")
            check(dp["launches"]["rasterize_flat_masked"] == 1, f"world-1 f64 step: {dp['launches']}")
            out["world1_f64"] = {"err": err, "launches": dp["launches"]}
        finally:
            mesh.close()

        # (c) two ranks over gloo on the one card, against one process
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        t0 = time.perf_counter()
        ctx = mp.spawn(phase14_rank, args=(DP_RANKS, port, root, str(dev)), nprocs=DP_RANKS, join=False)
        try:
            single = f64_step(*dp_case(), dev, gen_seed=7)
            single_eval = dp_eval_case(dev)
            deadline = time.monotonic() + 400
            while not ctx.join(timeout=5):
                check(time.monotonic() < deadline, "the two ranks finished within 400 s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.terminate()
                    proc.join(10)
        ranks = [torch.load(os.path.join(root, f"rank{r}.pt")) for r in range(DP_RANKS)]
        errs = [f64_errors(r, single) for r in ranks]
        equal = all(torch.equal(ranks[0]["params"][n], ranks[1]["params"][n]) for n in single["params"])
        eval_err = max(((g - w).abs().max() / w.abs().max().clamp_min(1e-300)).item()
                       for r in ranks for g, w in zip(r["eval"], single_eval))
        print(f"phase 14: (c) {DP_RANKS} gloo ranks on cuda:0, f64 W48 64 px, global B={DP_GLOBAL_BATCH} (noise on, "
              f"masks differ between the halves) vs one process: worst error / bar by rank {errs}; parameters "
              f"bit-equal across ranks {equal}; eval (mpjpe, pa, para) max rel err {eval_err!r}; launches by rank "
              f"{[r['launches'] for r in ranks]}; {time.perf_counter() - t0:.1f} s")
        check(all(max(e.values()) <= 1 for e in errs), "two-rank f64 step vs one process")
        check(equal, "the ranks' parameters are bit-equal after the step")
        check(eval_err <= 1e-12 and all(r["eval"][2].shape == (DP_GLOBAL_BATCH, 229) for r in ranks),
              f"two-rank eval vs one rank: {eval_err}")
        check(all(r["launches"]["rasterize_flat_masked"] == 1 for r in ranks), "K4 once per rank per step")
        out["two_ranks"] = {"errs": errs, "launches": [r["launches"] for r in ranks], "eval_err": eval_err}
        return out
    finally:
        tempfile.tempdir = saved_tempdir
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


REMAT_SCOPES = (None, "backbone", "modules", "early")
REMAT_BATCH, REMAT_BIG_BATCH = 128, 384
PAD_BATCH, PAD_REQUESTS = 64, 8
DP_MASK_BATCH = 64


def phase15_remat_pad(dev, card) -> dict:
    """The last refusals (see the module docstring, phase 15): backbone
    rematerialisation, the padded HRNet (K1 at C=64), and the checkpoint
    preflight, the native RLE codec and the profiling module."""
    import shutil
    import tempfile

    root = os.path.join(REPO, "build", "chip_smoke_remat_pad")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    saved_tempdir, tempfile.tempdir = tempfile.tempdir, root     # the CLI writes its dataset there
    try:
        out = {"remat": phase15_remat(dev, card, root)}
        out["k1"] = phase15_k1_pad(dev, card)
        out["pad"] = phase15_pad_models(dev, card)
        out["small"] = phase15_small_modules(dev, card, root)
        return out
    finally:
        tempfile.tempdir = saved_tempdir
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def phase15_remat(dev, card, root: str) -> dict:
    """(a): the culled bf16 B=128 step under each remat scope, one B=384
    step under 'modules', the f64 step per scope against no remat, two gloo
    ranks with 'modules' against one process, `cli.train --remat`."""
    import socket

    import torch.multiprocessing as mp

    from danet_densepose2smpl_tpu_torch.config import load_config
    from danet_densepose2smpl_tpu_torch.data.synthetic import synthetic_raw_batch
    from danet_densepose2smpl_tpu_torch.kernels import rasterizer as R
    from danet_densepose2smpl_tpu_torch.models.danet import DaNet
    from danet_densepose2smpl_tpu_torch.serve import random_init_
    from danet_densepose2smpl_tpu_torch.smpl.densepose_atlas import closed_synthetic_atlas
    from danet_densepose2smpl_tpu_torch.smpl.loader import synthetic_smpl_model
    from danet_densepose2smpl_tpu_torch.train.step import batch_to_device, create_train_state, make_train_step

    out = {}
    smpl = synthetic_smpl_model()
    atlas, template = closed_synthetic_atlas(smpl.num_verts)
    renderer = R.IUVRenderer(atlas, 224, 56, cull_verts=template)

    def remat_cfg(scope):
        over = {"danet.compute_dtype": "bfloat16"}
        if scope is not None:
            over.update({"danet.remat_backbone": True, "danet.remat_scope": scope})
        return load_config(None, overrides=over)

    def batches(cfg, b, n, seed):
        return [batch_to_device(posed_keypoints(cfg, smpl, synthetic_raw_batch(cfg, b, seed=seed + i), seed=seed + 50 + i),
                                dev) for i in range(n)]

    # the culled bf16 B=128 step without remat and under each scope
    data = batches(remat_cfg(None), REMAT_BATCH, 3, seed=100)
    out["b128"] = {}
    for scope in REMAT_SCOPES:
        cfg = remat_cfg(scope)
        model = random_init_(DaNet(cfg.danet), seed=0).to(dev, memory_format=torch.channels_last)
        state = create_train_state(model, cfg)
        step = make_train_step(model, smpl, cfg, renderer=renderer)
        gen = torch.Generator(device=dev).manual_seed(0)
        rng = torch.cuda.get_rng_state(dev)
        (ms, peak, metrics), counts = launch_counts(lambda: timed_steps(step, state, data, gen, dev))
        check(torch.equal(torch.cuda.get_rng_state(dev), rng), f"remat {scope}: the CUDA RNG is untouched")
        check(all(bool(torch.isfinite(v)) for m in metrics for v in m.values()), f"remat {scope}: finite")
        check(counts["rasterize_flat_masked"] == 3 and counts["part_crop_head"] == 0,
              f"remat {scope}: launches {counts} in 3 steps")
        print(f"phase 15: (a) culled bf16 step, B={REMAT_BATCH}, remat {scope or 'none'}: {ms!r} ms/step (2 steps "
              f"after a warm-up, host clock, ends in synchronize), peak {peak!r} GiB; loss_total "
              f"{[m['loss_total'].item() for m in metrics]}; launches {counts} (warm-up included); card {card}")
        out["b128"][scope or "none"] = {"ms_per_step": ms, "peak_gib": peak, "launches": counts}
        del model, state, step, metrics
        torch.cuda.empty_cache()
    del data

    # one bf16 B=384 step under 'modules'
    cfg = remat_cfg("modules")
    big = batches(cfg, REMAT_BIG_BATCH, 1, seed=200)[0]
    model = random_init_(DaNet(cfg.danet), seed=0).to(dev, memory_format=torch.channels_last)
    state = create_train_state(model, cfg)
    step = make_train_step(model, smpl, cfg, renderer=renderer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    (_, metrics), counts = launch_counts(lambda: step(state, big, torch.Generator(device=dev).manual_seed(0)))
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    check(all(bool(torch.isfinite(v)) for v in metrics.values()), "B=384 'modules' step: finite losses")
    check(counts["rasterize_flat_masked"] == 1, f"B=384 step: launches {counts}")
    print(f"phase 15: (a) culled bf16 step, B={REMAT_BIG_BATCH}, remat 'modules': one step {dt * 1e3!r} ms (the "
          f"first at this batch, host clock), peak {peak!r} GiB; loss_total {metrics['loss_total'].item()!r}; "
          f"launches {counts}; card {card}")
    out["b384"] = {"ms": dt * 1e3, "peak_gib": peak, "launches": counts}
    del model, state, step, big, metrics
    torch.cuda.empty_cache()

    # the f64 step under each scope against no remat, on the card
    plain = f64_step(*f64_case(4, seed=60), dev, gen_seed=7)
    out["f64"] = {}
    for scope in REMAT_SCOPES[1:]:
        got = f64_step(*f64_case(4, seed=60, remat_backbone=True, remat_scope=scope), dev, gen_seed=7)
        err = f64_errors(got, plain)
        same_stats = all(torch.equal(got["stats"][n], b) for n, b in plain["stats"].items())
        print(f"phase 15: (a) f64 step W48 64 px B=4 (noise on), remat {scope} vs none on the card: worst error / "
              f"bar {err}; BatchNorm statistics bit-equal {same_stats}; num_batches_tracked equal "
              f"{got['tracked'] == plain['tracked']}; launches {got['launches']}")
        check(max(err.values()) <= 1, f"f64 remat {scope} step bars")
        check(got["tracked"] == plain["tracked"] and set(plain["tracked"].values()) == {1},
              f"remat {scope}: each BatchNorm counted one batch")
        check(got["launches"]["rasterize_flat_masked"] == 1, f"f64 remat {scope}: {got['launches']}")
        out["f64"][scope] = {"err": err, "stats_bit_equal": same_stats}

    # two gloo ranks on cuda:0 under 'modules' against one process without remat
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    remat_kw = {"remat_backbone": True, "remat_scope": "modules"}
    ctx = mp.spawn(phase14_rank, args=(DP_RANKS, port, root, str(dev), remat_kw), nprocs=DP_RANKS, join=False)
    try:
        single = f64_step(*dp_case(), dev, gen_seed=7)
        deadline = time.monotonic() + 400
        while not ctx.join(timeout=5):
            check(time.monotonic() < deadline, "the two ranks finished within 400 s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt")) for r in range(DP_RANKS)]
    errs = [f64_errors(r, single) for r in ranks]
    equal = all(torch.equal(ranks[0]["params"][n], ranks[1]["params"][n]) for n in single["params"])
    print(f"phase 15: (a) {DP_RANKS} gloo ranks on cuda:0 with remat 'modules', f64 W48 64 px, global "
          f"B={DP_GLOBAL_BATCH} (noise on) vs one process without remat: worst error / bar by rank {errs}; parameters "
          f"bit-equal across ranks {equal}; num_batches_tracked equal "
          f"{all(r['tracked'] == single['tracked'] for r in ranks)}; launches by rank "
          f"{[r['launches'] for r in ranks]}; {time.perf_counter() - t0:.1f} s")
    check(all(max(e.values()) <= 1 for e in errs), "two-rank remat f64 step vs one process")
    check(equal and all(r["tracked"] == single["tracked"] for r in ranks), "the ranks agree")
    check(all(r["launches"]["rasterize_flat_masked"] == 1 for r in ranks), "K4 once per rank per step")
    out["two_ranks"] = {"errs": errs, "launches": [r["launches"] for r in ranks]}

    # cli.train --remat in-process
    steps = 4
    argv = ["--remat", "--synthetic-data", "--num_samples", str(steps * TRAIN_BATCH), "--batch_size", str(TRAIN_BATCH),
            "--bf16", "--pretr_step", "1", "--num_epochs", "1", "--summary_steps", "1", "--vis_interval", "0"]
    trainer, counts, rates = cli_train_run(dev, card, root, "remat", argv, steps, "phase 15: (a)")
    check(trainer.cfg.danet.remat_backbone and trainer.cfg.danet.remat_scope == "backbone",
          f"cli.train --remat: {trainer.cfg.danet}")
    out["cli"] = {"launches": counts, "imgs_per_sec": rates}
    del trainer
    torch.cuda.empty_cache()
    return out


def phase15_k1_pad(dev, card) -> dict:
    """(b): K1 at the padded HRNet's width (56x56x64) and at C=48 against
    its plain version, and its time at B=64 bf16, C=64, beside the plain
    version, the unfused route and the launch at C=48 in the same turns."""
    cases = [("bfloat16", PAD_BATCH, 56, 64, 21), ("float32", 16, 56, 64, 21), ("float64", 2, 56, 64, 21),
             ("bfloat16", 1, 56, 48, 21), ("float32", 1, 56, 48, 21), ("float64", 1, 56, 48, 21)]
    err = k1_check_cases("15: (b)", dev, cases, seed=4)
    c48 = k1_inputs(PAD_BATCH, 56, 56, 48, 56, torch.bfloat16, dev, seed=2)
    out = {**k1_timing("15: (b)", dev, card, 64, beside={"C=48": k1_launch(c48, 56)}), "max_abs_err": err}
    ratio = out["launch_ms"]["plan"] / out["launch_ms"]["C=48"]
    print(f"phase 15: (b) K1 launch alone at C=64 / at C=48, the same turns: {ratio!r}; card {card}")
    return {**out, "c64_over_c48": ratio}


def phase15_pad_models(dev, card) -> dict:
    """(b): the padded DaNet: f64 serving card vs CPU, bf16 requests beside
    W48 in turns, one culled bf16 step."""
    from danet_densepose2smpl_tpu_torch.config import Config, DaNetConfig
    from danet_densepose2smpl_tpu_torch.data.synthetic import synthetic_raw_batch
    from danet_densepose2smpl_tpu_torch.kernels import rasterizer as R
    from danet_densepose2smpl_tpu_torch.models.danet import DaNet
    from danet_densepose2smpl_tpu_torch.serve import Predictor, random_init_
    from danet_densepose2smpl_tpu_torch.smpl.densepose_atlas import closed_synthetic_atlas
    from danet_densepose2smpl_tpu_torch.smpl.loader import synthetic_smpl_model
    from danet_densepose2smpl_tpu_torch.train.step import batch_to_device, create_train_state, make_train_step

    out = {}
    pad = DaNetConfig(hrnet_pad_channels=True)
    # f64 serving: card vs CPU
    model = random_init_(DaNet(pad), seed=3).double()
    x = torch.from_numpy(np.random.RandomState(21).rand(2, 224, 224, 3))
    with torch.no_grad():
        ref = model(x)["para"]
        model = model.to(dev)
        got, counts = launch_counts(lambda: model(x.to(dev))["para"].cpu())
    err = (got - ref).abs().max().item()
    print(f"phase 15: (b) padded DaNet f64 B=2 224 px, card vs CPU: para max abs err {err!r}; launches {counts}")
    check(torch.allclose(got, ref, atol=1e-6, rtol=1e-9), f"padded f64 serving: {err}")
    check(counts["part_crop_head"] == 1, f"padded f64 serving: K1 once ({counts})")
    del model
    torch.cuda.empty_cache()

    # bf16 requests, padded and W48 in turns
    images = torch.from_numpy(np.random.RandomState(22).rand(PAD_BATCH, 224, 224, 3).astype(np.float32)).to(
        dev, torch.bfloat16)
    predictors = {"padded": Predictor(dev, torch.bfloat16, cfg=pad, seed=0),
                  "w48": Predictor(dev, torch.bfloat16, seed=0)}
    rates, launches = {k: [] for k in predictors}, {}
    for p in predictors.values():
        p.predict(images)      # warm-up
    for name in ("padded", "w48", "w48", "padded"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs, counts = launch_counts(lambda: [predictors[name].predict(images) for _ in range(PAD_REQUESTS)])
        dt = time.perf_counter() - t0
        check(all(o["para"].shape == (PAD_BATCH, 229) and bool(torch.isfinite(o["vertices"]).all()) for o in outs),
              f"{name} requests: shapes, finite")
        check(counts["part_crop_head"] == PAD_REQUESTS, f"{name}: K1 once a request ({counts})")
        rates[name].append(PAD_BATCH * PAD_REQUESTS / dt)
        launches[name] = counts["part_crop_head"]
    print(f"phase 15: (b) {PAD_REQUESTS} bf16 requests of B={PAD_BATCH}, padded vs W48 in turns (imgs/s, host clock, "
          f"ends in synchronize): {rates}; K1 launches {launches}; card {card}")
    out["serve"] = {"imgs_per_sec": rates, "launches": launches}
    del predictors, images, outs
    torch.cuda.empty_cache()

    # one culled bf16 B=64 step of the padded model
    cfg = Config(danet=DaNetConfig(hrnet_pad_channels=True, compute_dtype="bfloat16"))
    smpl = synthetic_smpl_model()
    atlas, template = closed_synthetic_atlas(smpl.num_verts)
    renderer = R.IUVRenderer(atlas, 224, 56, cull_verts=template)
    data = [batch_to_device(posed_keypoints(cfg, smpl, synthetic_raw_batch(cfg, PAD_BATCH, seed=300 + i),
                                            seed=350 + i), dev) for i in range(3)]
    model = random_init_(DaNet(cfg.danet), seed=0).to(dev, memory_format=torch.channels_last)
    state = create_train_state(model, cfg)
    step = make_train_step(model, smpl, cfg, renderer=renderer)
    (ms, peak, metrics), counts = launch_counts(
        lambda: timed_steps(step, state, data, torch.Generator(device=dev).manual_seed(0), dev))
    check(all(bool(torch.isfinite(v)) for m in metrics for v in m.values()), "padded step: finite")
    check(counts["rasterize_flat_masked"] == 3, f"padded step: launches {counts}")
    print(f"phase 15: (b) culled bf16 step of the padded DaNet, B={PAD_BATCH}: {ms!r} ms/step (2 steps after a "
          f"warm-up), peak {peak!r} GiB; launches {counts}; card {card}")
    out["step"] = {"ms_per_step": ms, "peak_gib": peak, "launches": counts}
    del model, state, step, data
    torch.cuda.empty_cache()
    return out


def phase15_small_modules(dev, card, root: str) -> dict:
    """(c): `cli.port --check` GO and NO-GO, the native RLE decode of a
    batch's DensePose masks against numpy, `utils.profiling.trace` around
    one request."""
    from danet_densepose2smpl_tpu_torch.cli import port as cli_port
    from danet_densepose2smpl_tpu_torch.data import rle
    from danet_densepose2smpl_tpu_torch.models.danet import DaNet
    from danet_densepose2smpl_tpu_torch.serve import random_init_

    out = {}
    # the preflight on a synthetic reference .pt: intact, then a key dropped
    sd = {"module." + k: v for k, v in random_init_(DaNet(), seed=0).state_dict().items()}
    pt = os.path.join(root, "ckpt.pt")
    torch.save({"model": sd}, pt)
    t0 = time.perf_counter()
    go = cli_port.main(["--check", pt, "--limit", "3"])
    go_s = time.perf_counter() - t0
    del sd["module.img2iuv.iuv_est.final_pred.predict_u.weight"]
    torch.save({"model": sd}, pt)
    nogo = cli_port.main(["--check", pt, "--limit", "3"])
    print(f"phase 15: (c) cli.port --check: exit {go} on the intact file ({go_s:.2f} s), {nogo} with a key dropped")
    check((go, nogo) == (0, 1), f"cli.port verdicts {go}, {nogo}")
    out["port"] = {"go": go, "nogo": nogo}

    # DensePose masks of a batch: the C++ codec against numpy
    rng = np.random.RandomState(7)
    yy, xx = np.mgrid[:256, :256]
    anns = []
    for a in range(DP_MASK_BATCH):
        parts = []
        for p in range(14):
            cy, cx, r = rng.randint(40, 216), rng.randint(40, 216), rng.randint(8, 60)
            enc = rle.encode_rle(((yy - cy) ** 2 + (xx - cx) ** 2 < r * r).astype(np.uint8))
            parts.append(enc if (a + p) % 3 else {"size": enc["size"],
                                                   "counts": rle.compress_counts(enc["counts"]).decode()})
        anns.append(parts)
    rle.decode_dp_masks(anns[0])       # builds the codec
    times = {"native": [], "numpy": []}
    labels = {}
    for name, fn in (("native", rle.decode_dp_masks), ("numpy", rle.decode_dp_masks_plain)) * 2:
        t0 = time.perf_counter()
        labels[name] = [fn(m) for m in anns]
        times[name].append((time.perf_counter() - t0) * 1e3)
    same = all(np.array_equal(a, b) for a, b in zip(labels["native"], labels["numpy"]))
    print(f"phase 15: (c) decode_dp_masks of a B={DP_MASK_BATCH} batch (14 parts each; host ms, in turns): native "
          f"{times['native']}, numpy {times['numpy']}; bit-equal {same}")
    check(same, "native dp_masks decode equals numpy")
    out["rle_ms"] = times

    # a traced request, in a process of its own: late in this script's
    # process (after phase 14's NCCL group and spawned ranks) the profiler
    # recorded no device events (PERF.md §7)
    log_dir = os.path.join(root, "trace")
    code = ("import numpy as np, torch\n"
            "from danet_densepose2smpl_tpu_torch.serve import Predictor\n"
            "from danet_densepose2smpl_tpu_torch.utils.profiling import annotate, trace\n"
            f"dev = torch.device({str(dev)!r})\n"
            "predictor = Predictor(dev, torch.bfloat16, seed=0)\n"
            f"images = torch.from_numpy(np.random.RandomState(23).rand({PAD_BATCH}, 224, 224, 3)"
            ".astype(np.float32)).to(dev, torch.bfloat16)\n"
            "predictor.predict(images)\n"
            f"with trace({log_dir!r}):\n"
            "    with annotate('chip_smoke.request'):\n"
            "        predictor.predict(images)\n")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"the traced request: {proc.stderr[-3000:]}")
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    ranges = [e for e in events if e.get("name") == "chip_smoke.request"]
    kernel_ms = sum(e.get("dur", 0) for e in kernels) / 1e3
    print(f"phase 15: (c) utils.profiling.trace of one B={PAD_BATCH} request (a process of its own, "
          f"{time.perf_counter() - t0:.1f} s): {len(events)} events, {len(kernels)} device kernels ({kernel_ms!r} ms), "
          f"the annotated range {len(ranges)} time(s); {os.path.getsize(os.path.join(log_dir, 'trace.json'))} bytes")
    check(kernels and ranges, "the trace holds device kernels and the annotated range")
    out["trace_kernels"] = len(kernels)
    return out


K1_F32_WIDTHS = (48, 64, 256)   # HRNet-W48, the padded HRNet, the ResNet-50 backbone
K1_F32_BATCH = 64


def phase16_k1_fp32(dev, card) -> dict:
    """K1's fp32 kernel (`part_crop_head_f32_kernel<CH>`, 3xTF32): (a) against
    its plain version, (b) its time at B=64, C=48, 64, 256 beside the scalar
    kernel it replaced, the plain version and the unfused route, (c) fp32
    `Predictor` requests of W48, the padded HRNet and the ResNet-50 config.
    Returns {C: the numbers of the `kernels` line's `fp32` object}."""
    # (a) every width and odd shape, bilinear and dense weights, TF32 off
    cases = [("float32", 1, 56, c, 21) for c in (8, 20, 48, 64, 72, 200, 201, 256, 264)]
    cases += [("float32", 1, 57, c, 5) for c in (8, 20, 201)]
    cases += [("float32", K1_F32_BATCH, 56, 48, 21), ("float32", 16, 56, 256, 21)]
    errors = {}
    k1_check_cases("16: (a)", dev, cases, seed=5, errors=errors)
    worst = max(errors, key=errors.get)
    print(f"phase 16: (a) K1 fp32 vs plain, {len(errors)} cases: max abs err {errors[worst]!r} at {worst} "
          f"(bar 1e-4); card {card}")
    out = {c: k1_f32_timing(dev, card, c) for c in K1_F32_WIDTHS}
    for c, launches in phase16_requests(dev, card, out).items():
        out[c]["launches"] = launches
    return out


def k1_f32_timing(dev, card, c: int) -> dict:
    """(b): K1 at B=64 fp32 on 56x56xC, TF32 off: the wrapper, the plain
    version (3 calls), the unfused route (`separable_crop_concat`, then
    cuDNN's grouped conv) and its conv alone in turns; then the launch alone
    at `f32_plan`, at each channel chunk and of the scalar kernel (the C
    entry `part_crop_head` with dtype 0, the kernel fp32 ran before) in
    turns: medians of two turns by CUDA events, and the kernel's device ms
    by torch.profiler."""
    from danet_densepose2smpl_tpu_torch.kernels.part_crop_head import (
        F32_CHUNKS,
        f32_plan,
        f32_rows,
        fused_part_predict,
        part_crop_head_plain,
    )
    from danet_densepose2smpl_tpu_torch.nn.iuv_head import PartialIUVHead
    from danet_densepose2smpl_tpu_torch.ops.imwarp import separable_crop_concat

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    args, centers, scales = k1_inputs(K1_F32_BATCH, 56, 56, c, 56, torch.float32, dev, seed=2, boxes=True)
    feats, _, _, kernel, bias = args
    head = PartialIUVHead(c).to(dev, torch.float32, memory_format=torch.channels_last)
    head.weight.data.copy_(kernel.permute(3, 2, 0, 1))
    head.bias.data.copy_(bias)
    crops = separable_crop_concat(feats, centers, scales, 56).permute(0, 3, 1, 2)
    calls = {
        "kernel": lambda: fused_part_predict(*args, 56),
        "plain": lambda: part_crop_head_plain(*args, 56),
        "unfused": lambda: head(separable_crop_concat(feats, centers, scales, 56).permute(0, 3, 1, 2)),
        "unfused conv": lambda: head(crops),
    }
    plan = f32_plan(56, 56, c, 56, 21)
    launches = {"plan": k1_launch(args, 56, plan), "scalar": k1_launch(args, 56, scalar=True)}
    for chunk in F32_CHUNKS:
        launches[f"chunk {chunk}"] = k1_launch(args, 56, (f32_rows(56, 56, 21, chunk), chunk))
    times = {name: [] for name in [*calls, *launches]}
    with torch.no_grad():
        for name in ("plain", "kernel", "unfused", "unfused conv", "unfused conv", "unfused", "kernel", "plain"):
            times[name].append(cuda_ms(calls[name], 3 if name == "plain" else 20))
        for order in (list(launches), list(launches)[::-1]):
            for name in order:
                times[name].append(cuda_ms(launches[name], 5 if name == "scalar" else 10))
        by_kernel = device_ms_by_kernel(calls["kernel"], 10)
        alone = [v for key, v in by_kernel.items() if "part_crop_head_f32_kernel" in key]
        check(len(alone) == 1, f"the profiler sees the fp32 kernel: {by_kernel}")
        ref = calls["plain"]().double()
        err = (calls["kernel"]().double() - ref).abs().max().item()
        err_u = (calls["unfused"]().reshape(ref.shape).double() - ref).abs().max().item()
    errs = {name: (launches[name].out.double() - ref).abs().max().item() for name in launches}
    check(err <= 1e-4 and all(e <= 1e-4 for e in errs.values()),
          f"K1 fp32 C={c} B={K1_F32_BATCH} vs plain: the wrapper {err}, the launches {errs} (bar 1e-4)")
    bound_ms, bound_by = k1_bound(args, 56, "tf32x3")
    ffma_ms, ffma_by = k1_bound(args, 56, "fp32")
    ms = {name: float(np.median(t)) for name, t in times.items()}
    print(f"phase 16: (b) K1 B={K1_F32_BATCH} fp32 56x56x{c} (CUDA events, medians of two turns of 20 calls, plain "
          f"3; TF32 off): kernel {times['kernel']} ms, plain {times['plain']} ms, unfused route {times['unfused']} "
          f"ms, its conv alone {times['unfused conv']} ms; the launch alone (weights packed once) at the plan "
          f"{plan} (tile rows, chunk) {times['plan']} ms, "
          + ", ".join(f"{name} {times[name]} ms" for name in launches if name not in ("plan", "scalar"))
          + f"; the scalar kernel it replaced (5 calls) {times['scalar']} ms, {ms['scalar'] / ms['plan']!r}x the "
          f"launch; device ms (torch.profiler, 10 calls) {alone[0]!r}; max abs err vs plain {err!r} (the "
          f"scalar kernel {errs['scalar']!r}, the unfused route {err_u!r}); bound {bound_ms!r} ms ({bound_by}, "
          f"3xTF32 at 495 TFLOP/s), FFMA bound {ffma_ms!r} ms ({ffma_by}, 67 TFLOP/s); card {card}")
    check(ms["plan"] < ms["scalar"], f"K1 fp32 C={c}: the kernel ({ms['plan']} ms) is faster than the scalar "
                                     f"kernel it replaced ({ms['scalar']} ms)")
    del args, feats, kernel, bias, head, crops, calls, launches, ref
    torch.cuda.empty_cache()
    return {"ms": ms["kernel"], "scalar_ms": ms["scalar"], "plain_ms": ms["plain"], "unfused_ms": ms["unfused"],
            "unfused_conv_ms": ms["unfused conv"], "launch_ms": ms["plan"], "device_ms": alone[0],
            "bound_ms": bound_ms, "bound_by": bound_by, "ffma_bound_ms": ffma_ms, "plan": plan,
            "chunk_ms": {name: ms[name] for name in ms if name.startswith("chunk")}, "max_abs_err": err}


def phase16_requests(dev, card, timing: dict) -> dict:
    """(c): 8 fp32 `Predictor` requests of B=64 on HRNet-W48, the padded
    HRNet and configs/danet_resnet.yaml (K1 at C=48, 64, 256), the counts
    zeroed just before and read just after: host ms and imgs/s; then one
    request of each under torch.profiler: kernel ms, the fp32 kernel's
    device ms inside it and the idle share, beside the scalar kernel's time
    from (b). Returns {C: K1 launches in the 8 requests}."""
    from danet_densepose2smpl_tpu_torch.config import DaNetConfig, load_config
    from danet_densepose2smpl_tpu_torch.serve import Predictor

    configs = {48: ("HRNet-W48", DaNetConfig()), 64: ("the padded HRNet", DaNetConfig(hrnet_pad_channels=True)),
               256: (RESNET_CFG, load_config(os.path.join(REPO, RESNET_CFG)).danet)}
    images = torch.from_numpy(np.random.RandomState(31).rand(K1_F32_BATCH, 224, 224, 3).astype(np.float32)).to(dev)
    launches = {}
    for c, (label, cfg) in configs.items():
        predictor = Predictor(dev, torch.float32, cfg=cfg, seed=0)
        predictor.predict(images)   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs, counts = launch_counts(lambda: [predictor.predict(images) for _ in range(SERVE_REQUESTS)])
        dt = time.perf_counter() - t0
        check(all(o["para"].shape == (K1_F32_BATCH, 229) and o["vertices"].shape == (K1_F32_BATCH, 6890, 3)
                  and all(bool(torch.isfinite(v).all()) for v in o.values()) for o in outs),
              f"fp32 requests of {label}: shapes, finite")
        check(counts["part_crop_head"] == SERVE_REQUESTS, f"fp32 requests of {label}: K1 once each ({counts})")
        launches[c] = counts["part_crop_head"]
        print(f"phase 16: (c) {SERVE_REQUESTS} fp32 requests of B={K1_F32_BATCH} ({label}, K1 at C={c}): "
              f"{dt / SERVE_REQUESTS * 1e3!r} ms a request, {K1_F32_BATCH * SERVE_REQUESTS / dt!r} imgs/s (host clock, "
              f"ends in synchronize); launches {counts}; card {card}")
        events = profile_ranges(lambda: predictor.predict(images), "serve.", f"one fp32 request of B={K1_F32_BATCH} "
                                f"({label})", card)
        k1_ms = sum(e.self_device_time_total for e in events if "part_crop_head_f32_kernel" in e.key) / 1e3
        check(k1_ms > 0, f"the profiled fp32 request of {label} ran part_crop_head_f32_kernel")
        print(f"profile: K1 (part_crop_head_f32_kernel) inside it: {k1_ms!r} ms on the card; the scalar kernel it "
              f"replaced took {timing[c]['scalar_ms']!r} ms at this shape in (b); card {card}")
        timing[c]["request"] = {"imgs_per_s": K1_F32_BATCH * SERVE_REQUESTS / dt, "k1_device_ms": k1_ms}
        del predictor, outs
        torch.cuda.empty_cache()
    return launches


def main():
    k1_report = phase0_environment()
    dev = torch.device("cuda", 0)
    card = card_line()
    timings = {}

    def timed(n, fn):
        t0 = time.perf_counter()
        out = fn()
        timings[n] = time.perf_counter() - t0
        return out

    timed(1, lambda: phase1_kernel_vs_plain(dev))
    timed(2, lambda: phase2_slice_f64(dev))
    k1_launches = timed(3, lambda: phase3_serving(dev, card))
    k1 = timed(4, lambda: phase4_timing(dev, card))
    raster = timed(5, lambda: phase5_raster(dev, card))
    timed(6, lambda: phase6_step_f64(dev))
    paths = timed(7, lambda: phase7_train_bf16(dev, card))
    k3 = timed(8, lambda: phase8_eval(dev, card))
    cli = timed(9, lambda: phase9_train_cli(dev, card))
    evals = timed(10, lambda: phase10_eval_cli(dev, card, cli))
    demo = timed(11, lambda: phase11_demo_vis(dev, card))
    archs = timed(12, lambda: phase12_archs(dev, card))
    modes = timed(13, lambda: phase13_input_modes(dev, card))
    # phase 16 runs before 14 and 15: after phase 14's NCCL group and spawned
    # ranks torch.profiler has recorded no device event, and 16 profiles
    k1_f32 = timed(16, lambda: phase16_k1_fp32(dev, card))
    last = timed(14, lambda: phase14_chunks_dp(dev, card))
    final = timed(15, lambda: phase15_remat_pad(dev, card))
    kernels = [{"name": "part_crop_head", "route": "cuda", "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
                "launches": k1_launches, "path": f"serving: Predictor.predict, bf16, B={SERVE_BATCH}, "
                f"{SERVE_REQUESTS} requests", "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
                "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
                "library_ms": None, "unfused_ms": k1["unfused_ms"], "unfused_conv_ms": k1["unfused_conv_ms"],
                "device_ms": k1["device_ms"], "mma_instructions": {n: r["mma"] for n, r in k1_report.items()},
                "plan": k1["plan"],
                "cli_eval_launches": {k: evals[k]["k1"] for k in ("pose", "pose_dp", "lsp", "coco")}}]
    raster_paths = {  # entry -> (the phase-7 path its launches are read from, its label)
        "rasterize_flat": ("pallas", "training step, IUVRenderer backend 'pallas', bf16, B=64, 1 step"),
        "rasterize_flat_masked": ("main", f"training step (the main path: closed atlas, culled), bf16, "
                                          f"B={TRAIN_BATCH}, {TRAIN_STEPS} steps"),
    }
    for name, (ms, plain_ms, err, bound_ms, bound_by) in raster.items():
        path, label = raster_paths[name]
        kernels.append({"name": name, "route": "cuda", "source": RASTER_SOURCE, "replaces": RASTER_REPLACES[name],
                        "launches": paths[path][name], "path": label, "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    for k in kernels:
        if k["name"] == "rasterize_flat":
            k["cli_launches"] = cli["launches"]   # in phase 9's training CLI, 4 steps
            k["cli_device_preprocess_launches"] = evals["train"]["raster"]   # phase 10 (e), 4 steps
    kernels.append({"name": "rasterize_flat_banded", "route": "cuda", "source": RASTER_SOURCE,
                    "replaces": RASTER_REPLACES["rasterize_flat_banded"], "launches": k3["launches"],
                    "path": f"eval: run_lsp_eval with PartRenderer('pallas_banded'), Predictor bf16, "
                            f"{EVAL_BATCHES} batches of B={EVAL_BATCH}",
                    "max_abs_err": k3["max_abs_err"], "ms": k3["ms"], "plain_ms": k3["plain_ms"],
                    "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"], "library_ms": None})
    for k in kernels:
        if k["name"] == evals["lsp"]["raster_entry"]:
            k["cli_eval_lsp_launches"] = evals["lsp"]["raster"]    # phase 10 (b), 4 batches
        if k["name"] in ("part_crop_head", "rasterize_flat"):    # phase 11 (b), (c)
            k["demo_launches"] = {m: demo["demo"][m]["launches"][k["name"]] for m in ("fp32", "bf16")}
            k["vis_launches"] = {b: demo["vis"][b]["launches"][k["name"]] for b in ("host_crop", "raw")}
        if k["name"] == "rasterize_flat":                        # phase 11 (a): render_shaded, 224 px, C=1
            k["shaded"] = {f"yaw{int(yaw)}_B{b}": v for (yaw, b), v in demo["shaded"].items()}
        if k["name"] == "part_crop_head":                         # phase 12 (a), (b), (d)
            k["resnet"] = {"launches": archs["serve"]["launches"], "path": f"serving {RESNET_CFG}: Predictor.predict, "
                           f"bf16, B={SERVE_BATCH}, {SERVE_REQUESTS} requests", "C": 256, **archs["k1"],
                           "library_ms": None}
            k["arch_launches"] = {name: v["k1"] for name, v in archs["archs"].items()}
        if k["name"] == "rasterize_flat":                         # phase 12 (c), (e)
            k["resnet_cli_launches"] = archs["cli_train"]["rasterize_flat"]
            k["hmr_lsp_launches"] = archs["hmr"]["lsp"]["launches"]["rasterize_flat"]
        if k["name"] == "rasterize_flat_masked":                  # phase 12 (c)
            k["resnet_launches"] = archs["train_step"]["rasterize_flat_masked"]
        if k["name"] == "part_crop_head":                         # phase 13 (b): one request each
            k["input_mode_launches"] = {m: v["k1"] for m, v in modes["serve"].items()}
        if k["name"] == "rasterize_flat_masked":                  # phase 13 (c): 2 steps each
            k["input_mode_launches"] = {m: v["launches"] for m, v in modes["train"].items()}
        if k["name"] == "rasterize_flat":                         # phase 13 (e): 4 steps
            k["input_mode_cli_launches"] = {"iuv_gt_feat": modes["cli_train"]["rasterize_flat"]}
        if k["name"] == "rasterize_flat":                         # phase 14 (a), (b): the CLIs' 4 steps
            k["b128_cli_launches"] = last["b128_cli"]["launches"]["rasterize_flat"]
            k["dp_cli_launches"] = last["dp_cli"]["launches"]["rasterize_flat"]
        if k["name"] == "rasterize_flat_masked":                  # phase 14: the chunked and data-parallel steps
            k["b128_chunks_launches"] = {f"chunks{c}": v["launches"]["rasterize_flat_masked"]
                                         for c, v in last["b128_step"].items()}
            k["dp_launches"] = {
                "one_nccl_rank_f64": last["world1_f64"]["launches"]["rasterize_flat_masked"],
                "two_gloo_ranks_f64": [n["rasterize_flat_masked"] for n in last["two_ranks"]["launches"]]}
    for k in kernels:
        if k["name"] == "part_crop_head":                         # phase 15 (b): K1 at C=64
            k["pad"] = {"launches": final["pad"]["serve"]["launches"]["padded"], "path": f"serving the padded "
                        f"HRNet: Predictor.predict, bf16, B={PAD_BATCH}, {PAD_REQUESTS} requests", "C": 64,
                        **final["k1"], "library_ms": None}
        if k["name"] == "part_crop_head":                         # phase 16: the fp32 kernel at each C
            k["fp32"] = {str(c): {"launches": v["launches"], "path": f"fp32 serving: Predictor.predict, "
                                  f"B={K1_F32_BATCH}, {SERVE_REQUESTS} requests",
                                  **{key: v[key] for key in ("ms", "scalar_ms", "plain_ms", "unfused_ms",
                                                             "unfused_conv_ms", "device_ms", "bound_ms", "bound_by",
                                                             "ffma_bound_ms", "plan", "max_abs_err")},
                                  "library_ms": None} for c, v in k1_f32.items()}
        if k["name"] == "rasterize_flat_masked":                  # phase 15 (a): 3 steps per scope
            k["remat_launches"] = {scope: v["launches"]["rasterize_flat_masked"]
                                   for scope, v in final["remat"]["b128"].items()}
    print("phase seconds: " + ", ".join(f"{n}: {t:.1f}" for n, t in sorted(timings.items())))
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
