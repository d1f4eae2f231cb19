"""danet_densepose2smpl_tpu_torch — the PyTorch/CUDA port of DaNet serving,
training and eval.

The JAX package `danet_densepose2smpl_tpu` is the reference; every module
here keeps the name of its JAX counterpart so each pair is easy to find.
This package imports `torch` and never `jax`, `flax` or anything of the JAX
package: `config.py` and `constants.py` are its own copies.

Layer map:
  config.py, constants.py  the configuration dataclasses, the YAML loader
                           and constants
  ops/       numpy tables and tensor numerics (structure, rotations,
             Procrustes, ...)
  kernels/   hand-written CUDA kernels for Hopper, each with its plain
             PyTorch version; `csrc/` holds their sources
  nn/        nn.Module building blocks (HRNet-W48, ResNets, GCN, heads)
  models/    IUV estimator, SMPL regressor and the DaNet composition
  smpl/      SMPL arrays and model files, the LBS forward, the DensePose
             atlas and its flip symmetry
  data/      SPIN-format npz datasets and augmentation, the resumable and
             prefetching loaders, image files and transforms without cv2,
             the offline DensePose-COCO preprocessing, synthetic fixtures
  train/     GT preparation, the loss assembly, the training step, the
             fits store and the Trainer
  core/      torch checkpoints with mid-epoch resume, metric logging
  eval/      pose MPJPE / PA-MPJPE, the LSP segmentation eval, COCO OKS AP
  utils/     the demo's and the training summaries' panels and PNGs
             (numpy; no cv2, no matplotlib)
  cli/       `python -m danet_densepose2smpl_tpu_torch.cli.<name>`: train,
             eval, eval_coco, demo, preprocess
  port.py    flax variables -> this package's state_dict
  serve.py   `Predictor`: one request = one batch of images -> SMPL

Tensors are NCHW with `torch.channels_last` inside; the public outputs are
NHWC dicts, matching the JAX package.
"""

__version__ = "0.1.0"
