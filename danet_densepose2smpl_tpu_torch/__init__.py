"""danet_densepose2smpl_tpu_torch — the PyTorch/CUDA port of DaNet serving,
training and eval.

The JAX package `danet_densepose2smpl_tpu` is the reference; every module
here keeps the name of its JAX counterpart so each pair is easy to find.
This package imports `torch` and never `jax`, `flax` or anything of the JAX
package: `config.py` and `constants.py` are its own copies.

Layer map:
  config.py, constants.py  the configuration dataclasses and constants
  ops/       numpy tables and tensor numerics (structure, rotations,
             Procrustes, ...)
  kernels/   hand-written CUDA kernels for Hopper, each with its plain
             PyTorch version; `csrc/` holds their sources
  nn/        nn.Module building blocks (HRNet-W48, ResNets, GCN, heads)
  models/    IUV estimator, SMPL regressor and the DaNet composition
  smpl/      SMPL arrays, the LBS forward and the DensePose atlas
  data/      synthetic raw training batches (numpy), the eval crop transforms
  train/     GT preparation, the loss assembly and the training step
  eval/      pose MPJPE / PA-MPJPE and the LSP segmentation eval
  port.py    flax variables -> this package's state_dict
  serve.py   `Predictor`: one request = one batch of images -> SMPL

Tensors are NCHW with `torch.channels_last` inside; the public outputs are
NHWC dicts, matching the JAX package.
"""

__version__ = "0.1.0"
