"""Shared CLI plumbing: the device, asset resolution, model building and
checkpoint loading, arg groups (port of the JAX package's `cli/common.py`).

Every asset (SMPL model, DensePose UV atlas, H36M joint regressor, SPIN
mean params) resolves from flags or the environment, with a synthetic
fallback (`--synthetic-assets`) so every entry point runs without the
licensed files. The CLIs run on `cuda:0` unless `--cpu` is given; without
a card and without `--cpu` they raise.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def add_common_args(p: argparse.ArgumentParser):
    p.add_argument("--cfg", default=None, help="YAML config (reference layout)")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint directory of this port's trainer (or empty for random init)")
    p.add_argument("--torch_checkpoint", default=None,
                   help="released reference .pt checkpoint (danet), loaded strictly")
    p.add_argument("--regressor", default="danet", choices=["danet", "hmr"])
    p.add_argument("--smpl_model", default=os.environ.get("SMPL_MODEL_PATH"),
                   help=".pkl/.npz SMPL model (dir ok); synthetic if absent")
    p.add_argument("--uv_atlas", default=os.environ.get("DENSEPOSE_UV_PATH"),
                   help="UV_Processed.mat; synthetic if absent")
    p.add_argument("--j_regressor_h36m", default=os.environ.get("J_REGRESSOR_H36M"),
                   help="J_regressor_h36m.npy; synthetic if absent")
    p.add_argument("--j_regressor_extra", default=os.environ.get("J_REGRESSOR_EXTRA"))
    p.add_argument("--smpl_mean_params", default=os.environ.get("SMPL_MEAN_PARAMS"))
    p.add_argument("--synthetic-assets", action="store_true",
                   help="force synthetic SMPL/atlas/regressor assets")
    p.add_argument("--num_verts", type=int, default=6890,
                   help="vertex count for synthetic SMPL (tests use fewer)")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16: mixed precision in training, bf16 weights and activations in serving")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (tests, fixture runs); the default is the CUDA card")
    return p


def resolve_device(args) -> torch.device:
    """cuda:0, or the CPU with --cpu; raises when there is no card and no
    --cpu, so that a run never carries on on the CPU unasked."""
    if getattr(args, "cpu", False):
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available (torch.cuda.is_available() is false); "
                           "pass --cpu to run on the CPU")
    return torch.device("cuda", 0)


def load_assets(args):
    """Returns (smpl_model, atlas, j_regressor_h36m, mean_params,
    smpl_male, smpl_female); the gendered models fall back to the neutral
    one."""
    from danet_densepose2smpl_tpu_torch.eval.harness import synthetic_h36m_regressor
    from danet_densepose2smpl_tpu_torch.models.smpl_regressor import load_mean_params
    from danet_densepose2smpl_tpu_torch.smpl.densepose_atlas import (
        load_densepose_atlas,
        synthetic_densepose_atlas,
    )
    from danet_densepose2smpl_tpu_torch.smpl.loader import load_smpl_model, synthetic_smpl_model

    gendered = {}
    if args.smpl_model and not args.synthetic_assets:
        smpl = load_smpl_model(args.smpl_model, j_regressor_extra_path=args.j_regressor_extra)
        if os.path.isdir(args.smpl_model):
            # gendered models for the 3DPW eval (reference eval.py:68-75)
            for gender in ("male", "female"):
                p = os.path.join(args.smpl_model, f"SMPL_{gender.upper()}.pkl")
                if os.path.isfile(p):
                    gendered[gender] = load_smpl_model(p, j_regressor_extra_path=args.j_regressor_extra)
    else:
        smpl = synthetic_smpl_model(num_verts=args.num_verts, seed=args.seed)

    if args.uv_atlas and not args.synthetic_assets:
        atlas = load_densepose_atlas(args.uv_atlas)
    else:
        atlas = synthetic_densepose_atlas(smpl, seed=args.seed)

    if args.j_regressor_h36m and not args.synthetic_assets:
        jreg = np.load(args.j_regressor_h36m).astype(np.float32)
    else:
        jreg = synthetic_h36m_regressor(smpl.num_verts, seed=args.seed)

    mean = load_mean_params(None if args.synthetic_assets else args.smpl_mean_params)
    return smpl, atlas, jreg, mean, gendered.get("male", smpl), gendered.get("female", smpl)


def read_reference_checkpoint(pt_path: str) -> dict:
    """The state_dict of a released reference .pt ({'model': state_dict}
    unwrapped, DataParallel 'module.' prefixes stripped), read on the CPU
    with `weights_only=True`."""
    ckpt = torch.load(pt_path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt)
    return {(k[7:] if k.startswith("module.") else k): v for k, v in sd.items()}


def load_reference_checkpoint(model: torch.nn.Module, pt_path: str) -> list[str]:
    """Load a released reference .pt (`read_reference_checkpoint`) into
    `model`, whose names are the reference's. Raises when a key of the
    model is missing from the file; returns the file's keys the model does
    not have."""
    missing, unexpected = model.load_state_dict(read_reference_checkpoint(pt_path), strict=False)
    if missing:
        raise KeyError(f"{pt_path} lacks {len(missing)} keys of the model, e.g. {missing[:5]}")
    return list(unexpected)


def refuse_hmr(args, entry: str) -> None:
    """Raise for --regressor hmr in an entry point that runs DaNet only."""
    if args.regressor == "hmr":
        raise ValueError(
            f"{entry} runs DaNet only: --regressor hmr is for cli.eval (the JAX package's {entry} "
            "calls the HMR baseline without its mean parameters and fails; ROADMAP.md, caveats "
            "in the reference)")


def build_model_and_params(args, cfg, device, train: bool = False) -> torch.nn.Module:
    """The model of --regressor on `device`: DaNet for `cfg`, or the HMR
    baseline (`nn/hmr.py`); random init from --seed, then the weights of
    --torch_checkpoint (a released reference file; HMR's `init_*` mean
    parameter buffers are among its unused keys) and of --checkpoint (this
    port's trainer's checkpoints) where given. In eval mode unless
    `train`."""
    from danet_densepose2smpl_tpu_torch.core.checkpoint import CheckpointManager
    from danet_densepose2smpl_tpu_torch.models.danet import DaNet
    from danet_densepose2smpl_tpu_torch.nn.hmr import HMR
    from danet_densepose2smpl_tpu_torch.serve import random_init_
    from danet_densepose2smpl_tpu_torch.train.step import create_train_state

    model = HMR() if args.regressor == "hmr" else DaNet(cfg.danet)
    model = random_init_(model, seed=args.seed).to(device, memory_format=torch.channels_last)

    if getattr(args, "torch_checkpoint", None):
        extra = load_reference_checkpoint(model, args.torch_checkpoint)
        print(f"loaded {args.torch_checkpoint} ({len(extra)} keys of the file unused"
              + (f", e.g. {extra[:3]}" if extra else "") + ")")

    if args.checkpoint:
        restored = CheckpointManager(args.checkpoint).restore(create_train_state(model, cfg))
        if restored is not None:
            print(f"restored checkpoint from {args.checkpoint}")
    return model.train(train)


def dump_run_config(args, cfg, out_dir: str):
    """Persist the resolved run configuration (reference train_options.py
    dumps config.json per run)."""
    os.makedirs(out_dir, exist_ok=True)
    payload = {"args": {k: str(v) for k, v in vars(args).items()}}
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(payload, f, indent=2)
