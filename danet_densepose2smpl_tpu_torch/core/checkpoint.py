"""Checkpoint save/restore with mid-epoch resume, in torch files (port of
the JAX package's `core/checkpoint.py`, which uses orbax; reference
`utils/saver.py`).

A checkpoint holds the model's `state_dict` (BatchNorm statistics
included), the optimizer's, the step, and the resume point (epoch,
batch_idx, step) as plain ints, so it loads with `weights_only=True`.
Because the loader's permutation and per-sample RNG are pure functions of
(seed, epoch, slot), those two integers are all a resumed epoch needs.
Files are written beside their final name and renamed into place, so a
crash never leaves a half-written latest checkpoint.
"""

from __future__ import annotations

import json
import os
import re
from typing import NamedTuple

import torch

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class ResumePoint(NamedTuple):
    epoch: int
    batch_idx: int
    step: int


class CheckpointManager:
    """`directory/ckpt_<step>.pt`, the newest `max_to_keep` kept."""

    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:09d}.pt")

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, state, resume: ResumePoint) -> None:
        """Write `state` (a `train.step.TrainState`) with its resume point."""
        payload = {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": int(state.step),
            "resume": {"epoch": int(resume.epoch), "batch_idx": int(resume.batch_idx), "step": int(resume.step)},
        }
        path = self._path(resume.step)
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in self.steps()[: -self.max_to_keep]:
            os.remove(self._path(old))

    def restore(self, state, step: int | None = None):
        """Load checkpoint `step` (default the latest) into `state`'s model
        and optimizer, wherever they live; returns (state, ResumePoint), or
        None when the directory holds no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        # onto the CPU first: load_state_dict copies into the parameters on
        # their device, and moves the optimizer's moments to their
        # parameters' device while Adam's step counts stay on the CPU
        payload = torch.load(self._path(step), map_location="cpu", weights_only=True)
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        r = payload["resume"]
        return state, ResumePoint(int(r["epoch"]), int(r["batch_idx"]), int(r["step"]))


class MetricLogger:
    """JSONL scalar logging (the TensorBoard-scalar equivalent; host-side)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def log(self, step: int, metrics: dict) -> None:
        row = {"step": int(step)}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                pass
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()
