"""Faults planted in the timed path, which the comparison has to catch
(`calibrate.py` reads them on the card, the CPU tests see `correct` come
out false): each a `wrap(fn) -> fn` for `serve.run(wrap=)` or
`train.run(wrap=)`.

- serve 'answer': one image's answer altered where it is produced (its
  outputs replaced by another image's);
- serve 'half': half of the batch left out (the first half computed, its
  answers repeated for the rest);
- train 'half': half of the batch left out, the loss's means taken over
  the rest;
- train 'unchanged': a step that returns its state unchanged.
"""

from __future__ import annotations

import torch

SERVED_KEYS = ("para", "pred_cam", "pred_shape", "pred_rotmat", "vertices", "joints")


def _halve(tree, b: int):
    if isinstance(tree, dict):
        return {k: _halve(v, b) for k, v in tree.items()}
    if torch.is_tensor(tree) and tree.dim() > 0 and tree.shape[0] == b:
        return tree[: b // 2]
    return tree


def serve_answer(predict):
    def wrapped(images):
        out = dict(predict(images))
        for k in SERVED_KEYS:
            if k in out:
                v = out[k].clone()
                v[0] = v[1]
                out[k] = v
        return out
    return wrapped


def serve_half(predict):
    def wrapped(images):
        b = images.shape[0]
        out = predict(images[: b // 2])
        return {k: torch.cat([v, v])[:b] if torch.is_tensor(v) else v for k, v in out.items()}
    return wrapped


def train_half(step):
    def wrapped(state, batch, generator=None):
        return step(state, _halve(batch, batch["raw_img"].shape[0]), generator)
    return wrapped


def train_unchanged(step):
    def wrapped(state, batch, generator=None):
        params = list(state.model.parameters())
        before = [p.detach().clone() for p in params]
        out = step(state, batch, generator)
        with torch.no_grad():
            for p, b in zip(params, before):
                p.copy_(b)
        return out
    return wrapped


FAULTS = {"serve": {"answer": serve_answer, "half": serve_half},
          "train": {"half": train_half, "unchanged": train_unchanged}}
