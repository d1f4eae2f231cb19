"""A toy multi-person, whole-body family, for the tests of the family
interface's optional attributes (`port_bench/families/__init__.py`): a
pre-LN transformer over the patches of a non-square image gives each
token a score; the top K tokens of each image, picked on the device with
`torch.topk`, are its people; each person's query (its token plus a
learned embedding) cross-attends to all tokens and gives a 3D position,
10 shape and 10 expression coefficients and 30 joint rotations (6D), so
`para` holds K rows an image, image-major, of 3 | 10 | 10 | 270 = 293
columns in four blocks. A seeded toy body model (a 30-joint tree, shape
and expression bases, LBS, the position added) gives each person's
vertices and joints. The port's side (`Server`) is the module in the
served dtype with the body model in fp32; the reference is the module in
fp32, conditioned on the port's picks, and reads how far a picked
token's score falls below its own K-th best (`pick_shortfall`)."""

from __future__ import annotations

import math
import re
from typing import NamedTuple

import numpy as np
import torch
import torch.nn as nn

from port_bench.harness.weights import derive_seed, fill_weights_, round_to_
from port_bench.reference.ops.rotations import rot6d_to_rotmat
from port_bench.tests.families.toy import IDENTITY_6D, Block, leaves  # noqa: F401 (the toy's draws)

kinds = ("serve_closed",)
output_layers = re.compile(r"head$")
left_to_construction = ()
JOINTS, SHAPE, EXPRESSION = 30, 10, 10
PARA = 3 + SHAPE + EXPRESSION + 9 * JOINTS   # 293
compared = ("para", "vertices", "joints", "scores")
reference_conditioned = True


def answers_per_image(cfg: dict) -> int:
    return cfg["people"]


def para_blocks(cfg: dict) -> tuple:
    """Position, shape, expression, rotations."""
    return (0, 3), (3, 3 + SHAPE), (3 + SHAPE, 3 + SHAPE + EXPRESSION), (3 + SHAPE + EXPRESSION, PARA)


class Body(NamedTuple):
    """v_template (V, 3), shapedirs and exprdirs (V, 3, 10), J_regressor
    (30, V), lbs_weights (V, 30); parents (30,) a tuple, each joint's
    parent before it (the root's -1), so the kinematic chain reads no
    device tensor on the host."""

    v_template: np.ndarray
    shapedirs: np.ndarray
    exprdirs: np.ndarray
    J_regressor: np.ndarray
    lbs_weights: np.ndarray
    parents: tuple


def body_arrays(cfg: dict) -> Body:
    """A seeded toy body model of `cfg['vertices']` vertices: joints placed
    by a random walk down a random tree, vertices scattered around the
    joint that owns them, blend weights a softmax over joint distance."""
    rng = np.random.RandomState(0)
    parents = (-1, *(int(rng.randint(0, j)) for j in range(1, JOINTS)))
    joints = np.zeros((JOINTS, 3))
    for j in range(1, JOINTS):
        joints[j] = joints[parents[j]] + rng.randn(3) * 0.1
    owner = np.concatenate([np.arange(JOINTS), rng.randint(0, JOINTS, cfg["vertices"] - JOINTS)])
    v_template = joints[owner] + rng.randn(cfg["vertices"], 3) * 0.03
    regressor = (owner[None] == np.arange(JOINTS)[:, None]) * rng.rand(JOINTS, cfg["vertices"])
    weights = np.exp(-np.linalg.norm(v_template[:, None] - joints[None], axis=-1) / 0.05)
    return Body(v_template.astype(np.float32),
                (rng.randn(cfg["vertices"], 3, SHAPE) * 0.02).astype(np.float32),
                (rng.randn(cfg["vertices"], 3, EXPRESSION) * 0.02).astype(np.float32),
                (regressor / regressor.sum(1, keepdims=True)).astype(np.float32),
                (weights / weights.sum(1, keepdims=True)).astype(np.float32), parents)


def body_to_device(body: Body, device) -> Body:
    return Body(*(torch.as_tensor(a, device=device) for a in body[:-1]), body.parents)


def body_forward(body: Body, position, shape, expression, rotmat) -> tuple:
    """(vertices (N, V, 3), joints (N, 30, 3)) of N people: the shape and
    expression bases, the rest joints, the kinematic chain down the tree,
    linear blend skinning, the position added."""
    v = (body.v_template + torch.einsum("vck,nk->nvc", body.shapedirs, shape)
         + torch.einsum("vck,nk->nvc", body.exprdirs, expression))
    rest = torch.einsum("jv,nvc->njc", body.J_regressor, v)
    rot, at = [rotmat[:, 0]], [rest[:, 0]]
    for j in range(1, JOINTS):
        p = body.parents[j]
        rot.append(rot[p] @ rotmat[:, j])
        at.append((rot[p] @ (rest[:, j] - rest[:, p])[..., None])[..., 0] + at[p])
    rot, at = torch.stack(rot, 1), torch.stack(at, 1)
    skin = torch.cat([rot, (at - (rot @ rest[..., None])[..., 0])[..., None]], dim=-1)
    t = torch.einsum("vj,njcd->nvcd", body.lbs_weights, skin)
    vertices = (t[..., :3] @ v[..., None])[..., 0] + t[..., 3]
    return vertices + position[:, None], at + position[:, None]


def top_k(scores: torch.Tensor, k: int) -> torch.Tensor:
    return torch.topk(scores, k, dim=1).indices


class ToyPeople(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        h, w = cfg["img_hw"]
        p, d = cfg["patch"], cfg["width"]
        self.people = cfg["people"]
        self.patch = nn.Conv2d(3, d, p, stride=p)
        self.pos = nn.Parameter(torch.zeros(1, (h // p) * (w // p), d))
        self.blocks = nn.ModuleList(Block(d, cfg["heads"], cfg["mlp"]) for _ in range(cfg["blocks"]))
        self.norm = nn.LayerNorm(d)
        self.score = nn.Linear(d, 1)
        self.query = nn.Parameter(torch.zeros(1, 1, d))
        self.cross = nn.MultiheadAttention(d, cfg["heads"], batch_first=True)
        self.head = nn.Linear(d, 3 + SHAPE + EXPRESSION + 6 * JOINTS)

    def forward(self, image, chosen=None, pick=top_k):
        """image (B, H, W, 3) -> scores (B, T); chosen (B, K), the tokens
        `pick` takes or, given, those; and per person, image-major: para
        (B·K, 293), position, shape, expression, rotmat (B·K, 30, 3, 3)."""
        x = self.patch(image.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2) + self.pos
        for block in self.blocks:
            x = block(x)
        x = self.norm(x)
        scores = self.score(x)[..., 0]
        if chosen is None:
            chosen = pick(scores, self.people)
        q = torch.gather(x, 1, chosen[..., None].expand(-1, -1, x.shape[-1])) + self.query
        q = q + self.cross(q, x, x, need_weights=True)[0]
        out = self.head(q).flatten(0, 1)
        position, shape = out[:, :3], out[:, 3:3 + SHAPE]
        expression = out[:, 3 + SHAPE:3 + SHAPE + EXPRESSION]
        rotmat = rot6d_to_rotmat(out[:, 3 + SHAPE + EXPRESSION:].reshape(-1, JOINTS, 6)
                                 + out.new_tensor(IDENTITY_6D))
        para = torch.cat([position, shape, expression, rotmat.flatten(1)], dim=1)
        return {"para": para, "position": position, "shape": shape, "expression": expression,
                "rotmat": rotmat, "scores": scores, "chosen": chosen}


def configs(config: dict, traffic: dict, overrides: dict | None = None) -> tuple:
    cfg = {**config["toy_people"], **(overrides or {})}
    return cfg, cfg


def image_hw(cfg: dict) -> tuple:
    return tuple(cfg["img_hw"])


def reference_model(cfg: dict, seed: int, device, served_dtype: torch.dtype = torch.float32):
    torch.manual_seed(derive_seed(seed, "module-init"))
    with torch.device(device):
        model = ToyPeople(cfg)
    return round_to_(fill_weights_(model, seed, leaves(model), output_layers, left_to_construction), served_dtype)


def served_outputs(out: dict, body: Body, expression: bool = True) -> dict:
    """The compared outputs and the picks of a model output, the body
    model in fp32 (without the expression where `expression` is false)."""
    expr = out["expression"].float()
    vertices, joints = body_forward(body, out["position"].float(), out["shape"].float(),
                                    expr if expression else torch.zeros_like(expr), out["rotmat"].float())
    return {"para": out["para"].float(), "vertices": vertices, "joints": joints, "scores": out["scores"].float(),
            "chosen": out["chosen"]}


class Server:
    """The system under test: the toy in the served dtype, its picks made
    on the device with no host wait. `pick` and `expression` are what the
    tests' planted faults change."""

    pick = staticmethod(top_k)
    expression = True

    def __init__(self, model: nn.Module, body: Body, dtype: torch.dtype):
        self.model, self.body, self.dtype = model.eval().to(dtype), body, dtype

    @torch.inference_mode()
    def __call__(self, images):
        return served_outputs(self.model(images.to(self.dtype), pick=self.pick), self.body, self.expression)


def port_server(cfg: dict, ref_cfg: dict, seed: int, dtype: torch.dtype, device, body: Body):
    with torch.device(device):
        model = ToyPeople(cfg)
    model.load_state_dict(reference_model(ref_cfg, seed, device).state_dict())
    return Server(model, body_to_device(body, device), dtype)


def pick_shortfall(scores: torch.Tensor, chosen: torch.Tensor) -> float:
    """The widest shortfall, over the images, of a picked token's reference
    score below the reference's own pick of the same rank (the picks in
    order of their scores), over the spread of the image's scores (their
    median distance from the median); inf where an image picks a token
    twice."""
    k = chosen.shape[1]
    ranked = chosen.sort(dim=1).values
    if bool((ranked[:, 1:] == ranked[:, :-1]).any()):
        return math.inf
    best = torch.topk(scores, k, dim=1).values
    picked = torch.gather(scores, 1, chosen).sort(dim=1, descending=True).values
    spread = (scores - scores.median(dim=1, keepdim=True).values).abs().median(dim=1).values
    return ((best - picked).clamp_min(0).amax(dim=1) / spread.clamp_min(1e-30)).max().item()


def reference_outputs(model, body_t: Body, images: torch.Tensor, block: int, served: dict | None = None) -> dict:
    """The reference's compared outputs of `images` in blocks of `block`
    images, fp32; given the port's `served` outputs, for the port's picks,
    with the reading `pick_shortfall` of those picks."""
    outs = []
    for i in range(0, images.shape[0], block):
        chosen = None if served is None else served["chosen"][i:i + block]
        outs.append(served_outputs(model(images[i:i + block].float(), chosen=chosen), body_t))
    ref = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
    if served is not None:
        ref["readings"] = {"pick_shortfall": pick_shortfall(ref["scores"], served["chosen"])}
    return ref
