"""The 'iuv_gt' oracle's training step and the GT modes' train-mode
forward with injected noise, against the JAX package on the CPU (full W48
width, 64 px, B=4, f64). The feature modes' and 'seg''s training steps are
`tests/test_torch_input_modes_train_*.py`, one a file: each is one XLA
compile of the JAX step's whole backward, ~2-3 min."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from danet_densepose2smpl_tpu.models.danet import DaNet as JDaNet

from danet_densepose2smpl_tpu_torch import port

from test_torch_config import jax_cfg
from test_torch_input_modes import (  # noqa: F401 (x64_mode: a fixture)
    BATCH,
    SIZE,
    check_train_step,
    f64,
    gt_inputs,
    gt_kwargs,
    mode_cfg,
    port_model,
    variables_for,
    x64_mode,
)


def test_train_step_matches_jax_f64(x64_mode):  # noqa: F811
    """`check_train_step('iuv_gt')`: the oracle has no backbone; its STN
    ratio/offset are parameters whose gradients (through the GT part crops,
    which keep theta's gradient, into the partial UV losses and the limb
    branch) are non-zero and equal JAX's within the step's bar."""
    model = check_train_step("iuv_gt")
    for p in (model.img2iuv.learned_ratio, model.img2iuv.learned_offset):
        assert p.grad is not None and float(p.grad.abs().min()) > 0


@pytest.mark.parametrize("mode", ["iuv_gt", "iuv_gt_feat"])
def test_train_forward_with_injected_noise_matches_jax(mode, x64_mode, monkeypatch):  # noqa: F811
    """The train-mode forward with the default PartDrop (0.3) and STN
    jitter (centre 0.1, scale 0.2), f64: a recording wrapper of
    `jax.random.uniform` hands the port JAX's uniforms. The oracle draws
    two (the centre jitter straight from the 'jitter' stream, unsplit, and
    PartDrop; it has no scale jitter), 'iuv_gt_feat''s estimator four.
    `para`, the thetas, the limb branch's stacks (GT crops in both modes,
    PartDrop applied), the cleaned global index map, the coordinate heads
    and the BatchNorm statistics at f64 noise (rtol/atol 1e-9; statistics
    rtol 1e-9, atol 1e-10). The first head's rotations are held to 1e-8:
    in 'iuv_gt_feat' they part from JAX's by up to 6.3e-9 (4.7x the 1e-9
    bar, on 5 of 864 entries; `para` 0.10x, the other outputs at most
    0.6x). The forward is ill-conditioned, not wrong: in the port alone, a
    1e-15 relative change of the image moves these rotations by 1.2e-10
    and `para` by 5e-11 of its largest entry (train-mode BatchNorm over
    B=4, then the 6D -> rotation Gram-Schmidt of random-weight outputs)."""
    cfg = mode_cfg(mode)
    variables = variables_for(cfg, seed=9)
    v64 = f64(variables)
    x = np.random.RandomState(12).rand(BATCH, SIZE, SIZE, 3)
    uv, kps = gt_inputs(7)
    drawn, uniform = [], jax.random.uniform

    def recording_uniform(*args, **kwargs):
        drawn.append(uniform(*args, **kwargs))
        return drawn[-1]

    monkeypatch.setattr(jax.random, "uniform", recording_uniform)
    jmodel = JDaNet(jax_cfg(cfg), train=True)

    def forward(v, img, kw, key):
        drawn.clear()
        out, upd = jmodel.apply(v, img, mutable=["batch_stats"],
                                rngs={"jitter": key, "partdrop": jax.random.fold_in(key, 1)}, **kw)
        return out, upd["batch_stats"], list(drawn)

    jout, jstats, u = jax.jit(forward)(v64, jnp.asarray(x), gt_kwargs(mode, uv, kps, jnp.asarray),
                                       jax.random.PRNGKey(2))
    shapes = [(BATCH, 24, 2)] + ([] if mode == "iuv_gt" else [(BATCH, 24)] * 2) + [(BATCH, 24)]
    assert [a.shape for a in u] == shapes
    noise = {"center": torch.from_numpy(np.array(u[0])), "partdrop": torch.from_numpy(np.array(u[-1]))}
    if mode == "iuv_gt_feat":
        noise["scale"] = torch.from_numpy(np.stack([np.array(u[1]), np.array(u[2])]))
    assert bool((noise["partdrop"] < cfg.partdrop_rate).any())

    model = port_model(cfg, variables).double().train()
    out = model(torch.from_numpy(x), noise=noise, **gt_kwargs(mode, uv, kps, torch.from_numpy))
    pairs = [(out["para"], jout["para"]), (out["iuv_raw"]["stn_theta"], jout["iuv_raw"]["stn_theta"]),
             (out["iuv_raw"]["stn_centers"], jout["iuv_raw"]["stn_centers"]),
             (out["iuv_raw"]["part_iuv"], jout["iuv_raw"]["part_iuv"]),
             (out["part_iuv_clean"], jout["part_iuv_clean"]), (out["iuv_clean"][2], jout["iuv_clean"][2])]
    rotations = list(zip(out["joint_rotation"], jout["joint_rotation"]))
    pairs += list(zip(out["joint_position"], jout["joint_position"]))
    assert len(pairs) + len(rotations) == 9
    # worst |ours - theirs| / (bar + bar |theirs|) of each pair: within 1 passes
    worst = [float(np.max(np.abs(ours.detach().numpy() - np.asarray(theirs)) / (bar + bar * np.abs(theirs))))
             for bar, group in ((1e-9, pairs), (1e-8, rotations)) for ours, theirs in group]
    assert max(worst) <= 1.0, worst
    stats = port.convert({"params": v64["params"], "batch_stats": jstats}, port.danet_rules(cfg))
    for name, b in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(b.numpy(), stats[name].numpy(), rtol=1e-9, atol=1e-10, err_msg=name)
