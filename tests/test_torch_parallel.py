"""Data parallel in the port (`parallel/`, the `mesh=` paths of the train
step, the Trainer, the pose eval and `cli.train --data_parallel`) on the
CPU, without JAX.

The JAX step with `mesh=` is GSPMD: the sharded step is the single-device
step on the global batch (`tests/test_train_step.py:116`, slow,
`tests/test_eval_sharded.py:19`). The port reproduces that by hand, so the
tests hold its data-parallel step to its own single-process step, which
`tests/test_torch_train.py::test_train_step_matches_jax_f64` holds to
JAX's: two gloo ranks on the CPU (`tests/torch_parallel_ranks.py`, started
by `torch.multiprocessing`), each with 4 rows of a global batch of 8 whose
masks differ between the halves, against one process on all 8. Bars, f64:
losses rtol 1e-9; gradients within 1e-9 of their tensor's largest entry
(+1e-12: the heatmap head's bias has a gradient of exactly 0 in exact
arithmetic); BatchNorm statistics rtol 1e-9, atol 1e-10; the ranks'
parameters after the step bit-equal. The same rows with per-rank averaging
(plain DDP) miss these bars by orders of magnitude."""

import json
import os
import shutil
import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
import torch.nn.functional as F

import torch_parallel_ranks as ranks
from danet_densepose2smpl_tpu_torch.cli import train as cli_train
from danet_densepose2smpl_tpu_torch.config import DaNetConfig
from danet_densepose2smpl_tpu_torch.core.checkpoint import CheckpointManager
from danet_densepose2smpl_tpu_torch.data.loader import ResumableLoader
from danet_densepose2smpl_tpu_torch.models.danet import draw_noise
from danet_densepose2smpl_tpu_torch.nn.layers import GlobalBatchNorm
from danet_densepose2smpl_tpu_torch.parallel import Mesh, data_parallel, make_mesh, shard_batch

torch.set_num_threads(1)
WORLD = 2
CPU = torch.device("cpu")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The two ranks' results and the single-process references (computed
    while the ranks run)."""
    out = tmp_path_factory.mktemp("ranks")
    ctx = mp.spawn(ranks.rank_main, args=(WORLD, free_port(), str(out)), nprocs=WORLD, join=False)
    try:
        cfg = ranks.case_cfg("sgd")
        ref = {"step": ranks.run_step(cfg, ranks.case_batch(cfg)), "eval": ranks.run_eval()}
        deadline = time.monotonic() + 300
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, "the ranks did not finish in 300 s"
    finally:
        ranks.case_weights.cache_clear()
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    yield [torch.load(out / f"rank{r}.pt") for r in range(WORLD)], ref
    shutil.rmtree(out, ignore_errors=True)


def misses(res: dict, ref: dict) -> dict:
    """Each quantity's worst error over its bar (<= 1 passes)."""
    loss = max(abs(res["metrics"][k] - v) / (1e-9 * abs(v) + 1e-12) for k, v in ref["metrics"].items())
    grad = max(((res["grads"][k] - g).abs().max() / (1e-9 * g.abs().max() + 1e-12)).item()
               for k, g in ref["grads"].items())
    stats = max(((res["stats"][k] - s).abs() / (1e-9 * s.abs() + 1e-10)).max().item() for k, s in ref["stats"].items())
    return {"losses": loss, "gradients": grad, "statistics": stats}


def test_two_gloo_ranks_equal_the_global_batch_step(two_ranks):
    """The data-parallel f64 step on 2 x 4 rows equals the single-process
    step on the 8 rows: every loss term, every gradient (summed over the
    ranks), the BatchNorm statistics (the global batch's, on both ranks);
    and the ranks' parameters are bit-equal after Adam."""
    results, ref = two_ranks
    assert set(results[0]["dp"]["metrics"]) == set(ref["step"]["metrics"])
    assert ref["step"]["metrics"]["loss_Udp"] > 0 and ref["step"]["metrics"]["keypoints_3d"] > 0
    for res in results:
        worst = misses(res["dp"], ref["step"])
        assert max(worst.values()) <= 1.0, worst
    a, b = (r["dp"] for r in results)
    for part in ("params", "grads", "stats"):
        assert all(torch.equal(a[part][k], b[part][k]) for k in a[part]), part


def test_per_rank_averaging_misses_the_bar(two_ranks):
    """Plain DDP on the same rows (each rank's losses and BatchNorm over
    its own 4 rows, the losses and gradients averaged) is not the global
    batch's step: the losses, the gradients and the statistics all miss
    the bars above by more than 1000x, so the equality above sees the
    global semantics."""
    results, ref = two_ranks
    worst = misses(results[0]["per_rank"], ref["step"])
    assert min(worst.values()) > 1e3, worst


def test_eval_step_on_two_ranks_equals_one(two_ranks):
    """`make_eval_step(mesh=)`: each rank runs its 4 rows of the global
    batch and returns the global per-sample MPJPE, PA-MPJPE and para, equal
    to one process's on the 8 rows (mirrors `tests/test_eval_sharded.py`)."""
    results, ref = two_ranks
    for res in results:
        for got, want in zip(res["eval"], ref["eval"]):
            assert got.shape == want.shape and got.shape[0] == ranks.GLOBAL_BATCH
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-15)


def test_draw_noise_keeps_this_ranks_rows():
    """Inside `data_parallel(mesh)` each rank draws the global batch's
    uniforms from the step's generator and keeps its rows, so the ranks
    together see the single-process step's PartDrop and STN jitter."""
    cfg = DaNetConfig()
    whole = draw_noise(cfg, 8, torch.Generator().manual_seed(3), CPU)
    assert set(whole) == {"center", "scale", "partdrop"}
    for rank in range(WORLD):
        with data_parallel(Mesh(rank, WORLD, CPU, "gloo")):
            mine = draw_noise(cfg, 4, torch.Generator().manual_seed(3), CPU)
        rows = slice(4 * rank, 4 * rank + 4)
        assert torch.equal(mine["center"], whole["center"][rows])
        assert torch.equal(mine["scale"], whole["scale"][:, rows])
        assert torch.equal(mine["partdrop"], whole["partdrop"][rows])


def test_shard_batch_keeps_this_ranks_rows():
    batch = {"img": np.arange(24).reshape(6, 4), "names": ["a", "b", "c", "d", "e", "f"],
             "dp": {"x": torch.arange(12).reshape(6, 2)}, "flag": np.float32(1.0)}
    mine = shard_batch(batch, Mesh(1, 3, CPU, "gloo"))
    assert mine["img"].tolist() == [[8, 9, 10, 11], [12, 13, 14, 15]]
    assert mine["names"] == ["c", "d"] and mine["dp"]["x"].tolist() == [[4, 5], [6, 7]] and mine["flag"] == 1.0
    with pytest.raises(ValueError, match="does not divide over 4 ranks"):
        shard_batch(batch, Mesh(0, 4, CPU, "gloo"))


class _Draws:
    """A dataset whose items are their index and a draw of their RNG."""

    def __len__(self):
        return 12

    def __getitem__(self, i, rng=None):
        return {"i": np.int64(i), "u": rng.rand(3)}


def test_loader_rows_are_the_global_batch_rows():
    """A rank's loader (`rows=`) assembles its rows of each global batch as
    the single-process loader does, bit for bit: the same samples and the
    same per-sample augmentation draws, from any batch on (resume)."""
    whole = list(ResumableLoader(_Draws(), 6, seed=4).epoch(1))
    for rank in range(WORLD):
        rows = Mesh(rank, WORLD, CPU, "gloo").rows(6)
        mine = list(ResumableLoader(_Draws(), 6, seed=4, rows=rows).epoch(1, start_batch=1))
        assert [b for b, _ in mine] == [1]
        for key in ("i", "u"):
            np.testing.assert_array_equal(mine[0][1][key], whole[1][1][key][rows])


def test_make_mesh_world_of_one(monkeypatch):
    """Without torchrun's environment `make_mesh` is a world of one rank
    (gloo on the CPU); on the card by default, so without one it raises."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    mesh = make_mesh("cpu")
    try:
        assert (mesh.rank, mesh.size, mesh.backend, mesh.rows(5)) == (0, 1, "gloo", slice(0, 5))
        assert torch.distributed.get_world_size() == 1
    finally:
        mesh.close()
    assert not torch.distributed.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_global_batchnorm_at_one_rank_equals_batchnorm(monkeypatch):
    """`GlobalBatchNorm` (the statistics' collectives over a world of one)
    is train-mode BatchNorm: outputs, the batch mean and biased variance,
    and the input's, scale's and shift's gradients against `F.batch_norm`,
    f64, within 1e-12; activations whose mean is 13x their spread, where a
    one-pass E[x^2] - E[x]^2 would lose digits. (Inside `data_parallel` of
    one rank the layers take the plain path; two ranks run this one, in
    `test_two_gloo_ranks_equal_the_global_batch_step`.)"""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 4, 2) * 3 + 40
    dy = torch.from_numpy(rng.randn(3, 5, 4, 2))
    params = [torch.from_numpy(rng.rand(5) + 0.5), torch.from_numpy(rng.randn(5))]
    results = []
    mesh = make_mesh("cpu")
    try:
        for fn in (lambda xx, w, b: (F.batch_norm(xx, None, None, w, b, True, 0.0, 1e-5),),
                   lambda xx, w, b: GlobalBatchNorm.apply(xx, w, b, 1e-5)):
            xx = torch.from_numpy(x).requires_grad_()
            w, b = (p.clone().requires_grad_() for p in params)
            out = fn(xx, w, b)
            (out[0] * dy).sum().backward()
            results.append([out[0].detach(), xx.grad, w.grad, b.grad])
    finally:
        mesh.close()
    _, mean, var = out
    np.testing.assert_allclose(mean.numpy(), x.mean(axis=(0, 2, 3)), rtol=1e-12)
    np.testing.assert_allclose(var.numpy(), x.var(axis=(0, 2, 3)), rtol=1e-12)
    for ours, ref in zip(results[1], results[0]):
        np.testing.assert_allclose(ours.numpy(), ref.numpy(), rtol=1e-12, atol=1e-12)


def test_cli_train_data_parallel_world_of_one_equals_plain(tmp_path, monkeypatch):
    """`cli.train --data_parallel` launched plainly (a world of one, gloo
    with --cpu) trains as the run without the flag, bit for bit: the same
    metric rows and the same parameters in the last checkpoint (fp32, a
    random-init model whose second step's loss moves with any rounding of
    the first step's gradients)."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    base = ["--cpu", "--cfg", os.path.join(os.path.dirname(__file__), "..", "configs", "danet_tiny_test.yaml"),
            "--synthetic-data", "--img_size", "64", "--batch_size", "2", "--num_samples", "4", "--pretr_step", "1",
            "--summary_steps", "1", "--vis_interval", "0", "--num_verts", "500", "--num_epochs", "1",
            "--log_dir", str(tmp_path)]
    try:
        runs = {}
        for name, flags in (("plain", []), ("dp", ["--data_parallel"])):
            trainer = cli_train.main(base + ["--name", name] + flags)
            assert trainer.state.step == 2 and (trainer.mesh is None) == (name == "plain")
            with open(tmp_path / name / "metrics.jsonl") as f:
                runs[name] = [json.loads(line) for line in f]
        assert not torch.distributed.is_initialized()
        assert [r["step"] for r in runs["dp"]] == [r["step"] for r in runs["plain"]] == [1, 2]
        for dp, plain in zip(runs["dp"], runs["plain"]):
            losses = [k for k in plain if k not in ("step", "step_time_s", "imgs_per_sec")]
            assert set(dp) == set(plain) and len(losses) > 10
            assert {k: dp[k] for k in losses} == {k: plain[k] for k in losses}
        ckpts = {name: CheckpointManager(str(tmp_path / name / "checkpoints")) for name in runs}
        assert ckpts["dp"].steps() == ckpts["plain"].steps() == [2]
        models = [torch.load(ckpts[name]._path(2), weights_only=True)["model"] for name in runs]
        assert all(torch.equal(models[0][k], models[1][k]) for k in models[0])
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)
