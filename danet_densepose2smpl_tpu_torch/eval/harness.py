"""3D pose evaluation harness (the reference's eval.py core loop).

Port of the JAX package's `eval/harness.py`: per batch, model inference ->
SMPL forward -> H36M-regressor joints -> pelvis-centred MPJPE and
Procrustes PA-MPJPE; gendered GT meshes for 3DPW; the H36M-P2 per-action
table. The step runs on the device of the `para` that `infer_fn` returns;
batches are dicts of numpy arrays, as the JAX harness takes them. With
`device_preprocess`, the batches carry the raw uint8 frames and the crop
(`data/pipeline.device_preprocess`) runs on `device`, the model's device,
before `infer_fn`. The stages carry spans (`utils.profiling.annotate`)
pose.crop / infer / metrics / read for torch.profiler.

With `mesh` (`parallel.make_mesh`) the eval is data-parallel, as JAX's with
batch-sharded inputs and outputs: every rank is handed the global batch,
runs its rows, and returns the global per-sample arrays (each rank's rows
written into a zero buffer and summed over the ranks: exact).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from danet_densepose2smpl_tpu_torch.constants import H36M_TO_J14, H36M_TO_J17, J24_TO_J14, J24_TO_J17
from danet_densepose2smpl_tpu_torch.data.pipeline import device_preprocess as crop_on_device
from danet_densepose2smpl_tpu_torch.eval.metrics import compute_mpjpe
from danet_densepose2smpl_tpu_torch.ops.procrustes import full_fp32
from danet_densepose2smpl_tpu_torch.parallel.mesh import all_gather_rows
from danet_densepose2smpl_tpu_torch.smpl.loader import SMPLModel, to_torch
from danet_densepose2smpl_tpu_torch.smpl.model import smpl_forward, smpl_forward_aa
from danet_densepose2smpl_tpu_torch.utils.profiling import annotate


def synthetic_h36m_regressor(num_verts: int, seed: int = 0) -> np.ndarray:
    """(17, V) stand-in for the official J_regressor_h36m.npy (rows sum 1)."""
    rng = np.random.RandomState(seed)
    J = np.zeros((17, num_verts), np.float32)
    for j in range(17):
        ids = rng.choice(num_verts, size=8, replace=False)
        w = rng.rand(8).astype(np.float32)
        J[j, ids] = w / w.sum()
    return J


@dataclass
class PoseEvalResult:
    mpjpe: np.ndarray
    pa_mpjpe: np.ndarray
    per_action: dict = field(default_factory=dict)

    @property
    def mpjpe_mm(self) -> float:
        return float(self.mpjpe.mean() * 1000.0)

    @property
    def pa_mpjpe_mm(self) -> float:
        return float(self.pa_mpjpe.mean() * 1000.0)

    def summary(self, name: str = "") -> str:
        lines = [f"*** {name} ***", f"MPJPE: {self.mpjpe_mm:.2f} mm", f"PA-MPJPE (rec. err): {self.pa_mpjpe_mm:.2f} mm"]
        if self.per_action:
            lines.append("per-action PA-MPJPE:")
            for act, (m, pa) in sorted(self.per_action.items()):
                lines.append(f"  {act:16s} MPJPE {m:7.2f}  PA {pa:7.2f}")
        return "\n".join(lines)


def h36m_action_of(imgname: str) -> str:
    """Action tag from an H36M frame path (reference eval.py:152)."""
    return imgname.split("/")[-1].split(".")[0].split("_")[1]


def _check_options(device_preprocess: bool, device) -> None:
    if device_preprocess and device is None:
        raise ValueError("device_preprocess crops on the model's device: pass device=")


def make_eval_step(
    infer_fn,
    smpl_neutral: SMPLModel,
    j_regressor: np.ndarray,
    joint_mapper_h36m: np.ndarray,
    joint_mapper_gt: np.ndarray,
    use_gt_verts: bool,
    smpl_male: SMPLModel | None = None,
    smpl_female: SMPLModel | None = None,
    device_preprocess: bool = False,
    mesh=None,
    device=None,
):
    """One eval step: images (+GT) -> ((per-sample mpjpe, pa), para).

    `infer_fn(images) -> para (B, 229)` runs the model; the step follows
    `para`'s device and dtype, and moves the SMPL arrays, the regressor and
    the GT there (once per device and dtype). With `device_preprocess`,
    `images` are the raw (B, H, W, 3) uint8 frames, and `centers` /
    `scales` place each crop; the crop runs on `device`. With `mesh`, each
    rank takes its rows of the global batch it is handed and returns the
    global results."""
    _check_options(device_preprocess, device)
    on = {}

    def tables(dev, dtype):
        key = (str(dev), dtype)
        if key not in on:
            models = {"neutral": smpl_neutral}
            if use_gt_verts:
                models.update(male=smpl_male, female=smpl_female)
            on[key] = {k: to_torch(m, dev, dtype) for k, m in models.items()} | {
                "jreg": torch.as_tensor(np.asarray(j_regressor), device=dev).to(dtype),
                "mh": torch.as_tensor(np.asarray(joint_mapper_h36m), dtype=torch.long, device=dev),
                "mg": torch.as_tensor(np.asarray(joint_mapper_gt), dtype=torch.long, device=dev)}
        return on[key]

    @torch.inference_mode()
    def step(images, gt_pose, gt_betas, gender, pose_3d, centers=None, scales=None):
        if mesh is None:
            return local_step(images, gt_pose, gt_betas, gender, pose_3d, centers, scales)
        rows = mesh.rows(len(images))
        (mpjpe, pa), para = local_step(*(None if a is None else a[rows] for a in (
            images, gt_pose, gt_betas, gender, pose_3d, centers, scales)))
        return (all_gather_rows(mpjpe, mesh), all_gather_rows(pa, mesh)), all_gather_rows(para, mesh)

    def local_step(images, gt_pose, gt_betas, gender, pose_3d, centers, scales):
        if device_preprocess:
            with annotate("pose.crop"):
                images = crop_on_device(torch.as_tensor(np.asarray(images)).to(device),
                                        torch.as_tensor(np.asarray(centers)), torch.as_tensor(np.asarray(scales)))
        with annotate("pose.infer"):
            para = infer_fn(images)
        with annotate("pose.metrics"):
            return score(para, gt_pose, gt_betas, gender, pose_3d), para

    def score(para, gt_pose, gt_betas, gender, pose_3d):
        t = tables(para.device, para.dtype)

        def gt(a):
            return torch.as_tensor(np.asarray(a), device=para.device).to(para.dtype)

        pred_verts = smpl_forward(t["neutral"], para[:, 3:13], para[:, 13:].reshape(-1, 24, 3, 3)).vertices
        with full_fp32():
            pred_j = torch.einsum("jv,bvc->bjc", t["jreg"], pred_verts)
            pred_sel = pred_j[:, t["mh"]] - pred_j[:, :1]
            if use_gt_verts:
                # 3DPW: gendered GT meshes (reference eval.py:192-198)
                vm = smpl_forward_aa(t["male"], gt(gt_betas), gt(gt_pose)).vertices
                vf = smpl_forward_aa(t["female"], gt(gt_betas), gt(gt_pose)).vertices
                female = torch.as_tensor(np.asarray(gender), device=para.device) == 1
                gt_j = torch.einsum("jv,bvc->bjc", t["jreg"], torch.where(female[:, None, None], vf, vm))
                gt_sel = gt_j[:, t["mh"]] - gt_j[:, :1]
            else:
                gt_sel = gt(pose_3d)[:, t["mg"], :3]
            return compute_mpjpe(pred_sel, gt_sel)

    return step


def run_pose_eval(
    infer_fn,
    loader,
    dataset_name: str,
    smpl_neutral: SMPLModel,
    j_regressor: np.ndarray,
    smpl_male: SMPLModel | None = None,
    smpl_female: SMPLModel | None = None,
    imgnames: np.ndarray | None = None,
    log_every: int = 10,
    device_preprocess: bool = False,
    mesh=None,
    device=None,
) -> PoseEvalResult:
    """Evaluate over `loader`: an iterable of (batch index, batch dict)
    with img (B, H, W, 3) normalized, pose (B, 72), betas (B, 10), gender
    (B,), pose_3d (B, 24, 4) and sample_index (B,), numpy arrays; with
    `device_preprocess`, raw_img (B, H, W, 3) uint8, center (B, 2) and
    scale (B,) in place of img, cropped on `device` (the model's). With
    `mesh`, every rank iterates the same global batches, runs its rows and
    returns the whole result."""
    _check_options(device_preprocess, device)
    is_mpi = dataset_name == "mpi-inf-3dhp"
    mapper_h36m = H36M_TO_J17 if is_mpi else H36M_TO_J14
    mapper_gt = J24_TO_J17 if is_mpi else J24_TO_J14
    use_gt_verts = dataset_name == "3dpw"

    step = make_eval_step(
        infer_fn, smpl_neutral, j_regressor, mapper_h36m, mapper_gt,
        use_gt_verts, smpl_male or smpl_neutral, smpl_female or smpl_neutral,
        device_preprocess=device_preprocess, mesh=mesh, device=device,
    )

    all_mpjpe, all_pa, all_idx = [], [], []
    for b, batch in loader:
        if device_preprocess:
            images, extra = batch["raw_img"], (batch["center"], batch["scale"])
        else:
            images, extra = batch["img"], ()
        (mpjpe, pa), _ = step(torch.as_tensor(np.asarray(images)), batch["pose"], batch["betas"],
                              batch["gender"], batch["pose_3d"], *extra)
        with annotate("pose.read"):
            all_mpjpe.append(mpjpe.cpu().numpy())
            all_pa.append(pa.cpu().numpy())
        all_idx.append(np.asarray(batch["sample_index"]))
        if log_every and b % log_every == 0:
            print(f"batch {b}: MPJPE {np.concatenate(all_mpjpe).mean()*1000:.2f} mm "
                  f"PA {np.concatenate(all_pa).mean()*1000:.2f} mm")

    mpjpe = np.concatenate(all_mpjpe)
    pa = np.concatenate(all_pa)
    idx = np.concatenate(all_idx)

    per_action = {}
    if dataset_name == "h36m-p2" and imgnames is not None:
        actions = {}
        for row, i in enumerate(idx):
            act = h36m_action_of(str(imgnames[i]))
            actions.setdefault(act, []).append(row)
        for act, rows in actions.items():
            per_action[act] = (
                float(mpjpe[rows].mean() * 1000.0),
                float(pa[rows].mean() * 1000.0),
            )
    return PoseEvalResult(mpjpe=mpjpe, pa_mpjpe=pa, per_action=per_action)
