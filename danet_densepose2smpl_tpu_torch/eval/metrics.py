"""Evaluation metrics: MPJPE / PA-MPJPE, streaming segmentation scores and
the COCO keypoint OKS AP.

Port of the JAX package's `eval/metrics.py`. The segmentation scores
accumulate on the tensors' device in int64 and reach the host only when
read. The COCO OKS AP (`keypoint_oks_ap`, `rescore_detections`; reference
`datasets/coco_keypoint_dataset.py:287-443`) is host numpy in the JAX
package, a reimplementation of pycocotools' COCOeval; the port keeps its
own copy of it.
"""

from __future__ import annotations

import numpy as np
import torch

from danet_densepose2smpl_tpu_torch.ops.procrustes import reconstruction_error


def compute_mpjpe(pred: torch.Tensor, gt: torch.Tensor):
    """Per-sample MPJPE and PA-MPJPE (meters). pred / gt: (B, J, 3)."""
    mpjpe = torch.sqrt(((pred - gt) ** 2).sum(-1)).mean(-1)
    return mpjpe, reconstruction_error(pred, gt)


class SegmentationScores:
    """Streaming accuracy and per-class F1 of label maps.

    `update(pred, gt, keep=None)` adds one pair of integer maps (any equal
    shapes, any device): accuracy counts pred == gt over every pixel; the
    true/false positive and false negative counts of classes 0..n-1 take
    only the pixels where `keep` is True (all when None). Labels outside
    0..n-1 count toward accuracy only. The counts live in one int64
    confusion matrix on the device of the first update."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        n = num_classes + 1          # the last row / column: any other label
        self.confusion = torch.zeros((n, n), dtype=torch.int64)
        self.correct = torch.zeros((), dtype=torch.int64)
        self.total = 0

    def update(self, pred: torch.Tensor, gt: torch.Tensor, keep: torch.Tensor | None = None):
        if self.confusion.device != gt.device:
            self.confusion = self.confusion.to(gt.device)
            self.correct = self.correct.to(gt.device)
        n = self.num_classes
        pred, gt = pred.reshape(-1).long(), gt.reshape(-1).long()
        self.correct += (pred == gt).sum()
        self.total += gt.numel()
        p = torch.where((pred >= 0) & (pred < n), pred, n)
        g = torch.where((gt >= 0) & (gt < n), gt, n)
        cell = g * (n + 1) + p
        if keep is not None:            # dropped pixels go to a bin past the matrix
            cell = torch.where(keep.reshape(-1), cell, (n + 1) ** 2)
        counts = torch.zeros((n + 1) ** 2 + 1, dtype=torch.int64, device=gt.device)
        counts.scatter_add_(0, cell, torch.ones_like(cell))
        self.confusion += counts[:-1].reshape(n + 1, n + 1)

    def counts(self):
        """(tp, fp, fn) as float64 numpy arrays of length num_classes."""
        c = self.confusion.cpu().numpy().astype(np.float64)
        n = self.num_classes
        tp = np.diag(c)[:n]
        return tp, c[:, :n].sum(0) - tp, c[:n, :].sum(1) - tp

    @property
    def accuracy(self) -> float:
        return float(int(self.correct) / max(self.total, 1))

    @property
    def f1(self) -> np.ndarray:
        tp, fp, fn = self.counts()
        return 2 * tp / np.maximum(2 * tp + fp + fn, 1e-9)


# COCO 17-keypoint OKS sigmas (person category, pycocotools convention).
COCO_KP_SIGMAS = np.array(
    [0.26, 0.25, 0.25, 0.35, 0.35, 0.79, 0.79, 0.72, 0.72, 0.62, 0.62,
     1.07, 1.07, 0.87, 0.87, 0.89, 0.89]
) / 10.0

# COCOeval keypoint defaults (pycocotools Params(iouType='keypoints')).
OKS_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.00, 101)
MAX_DETS = 20
AREA_RNG = {
    "all": (0.0, 1e5 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e5 ** 2),
}


def compute_oks(dt_kps: np.ndarray, gt: dict, sigmas: np.ndarray = COCO_KP_SIGMAS) -> np.ndarray:
    """OKS of each detection against one GT — pycocotools `computeOks`.

    dt_kps: (D, 17, 3); gt: dict with keypoints (17, 3), area, bbox [x,y,w,h].
    GT with no labeled keypoints scores by distance outside the 3x-extended
    bbox, exactly as pycocotools does for crowd regions.
    """
    var = (sigmas * 2) ** 2
    g = np.asarray(gt["keypoints"], dtype=np.float64)
    xg, yg, vg = g[:, 0], g[:, 1], g[:, 2]
    k1 = int(np.count_nonzero(vg > 0))
    xd, yd = dt_kps[:, :, 0].astype(np.float64), dt_kps[:, :, 1].astype(np.float64)
    if k1 > 0:
        dx = xd - xg[None, :]
        dy = yd - yg[None, :]
    else:
        bb = np.asarray(gt["bbox"], dtype=np.float64)
        x0, x1 = bb[0] - bb[2], bb[0] + bb[2] * 2
        y0, y1 = bb[1] - bb[3], bb[1] + bb[3] * 2
        z = np.zeros_like(xd)
        dx = np.maximum(z, x0 - xd) + np.maximum(z, xd - x1)
        dy = np.maximum(z, y0 - yd) + np.maximum(z, yd - y1)
    e = (dx ** 2 + dy ** 2) / var[None, :] / (float(gt["area"]) + np.spacing(1)) / 2.0
    if k1 > 0:
        e = e[:, vg > 0]
    return np.exp(-e).sum(axis=1) / e.shape[1]


def _match_image(dts: list, gts: list, area_rng, oks_mat: np.ndarray):
    """Greedy per-threshold matching for one image — pycocotools
    `evaluateImg` (ignore-aware, crowd-rematchable). dts must already be
    score-sorted and truncated to MAX_DETS; oks_mat is (D, G) in that order.
    Returns (dt_matched (T, D), dt_ignored (T, D), gt_ignore (G,), dt_scores)."""
    g_ig = np.array(
        [
            1 if (g.get("ignore", 0) or not (area_rng[0] <= g["area"] <= area_rng[1])) else 0
            for g in gts
        ],
        dtype=np.int64,
    )
    gtind = np.argsort(g_ig, kind="mergesort")  # non-ignored first
    gts = [gts[i] for i in gtind]
    g_ig = g_ig[gtind]
    oks_mat = oks_mat[:, gtind] if len(gts) else oks_mat
    iscrowd = [int(g.get("iscrowd", 0)) for g in gts]

    T, D, G = len(OKS_THRS), len(dts), len(gts)
    gtm = -np.ones((T, G), dtype=np.int64)
    dtm = -np.ones((T, D), dtype=np.int64)
    dt_ig = np.zeros((T, D), dtype=bool)
    if G:
        for tind, t in enumerate(OKS_THRS):
            for dind in range(D):
                best = min(t, 1 - 1e-10)
                m = -1
                for gind in range(G):
                    if gtm[tind, gind] >= 0 and not iscrowd[gind]:
                        continue
                    # gts sorted ignored-last: stop at the first ignored gt
                    # once a real match exists
                    if m > -1 and g_ig[m] == 0 and g_ig[gind] == 1:
                        break
                    if oks_mat[dind, gind] < best:
                        continue
                    best = oks_mat[dind, gind]
                    m = gind
                if m == -1:
                    continue
                dt_ig[tind, dind] = bool(g_ig[m])
                dtm[tind, dind] = m
                gtm[tind, m] = dind
    # unmatched detections outside the area range are ignored
    a = np.array(
        [not (area_rng[0] <= d["area"] <= area_rng[1]) for d in dts], dtype=bool
    ).reshape(1, D)
    dt_ig = np.logical_or(dt_ig, np.logical_and(dtm < 0, np.repeat(a, T, axis=0)))
    return dtm >= 0, dt_ig, g_ig


def _detection_area(kps: np.ndarray) -> float:
    """Keypoint-extent box area — what COCO.loadRes assigns to keypoint
    detections (pycocotools coco.py loadRes)."""
    x, y = kps[:, 0], kps[:, 1]
    return float((x.max() - x.min()) * (y.max() - y.min()))


def keypoint_oks_ap(
    detections: list,
    ground_truths: list,
    sigmas: np.ndarray = COCO_KP_SIGMAS,
):
    """COCO keypoint AP/AR — numpy reimplementation of pycocotools COCOeval
    (iouType='keypoints') + `_do_python_keypoint_eval`
    (reference `datasets/coco_keypoint_dataset.py:430-443`).

    detections: dicts {image_id, keypoints (17, 3: x, y, score), score,
      optional area (defaults to the keypoint-extent box, as COCO.loadRes)}.
    ground_truths: dicts {image_id, keypoints (17, 3: x, y, v in {0,1,2}),
      area, bbox [x, y, w, h], optional iscrowd, optional ignore}. A GT with
      no labeled keypoints (or iscrowd) is an ignore region, exactly as
      pycocotools treats num_keypoints==0 / crowd annotations.

    Returns the 10-stat dict COCOeval.summarize prints: AP, AP50, AP75,
    AP(M), AP(L), AR, AR50, AR75, AR(M), AR(L). Stats with no GT are -1.
    """
    for g in ground_truths:
        kp = np.asarray(g["keypoints"])
        nkp = int(np.count_nonzero(kp[:, 2] > 0))
        g["ignore"] = int(bool(g.get("iscrowd", 0)) or nkp == 0 or g.get("ignore", 0))
    for d in detections:
        if "area" not in d:
            d["area"] = _detection_area(np.asarray(d["keypoints"]))

    img_ids = sorted(
        {g["image_id"] for g in ground_truths} | {d["image_id"] for d in detections}
    )
    by_img_gt = {i: [] for i in img_ids}
    by_img_dt = {i: [] for i in img_ids}
    for g in ground_truths:
        by_img_gt[g["image_id"]].append(g)
    for d in detections:
        by_img_dt[d["image_id"]].append(d)

    # per-image: sort detections by score (stable), truncate, compute OKS once
    per_img = {}
    for i in img_ids:
        dts = by_img_dt[i]
        order = np.argsort([-d["score"] for d in dts], kind="mergesort")
        dts = [dts[j] for j in order][:MAX_DETS]
        gts = by_img_gt[i]
        if dts and gts:
            dt_kps = np.stack([np.asarray(d["keypoints"], dtype=np.float64) for d in dts])
            oks = np.stack([compute_oks(dt_kps, g, sigmas) for g in gts], axis=1)
        else:
            oks = np.zeros((len(dts), len(gts)))
        per_img[i] = (dts, gts, oks)

    T, R = len(OKS_THRS), len(REC_THRS)
    stats = {}
    for a_name, a_rng in AREA_RNG.items():
        all_scores, all_tp, all_ig = [], [], []
        npig = 0
        for i in img_ids:
            dts, gts, oks = per_img[i]
            if not dts and not gts:
                continue
            matched, ignored, g_ig = _match_image(dts, gts, a_rng, oks)
            all_scores.append(np.array([d["score"] for d in dts]))
            all_tp.append(matched)
            all_ig.append(ignored)
            npig += int(np.count_nonzero(g_ig == 0))
        if npig == 0:
            stats[a_name] = (-np.ones(T), -np.ones(T))
            continue
        scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
        inds = np.argsort(-scores, kind="mergesort")
        tp = (np.concatenate(all_tp, axis=1) if all_tp else np.zeros((T, 0), bool))[:, inds]
        ig = (np.concatenate(all_ig, axis=1) if all_ig else np.zeros((T, 0), bool))[:, inds]

        tps = np.logical_and(tp, ~ig)
        fps = np.logical_and(~tp, ~ig)
        tp_sum = np.cumsum(tps, axis=1, dtype=np.float64)
        fp_sum = np.cumsum(fps, axis=1, dtype=np.float64)
        ap_t = np.zeros(T)
        ar_t = np.zeros(T)
        for t in range(T):
            tp_c, fp_c = tp_sum[t], fp_sum[t]
            nd = len(tp_c)
            rc = tp_c / npig
            pr = tp_c / (fp_c + tp_c + np.spacing(1))
            ar_t[t] = rc[-1] if nd else 0.0
            q = np.zeros(R)
            pr = pr.tolist()
            for k in range(nd - 1, 0, -1):
                if pr[k] > pr[k - 1]:
                    pr[k - 1] = pr[k]
            pos = np.searchsorted(rc, REC_THRS, side="left")
            for ri, pi in enumerate(pos):
                if pi < nd:
                    q[ri] = pr[pi]
            ap_t[t] = q.mean()
        stats[a_name] = (ap_t, ar_t)

    def _sel(area, thr=None, kind=0):
        arr = stats[area][kind]
        if arr[0] == -1:
            return -1.0
        if thr is None:
            return float(arr.mean())
        return float(arr[int(np.argmin(np.abs(OKS_THRS - thr)))])

    return {
        "AP": _sel("all"), "AP50": _sel("all", 0.5), "AP75": _sel("all", 0.75),
        "APm": _sel("medium"), "APl": _sel("large"),
        "AR": _sel("all", kind=1), "AR50": _sel("all", 0.5, 1), "AR75": _sel("all", 0.75, 1),
        "ARm": _sel("medium", kind=1), "ARl": _sel("large", kind=1),
    }


def rescore_detections(detections: list, in_vis_thre: float = 0.2) -> list:
    """Per-person rescoring — reference
    `datasets/coco_keypoint_dataset.py:316-340`: score = (mean keypoint
    confidence above `in_vis_thre`) x box score. Each detection dict carries
    keypoints (17, 3: x, y, conf) and box_score; sets/overwrites 'score'."""
    for d in detections:
        conf = np.asarray(d["keypoints"])[:, 2]
        valid = conf > in_vis_thre
        kpt_score = float(conf[valid].mean()) if valid.any() else 0.0
        d["score"] = kpt_score * float(d.get("box_score", 1.0))
    return detections
