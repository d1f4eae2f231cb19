"""Offline dataset preprocessing: DensePose-COCO json -> SPIN-format npz
(a numpy and json copy of the JAX package's `data/preprocess.py`).

Parity: reference `datasets/preprocess/dp_coco.py` — `db_coco_extract`
walks the densepose_coco json, keeps annotations with DensePose labels,
derives center/scale from the bbox, synthesizes 24 SMPL 2D keypoints from
the 17 COCO keypoints (`kp_coco2smpl` averaging rules), and stores the raw
dp annotation for per-sample blob processing at train time. No pycocotools
needed (plain json + the numpy RLE codec, `data/rle.py`).
"""

from __future__ import annotations

import json
import os

import numpy as np

# COCO keypoint order: 0 nose, 1-2 eyes, 3-4 ears, 5-6 shoulders,
# 7-8 elbows, 9-10 wrists, 11-12 hips, 13-14 knees, 15-16 ankles.
# Direct SMPL<-COCO joint correspondences (limbs); reference dp_coco.py:104-110.
SMPL_FROM_COCO_DIRECT = (
    (1, 11), (2, 12), (4, 13), (5, 14), (7, 15), (8, 16),
    (16, 5), (17, 6), (18, 7), (19, 8), (20, 9), (21, 10),
)


def kp_coco2smpl(coco_kps: np.ndarray) -> np.ndarray:
    """(17, 3) COCO keypoints (x, y, vis) -> (24, 3) SMPL 2D keypoints with
    confidence channel — the reference's synthesis rules
    (dp_coco.py:103-150): direct limb mappings at half the COCO confidence,
    then cascading mid-point constructions (pelvis from hips, neck from
    shoulders, head from neck+nose, spine chain, collars, hands/feet copy
    wrists/ankles) at confidence 0.5."""
    kp = np.zeros((24, 3), np.float64)
    for sj, cj in SMPL_FROM_COCO_DIRECT:
        kp[sj, :2] = coco_kps[cj, :2]
        kp[sj, 2] = coco_kps[cj, 2] / 2.0

    def mid(a, b):
        return (a[:2] + b[:2]) / 2.0

    if (coco_kps[[11, 12], 2] > 0).all():
        kp[0] = [*mid(coco_kps[11], coco_kps[12]), 0.5]
    if (coco_kps[[5, 6], 2] > 0).all():
        kp[12] = [*mid(coco_kps[5], coco_kps[6]), 0.5]
    if kp[12, 2] > 0 and coco_kps[0, 2] > 0:
        kp[15] = [*mid(kp[12], coco_kps[0]), 0.5]
    if kp[0, 2] > 0 and kp[12, 2] > 0:
        kp[6] = [*mid(kp[0], kp[12]), 0.5]
        kp[9] = kp[6].copy()
    if kp[0, 2] > 0 and kp[6, 2] > 0:
        kp[3] = [*mid(kp[0], kp[6]), 0.5]
    if kp[9, 2] > 0 and kp[16, 2] > 0:
        kp[13] = [*mid(kp[9], kp[16]), 0.5]
    if kp[9, 2] > 0 and kp[17, 2] > 0:
        kp[14] = [*mid(kp[9], kp[17]), 0.5]
    for src, dst in ((7, 10), (8, 11), (20, 22), (21, 23)):
        if kp[src, 2] > 0:
            kp[dst] = [*kp[src, :2], 0.5]
    return kp


# COCO-17 keypoints land at these indices of the GT-24 "part" layout
# (SPIN convention; reference dp_coco.py:12, `part[joints_idx] = keypoints`)
COCO17_TO_GT24 = (19, 20, 21, 22, 23, 9, 8, 10, 7, 11, 6, 3, 2, 4, 1, 5, 0)

# reference dp_coco.py:15 — bbox -> SPIN box margin
BBOX_SCALE_FACTOR = 1.2


def db_coco_extract(json_path: str, out_npz: str, img_prefix: str = "") -> int:
    """densepose_coco json -> SPIN npz with imgname/center/scale/part/
    smpl_2dkps/dp_annot/im_id/id columns. Returns the number of samples
    written. `img_prefix` is prepended to each file_name (the reference
    stores 'train2014/...' etc, dp_coco.py:22,59).

    Filter parity (dp_coco.py:38-41): an annotation is kept iff it carries
    `dp_masks`; keypoint-less dp annotations are kept with zero parts."""
    with open(json_path) as f:
        db = json.load(f)

    images = {im["id"]: im for im in db["images"]}
    rows = {k: [] for k in ("imgname", "center", "scale", "part",
                            "smpl_2dkps", "dp_annot", "im_id", "id")}

    for ann in db["annotations"]:
        if "dp_masks" not in ann:
            continue
        im = images[ann["image_id"]]
        x, y, w, h = ann["bbox"]
        center = [x + w / 2.0, y + h / 2.0]
        scale = BBOX_SCALE_FACTOR * max(w, h) / 200.0

        kps = np.asarray(ann.get("keypoints") or [0.0] * 51, np.float64).reshape(17, 3)
        kps[:, 2] = (kps[:, 2] > 0).astype(np.float64)
        part24 = np.zeros((24, 3))
        part24[list(COCO17_TO_GT24)] = kps

        rows["imgname"].append(os.path.join(img_prefix, im["file_name"])
                               if img_prefix else im["file_name"])
        rows["center"].append(center)
        rows["scale"].append(scale)
        rows["part"].append(part24)
        rows["smpl_2dkps"].append(kp_coco2smpl(kps))
        rows["dp_annot"].append(
            {
                "bbox": ann["bbox"],
                "dp_masks": ann.get("dp_masks"),
                "dp_I": ann["dp_I"],
                "dp_U": ann["dp_U"],
                "dp_V": ann["dp_V"],
                "dp_x": ann["dp_x"],
                "dp_y": ann["dp_y"],
            }
        )
        rows["im_id"].append(ann["image_id"])
        rows["id"].append(ann.get("id", -1))

    n = len(rows["imgname"])
    os.makedirs(os.path.dirname(out_npz) or ".", exist_ok=True)
    np.savez(
        out_npz,
        imgname=np.array(rows["imgname"]),
        center=np.array(rows["center"], np.float64),
        scale=np.array(rows["scale"], np.float64),
        part=np.array(rows["part"], np.float64),
        smpl_2dkps=np.array(rows["smpl_2dkps"], np.float64),
        dp_annot=np.array(rows["dp_annot"], dtype=object),
        im_id=np.array(rows["im_id"], np.int64),
        id=np.array(rows["id"], np.int64),
    )
    return n


def check_dp_coco_json(json_path: str, max_report: int = 10) -> dict:
    """Schema preflight for a real densepose_coco json: validate every
    observable assumption that the converter and the train-time DensePose
    blobs (`data/dp_annot.py`, reference `utils/dp_utils.py:12-140`) make,
    BEFORE running the conversion. Returns a report dict; report["ok"] is
    the go/no-go.

    Hard failures (would crash or corrupt the conversion): missing
    images/annotations keys, image records without id/file_name, annotation
    image_ids that don't resolve, dp-annotated records missing any of
    dp_x/y/I/U/V, ragged dp point lists, undecodable dp_masks entries.
    Warnings (handled, but worth eyes): crowd records carrying dp labels,
    dp_I outside 1..24, dp_x/y outside [0,256], dp_U/V outside [0,1],
    >196 points (the blob keeps the first 196, dp_annot.py), degenerate
    bboxes, missing/short keypoints (treated as all-invisible), compressed
    vs uncompressed RLE variant counts."""
    from danet_densepose2smpl_tpu_torch.data.rle import decode_rle

    errors: list = []
    warnings: list = []
    stats = {"images": 0, "annotations": 0, "dp_annotations": 0,
             "crowd_with_dp": 0, "rle_compressed": 0, "rle_uncompressed": 0,
             "rle_empty_slots": 0, "over_196_points": 0, "no_keypoints": 0}

    def err(msg):
        if len(errors) < max_report:
            errors.append(msg)
        elif len(errors) == max_report:
            errors.append("... (more suppressed)")

    def warn(msg):
        if len(warnings) < max_report:
            warnings.append(msg)
        elif len(warnings) == max_report:
            warnings.append("... (more suppressed)")

    with open(json_path) as f:
        db = json.load(f)

    for key in ("images", "annotations"):
        if key not in db:
            err(f"top-level '{key}' missing")
    if errors:
        return {"ok": False, "errors": errors, "warnings": warnings, "stats": stats}

    images = {}
    for im in db["images"]:
        if "id" not in im or "file_name" not in im:
            err(f"image record without id/file_name: {sorted(im)[:6]}")
            continue
        images[im["id"]] = im
    stats["images"] = len(images)

    point_keys = ("dp_x", "dp_y", "dp_I", "dp_U", "dp_V")
    for ann in db["annotations"]:
        stats["annotations"] += 1
        if "dp_masks" not in ann:
            continue
        stats["dp_annotations"] += 1
        aid = ann.get("id", "?")
        if ann.get("image_id") not in images:
            err(f"ann {aid}: image_id {ann.get('image_id')} not in images")
        if ann.get("iscrowd"):
            stats["crowd_with_dp"] += 1

        missing = [k for k in point_keys if k not in ann]
        if missing:
            err(f"ann {aid}: dp_masks present but {missing} missing")
            continue
        lens = {k: len(ann[k]) for k in point_keys}
        if len(set(lens.values())) != 1:
            err(f"ann {aid}: ragged dp point lists {lens}")
            continue
        npts = lens["dp_x"]
        if npts > 196:
            stats["over_196_points"] += 1
        I = np.asarray(ann["dp_I"], np.float64)
        if npts and not ((I >= 1) & (I <= 24)).all():
            warn(f"ann {aid}: dp_I outside 1..24: {sorted(set(I) - set(range(1, 25)))[:5]}")
        for k, lo, hi in (("dp_x", 0, 256), ("dp_y", 0, 256),
                          ("dp_U", 0, 1), ("dp_V", 0, 1)):
            v = np.asarray(ann[k], np.float64)
            if npts and ((v < lo) | (v > hi)).any():
                warn(f"ann {aid}: {k} outside [{lo},{hi}]: "
                     f"[{v.min():.3f}, {v.max():.3f}]")

        bbox = ann.get("bbox")
        if not bbox or len(bbox) != 4 or bbox[2] <= 0 or bbox[3] <= 0:
            warn(f"ann {aid}: degenerate bbox {bbox}")
        kp = ann.get("keypoints")
        if not kp:
            stats["no_keypoints"] += 1
        elif len(kp) != 51:
            err(f"ann {aid}: keypoints length {len(kp)} != 51")

        masks = ann["dp_masks"]
        if not isinstance(masks, list) or len(masks) != 14:
            err(f"ann {aid}: dp_masks is not a 14-entry list")
            continue
        for i, rle in enumerate(masks):
            if not rle:
                stats["rle_empty_slots"] += 1
                continue
            counts = rle.get("counts") if isinstance(rle, dict) else None
            if counts is None or "size" not in rle:
                err(f"ann {aid}: dp_masks[{i}] has no counts/size")
                continue
            variant = ("rle_compressed" if isinstance(counts, (str, bytes))
                       else "rle_uncompressed")
            stats[variant] += 1
            if list(rle["size"]) != [256, 256]:
                warn(f"ann {aid}: dp_masks[{i}] size {rle['size']} != [256, 256]")
            try:
                m = decode_rle(rle)
                if m.shape != tuple(rle["size"]):
                    err(f"ann {aid}: dp_masks[{i}] decoded shape {m.shape}")
            except Exception as e:
                err(f"ann {aid}: dp_masks[{i}] decode failed: {type(e).__name__}: {e}")

    return {"ok": not errors, "errors": errors, "warnings": warnings, "stats": stats}
