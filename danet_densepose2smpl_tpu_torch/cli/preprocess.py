"""Offline dataset preprocessing CLI: densepose_coco json -> SPIN npz
(port of the JAX package's `cli/preprocess.py`; numpy and json only, no
card needed).

The converter mirrors the reference's `datasets/preprocess/dp_coco.py`
(keep-iff-dp_masks filter, COCO17->GT24 joint placement, 1.2x bbox margin,
kp_coco2smpl synthesis). A schema preflight runs first, validating every
observable assumption that the converter and the train-time DensePose
blobs make (RLE variants, crowd records, point ranges, ragged lists), so
converting a densepose_coco json is one go/no-go command:

  # preflight only (no npz written):
  python -m danet_densepose2smpl_tpu_torch.cli.preprocess \
      --json densepose_coco_2014_train.json --check

  # preflight + convert (refuses to convert on a failed preflight
  # unless --force):
  python -m danet_densepose2smpl_tpu_torch.cli.preprocess \
      --json densepose_coco_2014_train.json --out dp_coco_2014_train.npz \
      --img_prefix train2014

Exit code 0 = GO, 1 = NO-GO (hard schema violations listed).
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--json", required=True, help="densepose_coco_*.json")
    p.add_argument("--out", default=None, help="output npz path (omit with --check)")
    p.add_argument("--img_prefix", default="",
                   help="folder prefix for imgname (reference stores "
                        "'train2014/...' etc)")
    p.add_argument("--check", action="store_true",
                   help="schema preflight only; no npz written")
    p.add_argument("--force", action="store_true",
                   help="convert even when the preflight reports errors")
    args = p.parse_args(argv)

    from danet_densepose2smpl_tpu_torch.data.preprocess import (
        check_dp_coco_json,
        db_coco_extract,
    )

    report = check_dp_coco_json(args.json)
    print(json.dumps(report["stats"], indent=2))
    for w in report["warnings"]:
        print(f"WARN  {w}")
    for e in report["errors"]:
        print(f"ERROR {e}")
    print(("GO" if report["ok"] else "NO-GO")
          + f": {report['stats']['dp_annotations']} dp annotations across "
            f"{report['stats']['images']} images")

    if args.check or args.out is None:
        return 0 if report["ok"] else 1
    if not report["ok"] and not args.force:
        print("refusing to convert on a failed preflight (--force overrides)")
        return 1

    n = db_coco_extract(args.json, args.out, img_prefix=args.img_prefix)
    print(f"wrote {n} samples -> {args.out}")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
