"""Checkpoint preflight CLI (port of the JAX package's `cli/port.py`).

Go / no-go a released reference .pt (`danet_model_h36m_itw.pt`,
`danet_model_h36m_dpcoco.pt`, or a SPIN checkpoint with `--regressor hmr`)
against the model it must fill, and write the key -> shape manifest such
a file must carry, before any weights exist:

  python -m danet_densepose2smpl_tpu_torch.cli.port --check ckpt.pt [--cfg cfg.yaml]
  python -m danet_densepose2smpl_tpu_torch.cli.port --manifest expected_keys.json

Exit code 0 = GO (every expected key present at its shape, nothing the
model does not take but the ignorable keys), 1 = NO-GO with the report by
category (`port.preflight_report`). Shape-only: the model is built on the
meta device, and no card is touched; the file is read with
`torch.load(weights_only=True)` on the CPU, as `cli.eval
--torch_checkpoint` reads it (`cli/common.py::read_reference_checkpoint`).
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--check", default=None, metavar="CKPT_PT", help="released .pt to preflight")
    p.add_argument("--manifest", default=None, metavar="OUT_JSON",
                   help="write the expected torch key -> shape manifest")
    p.add_argument("--cfg", default=None, help="YAML config (reference layout)")
    p.add_argument("--regressor", default="danet", choices=["danet", "hmr"])
    p.add_argument("--json", action="store_true", help="emit the full report as JSON instead of text")
    p.add_argument("--limit", type=int, default=12, help="max items printed per report section")
    args = p.parse_args(argv)
    if not args.check and not args.manifest:
        p.error("nothing to do: pass --check ckpt.pt and/or --manifest out.json")

    from danet_densepose2smpl_tpu_torch.cli.common import read_reference_checkpoint
    from danet_densepose2smpl_tpu_torch.config import load_config
    from danet_densepose2smpl_tpu_torch.port import expected_shapes, format_report, preflight_model, preflight_report

    expected = expected_shapes(preflight_model(load_config(args.cfg).danet, args.regressor))
    if args.manifest:
        with open(args.manifest, "w") as f:
            json.dump({k: list(v) for k, v in expected.items()}, f, indent=1, sort_keys=True)
        print(f"wrote {len(expected)} expected torch keys to {args.manifest}")
    if not args.check:
        return 0

    report = preflight_report(read_reference_checkpoint(args.check), expected)
    print(json.dumps(report, indent=1) if args.json else format_report(report, limit=args.limit))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
