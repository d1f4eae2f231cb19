"""Readings of the comparison that decides `correct`, for setting a
cell's limits: the port on many seeds, the control (the reference put in
the port's place, a precision below the cell's) and the planted faults on
a few, at the cell's own sizes, each run with a short window, all in one
process.

    python3 port_bench/calibrate.py --workload w48-serve-bf16-b256 --seconds 3 \\
        --seeds 11,12,13 --controls 21,22,23 --control fp8 --faults answer,half --fault-seeds 31,32,33

Prints one JSON line per run: what ran, its seed and its readings.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def ints(text: str) -> list:
    return [int(x) for x in text.split(",") if x]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--seeds", type=ints, default=[])
    parser.add_argument("--control", default=None, help="the control's precision: tf32 or fp8")
    parser.add_argument("--controls", type=ints, default=[])
    parser.add_argument("--faults", default="")
    parser.add_argument("--fault-seeds", type=ints, default=[])
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "port_bench"))

    import torch

    import run
    from port_bench.harness import spec
    from port_bench.harness.faults import FAULTS

    device = torch.device("cuda", 0)
    kind = "serve" if spec.load_cell(args.workload).traffic["kind"] == "serve_closed" else "train"
    plan = [("port", s, {}) for s in args.seeds]
    plan += [(f"control:{args.control}", s, {"server": args.control}) for s in args.controls]
    for fault in filter(None, args.faults.split(",")):
        plan += [(f"fault:{fault}", s, {"wrap": FAULTS[kind][fault]}) for s in args.fault_seeds]
    for what, seed, kw in plan:
        t0 = time.perf_counter()
        out = run.execute(args.workload, seed, args.seconds, False, device, **kw)
        r = out["result"]
        print(json.dumps({"workload": args.workload, "run": what, "seed": seed, "correct": r["correct"],
                          "readings": out["readings"],
                          "e2e": out["e2e"], "notes": out["notes"], "s": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
