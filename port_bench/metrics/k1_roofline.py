"""k1_roofline: K1's bound from the reference's shapes of one request
(`harness/yardstick.py::k1_bound_s`) over K1's device time per request in
the profiled slice (the kernels whose names `k1_kernels.json` lists), in
%. Nothing where the slice ran no such kernel."""

import json
from pathlib import Path

from port_bench.harness.yardstick import k1_bound_s

PATTERNS = json.loads((Path(__file__).resolve().parent / "k1_kernels.json").read_text())["patterns"]


def read(ctx: dict):
    sl = ctx.get("slice")
    if ctx.get("kind") != "serve" or sl is None or not ctx.get("k1_call"):
        return None
    seconds = sl.op_seconds(PATTERNS)
    if seconds <= 0:
        return None
    bound, _ = k1_bound_s(tuple(ctx["k1_call"]), ctx["dtype"])
    return 100.0 * bound / (seconds / sl.items)
