"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 port_bench/run.py --workload w48-serve-bf16-b256 --seed 7 --seconds 30 --trace 0

Runs the cell's loop on the card for `--seconds` after its set-up, checks
what the timed path produced against the plain reference under
`port_bench/reference/`, and prints one JSON line last on standard
output: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics with `--trace 0`, its per-layer metrics with
`--trace 1`), `device`, with `--trace 1` `breakdown`, and last `checks`:
each number compared beside its limit, which also close standard error.
Exits non-zero, printing no result, without a card, or if JAX or the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "danet_densepose2smpl_tpu")


def cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = BENCH_DIR / ".cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def read_metric(name: str, ctx: dict):
    """The value of per-layer metric `name` from `metrics/<name>.py`'s
    `read(ctx)`, or None where it finds nothing to read."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    loaded = importlib.util.spec_from_file_location(f"port_bench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(loaded)
    loaded.loader.exec_module(module)
    return module.read(ctx)


def checks_of(readings: dict, limits: dict) -> dict:
    """{number: {'value', 'limit'}} for every number the cell's limits
    file compares; a number without a reading fails."""
    return {k: {"value": readings.get(k, float("inf")), "limit": limits[k]} for k in sorted(limits)}


def execute(workload: str, seed: int, seconds: float, trace: bool, device, overrides=None, limits=None,
            **kw) -> dict:
    """One run of `workload` on `device`: the result line's dict.
    `overrides` ({<family>: {...}, 'traffic': {...}}, the family's fields
    under its name, `danet` for DaNet) shrinks a cell for the CPU tests,
    and `limits` replaces the cell's limits there."""
    import torch

    from port_bench.harness import serve, spec, train

    cell = spec.load_cell(workload)
    overrides = overrides or {}
    cell.traffic.update(overrides.get("traffic", {}))
    runner = {"serve_closed": serve.run, "train_steps": train.run}[cell.traffic["kind"]]
    family = cell.config.get("family", spec.DEFAULT_FAMILY)
    out = runner(cell, seed, seconds, trace, device, T_START, overrides=overrides.get(family), **kw)

    checks = checks_of(out["readings"], cell.limits if limits is None else limits)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    e2e = {"setup_s": out["setup_s"], **out["end_to_end"]}
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = read_metric(m["name"], out["ctx"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    on_card = device.type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out.get("failed", 0) + (0 if correct else 1), "metrics": metrics, "device": dev}
    sl = out["ctx"].get("slice")
    if trace and sl is not None:
        dev["busy_s"] = sl.busy_s()
        dev["window_s"] = sl.window_s
        result["breakdown"] = {"device_ops": sl.device_ops(), "idle_gaps": sl.idle_gaps()}
    result["checks"] = checks
    return {"result": result, "notes": out["notes"], "e2e": e2e, "readings": out["readings"]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cache_dirs()
    sys.path.insert(0, str(ROOT))

    import torch

    from port_bench.harness.yardstick import power_limit_w

    cells = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
    chips = next((w["chips"] for w in cells if w["name"] == args.workload), 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    run = execute(args.workload, args.seed, args.seconds, bool(args.trace), device)
    found = forbidden_modules()
    if found:
        print(f"port_bench: JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    result = run["result"]
    result["device"]["power_limit_w"] = power_limit_w()
    for line in run["notes"]:
        print(f"port_bench: {line}")
    print(f"port_bench: end to end {json.dumps(run['e2e'])}; card {result['device']['kind']}, power limit "
          f"{result['device']['power_limit_w']} W")
    checks = result.pop("checks")
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
