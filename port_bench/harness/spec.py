"""Cells by name: a workload of BENCHMARK.json, its configuration file
(`configs/<config>.json`), its traffic mix (`traffic/<traffic>.json`) and
its limits (`limits/<workload>.json`), and the two `Config`s built from
them, the port's and the reference's.

A configuration file holds the reference YAML's sections as JSON with
lower-case keys: `danet` (DaNetConfig's fields, `refinement` nested) and
`solver`. A traffic mix may override `danet` fields of the operating point
it runs (`compute_dtype`, `part_head_chunks`)."""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
BENCHMARK_JSON = ROOT / "BENCHMARK.json"


@dataclass
class Cell:
    workload: dict
    config: dict      # the configuration file
    traffic: dict     # the traffic file
    limits: dict      # {number: limit}
    end_to_end: list  # BENCHMARK.json's end-to-end metrics that this cell reports
    per_layer: list   # and its per-layer metrics

    @property
    def name(self) -> str:
        return self.workload["name"]


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reported_in(metric: dict, workload: str, end_to_end_names) -> bool:
    """Whether `metric` is reported in `workload`: the cells its `workloads`
    lists; without the key, every cell that reports the end-to-end metric
    it moves (all cells, for an end-to-end metric without the key)."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in end_to_end_names
    return True


def load_cell(workload: str, benchmark: dict | None = None) -> Cell:
    """The cell named `workload`; raises KeyError for an unknown name and
    FileNotFoundError for a missing file."""
    benchmark = benchmark if benchmark is not None else read_json(BENCHMARK_JSON)
    cells = {w["name"]: w for w in benchmark["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload '{workload}' in BENCHMARK.json (have: {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in benchmark["configs"]}
    config = read_json(ROOT / configs[w["config"]]["file"])
    traffic = read_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    limits = read_json(BENCH_DIR / "limits" / f"{workload}.json")
    e2e = [m for m in benchmark["end_to_end"] if reported_in(m, workload, ())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in benchmark["per_layer"] if reported_in(m, workload, names)]
    return Cell(w, config, traffic, limits, e2e, per_layer)


def danet_fields(config: dict, traffic: dict) -> dict:
    """DaNetConfig keyword arguments of the configuration with the traffic
    mix's operating point over it (`refinement` still a dict)."""
    fields = dict(config["danet"])
    fields.update(traffic.get("danet", {}))
    return fields


def build_config(module, config: dict, traffic: dict, overrides: dict | None = None):
    """A `Config` of `module` (the port's `config` module or the
    reference's copy) from a configuration file and a traffic mix;
    `overrides` replaces DaNetConfig fields (the CPU tests' small sizes)."""
    fields = danet_fields(config, traffic)
    fields.update(overrides or {})
    refinement = module.RefinementConfig(**fields.pop("refinement", {}))
    danet = module.DaNetConfig(refinement=refinement, **fields)
    solver = config.get("solver", {})
    solver = module.SolverConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in solver.items()})
    return module.Config(solver=solver, danet=danet)
