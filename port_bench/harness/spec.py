"""Cells by name: a workload of BENCHMARK.json, its configuration file
(`configs/<config>.json`), its traffic mix (`traffic/<traffic>.json`), its
limits (`limits/<workload>.json`) and its model family
(`families/<family>.py`, the configuration file's `"family"`, `danet`
where it has none), which builds the port's and the reference's
configurations from the other files (`families/__init__.py`)."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
BENCHMARK_JSON = ROOT / "BENCHMARK.json"
FAMILIES_DIR = BENCH_DIR / "families"
LIMITS_DIR = BENCH_DIR / "limits"
DEFAULT_FAMILY = "danet"


@dataclass
class Cell:
    workload: dict
    config: dict      # the configuration file
    traffic: dict     # the traffic file
    limits: dict      # {number: limit}
    end_to_end: list  # BENCHMARK.json's end-to-end metrics that this cell reports
    per_layer: list   # and its per-layer metrics
    family: object    # the model family's module (families/__init__.py)

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


def load_family(name: str):
    """The module `FAMILIES_DIR/<name>.py`, loaded from its file; raises
    FileNotFoundError, naming the families there, where it is missing."""
    path = FAMILIES_DIR / f"{name}.py"
    if not path.is_file():
        have = sorted(p.name for p in FAMILIES_DIR.glob("*.py") if not p.name.startswith("_"))
        raise FileNotFoundError(f"unknown model family '{name}': no {path.name} under {FAMILIES_DIR} "
                                f"(have: {have})")
    loaded = importlib.util.spec_from_file_location(f"port_bench_family_{name}", path)
    module = importlib.util.module_from_spec(loaded)
    loaded.loader.exec_module(module)
    return module


def load_cell(workload: str, benchmark: dict | None = None) -> Cell:
    """The cell named `workload`; raises KeyError for an unknown name,
    FileNotFoundError for a missing file or an unknown family, and
    ValueError for a family without a harness for the traffic's kind."""
    benchmark = benchmark if benchmark is not None else read_json(BENCHMARK_JSON)
    cells = {w["name"]: w for w in benchmark["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload '{workload}' in BENCHMARK.json (have: {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in benchmark["configs"]}
    config = read_json(ROOT / configs[w["config"]]["file"])
    traffic = read_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    limits = read_json(LIMITS_DIR / f"{workload}.json")
    name = config.get("family", DEFAULT_FAMILY)
    family = load_family(name)
    if traffic["kind"] not in family.kinds:
        raise ValueError(f"model family '{name}' has no harness for traffic kind '{traffic['kind']}' of "
                         f"{w['traffic']} (its kinds: {list(family.kinds)})")
    e2e = [m for m in benchmark["end_to_end"] if reported_in(m, workload, ())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in benchmark["per_layer"] if reported_in(m, workload, names)]
    return Cell(w, config, traffic, limits, e2e, per_layer, family)


def build_config(module, config: dict, traffic: dict, overrides: dict | None = None):
    """DaNet's `Config` of `module` (`families/danet.py::build_config`), by
    the name that callers outside the harness use."""
    from port_bench.families.danet import build_config as danet_config

    return danet_config(module, config, traffic, overrides)
