"""BENCHMARK.json against the files of the harness: every cell resolves to
its configuration, traffic mix, limits and metric readers, and every
per-layer metric is reported where the end-to-end metric it moves is."""

import json
import re

import pytest

from port_bench.harness import spec

BENCH = json.loads(spec.BENCHMARK_JSON.read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(workload):
    cell = spec.load_cell(workload)
    assert cell.traffic["kind"] in ("serve_closed", "train_steps")
    assert cell.limits, "a cell without limits is never correct"
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert (spec.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_cells_report_what_it_moves(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    for workload in m["workloads"]:
        names = {e["name"] for e in spec.load_cell(workload).end_to_end}
        assert m["moves"] in names


def test_names_units_and_files():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]) and m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert c["file"].startswith("port_bench/") and (spec.ROOT / c["file"]).is_file()
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
