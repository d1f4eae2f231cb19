"""Nothing that port_bench runs loads JAX or the JAX package: the
harness's sources import neither, and a whole run (at a CPU size) leaves
neither in `sys.modules`, compared by whole top-level names (the port's
name begins with the JAX package's)."""

import ast
import subprocess
import sys

from port_bench.harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "danet_densepose2smpl_tpu", "bench", "chip_smoke"}


def test_sources_import_neither():
    for path in spec.BENCH_DIR.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, f"{path}: imports {n}"


def test_a_run_loads_neither():
    code = f"""
import sys, torch
sys.path[:0] = [{str(spec.ROOT)!r}, {str(spec.BENCH_DIR)!r}]
import run
from port_bench.tests.tiny import tiny, SEED
run.execute("r50-serve-fp32-b64", SEED, 0.5, True, torch.device("cpu"), tiny("r50-serve-fp32-b64"))
top = {{m.split(".")[0] for m in sys.modules}}
print(sorted(top & set({sorted(FORBIDDEN)!r})))
assert "danet_densepose2smpl_tpu_torch" in top
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
