"""pytest settings of the benchmark's own tests (`python -m pytest
port_bench/tests`): the repository root and `port_bench/` on the path,
and the `cuda` marker for the tests that need the card."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (HERE.parent, HERE):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU; the test skips itself when torch.cuda.is_available() is false",
    )
