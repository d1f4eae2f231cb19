"""Build a CUDA source of `csrc/` with nvcc into a shared library with a
plain C interface, loaded with ctypes.

The library goes to `build/kernels/` at the root of the checkout, named by
the hash of its source and flags, so an edited source is rebuilt and an
unchanged one is built once. The compiler's `-Xptxas -v` report
(registers, shared memory, spills per kernel) is kept beside it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return nvcc


def build(source: str, extra_flags: tuple = ()) -> tuple[ctypes.CDLL, str]:
    """Compile `csrc/<source>` (if not built yet) with NVCC_FLAGS plus
    `extra_flags`, and load it.

    Returns the loaded library and the compiler's report."""
    src = CSRC / source
    flags = NVCC_FLAGS + tuple(extra_flags)
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    stem = f"{src.stem}-{digest}"
    lib_path = BUILD_DIR / f"lib{stem}.so"
    log_path = BUILD_DIR / f"{stem}.log"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # compile to a private name, then rename: no concurrent process
        # ever loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [find_nvcc(), *flags, "-o", tmp, str(src)],
                capture_output=True, text=True, check=False,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
            log_path.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ctypes.CDLL(str(lib_path)), log_path.read_text()
