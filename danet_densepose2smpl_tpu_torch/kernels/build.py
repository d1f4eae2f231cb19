"""Build a source of `csrc/` into a shared library with a plain C
interface, loaded with ctypes: a CUDA source with nvcc (`build`), a C++
one with the host compiler (`build_host`: the RLE codec).

CUDA libraries go to `build/kernels/` at the root of the checkout, host
ones to `build/native/`, named by the hash of the source and flags, so an
edited source is rebuilt and an unchanged one is built once. The
compiler's output (for nvcc its `-Xptxas -v` report: registers, shared
memory, spills per kernel) is kept beside the library. A failed build
raises.
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
HOST_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
HOST_FLAGS = ("-O2", "-shared", "-fPIC")
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


def _compile(src: Path, command: list, flags: tuple, out_dir: Path) -> tuple[ctypes.CDLL, str]:
    """Compile `src` with `command + flags -o <lib> src` into `out_dir` if
    that library is not there yet, and load it: (library, compiler
    output)."""
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    stem = f"{src.stem}-{digest}"
    lib_path = out_dir / f"lib{stem}.so"
    log_path = out_dir / f"{stem}.log"
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        # compile to a private name, then rename: no concurrent process
        # ever loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        try:
            try:
                proc = subprocess.run([*command, *flags, "-o", tmp, str(src)],
                                      capture_output=True, text=True, check=False)
            except OSError as e:
                raise RuntimeError(f"{command[0]} could not run on {src}: {e}") from e
            if proc.returncode != 0:
                raise RuntimeError(f"{command[0]} failed on {src}:\n{proc.stdout}{proc.stderr}")
            log_path.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ctypes.CDLL(str(lib_path)), log_path.read_text()


def build(source: str, extra_flags: tuple = ()) -> tuple[ctypes.CDLL, str]:
    """Compile `csrc/<source>` (if not built yet) with NVCC_FLAGS plus
    `extra_flags`, and load it.

    Returns the loaded library and the compiler's report."""
    return _compile(CSRC / source, [find_nvcc()], NVCC_FLAGS + tuple(extra_flags), BUILD_DIR)


def build_host(source: str, compiler: str | None = None) -> ctypes.CDLL:
    """Compile the C++ source `csrc/<source>` (if not built yet) with
    `compiler` (default: $CXX, else g++) and HOST_FLAGS into
    `build/native/`, and load it."""
    compiler = compiler or os.environ.get("CXX") or "g++"
    return _compile(CSRC / source, [compiler], HOST_FLAGS, HOST_BUILD_DIR)[0]
