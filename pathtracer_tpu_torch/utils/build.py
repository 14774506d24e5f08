"""Build of the CUDA sources under ``csrc/`` into one shared library.

At first use ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into
``build/pathtracer_tpu_torch/libpathtracer_tpu_torch-<hash>.so`` at the repo
root, where the hash covers the source bytes and the flags: an edited
source never loads a stale library.  The library has a plain C interface
and is loaded with ctypes; each wrapper declares the ``argtypes`` of the
functions it calls.  Nothing is downloaded and nothing prebuilt is kept in
the repository.  Importing this module needs no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pathtracer_tpu_torch"

# --fmad=false: no multiply-add contraction, so the kernels round every
# operation as the plain PyTorch versions do (see csrc/trace_kernel.cu).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v")

_LOADED = {}


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path
    seconds: float   # nvcc wall time; 0.0 when the library was already built
    log: str         # nvcc's output (ptxas registers and shared memory)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels of "
        "pathtracer_tpu_torch are built from source at first use")


def _sources():
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return sources


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libpathtracer_tpu_torch-{digest.hexdigest()[:16]}.so"


def build_library() -> Build:
    """Compile the sources unless a library for their hash exists.  A failed
    ``nvcc`` raises ``RuntimeError`` with its output."""
    path = library_path()
    if path.exists():
        return Build(path, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return Build(path, seconds, proc.stdout + proc.stderr)


def load_library() -> ctypes.CDLL:
    """The kernel library, built if needed and loaded once per process."""
    path = build_library().path
    lib = _LOADED.get(path)
    if lib is None:
        lib = _LOADED[path] = ctypes.CDLL(str(path))
    return lib
