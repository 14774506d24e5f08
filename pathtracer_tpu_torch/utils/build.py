"""Build of the CUDA sources under ``csrc/`` into one shared library.

At first use ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a``, one
process per source, all started together, and links the objects into
``build/pathtracer_tpu_torch/libpathtracer_tpu_torch-<hash>.so`` at the repo
root, where the hash covers the source and header bytes and the flags: an
edited source never loads a stale library.  The library has a plain C interface
and is loaded with ctypes; each wrapper declares the ``argtypes`` of the
functions it calls.  Nothing is downloaded and nothing prebuilt is kept in
the repository.  Importing this module needs no ``nvcc``.

The checked build (``checked=True``) compiles the same sources with
``-DPTK_CHECKED`` into ``libpathtracer_tpu_torch_checked-<hash>.so``: every
array index of the kernels is bounds-checked (``csrc/common.cuh::PTK_IX``),
and an index out of range prints the kernel, the array and the index and
traps.  It has the same C interface, and gives the same bits.
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
LIB_NAME = "libpathtracer_tpu_torch"

# --fmad=false: no multiply-add contraction, so the kernels round every
# operation as the plain PyTorch versions do (see csrc/trace_kernel.cu).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v")
CHECKED_FLAGS = ("-DPTK_CHECKED",)

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


def _sources(csrc: Path, names):
    sources = (sorted(csrc.glob("*.cu")) if names is None
               else [csrc / n for n in names])
    if not sources:
        raise RuntimeError(f"no CUDA sources under {csrc}")
    return sources


def _flags(checked: bool):
    return NVCC_FLAGS + CHECKED_FLAGS if checked else NVCC_FLAGS


def library_path(csrc: Path = CSRC, name: str = LIB_NAME,
                 sources=None, checked: bool = False) -> Path:
    digest = hashlib.sha256()
    for src in sorted([*_sources(csrc, sources), *csrc.glob("*.cuh")]):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(_flags(checked)).encode())
    name = f"{name}_checked" if checked else name
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_library(csrc: Path = CSRC, name: str = LIB_NAME,
                  sources=None, checked: bool = False) -> Build:
    """Compile the sources unless a library for their hash exists: one
    ``nvcc -c`` per source, run in parallel, then one link.  By default
    every ``.cu`` of this package's ``csrc/``; ``csrc``, ``name`` and
    ``sources`` (file names) build another set, such as an older
    checkout's kernels for an A/B; ``checked`` builds the bounds-checked
    library.  A failed ``nvcc`` raises ``RuntimeError`` with its
    output."""
    csrc = Path(csrc)
    path = library_path(csrc, name, sources, checked)
    if path.exists():
        return Build(path, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in _sources(csrc, sources):
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *_flags(checked), "-c", str(src), "-o", obj]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        failed = None
        for cmd, _, proc in jobs:
            out = proc.communicate()[0]
            log.append(out)
            if proc.returncode != 0 and failed is None:
                failed = (proc.returncode, cmd, out)
        if failed is not None:
            code, cmd, out = failed
            raise RuntimeError(f"nvcc failed ({code}): {' '.join(cmd)}\n{out}")
        fd, lib = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, "-shared", "-o", lib, *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(lib)
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(lib, path)
    return Build(path, time.perf_counter() - t0, "".join(log))


def error_string(lib: ctypes.CDLL, code: int) -> str:
    """The CUDA runtime's message for an error code a kernel entry point
    returned."""
    lib.pt_error_string.argtypes = [ctypes.c_int]
    lib.pt_error_string.restype = ctypes.c_char_p
    return lib.pt_error_string(code).decode()


def load_library(csrc: Path = CSRC, name: str = LIB_NAME,
                 sources=None, checked: bool = False) -> ctypes.CDLL:
    """The kernel library (by default this package's; the arguments as in
    ``build_library``), built if needed and loaded once per process: the
    sources are hashed at the first call only, since the wrappers call this
    on every launch (reading and hashing them took milliseconds a call on a
    machine with the card, more than a cluster-kernel launch).  The
    wrappers call it with the defaults; to run them on the checked library,
    replace ``load_library`` with ``functools.partial(load_library,
    checked=True)``."""
    key = (str(csrc), name, None if sources is None else tuple(sources),
           checked)
    lib = _LOADED.get(key)
    if lib is None:
        lib = _LOADED[key] = ctypes.CDLL(
            str(build_library(csrc, name, sources, checked).path))
    return lib


def check_tree_depth(lib: ctypes.CDLL, depth: int, what: str) -> None:
    """Raises ValueError when a box tree of ``depth`` is deeper than the
    cluster and beam kernels' stacks (``pt_tree_stack_size``)."""
    lib.pt_tree_stack_size.restype = ctypes.c_int
    limit = lib.pt_tree_stack_size()
    if depth > limit:
        raise ValueError(f"{what}: a box tree of depth {depth} is deeper "
                         f"than the kernels' stack of {limit} entries")
