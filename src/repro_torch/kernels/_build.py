"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Every ``csrc/*.cu`` under ``repro_torch/kernels`` compiles to its own
shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/repro_torch_kernels/<name>-<hash>.so <src>

on first use, all sources at once (one ``nvcc`` process each, started
together), under a process-wide lock, so two threads that launch their
first kernel together (a client's ``submit`` and the engine's serve
loop) never race one build.  The library name carries a hash of the
source, so an edited source never loads a stale build.  ``build/`` sits
at the root of the checkout and is git-ignored.  A failed build raises
with nvcc's stderr; there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LOCK = threading.RLock()


def sources() -> dict[str, Path]:
    """Kernel name (the source's stem) -> ``.cu`` path."""
    return {p.stem: p for p in sorted(KERNELS_DIR.glob("*/csrc/*.cu"))}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the port's CUDA kernels build "
                           "only where the CUDA toolkit is installed")
    return nvcc


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, in parallel; returns
    name -> library path.  ptxas' resource report (``-Xptxas -v``) is kept
    beside each library as ``<lib>.log``."""
    with _LOCK:
        return _build_all()


def _build_all() -> dict[str, Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {name: _target(src) for name, src in sources().items()}
    procs = {}
    for name, src in sources().items():
        if libs[name].exists():
            continue
        tmp = libs[name].with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors = []
    for name, (tmp, proc) in procs.items():
        out, err = proc.communicate()
        libs[name].with_suffix(".so.log").write_text(out + err)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name} "
                          f"(exit {proc.returncode}):\n{err}")
            continue
        os.replace(tmp, libs[name])
    if errors:
        raise RuntimeError("\n".join(errors))
    return libs


@functools.cache
def _load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build_all()[name]))


def load_library(name: str) -> ctypes.CDLL:
    """The built library of kernel source ``name`` (building on first
    use; the first load happens once, under the build lock)."""
    with _LOCK:
        return _load(name)
