"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``repro_torch/kernels/*/csrc/`` has a plain C
entry point.  It is compiled with ``nvcc`` for ``sm_90a`` into a shared
library at first use and loaded with ``ctypes``; nothing includes
PyTorch's headers, so a build takes seconds, not minutes.  Libraries land
in ``repro_torch/_build/`` (listed in ``.gitignore``), named by a hash of
their sources (the ``.cu`` and the ``.cuh`` headers beside it) and
flags, so an edited source is rebuilt and a concurrent
builder never sees a half-written file (each writes a private temporary
and renames it into place).

Nothing here runs when the module is imported: the CPU tests import
every module of the port on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence, Tuple

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> source path, relative to the package directory
SOURCES: Dict[str, str] = {
    "feature_attention": os.path.join(
        "kernels", "feature_attention", "csrc", "feature_attention.cu"),
    "linear_scan": os.path.join(
        "kernels", "linear_scan", "csrc", "linear_scan.cu"),
    "selective_scan": os.path.join(
        "kernels", "linear_scan", "csrc", "selective_scan.cu"),
    "flash_attention": os.path.join(
        "kernels", "flash_attention", "csrc", "flash_attention.cu"),
}

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}
# name -> (seconds, compiler log) of the builds this process ran
BUILD_LOG: Dict[str, Tuple[float, str]] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc`` as PyTorch locates the
    toolkit, else the first ``nvcc`` on ``PATH``."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built from source "
            "at first use and need the CUDA toolkit (set CUDA_HOME)")
    return found


def library_path(name: str) -> str:
    """The library's path, named by a hash of the flags, its source and
    the headers (``*.cuh``) beside the source, which it may include."""
    src = os.path.join(PKG_DIR, SOURCES[name])
    csrc = os.path.dirname(src)
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + sorted(os.path.join(csrc, f)
                               for f in os.listdir(csrc)
                               if f.endswith(".cuh")):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str) -> Tuple[subprocess.Popen, str, str, float]:
    out = library_path(name)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(PKG_DIR, SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, proc: subprocess.Popen, tmp: str, out: str,
            t0: float) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"nvcc failed to build kernel {name!r} "
            f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    BUILD_LOG[name] = (time.perf_counter() - t0, log)


def build_all(names: Sequence[str] = ()) -> Dict[str, str]:
    """Build every listed kernel (default: all) that is not built yet,
    one ``nvcc`` process per source, all started together.  Returns
    name -> library path."""
    names = tuple(names) or tuple(SOURCES)
    os.makedirs(BUILD_DIR, exist_ok=True)
    running = []
    for n in names:
        if not os.path.exists(library_path(n)):
            running.append((n, *_start(n)))
    errors = []
    for n, proc, tmp, out, t0 in running:
        try:
            _finish(n, proc, tmp, out, t0)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: library_path(n) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built first if needed (once per process)."""
    lib = _LOADED.get(name)
    if lib is not None:  # the per-launch path: no lock once loaded
        return lib
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_all([name])[name])
            _LOADED[name] = lib
        return lib
