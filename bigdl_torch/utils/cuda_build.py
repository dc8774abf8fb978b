"""Build the port's CUDA sources into shared libraries at first use.

Each ``bigdl_torch/csrc/<name>.cu`` has a plain C interface and is compiled
by ``nvcc`` for Hopper (``sm_90a``) into ``bigdl_torch/_build/``, a
directory git ignores, then loaded with ``ctypes``.  The library's file
name carries a hash of its source and flags, so an edited source is rebuilt
and a built one is reused.  Nothing here runs at import: a kernel's wrapper
calls :func:`load` when it first launches, and ``chip_smoke.py`` calls
:func:`build` for every source at once (one ``nvcc`` per source, all
started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence

__all__ = ["SOURCES", "BUILD_DIR", "build", "load", "source_path"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

#: every CUDA source of the port, by library name
SOURCES = ("flash_attention", "batchnorm", "matmul_stats")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, name + ".cu")


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the CUDA kernels build from source at "
                           "first use")
    return found


def _library_path(name: str) -> str:
    with open(source_path(name), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source that has no library yet, all in
    parallel; returns name -> library path.  The compiler's resource
    report (``-Xptxas -v``) lands beside each library as ``.log``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _library_path(n) for n in names}
    procs = {}
    for name, out in paths.items():
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, source_path(name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        with open(paths[name][:-3] + ".log", "w") as f:
            f.write(log)
        if proc.returncode:
            failed.append(f"{source_path(name)}:\n{log}")
        else:
            os.replace(tmp, paths[name])  # atomic: no half-written library
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(build([name])[name])
        return lib
