"""Build the port's CUDA sources into shared libraries at first use.

Each ``bigdl_torch/csrc/<name>.cu`` has a plain C interface and is compiled
by ``nvcc`` for Hopper (``sm_90a``) into ``bigdl_torch/_build/``, a
directory git ignores, then loaded with ``ctypes``.  The library's file
name carries a hash of its source, of every shared header
(``csrc/*.cuh``) and of the flags, so an edited source or header is rebuilt
and a built one is reused.  Nothing here runs at import: a kernel's wrapper
calls :func:`load` when it first launches, and ``chip_smoke.py`` calls
:func:`build` for every source at once (one ``nvcc`` per source, all
started together).

The host library (:data:`HOST_SOURCES` in ``bigdl_torch/csrc/host/``:
the CRC32C, the record codec, the shard prefetcher and the host batch
kernels, linked into one shared library) is built the same way by the host
C++ compiler (``$CXX``, else ``g++``, which ``nvcc`` needs too), keyed by a
hash of its sources, the host headers and the flags (:func:`build_host`,
:func:`load_host`).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence

__all__ = ["SOURCES", "HOST_SOURCES", "BUILD_DIR", "build", "load",
           "source_path", "build_host", "load_host"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

#: every CUDA source of the port, by library name
SOURCES = ("flash_attention", "flash_attention_bwd", "batchnorm",
           "matmul_stats", "decode_attention")

#: every host C++ source of the port, linked into its one host library
HOST_SOURCES = ("crc32c", "recordio", "prefetch", "hostops")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

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
    digest = hashlib.sha256()
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    for path in [source_path(name)] + headers:
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
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


def host_source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, "host", name + ".cc")


def _cxx() -> str:
    found = os.environ.get("CXX") or shutil.which("g++") or \
        shutil.which("c++")
    if not found:
        raise RuntimeError("no host C++ compiler (set CXX or put g++ on "
                           "PATH)")
    return found


def _host_library_path() -> str:
    digest = hashlib.sha256()
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "host", "*.h")))
    for path in [host_source_path(n) for n in HOST_SOURCES] + headers:
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libbigdl_torch_host-{digest.hexdigest()[:16]}.so")


def build_host() -> str:
    """Compile :data:`HOST_SOURCES` into the host library with the host
    C++ compiler unless it exists; returns the library's path.  Raises if
    the compiler is missing or fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = _host_library_path()
    if os.path.exists(out):
        return out
    tmp = f"{out}.{os.getpid()}.tmp"
    srcs = [host_source_path(n) for n in HOST_SOURCES]
    proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", tmp, *srcs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"host library ({', '.join(srcs)}) failed to "
                           f"build:\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: no half-written library
    return out


def load_host() -> ctypes.CDLL:
    """The loaded host library, built on first use."""
    key = "host/"
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            lib = _loaded[key] = ctypes.CDLL(build_host())
        return lib
