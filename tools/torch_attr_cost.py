#!/usr/bin/env python3
"""Time, on the card, what a launch pays to set its kernel's attribute and
ask for the SM count, the host cost of setting them per launch.

    python3 tools/torch_attr_cost.py

B5, B6 ``"tc"`` and B7 call ``hopper::allow_smem`` (``cudaFuncSetAttribute``
of the dynamic shared memory) and ``hopper::sm_count`` (``cudaGetDevice``,
``cudaDeviceGetAttribute``) on every launch (``bigdl_torch/csrc/
hopper.cuh``).  This compiles a few lines that include that header with
``nvcc`` (the port's flags, into ``bigdl_torch/_build/``) and times, on
the host clock in C++, 100000 calls of each against 100000 launches of
an empty kernel on one stream.  Prints one JSON line of nanoseconds per
call, with the calls a step makes (the LM training step: 8 B6 and 8 B7
calls, 24 attributes and 16 SM counts; the ResNet-50 step: 33 B5, 33 of
each), then the card's name and power limit.  Exits 2 without CUDA.
"""

import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from bigdl_torch.utils import cuda_build  # noqa: E402

SOURCE = r"""
#include <chrono>
#include "hopper.cuh"

__global__ void empty_kernel() {}

template <typename F>
static double mean_ns(int n, F f) {
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < n; ++i) f();
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::nano>(t1 - t0).count() / n;
}

// what = 0: allow_smem (100 KiB), 1: sm_count, 2: an empty launch; the
// mean ns of n calls after n warm-up calls, or -1 on a CUDA error
extern "C" double bigdl_attr_cost(int what, int n) {
  int sink = 0;
  auto call = [&] {
    if (what == 0)
      sink += hopper::allow_smem(empty_kernel, 100 * 1024);
    else if (what == 1)
      sink += hopper::sm_count();
    else
      empty_kernel<<<1, 32>>>();
  };
  mean_ns(n, call);
  const double ns = mean_ns(n, call);
  cudaDeviceSynchronize();
  if (cudaGetLastError() != cudaSuccess || (what == 0 && sink != 0))
    return -1.0;
  return ns;
}
"""

CALLS = 100000


def main():
    if not torch.cuda.is_available():
        print("torch_attr_cost: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(cuda_build.BUILD_DIR, "attr_cost.cu")
    lib_path = os.path.join(cuda_build.BUILD_DIR, "libattr_cost.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                    "-I", cuda_build.CSRC_DIR, "-o", lib_path, src],
                   check=True, capture_output=True)
    torch.cuda.init()
    fn = ctypes.CDLL(lib_path).bigdl_attr_cost
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_double
    attr_ns, sm_ns, launch_ns = (fn(w, CALLS) for w in range(3))
    if min(attr_ns, sm_ns, launch_ns) < 0:
        print("torch_attr_cost: a CUDA call failed", file=sys.stderr)
        return 1
    print(json.dumps({
        "calls": CALLS, "allow_smem_ns": attr_ns, "sm_count_ns": sm_ns,
        "empty_launch_ns": launch_ns,
        "lm_step_us": (24 * attr_ns + 16 * sm_ns) / 1e3,
        "resnet_step_us": 33 * (attr_ns + sm_ns) / 1e3}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
