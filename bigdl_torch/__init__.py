"""bigdl_torch: the PyTorch/CUDA port of bigdl_tpu.

The package sits beside ``bigdl_tpu`` (the JAX reference, unchanged) and
keeps its layout, module names and parameter trees.  Plain tensor code is
PyTorch; every kernel the reference wrote in Pallas for the TPU becomes a
kernel written by hand for Hopper under ``bigdl_torch/csrc``, built with
``nvcc`` at first use.  Slice 1 serves ``TransformerLM`` through
``InferenceServer`` with flash attention as a CUDA kernel; slice 2 trains
ResNet through ``Optimizer`` with the training BatchNorm and conv-BN
kernels in CUDA; slice 3 trains it data-parallel over the ``Engine``'s
process group, with sync-BN's statistics kernel in CUDA.

It imports torch and never jax or bigdl_tpu.  Entry points run on the CUDA
device unless the caller passes ``device="cpu"``.
"""

from .common import (DTypePolicy, default_generator, get_policy,
                     resolve_device, set_policy, set_seed)
from .utils.engine import Engine

__all__ = ["DTypePolicy", "get_policy", "set_policy", "set_seed",
           "default_generator", "resolve_device", "Engine"]
