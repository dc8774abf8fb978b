"""bigdl_torch: the PyTorch/CUDA port of bigdl_tpu.

The package sits beside ``bigdl_tpu`` (the JAX reference, unchanged) and
keeps its layout, module names and parameter trees.  Plain tensor code is
PyTorch; every kernel the reference wrote in Pallas for the TPU becomes a
kernel written by hand for Hopper under ``bigdl_torch/csrc``, built with
``nvcc`` at first use.  Slice 1 serves ``TransformerLM`` through
``InferenceServer`` with flash attention as a CUDA kernel; slice 2 trains
ResNet through ``Optimizer`` with the training BatchNorm and conv-BN
kernels in CUDA; slice 3 trains it data-parallel over the ``Engine``'s
process group, with sync-BN's statistics kernel in CUDA; later slices
train TransformerLM, decode over a KV cache, and add validation,
checkpoints and resume in the reference's file format, then the long-run
half of training: gradient accumulation, remat, layer-wise scales, EMA and
LBFGS, the retry loop with supervision, chaos points and preemption,
asynchronous and remote checkpoints, and summaries (``visualization``);
then the rest of data parallelism (ZeRO, the bucketed wire), the layer
library with the criteria and the recurrent cells, which train the PTB
LSTM language model, and the rest of the zoo with the data half: ViT,
Wide & Deep on the recommendation pipeline, int8 weight quantization
(``quantize``), the text, SequenceFile and standard-dataset loaders, the
DataFrame-style UDFs (``serving``) and estimators (``ml``).

It imports torch and never jax or bigdl_tpu.  Entry points run on the CUDA
device unless the caller passes ``device="cpu"``.
"""

__version__ = "0.3.0"

from .common import (DTypePolicy, default_generator, get_policy,
                     resolve_device, set_policy, set_seed)
from .utils import RNG, Engine, RandomGenerator, T, Table
from . import nn
from . import optim
from . import dataset
from . import models
from . import parallel
from . import quantize as quantization
from .quantize import quantize
from . import serve
from .serve import InferenceServer

__all__ = ["DTypePolicy", "get_policy", "set_policy", "set_seed",
           "default_generator", "resolve_device", "Engine", "Table", "T",
           "RandomGenerator", "RNG", "common", "nn", "optim", "dataset",
           "models", "parallel", "quantization", "quantize", "serve",
           "InferenceServer"]
