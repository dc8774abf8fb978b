"""Model interop: Caffe, TensorFlow, Torch7, and both native formats.

Counterpart of ``bigdl_tpu/interop/__init__.py``, with the same exports.
Reference: BigDL's ``Module.load/loadTorch/loadCaffe/loadTF`` entry points
(nn/Module.scala:41-73) over utils/caffe/, utils/tf/, utils/TorchFile.scala.
Native formats: the port's own module file (``Module.save`` /
``Module.load``) and the reference's JVM object-stream format
(``interop/bigdl.py`` over the Java-serialization codec
``interop/javaser.py``).  Every loader builds on the device the caller
names (``device=``, the CUDA device by default; it raises without one);
every saver writes the bytes the JAX package's writes for the same model.
"""

from .bigdl import load as load_bigdl, save as save_bigdl
from .caffe import CaffeLoader, CaffePersister, load_caffe, save_caffe
from .tensorflow import TensorflowLoader, TensorflowSaver, load_tf, save_tf
from .torchfile import (load_t7, save_t7, T7Reader, T7Writer,
                        load_torch_module, save_torch_module)

__all__ = ["CaffeLoader", "CaffePersister", "load_caffe", "save_caffe",
           "TensorflowLoader", "TensorflowSaver", "load_tf", "save_tf",
           "load_t7", "save_t7", "T7Reader", "T7Writer",
           "load_torch_module", "save_torch_module",
           "load_bigdl", "save_bigdl"]
