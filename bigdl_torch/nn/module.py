"""Module system: BigDL's AbstractModule on ``torch.nn.Module``.

Counterpart of ``bigdl_tpu/nn/module.py``.  The reference keeps parameters
in pytrees beside a pure ``init/apply`` core because ``jax.jit`` needs pure
functions; PyTorch runs eagerly, so here a module owns its parameters as
``torch.nn.Parameter`` attributes and ``forward`` is the computation.

- A leaf module's ``_init(generator)`` returns its parameters as a dict
  (the reference's param-tree leaf); :meth:`Module.build` registers them
  under the same names and moves the module to its device.
- A :class:`Container` holds its children in order in ``layers``; its
  parameter tree is the list of its children's trees, as in the reference.
- A leaf's ``_init_state()`` returns its non-trained state (BatchNorm's
  running statistics) as a dict; :meth:`Module.build` registers it as
  buffers, so it moves with the module and is saved with it.
- ``PARAM_ROLES`` is kept as a class attribute for the mesh-layout
  assigner that comes with the sharding slice.

Train/eval mode is PyTorch's (``train()``/``eval()``); a freshly built
module is in training mode, as in PyTorch.  ``evaluate()`` with no
arguments also switches to eval mode, as in the reference; with a dataset
and validation methods it scores the model through ``optim.Evaluator``,
and ``predict`` / ``predict_class`` run ``optim.Predictor``
(``bigdl_tpu/nn/module.py:415-433, 570-580``).  Every module has a name
(``set_name`` / ``get_name``), ``<Class>_<n>`` until one is set.
Gradients come from ``loss.backward()``.  ``scale_w`` and ``scale_b``
are the layer-wise gradient scales (``AbstractModule.scala:73``): the
Optimizer multiplies each parameter's gradient, its regularizer term
included, by its module's ``scale_b`` (a parameter named ``bias``) or
``scale_w`` (every other one); ``set_scale_w`` / ``set_scale_b`` pass the
scale down to a container's children.  The eager step reads the scales
every step, so the reference's scale epoch (which rebuilds a compiled
step) has no counterpart.  The rest of the Torch-style facade
(``backward``, ``get_parameters``) is not ported.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional

import torch

from ..common import default_generator, resolve_device

__all__ = ["Module", "Container"]

_uid_counter = itertools.count()


class Module(torch.nn.Module):
    """Base class for all layers (BigDL: AbstractModule)."""

    #: parameter-name -> role for the mesh-layout assigner; None means
    #: unannotated (see bigdl_tpu/nn/module.py)
    PARAM_ROLES = None

    def __init__(self):
        super().__init__()
        #: names of this module's own parameters, in ``_init`` order
        self.param_names: tuple = ()
        #: names of this module's own state buffers, in ``_init_state`` order
        self.state_names: tuple = ()
        self.built = False
        self.name = f"{type(self).__name__}_{next(_uid_counter)}"
        # initializer overrides (BigDL: abstractnn/Initializable.scala:23)
        self.weight_initializer = None
        self.bias_initializer = None
        # layer-wise gradient scales (AbstractModule.scala:73)
        self.scale_w = 1.0
        self.scale_b = 1.0

    def set_scale_w(self, s: float):
        """Layer-wise weight-gradient scale; a container passes it to its
        children (the reference's Container.setScaleW)."""
        self.scale_w = s
        for m in getattr(self, "layers", ()):
            m.set_scale_w(s)
        return self

    def set_scale_b(self, s: float):
        """(AbstractModule.setScaleB; passed down as ``set_scale_w``.)"""
        self.scale_b = s
        for m in getattr(self, "layers", ()):
            m.set_scale_b(s)
        return self

    def _grad_scales(self):
        """The gradient scale of each parameter, in ``parameters()``
        order: its own module's ``scale_b`` for a parameter named
        ``bias``, ``scale_w`` for the rest (the reference's
        ``_grad_scale_tree``).  None when every scale is 1, so the step
        skips the multiply."""
        scales, ones = [], True
        for mod in self.modules():
            for name, _ in mod.named_parameters(recurse=False):
                s = float(mod.scale_b if name == "bias" else mod.scale_w)
                scales.append(s)
                ones = ones and s == 1.0
        return None if ones else scales

    def _init(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """This module's own parameters, drawn from ``generator``."""
        return {}

    def _init_state(self) -> Dict[str, torch.Tensor]:
        """This module's own non-trained state (e.g. running statistics)."""
        return {}

    def set_init_method(self, weight_init=None, bias_init=None):
        """BigDL: Initializable.setInitMethod
        (abstractnn/Initializable.scala:29); takes effect at :meth:`build`."""
        if self.built:
            raise RuntimeError("set_init_method: the module is already "
                               "built; set initializers before build()")
        self.weight_initializer = weight_init
        self.bias_initializer = bias_init
        return self

    def set_name(self, name: str):
        self.name = name
        return self

    def get_name(self) -> str:
        return self.name

    def _device(self, device):
        """``device`` when given, else where the built module lives (an
        unbuilt one goes to the CUDA device, or raises without one)."""
        if device is None and self.built:
            for p in itertools.chain(self.parameters(), self.buffers()):
                return p.device
        return resolve_device(device)

    def evaluate(self, dataset=None, methods=None, batch_size=None,
                 device=None):
        """No arguments: switch to eval mode (Torch semantics).  With a
        dataset and validation methods: score the model over it through
        ``optim.Evaluator`` (the reference's ``model.evaluate(rdd,
        vMethods, batchSize)``, AbstractModule.scala:571), on the device
        the model lives on."""
        if dataset is None:
            self.eval()
            return self
        if not methods:
            raise ValueError("evaluate(dataset, ...) needs validation "
                             "methods, e.g. [Top1Accuracy()]")
        from ..optim.optimizer import Evaluator
        self.eval()
        return Evaluator(self, device=self._device(device)).test(
            dataset, methods, batch_size=batch_size)

    def predict(self, dataset, batch_size: int = 128, device=None):
        """Bulk inference over a DataSet or a list of Samples
        (AbstractModule.predict -> Predictor)."""
        from ..optim.optimizer import Predictor
        self.eval()
        return Predictor(self, batch_size=batch_size,
                         device=self._device(device)).predict(dataset)

    def predict_class(self, dataset, batch_size: int = 128, device=None):
        """(AbstractModule.predictClass): the argmax of :meth:`predict`."""
        from ..optim.optimizer import Predictor
        self.eval()
        return Predictor(self, batch_size=batch_size,
                         device=self._device(device)).predict_class(dataset)

    def _build(self, generator: torch.Generator) -> None:
        params = self._init(generator)
        for name, t in params.items():
            self.register_parameter(name, torch.nn.Parameter(t))
        self.param_names = tuple(params)
        state = self._init_state()
        for name, t in state.items():
            self.register_buffer(name, t)
        self.state_names = tuple(state)
        self.built = True

    def build(self, device=None, generator: Optional[torch.Generator] = None):
        """Materialize parameters on ``device`` (default: the CUDA device;
        raises without one).  Init draws from ``generator`` on the host
        (default: the process-wide one, see ``common.set_seed``), so a seed
        gives the same weights on every device."""
        device = resolve_device(device)
        self._build(generator if generator is not None
                    else default_generator())
        return self.to(device)


class Container(Module):
    """Base for composite modules (BigDL: nn/Container.scala).  Children
    live in ``layers``; the parameter tree is the list of theirs."""

    def __init__(self, *modules: Module):
        super().__init__()
        self.layers = torch.nn.ModuleList(modules)

    def add(self, module: Module):
        """BigDL: Container.add (nn/Container.scala:54)."""
        self.layers.append(module)
        return self

    def _build(self, generator: torch.Generator) -> None:
        for m in self.layers:
            m._build(generator)
        self.built = True
