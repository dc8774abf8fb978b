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
module is in training mode, as in PyTorch.  Gradients come from
``loss.backward()``; the Torch-style facade (``backward``,
``get_parameters``, ``scale_w``) is not ported.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..common import default_generator, resolve_device

__all__ = ["Module", "Container"]


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
        # initializer overrides (BigDL: abstractnn/Initializable.scala:23)
        self.weight_initializer = None
        self.bias_initializer = None

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
