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
- ``PARAM_ROLES`` maps each parameter name to its role for the
  mesh-layout assigner (``parallel/layout.py``); :meth:`param_roles`
  returns it.

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
step) has no counterpart.

The stateful facade (``AbstractModule.scala``; the reference's
``nn/module.py:172-570``): ``forward`` is the module's computation, as in
PyTorch; :meth:`update_output` also keeps it in ``output``.
:meth:`backward`, :meth:`update_grad_input` and
:meth:`acc_grad_parameters` differentiate a recomputed forward on the same
input, as the reference's ``jax.vjp`` does: the buffers (BatchNorm's running
statistics) are put back after it, and a Dropout mask drawn by the last
:meth:`update_output` is drawn again.  Parameter gradients accumulate, scaled
by ``scale_w`` / ``scale_b``, in each parameter's ``.grad``.  The reference's
``parameters()`` (weights and gradients as two lists) is
:meth:`weights_and_grads`: ``parameters()`` keeps PyTorch's meaning, and so
does ``training`` (the reference's ``training()`` is ``train()``).  Leaf
order in :meth:`weights_and_grads`, :meth:`get_parameters` and
:meth:`get_weights_bias` is the reference's: containers in order, each
leaf's parameters by sorted name.

:meth:`save` writes the port's own module file (``"bigdl_torch-module-v1"``
through ``utils/file_io.py``'s framed pickle): the module tree pickled with
every tensor stored beside it as numpy.  :meth:`load` reads it onto a
device; a module file of the JAX package (which pickles its own classes)
raises :class:`ReferenceModuleFile`, naming the way across: build the model
and copy its trees in with ``utils/convert.py`` ``load_reference_tree``.
"""

from __future__ import annotations

import contextlib
import copy
import io
import itertools
import pickle
from typing import Dict, Optional

import numpy as np
import torch

from ..common import default_generator, resolve_device
from ..utils.graph import Node

__all__ = ["Module", "Container", "ReferenceModuleFile"]

MODULE_FORMAT = "bigdl_torch-module-v1"
#: the weights file holds a list of numpy arrays and nothing of either
#: package, so both write and read the same format
WEIGHTS_FORMAT = "bigdl_tpu-weights-v1"


class ReferenceModuleFile(ValueError):
    """A module file written by the JAX package's ``Module.save``."""


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _flat(e)]
    return [x]


def _unflat(like, flat):
    if isinstance(like, (list, tuple)):
        out = []
        for e in like:
            out.append(_unflat(e, flat))
        return out
    return flat.pop(0)


@contextlib.contextmanager
def _buffers_kept(module):
    """The module's buffers as they were, after the block."""
    saved = [(b, b.detach().clone()) for b in module.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, v in saved:
                b.copy_(v)


def _tensor_to_numpy(t: torch.Tensor):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().copy(), "bfloat16"
    return t.numpy().copy(), None


def _tensor_from_numpy(a, dtype):
    t = torch.from_numpy(np.array(a))
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


class _ModulePickler(pickle.Pickler):
    """Pickles a module tree with every tensor out of line: numpy arrays
    in ``tensors``, each pickled as its index."""

    def __init__(self, f, tensors):
        super().__init__(f, pickle.HIGHEST_PROTOCOL)
        self.tensors = tensors

    def persistent_id(self, obj):
        if isinstance(obj, torch.Tensor):
            arr, dtype = _tensor_to_numpy(obj)
            self.tensors.append(arr)
            return ("tensor", len(self.tensors) - 1, dtype,
                    isinstance(obj, torch.nn.Parameter), obj.requires_grad)
        return None


def _module_unpickler():
    from ..utils.recordio import _Unpickler

    class _ModuleUnpickler(_Unpickler):
        def __init__(self, f, tensors):
            super().__init__(f)
            self.tensors = tensors

        def persistent_load(self, pid):
            _, i, dtype, is_param, grad = pid
            t = _tensor_from_numpy(self.tensors[i], dtype)
            return torch.nn.Parameter(t, requires_grad=grad) if is_param \
                else t
    return _ModuleUnpickler


def _read_blob(path: str):
    """A framed pickle read without importing the JAX package."""
    from ..utils import file_io
    from ..utils.recordio import ReferenceGlobalError, loads
    path = file_io._strip_file_scheme(path)
    data = file_io.get_filesystem(path).read_bytes(path)
    try:
        return loads(file_io.unframe_bytes(data, path))
    except ReferenceGlobalError as e:
        raise ReferenceModuleFile(
            f"{path!r} was written by the JAX package ({e}); build the model "
            "in the port and copy the reference's (params, state) trees in "
            "with bigdl_torch.utils.convert.load_reference_tree") from e

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
        # the stateful facade's caches (AbstractModule.scala:62, :67)
        self.output = None
        self.grad_input = None
        self._facade_rng = None

    def param_roles(self):
        """name -> role of this module's own parameters (``PARAM_ROLES``;
        ``"*"`` a wildcard), None where unannotated."""
        return self.PARAM_ROLES

    def __call__(self, *args, **kwargs):
        """The forward; called on a graph node or a list of them, the
        node of this module with those nodes' edges to it (``Graph``'s
        functional API)."""
        if args and isinstance(args[0], (Node, list, tuple)):
            from .graph import _node, is_node_call
            if is_node_call(args, kwargs):
                return _node(self, args[0])
        return super().__call__(*args, **kwargs)

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

    # -- the stateful facade ---------------------------------------------

    def update_output(self, input):
        """The forward, kept in ``output`` (AbstractModule.forward,
        ``:213``): a value, computed without a graph (the backward
        recomputes).  A Dropout generator active here (``dropout_rng``) is
        replayed by the next backward."""
        from .dropout import _rng
        gen = _rng.get()
        self._facade_rng = None if gen is None else (gen.device,
                                                     gen.get_state())
        with torch.no_grad():
            self.output = self(input)
        return self.output

    def _vjp(self, input, grad_output, want_input: bool, want_params: bool):
        """Recompute the forward on ``input`` (buffers put back, the last
        Dropout masks drawn again) and differentiate it against
        ``grad_output``: (grad of the input or None, param grads or
        None)."""
        from .dropout import dropout_rng
        xs = _flat(input)
        if want_input:
            xs = [x.detach().requires_grad_(x.is_floating_point())
                  for x in xs]
        params = [p for _, p in self._leaves()] if want_params else []
        gen = None
        if self._facade_rng is not None:
            device, state = self._facade_rng
            gen = torch.Generator(device=device)
            gen.set_state(state)
        with torch.enable_grad(), _buffers_kept(self), dropout_rng(gen):
            out = self(_unflat(input, list(xs)))
        outs = [o for o in _flat(out) if o.requires_grad]
        gouts = [g for o, g in zip(_flat(out), _flat(grad_output))
                 if o.requires_grad]
        wrt = [x for x in xs if x.requires_grad] + params
        grads = torch.autograd.grad(outs, wrt, gouts, allow_unused=True) \
            if outs and wrt else [None] * len(wrt)
        grads = [torch.zeros_like(w) if g is None else g
                 for w, g in zip(wrt, grads)]
        gx = None
        if want_input:
            it = iter(grads[:len(wrt) - len(params)])
            gx = _unflat(input, [next(it) if x.requires_grad else
                                 torch.zeros_like(x) for x in xs])
        return gx, grads[len(wrt) - len(params):]

    def _accumulate(self, grads) -> None:
        with torch.no_grad():
            for (mod, name), g in zip(self._leaf_names(), grads):
                p = getattr(mod, name)
                s = float(mod.scale_b if name == "bias" else mod.scale_w)
                g = g * s if s != 1.0 else g
                p.grad = g.clone() if p.grad is None else p.grad + g

    def backward(self, input, grad_output):
        """The input's gradient, and each parameter's gradient added to its
        ``.grad`` (AbstractModule.backward, ``:231-236``)."""
        gx, gp = self._vjp(input, grad_output, True, True)
        self._accumulate(gp)
        self.grad_input = gx
        return gx

    def update_grad_input(self, input, grad_output):
        """The input's gradient only (updateGradInput)."""
        gx, _ = self._vjp(input, grad_output, True, False)
        self.grad_input = gx
        return gx

    def acc_grad_parameters(self, input, grad_output):
        """The parameters' gradients only, added to ``.grad``
        (accGradParameters)."""
        _, gp = self._vjp(input, grad_output, False, True)
        self._accumulate(gp)

    def _leaf_names(self):
        """(module, parameter name) in the reference's leaf order."""
        if isinstance(self, Container):
            return [ln for _, m in self.tree_children()
                    for ln in m._leaf_names()]
        return [(self, n) for n in sorted(self.param_names)]

    def _leaves(self):
        return [(n, getattr(m, n)) for m, n in self._leaf_names()]

    def _need_built(self):
        if not self.built:
            raise RuntimeError(f"{type(self).__name__}: build the module "
                               "first (module.build(device))")

    def weights_and_grads(self):
        """(weights, gradients) as two lists in the reference's leaf order
        (the reference's ``parameters()``); a parameter without a gradient
        gives zeros."""
        self._need_built()
        ws = [p for _, p in self._leaves()]
        return ws, [torch.zeros_like(p) if p.grad is None else p.grad
                    for p in ws]

    def get_parameters(self):
        """One flat weight vector and one flat gradient vector
        (AbstractModule.getParameters, ``:284``), copies in the reference's
        leaf order."""
        ws, gs = self.weights_and_grads()
        if not ws:
            return torch.zeros((0,)), torch.zeros((0,))
        return (torch.cat([w.detach().reshape(-1) for w in ws]),
                torch.cat([g.reshape(-1) for g in gs]))

    def set_flat_parameters(self, flat):
        """The inverse of ``get_parameters()[0]``."""
        self._need_built()
        flat = torch.as_tensor(flat)
        off = 0
        with torch.no_grad():
            for _, p in self._leaves():
                n = p.numel()
                p.copy_(flat[off:off + n].reshape(p.shape))
                off += n
        if off != flat.numel():
            raise ValueError(f"set_flat_parameters: {flat.numel()} values "
                             f"for {off} parameters")
        return self

    def zero_grad_parameters(self):
        for p in self.parameters():
            if p.grad is not None:
                p.grad.zero_()

    @torch.no_grad()
    def update_parameters(self, learning_rate: float):
        """w -= lr * gradW (AbstractModule.updateParameters)."""
        for p in self.parameters():
            if p.grad is not None:
                p.sub_(learning_rate * p.grad)

    def get_parameters_table(self):
        """name -> the module's param tree (getParametersTable)."""
        from ..utils.convert import _param_tree
        self._need_built()
        return {self.name: _param_tree(self, getattr)}

    def summary(self, print_fn=print) -> str:
        """A table of every module with its parameter count and dtypes,
        and the total; the reference's layout.  Returns the text (also
        given to ``print_fn``)."""
        self._need_built()
        rows = []

        def walk(module, depth):
            leaves = list(module.parameters())
            dts = sorted({str(p.dtype).replace("torch.", "") for p in leaves})
            rows.append(("  " * depth + type(module).__name__,
                         sum(p.numel() for p in leaves),
                         ",".join(dts) or "-"))
            for m in getattr(module, "layers", ()):
                walk(m, depth + 1)

        walk(self, 0)
        width = max(len(r[0]) for r in rows) + 2
        body = [f"{lbl:<{width}}{n:>12,}  {dt}" for lbl, n, dt in rows]
        header = f"{'Layer':<{width}}{'Params':>12}  Dtypes"
        rule = "-" * max(len(header), max(len(b) for b in body))
        text = "\n".join([header, rule] + body +
                         [rule, f"{'Total':<{width}}{rows[0][1]:>12,}"])
        if print_fn is not None:
            print_fn(text)
        return text

    # -- persistence --------------------------------------------------------

    def save(self, path: str, overwrite: bool = True):
        """The module tree and its tensors (as numpy) in the port's module
        file (``file_io``'s framed pickle); caches are not saved."""
        from ..utils import file_io
        self._need_built()
        tensors: list = []
        buf = io.BytesIO()
        with self._caches_cleared():
            _ModulePickler(buf, tensors).dump(self)
        file_io.save({"format": MODULE_FORMAT, "module": buf.getvalue(),
                      "tensors": tensors}, path, overwrite=overwrite)
        return self

    @staticmethod
    def load(path: str, device=None) -> "Module":
        """A module written by :meth:`save`, on ``device`` (default the
        CUDA device)."""
        blob = _read_blob(path)
        if not (isinstance(blob, dict) and
                blob.get("format") == MODULE_FORMAT):
            raise ValueError(f"{path!r} is not a bigdl_torch module file")
        m = _module_unpickler()(io.BytesIO(blob["module"]),
                                blob["tensors"]).load()
        return m.to(resolve_device(device))

    def attach(self, params, state=None):
        """Install a reference (params, state) tree of numpy leaves
        (``utils/convert.py`` ``load_reference_tree``)."""
        from ..utils.convert import load_reference_tree
        return load_reference_tree(self, params, state)

    def get_weights_bias(self):
        """The parameters as numpy, in the reference's leaf order
        (getWeightsBias)."""
        self._need_built()
        return [p.detach().cpu().numpy().copy() for _, p in self._leaves()]

    def set_weights_bias(self, arrays):
        """Install arrays in :meth:`get_weights_bias`'s order; a shape
        mismatch raises (setWeightsBias)."""
        self._need_built()
        leaves = [p for _, p in self._leaves()]
        if len(arrays) != len(leaves):
            raise ValueError(f"expected {len(leaves)} arrays, "
                             f"got {len(arrays)}")
        with torch.no_grad():
            for i, (a, p) in enumerate(zip(arrays, leaves)):
                if not isinstance(a, torch.Tensor):
                    a = torch.tensor(np.asarray(a))
                if tuple(a.shape) != tuple(p.shape):
                    raise ValueError(
                        f"set_weights_bias: array {i} has shape "
                        f"{tuple(a.shape)}, parameter expects "
                        f"{tuple(p.shape)}")
                p.copy_(a)
        return self

    def save_weights(self, path: str, overwrite: bool = True):
        """The weights alone (saveWeights), in the format both packages
        read."""
        from ..utils import file_io
        file_io.save({"format": WEIGHTS_FORMAT,
                      "weights": self.get_weights_bias()},
                     path, overwrite=overwrite)
        return self

    def load_weights(self, path: str):
        """(loadWeights)"""
        blob = _read_blob(path)
        if not (isinstance(blob, dict) and
                blob.get("format") == WEIGHTS_FORMAT):
            raise ValueError(f"{path!r} is not a weights file")
        return self.set_weights_bias(blob["weights"])

    def load_model_weights(self, src: "Module"):
        """Copy another module's weights, architecture-identical
        (loadModelWeights / copyWeights)."""
        src._need_built()
        return self.set_weights_bias([p for _, p in src._leaves()])

    copy_weights = load_model_weights

    def save_caffe(self, *args, **kwargs):
        raise NotImplementedError("save_caffe (interop/caffe.py) is not "
                                  "ported: ROADMAP.md queue A item 9")

    def save_tf(self, *args, **kwargs):
        raise NotImplementedError("save_tf (interop/tensorflow.py) is not "
                                  "ported: ROADMAP.md queue A item 9")

    def save_torch(self, *args, **kwargs):
        raise NotImplementedError("save_torch (interop/torchfile.py) is not "
                                  "ported: ROADMAP.md queue A item 9")

    # -- modes and bookkeeping ------------------------------------------------

    def is_training(self) -> bool:
        return self.training

    def get_times(self):
        """(module, forward s, backward s) per module of
        :meth:`unique_modules`, in its pre-order: the times the last
        ``utils/profiling.py`` ``ModuleProfiler`` block over the module
        measured, 0 for a module no profiler has timed (or after
        :meth:`reset_times`)."""
        return [(m, *getattr(m, "_profile_times", (0.0, 0.0)))
                for m in self.unique_modules()]

    def reset_times(self):
        for m in self.unique_modules():
            if "_profile_times" in m.__dict__:
                del m._profile_times

    def unique_modules(self):
        """Pre-order walk of the tree, each instance once."""
        seen = set()

        def walk(m):
            if id(m) in seen:
                return
            seen.add(id(m))
            yield m
            for c in getattr(m, "layers", ()):
                yield from walk(c)
        yield from walk(self)

    def clear_state(self):
        """Drop the facade's cached activations (clearState)."""
        self.output = None
        self.grad_input = None
        return self

    @torch.no_grad()
    def copy_status(self, src: "Module"):
        """Copy ``src``'s cached output, grad input and buffers
        (copyStatus)."""
        self.output = src.output
        self.grad_input = src.grad_input
        for b, sb in zip(self.buffers(), src.buffers()):
            b.copy_(sb)
        return self

    def get_scale_w(self) -> float:
        return self.scale_w

    def get_scale_b(self) -> float:
        return self.scale_b

    @contextlib.contextmanager
    def _caches_cleared(self):
        """The facade's caches of every module put aside in the block."""
        cached = [(m, m.output, m.grad_input, m._facade_rng)
                  for m in self.unique_modules()]
        for m, _, _, _ in cached:
            m.output = m.grad_input = m._facade_rng = None
        try:
            yield
        finally:
            for m, out, gin, rng in cached:
                m.output, m.grad_input, m._facade_rng = out, gin, rng

    def clone_module(self) -> "Module":
        """A deep copy without the facade's caches (cloneModule)."""
        with self._caches_cleared():
            return copy.deepcopy(self)

    def reset(self, generator: Optional[torch.Generator] = None):
        """New parameters drawn from ``generator`` (default: the
        process-wide one), on the device the module lives on (reset)."""
        device = self._device(None)
        self._build(generator if generator is not None
                    else default_generator())
        return self.to(device)

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

    #: names of the children's entries where the reference's tree of this
    #: container is a dict (one per child, in ``layers`` order); None
    #: where it is the list of the children's trees
    TREE_KEYS = None

    def __init__(self, *modules: Module):
        super().__init__()
        self.layers = torch.nn.ModuleList(modules)

    def tree_children(self):
        """(key, child) in the order the reference's tree flattens: the
        list's, or a dict's sorted keys."""
        if self.TREE_KEYS is None:
            return list(enumerate(self.layers))
        return sorted(zip(self.TREE_KEYS, self.layers), key=lambda kv: kv[0])

    def add(self, module: Module):
        """BigDL: Container.add (nn/Container.scala:54)."""
        self.layers.append(module)
        return self

    def _build(self, generator: torch.Generator) -> None:
        for m in self.layers:
            m._build(generator)
        self.built = True
