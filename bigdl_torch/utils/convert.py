"""Weight and state carry-over between the JAX package's trees and the port.

The reference keeps a model's weights and its non-trained state (BatchNorm
running statistics) as two pytrees: a container's tree is the list of its
children's trees, a leaf module's tree is a dict of arrays by name (``{}``
when it has none).  The port's module tree has the same shape
(``Container.layers`` in order; ``Module.param_names`` and
``Module.state_names`` per leaf, the latter registered as buffers), so a
reference (params, state) pair with numpy leaves copies in leaf by leaf and
back.  Every shape, name and structure mismatch raises; nothing is
reshaped.
"""

from __future__ import annotations

import numpy as np
import torch

from ..nn.module import Container, Module

__all__ = ["load_reference_tree", "to_reference_tree"]


def _where(path):
    return "/".join(str(p) for p in path) or "<root>"


def _load(module: Module, tree, path, kind: str, names_of) -> None:
    if isinstance(module, Container):
        if not isinstance(tree, (list, tuple)) or \
                len(tree) != len(module.layers):
            raise ValueError(f"{kind} tree at {_where(path)}: expected a "
                             f"list of {len(module.layers)} child trees for "
                             f"{type(module).__name__}, got "
                             f"{type(tree).__name__}")
        for i, (m, t) in enumerate(zip(module.layers, tree)):
            _load(m, t, path + [i], kind, names_of)
        return
    names = names_of(module)
    if not isinstance(tree, dict) or set(tree) != set(names):
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        noun = "parameters" if kind == "param" else "state entries"
        raise ValueError(f"{kind} tree at {_where(path)}: "
                         f"{type(module).__name__} has {noun} "
                         f"{sorted(names)}, got {got}")
    for name in names:
        dst = getattr(module, name)
        leaf = np.asarray(tree[name])
        if tuple(leaf.shape) != tuple(dst.shape):
            raise ValueError(f"{kind} {_where(path + [name])}: shape "
                             f"{leaf.shape} != {tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(torch.tensor(leaf))


def load_reference_tree(model: Module, params, state=None) -> Module:
    """Copy a reference (params, state) tree with numpy leaves into the
    built ``model``, in place, on whatever device it lives on.  ``state``
    may be omitted to leave the model's state as it is."""
    if not model.built:
        raise RuntimeError("load_reference_tree: build the model first "
                           "(model.build(device))")
    if state is not None:
        _load(model, state, [], "state", lambda m: m.state_names)
    _load(model, params, [], "param", lambda m: m.param_names)
    return model


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _dump(module: Module):
    if isinstance(module, Container):
        trees = [_dump(m) for m in module.layers]
        return [p for p, _ in trees], [s for _, s in trees]
    return ({n: _numpy(getattr(module, n)) for n in module.param_names},
            {n: _numpy(getattr(module, n)) for n in module.state_names})


def to_reference_tree(model: Module):
    """The model's (params, state) as reference trees with numpy leaves."""
    if not model.built:
        raise RuntimeError("to_reference_tree: build the model first")
    return _dump(model)
