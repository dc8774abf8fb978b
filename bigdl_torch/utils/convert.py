"""Weight carry-over between the JAX package's param trees and the port.

The reference keeps a model's weights as pytrees: a container's tree is
the list of its children's trees, a leaf module's tree is a dict of arrays
by parameter name (``{}`` when it has none).  The port's module tree has
the same shape (``Container.layers`` in order, ``Module.param_names`` per
leaf), so a reference tree with numpy leaves copies in leaf by leaf.
Every shape, name and structure mismatch raises; nothing is reshaped.
"""

from __future__ import annotations

import numpy as np
import torch

from ..nn.module import Container, Module

__all__ = ["load_reference_tree", "to_reference_tree"]


def _where(path):
    return "/".join(str(p) for p in path) or "<root>"


def _check_state(module: Module, state, path) -> None:
    # no module of the ported slice carries state: every leaf's is {}
    if isinstance(module, Container):
        if not isinstance(state, (list, tuple)) or \
                len(state) != len(module.layers):
            raise ValueError(f"state tree at {_where(path)}: expected a list "
                             f"of {len(module.layers)} child states for "
                             f"{type(module).__name__}")
        for i, (m, s) in enumerate(zip(module.layers, state)):
            _check_state(m, s, path + [i])
    elif state != {}:
        raise ValueError(f"state tree at {_where(path)}: "
                         f"{type(module).__name__} has no state, got "
                         f"{type(state).__name__}")


def _load(module: Module, tree, path) -> None:
    if isinstance(module, Container):
        if not isinstance(tree, (list, tuple)) or \
                len(tree) != len(module.layers):
            raise ValueError(f"param tree at {_where(path)}: expected a list "
                             f"of {len(module.layers)} child trees for "
                             f"{type(module).__name__}, got "
                             f"{type(tree).__name__}")
        for i, (m, t) in enumerate(zip(module.layers, tree)):
            _load(m, t, path + [i])
        return
    if not isinstance(tree, dict) or set(tree) != set(module.param_names):
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(f"param tree at {_where(path)}: "
                         f"{type(module).__name__} has parameters "
                         f"{sorted(module.param_names)}, got {got}")
    for name in module.param_names:
        param = getattr(module, name)
        leaf = np.asarray(tree[name])
        if tuple(leaf.shape) != tuple(param.shape):
            raise ValueError(f"param {_where(path + [name])}: shape "
                             f"{leaf.shape} != {tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(torch.tensor(leaf))


def load_reference_tree(model: Module, params, state=None) -> Module:
    """Copy a reference (params, state) tree with numpy leaves into the
    built ``model``, in place, on whatever device it lives on."""
    if not model.built:
        raise RuntimeError("load_reference_tree: build the model first "
                           "(model.build(device))")
    if state is not None:
        _check_state(model, state, [])
    _load(model, params, [])
    return model


def _dump(module: Module):
    if isinstance(module, Container):
        trees = [_dump(m) for m in module.layers]
        return [p for p, _ in trees], [s for _, s in trees]
    return ({n: getattr(module, n).detach().cpu().numpy()
             for n in module.param_names}, {})


def to_reference_tree(model: Module):
    """The model's weights as a reference (params, state) tree with numpy
    leaves."""
    if not model.built:
        raise RuntimeError("to_reference_tree: build the model first")
    return _dump(model)
