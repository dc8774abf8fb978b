"""Weight and state carry-over between the JAX package's trees and the port.

The reference keeps a model's weights and its non-trained state (BatchNorm
running statistics) as two pytrees: a container's tree is the list of its
children's trees (a dict of them where a model names its parts, as
``TreeLSTMSentiment`` does), a leaf module's tree is a dict of arrays by
name (``{}`` when it has none).  The port's module tree has the same shape
(``Container.layers`` in order, keyed by ``Container.TREE_KEYS`` where
the reference's is a dict; ``Module.param_names`` and
``Module.state_names`` per leaf, the latter registered as buffers), so a
reference (params, state) pair with numpy leaves copies in leaf by leaf and
back.  Every shape, name and structure mismatch raises; nothing is
reshaped.  A pipeline (``GPipeSequential``) is its stage's tree with
every leaf stacked along a leading stage axis, and state ``{}``, as in
the reference.

An optimization method's state carries across the same way.  The port
keeps one list per slot (``velocity``, ``m``, ``v``, ...) in the order of
``model.parameters()``; the reference keeps each slot as a param-shaped
tree.  :func:`to_reference_opt_state` and :func:`load_reference_opt_state`
map one to the other by parameter identity (a leaf module's parameter by
its name), not by position: the reference's tree flattens a leaf's dict
in sorted key order, the port's list in registration order.  Scalar slots
(Adam's int32 step count ``t``) pass as int32 arrays.  ``EMA``'s state is
``{"inner": <the inner method's>, "shadow": <a param tree>}``.  ``LBFGS``'s
history is raveled: the reference flattens the whole param tree into one
vector (``ravel_pytree``: containers in order, each leaf's dict in sorted
key order), so ``s`` and ``y`` [m, n], ``prev_flat`` and ``prev_grad``
[n] are the port's per-parameter rows concatenated in that order.

A model sharded over a mesh (``parallel/mesh_plan.py``) takes a whole
tree into its shards (each leaf cut for this rank) and gives a whole tree
back (gathered: every rank calls :func:`to_reference_tree`); a method
state's whole slots are cut alike.

``fetch`` (default: a copy to numpy) turns each tensor into the numpy leaf
written; an asynchronous snapshot passes one that returns views of pinned
copies the device is still filling (``optim/optimizer.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..nn.module import Container, Module

__all__ = ["load_reference_tree", "check_reference_tree",
           "to_reference_tree", "to_reference_opt_state",
           "load_reference_opt_state"]


def _where(path):
    return "/".join(str(p) for p in path) or "<root>"


def _stacked(module: Module) -> bool:
    """A pipeline (``parallel/pipeline.py`` ``GPipeSequential``): its
    reference param tree is its one stage's, each leaf stacked, and its
    state tree is {}."""
    return getattr(module, "STACKED", False)


def _walk(module: Module, tree, path, kind: str, names_of, visit) -> None:
    """Walk a reference tree beside the module tree, raising on any
    structure mismatch; ``visit(module, name, leaf, path)`` at each leaf."""
    if _stacked(module):
        if kind == "state":
            if tree != {}:
                raise ValueError(f"state tree at {_where(path)}: expected "
                                 f"{{}} for {type(module).__name__}, got "
                                 f"{type(tree).__name__}")
            return
        _walk(module.layers[0], tree, path, kind, names_of, visit)
        return
    if isinstance(module, Container):
        keys = module.TREE_KEYS
        if keys is None and (not isinstance(tree, (list, tuple)) or
                             len(tree) != len(module.layers)):
            raise ValueError(f"{kind} tree at {_where(path)}: expected a "
                             f"list of {len(module.layers)} child trees for "
                             f"{type(module).__name__}, got "
                             f"{type(tree).__name__}")
        if keys is not None and kind == "state" and tree == {} and \
                not _has_state(module):
            return  # the reference keeps such a model's state as {}
        if keys is not None and (not isinstance(tree, dict) or
                                 set(tree) != set(keys)):
            got = (sorted(tree) if isinstance(tree, dict)
                   else type(tree).__name__)
            raise ValueError(f"{kind} tree at {_where(path)}: expected a "
                             f"dict of child trees {sorted(keys)} for "
                             f"{type(module).__name__}, got {got}")
        for k, m in module.tree_children():
            _walk(m, tree[k], path + [k], kind, names_of, visit)
        return
    names = names_of(module)
    if not isinstance(tree, dict) or set(tree) != set(names):
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        noun = "state entries" if kind == "state" else "parameters"
        raise ValueError(f"{kind} tree at {_where(path)}: "
                         f"{type(module).__name__} has {noun} "
                         f"{sorted(names)}, got {got}")
    for name in names:
        visit(module, name, tree[name], path + [name])


def _has_state(module: Module) -> bool:
    return any(getattr(m, "state_names", ()) for m in module.modules())


def whole_shape(t) -> tuple:
    """The shape of the whole leaf ``t`` holds (a mesh shard's
    ``_layout_whole``, ``parallel/mesh_plan.py``), else its own."""
    s = getattr(t, "_layout_whole", None)
    return tuple(s) if s is not None else tuple(getattr(t, "shape", ()))


def _placed(dst, leaf: torch.Tensor) -> torch.Tensor:
    """A whole leaf as ``dst`` holds it: this rank's shard where ``dst``
    is a mesh shard."""
    cut = getattr(dst, "_layout_cut", None)
    return leaf if cut is None else cut(leaf)


def _copy_into(kind):
    def visit(module, name, leaf, path):
        dst = getattr(module, name)
        leaf = np.asarray(leaf)
        if tuple(leaf.shape) != whole_shape(dst):
            raise ValueError(f"{kind} {_where(path)}: shape "
                             f"{leaf.shape} != {whole_shape(dst)}")
        with torch.no_grad():
            dst.copy_(_placed(dst, torch.tensor(leaf)))
    return visit


def _load(module: Module, tree, path, kind: str, names_of) -> None:
    _walk(module, tree, path, kind, names_of, _copy_into(kind))


def check_reference_tree(model: Module, params, state=None) -> None:
    """Raise as :func:`load_reference_tree` would, changing nothing."""
    if not model.built:
        raise RuntimeError("check_reference_tree: build the model first")

    def check(kind):
        def visit(module, name, leaf, path):
            shape = tuple(np.shape(leaf))
            if shape != whole_shape(getattr(module, name)):
                raise ValueError(f"{kind} {_where(path)}: shape {shape} != "
                                 f"{whole_shape(getattr(module, name))}")
        return visit
    if state is not None:
        _walk(model, state, [], "state", lambda m: m.state_names,
              check("state"))
    _walk(model, params, [], "param", lambda m: m.param_names,
          check("param"))


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


def _dump(module: Module, fetch):
    if _stacked(module):
        return _dump(module.layers[0], fetch)[0], {}
    if isinstance(module, Container):
        trees = [_dump(m, fetch) for m in module.layers]
        ps, ss = [p for p, _ in trees], [s for _, s in trees]
        if module.TREE_KEYS is not None:
            return (dict(zip(module.TREE_KEYS, ps)),
                    dict(zip(module.TREE_KEYS, ss)) if _has_state(module)
                    else {})
        return ps, ss
    return ({n: fetch(getattr(module, n)) for n in module.param_names},
            {n: fetch(getattr(module, n)) for n in module.state_names})


def to_reference_tree(model: Module, fetch=None):
    """The model's (params, state) as reference trees with numpy leaves.
    A model sharded over a mesh (``parallel/mesh_plan.py``) gives its
    whole tree: the shards are gathered, so every rank calls this."""
    if not model.built:
        raise RuntimeError("to_reference_tree: build the model first")
    plan = model.__dict__.get("_layout_plan")
    if plan is not None:
        with plan.whole():
            return _dump(model, fetch or _numpy)
    return _dump(model, fetch or _numpy)


def _index(model: Module):
    return {id(p): i for i, p in enumerate(model.parameters())}


def _param_tree(module: Module, leaf):
    if _stacked(module):
        return _param_tree(module.layers[0], leaf)
    if isinstance(module, Container):
        trees = [_param_tree(m, leaf) for m in module.layers]
        if module.TREE_KEYS is not None:
            return dict(zip(module.TREE_KEYS, trees))
        return trees
    return {n: leaf(module, n) for n in module.param_names}


def _ravel_order(model: Module):
    """Indices into ``model.parameters()`` in the order ``ravel_pytree``
    flattens the reference's param tree."""
    index = _index(model)
    out = []

    def walk(m):
        if isinstance(m, Container):
            for _, c in m.tree_children():
                walk(c)
        else:
            out.extend(index[id(getattr(m, n))] for n in sorted(m.param_names))
    walk(model)
    return out


_LBFGS_ROWS = ("s", "y")
_LBFGS_FLAT = ("prev_flat", "prev_grad")


def _slots(method, state):
    want = set(method.init_state([]))
    if set(state) != want:
        raise ValueError(f"{type(method).__name__} state has slots "
                         f"{sorted(want)}, got {sorted(state)}")


def to_reference_opt_state(model: Module, method, state, fetch=None):
    """The port's method ``state`` (per-parameter lists, in
    ``model.parameters()`` order) as the reference's opt_state tree with
    numpy leaves.  Raises if a list does not match the parameters."""
    from ..optim.method import EMA, LBFGS
    if not model.built:
        raise RuntimeError("to_reference_opt_state: build the model first")
    fetch = fetch or _numpy
    index = _index(model)
    if isinstance(method, EMA):
        if set(state) != {"inner", "shadow"}:
            raise ValueError(f"EMA state has slots ['inner', 'shadow'], "
                             f"got {sorted(state)}")
        return {"inner": to_reference_opt_state(model, method.inner,
                                                state["inner"], fetch),
                "shadow": _slot_tree(model, index, "shadow",
                                     state["shadow"], fetch)}
    _slots(method, state)
    if isinstance(method, LBFGS):
        order = _ravel_order(model)
        out = {"rho": fetch(state["rho"]),
               "count": np.asarray(state["count"], np.int32)}
        for key in _LBFGS_ROWS + _LBFGS_FLAT:
            rows = state[key]
            if len(rows) != len(index):
                raise ValueError(f"opt_state[{key!r}]: {len(rows)} tensors "
                                 f"for {len(index)} parameters")
            out[key] = np.concatenate([fetch(rows[i]) for i in order],
                                      axis=-1)
        return out
    out = {}
    for key, val in state.items():
        if not isinstance(val, (list, tuple)):
            out[key] = np.asarray(val, np.int32)
            continue
        out[key] = _slot_tree(model, index, key, val, fetch)
    return out


def _slot_tree(model, index, key, val, fetch):
    """A per-parameter list as a param-shaped tree."""
    if len(val) != len(index):
        raise ValueError(f"opt_state[{key!r}]: {len(val)} tensors for "
                         f"{len(index)} parameters")

    def leaf(m, n):
        t = val[index[id(getattr(m, n))]]
        p = getattr(m, n)
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"opt_state[{key!r}] at {type(m).__name__}.{n}"
                             f": shape {tuple(t.shape)} != "
                             f"{tuple(p.shape)}")
        return fetch(t)
    return _param_tree(model, leaf)


def _load_lbfgs(model, template, tree):
    params = list(model.parameters())
    order = _ravel_order(model)
    sizes = [params[i].numel() for i in order]
    n = sum(sizes)
    out = {}
    for key, tmpl in template.items():
        leaf = np.asarray(tree[key])
        if key == "count":
            if leaf.shape != () or leaf.dtype != np.int32:
                raise ValueError(f"opt_state['count']: an int32 scalar, got "
                                 f"{leaf.dtype} {leaf.shape}")
            out[key] = np.int32(leaf)
            continue
        if key == "rho":
            if leaf.shape != tuple(tmpl.shape):
                raise ValueError(f"opt_state['rho']: shape {leaf.shape} != "
                                 f"{tuple(tmpl.shape)}")
            out[key] = torch.tensor(leaf).to(tmpl.device, tmpl.dtype)
            continue
        want = tuple(tmpl[0].shape[:-1]) + (n,) if tmpl else (n,)
        if leaf.shape[-1:] != (n,) or (
                key in _LBFGS_ROWS and leaf.shape != want):
            raise ValueError(f"opt_state[{key!r}]: shape {leaf.shape}, "
                             f"expected a last axis of {n}")
        parts = np.split(leaf, np.cumsum(sizes)[:-1], axis=-1)
        rows = [None] * len(params)
        for i, part in zip(order, parts):
            rows[i] = torch.tensor(part).to(tmpl[i].device, tmpl[i].dtype)
        out[key] = rows
    return out


def load_reference_opt_state(model: Module, method, tree):
    """The reference's opt_state ``tree`` (numpy leaves) as the port's
    method state for the built ``model``: per-parameter lists on each
    parameter's device and dtype, in ``model.parameters()`` order.  Raises
    on a missing or extra slot and on any structure or shape mismatch."""
    from ..optim.method import EMA, LBFGS
    if not model.built:
        raise RuntimeError("load_reference_opt_state: build the model "
                           "first")
    params = list(model.parameters())
    index = _index(model)
    if isinstance(method, EMA):
        if not isinstance(tree, dict) or set(tree) != {"inner", "shadow"}:
            got = (sorted(tree) if isinstance(tree, dict)
                   else type(tree).__name__)
            raise ValueError(f"EMA opt_state has slots ['inner', 'shadow'],"
                             f" got {got}")
        return {"inner": load_reference_opt_state(model, method.inner,
                                                  tree["inner"]),
                "shadow": _load_slot(model, index, "shadow",
                                     [p.detach() for p in params],
                                     tree["shadow"])}
    template = method.init_state(params)
    if not isinstance(tree, dict) or set(tree) != set(template):
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(f"{type(method).__name__} opt_state has slots "
                         f"{sorted(template)}, got {got}")
    if isinstance(method, LBFGS):
        return _load_lbfgs(model, template, tree)
    out = {}
    for key, tmpl in template.items():
        if not isinstance(tmpl, list):
            leaf = np.asarray(tree[key])
            if leaf.shape != () or leaf.dtype != np.int32:
                raise ValueError(f"opt_state[{key!r}]: an int32 scalar, "
                                 f"got {leaf.dtype} {leaf.shape}")
            out[key] = np.int32(leaf)
            continue
        out[key] = _load_slot(model, index, key, tmpl, tree[key])
    return out


def _load_slot(model, index, key, tmpl, tree):
    """A param-shaped tree as a per-parameter list like ``tmpl``."""
    slots = [None] * len(tmpl)

    def visit(m, n, leaf, path):
        p = getattr(m, n)
        i = index[id(p)]
        leaf = np.asarray(leaf)
        want = whole_shape(p) if tuple(tmpl[i].shape) == tuple(p.shape) \
            else tuple(tmpl[i].shape)
        if tuple(leaf.shape) != want:
            raise ValueError(f"opt_state[{key!r}] {_where(path)}: shape "
                             f"{leaf.shape} != {want}")
        slots[i] = _placed(p, torch.tensor(leaf)).to(
            tmpl[i].device, tmpl[i].dtype, copy=True)
    _walk(model, tree, [key], "opt_state", lambda m: m.param_names, visit)
    if any(s is None for s in slots):
        raise ValueError(f"opt_state[{key!r}] left parameters unset")
    return slots
