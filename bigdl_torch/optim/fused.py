"""The fused update: an optimization method run over one flat tensor per
dtype instead of one tensor per parameter.

Counterpart of ``bigdl_tpu/optim/fused.py`` (reference
``AbstractModule.getParameters``, Module.scala:284: every layer's weights
and gradients compacted into one storage before ``OptimMethod.optimize``).
The port's methods are ``torch._foreach_*`` operations over lists, so a
fused update runs the same method on lists holding one flat tensor per
dtype group: a handful of large launches in place of a few per parameter.
Every method the update can fuse (SGD, Adam, Adagrad, Adadelta, Adamax,
RMSprop, EMA) is elementwise, so each element goes through the same float
operations and the result is bit-identical to the per-leaf update.
``LBFGS`` opts out (``supports_fused = False``): its dot products run over
the whole parameter list.

:func:`fuse` concatenates a group's tensors, except where they already lie
back to back in one storage, in order (the views ``DataParallel``'s single
all-reduce splits its flat buffer into, or the state views
:func:`unfuse` handed out on the step before): then it returns a view of
that memory and copies nothing.  The parameters are written back in place
after the update.

A state list is fused where it is parameter-shaped
(``parallel/sharding.py`` :func:`param_shaped`), the same test by which
ZeRO's rule slices it.

Opt in with ``BIGDL_TORCH_FUSED_UPDATE=1`` (read when ``Optimizer.optimize``
starts) or call ``OptimMethod.update_fused``.  Under ``ShardedDataParallel``
the update runs on each rank's own slices (``parallel/sharding.py``): the
sliced leaves' gradients are row ``rank`` of the packed [N, S] gradient
buffer, a contiguous 1/N chunk (what the reference's ``fused_buffer_spec``
asks of its fused buffers).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..parallel.sharding import param_shaped

__all__ = ["FusedLayout", "plan", "fuse", "unfuse", "fused_update"]


class FusedLayout:
    """How a list of parameters maps onto flat buffers: ``groups[g]`` holds
    the indices of the leaves of one dtype, in leaf order, the groups in
    the order their dtypes first appear.  Derived from the parameters and
    used for the gradients and every parameter-shaped state list alike."""

    def __init__(self, params: Sequence[torch.Tensor]):
        self.shapes = [tuple(p.shape) for p in params]
        self.sizes = [p.numel() for p in params]
        self.dtypes = [p.dtype for p in params]
        by_dtype: dict = {}
        for i, dt in enumerate(self.dtypes):
            by_dtype.setdefault(dt, []).append(i)
        self.groups = tuple(tuple(v) for v in by_dtype.values())

    @property
    def n_leaves(self) -> int:
        return len(self.sizes)

    def matches(self, tree) -> bool:
        """True when ``tree`` is a list of tensors with this layout's leaf
        shapes: a parameter-shaped state list, safe to fuse.  A scalar
        step counter never matches, not even beside a model of one
        parameter."""
        return param_shaped(tree, self.shapes)


def plan(params: Sequence[torch.Tensor]) -> FusedLayout:
    """The fused layout of a list of parameters."""
    return FusedLayout(params)


def _back_to_back(parts: List[torch.Tensor]):
    """A flat view over ``parts`` where they are contiguous tensors of one
    dtype laid end to end in one storage, in order; else None."""
    first = parts[0]
    ptr = first.untyped_storage().data_ptr()
    offset = first.storage_offset()
    for t in parts:
        if (not t.is_contiguous() or t.dtype != first.dtype
                or t.untyped_storage().data_ptr() != ptr
                or t.storage_offset() != offset):
            return None
        offset += t.numel()
    return first.as_strided((offset - first.storage_offset(),), (1,))


def fuse(layout: FusedLayout, tensors: Sequence[torch.Tensor]
         ) -> List[torch.Tensor]:
    """``tensors`` (parameters, gradients or a parameter-shaped state list)
    as one flat tensor per group of the layout: a view where the group's
    tensors already lie back to back, else their concatenation."""
    bufs = []
    for idxs in layout.groups:
        parts = [tensors[i] for i in idxs]
        flat = _back_to_back(parts)
        if flat is None:
            flat = torch.cat([t.reshape(-1) for t in parts])
        bufs.append(flat)
    return bufs


def unfuse(layout: FusedLayout, bufs: Sequence[torch.Tensor]
           ) -> List[torch.Tensor]:
    """The flat buffers split back into one view per leaf, in leaf
    order."""
    leaves: List[torch.Tensor] = [None] * layout.n_leaves
    for idxs, buf in zip(layout.groups, bufs):
        parts = buf.split([layout.sizes[i] for i in idxs])
        for i, part in zip(idxs, parts):
            leaves[i] = part.view(layout.shapes[i])
    return leaves


def _fuse_state(layout, state, path=()):
    """``state`` with every parameter-shaped list fused, and the paths of
    those lists; scalars (Adam's ``t``) and other leaves pass through."""
    if layout.matches(state):
        return fuse(layout, state), {path}
    if isinstance(state, dict):
        out, paths = {}, set()
        for k, v in state.items():
            out[k], p = _fuse_state(layout, v, path + (k,))
            paths |= p
        return out, paths
    return state, set()


def _unfuse_state(layout, state, paths, path=()):
    if path in paths:
        return unfuse(layout, state)
    if isinstance(state, dict):
        return {k: _unfuse_state(layout, v, paths, path + (k,))
                for k, v in state.items()}
    return state


@torch.no_grad()
def fused_update(method, grads, params, state, lr):
    """``method.update`` over fused buffers, ``params`` updated in place;
    returns the new state, its parameter-shaped lists as views into one
    flat tensor per group.  Falls back to the per-leaf update where every
    group is a single leaf (fusing would only add copies)."""
    layout = plan(params)
    if layout.n_leaves <= len(layout.groups):
        return method.update(grads, params, state, lr)
    fp = fuse(layout, params)
    fg = fuse(layout, grads)
    fs, paths = _fuse_state(layout, state)
    new_fs = method.update(fg, fp, fs, lr)
    for p, v in zip(params, unfuse(layout, fp)):
        if v.data_ptr() != p.data_ptr():
            p.copy_(v)
    return _unfuse_state(layout, new_fs, paths)
