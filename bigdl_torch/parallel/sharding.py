"""Sharding strategies: how parameters, optimizer state and batches map
onto the data group.

Counterpart of ``bigdl_tpu/parallel/sharding.py``.  The reference's only
inter-node strategy is synchronous data parallelism
(``parameters/AllReduceParameter.scala``), expressed there as shardings of
one compiled program.  Here a strategy is what the ``Optimizer`` does
around each rank's eager step:

- :class:`DataParallel`: parameters and buffers are replicated, broadcast
  from rank 0 when the optimizer starts; each rank feeds its own rows
  (``DataSet.array(..., distributed=True)``), and after the backward the
  gradients and the loss are averaged over the group in one all-reduce of
  one float32 buffer.  With ``BIGDL_TORCH_WIRE_BUCKET_MB`` > 0 (read once
  when the optimizer starts, the same value that buckets the wire cast)
  that buffer is cut into the wire's buckets (``parallel/wire.py`` :func:`bucket_assignment` over float32
  bytes, the loss riding in bucket 0), and each bucket's all-reduce is
  launched asynchronously from the backward, by a post-accumulate-grad
  hook on each parameter, as soon as its last gradient is ready; the
  step waits on every handle before the regularizers run.  This is the
  counterpart of the reference's overlap flags
  (``bigdl_tpu/utils/platform.py``).  Under gradient accumulation the
  hooks act on the last microbatch's backward only, on the gradients
  divided by the accumulation steps, so the values are bit-equal to the
  single all-reduce.  Every rank must run the same graph: the hooks fire,
  and the buckets launch, in the backward's order, interleaved with
  sync-BN's all-reduces, and a parameter that receives no gradient sends
  zeros after the backward, bucket by bucket in order.
- :class:`ShardedDataParallel` (ZeRO, the reference's form of BigDL's
  ``AllReduceParameter``: reduce-scatter into 1/N slices, each rank
  updates its own slice, then an all-gather).  The plan is the
  reference's: a leaf under ``min_size`` elements stays replicated; any
  other is sliced along the last axis, counting back from the end, that
  the world size divides; a leaf with no such axis stays replicated
  (:meth:`ShardedDataParallel.param_axes`).  A step packs every sliced
  gradient's slice r into row r of an [N, S] float32 buffer and
  reduce-scatters it in one call, so each rank gets its own S elements;
  the replicated gradients and the loss go through one all-reduce.  The
  regularizers, scales, wire and clipping then apply to the own slices
  and the replicated leaves, the method updates them (its state for a
  sliced leaf holds only the slice), and the updated slices are
  all-gathered back into every rank's whole parameters, one call per
  parameter dtype.  A method whose update is not elementwise
  (``supports_fused = False``: ``LBFGS``) keeps replicated state and
  takes the full all-reduce, as GSPMD does for the reference's raveled
  history.

  The parameters stay whole on every rank between steps: the reference's
  "weights all-gather lazily", taken eagerly.  What ZeRO saves here is the
  optimizer state: for the reference's ResNet-50 tree (214 leaves,
  25,583,592 elements; the port's fused and unfused ResNet-50 have the
  same leaves) 25,489,408 elements are in sliced leaves and 94,184 stay
  replicated, so one float32 slot per rank is 12,838,888 elements at
  N = 2 (51.36 MB, against 102.33 MB under ``DataParallel``) and
  6,466,536 at N = 4 (25.87 MB).  Against the reference's sliced
  parameters each rank holds (N − 1)/N of the parameters more (51.17 MB
  at N = 2 for ResNet-50's float32 weights), and for the step's length
  the [N, S] send buffer and the gather buffer, each the size of the
  sliced parameters.

``ShardingStrategy.opt_state_sharding`` is the reference's rule for the
method state: a parameter-shaped list (:func:`param_shaped`) inherits the
parameters' slicing leaf by leaf; scalars and unmatched leaves stay
replicated, and so does a leaf whose shape two parameters with different
slicings share.  It is the one rule: ZeRO's ``shard_state`` and
``full_state`` cut and gather the leaves it marks, and ``remap`` cuts them
for another world through host memory (elasticity, ROADMAP queue A item
6, will use it), with the one cutter :func:`_cut`.

``LayoutSharding`` (the MeshLayout axes) and ``TensorParallel`` hold the
parameters as mesh shards (``parallel/mesh_plan.py``), on the Engine's
mesh or the one a thread pinned (``Engine.pinned``: a router member's).
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.engine import Engine
from .wire import bucket_assignment

__all__ = ["ShardingStrategy", "DataParallel", "ShardedDataParallel",
           "TensorParallel", "LayoutSharding", "param_shaped"]


def _shape(t) -> tuple:
    """A tensor's, an array's or a scalar's shape; a shape as it is."""
    if isinstance(t, tuple):
        return tuple(t)
    return tuple(getattr(t, "shape", ()))


def param_shaped(tree, shapes) -> bool:
    """True where ``tree`` is a parameter-shaped list: a list or tuple of
    as many leaves as ``shapes``, each of its shape (a scalar step counter
    never is, not even beside a model of one parameter)."""
    return (isinstance(tree, (list, tuple)) and len(tree) == len(shapes)
            and all(_shape(t) == tuple(s) for t, s in zip(tree, shapes)))


def _cut(t: torch.Tensor, ax: Optional[int], world: int, rank: int
         ) -> torch.Tensor:
    """Slice ``rank`` of ``world`` of ``t`` along ``ax`` (a view), or ``t``
    where ``ax`` is None."""
    if ax is None:
        return t
    c = t.shape[ax] // world
    return t.narrow(ax, rank * c, c)


def _map_spec(tree, spec, fn):
    """``tree`` with ``fn(leaf, axis)`` at every leaf, ``spec`` the tree of
    axes :meth:`ShardingStrategy.opt_state_sharding` gives for it."""
    if isinstance(tree, dict):
        return {k: _map_spec(v, spec[k], fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_spec(v, a, fn) for v, a in zip(tree, spec)]
    return fn(tree, spec)


def _broadcast(model: torch.nn.Module) -> None:
    """The model's tensors of the group's rank 0 on every rank of it."""
    group = Engine.group()
    src = dist.get_global_rank(group, 0) if group is not None and \
        group is not dist.group.WORLD else 0
    for t in list(model.parameters()) + list(model.buffers()):
        dist.broadcast(t, src, group=group)


class ShardingStrategy:
    """What the Optimizer does around each rank's step.  The base step is
    replicated: every hook below but :meth:`setup` and :meth:`reduce`
    leaves the step as it is."""

    def setup(self, model: torch.nn.Module, method=None,
              bucket_mb: float = 0.0) -> None:
        """Make the model's parameters and buffers agree across ranks
        before the first step, and plan the step for ``method``;
        ``bucket_mb`` is the gradient wire's bucket cap (the Optimizer
        passes ``BIGDL_TORCH_WIRE_BUCKET_MB`` as it read it when it
        started)."""
        raise NotImplementedError

    def batch_shard_count(self) -> int:
        """How many ways a batch's rows are split: the padding multiple of
        sharded inference."""
        return Engine.group_size()

    def param_axes(self, params, world: Optional[int] = None
                   ) -> List[Optional[int]]:
        """The axis each parameter (a tensor or a shape) is sliced along
        over a world of ``world`` ranks (default: the group's), or None
        where it is replicated."""
        return [None] * len(params)

    def opt_state_sharding(self, opt_state, params, axes=None):
        """The method state's slicing, the state's structure with an axis
        (or None) at each leaf: a list of the parameters' length and
        shapes inherits ``axes`` (default: :meth:`param_axes`) leaf by
        leaf; a scalar, and a leaf whose shape no parameter has, or two
        parameters with different axes have, is None; any other leaf
        takes the axis of the parameters of its shape."""
        shapes = [_shape(p) for p in params]
        if axes is None:
            axes = self.param_axes(shapes)
        by_shape, ambiguous = {}, set()
        for s, a in zip(shapes, axes):
            if s in by_shape and by_shape[s] != a:
                ambiguous.add(s)
            by_shape.setdefault(s, a)

        def assign(sub):
            if param_shaped(sub, shapes):
                return list(axes)
            if isinstance(sub, dict):
                return {k: assign(v) for k, v in sub.items()}
            if isinstance(sub, (list, tuple)):
                return [assign(v) for v in sub]
            s = _shape(sub)
            if len(s) == 0 or s in ambiguous:
                return None
            return by_shape.get(s)
        return assign(opt_state)

    def remap(self, params, tree, world: Optional[int] = None,
              rank: Optional[int] = None):
        """``tree`` (whole tensors: a parameter list or a method state, as
        :meth:`ShardedDataParallel.full_state` gives it) re-derived for
        rank ``rank`` of a world of ``world`` (default: this rank and the
        group's world): every tensor goes through host memory, and each
        leaf that :meth:`opt_state_sharding` slices is cut to that rank's
        slice, then placed on the device of ``params``."""
        world = Engine.group_size() if world is None else world
        rank = Engine.group_rank() if rank is None else rank
        shapes = [_shape(p) for p in params]
        spec = self.opt_state_sharding(tree, shapes,
                                       self.param_axes(shapes, world))
        device = params[0].device if params and isinstance(
            params[0], torch.Tensor) else None

        def place(t, ax):
            if isinstance(t, np.ndarray):
                t = torch.tensor(t)
            if not isinstance(t, torch.Tensor):
                return t
            return _cut(t.detach().cpu(), ax, world, rank).to(
                device, copy=True, memory_format=torch.contiguous_format)
        return _map_spec(tree, spec, place)

    # -- the step (the Optimizer calls these in this order) ---------------

    def arm(self, params, loss: torch.Tensor, accum: int) -> bool:
        """Called before the last microbatch's backward with the loss over
        the batch: True where the strategy takes the gradients from the
        backward itself, and :meth:`reduce` then gets None for them."""
        return False

    def reduce(self, grads: Optional[List[torch.Tensor]], loss: torch.Tensor
               ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """(gradients, loss) of this rank's batch -> those of the global
        batch for this rank's share of the parameters (:meth:`own`), the
        loss a 0-d float32 tensor (reading it would wait for the card)."""
        raise NotImplementedError

    def own(self, params: List[torch.Tensor]) -> List[torch.Tensor]:
        """The tensors this rank updates: the parameters, or views of
        their slices."""
        return params

    def sq_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The squared L2 norm of the global gradient from this rank's
        share of it, float32 on the device."""
        return torch.stack([torch.sum(torch.square(g.float()))
                            for g in grads]).sum()

    def after_update(self, params: List[torch.Tensor]) -> None:
        """Make every rank's parameters whole again after the update."""

    def shard_state(self, state):
        """A whole method state (per-parameter lists) cut to this rank's
        share."""
        return state

    def full_state(self, state):
        """This rank's share of a method state made whole (a collective
        every rank calls where the state is sliced)."""
        return state

    def place(self, model):
        """Put ``model``'s parameters where this strategy keeps them before
        a forward outside the Optimizer (``Predictor``, ``Evaluator``);
        the replicated strategies leave them as they are."""
        return None

    def whole(self, model):
        """A block in which ``model``'s parameters are whole (every rank
        enters it together where they are sharded)."""
        return contextlib.nullcontext()


class DataParallel(ShardingStrategy):
    """Replicated parameters, per-rank rows, averaged gradients (the
    reference's strategy); a ``bucket_mb`` above 0 in :meth:`setup` cuts
    the all-reduce into buckets launched from the backward."""

    def __init__(self):
        self._buckets = None

    @torch.no_grad()
    def setup(self, model, method=None, bucket_mb=0.0):
        _broadcast(model)
        if self._buckets is not None:
            self._buckets.remove()
            self._buckets = None
        if bucket_mb > 0:
            self._buckets = _GradBuckets(list(model.parameters()), bucket_mb)

    def arm(self, params, loss, accum):
        if self._buckets is None:
            return False
        self._buckets.arm(loss, accum)
        return True

    @torch.no_grad()
    def reduce(self, grads, loss):
        """Every gradient and the loss flattened into one float32 buffer,
        summed over the group in one all-reduce, divided by the world size
        and split back: each rank's loss is the mean over its rows, so the
        mean over ranks is the global-batch loss and gradient.  Bucketed,
        the armed buckets' all-reduces are waited on and split alike."""
        if self._buckets is not None and self._buckets.armed:
            return self._buckets.finish()
        flat = torch.cat([g.reshape(-1).float() for g in grads]
                         + [loss.detach().float().reshape(1)])
        Engine.all_reduce(flat, "grads")
        flat /= Engine.group_size()
        parts = torch.split(flat[:-1], [g.numel() for g in grads])
        return ([p.view(g.shape) for p, g in zip(parts, grads)], flat[-1])


class _GradBuckets:
    """``DataParallel``'s bucketed all-reduce: float32 buffers in the
    wire's bucket assignment, each all-reduced asynchronously as soon as
    the backward has accumulated its last gradient."""

    def __init__(self, params: List[torch.nn.Parameter], bucket_mb: float):
        self.params = params
        self.sizes = [p.numel() for p in params]
        self.assignment = bucket_assignment(self.sizes, 4, bucket_mb)
        self.where = {}
        for b, idxs in enumerate(self.assignment):
            off = 0
            for i in idxs:
                self.where[id(params[i])] = (b, off, i)
                off += self.sizes[i]
        self.handles = [p.register_post_accumulate_grad_hook(self._ready)
                        for p in params]
        self.armed = False

    def remove(self):
        for h in self.handles:
            h.remove()
        self.handles = []

    def arm(self, loss, accum):
        device = self.params[0].device
        # bucket 0 carries the loss in one more element
        self.bufs = [torch.empty(sum(self.sizes[i] for i in idxs)
                                 + (b == 0), device=device)
                     for b, idxs in enumerate(self.assignment)]
        self.bufs[0][-1:].copy_(loss.detach().float().reshape(1))
        self.pending = [len(idxs) for idxs in self.assignment]
        self.filled = [False] * len(self.params)
        self.works = [None] * len(self.bufs)
        self.accum = accum
        self.armed = True

    @torch.no_grad()
    def _ready(self, p):
        if not self.armed:
            return
        b, off, i = self.where[id(p)]
        g = p.grad
        if self.accum > 1:
            g = g / self.accum
        self.bufs[b][off:off + self.sizes[i]].copy_(g.reshape(-1))
        self.filled[i] = True
        self.pending[b] -= 1
        if self.pending[b] == 0:
            self._launch(b)

    def _launch(self, b):
        self.works[b] = Engine.all_reduce(self.bufs[b], "grads",
                                          async_op=True)

    @torch.no_grad()
    def finish(self):
        """Wait on every bucket (first launching, in bucket order, those
        holding a parameter the backward gave no gradient, its slot
        zeroed); returns (gradients as views, loss)."""
        for b, idxs in enumerate(self.assignment):
            if self.works[b] is not None:
                continue
            off = 0
            for i in idxs:
                if not self.filled[i]:
                    self.bufs[b][off:off + self.sizes[i]].zero_()
                off += self.sizes[i]
            self._launch(b)
        for w in self.works:
            w.wait()
        self.armed = False
        world = Engine.group_size()
        grads: List[torch.Tensor] = [None] * len(self.params)
        for buf, idxs in zip(self.bufs, self.assignment):
            buf /= world
            parts = buf.split([self.sizes[i] for i in idxs]
                              + [buf.numel() - sum(self.sizes[i]
                                                   for i in idxs)])
            for i, part in zip(idxs, parts):
                grads[i] = part.view(self.params[i].shape)
        loss = self.bufs[0][-1]
        self.bufs = self.works = None
        return grads, loss


class _Slice:
    """One sliced leaf's geometry: the leaf viewed as [pre, N, c, post]
    along its axis, c = shape[axis] / N; ``off`` its column in the packed
    [N, S] gradient buffer, ``goff`` in its dtype group's gather buffer."""

    def __init__(self, i, shape, ax, world):
        self.i, self.ax = i, ax
        self.shape = tuple(shape)
        self.pre = math.prod(shape[:ax])
        self.c = shape[ax] // world
        self.post = math.prod(shape[ax + 1:])
        self.size = self.pre * self.c * self.post
        self.own_shape = self.shape[:ax] + (self.c,) + self.shape[ax + 1:]
        self.off = self.goff = 0


class ShardedDataParallel(ShardingStrategy):
    """ZeRO: each rank updates, and keeps the method state of, a 1/N
    slice of every parameter of at least ``min_size`` elements (module
    docstring)."""

    def __init__(self, min_size: int = 2 ** 14):
        self.min_size = min_size
        self._slices: List[_Slice] = []
        self._replicated: List[int] = []

    def param_axes(self, params, world=None):
        """The reference's rule, leaf by leaf (module docstring)."""
        n = Engine.group_size() if world is None else world

        def axis(shape):
            if math.prod(shape) < self.min_size:
                return None
            for ax in range(len(shape) - 1, -1, -1):
                if shape[ax] % n == 0:
                    return ax
            return None
        return [axis(_shape(p)) for p in params]

    @torch.no_grad()
    def setup(self, model, method=None, bucket_mb=0.0):
        _broadcast(model)
        params = list(model.parameters())
        self.world, self.rank = Engine.group_size(), Engine.group_rank()
        self.device = params[0].device if params else None
        if method is not None and not method.supports_fused:
            axes = [None] * len(params)
        else:
            axes = self.param_axes(params)
        self.axes = axes
        self._shapes = [tuple(p.shape) for p in params]
        self._slices = [_Slice(i, tuple(p.shape), ax, self.world)
                        for i, (p, ax) in enumerate(zip(params, axes))
                        if ax is not None]
        self._replicated = [i for i, ax in enumerate(axes) if ax is None]
        self._rep_sizes = [params[i].numel() for i in self._replicated]
        off = 0
        for s in self._slices:
            s.off = off
            off += s.size
        self.sliced_numel = off
        self._groups = _dtype_groups(self._slices,
                                     [params[s.i] for s in self._slices])

    def own_shapes(self) -> List[tuple]:
        """The shape of each tensor this rank updates, in parameter
        order."""
        shapes = list(self._shapes)
        for s in self._slices:
            shapes[s.i] = s.own_shape
        return shapes

    def own(self, params):
        out = list(params)
        for s in self._slices:
            out[s.i] = _cut(params[s.i], s.ax, self.world, self.rank)
        return out

    @torch.no_grad()
    def reduce(self, grads, loss):
        """The sliced gradients reduce-scattered from the packed [N, S]
        buffer, the replicated ones and the loss all-reduced, both divided
        by the world size; returns (this rank's gradient of each tensor of
        :meth:`own`, loss)."""
        n = self.world
        own = list(grads)
        if self._slices:
            send = torch.empty((n, self.sliced_numel), device=self.device)
            for s in self._slices:
                send[:, s.off:s.off + s.size].view(
                    n, s.pre, s.c, s.post).copy_(grads[s.i].reshape(
                        s.pre, n, s.c, s.post).transpose(0, 1))
            recv = torch.empty(self.sliced_numel, device=self.device)
            Engine.reduce_scatter(recv, send.view(-1), "grads")
            recv /= n
            for s in self._slices:
                own[s.i] = recv[s.off:s.off + s.size].view(s.own_shape)
        flat = torch.cat([grads[i].reshape(-1).float()
                          for i in self._replicated]
                         + [loss.detach().float().reshape(1)])
        Engine.all_reduce(flat, "grads")
        flat /= n
        parts = torch.split(flat[:-1], self._rep_sizes)
        for i, part in zip(self._replicated, parts):
            own[i] = part.view(grads[i].shape)
        return own, flat[-1]

    def sq_norm(self, grads):
        """The sliced leaves' squares summed over the group in one
        all-reduce, the replicated leaves' added once."""
        zero = torch.zeros((), device=self.device)
        sliced = zero
        if self._slices:
            sliced = torch.stack([torch.sum(torch.square(grads[s.i].float()))
                                  for s in self._slices]).sum().reshape(1)
            Engine.all_reduce(sliced, "clip_norm")
            sliced = sliced[0]
        rep = zero
        if self._replicated:
            rep = torch.stack([torch.sum(torch.square(grads[i].float()))
                               for i in self._replicated]).sum()
        return sliced + rep

    @torch.no_grad()
    def _gather(self, groups, own, kind, into=None):
        """Whole tensors of the sliced leaves ``groups`` (:func:`_dtype_groups`
        of :class:`_Slice`) from every rank's slices in ``own`` (indexed by
        each slice's ``i``; other entries pass through), one all-gather per
        dtype group; written into ``into``'s tensors where given."""
        n, whole = self.world, list(own)
        for members in groups:
            total = sum(s.size for s in members)
            dtype = own[members[0].i].dtype
            send = torch.empty(total, dtype=dtype, device=self.device)
            for s in members:
                send[s.goff:s.goff + s.size].view(s.pre, s.c, s.post).copy_(
                    own[s.i].reshape(s.pre, s.c, s.post))
            out = torch.empty(n * total, dtype=dtype, device=self.device)
            Engine.all_gather(out, send, kind)
            grid = out.view(n, total)
            for s in members:
                src = grid[:, s.goff:s.goff + s.size].view(
                    n, s.pre, s.c, s.post).transpose(0, 1)
                if into is not None:
                    into[s.i].view(s.pre, n, s.c, s.post).copy_(src)
                else:
                    whole[s.i] = src.reshape(s.shape)
        return whole

    def after_update(self, params):
        """The updated slices all-gathered into every rank's parameters."""
        if self._slices:
            self._gather(self._groups, self.own(params), "params",
                         into=params)

    def shard_state(self, state):
        """A whole method state cut to this rank's share: every leaf that
        :meth:`opt_state_sharding` slices becomes a copy of its slice (the
        whole tensor is not kept).  :meth:`remap`'s cut, on the device."""
        if not self._slices:
            return state
        spec = self.opt_state_sharding(state, self._shapes, self.axes)
        return _map_spec(state, spec, lambda t, ax: t if ax is None else
                         _cut(t, ax, self.world, self.rank).clone(
                             memory_format=torch.contiguous_format))

    def full_state(self, state):
        """This rank's share of a method state made whole: every leaf that
        :meth:`opt_state_sharding` slices, all-gathered in one call per
        dtype (every rank calls this at the same point)."""
        if not self._slices:
            return state
        spec = self.opt_state_sharding(state, self.own_shapes(), self.axes)
        leaves, slices = [], []

        def mark(t, ax):
            if ax is None:
                return t
            shape = list(t.shape)
            shape[ax] *= self.world
            slices.append(_Slice(len(leaves), shape, ax, self.world))
            leaves.append(t)
            return len(leaves) - 1
        marked = _map_spec(state, spec, mark)
        whole = self._gather(_dtype_groups(slices, leaves), leaves,
                             "opt_state")
        return _map_spec(marked, spec,
                         lambda t, ax: t if ax is None else whole[t])


def _dtype_groups(slices: List[_Slice], tensors) -> List[List[_Slice]]:
    """``slices`` grouped by their tensors' dtype, in first-seen order, each
    slice's ``goff`` set to its offset in its group's gather buffer."""
    groups = {}
    for s, t in zip(slices, tensors):
        members = groups.setdefault(t.dtype, [])
        s.goff = sum(m.size for m in members)
        members.append(s)
    return list(groups.values())




class _MeshSharded(ShardingStrategy):
    """Parameters held as mesh shards (``parallel/mesh_plan.py``): the
    common half of :class:`LayoutSharding` and :class:`TensorParallel`.

    - :meth:`setup` broadcasts the parameters and buffers from the mesh's
      first rank over its ranks (the Engine's mesh, or the one the thread
      pinned) and cuts each parameter to this rank's shard, in place:
      the Optimizer's parameters and its method state are the shards
      (a method state inherits the shards leaf by leaf).
    - :meth:`reduce`: the backward has summed each gathered leaf's
      gradient over the batch ranks of its gather group (the plan's
      reduce-scatter); the rest of the batch axes are summed here, in one
      float32 all-reduce a set of remaining axes (the loss with the set
      of all of them), and everything is divided by the batch ranks'
      count.  With ``BIGDL_TORCH_WIRE_BUCKET_MB`` > 0 each such
      all-reduce is cut into the wire's buckets (``parallel/wire.py``
      :func:`bucket_assignment` over float32 bytes, the leaves in order,
      the loss riding in the last bucket of its set), issued set by set
      and bucket by bucket in one order on every rank; a sum is
      elementwise, so the values are the unbucketed ones wherever the
      ranks' reduction adds each element in the same order (two ranks
      a set, as every layout of four).  Here :meth:`reduce` runs after
      the backward has ended, so a bucket overlaps nothing: the buckets
      only cap each message's size, and they add all-reduces (one a
      bucket in place of one a set), each a round trip.  Leave the
      setting at 0 under a mesh strategy unless one message of a set's
      whole gradient is too large for the transport.
    - :meth:`dot` and :meth:`sq_norm` count each element once: a leaf's
      local sum of products is summed over the ranks that hold its other
      shards (one all-reduce a set of axes), never over its replicas.
      A method without a fused update (``LBFGS``) computes every dot
      product of its two-loop recursion with :meth:`dot` (the
      ``Optimizer`` binds it), and keeps its raveled rows as this rank's
      shards: :meth:`full_state` / :meth:`shard_state` gather and cut
      them, as a method state's parameter-shaped lists; :meth:`whole`
      swaps whole parameters in for a checkpoint (every rank calls
      them).
    """

    #: the parameters themselves are cut (the Optimizer cuts a resumed
    #: method state before it copies its starting point)
    SHARDS_PARAMS = True
    #: the axis a capable layer computes its slice over
    TP_AXIS = "tp"
    BATCH_AXES = ("data", "fsdp")
    #: the most MB of a gradient all-reduce (``setup``'s; 0: one a set)
    bucket_mb = 0.0

    def specs(self, model) -> List[tuple]:
        """One spec a parameter, in ``model.parameters()`` order."""
        raise NotImplementedError

    def _key(self):
        return (type(self).__name__, id(Engine.mesh()))

    def place(self, model):
        """Shard ``model`` under this strategy where it is not yet (its
        plan is kept on it as ``_layout_plan``); returns the plan."""
        from .mesh_plan import MeshPlan
        plan = model.__dict__.get("_layout_plan")
        if plan is not None:
            if plan.key != self._key():
                raise RuntimeError(
                    f"the model is sharded under {plan.key[0]} on another "
                    "mesh; build a new model for this one")
            self.plan = plan
            return plan
        tensors = list(model.parameters()) + list(model.buffers())
        # from the mesh's first rank over its ranks (the Engine's mesh, or
        # the one the thread pinned: a router member's subset)
        st = Engine.mesh_state()
        src, group = (0, None) if st is None else \
            (st.ranks[0], st.axis_group(st.names))
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t, src, group=group)
        plan = MeshPlan(model, self.specs(model), self.TP_AXIS,
                        self.BATCH_AXES)
        plan.key = self._key()
        plan.shard()
        model._layout_plan = plan
        self.plan = plan
        return plan

    def setup(self, model, method=None, bucket_mb=0.0):
        self.bucket_mb = bucket_mb
        self.place(model)

    def whole(self, model):
        plan = model.__dict__.get("_layout_plan")
        return plan.whole() if plan is not None else super().whole(model)

    @torch.no_grad()
    def reduce(self, grads, loss):
        plan = self.plan
        batch = plan.batch_axes

        def remaining(l):
            done = l.gathered(plan.names)
            return tuple(a for a in batch if a not in done)
        groups = _by_axes(plan.leaves, remaining)
        groups.setdefault(batch, [])
        out = list(grads)
        loss_out = loss.detach().float().reshape(())
        n = math.prod(plan.sizes[a] for a in batch)
        for axes, idx in groups.items():
            buckets = [idx]
            if axes and self.bucket_mb > 0 and idx:
                buckets = [[idx[j] for j in b] for b in bucket_assignment(
                    [grads[i].numel() for i in idx], 4, self.bucket_mb)]
            for k, members in enumerate(buckets):
                with_loss = axes == batch and k == len(buckets) - 1
                flat = torch.cat([grads[i].reshape(-1).float()
                                  for i in members]
                                 + ([loss_out.reshape(1)] if with_loss
                                    else []))
                if axes:
                    Engine.all_reduce(flat, "grads",
                                      group=Engine.axis_group(axes))
                if n > 1:
                    flat /= n
                if with_loss:
                    loss_out = flat[-1]
                    flat = flat[:-1]
                for i, part in zip(members, flat.split(
                        [grads[i].numel() for i in members])):
                    out[i] = part.view(grads[i].shape).to(grads[i].dtype)
        return out, loss_out

    def _summed(self, tensors, local, kind):
        """Σ over the leaves of ``local(i, tensor)`` (a 0-d float32 sum of
        leaf i's local elements), each leaf's summed over the ranks that
        hold its other shards: one all-reduce a set of axes."""
        plan = self.plan
        groups = _by_axes(plan.leaves, lambda l: tuple(
            a for a in plan.names if a in l.all_axes()))
        total = torch.zeros((), device=tensors[0].device if tensors
                            else None)
        for axes, idx in groups.items():
            part = torch.stack([local(i, tensors[i])
                                for i in idx]).sum().reshape(1)
            if axes:
                Engine.all_reduce(part, kind, group=Engine.axis_group(axes))
            total = total + part[0]
        return total

    def sq_norm(self, grads):
        return self._summed(grads, lambda i, g: torch.sum(
            torch.square(g.float())), "clip_norm")

    def dot(self, a, b):
        """Σ a·b over two per-parameter lists of this rank's shards (each
        entry shaped or raveled), every element of the whole parameters
        counted once: ``LBFGS``'s dot products under a mesh strategy."""
        return self._summed(a, lambda i, x: torch.sum(x * b[i]), "dot")

    def _map_lists(self, state, fn, shapes):
        if param_shaped(state, shapes):
            return fn(list(state))
        if isinstance(state, dict):
            return {k: self._map_lists(v, fn, shapes)
                    for k, v in state.items()}
        if isinstance(state, (list, tuple)) and not isinstance(
                state, torch.Tensor):
            return [self._map_lists(v, fn, shapes) for v in state]
        return state

    def _raveled(self, state, fn, numels):
        """``state`` with ``fn(list)`` applied to each list of one tensor a
        parameter whose i-th entry is raveled to [numels[i]] or [rows,
        numels[i]] (``LBFGS``'s history rows, previous weights and
        gradient); other entries pass as they are."""
        if isinstance(state, (list, tuple)) and len(state) == len(numels) \
                and all(isinstance(t, torch.Tensor) and t.ndim in (1, 2)
                        and t.shape[-1] == n for t, n in zip(state, numels)):
            return fn(list(state))
        if isinstance(state, dict):
            return {k: self._raveled(v, fn, numels) for k, v in state.items()}
        return state

    def _sharded(self) -> bool:
        return any(tuple(l.param.shape) != l.whole for l in self.plan.leaves)

    def shard_state(self, state):
        """A method state's whole parameter-shaped lists, and its lists
        raveled per parameter, cut to this rank's shards (lists already
        cut pass as they are)."""
        plan = self.plan
        whole = [l.whole for l in plan.leaves]

        def cut(ts):
            return [t if not isinstance(t, torch.Tensor) else
                    plan.cut(l, t.to(l.param.device)).clone(
                        memory_format=torch.contiguous_format)
                    for l, t in zip(plan.leaves, ts)]

        def cut_rows(ts):
            out = []
            for l, t in zip(plan.leaves, ts):
                rows = t.to(l.param.device).reshape((-1,) + l.whole)
                out.append(torch.stack([plan.cut(l, r).reshape(-1)
                                        for r in rows.unbind(0)])
                           .reshape(t.shape[:-1] + (-1,)))
            return out
        state = self._map_lists(state, cut, whole)
        if self._sharded():
            state = self._raveled(state, cut_rows,
                                  [math.prod(w) for w in whole])
        return state

    def remap(self, params, tree, world=None, rank=None):
        """A whole tree (parameters or a method state) cut for this rank
        of the mesh at hand, through host memory."""
        if world is not None or rank is not None:
            raise ValueError(f"{type(self).__name__}.remap cuts for this "
                             "rank of the Engine's mesh")
        return self.shard_state(_to_host(tree))

    def full_state(self, state):
        """A method state's parameter-shaped lists, and its lists raveled
        per parameter, gathered whole (collective)."""
        plan = self.plan
        local = [tuple(l.param.shape) for l in plan.leaves]
        state = self._map_lists(
            state, lambda ts: plan.gather_whole(ts, "opt_state"), local)
        if not self._sharded():
            return state

        def gather_rows(ts):
            # each history row is a parameter-shaped list of its own
            rows = max(1 if t.ndim == 1 else t.shape[0] for t in ts)
            out = [[] for _ in ts]
            for k in range(rows):
                shards = [(t if t.ndim == 1 else t[k]).reshape(s)
                          for t, s in zip(ts, local)]
                for i, w in enumerate(plan.gather_whole(shards,
                                                        "opt_state")):
                    out[i].append(w.reshape(-1))
            return [o[0] if t.ndim == 1 else torch.stack(o)
                    for o, t in zip(out, ts)]
        return self._raveled(state, gather_rows,
                             [math.prod(s) for s in local])


def _by_axes(leaves, axes_of):
    """{axes: indices of the leaves with those axes}, in leaf order."""
    groups = {}
    for i, l in enumerate(leaves):
        groups.setdefault(axes_of(l), []).append(i)
    return groups


def _to_host(tree):
    """``tree`` with every tensor and array a host tensor."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_host(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, np.ndarray):
        return torch.as_tensor(tree)
    return tree


class LayoutSharding(_MeshSharded):
    """The MeshLayout strategy (the reference's ``LayoutSharding``): every
    parameter cut by its role's spec over the data / fsdp / tp / pipe /
    expert axes of the Engine's mesh (``parallel/layout.py``
    ``assign_specs``), the batch split over data x fsdp.  FSDP: a leaf
    split over fsdp is gathered at each forward and its gradient
    reduce-scattered back (and gathered again for the backward).  TP: a
    Linear or attention kernel split over tp along its output features
    is not gathered; its layer computes its slice
    (``parallel/mesh_plan.py``).  Pipe: a pipeline's stage stack keeps
    1/p a pipe rank, which runs its own stages
    (``parallel/pipeline.py``).  Expert: a ``MoEFFN``'s tables keep E/e
    rows an expert rank, which runs its own experts
    (``parallel/expert.py``).
    On a plain data group (or a ``(W, 1, 1)`` layout) every leaf
    replicates: ``DataParallel``'s arithmetic.  The layout is the mesh's;
    ``layout`` only stands in on a mesh without the canonical axes.

    Traps: the clipping norm counts each element once (:meth:`sq_norm`);
    the fused update runs on the local shards, bit-equal to per-leaf;
    the gradient buckets cut :meth:`reduce`'s all-reduces; Dropout
    draws the same masks on the ranks of one tp group (they share the
    batch group's rank, which seeds the generator) and different ones
    across batch shards."""

    def __init__(self, model, layout=None, min_size: Optional[int] = None):
        self.model = model
        self.layout = layout
        self.min_size = min_size
        self.plan = None

    def _layout(self):
        from .layout import MeshLayout
        lay = MeshLayout.of_mesh(Engine.mesh())
        if lay is None:
            lay = self.layout
        if lay is None:
            lay = MeshLayout(data=Engine.group_size())
        return lay

    def specs(self, model):
        from .layout import assign_specs
        specs = _flatten(assign_specs(model, None, self._layout(),
                                      min_size=self.min_size),
                         leaf=lambda x: isinstance(x, tuple))
        by_id = {id(p): s for (_, p), s in zip(_leaf_paths(model), specs)}
        return [by_id[id(p)] for p in model.parameters()]


class TensorParallel(_MeshSharded):
    """The reference's rule-driven tensor parallelism over a ``model`` axis
    (``Engine.init(mesh_shape={"model": m, "data": d})``), the batch
    split over ``data``.  ``rule(path, leaf) -> spec`` (a tuple of None
    or axis names a dim, or None to replicate), ``path`` the leaf's keys
    in the reference's tree and ``leaf`` the parameter; the default rule
    splits the last axis of a 2-D+ weight of at least 2^16 elements that
    the axis divides.  A split leaf is gathered at use, except where its
    layer computes on the slice (a Linear split along dim 0, the
    attention's kernels along their last dim)."""

    TP_AXIS = "model"
    BATCH_AXES = ("data",)

    def __init__(self, rule=None):
        self.rule = rule
        self.plan = None

    def specs(self, model):
        mesh = Engine.mesh()
        names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
        n = int(mesh.shape[names.index("model")]) if "model" in names else 1

        def default_rule(path, leaf):
            if leaf.ndim >= 2 and leaf.shape[-1] % n == 0 and \
                    leaf.numel() >= 2 ** 16:
                return (None,) * (leaf.ndim - 1) + ("model",)
            return ()
        rule = self.rule or default_rule
        by_id = {}
        for path, p in _leaf_paths(model):
            s = rule(path, p)
            by_id[id(p)] = tuple(s) if s is not None else ()
        return [by_id[id(p)] for p in model.parameters()]


def _leaf_paths(model):
    """(path, parameter) of every leaf of ``model``'s reference-shaped
    tree (``utils/convert.py``), in its order: the path holds list
    indices and dict keys."""
    from ..utils.convert import _param_tree
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        else:
            out.append((path, t))
    walk(_param_tree(model, getattr), ())
    return out


def _flatten(tree, leaf=lambda x: False):
    if not leaf(tree) and isinstance(tree, dict):
        return [x for v in tree.values() for x in _flatten(v, leaf)]
    if not leaf(tree) and isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flatten(v, leaf)]
    return [tree]
