"""A model's parameters held as mesh shards, and the collectives that run it.

The runtime half of the mesh layouts (``parallel/layout.py`` gives the
specs; ``parallel/sharding.py``'s ``LayoutSharding`` and
``TensorParallel`` drive this module).  The reference compiles one SPMD
program and lets GSPMD place the collectives; PyTorch runs eagerly, so a
:class:`MeshPlan` does it by hand, every collective through ``Engine``
(counted in ``Engine.collectives()``):

- Between steps each rank holds only its shard of every parameter, as its
  spec cuts it (:meth:`MeshPlan.shard` replaces each ``Parameter``'s data
  in place, so the optimizer's list and its method state hold the
  shards).  A shard keeps the whole leaf's shape in ``_layout_whole`` and
  its cutter in ``_layout_cut`` (``utils/convert.py`` loads a whole tree
  into the shards with it).
- The shards are gathered at use, a unit at a time: a unit is a layer of
  a ``Sequential`` model (the LM's embeddings, each block, the head), or
  the whole model when it is no ``Sequential``.  At each forward of a
  unit (a forward pre-hook on it) its shards are gathered into the
  tensors its layers compute with and swapped into the modules'
  ``_parameters``; a forward hook puts the shards back.  The gather is
  one all-gather per group of axes and dtype of the unit (kind
  ``"params"``): a leaf is gathered over every axis of its spec but
  those whose rows its module computes with (``_Leaf.keep``): tp where
  its layer computes its slice, pipe for a pipeline's stage stack (the
  ``pipeline_stage`` role; each pipe rank runs its own stages,
  ``parallel/pipeline.py``) and expert for the tables of a module that
  takes its own rows (``mesh_rows``, as ``MoEFFN``: each expert rank
  runs its own experts, ``parallel/expert.py``).  Its backward is one
  reduce-scatter per such bucket (kind ``"grads"``), which runs once the
  unit's backward is done, so a unit's whole gradients live only until
  then; each shard's ``.grad`` is the sum over the batch ranks of the
  gather group, and a rank off coordinate 0 of a gathered non-batch axis
  (tp, model, pipe, expert) sends zeros, since those ranks computed the
  same gradient.  Under grad, a leaf that its layer uses only as one
  cast of the whole to the compute dtype (the class's
  ``COMPUTE_CAST``: ``Linear``'s weight, the attention's kernels, the
  expert tables) is swapped in as that cast, made once at the gather,
  and the layer's own ``.to`` finds it done.
- Re-gathered in the backward (FSDP's reshard after forward): while a
  unit's forward runs, ``torch.autograd.graph.saved_tensors_hooks``
  pack every tensor autograd saves whose storage is one of the tensors
  swapped in (a view of one: the plan registers their storages by
  address) as a handle to its bucket (:class:`_Saved`); the first unpack
  in the unit's backward gathers the bucket again (kind
  ``"params_bwd"``, one all-gather a bucket that saved a weight) and
  casts it as the forward did.  The copies belong to that forward's
  handles (:class:`_Copies`) and go when autograd frees them, once the
  unit's backward ran or the graph was dropped: a backward abandoned
  part way cannot hand a later step its weights.  So the whole tensors
  alive at once are one unit's, not every unit's.  :attr:`MeshPlan.held_peak` is the most
  whole bytes alive at once (each gathered tensor and each cast counted
  from its creation until it is freed, by a ``weakref.finalize``),
  beside :meth:`MeshPlan.gathered_bytes`.  Inside a segment that
  ``Optimizer.set_remat`` checkpoints the plan's hooks stand aside: the
  checkpoint keeps nothing of the unit's forward, and its recompute in
  the backward runs the unit's pre-hook again, which gathers the current
  shards (kind ``"params"``) in the forward's order on every rank; the
  recomputed copies live until that segment's backward is done, and the
  forward's gather node still reduce-scatters the gradients once.
- Tensor parallelism: a ``Linear`` whose ``weight`` is split over the tp
  axis along its output features (dim 0), and a ``MultiHeadAttention``
  whose four (E, E) kernels are split along their output features (the
  last dim) with the heads divisible, get ``_tp`` (a :class:`TpAxis`) and
  compute their own output features (``nn/linear.py``,
  ``nn/attention.py``).  The input enters through :meth:`TpAxis.enter`
  (the identity; the backward all-reduces the partial input gradients
  over tp in float32 and rounds them once, kind ``"tp_in"``; the product
  :meth:`TpAxis.matmul` keeps its input gradient in float32 for that),
  and the output features are all-gathered
  over tp (:meth:`TpAxis.gather`, kind ``"tp_out"``; the backward takes
  this rank's slice of the replicated gradient): Megatron's conjugate
  pair.  A bias the layer slices comes through :meth:`TpAxis.slice`,
  whose backward all-gathers the slices' gradients (kind ``"tp_bias"``).
  Everything after such a layer is computed alike on every rank of the
  tp group, on the same rows.
- :meth:`MeshPlan.whole` swaps in whole tensors (each leaf all-gathered
  over every axis of its spec, kind ``"whole"``) for a checkpoint, a
  comparison or a one-process copy; every rank calls it.
"""

from __future__ import annotations

import contextlib
import math
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..common import get_policy
from ..nn.linear import _mm_f32, matmul_f32
from ..utils import remat
from ..utils.engine import Engine

__all__ = ["MeshPlan", "TpAxis"]


class TpAxis:
    """The tensor-parallel axis of one layer: its process group, its width
    ``n`` and this rank's index ``rank`` on it."""

    def __init__(self, group, n: int, rank: int):
        self.group, self.n, self.rank = group, n, rank

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The carrier of ``x``'s gradient into :meth:`matmul`: ``x`` in
        float32, whose gradient (the float32 partial input gradients of
        this rank's output features) is all-reduced over the axis and
        rounded once to ``x``'s dtype, as one process rounds the whole
        product.  ``x`` itself where no gradient is wanted."""
        if not torch.is_grad_enabled():
            return x
        return _Enter.apply(self, x)

    def matmul(self, xe: torch.Tensor, x: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
        """``x[..., K] @ w[K, N]`` for ``x`` in ``w``'s dtype, accumulated
        and returned in float32 (``nn/linear.py``'s ``matmul_f32``); the
        input gradient goes to ``xe`` (``enter`` of ``x``) in float32,
        for :meth:`enter` to sum over the axis before it rounds.  The
        product saves ``x``, which the layer's other products share."""
        if not torch.is_grad_enabled():
            return matmul_f32(x, w)
        return _Matmul.apply(xe, x.detach(), w)

    def gather(self, x: torch.Tensor, dim: int = -1,
               kind: str = "tp_out") -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order; the
        gradient is this rank's slice."""
        return _Gather.apply(self, x, dim, kind)

    def slice(self, x: torch.Tensor, dim: int = -1,
              kind: str = "tp_bias") -> torch.Tensor:
        """This rank's slice of ``x`` (whole on every rank) along ``dim``;
        the gradient is all the ranks' slices gathered (counted under
        ``kind``)."""
        return _Slice.apply(self, x, dim, kind)

    def all_gather(self, x: torch.Tensor, dim: int, kind: str):
        x = x.contiguous()
        out = torch.empty((self.n,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        Engine.all_gather(out.view(-1), x.view(-1), kind, group=self.group)
        return torch.cat(out.unbind(0), dim=dim)

    def narrow(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        c = x.shape[dim] // self.n
        return x.narrow(dim, self.rank * c, c).contiguous()


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, x):
        ctx.ax, ctx.dtype = ax, x.dtype
        return x.float() if x.dtype != torch.float32 else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # the partial products are added in float32 and rounded once after
        # the sum (gloo's sum in bf16 rounds at every hop)
        s = g.float().contiguous()
        Engine.all_reduce(s, "tp_in", group=ctx.ax.group)
        return None, s.to(ctx.dtype)


class _Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xe, x, w):
        a2 = x.reshape(-1, x.shape[-1])
        ctx.save_for_backward(a2, w)
        ctx.shape = x.shape
        return _mm_f32(a2, w).reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        a2, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).to(w.dtype)
        # float32, not rounded: _Enter rounds after the sum over the axis
        gx = _mm_f32(g2, w.t()).reshape(ctx.shape) \
            if ctx.needs_input_grad[0] else None
        gw = _mm_f32(a2.t(), g2).to(w.dtype) if ctx.needs_input_grad[2] \
            else None
        return gx, None, gw


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, x, dim, kind):
        ctx.ax, ctx.dim = ax, dim
        return ax.all_gather(x, dim, kind)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.ax.narrow(g, ctx.dim), None, None


class _Slice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, x, dim, kind):
        ctx.ax, ctx.dim, ctx.kind = ax, dim, kind
        return ax.narrow(x, dim)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.ax.all_gather(g, ctx.dim, ctx.kind), None, None


def _tp_dims(module) -> Optional[dict]:
    """{parameter name: the dim its tp axis splits} of a layer that
    computes on tensor-parallel slices (its own forward, not a
    subclass's), else None."""
    from ..nn.attention import MultiHeadAttention
    from ..nn.linear import Linear
    for cls, dims in ((Linear, {"weight": 0}),
                      (MultiHeadAttention,
                       {n: -1 for n in ("wq", "wk", "wv", "wo")})):
        if isinstance(module, cls) and type(module).forward is cls.forward:
            return dims
    return None


def _cast_names(module) -> tuple:
    """The parameters ``module``'s forward uses only as one cast of the
    whole to the compute dtype: its class's ``COMPUTE_CAST``, where that
    class's forward is the one that runs."""
    for cls in type(module).__mro__:
        if "COMPUTE_CAST" in cls.__dict__:
            return cls.COMPUTE_CAST if type(module).forward is cls.forward \
                else ()
    return ()


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class _Leaf:
    """One parameter under a plan: its module and name, the ``Parameter``,
    the whole shape, the wide mesh axes of each dim (in spec order), the
    dim its layer keeps split over tp (or None) and whether its layer
    computes with its cast to the compute dtype (``cast``)."""

    def __init__(self, module, name, param, spec, sizes):
        self.module, self.name, self.param = module, name, param
        self.whole = tuple(param.shape)
        self.cast = name in _cast_names(module)
        spec = tuple(spec) + (None,) * (len(self.whole) - len(spec))
        self.axes = [tuple(a for a in _axes_of(e) if sizes.get(a, 1) > 1)
                     for e in spec]
        self.local_dim: Optional[int] = None
        # the axes whose rows the module computes on (never gathered):
        # tp on ``local_dim``, pipe on a stage stack, expert on a table
        self.keep: set = set()
        for d, axes in enumerate(self.axes):
            n = math.prod(sizes[a] for a in axes)
            if self.whole[d] % n:
                raise ValueError(f"{type(module).__name__}.{name}: dim {d} "
                                 f"({self.whole[d]}) does not split over "
                                 f"{axes}")

    def all_axes(self) -> set:
        return {a for axes in self.axes for a in axes}

    def gathered(self, names) -> tuple:
        """The axes this leaf is gathered over at use, in mesh order."""
        return tuple(a for a in names if a in self.all_axes()
                     and a not in self.keep)


class _Geom:
    """How one leaf's chunks over a group of axes ``gathered`` (in mesh
    order) assemble into the tensor they form, and back."""

    def __init__(self, leaf: _Leaf, gathered: Tuple[str, ...], sizes):
        G = list(gathered)
        nd = len(leaf.whole)
        self.local = tuple(leaf.whole[d] // math.prod(
            sizes[a] for a in leaf.axes[d]) for d in range(nd))
        perm, split, out = [], [], []
        for d in range(nd):
            ga = [a for a in leaf.axes[d] if a in gathered]
            perm += [G.index(a) for a in ga] + [len(G) + d]
            split += [sizes[a] for a in ga] + [self.local[d]]
            out.append(self.local[d] * math.prod(sizes[a] for a in ga))
        self.view = tuple(sizes[a] for a in G) + self.local
        self.perm, self.split, self.shape = perm, tuple(split), tuple(out)
        self.inv = [perm.index(i) for i in range(len(perm))]
        self.n = math.prod(sizes[a] for a in G)
        self.numel = math.prod(self.local)

    def assemble(self, chunks: torch.Tensor) -> torch.Tensor:
        """[n, local numel] chunks in group-rank order -> the tensor."""
        return chunks.reshape(self.view).permute(self.perm).reshape(
            self.shape)

    def disassemble(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor -> [n, local numel] chunks in group-rank order."""
        return t.reshape(self.split).permute(self.inv).reshape(self.n, -1)


class _Bucket:
    """The leaves gathered over one group of axes, of one dtype."""

    def __init__(self, plan, gathered, leaves):
        self.plan, self.gathered, self.leaves = plan, gathered, leaves
        self.unit = leaves[0].unit
        self.geoms = [_Geom(l, gathered, plan.sizes) for l in leaves]
        self.group = Engine.axis_group(gathered)
        self.n = self.geoms[0].n
        self.sizes = [g.numel for g in self.geoms]
        # a rank off coordinate 0 of a gathered non-batch axis holds a
        # gradient its peers there hold too: it contributes zeros
        self.contributes = all(plan.coord[a] == 0 for a in gathered
                               if a not in plan.batch_axes)

    def gather(self, shards: Sequence[torch.Tensor], kind: str):
        send = torch.cat([s.reshape(-1) for s in shards])
        out = torch.empty((self.n, send.numel()), dtype=send.dtype,
                          device=send.device)
        Engine.all_gather(out.view(-1), send, kind, group=self.group)
        parts = out.split(self.sizes, dim=1)
        return [g.assemble(p) for g, p in zip(self.geoms, parts)]

    def scatter_grads(self, grads):
        dtype, device = self.leaves[0].param.dtype, self.leaves[0].param.device
        send = torch.empty((self.n, sum(self.sizes)), dtype=dtype,
                           device=device)
        off = 0
        for g, geom, size in zip(grads, self.geoms, self.sizes):
            dst = send[:, off:off + size]
            if g is None or not self.contributes:
                dst.zero_()
            else:
                dst.copy_(geom.disassemble(g))
            off += size
        recv = torch.empty(sum(self.sizes), dtype=dtype, device=device)
        Engine.reduce_scatter(recv, send.view(-1), "grads", group=self.group)
        return [p.view(geom.local) for p, geom in
                zip(recv.split(self.sizes), self.geoms)]

    def computed(self, tensors, dtypes) -> list:
        """The gathered ``tensors`` as the layers compute with them: each
        cast to its ``dtypes`` entry where it has one (each cast counted
        in ``held_peak``)."""
        out = []
        for t, d in zip(tensors, dtypes):
            if d is not None:
                t = t.to(d)
                self.plan._hold(t)
            out.append(t)
        return out


class _GatherParams(torch.autograd.Function):
    """A bucket's shards -> the gathered tensors; the backward
    reduce-scatters their gradients back to the shards."""

    @staticmethod
    def forward(ctx, bucket, *shards):
        ctx.bucket = bucket
        out = tuple(bucket.gather(shards, "params"))
        for t in out:
            bucket.plan._hold(t)
        return out

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + tuple(ctx.bucket.scatter_grads(grads))


class _Copies:
    """What one forward of a bucket swapped in, for its backward: the
    dtype of each leaf's cast (None: its own) and the tensors gathered
    again and cast so (None until the first unpack).  Only the handles
    packed in that forward hold it, so the copies go with them: with the
    graph's saved tensors once its backward ran or it was dropped, and
    a later step can never compute with them."""

    __slots__ = ("bucket", "dtypes", "tensors")

    def __init__(self, bucket, dtypes):
        self.bucket, self.dtypes, self.tensors = bucket, dtypes, None


class _Saved:
    """A saved tensor packed as a handle to its forward's
    :class:`_Copies`: the index of the tensor swapped in whose storage it
    views, and the view."""

    __slots__ = ("copies", "i", "size", "stride", "offset")

    def __init__(self, copies, i, t):
        self.copies, self.i = copies, i
        self.size, self.stride = t.size(), t.stride()
        self.offset = t.storage_offset()


class MeshPlan:
    """A model's parameters sharded over the Engine's mesh by per-leaf
    specs (module docstring).  ``specs`` is one spec a parameter, in
    ``model.parameters()`` order; ``tp_axis`` names the axis a capable
    layer computes its slice over; ``batch_axes`` those the batch splits
    over."""

    def __init__(self, model, specs: Sequence[tuple], tp_axis: str,
                 batch_axes: Sequence[str]):
        mesh = Engine.mesh()
        names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
        if len(names) < 2 and Engine.group() is not None:
            # a plain data group: the batch splits over it, nothing else
            names, shape = ("data",), (Engine.group_size(),)
            self.coord = {"data": Engine.group_rank()}
        else:
            shape = tuple(int(n) for n in mesh.shape)
            self.coord = Engine.mesh_coordinate()
        self.model, self.mesh, self.names = model, mesh, names
        self.sizes = dict(zip(names, shape))
        self.tp_axis = tp_axis
        self.batch_axes = tuple(a for a in batch_axes
                                if self.sizes.get(a, 1) > 1)
        owner = {}
        for m in model.modules():
            for n, p in m.named_parameters(recurse=False):
                owner[id(p)] = (m, n)
        params = list(model.parameters())
        if len(specs) != len(params):
            raise ValueError(f"{len(specs)} specs for {len(params)} "
                             "parameters")
        self.leaves = [_Leaf(*owner[id(p)], p, s, self.sizes)
                       for p, s in zip(params, specs)]
        self._mark_tp()
        self._mark_rows()
        self.units = self._mark_units()
        self._buckets = self._make_buckets(lambda l: l.gathered(names))
        # whole tensors swapped in for a block (whole(), materialized()):
        # the units' hooks stand aside
        self._held = self._is_whole = False
        self._hooks = []
        # a unit's saved-tensor hooks while its forward runs (None where
        # grad is off), and the storages of the tensors swapped in for it
        # (address -> (bucket, index, dtype))
        self._saving: List = []
        self._wholes: Dict[int, tuple] = {}
        # bytes of whole tensors alive now, their most since the last
        # reset_held(), and the storages counted (address -> [bytes,
        # counted tensors alive on it])
        self._live = self.held_peak = 0
        self._counted: Dict[int, list] = {}

    # -- planning ----------------------------------------------------------

    def _mark_tp(self):
        """Give ``_tp`` to each capable layer whose leaves the specs split
        over tp where it computes its slice.  A pipeline stage's layers
        hold ``pipeline_stage`` leaves (pipe rows alone) and are never
        marked, nor is a ``MoEFFN`` (its tables never split over tp)."""
        n = self.sizes.get(self.tp_axis, 1)
        by_module: Dict[int, List[_Leaf]] = {}
        for l in self.leaves:
            by_module.setdefault(id(l.module), []).append(l)
        for leaves in by_module.values():
            m = leaves[0].module
            m.__dict__.pop("_tp", None)
            dims = _tp_dims(m)
            if n == 1 or dims is None:
                continue
            named = {l.name: l for l in leaves}
            ok = all(k in named and named[k].axes[d] == (self.tp_axis,)
                     for k, d in dims.items())
            if ok and hasattr(m, "tp_ok"):
                ok = m.tp_ok(n)
            if not ok:
                continue
            for k, d in dims.items():
                named[k].local_dim = d % len(named[k].whole)
                named[k].keep.add(self.tp_axis)
            m._tp = TpAxis(Engine.axis_group(self.tp_axis), n,
                           self.coord[self.tp_axis])

    def _mark_rows(self):
        """Where a leaf's dim 0 splits over pipe or expert, it keeps the
        axis if its module computes with this rank's rows.  In the role
        table (``parallel/layout.py``) only a pipeline's stage stack
        (``pipeline_stage``) splits over pipe, and the pipeline reads the
        rows it is given (``parallel/pipeline.py``): it always keeps
        them.  Over expert only ``expert_table`` leaves split; a module
        that computes on its own rows says which (``mesh_rows(plan) ->
        {name: axis}``, which binds what the module needs of the plan, as
        ``MoEFFN``'s); the others are gathered."""
        for l in self.leaves:
            if l.axes and l.axes[0] == ("pipe",):
                l.keep.add("pipe")
        for m in self.model.modules():
            bind = getattr(m, "mesh_rows", None)
            if bind is not None:
                for name, axis in bind(self).items():
                    self.leaf(m, name).keep.add(axis)

    def leaf(self, module, name: str) -> Optional[_Leaf]:
        """The leaf of ``module``'s parameter ``name``, or None."""
        for l in self.leaves:
            if l.module is module and l.name == name:
                return l
        return None

    def axis(self, axes: Sequence[str]) -> Optional[TpAxis]:
        """A :class:`TpAxis` over the mesh axes ``axes`` (this rank's
        index on them row-major), or None where they are one wide: the
        group of the ranks that share this rank's other coordinates (an
        expert group is the one of this rank's tp and pipe coordinates)."""
        n = math.prod(self.sizes.get(a, 1) for a in axes)
        if n == 1:
            return None
        rank = 0
        for a in axes:
            rank = rank * self.sizes[a] + self.coord[a]
        return TpAxis(Engine.axis_group(tuple(axes)), n, rank)

    def _mark_units(self) -> list:
        """Set each leaf's ``unit`` (module docstring); the units, in
        order."""
        from ..nn.containers import Sequential
        unit_of = {}
        if type(self.model) is Sequential:
            for u in self.model.layers:
                for m in u.modules():
                    unit_of.setdefault(id(m), u)
        units = []
        for l in self.leaves:
            l.unit = unit_of.get(id(l.module), self.model)
            if l.unit not in units:
                units.append(l.unit)
        return units

    def _make_buckets(self, gathered_of):
        groups: Dict[tuple, List[_Leaf]] = {}
        for l in self.leaves:
            g = gathered_of(l)
            if g:
                groups.setdefault((id(l.unit), g, l.param.dtype),
                                  []).append(l)
        return [_Bucket(self, g, ls) for (_, g, _), ls in groups.items()]

    def gathered_bytes(self) -> List[int]:
        """Bytes a forward gathers whole, one entry a unit (in order)."""
        out = {id(u): 0 for u in self.units}
        for b in self._buckets:
            out[id(b.unit)] += sum(math.prod(g.shape) for g in b.geoms) * \
                b.leaves[0].param.element_size()
        return list(out.values())

    def reset_held(self) -> None:
        """Start :attr:`held_peak` over from the bytes alive now."""
        self.held_peak = self._live

    def _hold(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage (a whole tensor's, or a cast's of one)
        among the whole bytes alive until the last counted tensor on it
        is freed (``held_peak``: the most at once); views of one storage
        count it once."""
        st = t.untyped_storage()
        key = st.data_ptr()
        entry = self._counted.get(key)
        if entry is None:
            entry = self._counted[key] = [st.nbytes(), 0]
            self._live += entry[0]
            self.held_peak = max(self.held_peak, self._live)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        entry = self._counted.get(key)
        if entry is not None:
            entry[1] -= 1
            if entry[1] == 0:
                del self._counted[key]
                self._live -= entry[0]

    def _pack(self, t: torch.Tensor):
        """A tensor autograd saves in a unit's forward: a view of a tensor
        swapped in becomes a :class:`_Saved` handle, anything else stays
        as it is."""
        found = self._wholes.get(t.untyped_storage().data_ptr())
        if found is None or found[2] != t.dtype:
            return t
        return _Saved(found[0], found[1], t)

    def _unpack(self, x):
        if not isinstance(x, _Saved):
            return x
        c = x.copies
        if c.tensors is None:
            b = c.bucket
            with torch.no_grad():
                whole = b.gather([l.param.detach() for l in b.leaves],
                                 "params_bwd")
                for t in whole:
                    self._hold(t)
                c.tensors = b.computed(whole, c.dtypes)
        return c.tensors[x.i].as_strided(x.size, x.stride, x.offset)

    def tp_modules(self) -> list:
        """The modules that compute on tensor-parallel slices."""
        seen = []
        for l in self.leaves:
            if l.local_dim is not None and l.module not in seen:
                seen.append(l.module)
        return seen

    # -- the shards --------------------------------------------------------

    def cut(self, leaf: _Leaf, t: torch.Tensor, keep_local=False):
        """``t`` (whole) cut to this rank's shard of ``leaf``; with
        ``keep_local`` only over the axes the layer does not compute on
        (the tensor the layer computes with)."""
        for d, axes in enumerate(leaf.axes):
            if keep_local and d == leaf.local_dim:
                axes = tuple(a for a in axes if a != self.tp_axis)
            if not axes:
                continue
            idx = 0
            for a in axes:
                idx = idx * self.sizes[a] + self.coord[a]
            c = t.shape[d] // math.prod(self.sizes[a] for a in axes)
            t = t.narrow(d, idx * c, c)
        return t

    @torch.no_grad()
    def shard(self):
        """Replace every parameter's data by this rank's shard of it (the
        ranks' whole parameters must agree), and arm the forward hooks."""
        for l in self.leaves:
            p = l.param
            if getattr(p, "_layout_whole", None) is not None:
                raise RuntimeError(f"{type(l.module).__name__}.{l.name} is "
                                   "sharded already")
            p.data = self.cut(l, p.data).clone(
                memory_format=torch.contiguous_format)
            p._layout_whole = torch.Size(l.whole)
            p._layout_cut = (lambda t, l=l: self.cut(l, t))
        for u in self.units:
            buckets = [b for b in self._buckets if b.unit is u]
            if buckets:
                self._hooks += [
                    u.register_forward_pre_hook(
                        lambda m, a, bs=buckets: self._pre(bs)),
                    u.register_forward_hook(
                        lambda m, a, o, bs=buckets: self._post(bs),
                        always_call=True)]
        return self

    def local_elements(self) -> int:
        """Elements of the parameter shards this rank holds."""
        return sum(l.param.numel() for l in self.leaves)

    # -- the forward ---------------------------------------------------------

    def _swap(self, tensors):
        for l, t in tensors:
            l.module._parameters[l.name] = t

    def _pre(self, buckets):
        if self._held:
            return
        grad = torch.is_grad_enabled()
        self._swap(self._materialized(buckets, grad))
        hooks = None
        # inside a checkpointed segment (``Optimizer.set_remat``) the
        # checkpoint's own hooks keep nothing of the forward, and its
        # recompute runs this hook again: the weights are gathered anew,
        # in the forward's order, for that segment's backward alone
        if grad and not remat.active():
            hooks = torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                             self._unpack)
            hooks.__enter__()
        self._saving.append(hooks)

    def _post(self, buckets):
        if self._held:
            return
        self._swap([(l, l.param) for b in buckets for l in b.leaves])
        self._wholes = {k: v for k, v in self._wholes.items()
                        if v[0].bucket not in buckets}
        hooks = self._saving.pop() if self._saving else None
        if hooks is not None:
            hooks.__exit__(None, None, None)

    def _materialized(self, buckets, grad: bool = False):
        """The (leaf, tensor) pairs a forward swaps in.  Under ``grad``
        each leaf its layer computes cast comes as that cast, and the
        tensors' storages are registered for :meth:`_pack` with this
        forward's :class:`_Copies`."""
        out = []
        c = get_policy().compute_dtype
        for b in buckets:
            ts = _GatherParams.apply(b, *[l.param for l in b.leaves])
            if grad:
                copies = _Copies(b, [c if l.cast and l.param.dtype != c
                                     else None for l in b.leaves])
                ts = b.computed(ts, copies.dtypes)
                for i, t in enumerate(ts):
                    self._wholes.setdefault(t.untyped_storage().data_ptr(),
                                            (copies, i, t.dtype))
            out += list(zip(b.leaves, ts))
        return out

    @contextlib.contextmanager
    def _holding(self, tensors, whole=False):
        """``tensors`` swapped in for the block, the units' hooks aside;
        what was in before is put back."""
        before = [(l, l.module._parameters[l.name]) for l in self.leaves]
        held, was_whole = self._held, self._is_whole
        self._held, self._is_whole = True, whole or was_whole
        self._swap(tensors)
        try:
            yield self
        finally:
            self._swap(before)
            self._held, self._is_whole = held, was_whole

    @contextlib.contextmanager
    def materialized(self):
        """Every unit's gathered tensors swapped in for the block (a decode
        loop that calls the layers itself)."""
        if self._held:
            yield self
            return
        with self._holding(self._materialized(self._buckets)):
            yield self

    @torch.no_grad()
    def gather_whole(self, shards: Optional[Sequence[torch.Tensor]] = None,
                     kind: str = "whole") -> List[torch.Tensor]:
        """Whole tensors of per-parameter ``shards`` shaped like this rank's
        parameter shards (default: the parameters; a method state's slot
        too), in parameter order: each leaf all-gathered over every axis
        of its spec, one call a group of axes and dtype (collective:
        every rank calls it)."""
        if shards is None:
            shards = [l.param.detach() for l in self.leaves]
        out = list(shards)
        groups: Dict[tuple, list] = {}
        for i, (l, t) in enumerate(zip(self.leaves, shards)):
            g = tuple(a for a in self.names if a in l.all_axes())
            if g:
                groups.setdefault((g, t.dtype), []).append(i)
        for (g, _), idx in groups.items():
            b = _Bucket(self, g, [self.leaves[i] for i in idx])
            for i, t in zip(idx, b.gather([shards[i] for i in idx], kind)):
                out[i] = t
        return out

    @contextlib.contextmanager
    def whole(self):
        """Whole parameters swapped into the modules for the block (every
        rank enters it together); re-entrant."""
        if self._is_whole:
            yield self
            return
        with self._holding(list(zip(self.leaves, self.gather_whole())),
                           whole=True):
            yield self
