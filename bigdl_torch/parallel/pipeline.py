"""Pipeline parallelism: microbatched stages over the ranks of a ``pipe`` axis.

Counterpart of ``bigdl_tpu/parallel/pipeline.py``.  The model is a stack
of structurally identical stages (the SPMD-pipeline restriction: N
transformer blocks, say).  Their parameters are stacked along a new
leading axis of ``n·v`` rows (n pipe ranks, v virtual stages each) in the
reference's device-major order (``schedule.stack_index``): the parameter
tree of :class:`GPipeSequential` is the reference's stacked tree, leaf for
leaf.  A stage runs with its row k through ``torch.func.functional_call``
on one stage module, so its gradients land in the stacked ``.grad``.

Without a ``pipe`` axis wider than one (one card) the stages run one
after another off the stacked rows: the same math as the unpartitioned
model, bit for bit.  On a ``pipe`` axis of n > 1 ranks
(``Engine.init(mesh_shape={"pipe": n})``) :func:`pipeline_apply_scheduled`
executes the reference's schedule table (``parallel/schedule.py``) tick
by tick as one ``torch.autograd.Function``: each rank runs the stage
slices it owns (global stage s on rank ``s mod n``), and one hop per
direction per tick carries activations to the next rank and cotangents
to the previous one (``parallel/hops.py``).  Two schedules
(``BIGDL_TORCH_PIPE_SCHEDULE``):

- **gpipe**: the forward table keeps every stage's autograd graph; the
  backward is its transpose, tick by tick in reverse with the cotangents
  moving the other way (what ``jax.grad`` makes of the reference's scan).
  Every microbatch's activations stay live until the backward: ``m·v``
  per rank.
- **1f1b**: the forward runs the same table keeping only (params, x), as
  the reference's ``custom_vjp``.  The backward runs the combined 1F1B
  table: its forwards recompute each stage from its stashed input,
  keeping that stage's graph until its backward, which pulls the
  cotangent through it.  The live stash never holds more than the
  table's ``peak_inflight`` stage inputs (counted, :attr:`GPipeSequential
  .last_peak_stash`).

Around the schedule, as the reference's ``_bcast_from``: the last stage's
output is broadcast to every pipe rank, so the rest of the model computes
the same loss on every rank; in the backward the last stage takes its own
rank's cotangent (every rank holds the same one, none is summed), and the
first stage's input gradient is broadcast back, so the layers before the
pipeline get the same gradients everywhere.  Two routes for the stack:

- replicated (a ``pipe`` mesh without a strategy): every rank holds the
  whole stack; the stacked gradients are summed over the pipe group
  before the Function returns them, since each row is nonzero on its
  owner only, and every rank applies the same update.
- sharded (``LayoutSharding`` on a layout with ``pipe`` > 1, such as
  (2,1,1,2,1) or (1,2,1,2,1): the ``pipeline_stage`` role): each rank
  holds its v rows of the stack, the reference's 1/n a device
  (``parallel/mesh_plan.py`` never gathers them over pipe), and the
  stage function reads them.  Each row's gradient is its owner's alone,
  so nothing is summed over pipe; the strategy sums it over the batch
  axes.  The pipe group is this rank's row of the mesh: each ``(data,
  fsdp, tp, expert)`` coordinate runs its own pipeline on its own rows
  of the batch, its hops inside its own group.  Beside a wide ``tp`` a
  stage's layers hold pipe rows only and compute every head (the
  reference's stack is not split over tp); the tp ranks of one stage
  run the same rows, and the tp collectives of the layers around the
  pipeline come before and after its hops, in one order on every rank.
  The route follows the stack's leading axis (n·v rows whole, v rows
  this rank's).
"""

from __future__ import annotations

import copy
import logging
from typing import Callable, List, Optional, Sequence

import torch
from torch.func import functional_call
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..nn.dropout import dropout_rng
from ..nn.module import Container, Module
from ..utils import config as _config
from ..utils import remat as _remat
from . import schedule as schedule_mod
from .hops import AxisGroup, axis_group
from .schedule import (BWD, FWD, IDLE, build_schedule, bubble_fraction,
                       stack_index, stage_of_stack_index)

logger = logging.getLogger("bigdl_torch")

__all__ = ["pipeline_apply", "pipeline_apply_scheduled", "stack_stage_params",
           "GPipeSequential", "partition_pipeline", "PipelinePartitionError",
           "pipe_microbatches", "pipe_schedule", "pipe_virtual_stages",
           "bubble_fraction"]


class PipelinePartitionError(TypeError):
    """A model cannot be partitioned into pipeline stages (children do
    not split into structurally identical groups, a stage carries
    running state, or the stage count disagrees with the ``pipe`` axis).
    Typed and loud: a silently unpartitioned model would train replicated
    and defeat the pipeline."""


def pipe_microbatches() -> int:
    """``BIGDL_TORCH_PIPE_MICROBATCHES``: microbatches a pipelined step
    splits its batch into (default 4).  More microbatches shrink the
    bubble, (n-1)/(m+n-1) under gpipe, at the cost of smaller products."""
    return max(1, _config.get_int("PIPE_MICROBATCHES", 4))


def pipe_schedule() -> str:
    """``BIGDL_TORCH_PIPE_SCHEDULE``: ``gpipe`` (default: the forward
    table, its transpose as the backward) or ``1f1b`` (the combined
    table, in-flight activations bounded by its stash)."""
    val = _config.get_str("PIPE_SCHEDULE", "gpipe").strip().lower() or "gpipe"
    if val not in schedule_mod.SCHEDULES:
        raise ValueError(
            f"BIGDL_TORCH_PIPE_SCHEDULE={val!r}: expected one of "
            f"{schedule_mod.SCHEDULES}")
    return val


def pipe_virtual_stages() -> int:
    """``BIGDL_TORCH_PIPE_VIRTUAL_STAGES``: stage slices per pipe rank
    (default 1).  v > 1 gives each rank v non-contiguous slices of the
    stack (Megatron interleaving), cutting the 1F1B bubble by ~1/v at the
    cost of v trips around the ring per microbatch."""
    return max(1, _config.get_int("PIPE_VIRTUAL_STAGES", 1))


def stack_stage_params(param_list):
    """Stack per-stage parameter trees (identical structure: dicts,
    lists or tensors) along a new leading stage axis."""
    flats = [tree_flatten(p) for p in param_list]
    spec = flats[0][1]
    if any(s != spec for _, s in flats[1:]):
        raise PipelinePartitionError("stage parameter trees differ in "
                                     "structure")
    leaves = [torch.stack([f[i] for f, _ in flats])
              for i in range(len(flats[0][0]))]
    return tree_unflatten(leaves, spec)


# -- the schedule executor -------------------------------------------------

class _Run:
    """One pipelined call: the stage function, the axis, the tables and
    what the call leaves for its caller (the live stash's peak)."""

    def __init__(self, stage_fn, spec, axis: AxisGroup, schedule: str,
                 m: int, v: int, remat: bool, needs_grad: bool,
                 stats: Optional[dict], local: bool):
        self.stage_fn, self.spec, self.axis = stage_fn, spec, axis
        self.schedule, self.m, self.v, self.remat = schedule, m, v, remat
        self.needs_grad = needs_grad
        self.fwd_tbl = build_schedule("gpipe", axis.n, m, v)
        self.bwd_tbl = (build_schedule("1f1b", axis.n, m, v)
                        if schedule == "1f1b" else None)
        self.stats = stats if stats is not None else {}
        # the leaves hold this rank's v rows, not the whole stack
        self.local = local

    def row(self, j: int, d: int) -> int:
        """The leaves' row of slice j on pipe rank d: its
        ``stack_index`` in the whole stack, j in this rank's rows."""
        return j if self.local else stack_index(j * self.axis.n + d,
                                                self.axis.n, self.v)

    def run(self, leaves, k: int, x):
        """Stage row k on the microbatch x (checkpointed under remat)."""
        p = tree_unflatten([leaf[k] for leaf in leaves], self.spec)
        if self.remat and torch.is_grad_enabled():
            return _remat.checkpointed(lambda a: self.stage_fn(p, a), "full",
                                       None, x)
        return self.stage_fn(p, x)

    def graph(self, leaves, k: int, x, x_grad: bool):
        """Stage row k on x with its autograd graph kept: (leaf rows,
        input, output), the rows and the input fresh leaves, the input
        one that takes a gradient where ``x_grad``."""
        rows = [leaf[k].detach().requires_grad_(leaf.requires_grad)
                for leaf in leaves]
        xl = x.detach().requires_grad_(x_grad)
        p = tree_unflatten(rows, self.spec)
        with torch.enable_grad():
            if self.remat:
                y = _remat.checkpointed(lambda a: self.stage_fn(p, a),
                                        "full", None, xl)
            else:
                y = self.stage_fn(p, xl)
        return rows, xl, _shaped(y, x)

    def pull(self, rec, g, grads, k: int):
        """Backpropagate g through a kept graph: row k's gradients into
        ``grads``; returns the input's gradient (None without one)."""
        rows, xl, y = rec
        want = [r for r in rows if r.requires_grad]
        inputs = want + ([xl] if xl.requires_grad else [])
        got = torch.autograd.grad(y, inputs, g, allow_unused=True)
        it = iter(got)
        for r, G in zip(rows, grads):
            if r.requires_grad:
                gr = next(it)
                if gr is not None:
                    G[k] += gr
        return next(it) if xl.requires_grad else None


def _shaped(y, x):
    if y.shape != x.shape:
        raise PipelinePartitionError(
            f"a pipeline stage maps {tuple(x.shape)} to {tuple(y.shape)}; "
            "stages must preserve their input's shape")
    return y.to(x.dtype)


def _forward_table(run: _Run, leaves, x, keep_graph: bool):
    """Execute the forward-only table; returns (this rank's stage
    outputs by microbatch, the kept graphs by tick)."""
    tbl, ax = run.fwd_tbl, run.axis
    n, m, T, d, v = tbl.n_devices, tbl.microbatches, tbl.ticks, ax.rank, run.v
    trash = tbl.fstash_slots
    micro = list(x.chunk(m))
    fstash: List = [None] * (trash + 1)
    outs: List = [None] * m
    graphs = {}
    for t in range(T):
        y = None
        if tbl.act[t][d] == FWD:
            j, i = tbl.slice_idx[t][d], tbl.mb[t][d]
            k = run.row(j, d)
            if tbl.fwd_feed[t][d]:
                xin = micro[i]
            else:
                slot = tbl.fwd_in_slot[t][d]
                xin, fstash[slot] = fstash[slot], None
            if keep_graph:
                # a stage input from the previous stage takes a gradient
                graphs[t] = run.graph(leaves, k, xin, x.requires_grad
                                      or not tbl.fwd_feed[t][d])
                y = graphs[t][2].detach()
            else:
                y = _shaped(run.run(leaves, k, xin), xin)
            if tbl.out_idx[t][d] != m:
                outs[i] = y
        if t + 1 < T:
            send = tbl.recv_f_slot[t + 1][(d + 1) % n] != trash
            slot = tbl.recv_f_slot[t + 1][d]
            got = ax.hop([(y, 1, 0)] if send else [],
                         [(micro[0], -1, 0)] if slot != trash else [],
                         "pipe")
            if slot != trash:
                fstash[slot] = got[0]
    return outs, graphs


def _gpipe_backward(run: _Run, leaves, graphs, gy_micro):
    """The forward table's transpose, tick by tick in reverse: returns
    (stacked gradients, this rank's input gradients by microbatch)."""
    tbl, ax = run.fwd_tbl, run.axis
    n, m, T, d, v = tbl.n_devices, tbl.microbatches, tbl.ticks, ax.rank, run.v
    trash = tbl.fstash_slots
    grads = [torch.zeros_like(leaf) for leaf in leaves]
    gstash: List = [None] * (trash + 1)
    dx: List = [None] * m
    g_y = None
    for t in reversed(range(T)):
        if t + 1 < T:
            # the transpose of tick t+1's hop: the cotangent of what this
            # rank received goes back to the previous rank, and that of
            # what it sent at t comes from the next
            slot = tbl.recv_f_slot[t + 1][d]
            back = None
            if slot != trash:
                back, gstash[slot] = gstash[slot], None
            want = tbl.recv_f_slot[t + 1][(d + 1) % n] != trash
            got = ax.hop([(back, -1, 1)] if back is not None else [],
                         [(gy_micro[0], 1, 1)] if want else [], "pipe")
            g_y = got[0] if want else None
        if tbl.act[t][d] != FWD:
            continue
        j, i = tbl.slice_idx[t][d], tbl.mb[t][d]
        k = run.row(j, d)
        g = gy_micro[i] if tbl.out_idx[t][d] != m else g_y
        gx = run.pull(graphs.pop(t), g, grads, k)
        if gx is not None:
            gx = gx.to(gy_micro[0].dtype)
        if tbl.fwd_feed[t][d]:
            dx[i] = gx
        else:
            gstash[tbl.fwd_in_slot[t][d]] = gx
    return grads, dx


def _one_f_one_b(run: _Run, leaves, x, gy_micro):
    """Execute the combined 1F1B table: returns (stacked gradients, this
    rank's input gradients by microbatch); records the live stash's
    peak in ``run.stats["peak_stash"]``."""
    tbl, ax = run.bwd_tbl, run.axis
    n, m, T, d, v = tbl.n_devices, tbl.microbatches, tbl.ticks, ax.rank, run.v
    trash_f, trash_b = tbl.fstash_slots, tbl.bstash_slots
    micro = list(x.chunk(m))
    grads = [torch.zeros_like(leaf) for leaf in leaves]
    # a stage input, then (once its forward ran) the stage's kept graph
    fstash: List = [None] * (trash_f + 1)
    bstash: List = [None] * (trash_b + 1)
    dx: List = [None] * m
    peak = 0
    for t in range(T):
        y_send = g_send = None
        free = None
        a = tbl.act[t][d]
        if a != IDLE:
            j, i = tbl.slice_idx[t][d], tbl.mb[t][d]
            k = run.row(j, d)
        if a == FWD:
            if tbl.fwd_feed[t][d]:
                xin, slot = micro[i], tbl.fwd_store_slot[t][d]
            else:
                slot = tbl.fwd_in_slot[t][d]
                xin = fstash[slot]
            rec = run.graph(leaves, k, xin, x.requires_grad
                            or not tbl.fwd_feed[t][d])
            fstash[slot] = rec
            y_send = rec[2].detach()
        elif a == BWD:
            free = tbl.bwd_x_slot[t][d]
            if tbl.bwd_feed[t][d]:
                g = gy_micro[i]
            else:
                g, bstash[tbl.bwd_in_slot[t][d]] = \
                    bstash[tbl.bwd_in_slot[t][d]], None
            gx = run.pull(fstash[free], g, grads, k)
            if gx is not None:
                gx = gx.to(gy_micro[0].dtype)
            if tbl.dx_idx[t][d] != m:
                dx[i] = gx
            g_send = gx
        peak = max(peak, sum(s is not None for s in fstash[:trash_f]))
        if free is not None:
            fstash[free] = None
        if t + 1 < T:
            fslot, bslot = tbl.recv_f_slot[t + 1][d], tbl.recv_b_slot[t + 1][d]
            sends = []
            if tbl.recv_f_slot[t + 1][(d + 1) % n] != trash_f:
                sends.append((y_send, 1, 0))
            if tbl.recv_b_slot[t + 1][(d - 1) % n] != trash_b:
                sends.append((g_send, -1, 1))
            recvs = []
            if fslot != trash_f:
                recvs.append((micro[0], -1, 0))
            if bslot != trash_b:
                recvs.append((gy_micro[0], 1, 1))
            got = iter(ax.hop(sends, recvs, "pipe"))
            if fslot != trash_f:
                fstash[fslot] = next(got)
            if bslot != trash_b:
                bstash[bslot] = next(got)
    run.stats["peak_stash"] = peak
    return grads, dx


def _gather_from(ax: AxisGroup, parts, like, src: int):
    """The microbatches ``parts`` of rank ``src``, concatenated, on every
    rank."""
    out = torch.cat(parts) if ax.rank == src else torch.empty(
        like.shape, dtype=like.dtype, device=like.device)
    return ax.broadcast(out, src)


class _Pipeline(torch.autograd.Function):
    """The schedule as one differentiable call: (run, x, *leaves) -> y,
    the last stage's output on every pipe rank."""

    @staticmethod
    def forward(ctx, run: _Run, x, *leaves):
        ax = run.axis
        keep = run.schedule == "gpipe" and run.needs_grad
        outs, graphs = _forward_table(run, leaves, x, keep)
        run.stats["peak_stash"] = len(graphs) if keep else 0
        ctx.run, ctx.graphs = run, graphs
        if run.schedule == "1f1b":
            ctx.save_for_backward(x, *leaves)
        else:
            ctx.leaves = leaves
        return _gather_from(ax, outs, x, ax.n - 1)

    @staticmethod
    def backward(ctx, gy):
        run = ctx.run
        ax = run.axis
        # the last stage takes its own rank's cotangent
        gy_micro = list(gy.contiguous().chunk(run.m))
        if run.schedule == "1f1b":
            x, *leaves = ctx.saved_tensors
            grads, dx = _one_f_one_b(run, leaves, x, gy_micro)
        else:
            leaves = ctx.leaves
            grads, dx = _gpipe_backward(run, leaves, ctx.graphs, gy_micro)
            ctx.graphs = ctx.leaves = None
        if not run.local:
            for G in grads:
                ax.all_reduce(G, "pipe_grads")
        gx = (_gather_from(ax, dx, gy, 0) if ctx.needs_input_grad[1]
              else None)
        return (None, gx, *[G if need else None for G, need in
                            zip(grads, ctx.needs_input_grad[2:])])


def pipeline_apply_scheduled(stage_fn: Callable, stacked_params, x, *,
                             mesh=None, schedule: str,
                             virtual_stages: int = 1,
                             pipe_axis: str = "pipe",
                             num_microbatches: int = 4,
                             batch_axis=None, remat: bool = False,
                             stats: Optional[dict] = None):
    """Run x through ``n·v`` pipelined stage slices under a table-driven
    schedule (module docstring).  ``stage_fn(params_one_stage,
    microbatch) -> microbatch`` (same shape); ``stacked_params`` a tree of
    tensors whose leading axis is ``n·v`` (the whole stack) or ``v``
    (this rank's rows), in ``schedule.stack_index`` order; ``mesh`` a
    ``DeviceMesh`` with the ``pipe_axis`` (default: the Engine's).  ``x``
    is this rank's batch: the whole batch on a 1-D pipe mesh, its rows
    of the batch axes on a layout (``batch_axis`` names them, as in the
    reference's signature; each coordinate of them runs its own
    pipeline); ``num_microbatches`` must divide it.  Returns the output
    on every rank of the pipe group.  ``stats``, a dict, receives
    ``peak_stash``: the most stage inputs (and their graphs) this rank
    held at once."""
    ax = axis_group(mesh, pipe_axis)
    if ax is None:
        raise PipelinePartitionError(
            f"pipeline_apply_scheduled needs a mesh with a {pipe_axis!r} "
            "axis (Engine.init(mesh_shape={'pipe': n}) or mesh=)")
    if schedule not in schedule_mod.SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {schedule!r} "
                         f"(expected one of {schedule_mod.SCHEDULES})")
    leaves, spec = tree_flatten(stacked_params)
    n, v, m = ax.n, int(virtual_stages), int(num_microbatches)
    lead = leaves[0].shape[0]
    if lead not in (n * v, v):
        raise ValueError(f"stacked_params leading axis {lead} is neither "
                         f"|{pipe_axis}|*virtual = {n}*{v} (the stack) nor "
                         f"virtual = {v} (this rank's rows)")
    if x.shape[0] % m:
        raise ValueError(f"batch {x.shape[0]} must divide into {m} "
                         "microbatches")
    needs_grad = torch.is_grad_enabled() and (
        x.requires_grad or any(leaf.requires_grad for leaf in leaves))
    run = _Run(stage_fn, spec, ax, schedule, m, v, remat, needs_grad, stats,
               local=lead == v)
    return _Pipeline.apply(run, x, *leaves)


def pipeline_apply(stage_fn: Callable, stacked_params, x, *, mesh=None,
                   pipe_axis: str = "pipe", num_microbatches: int = 4,
                   batch_axis=None, remat: bool = False):
    """Run x through n pipelined stages, one per pipe rank (GPipe, v = 1):
    :func:`pipeline_apply_scheduled` with ``schedule="gpipe"``."""
    return pipeline_apply_scheduled(
        stage_fn, stacked_params, x, mesh=mesh, schedule="gpipe",
        virtual_stages=1, pipe_axis=pipe_axis,
        num_microbatches=num_microbatches, batch_axis=batch_axis,
        remat=remat)


# -- the pipeline as a module -------------------------------------------------

def _param_signature(module: Module):
    """(name, shape, dtype) of each parameter of ``module``, built or not
    (an unbuilt one is built on a copy, on the host), and whether it
    keeps running state."""
    if not module.built:
        module = copy.deepcopy(module)
        module._build(torch.Generator().manual_seed(0))
    params = tuple((name, tuple(p.shape), str(p.dtype))
                   for name, p in module.named_parameters())
    stateful = any(getattr(m, "state_names", ()) for m in module.modules())
    return params, stateful


def _stage_signature(module: Module):
    """Structural identity of one stage candidate: the module class chain
    and the parameters' names, shapes and dtypes.  Two stages with equal
    signatures can share one stage function."""
    def classes(m):
        kids = getattr(m, "layers", None)
        return (type(m).__name__,
                tuple(classes(c) for c in kids) if kids is not None else ())
    return (classes(module), _param_signature(module)[0])


class GPipeSequential(Container):
    """Structurally identical stages run as a pipeline over the ``pipe``
    axis (module docstring).

    Its one child is the stage module whose parameters are the stacked
    tree: each leaf gains a leading axis of ``n·v`` rows, in the
    reference's device-major order (``schedule.stack_index``), so
    ``utils/convert.py`` reads and writes the reference's stacked tree.
    ``virtual_stages`` (or ``BIGDL_TORCH_PIPE_VIRTUAL_STAGES``) is fixed at
    construction: it fixes the stacking order.  The schedule (``schedule``
    or ``BIGDL_TORCH_PIPE_SCHEDULE``) is read at each call.

    Restrictions, checked loudly: stages structurally identical,
    stateless (no BatchNorm running statistics), shape-preserving, and
    free of randomness (a stage runs without the Dropout generator, as
    the reference's runs with ``rng=None``); the stage count a multiple
    of ``virtual_stages``."""

    PARAM_ROLES = {"*": "pipeline_stage"}
    #: the reference's tree of this container is its one child's, each
    #: leaf stacked; its state tree is {} (``utils/convert.py``)
    STACKED = True

    def __init__(self, stages: Sequence[Module],
                 num_microbatches: Optional[int] = None,
                 pipe_axis: str = "pipe", remat: bool = False,
                 schedule: Optional[str] = None,
                 virtual_stages: Optional[int] = None):
        stages = list(stages)
        if not stages:
            raise PipelinePartitionError("GPipeSequential needs >= 1 stage")
        super().__init__(stages[0])
        self.num_stages = len(stages)
        self.num_microbatches = num_microbatches
        self.pipe_axis = pipe_axis
        self.remat = remat
        self.schedule = schedule
        self.virtual_stages = (int(virtual_stages) if virtual_stages
                               else pipe_virtual_stages())
        if self.virtual_stages < 1:
            raise PipelinePartitionError(
                f"virtual_stages must be >= 1, got {self.virtual_stages}")
        if self.num_stages % self.virtual_stages:
            raise PipelinePartitionError(
                f"{self.num_stages} stages cannot split into "
                f"virtual_stages={self.virtual_stages} slices per device "
                "(stage count must be a multiple of virtual_stages)")
        # what the last pipelined call ran: the microbatch count after
        # the clamp, its bubble, and the live stash's peak
        self._last_microbatches: Optional[int] = None
        self._last_bubble: Optional[float] = None
        self._clamp_logged = None
        self._stats: dict = {}
        self._validate_stages(stages)
        if all(s.built for s in stages):
            self._set_stacked([[p.detach() for _, p in s.named_parameters()]
                               for s in stages])
            self.built = True

    @property
    def stage(self) -> Module:
        """The stage module whose parameters are the stacked rows."""
        return self.layers[0]

    @property
    def last_peak_stash(self) -> Optional[int]:
        """The most stage inputs this rank held at once in the last
        pipelined call (its gpipe graphs, or the 1F1B stash)."""
        return self._stats.get("peak_stash")

    def _validate_stages(self, stages):
        sigs = [_stage_signature(m) for m in stages]
        if any(s != sigs[0] for s in sigs[1:]):
            raise PipelinePartitionError(
                "GPipeSequential stages are not structurally identical "
                "(pipelining stacks stage params along one axis; every "
                "stage must share the module/param structure): "
                f"{[s[0] for s in sigs]}")
        if _param_signature(stages[0])[1]:
            raise PipelinePartitionError(
                f"pipeline stage {type(stages[0]).__name__} carries "
                "running state (e.g. BatchNorm statistics); stages must "
                "be stateless — keep stateful layers outside the "
                "pipelined region")

    def _stack_order(self) -> List[int]:
        """The stage held by each stack row (``schedule.stack_index``'s
        inverse); the identity when virtual_stages == 1."""
        v = self.virtual_stages
        n = self.num_stages // v
        return [stage_of_stack_index(k, n, v) for k in range(self.num_stages)]

    def _set_stacked(self, per_stage: List[List[torch.Tensor]]):
        """Register the stage module's parameters as the stacked rows of
        ``per_stage`` (one list per stage, in ``named_parameters`` order),
        stacked in ``_stack_order``."""
        stacked = stack_stage_params([per_stage[s]
                                      for s in self._stack_order()])
        names = [name for name, _ in self.stage.named_parameters()]
        for name, leaf in zip(names, stacked):
            owner, _, attr = name.rpartition(".")
            mod = self.stage.get_submodule(owner) if owner else self.stage
            mod.register_parameter(attr, torch.nn.Parameter(leaf))
        self._names = names

    def _build(self, generator: torch.Generator) -> None:
        # each stage drawn in order, as the unpartitioned model draws its
        # blocks, then stacked in device-major order
        per_stage = []
        for _ in range(self.num_stages):
            self.stage._build(generator)
            per_stage.append([p.detach() for _, p in
                              self.stage.named_parameters()])
        self._set_stacked(per_stage)
        self.built = True

    def _stage_fn(self, rows, x):
        """The stage on x with the parameter rows ``rows`` (a list in
        ``named_parameters`` order), without the Dropout generator."""
        with dropout_rng(None):
            return functional_call(self.stage, dict(zip(self._names, rows)),
                                   (x,))

    def _stack_leaves(self):
        return [p for _, p in self.stage.named_parameters()]

    def _apply_sequential(self, x):
        v = self.virtual_stages
        n = self.num_stages // v
        rows = [leaf.unbind(0) for leaf in self._stack_leaves()]
        y = x
        for s in range(self.num_stages):
            k = stack_index(s, n, v)
            p = [r[k] for r in rows]
            if self.remat and torch.is_grad_enabled():
                y = _remat.checkpointed(
                    lambda a, p=p: self._stage_fn(p, a), "full", None, y)
            else:
                y = self._stage_fn(p, y)
        return y

    def plan(self, n: int, batch: Optional[int] = None):
        """(schedule, microbatch count, bubble fraction) of a call on an
        ``n``-wide pipe axis: the knobs' count, clamped to the largest
        that divides ``batch`` where one is given."""
        sched = self.schedule or pipe_schedule()
        m = self.num_microbatches or pipe_microbatches()
        while batch and batch % m:
            m -= 1
        return sched, m, bubble_fraction(n, m, sched, self.virtual_stages)

    def forward(self, x):
        ax = axis_group(None, self.pipe_axis)
        if ax is None or ax.n <= 1:
            # no pipe axis, or a 1-wide one: no schedule, the same math
            return self._apply_sequential(x)
        n, v = ax.n, self.virtual_stages
        if n * v != self.num_stages:
            raise PipelinePartitionError(
                f"GPipeSequential has {self.num_stages} stages but the "
                f"'{self.pipe_axis}' axis is {n}-wide with virtual_stages="
                f"{v} (needs {n * v} stages) — re-partition the model "
                f"(partition_pipeline(model, {n * v}))")
        m_req = self.num_microbatches or pipe_microbatches()
        sched, m, bubble = self.plan(n, x.shape[0])
        if m != m_req and self._clamp_logged != (m_req, m):
            logger.warning(
                "pipeline: BIGDL_TORCH_PIPE_MICROBATCHES=%d does not divide "
                "the local batch %d; clamped to %d microbatches "
                "(bubble %.4f under %s)", m_req, x.shape[0], m, bubble,
                sched)
            self._clamp_logged = (m_req, m)
        self._last_microbatches, self._last_bubble = m, bubble
        return pipeline_apply_scheduled(
            self._stage_fn, self._stack_leaves(), x, schedule=sched,
            virtual_stages=v, pipe_axis=self.pipe_axis, num_microbatches=m,
            remat=self.remat, stats=self._stats)


def _chain_modules(model) -> List[Module]:
    """Ordered child modules of a Sequential or a linear-chain Graph."""
    from ..nn.containers import Sequential
    from ..nn.graph import Graph, _InputModule
    if isinstance(model, Graph):
        if len(model.input_nodes) != 1 or len(model.output_nodes) != 1:
            raise PipelinePartitionError(
                "pipeline partitioning needs a single-input single-output "
                f"Graph; got {len(model.input_nodes)} inputs / "
                f"{len(model.output_nodes)} outputs")
        chain = []
        for node in model.exec_order:
            if len(node.prev_nodes) > 1 or len(node.next_nodes) > 1:
                raise PipelinePartitionError(
                    "pipeline partitioning needs a LINEAR Graph (every "
                    "node one predecessor/successor); node "
                    f"{node.element.name} has {len(node.prev_nodes)} "
                    f"inputs / {len(node.next_nodes)} outputs — wrap "
                    "branches inside a single stage module instead")
            if not isinstance(node.element, _InputModule):
                chain.append(node.element)
        return chain
    if isinstance(model, Sequential):
        return list(model.layers)
    raise PipelinePartitionError(
        f"cannot partition a {type(model).__name__} into pipeline stages "
        "(need a Sequential or a linear-chain Graph)")


def partition_pipeline(model, num_stages: int,
                       num_microbatches: Optional[int] = None,
                       remat: bool = False,
                       schedule: Optional[str] = None,
                       virtual_stages: Optional[int] = None):
    """Split a Sequential (or linear-chain Graph) model over the ``pipe``
    axis.

    Finds the longest contiguous run of children that divides into
    ``num_stages`` structurally identical groups (the repeated-block body
    of a transformer-style model), wraps it in :class:`GPipeSequential`,
    and returns ``Sequential(prelude..., pipeline, postlude...)``.
    ``num_stages`` counts stage SLICES: on an n-wide pipe axis with
    ``virtual_stages=v`` (or the knob) partition into ``n·v``.  The model
    is copied first, so it stays as it was.  A built model's parameters
    are carried over (the stage groups' stacked along the new stage axis
    in the schedule's device-major order): the partitioned model computes
    exactly what the original does.  Raises
    :class:`PipelinePartitionError` when no such run exists."""
    from ..nn.containers import Sequential
    num_stages = int(num_stages)
    if num_stages < 1:
        raise PipelinePartitionError(f"num_stages must be >= 1, "
                                     f"got {num_stages}")
    _chain_modules(model)   # refuses what cannot be partitioned, uncopied
    built = model.built
    children = _chain_modules(model.clone_module())
    sigs = [_stage_signature(m) for m in children]
    L = len(children)
    best = None  # (region_len, start, group_len)
    for g in range(L // num_stages, 0, -1):
        span = g * num_stages
        for start in range(0, L - span + 1):
            groups = [tuple(sigs[start + i * g: start + (i + 1) * g])
                      for i in range(num_stages)]
            if all(gr == groups[0] for gr in groups[1:]):
                cand = (span, start, g)
                if best is None or cand[0] > best[0]:
                    best = cand
        if best is not None:
            break  # g decreases: the first hit is the longest region
    if best is None:
        raise PipelinePartitionError(
            f"cannot split {L} children into {num_stages} structurally "
            "identical contiguous stages — pipeline partitioning needs a "
            "repeated-block body (e.g. N identical transformer blocks); "
            f"child classes: {[type(m).__name__ for m in children]}")
    span, start, g = best
    groups = [children[start + i * g: start + (i + 1) * g]
              for i in range(num_stages)]
    stage_mods = []
    for ms in groups:
        if g == 1:
            stage_mods.append(ms[0])
            continue
        seq = Sequential(*ms)
        seq.built = built
        stage_mods.append(seq)
    pipe = GPipeSequential(stage_mods, num_microbatches=num_microbatches,
                           remat=remat, schedule=schedule,
                           virtual_stages=virtual_stages)
    out = Sequential(*children[:start], pipe, *children[start + span:])
    out.built = built
    return out
