"""Expert parallelism: capacity-routed mixture-of-experts (Switch style).

Counterpart of ``bigdl_tpu/parallel/expert.py``:

- :func:`top_k_routing`: top-k softmax gating with a fixed per-expert
  token capacity; tokens past an expert's capacity are dropped in the
  order of their position in the batch.  The routing is piecewise
  constant, so its one-hot masks are the reference's bit for bit in
  float32 (the same top-k order, the same capacity positions, the same
  drops).
- :func:`load_balancing_loss`: the Switch auxiliary loss, E · Σ_e f_e ·
  p̄_e, with f_e from the router's choices before the capacity cut.
- :class:`MoEFFN`: gate -> routing -> a two-layer ReLU FFN per expert ->
  combine, as dense products over every expert (dispatch and combine are
  products with the [tokens, experts, capacity] one-hot masks).  The
  Switch loss of a training forward lands in the module's state
  (``aux_loss``), where the ``Optimizer`` adds it to the criterion's
  loss (:func:`collect_aux_losses`).  Under ``LayoutSharding`` on a
  layout with ``expert`` = e > 1 (``parallel/mesh_plan.py`` calls
  :meth:`MoEFFN.mesh_rows`, which sets ``_ep``) each rank holds E/e rows
  of the four tables (the ``expert_table`` role) and computes with them: the routing and the
  dispatch buffer [E, C, D] come out alike on every expert rank (the
  batch is replicated over ``expert``), each rank runs its own experts'
  FFN on its rows of the buffer, and the outputs are all-gathered over
  ``expert`` (kind ``"expert_out"``; the backward takes this rank's
  slice of the cotangent); the rows enter through the conjugate slice,
  whose backward all-gathers the rows' gradients (``"expert_in"``), so
  the input and gate gradients come out equal on every expert rank and
  nothing is summed over ``expert``.  Under a mesh strategy whose batch
  axes are wider than one (``_batch``) the routing is the global
  batch's, as the reference's: the capacity counts every batch rank's
  tokens, each round's buffer positions count the lower batch ranks'
  tokens first, and the Switch loss takes the global f_e.  Under
  ``DataParallel`` each rank routes its own rows.  Beside a wide ``tp``
  (expert x tp) the expert group is the one of this rank's tp
  coordinate; the tp ranks hold the same rows and route alike, the
  global batch is the batch axes' alone, and the gate's gradient is
  scattered from tp coordinate 0, so the Switch loss counts each batch
  row once.  A ``MoEFFN`` inside a pipeline stage would hold pipe rows
  (``mesh_rows`` returns {}), but a stage refuses one, as the
  reference's does: it carries state (``parallel/pipeline.py``).
- :func:`expert_parallel_ffn`: the same FFN with the experts spread over
  the ranks of a 1-D ``DeviceMesh`` axis and the tokens routed to them by
  ``all_to_all_single``; the dense math where the axis is missing or one
  wide.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..common import get_policy
from ..nn.dropout import _generator_for
from ..nn.module import Module
from ..utils import remat

__all__ = ["MoEFFN", "expert_parallel_ffn", "top_k_routing",
           "load_balancing_loss", "collect_aux_losses"]


def top_k_routing(gate_logits, capacity: int, k: int = 1):
    """Top-k capacity routing over gate_logits [T, E].  Returns (combine,
    dispatch, probs, assign): combine [T, E, C] the gate probability at
    each token's buffer slot, dispatch [T, E, C] the one-hot routing mask,
    probs [T, E] the full float32 softmax, and assign [T, E] the router's
    choices before the capacity cut (the Switch paper's f_e reads these).
    All float32."""
    return _route(gate_logits, capacity, k)[:4]


def _route(gate_logits, capacity: int, k: int = 1, batch=None):
    """:func:`top_k_routing`, and the router's choices per expert summed
    over the global batch.  ``batch`` (a ``TpAxis`` over the batch ranks,
    ``parallel/mesh_plan.py``) makes the tokens of ``gate_logits`` this
    rank's block of a batch split over those ranks in rank order: each
    round's positions count the lower ranks' tokens first (one
    all-gather of the [E] counts a round, kind ``"moe_route"``), as the
    reference routes its global batch."""
    T, E = gate_logits.shape
    if k > E:
        raise ValueError(f"top-k routing with k={k} > num_experts={E}")
    probs = torch.softmax(gate_logits.float(), dim=-1)
    f32 = dict(dtype=torch.float32, device=probs.device)
    combine = torch.zeros((T, E, capacity), **f32)
    dispatch = torch.zeros((T, E, capacity), **f32)
    assign = torch.zeros((T, E), **f32)
    chosen = torch.zeros((E,), **f32)
    # tokens already routed to each expert by earlier rounds
    claimed = torch.zeros((E,), dtype=torch.int64, device=probs.device)
    masked = probs
    for _ in range(k):
        idx = masked.argmax(dim=-1)                        # first on ties
        onehot = F.one_hot(idx, E).float()                 # [T, E]
        # each token's position in its expert's buffer, in token order
        pos_in_e = onehot.cumsum(0) - onehot
        pos = (pos_in_e * onehot).sum(-1).long() + claimed[idx]
        counts = onehot.sum(0)
        if batch is not None:
            every = batch.all_gather(counts[None], 0, "moe_route")
            pos = pos + every[:batch.rank].sum(0).long()[idx]
            counts = every.sum(0)
        keep = pos < capacity
        # an index of ``capacity`` is the dropped row: all zeros
        slot = F.one_hot(torch.where(keep, pos, capacity),
                         capacity + 1)[:, :capacity].float()   # [T, C]
        route = onehot[:, :, None] * slot[:, None, :]      # [T, E, C]
        gate_p = (probs * onehot).sum(-1, keepdim=True)    # [T, 1]
        dispatch = dispatch + route
        combine = combine + route * gate_p[:, :, None]
        assign = assign + onehot
        chosen = chosen + counts
        claimed = claimed + counts.long()
        masked = masked * (1.0 - onehot)
    return combine, dispatch, probs, assign, chosen


def load_balancing_loss(probs, assign):
    """E · Σ_e (fraction of tokens the router chose for e) · (mean gate
    probability of e), the fraction from ``assign`` (before the capacity
    cut)."""
    E = probs.shape[-1]
    return E * torch.sum(assign.mean(0) * probs.mean(0))


def _expert_ffn(x, w1, b1, w2, b2):
    """Each expert's two-layer ReLU FFN on expert-major buffers [E, C, D]."""
    h = torch.relu(torch.einsum("ecd,edh->ech", x, w1) + b1[:, None, :])
    return torch.einsum("ech,ehd->ecd", h, w2) + b2[:, None, :]


def _capacity(k: int, tokens: int, experts: int, factor: float) -> int:
    return max(1, math.ceil(k * tokens / experts * factor))


def collect_aux_losses(model):
    """The sum of the auxiliary losses the last training forward left in
    ``model``'s modules, or in a list of its modules (each
    :class:`MoEFFN`'s Switch loss, with its graph), taken once: a second
    call before the next forward finds none.  None where there is none."""
    total = None
    for m in (model.modules() if isinstance(model, Module) else model):
        aux = m.__dict__.pop("_aux_live", None)
        if aux is not None:
            total = aux if total is None else total + aux
    return total


class MoEFFN(Module):
    """Mixture-of-experts FFN: gate -> top-k capacity routing -> each
    expert's two-layer ReLU FFN -> combine.  ``C = ceil(k · T / E ·
    capacity_factor)``.

    Parameters are the reference's: ``gate`` [D, E], ``w1`` [E, D, H],
    ``b1`` [E, H], ``w2`` [E, H, D], ``b2`` [E, D]; the state holds
    ``aux_loss``, the Switch loss (times ``aux_loss_weight``) of the last
    training forward.  In training, the router's input takes the Switch
    jitter (a multiplicative uniform draw in [1 - ε, 1 + ε],
    ``router_jitter``) from the generator of the enclosing
    ``dropout_rng`` block, and none without one, as the reference draws
    none without a key.

    ``expert_axis`` is kept for the reference's signature: the
    reference hints XLA to shard the experts over that mesh axis; here
    the layout's ``expert`` axis splits the tables (module docstring)."""

    PARAM_ROLES = {"gate": "kernel_in", "w1": "expert_table",
                   "w2": "expert_table", "b1": "expert_table",
                   "b2": "expert_table"}
    #: the per-expert tables, whose dim 0 is the expert
    TABLES = ("w1", "b1", "w2", "b2")
    #: used only as their casts to the compute dtype (parallel/mesh_plan.py)
    COMPUTE_CAST = TABLES

    def __init__(self, d_model: int, d_hidden: int, num_experts: int,
                 k: int = 1, capacity_factor: float = 1.25,
                 expert_axis: Optional[str] = "expert"):
        super().__init__()
        self.d_model = d_model
        self.d_hidden = d_hidden
        self.num_experts = num_experts
        self.k = k
        self.capacity_factor = capacity_factor
        self.expert_axis = expert_axis
        self.aux_loss_weight = 0.01
        self.router_jitter = 0.01

    def _init(self, generator):
        dt = get_policy().param_dtype
        E, D, H = self.num_experts, self.d_model, self.d_hidden

        def normal(shape, std):
            return torch.randn(shape, generator=generator, dtype=dt) * std
        return {"gate": normal((D, E), 0.02),
                "w1": normal((E, D, H), (2.0 / D) ** 0.5),
                "b1": torch.zeros((E, H), dtype=dt),
                "w2": normal((E, H, D), (2.0 / H) ** 0.5),
                "b2": torch.zeros((E, D), dtype=dt)}

    def _init_state(self):
        return {"aux_loss": torch.zeros((), dtype=torch.float32)}

    def mesh_rows(self, plan) -> dict:
        """Bind the layer to a mesh plan (``parallel/mesh_plan.py``): under
        batch axes wider than one it routes the global batch (``_batch``);
        where the plan splits all four tables' rows over ``expert`` it
        runs its own experts on them (``_ep``).  Returns the tables that
        keep their rows, {name: "expert"} (none where it does not)."""
        self.__dict__.pop("_ep", None)
        self.__dict__.pop("_batch", None)
        batch = plan.axis(plan.batch_axes)
        if batch is not None:
            self._batch = batch
        ep = plan.axis(("expert",))
        leaves = [plan.leaf(self, n) for n in self.TABLES]
        if ep is None or not all(l is not None and l.axes[0] == ("expert",)
                                 for l in leaves):
            return {}
        self._ep = ep
        return dict.fromkeys(self.TABLES, "expert")

    def _capacity(self, tokens: int) -> int:
        return _capacity(self.k, tokens, self.num_experts,
                         self.capacity_factor)

    def forward(self, x):
        c = get_policy().compute_dtype
        shape = x.shape
        xt = x.reshape(-1, shape[-1]).to(c)                  # [T, D]
        gate_in = xt.float()
        if self.training and self.router_jitter > 0:
            gen = _generator_for(x)
            if gen is not None:
                e = self.router_jitter
                noise = torch.rand(gate_in.shape, generator=gen,
                                   device=x.device)
                gate_in = gate_in * (noise * (2 * e) + (1.0 - e))
        logits = gate_in @ self.gate.float()
        batch = self.__dict__.get("_batch")
        n = 1 if batch is None else batch.n
        combine, dispatch, probs, assign, chosen = _route(
            logits, self._capacity(xt.shape[0] * n), self.k, batch)
        buf = torch.einsum("tec,td->ecd", dispatch.to(c), xt)
        ep = self.__dict__.get("_ep")
        if ep is not None and self.w1.shape[0] * ep.n == self.num_experts:
            # this rank's experts on their rows, gathered over expert
            mine = ep.slice(buf, 0, "expert_in")
            out = ep.gather(_expert_ffn(mine, self.w1.to(c), self.b1.to(c),
                                        self.w2.to(c), self.b2.to(c)),
                            0, "expert_out")
        else:
            out = _expert_ffn(buf, self.w1.to(c), self.b1.to(c),
                              self.w2.to(c), self.b2.to(c))
        y = torch.einsum("tec,ecd->td", combine.to(c), out)
        if self.training:
            if batch is None:
                aux = load_balancing_loss(probs, assign)
            else:
                # the global f_e times this rank's mean gate probability:
                # the mean over the batch ranks, which the strategy takes,
                # is the global batch's loss, and so is its gradient
                aux = self.num_experts * torch.sum(
                    chosen / (xt.shape[0] * n) * probs.mean(0))
            aux = self.aux_loss_weight * aux
            # a checkpoint's recompute in the backward computes it again
            # (it must save what the forward saved) and leaves nothing: its
            # loss was the forward's
            if not remat.in_recompute():
                self.aux_loss = aux.detach()
                if torch.is_grad_enabled():
                    self._aux_live = aux
        return y.reshape(shape)


def _mesh_width(mesh, axis: str) -> int:
    names = getattr(mesh, "mesh_dim_names", None) or ()
    return int(mesh.size(names.index(axis))) if axis in names else 1


def expert_parallel_ffn(mesh, params, x, *, k: int = 1,
                        capacity_factor: float = 1.25,
                        axis: str = "expert"):
    """The MoE FFN with the experts spread over the ranks of ``mesh``'s
    ``axis`` (a 1-D ``torch.distributed.device_mesh.DeviceMesh``).

    ``params`` is a :class:`MoEFFN`-style dict (gate [D, E], w1 [E, D, H],
    b1, w2, b2) of whole tables on every rank, ``x`` the [T, D] global
    tokens on every rank, T divisible by the axis width n.  Rank r routes
    its rows ``x[r·T/n : (r+1)·T/n]`` with a local capacity per expert
    (so every all-to-all block has one shape), sends each expert's buffer
    to the rank that holds it (experts ``[j·E/n, (j+1)·E/n)`` on rank j),
    runs its own experts' FFN, sends the results back and combines them:
    two ``all_to_all_single`` calls over ``mesh.get_group(axis)``.  The
    ranks' combined rows are then gathered over the axis, so every rank
    returns the global [T, D], as the reference's ``out_specs=P(axis)``
    array is global; it equals the dense math wherever no token overflows.
    Where the mesh lacks ``axis`` or the axis is one wide, it computes the
    dense math over all of ``x``, as the reference does."""
    import torch.distributed as dist

    n = 1 if mesh is None else _mesh_width(mesh, axis)
    E = params["w1"].shape[0]
    if n <= 1:
        cap = _capacity(k, x.shape[0], E, capacity_factor)
        logits = x.float() @ params["gate"].float()
        combine, dispatch, _, _ = top_k_routing(logits, cap, k)
        buf = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), x)
        out = _expert_ffn(buf, params["w1"], params["b1"], params["w2"],
                          params["b2"])
        return torch.einsum("tec,ecd->td", combine.to(x.dtype), out)
    if E % n:
        raise ValueError(f"num_experts {E} not divisible by the {axis!r} "
                         f"axis width {n}")
    T = x.shape[0]
    if T % n:
        raise ValueError(f"{T} tokens not divisible by the {axis!r} axis "
                         f"width {n}")
    group = mesh.get_group(axis)
    r = dist.get_rank(group)
    el, tl = E // n, T // n
    cap = _capacity(k, tl, E, capacity_factor)
    px = x[r * tl:(r + 1) * tl]
    logits = px.float() @ params["gate"].float()
    combine, dispatch, _, _ = top_k_routing(logits, cap, k)
    buf = torch.einsum("tec,td->ecd", dispatch.to(px.dtype), px)
    # [E, cap, D]: block j (experts of rank j) goes to rank j; block i of
    # what comes back holds this rank's experts' tokens from rank i
    recv = torch.empty_like(buf)
    dist.all_to_all_single(recv, buf.contiguous(), group=group)
    mine = recv.view(n, el, cap, -1).transpose(0, 1).reshape(el, n * cap, -1)
    sl = slice(r * el, (r + 1) * el)
    out = _expert_ffn(mine, params["w1"][sl], params["b1"][sl],
                      params["w2"][sl], params["b2"][sl])
    # back: rank i's tokens to rank i, as [E, cap, D] in expert order
    send = out.view(el, n, cap, -1).transpose(0, 1).contiguous()
    back = torch.empty_like(send)
    dist.all_to_all_single(back, send, group=group)
    y = torch.einsum("tec,ecd->td", combine.to(px.dtype),
                     back.view(E, cap, -1))
    rows = [torch.empty_like(y) for _ in range(n)]
    dist.all_gather(rows, y.contiguous(), group=group)
    return torch.cat(rows)
