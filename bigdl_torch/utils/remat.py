"""Rematerialization of the training forward: ``Optimizer.set_remat``.

Counterpart of the reference's ``apply_remat`` (``bigdl_tpu/optim/
optimizer.py:801-810``), which wraps the loss function in
``jax.checkpoint``.  Here the Optimizer runs each segment of the forward
(the children of nested ``Sequential`` s) under
``torch.utils.checkpoint.checkpoint`` (non-reentrant, early stop off, so
the recompute always runs the whole segment) through :func:`checkpointed`:
one checkpoint over the whole loss would rebuild every activation at the
start of the backward, whose peak is the unremat one.  Policies:

- ``"full"``: nothing of the forward is kept; the backward recomputes all
  of it, the hand-written kernels included (B1, B5, B6 run again).
- ``"conv_out"``: only the convolutions' outputs are kept (the tensors the
  reference names ``conv_out``: ``nn/conv.py``'s convolution and B5's
  product in the fused conv-BN, ``ops/convbn.py``); the recompute takes
  them from the forward instead of computing them again, and recomputes
  the BatchNorm tails.  A selective-checkpoint policy sees only aten ops
  and cannot see B5 (a ``ctypes`` launch), so the producers themselves
  read the context through :func:`conv_out`, and ``SpatialConvolution``
  runs its convolution through :class:`_Conv`, whose backward is the
  library's ``convolution_backward`` with autograd's own arguments.
- a callable: a selective-checkpoint policy over aten ops
  (``policy(ctx, op, *args, **kwargs)`` returning a
  ``torch.utils.checkpoint.CheckpointPolicy`` or a bool, True = save),
  the counterpart of a ``jax.checkpoint_policies`` callable.  The
  hand-written kernels are recomputed under it.

Three things would make the recompute differ from the forward, each
without an error, and :func:`checkpointed` closes all three:

- Dropout draws from the Optimizer's own ``torch.Generator``, which
  ``preserve_rng_state`` does not save: the generator's state is taken
  before the forward and set back for the recompute, and after the
  recompute the generator is put back where the backward found it, so
  later draws are the ones a run without remat makes.
- BatchNorm updates its running statistics in place in the forward: under
  remat the forward hands the update to the context (:func:`defer_ema`),
  which applies it once, in order, after the checkpointed call; the
  recompute makes none.
- ``"conv_out"`` above.
"""

from __future__ import annotations

import contextvars
import functools
from typing import Callable, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as tcp

__all__ = ["checkpointed", "conv_out", "defer_ema", "check_policy",
           "conv2d", "active"]

_run: contextvars.ContextVar = contextvars.ContextVar("bigdl_remat",
                                                      default=None)


def check_policy(policy):
    """``policy`` as it is, or ValueError for an unknown string (a typo
    would otherwise run without remat, as in the reference)."""
    if policy is not None and not callable(policy) and \
            policy not in ("full", "conv_out"):
        raise ValueError(f"set_remat: unknown policy {policy!r}: expected "
                         "None, 'full', 'conv_out' or a callable "
                         "selective-checkpoint policy")
    return policy


class _Run:
    """One checkpointed call: its policy, the pass it is in, the conv
    outputs the forward kept and the EMA updates it deferred."""

    def __init__(self, policy):
        self.policy = policy
        self.recompute = False
        self.saved = []
        self.pos = 0
        self.ema = []


def active() -> bool:
    """True inside a checkpointed call: its forward or its recompute."""
    return _run.get() is not None


def in_recompute() -> bool:
    """True inside the backward's recompute of a checkpointed call."""
    r = _run.get()
    return r is not None and r.recompute


def defer_ema(update: Callable[[], None]) -> bool:
    """Called by BatchNorm with its running-statistics update: inside a
    checkpointed forward the update waits for the end of the call (True),
    inside a recompute it is dropped (True); without remat the caller
    applies it (False)."""
    r = _run.get()
    if r is None:
        return False
    if not r.recompute:
        r.ema.append(update)
    return True


def conv_out(compute: Callable):
    """A convolution output under the ``"conv_out"`` policy: computed and
    kept in the forward, taken back in the recompute; otherwise simply
    computed."""
    r = _run.get()
    if r is None or r.policy != "conv_out":
        return compute()
    if not r.recompute:
        out = compute()
        r.saved.append(tuple(t.detach() for t in out)
                       if isinstance(out, tuple) else out.detach())
        return out
    out = r.saved[r.pos]
    r.pos += 1
    return out


class _Conv(torch.autograd.Function):
    """F.conv2d whose output is a kept ``conv_out`` tensor: the forward
    computes (or takes back) it, the backward is the library's
    ``convolution_backward`` with the arguments autograd gives it for
    ``F.conv2d``, so the gradients are the unremat ones bit for bit."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, groups, dilation):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, groups, dilation)
        with torch.no_grad():
            return conv_out(lambda: F.conv2d(x, w, stride=stride,
                                             padding=padding, groups=groups,
                                             dilation=dilation))

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        stride, padding, groups, dilation = ctx.conf
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False]
        gx, gw, _ = torch.ops.aten.convolution_backward(
            gy, x, w, None, list(stride), list(padding), list(dilation),
            False, [0, 0], groups, mask)
        return gx, gw, None, None, None, None


def conv2d(x, w, stride, padding, groups, dilation=(1, 1)):
    """F.conv2d, through :class:`_Conv` under the ``"conv_out"`` policy."""
    r = _run.get()
    if r is not None and r.policy == "conv_out":
        return _Conv.apply(x, w, tuple(stride), tuple(padding), groups,
                           tuple(dilation))
    return F.conv2d(x, w, stride=stride, padding=padding, groups=groups,
                    dilation=dilation)


def _sac_context(policy):
    def adapted(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        if isinstance(out, bool):
            return (tcp.CheckpointPolicy.MUST_SAVE if out
                    else tcp.CheckpointPolicy.PREFER_RECOMPUTE)
        return out
    return functools.partial(tcp.create_selective_checkpoint_contexts,
                             adapted)


def checkpointed(fn: Callable, policy, rng: Optional[torch.Generator],
                 *args):
    """``fn(*args)`` under ``policy`` (not None), its saved activations
    recomputed in the backward; BatchNorm's deferred updates are applied
    before this returns."""
    run = _Run(policy)
    states = {}

    def body(*a):
        token = _run.set(run)
        try:
            if "before" not in states:
                states["before"] = None if rng is None else rng.get_state()
                return fn(*a)
            run.recompute, run.pos = True, 0
            # the recompute draws the forward's masks, then the generator
            # goes on from where the backward found it
            now = None if rng is None else rng.get_state()
            if rng is not None:
                rng.set_state(states["before"])
            try:
                return fn(*a)
            finally:
                if rng is not None:
                    rng.set_state(now)
                run.saved = []
        finally:
            _run.reset(token)

    kw = {}
    if callable(policy):
        kw["context_fn"] = _sac_context(policy)
    with tcp.set_checkpoint_early_stop(False):
        out = tcp.checkpoint(body, *args, use_reentrant=False,
                             preserve_rng_state=False, **kw)
    for update in run.ema:
        update()
    run.ema = []
    return out
