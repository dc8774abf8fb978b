"""KV-cache incremental decoding for the TransformerLM family.

Counterpart of ``bigdl_tpu/models/decode.py``.  ``greedy_generate``
(transformer_lm.py) re-runs the whole [B, max_len] forward for every new
token; here each new token costs one [B, 1, E] forward against a
per-layer key/value cache, updated in place.

The decoder walks the model's own module tree (``Sequential``, the
residual ``ConcatTable`` + ``CAddTable``, leaf modules through their eval
``forward``), so a model trained through the ``Optimizer`` decodes with
its own weights.  ``MultiHeadAttention`` projects q, k and v with the
module's own ``_proj`` and calls :func:`~bigdl_torch.ops.decode_attention.
decode_attention` (B8: the CUDA kernel on the card, its plain version on
the CPU), which writes k and v into the cache at each row's position and
attends to it in one call.  Other containers raise, as the reference
does.

Positions are an int32 [rows] tensor on the model's device, one per row:
``cached_generate`` and ``beam_generate`` give every row the same one, the
decode engine (``serve/decode.py``) each slot its own, through the same
step.  The step never reads them back on the host.

``mesh=`` (the reference's ``:62-90``, ``:285-321``): on a layout mesh
(``parallel/layout.py``: the Engine's, or any mesh ``MeshLayout.
build_mesh`` registered, such as a router member's subset, which the
loop pins with ``Engine.pinned``) the parameters are placed through
the role table (``parallel/sharding.py`` ``LayoutSharding``, where the
model is not sharded yet) and each cache through the ``kv_cache`` role:
its slots split over data x fsdp like batch rows, its heads over tp
where the attention computes its own heads (a layer the split left whole
keeps every head).  Every rank runs the same loop on the same prompt:
it decodes its own rows, B8 appending and attending over its own slots
and heads, and each step's [B, vocab] log-prob row is all-gathered over
the rows' axes before it crosses to the host.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..common import get_policy
from ..nn.attention import MultiHeadAttention
from ..nn.containers import ConcatTable, Sequential
from ..nn.module import Container
from ..ops.decode_attention import decode_attention
from .transformer_lm import PositionalEmbedding, sample_next

__all__ = ["init_kv_cache", "cached_generate", "cached_generate_rows",
           "beam_generate"]


def _modules_of_type(module, cls):
    """Leaves of type ``cls`` in traversal order (== cache slot order)."""
    if isinstance(module, cls):
        return [module]
    if isinstance(module, Container):
        out = []
        for m in module.layers:
            out.extend(_modules_of_type(m, cls))
        return out
    return []


def _mha_modules(module):
    return _modules_of_type(module, MultiHeadAttention)


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def _layout_of(mesh):
    from ..parallel.layout import MeshLayout
    lay = MeshLayout.of_mesh(mesh)
    if lay is None:
        raise ValueError(
            "init_kv_cache: mesh lacks the canonical layout axes (build it "
            "with parallel/layout.MeshLayout.build_mesh)")
    return lay


def _rows_of(lay, batch: int, heads: int, max_len: int, head_dim: int,
             mesh):
    """(first row, rows, row axes) of this rank's cache slots: the
    ``kv_cache`` role's split of the slots over data x fsdp, at this
    rank's coordinate on ``mesh``."""
    spec = lay.spec_for("kv_cache", (batch, heads, max_len, head_dim),
                        min_size=0)
    axes = spec[0] if isinstance(spec[0], tuple) else \
        (() if spec[0] is None else (spec[0],))
    sizes = lay.shape()
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    idx, n = 0, 1
    for a in axes:
        idx, n = idx * sizes[a] + coord[a], n * sizes[a]
    return idx * (batch // n), batch // n, axes


def init_kv_cache(model, batch: int, max_len: int, dtype=None, mesh=None,
                  device=None):
    """One ``{"k", "v"}`` pair of [batch, H, max_len, D] zeros per
    ``MultiHeadAttention``, in traversal order.  ``dtype`` defaults to
    float32, as the reference's; ``device`` to the model's.  ``mesh``: a
    layout's mesh; each cache is then this rank's shard under the
    ``kv_cache`` role (module docstring): [batch / (data·fsdp), H / tp,
    max_len, D] where the slots divide and the attention computes its
    own heads."""
    dtype = torch.float32 if dtype is None else dtype
    device = _device_of(model) if device is None else torch.device(device)
    lay = None if mesh is None else _layout_of(mesh)
    caches = []
    for mha in _mha_modules(model):
        heads, rows = mha.num_heads, batch
        if lay is not None:
            _, rows, _ = _rows_of(lay, batch, heads, max_len, mha.head_dim,
                                  mesh)
            tp = mha.__dict__.get("_tp")
            if tp is not None:
                heads //= tp.n
        shape = (rows, heads, max_len, mha.head_dim)
        caches.append({"k": torch.zeros(shape, dtype=dtype, device=device),
                       "v": torch.zeros(shape, dtype=dtype, device=device)})
    return caches


def _cached_attention(mha, x, cache, pos):
    """x: [S, 1, E], row s at position pos[s] (int32 [S]); appends this
    position's k and v to ``cache`` in place and returns [S, 1, E]."""
    if not mha.causal:
        # a KV cache presumes causal attention
        raise NotImplementedError(
            "cached decoding requires causal attention "
            "(MultiHeadAttention(causal=False) found)")
    S = x.shape[0]
    # [S, H', 1, D]: H' the heads this rank computes (all, or H / tp)
    q, k, v = mha._qkv(x)
    o = decode_attention(q, k, v, cache["k"], cache["v"], pos)
    return mha._out(o.transpose(1, 2).reshape(S, 1, -1))


def _step(module, x, caches, slot: int, pos):
    """Incremental apply of one module at positions ``pos``; returns
    (y, next cache slot).  ``caches`` are updated in place."""
    if isinstance(module, MultiHeadAttention):
        return _cached_attention(module, x, caches[slot], pos), slot + 1
    if isinstance(module, PositionalEmbedding):
        w = module.weight.index_select(0, pos)          # [S, E]
        return x + w[:, None].to(x.dtype), slot
    if isinstance(module, Sequential):
        for m in module.layers:
            x, slot = _step(m, x, caches, slot, pos)
        return x, slot
    if isinstance(module, ConcatTable):
        outs = []
        for m in module.layers:
            o, slot = _step(m, x, caches, slot, pos)
            outs.append(o)
        return outs, slot
    if not isinstance(module, Container):
        # leaf modules (LayerNorm, Linear, GELU, CAddTable, ...) are
        # position-independent: their own eval forward
        return module(x), slot
    raise NotImplementedError(
        f"cached decoding: unsupported container {type(module).__name__}")


def decode_step(model, caches, tok, pos):
    """One position for every row: tok and pos int [rows] on the model's
    device -> log-probs [rows, vocab].  Call under ``torch.inference_mode``
    with the model in eval mode."""
    y, _ = _step(model, tok[:, None], caches, 0, pos)
    return y[:, -1]


def _validate_generate(model, toks, num_tokens, max_len):
    if toks.shape[1] == 0:
        raise ValueError("empty prompt")
    if toks.shape[1] + num_tokens > max_len:
        raise ValueError(f"prompt ({toks.shape[1]}) + num_tokens "
                         f"({num_tokens}) exceeds max_len ({max_len})")
    for pe in _modules_of_type(model, PositionalEmbedding):
        if max_len > pe.max_len:
            raise ValueError(f"max_len {max_len} > model positional "
                             f"embedding max_len {pe.max_len}")
    if not model.built:
        raise RuntimeError("cached decoding: build the model first "
                           "(model.build(device))")


def _positions(rows: int, p: int, device) -> torch.Tensor:
    return torch.full((rows,), p, dtype=torch.int32, device=device)


def cached_generate(model, prompt, num_tokens: int, max_len: int,
                    pad_token: int = 0, temperature: float = 0.0,
                    top_k: int = 0, generator: torch.Generator = None,
                    cache_dtype=None, mesh=None):
    """KV-cache decode with ``greedy_generate``'s contract: ``prompt`` is a
    list/array of ints or a [B, T0] batch, extended by ``num_tokens`` on the
    model's device; greedy when temperature == 0, else temperature/top-k
    sampling through ``sample_next`` with ``generator`` (a CPU
    ``torch.Generator``).  The cache is in ``cache_dtype`` (default: the
    policy's compute dtype).  Only each step's [B, vocab] log-prob row
    crosses to the host.  ``mesh``: a layout mesh (module docstring);
    every rank of it calls this with the same arguments."""
    return _generate(model, prompt, num_tokens, max_len, pad_token,
                     temperature, top_k, generator, cache_dtype, mesh,
                     keep_rows=False)[0]


def cached_generate_rows(model, prompt, num_tokens: int, max_len: int,
                         pad_token: int = 0, temperature: float = 0.0,
                         top_k: int = 0, generator: torch.Generator = None,
                         cache_dtype=None, mesh=None):
    """:func:`cached_generate` that also returns the [B, vocab] log-prob
    row of every generated token, float32 on the host: (tokens, rows)."""
    return _generate(model, prompt, num_tokens, max_len, pad_token,
                     temperature, top_k, generator, cache_dtype, mesh,
                     keep_rows=True)


def _generate(model, prompt, num_tokens, max_len, pad_token, temperature,
              top_k, generator, cache_dtype, mesh, keep_rows):
    """The decode loop: every row here, or on a layout mesh this rank's
    rows [lo, lo + n) and heads, each step's log-prob row all-gathered
    over the rows' axes before it crosses to the host."""
    prompt_arr = np.asarray(prompt, np.int32)
    toks = prompt_arr[None, :] if prompt_arr.ndim == 1 else prompt_arr
    B, t0 = toks.shape
    _validate_generate(model, toks, num_tokens, max_len)
    if temperature > 0 and generator is None:
        raise ValueError("sampling (temperature > 0) needs a torch.Generator"
                         " via generator=")
    dtype = cache_dtype or get_policy().compute_dtype
    device = _device_of(model)
    lo, n, group = 0, B, None
    pin = placed = contextlib.nullcontext()
    if mesh is not None:
        from ..parallel.sharding import LayoutSharding
        from ..utils.engine import Engine
        lay = _layout_of(mesh)
        with Engine.pinned(mesh):
            placed = LayoutSharding(model).place(model).materialized()
            mha = _mha_modules(model)
            lo, n, axes = _rows_of(lay, B, mha[0].num_heads if mha else 1,
                                   max_len, mha[0].head_dim if mha else 1,
                                   mesh)
            group = Engine.axis_group(axes)
        pin = Engine.pinned(mesh)
    buf = np.full((B, max_len), pad_token, np.int32)
    buf[:, :t0] = toks
    rows = []
    model.eval()
    with torch.inference_mode(), pin, placed:
        caches = init_kv_cache(model, B, max_len, dtype, mesh=mesh,
                               device=device)
        prompt_dev = torch.from_numpy(np.ascontiguousarray(
            toks[lo:lo + n])).to(device)
        for pos in range(t0 + num_tokens - 1):
            tok = (prompt_dev[:, pos] if pos < t0 else torch.from_numpy(
                np.ascontiguousarray(buf[lo:lo + n, pos])).to(device))
            logits = decode_step(model, caches, tok,
                                 _positions(n, pos, device))
            if pos + 1 < t0:
                continue  # prompt prefill: only the cache matters
            if n < B:
                logits = _gather_rows(logits.float().contiguous(), B, group)
            row = logits.float().cpu()
            if keep_rows:
                rows.append(row.numpy())
            buf[:, pos + 1] = sample_next(row, temperature, top_k,
                                          generator)
    out = buf[:, : t0 + num_tokens]
    return (out[0] if prompt_arr.ndim == 1 else out), rows


def _gather_rows(local, B: int, group):
    """Every rank's rows of a [n, vocab] step, [B, vocab] in row order."""
    from ..utils.engine import Engine
    out = torch.empty((B // local.shape[0],) + tuple(local.shape),
                      dtype=local.dtype, device=local.device)
    Engine.all_gather(out.view(-1), local.view(-1), "decode", group=group)
    return out.reshape(B, -1)


def beam_generate(model, prompt, num_tokens: int, max_len: int,
                  beam_size: int = 4, pad_token: int = 0,
                  eos_token: int = None, cache_dtype=None):
    """Beam search over the KV cache: keeps the ``beam_size`` hypotheses
    of highest total log-prob per batch row and returns the best one,
    [t0 + num_tokens] for a 1-D prompt else [B, t0 + num_tokens].  The
    model must emit log-probs (TransformerLM ends in LogSoftMax);
    ``beam_size=1`` is greedy.

    ``eos_token``: a hypothesis that emitted it stops accumulating log-prob
    (its only continuation is ``pad_token`` at score 0), so finished and
    live hypotheses compete fairly; finished ones come back padded.

    Scores are float64 on the host, as in the reference; each step reorders
    the caches along the row axis (``index_select``) to follow the
    surviving hypotheses, except for an identity permutation and on the
    last step, whose caches are unused."""
    prompt_arr = np.asarray(prompt, np.int32)
    toks = prompt_arr[None, :] if prompt_arr.ndim == 1 else prompt_arr
    B, t0 = toks.shape
    _validate_generate(model, toks, num_tokens, max_len)
    if beam_size < 1:
        raise ValueError(f"beam_size {beam_size}")
    if eos_token is not None and eos_token == pad_token:
        raise ValueError("eos_token must differ from pad_token (padding "
                         "marks the post-EOS tail)")
    dtype = cache_dtype or get_policy().compute_dtype
    device = _device_of(model)
    rows = B * beam_size
    buf = np.full((rows, max_len), pad_token, np.int32)
    buf[:, :t0] = np.repeat(toks, beam_size, axis=0)
    model.eval()
    with torch.inference_mode():
        prompt_dev = torch.from_numpy(np.ascontiguousarray(toks)).to(device)
        # prefill B rows only (all beams are identical until the first
        # scored step), then repeat the caches beam_size-fold
        caches = init_kv_cache(model, B, max_len, dtype, device=device)
        for pos in range(t0 - 1):
            decode_step(model, caches, prompt_dev[:, pos],
                        _positions(B, pos, device))
        if beam_size > 1:
            caches = [{n: c[n].repeat_interleave(beam_size, dim=0)
                       for n in c} for c in caches]
        # all beams start as copies of the prompt; only beam 0 may expand
        # on the first scored step, else the top-k would pick duplicates
        scores = np.full((B, beam_size), -np.inf, np.float64)
        scores[:, 0] = 0.0
        finished = np.zeros((B, beam_size), bool)
        for pos in range(t0 - 1, t0 + num_tokens - 1):
            tok = torch.from_numpy(np.ascontiguousarray(buf[:, pos]))
            logits = decode_step(model, caches, tok.to(device),
                                 _positions(rows, pos, device))
            lp = logits.float().cpu().numpy().astype(np.float64)
            lp = lp.reshape(B, beam_size, -1)
            V = lp.shape[-1]
            if eos_token is not None and finished.any():
                # a finished beam's only continuation is pad at log-prob 0
                lp = np.where(finished[:, :, None], -np.inf, lp)
                lp[:, :, pad_token] = np.where(finished, 0.0,
                                               lp[:, :, pad_token])
            flat = (scores[:, :, None] + lp).reshape(B, beam_size * V)
            k = min(beam_size, flat.shape[1])
            top = np.argpartition(flat, -k, axis=-1)[:, -k:]
            order = np.argsort(-np.take_along_axis(flat, top, -1), axis=-1)
            top = np.take_along_axis(top, order, -1)
            scores = np.take_along_axis(flat, top, -1)        # [B, k] desc
            src = top // V                                    # its beam
            tok = (top % V).astype(np.int32)
            gather = (np.arange(B)[:, None] * beam_size + src).reshape(-1)
            if not np.array_equal(gather, np.arange(rows)):
                buf = buf[gather].copy()
                if pos + 2 < t0 + num_tokens:
                    gidx = torch.from_numpy(gather).to(device)
                    caches = [{n: c[n].index_select(0, gidx) for n in c}
                              for c in caches]
            buf[:, pos + 1] = tok.reshape(-1)
            if eos_token is not None:
                finished = np.take_along_axis(finished, src, axis=1) | \
                    (tok == eos_token)
                if finished.all():
                    break  # buf is pad-prefilled; the rest are no-ops
    out = buf.reshape(B, beam_size, max_len)[:, 0, : t0 + num_tokens]
    return out[0] if prompt_arr.ndim == 1 else out
