"""Decoder-only transformer language model.

Counterpart of ``bigdl_tpu/models/transformer_lm.py``, built from the same
containers: each residual branch is ConcatTable(branch, Identity) +
CAddTable, so the parameter tree is the reference's, leaf for leaf.
``dropout > 0`` adds ``Dropout`` after the attention and after the MLP of
each block, as the reference does.  ``num_experts > 0`` builds the
Switch-style variant: each block's MLP is a ``parallel/expert.py``
``MoEFFN`` (k = ``expert_k``, hidden ``mlp_ratio * d_model``), whose
load-balancing loss the ``Optimizer`` adds to the criterion's.
``seq_parallel=True`` runs each block's attention as ring attention over
the ``seq`` axis of the Engine's mesh (``nn/attention.py``,
``parallel/ring_attention.py``); without one its forward raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..common import get_policy
from ..nn import (CAddTable, ConcatTable, Dropout, GELU, Identity, LayerNorm,
                  Linear, LogSoftMax, LookupTable, MultiHeadAttention,
                  Sequential)
from ..nn.module import Module

__all__ = ["TransformerLM", "TransformerBlock", "PositionalEmbedding",
           "greedy_generate", "sample_next"]


class PositionalEmbedding(Module):
    """Learned absolute positions added to [B, T, E] token embeddings."""

    PARAM_ROLES = {"weight": "embedding_row"}

    def __init__(self, max_len: int, embed_dim: int):
        super().__init__()
        self.max_len = max_len
        self.embed_dim = embed_dim

    def _init(self, generator):
        return {"weight": 0.02 * torch.randn(
            (self.max_len, self.embed_dim), generator=generator,
            dtype=get_policy().param_dtype)}

    def forward(self, x):
        t = x.shape[1]
        if t > self.max_len:
            raise ValueError(f"sequence length {t} > max_len {self.max_len}")
        return x + self.weight[:t].to(x.dtype)


def _residual(branch: Module) -> Sequential:
    """y = x + branch(x), via the library's table algebra."""
    return (Sequential()
            .add(ConcatTable(branch, Identity()))
            .add(CAddTable()))


def TransformerBlock(d_model: int, num_heads: int, mlp_ratio: int = 4,
                     dropout: float = 0.0, causal: bool = True,
                     seq_parallel: bool = False, num_experts: int = 0,
                     expert_k: int = 1, expert_axis=None) -> Sequential:
    """Pre-norm block: x + MHA(LN(x)); x + MLP(LN(x)), the MLP a MoEFFN
    where ``num_experts > 0``."""
    attn = (Sequential()
            .add(LayerNorm(d_model))
            .add(MultiHeadAttention(d_model, num_heads, causal=causal,
                                    seq_parallel=seq_parallel)))
    if num_experts:
        from ..parallel.expert import MoEFFN
        mlp = (Sequential()
               .add(LayerNorm(d_model))
               .add(MoEFFN(d_model, mlp_ratio * d_model, num_experts,
                           k=expert_k, expert_axis=expert_axis)))
    else:
        mlp = (Sequential()
               .add(LayerNorm(d_model))
               .add(Linear(d_model, mlp_ratio * d_model))
               .add(GELU())
               .add(Linear(mlp_ratio * d_model, d_model)))
    if dropout > 0:
        attn.add(Dropout(dropout))
        mlp.add(Dropout(dropout))
    return Sequential().add(_residual(attn)).add(_residual(mlp))


def TransformerLM(vocab_size: int, max_len: int = 1024, d_model: int = 256,
                  num_heads: int = 8, num_layers: int = 4,
                  mlp_ratio: int = 4, dropout: float = 0.0,
                  causal: bool = True, seq_parallel: bool = False,
                  num_experts: int = 0, expert_k: int = 1,
                  expert_axis=None) -> Sequential:
    """tokens [B, T] int -> log-probs [B, T, vocab]."""
    model = (Sequential()
             .add(LookupTable(vocab_size, d_model))
             .add(PositionalEmbedding(max_len, d_model)))
    for _ in range(num_layers):
        model.add(TransformerBlock(d_model, num_heads, mlp_ratio=mlp_ratio,
                                   dropout=dropout, causal=causal,
                                   seq_parallel=seq_parallel,
                                   num_experts=num_experts,
                                   expert_k=expert_k,
                                   expert_axis=expert_axis))
    model.add(LayerNorm(d_model))
    model.add(Linear(d_model, vocab_size))  # contracts the last axis of BTE
    model.add(LogSoftMax())
    return model


def sample_next(row, temperature: float, top_k: int,
                generator: torch.Generator = None) -> np.ndarray:
    """Pick next tokens from a [B, vocab] logit row (tensor or array).

    temperature <= 0 -> argmax (first index on ties, as numpy).  Otherwise
    sample from softmax(row / temperature), truncated to exactly the
    ``top_k`` most likely tokens when 0 < top_k < vocab.  Sampling runs on
    the host with ``generator``; it matches the reference in distribution,
    not in the numbers drawn."""
    row = torch.as_tensor(row).detach().float().cpu()
    if temperature <= 0:
        return row.argmax(dim=-1).numpy()
    scaled = row / temperature
    if 0 < top_k < scaled.shape[-1]:
        vals, idx = scaled.topk(top_k, dim=-1)
        scaled = torch.full_like(scaled, float("-inf")).scatter(-1, idx, vals)
    probs = torch.softmax(scaled, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].numpy()


def greedy_generate(model, prompt, num_tokens: int, max_len: int,
                    pad_token: int = 0, temperature: float = 0.0,
                    top_k: int = 0, generator: torch.Generator = None):
    """Extend ``prompt`` (list/array of ints, or a [B, T0] batch) by
    ``num_tokens`` on the model's device.  temperature == 0 -> greedy
    argmax; temperature > 0 -> sampling (needs ``generator``, a CPU
    ``torch.Generator``).

    Each step runs the eval forward at the fixed [B, max_len] shape
    (right-padded), as the reference does; causal masking makes the
    padding inert for positions below the current length."""
    toks = np.asarray(prompt, np.int64)
    if toks.ndim == 1:
        toks = toks[None, :]
    batch, t0 = toks.shape
    if t0 == 0:
        raise ValueError("empty prompt: need at least one token to condition"
                         " the first prediction on")
    if t0 + num_tokens > max_len:
        raise ValueError(f"prompt ({t0}) + num_tokens ({num_tokens}) "
                         f"exceeds max_len ({max_len})")
    if temperature > 0 and generator is None:
        raise ValueError("sampling (temperature > 0) needs a torch.Generator"
                         " via generator=")
    if not model.built:
        raise RuntimeError("greedy_generate: build the model first "
                           "(model.build(device))")
    device = next(model.parameters()).device
    buf = np.full((batch, max_len), pad_token, np.int64)
    buf[:, :t0] = toks
    model.eval()
    with torch.inference_mode():
        for i in range(t0, t0 + num_tokens):
            logits = model(torch.from_numpy(buf).to(device))
            # only the [B, vocab] row crosses to the host
            buf[:, i] = sample_next(logits[:, i - 1], temperature, top_k,
                                    generator)
    out = buf[:, : t0 + num_tokens]
    return out[0] if np.asarray(prompt).ndim == 1 else out
