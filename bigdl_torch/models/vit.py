"""Vision Transformer (ViT).

Counterpart of ``bigdl_tpu/models/vit.py``, built from the port's own
blocks in the reference's order, so the parameter tree is the reference's
leaf for leaf: the patch embedding is a ``SpatialConvolution`` whose
stride is the patch, ``Reshape`` flattens the grid of patches to tokens,
``PositionalEmbedding`` adds learned positions, the encoder is
``TransformerBlock(causal=False)`` (full attention: B6 forward and B7
backward on the card, not causal), and the head is ``LayerNorm``,
``Mean(dimension=1)`` over the tokens, ``Linear`` and ``LogSoftMax``.
``num_experts > 0`` swaps each block's MLP for ``parallel/expert.py``
``MoEFFN``, as ``TransformerLM``'s does.
"""

from __future__ import annotations

from ..nn import (LayerNorm, Linear, LogSoftMax, Mean, Reshape, Sequential,
                  SpatialConvolution)
from .transformer_lm import PositionalEmbedding, TransformerBlock

__all__ = ["ViT"]


def ViT(image_size: int = 224, patch_size: int = 16, class_num: int = 1000,
        d_model: int = 384, num_heads: int = 6, num_layers: int = 8,
        mlp_ratio: int = 4, in_channels: int = 3, dropout: float = 0.0,
        num_experts: int = 0, expert_axis=None) -> Sequential:
    """[B, H, W, C] images -> [B, class_num] log-probs."""
    if image_size % patch_size:
        raise ValueError(f"image_size {image_size} not divisible by "
                         f"patch_size {patch_size}")
    tokens = (image_size // patch_size) ** 2
    model = (Sequential()
             .add(SpatialConvolution(in_channels, d_model, patch_size,
                                     patch_size, patch_size, patch_size,
                                     0, 0))
             .add(Reshape((tokens, d_model)))
             .add(PositionalEmbedding(tokens, d_model)))
    for _ in range(num_layers):
        model.add(TransformerBlock(d_model, num_heads, mlp_ratio=mlp_ratio,
                                   dropout=dropout, causal=False,
                                   num_experts=num_experts,
                                   expert_axis=expert_axis))
    model.add(LayerNorm(d_model))
    model.add(Mean(dimension=1))   # pool over the tokens -> [B, E]
    model.add(Linear(d_model, class_num))
    model.add(LogSoftMax())
    return model
