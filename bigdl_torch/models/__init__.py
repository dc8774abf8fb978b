"""Model zoo: the models the serving and training slices use."""

from .resnet import ResNet, ShortcutType
from .transformer_lm import (PositionalEmbedding, TransformerBlock,
                             TransformerLM, greedy_generate, sample_next)

__all__ = ["TransformerLM", "TransformerBlock", "PositionalEmbedding",
           "greedy_generate", "sample_next", "ResNet", "ShortcutType"]
