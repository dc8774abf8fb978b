"""Model zoo: the models the serving and training slices use, and KV-cache
decoding for the TransformerLM family."""

from .decode import beam_generate, cached_generate, init_kv_cache
from .resnet import ResNet, ShortcutType
from .transformer_lm import (PositionalEmbedding, TransformerBlock,
                             TransformerLM, greedy_generate, sample_next)

__all__ = ["TransformerLM", "TransformerBlock", "PositionalEmbedding",
           "greedy_generate", "sample_next", "cached_generate",
           "beam_generate", "init_kv_cache", "ResNet", "ShortcutType"]
