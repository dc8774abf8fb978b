"""Model zoo: the models the serving slice uses."""

from .transformer_lm import (PositionalEmbedding, TransformerBlock,
                             TransformerLM, greedy_generate, sample_next)

__all__ = ["TransformerLM", "TransformerBlock", "PositionalEmbedding",
           "greedy_generate", "sample_next"]
