"""Model zoo: LeNet-5, ResNet, TransformerLM with KV-cache decoding,
SimpleRNN, the PTB LSTM language model and the MNIST autoencoder."""

from .autoencoder import Autoencoder
from .decode import beam_generate, cached_generate, init_kv_cache
from .lenet import LeNet5, lenet5
from .resnet import ResNet, ShortcutType
from .rnn import PTBModel, SimpleRNN
from .transformer_lm import (PositionalEmbedding, TransformerBlock,
                             TransformerLM, greedy_generate, sample_next)

__all__ = ["TransformerLM", "TransformerBlock", "PositionalEmbedding",
           "greedy_generate", "sample_next", "cached_generate",
           "beam_generate", "init_kv_cache", "ResNet", "ShortcutType",
           "LeNet5", "lenet5", "SimpleRNN", "PTBModel", "Autoencoder"]
