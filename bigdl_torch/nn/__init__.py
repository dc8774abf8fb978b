"""Torch-style layer library: the modules the serving slice uses."""

from .activation import GELU, LogSoftMax
from .attention import MultiHeadAttention
from .containers import ConcatTable, Identity, Sequential
from .embedding import LookupTable
from .initialization import (compute_fans, default_bias_init,
                             default_weight_init)
from .linear import Linear
from .module import Container, Module
from .normalization import LayerNorm
from .table_ops import CAddTable

__all__ = ["Module", "Container", "Sequential", "ConcatTable", "Identity",
           "CAddTable", "LookupTable", "LayerNorm", "Linear", "LogSoftMax",
           "GELU", "MultiHeadAttention", "compute_fans",
           "default_weight_init", "default_bias_init"]
