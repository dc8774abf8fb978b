"""Torch-style layer library: the modules the serving and training slices
use."""

from .activation import GELU, LogSoftMax, ReLU
from .attention import MultiHeadAttention
from .containers import ConcatTable, Identity, Sequential
from .conv import SpatialConvolution
from .criterion import (ClassNLLCriterion, Criterion, CrossEntropyCriterion,
                        TimeDistributedCriterion)
from .dropout import Dropout, dropout_rng
from .embedding import LookupTable
from .fused import ConvBN, ConvBNAddReLU, fuse_conv_bn
from .initialization import (InitializationMethod, MsraFiller, Zeros,
                             compute_fans, default_bias_init,
                             default_weight_init)
from .linear import Linear
from .module import Container, Module
from .normalization import (BatchNormalization, LayerNorm,
                            SpatialBatchNormalization)
from .pooling import SpatialAveragePooling, SpatialMaxPooling
from .shape import Reshape
from .table_ops import CAddTable

__all__ = ["Module", "Container", "Sequential", "ConcatTable", "Identity",
           "CAddTable", "LookupTable", "LayerNorm", "BatchNormalization",
           "SpatialBatchNormalization", "Linear", "SpatialConvolution",
           "SpatialMaxPooling", "SpatialAveragePooling", "Reshape", "ReLU",
           "LogSoftMax", "GELU", "MultiHeadAttention", "ConvBN",
           "ConvBNAddReLU", "fuse_conv_bn", "Criterion",
           "ClassNLLCriterion", "CrossEntropyCriterion",
           "TimeDistributedCriterion", "Dropout", "dropout_rng",
           "InitializationMethod", "Zeros", "MsraFiller", "compute_fans",
           "default_weight_init", "default_bias_init"]
