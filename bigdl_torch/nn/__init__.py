"""Torch-style layer library: the modules the serving and training slices
use."""

from .activation import GELU, LogSoftMax, ReLU, Tanh
from .attention import MultiHeadAttention
from .containers import Concat, ConcatTable, Identity, Sequential
from .conv import SpatialConvolution
from .criterion import (ClassNLLCriterion, Criterion, CrossEntropyCriterion,
                        TimeDistributedCriterion)
from .dropout import Dropout, dropout_rng
from .embedding import LookupTable
from .fused import ConvBN, ConvBNAddReLU, fuse_conv_bn
from .initialization import (BilinearFiller, ConstInitMethod,
                             InitializationMethod, MsraFiller, Ones,
                             RandomNormal, RandomUniform, Xavier, Zeros,
                             compute_fans, default_bias_init,
                             default_weight_init)
from .linear import AddConstant, Linear, MulConstant
from .module import Container, Module, ReferenceModuleFile
from .normalization import (BatchNormalization, LayerNorm,
                            SpatialBatchNormalization)
from .pooling import SpatialAveragePooling, SpatialMaxPooling
from .shape import Reshape
from .table_ops import CAddTable

__all__ = ["Module", "Container", "ReferenceModuleFile", "Sequential",
           "Concat", "ConcatTable", "Identity", "CAddTable", "MulConstant",
           "AddConstant", "LookupTable", "LayerNorm", "BatchNormalization",
           "SpatialBatchNormalization", "Linear", "SpatialConvolution",
           "SpatialMaxPooling", "SpatialAveragePooling", "Reshape", "ReLU",
           "Tanh", "LogSoftMax", "GELU", "MultiHeadAttention", "ConvBN",
           "ConvBNAddReLU", "fuse_conv_bn", "Criterion",
           "ClassNLLCriterion", "CrossEntropyCriterion",
           "TimeDistributedCriterion", "Dropout", "dropout_rng",
           "InitializationMethod", "Zeros", "Ones", "ConstInitMethod",
           "RandomUniform", "RandomNormal", "Xavier", "MsraFiller",
           "BilinearFiller", "compute_fans",
           "default_weight_init", "default_bias_init"]
