"""Torch-style layer library: the counterpart of ``bigdl_tpu.nn``, every
class of which it exports."""

from .activation import (ELU, GELU, HardShrink, HardTanh, LeakyReLU,
                         LogSigmoid, LogSoftMax, PReLU, ReLU, ReLU6, RReLU,
                         Sigmoid, SoftMax, SoftMin, SoftPlus, SoftShrink,
                         SoftSign, Tanh, TanhShrink, Threshold)
from .attention import MultiHeadAttention
from .containers import (Bottle, Concat, ConcatTable, Echo, Identity,
                         MapTable, ParallelTable, Sequential)
from .conv import (SpatialConvolution, SpatialConvolutionMap,
                   SpatialDilatedConvolution, SpatialFullConvolution,
                   SpatialShareConvolution, TemporalConvolution,
                   VolumetricConvolution)
from .criterion import (
    AbsCriterion, BCECriterion, ClassNLLCriterion, ClassSimplexCriterion,
    CosineDistanceCriterion, CosineEmbeddingCriterion, Criterion,
    CrossEntropyCriterion, DiceCoefficientCriterion, DistKLDivCriterion,
    HingeEmbeddingCriterion, L1Cost, L1HingeEmbeddingCriterion, L1Penalty,
    MarginCriterion, MarginRankingCriterion, MSECriterion, MultiCriterion,
    MultiLabelMarginCriterion, MultiLabelSoftMarginCriterion,
    MultiMarginCriterion, ParallelCriterion, SmoothL1Criterion,
    SmoothL1CriterionWithWeights, SoftMarginCriterion, SoftmaxWithCriterion,
    TimeDistributedCriterion)
from .detection import Nms
from .dropout import Dropout, GradientReversal, dropout_rng
from .embedding import LookupTable
from .fused import ConvBN, ConvBNAddReLU, fuse_conv_bn
from .graph import Graph, Input, ModuleNode
from .initialization import (BilinearFiller, ConstInitMethod,
                             InitializationMethod, MsraFiller, Ones,
                             RandomNormal, RandomUniform, Xavier, Zeros,
                             compute_fans, default_bias_init,
                             default_weight_init)
from .linear import (Add, AddConstant, Bilinear, CAdd, CMul, Linear, Mul,
                     MulConstant)
from .math_ops import (MM, MV, Abs, Clamp, Cosine, CosineDistance,
                       DotProduct, Euclidean, Exp, Log, Max, Mean, Min,
                       PairwiseDistance, Power, Scale, Sqrt, Square, Sum)
from .module import Container, Module, ReferenceModuleFile
from .normalization import (BatchNormalization, LayerNorm, Normalize,
                            SpatialBatchNormalization,
                            SpatialContrastiveNormalization,
                            SpatialCrossMapLRN, SpatialDivisiveNormalization,
                            SpatialSubtractiveNormalization,
                            SpatialWithinChannelLRN)
from .pooling import (RoiPooling, SpatialAveragePooling, SpatialMaxPooling,
                      VolumetricMaxPooling)
from .recurrent import (GRU, LSTM, BiRecurrent, Cell, ConvLSTMPeephole,
                        ConvLSTMPeephole3D, LSTMPeephole, Recurrent, RnnCell,
                        TimeDistributed)
from .shape import (Contiguous, Index, InferReshape, MaskedSelect, Narrow,
                    Padding, Replicate, Reshape, Reverse, Select,
                    SpatialZeroPadding, Squeeze, Transpose, Unsqueeze, View)
from .table_ops import (CAddTable, CDivTable, CMaxTable, CMinTable,
                        CMulTable, CSubTable, FlattenTable, JoinTable,
                        MixtureTable, NarrowTable, Pack, SelectTable,
                        SplitTable)
from .tree import BinaryTreeLSTM, TreeLSTM

__all__ = [
    "Module", "Container", "ReferenceModuleFile", "Criterion",
    # containers
    "Sequential", "Concat", "ConcatTable", "ParallelTable", "MapTable",
    "Identity", "Echo", "Bottle", "Graph", "Input", "ModuleNode",
    # activations
    "ReLU", "ReLU6", "PReLU", "RReLU", "LeakyReLU", "ELU", "GELU", "Tanh",
    "TanhShrink", "Sigmoid", "SoftMax", "SoftMin", "SoftPlus", "SoftSign",
    "SoftShrink", "HardShrink", "HardTanh", "Threshold", "LogSoftMax",
    "LogSigmoid",
    # dense and elementwise-parameter layers
    "Linear", "Bilinear", "CMul", "CAdd", "Mul", "Add", "MulConstant",
    "AddConstant",
    # convolutions, pooling, normalizations
    "SpatialConvolution", "SpatialDilatedConvolution",
    "SpatialFullConvolution", "TemporalConvolution", "VolumetricConvolution",
    "SpatialShareConvolution", "SpatialConvolutionMap",
    "SpatialMaxPooling", "SpatialAveragePooling", "VolumetricMaxPooling",
    "RoiPooling", "Nms",
    "BatchNormalization", "SpatialBatchNormalization", "LayerNorm",
    "Normalize", "SpatialCrossMapLRN", "SpatialWithinChannelLRN",
    "SpatialSubtractiveNormalization", "SpatialDivisiveNormalization",
    "SpatialContrastiveNormalization",
    "Dropout", "GradientReversal", "dropout_rng", "LookupTable",
    # shape
    "Reshape", "InferReshape", "View", "Transpose", "Replicate", "Squeeze",
    "Unsqueeze", "Select", "Narrow", "Index", "MaskedSelect", "Reverse",
    "Padding", "SpatialZeroPadding", "Contiguous",
    # math
    "Power", "Sqrt", "Square", "Clamp", "Max", "Min", "Mean", "Sum", "Exp",
    "Log", "Abs", "Scale", "MM", "MV", "Cosine", "Euclidean", "DotProduct",
    "PairwiseDistance", "CosineDistance",
    # tables
    "CAddTable", "CSubTable", "CMulTable", "CDivTable", "CMaxTable",
    "CMinTable", "JoinTable", "SplitTable", "NarrowTable", "FlattenTable",
    "SelectTable", "MixtureTable", "Pack",
    # recurrent
    "Cell", "RnnCell", "LSTM", "LSTMPeephole", "GRU", "ConvLSTMPeephole",
    "ConvLSTMPeephole3D", "Recurrent", "TimeDistributed", "BiRecurrent",
    "TreeLSTM", "BinaryTreeLSTM",
    # criteria
    "AbsCriterion", "BCECriterion", "ClassNLLCriterion",
    "ClassSimplexCriterion", "CosineDistanceCriterion",
    "CosineEmbeddingCriterion", "CrossEntropyCriterion",
    "DiceCoefficientCriterion", "DistKLDivCriterion",
    "HingeEmbeddingCriterion", "L1Cost", "L1HingeEmbeddingCriterion",
    "L1Penalty", "MarginCriterion", "MarginRankingCriterion",
    "MSECriterion", "MultiCriterion", "MultiLabelMarginCriterion",
    "MultiLabelSoftMarginCriterion", "MultiMarginCriterion",
    "ParallelCriterion", "SmoothL1Criterion",
    "SmoothL1CriterionWithWeights", "SoftMarginCriterion",
    "SoftmaxWithCriterion", "TimeDistributedCriterion",
    # fused and attention
    "MultiHeadAttention", "ConvBN", "ConvBNAddReLU", "fuse_conv_bn",
    # initialization
    "InitializationMethod", "Zeros", "Ones", "ConstInitMethod",
    "RandomUniform", "RandomNormal", "Xavier", "MsraFiller",
    "BilinearFiller", "compute_fans", "default_weight_init",
    "default_bias_init"]
