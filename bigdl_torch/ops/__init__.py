"""Kernels: each one's wrapper, launch counter and plain version."""

from .attention import flash_attention, mha_reference
from .batchnorm import (bn_backward, bn_backward_reference, bn_forward,
                        bn_forward_reference, bn_grad_stats,
                        bn_grad_stats_reference, bn_train)
from .convbn import (fused_conv_bn_add_relu_train, fused_conv_bn_train,
                     matmul_stats, matmul_stats_reference)

__all__ = ["flash_attention", "mha_reference", "bn_train", "bn_forward",
           "bn_backward", "bn_grad_stats", "bn_forward_reference",
           "bn_backward_reference", "bn_grad_stats_reference",
           "matmul_stats", "matmul_stats_reference", "fused_conv_bn_train",
           "fused_conv_bn_add_relu_train"]
