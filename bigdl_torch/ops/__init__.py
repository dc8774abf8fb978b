"""Kernels: each one's wrapper, launch counter and plain version."""

from .attention import flash_attention, mha_reference

__all__ = ["flash_attention", "mha_reference"]
