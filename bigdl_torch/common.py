"""Global configuration: dtype policy, default init generator, devices.

Counterpart of ``bigdl_tpu/common.py``.  Parameters are stored in
``param_dtype`` (float32) while matrix products and activations may run in
``compute_dtype`` (bfloat16 on the bench configs), and gradients are
rounded through ``wire_dtype`` (bfloat16 by default, the reference's
bf16-truncated gradient wire) before the update.  The default generator is
a CPU ``torch.Generator``: parameter init draws on the host and moves to the
device, so one seed gives the same weights on every device.
"""

from __future__ import annotations

import torch

from .utils import config

__all__ = ["DTypePolicy", "get_policy", "set_policy", "set_seed",
           "default_generator", "resolve_device"]


class DTypePolicy:
    """Dtype policy: parameter storage dtype, compute dtype, and the wire
    dtype every gradient is rounded through before the update, on one
    device as on many (``None``: no rounding)."""

    def __init__(self, param_dtype: torch.dtype = torch.float32,
                 compute_dtype: torch.dtype = torch.float32,
                 wire_dtype: torch.dtype = torch.bfloat16):
        self.param_dtype = param_dtype
        self.compute_dtype = compute_dtype
        self.wire_dtype = wire_dtype

    def __repr__(self):
        return (f"DTypePolicy(param={self.param_dtype}, "
                f"compute={self.compute_dtype}, wire={self.wire_dtype})")


_policy = DTypePolicy()


def get_policy() -> DTypePolicy:
    return _policy


def set_policy(policy: DTypePolicy) -> None:
    global _policy
    _policy = policy


_generator = torch.Generator().manual_seed(config.seed())


def default_generator() -> torch.Generator:
    """The process-wide init generator (seeded from ``BIGDL_TORCH_SEED``)."""
    return _generator


def set_seed(seed: int) -> None:
    """Global deterministic seed (BigDL: RandomGenerator.RNG.setSeed)."""
    _generator.manual_seed(seed)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    current CUDA device.  With no device and no CUDA it raises: the port
    never carries on silently on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the host")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
