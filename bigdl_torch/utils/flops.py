"""FLOP counting and the device's peak, the ``mfu`` denominator.

Counterpart of ``bigdl_tpu/utils/flops.py``.  The reference walks a jaxpr
and counts every ``dot_general`` (2·M·N·K) and ``conv_general_dilated``
(2 · prod(out) · in_features / groups · prod(kernel)); elementwise work is
free.  Here :func:`fn_flops` runs the function once under a dispatch mode
that adds up PyTorch's ``torch.utils.flop_counter`` formulas of the same
ops: ``mm``, ``addmm``, ``bmm``, ``baddbmm``, the convolutions and their
backward (:data:`COUNTED`).  (``FlopCounterMode`` itself also tracks the
module hierarchy, which a count of a whole step does not need.)  A convolution's input gradient counts as the
reference counts it: a convolution whose output is the input gradient,
2 · prod(dx) · C_out / groups · prod(kernel) (PyTorch's own formula counts
over the output gradient's positions instead, which is fewer where the
convolution pads less than ``same`` or strides).

The repo's kernels (B5, B6, B7) are ``ctypes`` launches that a dispatch
mode cannot see, so each wrapper reports its own count through
:func:`kernel`, and the products of its plain version (the CPU route) are
hidden from the counter, so one step counts the same on either route:

- B5 ``matmul_stats``: 2·R·K·N;
- B6 ``flash_attention``: 4·B·H·Tq·Tk·D (the causal mask is not
  subtracted, as the reference's count does not);
- B7 ``flash_attention_bwd``: 8·B·H·Tq·Tk·D (12 with B6, the reference's
  forward and backward);
- B1 to B4 and B8: 0 (not products).

Where nothing is counting, a wrapper pays one branch a launch
(``if flops.COUNTING``).  A count is the dispatch mode's: a kernel's
FLOPs land in the counts whose mode is on the launching thread's mode
stack (autograd carries it to its device threads for the backward), so
a launch on another thread (a serving replica, a trainer beside the
counted one) never lands in it.

:func:`device_peak_flops` gives the dense bf16 peak of the device: the
``BIGDL_TORCH_PEAK_FLOPS`` override (``"env"``), a table keyed by
``torch.cuda.get_device_name`` (``"table"``), or
:data:`CPU_NOMINAL_PEAK` for a CPU or an unknown device (``"nominal"``).
"""

from __future__ import annotations

import contextlib
import math
import threading
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from . import config

__all__ = ["fn_flops", "counting", "kernel", "device_peak_flops",
           "CPU_NOMINAL_PEAK", "COUNTED"]

# dense bf16 tensor-core peak FLOP/s by device name, from the vendor's
# data sheet ("NVIDIA H100 Tensor Core GPU" datasheet: H100 SXM 989.4
# TFLOPS bf16 dense, H100 PCIe 756, H100 NVL 835.5; A100 312); the first
# entry whose key the name contains wins
_GPU_PEAK_BF16 = (
    ("H100 80GB HBM3", 989.4e12),      # H100 SXM5
    ("H100 NVL", 835.5e12),
    ("H100 PCIe", 756.0e12),
    ("H100", 989.4e12),
    ("A100", 312.0e12),
)

# a fixed nominal denominator for the CPU: there is no honest peak for a
# shared host, but a fixed one keeps the mfu counter a regression signal
CPU_NOMINAL_PEAK = 1e12

#: the aten ops whose FLOPs count (the reference's dot and conv)
COUNTED = frozenset({
    "mm", "addmm", "bmm", "baddbmm", "convolution", "_convolution",
    "cudnn_convolution", "convolution_overrideable", "_slow_conv2d_forward",
    "convolution_backward"})


def device_peak_flops(device=None):
    """(peak FLOP/s, source) for the mfu denominator; ``source`` is
    ``"env"``, ``"table"`` or ``"nominal"``.  ``device`` defaults to the
    current CUDA device where there is one, else the CPU."""
    env = config.get_float("PEAK_FLOPS", 0.0)
    if env > 0:
        return env, "env"
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        for key, val in _GPU_PEAK_BF16:
            if key in name:
                return val, "table"
    return CPU_NOMINAL_PEAK, "nominal"


class _Count:
    """One open count: the products and convolutions the dispatch mode
    saw, and the kernels' FLOPs reported into it."""

    def __init__(self):
        self.ops = 0
        self.kernels = 0
        self.total = None
        #: why a formula failed, if one did (the count is then short)
        self.error = None


#: how many counts are open, on any thread
_open = 0
_lock = threading.Lock()
#: True while any count is open: the one branch a kernel wrapper pays
COUNTING = False


def _conv_backward(grad_out_shape, x_shape, w_shape, bias, stride, padding,
                   dilation, transposed, output_padding, groups, output_mask,
                   out_shape, **kwargs) -> int:
    """``convolution_backward``'s count: the input gradient of a
    convolution as the reference counts it (see the module's docstring),
    the rest by PyTorch's formula."""
    from torch.utils.flop_counter import conv_backward_flop
    n, mask = 0, list(output_mask)
    if mask[0] and not transposed:
        dx = out_shape[0]
        c_out, c_in_per_group, *kernel = w_shape
        n = (2 * math.prod(dx[2:]) * dx[0] * c_out * c_in_per_group
             * math.prod(kernel))
        mask[0] = False
    # the formula as written, before PyTorch's shape wrapper
    return n + conv_backward_flop.__wrapped__(
        grad_out_shape, x_shape, w_shape, bias, stride, padding, dilation,
        transposed, output_padding, groups, mask, out_shape)


def _formulas():
    """{aten op packet: FLOP formula} of the counted ops (PyTorch's
    ``flop_counter`` formulas, taking the op's arguments and its output),
    built on first use."""
    global _FORMULAS
    if _FORMULAS is None:
        from torch.utils.flop_counter import flop_registry, shape_wrapper
        out = {op: f for op, f in flop_registry.items()
               if getattr(op, "__name__", "") in COUNTED}
        out[torch.ops.aten.convolution_backward] = shape_wrapper(
            _conv_backward)
        _FORMULAS = out
    return _FORMULAS


_FORMULAS = None


class _Counting(TorchDispatchMode):
    """A dispatch mode adding each counted op's FLOPs to ``count``.  It
    sees the ops below autograd (``mm``, ``bmm``, ``convolution``, ...),
    the backward's included: autograd carries the mode to its threads."""

    def __init__(self, count: _Count):
        super().__init__()
        self.count = count
        self.formulas = _formulas()

    @classmethod
    def _should_skip_dynamo(cls):
        # the port compiles nothing; the guard PyTorch would wrap
        # __torch_dispatch__ in imports torch._dynamo, seconds on a host
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        f = self.formulas.get(func._overloadpacket)
        if f is not None:
            try:
                self.count.ops += int(f(*args, **kwargs, out_val=out))
            except Exception as e:  # noqa: BLE001 — never the op's
                self.count.error = f"{func}: {type(e).__name__}: {e}"
        return out


@contextlib.contextmanager
def counting():
    """Count the products and convolutions of the block; the object it
    yields holds the count in ``.total`` after the block (an int), and in
    ``.error`` why a formula failed, where one did (the block itself runs
    on: a count is a diagnostic)."""
    global COUNTING, _open
    c = _Count()
    mode = _Counting(c)
    with _lock:
        _open += 1
        COUNTING = True
    try:
        with mode:
            yield c
        c.total = c.ops + c.kernels
    finally:
        with _lock:
            _open -= 1
            COUNTING = bool(_open)


def kernel(n: int, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` as a kernel of ``n`` FLOPs: ``n`` is added
    to every count whose mode is on this thread's stack, and the ops
    ``fn`` runs (its plain version's, on the CPU) are not counted."""
    from torch.utils._python_dispatch import (
        _disable_current_modes, _get_current_dispatch_mode_stack)
    with _lock:
        for mode in _get_current_dispatch_mode_stack():
            if isinstance(mode, _Counting):
                mode.count.kernels += int(n)
    with _disable_current_modes():
        return fn(*args, **kwargs)


def fn_flops(fn, *args, **kwargs) -> int:
    """FLOPs of one call of ``fn(*args, **kwargs)``: products and
    convolutions, forward and whatever backward ``fn`` runs, the repo's
    kernels by their formulas.  ``fn`` runs (for real, once)."""
    with counting() as c:
        fn(*args, **kwargs)
    if c.error is not None:
        raise RuntimeError(f"fn_flops: a FLOP formula failed: {c.error}")
    return c.total

