"""Training-mode BatchNorm: three hand-written CUDA kernels for Hopper,
their plain PyTorch versions, and ``bn_train`` as an autograd Function.

Counterpart of ``bigdl_tpu/ops/batchnorm.py``.  Every function works on x
viewed as [R, C] (rows = all leading axes, channels last):

- :func:`bn_forward` (B1, ``_bn_fwd_pallas``): (y, mean, var) with float32
  one-pass statistics (biased var = Σx²/R − mean²) and y computed in
  float32, cast to x's dtype.
- :func:`bn_backward` (B2, ``_bn_bwd_pallas``): (dx, Σdy, Σdy·x̂).
- :func:`bn_grad_stats` (B4, ``_bn_grad_stats_pallas``): (Σdy, Σdy·x̂)
  alone, for the fused conv-BN backward (``ops/convbn.py``).

Each wrapper computes its plain version (``*_reference``) for tensors on
the CPU, and on a CUDA tensor launches ``bigdl_torch/csrc/batchnorm.cu``
(built with ``nvcc`` for ``sm_90a`` at first use, bound with ``ctypes``) or
raises: there is no fallback and no switch.  ``fn.launches`` counts calls
that launched the kernel.

The plain forward follows the TPU *kernel*, which computes y in float32 and
casts (``ops/batchnorm.py:113``), not the reference's jnp oracle, which
computes y in x's dtype (``:67``); the two agree in bf16 to rounding.
The sync-BN statistics kernel (B3, ``_bn_stats_pallas``) comes with the
data-parallel slice.
"""

from __future__ import annotations

import ctypes
import threading

import torch

__all__ = ["bn_train", "bn_forward", "bn_backward", "bn_grad_stats",
           "bn_forward_reference", "bn_backward_reference",
           "bn_grad_stats_reference"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: channels per block of the stat passes (``TX`` in batchnorm.cu)
_TILE_C = 32
#: stat-pass blocks to aim for: about 8 resident on each of 132 SMs
_TARGET_BLOCKS = 1056
_MIN_CHUNK_ROWS = 64


# -- plain versions -----------------------------------------------------------

def bn_forward_reference(x2, weight, bias, eps: float):
    """(y, mean, var) of training BN over the rows of x2 [R, C]: float32
    sums, biased var by the one-pass formula, y in float32 cast to x2's
    dtype."""
    xf = x2.float()
    mean = xf.sum(0) / x2.shape[0]
    var = (xf * xf).sum(0) / x2.shape[0] - mean * mean
    inv = torch.rsqrt(var + eps)
    scale = weight.float() * inv
    shift = bias.float() - mean * scale
    return (xf * scale + shift).to(x2.dtype), mean, var


def bn_grad_stats_reference(x2, dy2, mean, inv):
    """(Σdy, Σdy·x̂) in float32 over the rows, x̂ = (x − mean)·inv."""
    dyf = dy2.float()
    xhat = (x2.float() - mean) * inv
    return dyf.sum(0), (dyf * xhat).sum(0)


def bn_backward_reference(x2, dy2, mean, inv, weight):
    """(dx, Σdy, Σdy·x̂): dx = w·inv·(dy − Σdy/R − x̂·Σdy·x̂/R) in float32,
    cast to x2's dtype (the TPU kernel's expression, ``:194``)."""
    n = x2.shape[0]
    dyf = dy2.float()
    xhat = (x2.float() - mean) * inv
    sdy, sdyx = dyf.sum(0), (dyf * xhat).sum(0)
    dx = (weight.float() * inv) * (dyf - sdy / n - xhat * sdyx / n)
    return dx.to(x2.dtype), sdy, sdyx


# -- kernels ------------------------------------------------------------------

_launch_lock = threading.Lock()
_SIGNATURES = {
    # x, w, b, y, mean, var, part, coef, dtype, R, C, eps, n_chunks, rows
    "bigdl_bn_forward": [ctypes.c_void_p] * 8 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p],
    # x, dy, mean, inv, w, dx, sdy, sdyx, part, coef, dtype, R, C, ...
    "bigdl_bn_backward": [ctypes.c_void_p] * 10 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p],
    # x, dy, mean, inv, sdy, sdyx, part, dtype, R, C, n_chunks, rows
    "bigdl_bn_grad_stats": [ctypes.c_void_p] * 7 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p],
}


def _kernel(name: str):
    from ..utils import cuda_build

    fn = getattr(cuda_build.load("batchnorm"), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return fn


def _chunks(R: int, C: int):
    """(n_chunks, rows_per_chunk) of the stat passes: enough (row chunk x
    32-channel tile) blocks to fill the card, each chunk at least 64 rows.
    Depends on the shape only, so the summation order is fixed."""
    tiles = -(-C // _TILE_C)
    n = max(1, min(-(-R // _MIN_CHUNK_ROWS), -(-_TARGET_BLOCKS // tiles)))
    rows = -(-R // n)
    return -(-R // rows), rows


def _check(name, x2, *others):
    if x2.dim() != 2 or x2.shape[0] == 0:
        raise ValueError(f"{name}: x must be [R, C] with R > 0, got "
                         f"{tuple(x2.shape)}")
    if x2.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} takes float32 or bfloat16 x, got "
                        f"{x2.dtype}")
    for t in (x2, *others):
        if t.device != x2.device:
            raise ValueError(f"{name}: operands on {t.device} and "
                             f"{x2.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def _check_vec(name, C, *vecs):
    for v in vecs:
        if v.dtype != torch.float32 or tuple(v.shape) != (C,):
            raise ValueError(f"{name}: per-channel vectors must be float32 "
                             f"[{C}], got {v.dtype} {tuple(v.shape)}")


def _check_dy(name, x2, dy2):
    if dy2.shape != x2.shape or dy2.dtype != x2.dtype:
        raise ValueError(f"{name}: dy {dy2.dtype} {tuple(dy2.shape)} must "
                         f"match x {x2.dtype} {tuple(x2.shape)}")


def _raise_on(err, name, x2):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"at {tuple(x2.shape)} {x2.dtype}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _cuda(name, x2):
    if x2.device.type != "cuda":
        raise ValueError(f"{name}: no route for device {x2.device}")


def bn_forward(x2, weight, bias, eps: float):
    """Training BN forward over x2 [R, C] (B1): (y, mean, var), stats
    float32.  CPU tensors take :func:`bn_forward_reference`."""
    if x2.device.type == "cpu":
        return bn_forward_reference(x2, weight, bias, eps)
    _cuda("bn_forward", x2)
    w, b = weight.float().contiguous(), bias.float().contiguous()
    _check("bn_forward", x2, w, b)
    R, C = x2.shape
    _check_vec("bn_forward", C, w, b)
    n_chunks, rows = _chunks(R, C)
    f32 = dict(dtype=torch.float32, device=x2.device)
    y = torch.empty_like(x2)
    mean, var = torch.empty(C, **f32), torch.empty(C, **f32)
    part = torch.empty(2 * n_chunks * C, **f32)
    coef = torch.empty(2 * C, **f32)
    err = _kernel("bigdl_bn_forward")(
        x2.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
        mean.data_ptr(), var.data_ptr(), part.data_ptr(), coef.data_ptr(),
        _DTYPE_CODE[x2.dtype], R, C, float(eps), n_chunks, rows,
        _stream(x2))
    _raise_on(err, "bn_forward", x2)
    with _launch_lock:
        bn_forward.launches += 1
    return y, mean, var


def bn_backward(x2, dy2, mean, inv, weight):
    """Training BN backward over [R, C] (B2): (dx, Σdy, Σdy·x̂).  CPU
    tensors take :func:`bn_backward_reference`."""
    if x2.device.type == "cpu":
        return bn_backward_reference(x2, dy2, mean, inv, weight)
    _cuda("bn_backward", x2)
    w = weight.float().contiguous()
    _check("bn_backward", x2, dy2, mean, inv, w)
    _check_dy("bn_backward", x2, dy2)
    R, C = x2.shape
    _check_vec("bn_backward", C, mean, inv, w)
    n_chunks, rows = _chunks(R, C)
    f32 = dict(dtype=torch.float32, device=x2.device)
    dx = torch.empty_like(x2)
    sdy, sdyx = torch.empty(C, **f32), torch.empty(C, **f32)
    part = torch.empty(2 * n_chunks * C, **f32)
    coef = torch.empty(3 * C, **f32)
    err = _kernel("bigdl_bn_backward")(
        x2.data_ptr(), dy2.data_ptr(), mean.data_ptr(), inv.data_ptr(),
        w.data_ptr(), dx.data_ptr(), sdy.data_ptr(), sdyx.data_ptr(),
        part.data_ptr(), coef.data_ptr(), _DTYPE_CODE[x2.dtype], R, C,
        n_chunks, rows, _stream(x2))
    _raise_on(err, "bn_backward", x2)
    with _launch_lock:
        bn_backward.launches += 1
    return dx, sdy, sdyx


def bn_grad_stats(x2, dy2, mean, inv):
    """(Σdy, Σdy·x̂) over the rows of [R, C] (B4), float32.  CPU tensors
    take :func:`bn_grad_stats_reference`."""
    if x2.device.type == "cpu":
        return bn_grad_stats_reference(x2, dy2, mean, inv)
    _cuda("bn_grad_stats", x2)
    _check("bn_grad_stats", x2, dy2, mean, inv)
    _check_dy("bn_grad_stats", x2, dy2)
    R, C = x2.shape
    _check_vec("bn_grad_stats", C, mean, inv)
    n_chunks, rows = _chunks(R, C)
    f32 = dict(dtype=torch.float32, device=x2.device)
    sdy, sdyx = torch.empty(C, **f32), torch.empty(C, **f32)
    part = torch.empty(2 * n_chunks * C, **f32)
    err = _kernel("bigdl_bn_grad_stats")(
        x2.data_ptr(), dy2.data_ptr(), mean.data_ptr(), inv.data_ptr(),
        sdy.data_ptr(), sdyx.data_ptr(), part.data_ptr(),
        _DTYPE_CODE[x2.dtype], R, C, n_chunks, rows, _stream(x2))
    _raise_on(err, "bn_grad_stats", x2)
    with _launch_lock:
        bn_grad_stats.launches += 1
    return sdy, sdyx


bn_forward.launches = 0
bn_backward.launches = 0
bn_grad_stats.launches = 0


# -- differentiable entry point -----------------------------------------------

class _BNTrain(torch.autograd.Function):
    """y = BN_train(x; weight, bias) over the last axis, with the batch
    statistics as outputs that carry no gradient (the reference's
    ``bn_train`` custom VJP ignores their cotangents, ``:248-282``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        C = x.shape[-1]
        y, mean, var = bn_forward(x.reshape(-1, C), weight, bias, eps)
        inv = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, mean, inv, weight)
        ctx.mark_non_differentiable(mean, var)
        return y.reshape(x.shape), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, inv, weight = ctx.saved_tensors
        C = x.shape[-1]
        dx, sdy, sdyx = bn_backward(x.reshape(-1, C),
                                    dy.contiguous().reshape(-1, C),
                                    mean, inv, weight)
        return (dx.reshape(x.shape), sdyx.to(weight.dtype),
                sdy.to(weight.dtype), None)


def bn_train(x, weight, bias, eps: float):
    """Training-mode BN: (x[..., C], weight[C], bias[C]) -> (y, mean, var).

    mean and var are the biased float32 batch statistics for the caller's
    running EMA; they are not differentiable.  The forward is B1, the
    backward B2; x must be contiguous."""
    return _BNTrain.apply(x, weight, bias, eps)
