"""Flash attention: a hand-written CUDA kernel for Hopper, and its plain
PyTorch version.

Counterpart of ``bigdl_tpu/ops/attention.py``.  :func:`flash_attention`
launches ``bigdl_torch/csrc/flash_attention.cu`` (built with ``nvcc`` for
``sm_90a`` at first use, bound with ``ctypes``) for tensors on a CUDA
device, and computes :func:`mha_reference` for tensors on the CPU.  On a
CUDA tensor it launches a kernel or raises: there is no fallback and no
switch that selects the plain version on the card.

The operands' dtype picks the kernel (:func:`route`): bf16 takes ``"tc"``,
the tensor-core kernel fed by TMA (128 x 128 tiles), float32 ``"f32"``,
the CUDA-core kernel (64 x 64 tiles) that keeps p in float32 for parity
checks.  ``flash_attention.launches`` counts every launch and
``flash_attention.route_launches`` each route's.

Forward only: serving runs under ``torch.inference_mode()``.  The backward
(``_flash_bwd_chunked`` in the reference) comes with training.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

__all__ = ["flash_attention", "mha_reference", "route", "tma_ready",
           "BLOCK_Q", "BLOCK_K", "HEAD_DIMS"]

#: the routes' kernels by operand dtype, and their codes in the C interface
ROUTES = {torch.float32: "f32", torch.bfloat16: "tc"}
_ROUTE_CODE = {"f32": 0, "tc": 1}
#: tile sizes each route's kernel is compiled for, and its head dimensions
BLOCK_Q = {"f32": 64, "tc": 128}
BLOCK_K = {"f32": 64, "tc": 128}
HEAD_DIMS = (32, 64, 128)


def mha_reference(q, k, v, *, causal: bool = False,
                  sm_scale: Optional[float] = None,
                  q_offset: int = 0, k_offset: int = 0):
    """Exact attention in plain PyTorch.  q, k, v: [B, H, T, D].

    Scores are taken in float32; p is rounded to v's dtype before the P.V
    product, as the reference does.  ``q_offset``/``k_offset`` are the
    global positions of q[..., 0, :] and k[..., 0, :] under the causal
    mask.  Rows with every key masked give 0."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        qi = q_offset + torch.arange(q.shape[2], device=q.device)[:, None]
        kj = k_offset + torch.arange(k.shape[2], device=q.device)[None, :]
        s = s.masked_fill(kj > qi, float("-inf"))
    p = torch.softmax(s, dim=-1)
    # softmax of an all -inf row is NaN: such rows are meaningless, give 0
    p = torch.where(torch.isnan(p), 0.0, p)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


_launch_lock = threading.Lock()


def route(dtype) -> str:
    """The kernel that takes q, k, v of ``dtype`` on the card."""
    if dtype not in ROUTES:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v, "
                        f"got {dtype}")
    return ROUTES[dtype]


def tma_ready(t) -> bool:
    """Whether a tensor map can describe the [B, H, T, D] operand ``t`` in
    place: unit last stride, base 16-byte aligned, and the B, H, T strides
    of its non-unit axes positive multiples of 16 bytes."""
    n, st = t.shape, t.stride()
    if st[3] != 1 or t.data_ptr() % 16:
        return False
    step = 16 // t.element_size()
    for i in range(3):
        if n[i] > 1 and (st[i] <= 0 or st[i] % step):
            return False
    return True


def _strides(t):
    # an axis of size 1 is never stepped along: give it a stride a tensor
    # map takes (a positive multiple of 16 bytes)
    n, st = t.shape, t.stride()
    return [st[i] if n[i] > 1 else 8 * t.numel() for i in range(3)]


def _kernel():
    from ..utils import cuda_build

    fn = cuda_build.load("flash_attention").bigdl_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, causal: bool, sm_scale: float, rt: str):
    fn = _kernel()
    B, H, Tq, D = q.shape
    # [B, H, Tq, D] view of [B, Tq, H, D] memory: the caller's merge of the
    # heads back into [B, Tq, H*D] is then free
    o = torch.empty((B, Tq, H, D), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             _ROUTE_CODE[rt], B, H, Tq, k.shape[2], D,
             *_strides(q), *_strides(k), *_strides(v), *_strides(o),
             float(sm_scale), int(bool(causal)),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err} at shape {tuple(q.shape)} x "
                           f"{tuple(k.shape)} {q.dtype}")
    with _launch_lock:
        flash_attention.launches += 1
        flash_attention.route_launches[rt] += 1
    return o


def _check_cuda(q, k, v, block_q=None, block_k=None) -> str:
    """Refuse what no kernel takes; returns the route."""
    if any(t.requires_grad for t in (q, k, v)) and torch.is_grad_enabled():
        raise NotImplementedError(
            "flash_attention on CUDA is forward-only: the backward kernel "
            "comes with the training slice; call it under "
            "torch.inference_mode() or on tensors that need no grad")
    if not (q.dim() == k.dim() == v.dim() == 4):
        raise ValueError("q, k, v must be [B, H, T, D]")
    if q.dtype not in ROUTES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    rt = route(q.dtype)
    tiles = (BLOCK_Q[rt], BLOCK_K[rt])
    if (block_q or tiles[0], block_k or tiles[1]) != tiles:
        raise ValueError(f"the {rt!r} kernel is built with {tiles[0]}x"
                         f"{tiles[1]} tiles, got block_q={block_q} "
                         f"block_k={block_k}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    B, H, _, D = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[3] != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} has no kernel instance "
                         f"(built for {HEAD_DIMS})")
    if B * H >= 1 << 16:
        raise ValueError(f"B*H = {B * H} exceeds the kernel's grid limit "
                         "of 65535")
    return rt


def _operand(t, rt: str):
    """``t`` as the route's kernel reads it: in place where it can,
    otherwise a contiguous copy (a fresh, aligned buffer)."""
    if rt == "tc":
        return t if tma_ready(t) else t.clone(
            memory_format=torch.contiguous_format)
    return t if t.stride(3) == 1 else t.contiguous()


def flash_attention(q, k, v, *, causal: bool = False,
                    sm_scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None):
    """Blockwise (flash) attention.  q, k, v: [B, H, T, D] -> [B, H, Tq, D]
    in q's dtype.  ``Tq`` may differ from ``Tk``; the causal mask is
    ``kj > qi`` with both positions counted from 0.  ``block_q`` and
    ``block_k`` default to the route's tiles, the only ones built.

    CPU tensors take :func:`mha_reference`.  CUDA tensors launch the
    route's kernel, which reads its operands through their (B, H, T)
    strides, so transposed views need no copy (only an operand no kernel
    can read in place, see :func:`tma_ready`, is copied), and returns a
    [B, H, Tq, D] view of [B, Tq, H, D] memory."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return mha_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no route for device {q.device}")
    rt = _check_cuda(q, k, v, block_q, block_k)
    if q.shape[2] == 0 or k.shape[2] == 0:
        # no rows, or no keys: every row is fully masked and gives 0
        return torch.zeros_like(q)
    q, k, v = (_operand(t, rt) for t in (q, k, v))
    return _launch(q, k, v, causal, sm_scale, rt)


flash_attention.launches = 0
flash_attention.route_launches = {"tc": 0, "f32": 0}
