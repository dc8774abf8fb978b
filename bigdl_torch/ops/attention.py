"""Flash attention: a hand-written CUDA kernel for Hopper, and its plain
PyTorch version.

Counterpart of ``bigdl_tpu/ops/attention.py``.  :func:`flash_attention`
launches ``bigdl_torch/csrc/flash_attention.cu`` (built with ``nvcc`` for
``sm_90a`` at first use, bound with ``ctypes``) for tensors on a CUDA
device, and computes :func:`mha_reference` for tensors on the CPU.  On a
CUDA tensor it launches the kernel or raises: there is no fallback and no
switch that selects the plain version on the card.

Forward only: serving runs under ``torch.inference_mode()``.  The backward
(``_flash_bwd_chunked`` in the reference) comes with training.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

__all__ = ["flash_attention", "mha_reference", "BLOCK_Q", "BLOCK_K",
           "HEAD_DIMS"]

#: tile sizes and head dimensions the CUDA kernel is compiled for
BLOCK_Q = 64
BLOCK_K = 64
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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


def _strides(t):
    return [int(s) for s in t.stride()[:3]]


def _kernel():
    from ..utils import cuda_build

    fn = cuda_build.load("flash_attention").bigdl_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, causal: bool, sm_scale: float):
    fn = _kernel()
    B, H, Tq, D = q.shape
    # [B, H, Tq, D] view of [B, Tq, H, D] memory: the caller's merge of the
    # heads back into [B, Tq, H*D] is then free
    o = torch.empty((B, Tq, H, D), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             _DTYPE_CODE[q.dtype], B, H, Tq, k.shape[2], D,
             *_strides(q), *_strides(k), *_strides(v), *_strides(o),
             float(sm_scale), int(bool(causal)),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err} at shape {tuple(q.shape)} x "
                           f"{tuple(k.shape)} {q.dtype}")
    with _launch_lock:
        flash_attention.launches += 1
    return o


def _check_cuda(q, k, v, block_q: int, block_k: int):
    if (block_q, block_k) != (BLOCK_Q, BLOCK_K):
        raise ValueError(f"the CUDA kernel is built with {BLOCK_Q}x{BLOCK_K}"
                         f" tiles, got block_q={block_q} block_k={block_k}")
    if any(t.requires_grad for t in (q, k, v)) and torch.is_grad_enabled():
        raise NotImplementedError(
            "flash_attention on CUDA is forward-only: the backward kernel "
            "comes with the training slice; call it under "
            "torch.inference_mode() or on tensors that need no grad")
    if not (q.dim() == k.dim() == v.dim() == 4):
        raise ValueError("q, k, v must be [B, H, T, D]")
    if q.dtype not in _DTYPE_CODE or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
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


def flash_attention(q, k, v, *, causal: bool = False,
                    sm_scale: Optional[float] = None,
                    block_q: int = BLOCK_Q, block_k: int = BLOCK_K):
    """Blockwise (flash) attention.  q, k, v: [B, H, T, D] -> [B, H, Tq, D]
    in q's dtype.  ``Tq`` may differ from ``Tk``; the causal mask is
    ``kj > qi`` with both positions counted from 0.

    CPU tensors take :func:`mha_reference`.  CUDA tensors launch the
    kernel, which reads its operands through their (B, H, T) strides, so
    transposed views need no copy (only a non-unit stride on the last axis
    forces one), and returns a [B, H, Tq, D] view of [B, Tq, H, D] memory.
    ``flash_attention.launches`` counts kernel launches."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return mha_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no route for device {q.device}")
    _check_cuda(q, k, v, block_q, block_k)
    q, k, v = (t if t.stride(3) == 1 else t.contiguous() for t in (q, k, v))
    if q.shape[2] == 0:
        return torch.empty_like(q)
    return _launch(q, k, v, causal, sm_scale)


flash_attention.launches = 0
