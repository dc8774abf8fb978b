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
checks.  ``flash_attention.launches`` counts every launch,
``flash_attention.route_launches`` each route's and
``flash_attention.lse_launches`` those that wrote the log-sum-exp.

Training: where autograd records (grad mode on and an operand that needs
a gradient) :func:`flash_attention` goes through :class:`FlashAttention`,
a ``torch.autograd.Function`` (the reference's ``_flash_diff``
``custom_vjp``, ``:165-180`` and ``:255-258``).  Its forward is the call
above, which on the card also writes each row's log-sum-exp (float32
[B, H, Tq], :func:`flash_lse_reference` is its plain version); its
backward is :func:`flash_attention_bwd` (B7), which takes that
log-sum-exp: on the card the hand-written
``bigdl_torch/csrc/flash_attention_bwd.cu`` (two launches; route ``"tc"``
for bf16, wgmma fed by TMA, and ``"f32"`` for float32, the CUDA cores), on
the CPU :func:`flash_bwd_reference`, the port of ``_flash_bwd_chunked``.
``flash_attention_bwd.launches`` and ``.route_launches`` count it.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch
import torch.nn.functional as F

from ..utils import flops

__all__ = ["flash_attention", "flash_attention_with_lse", "mha_reference",
           "flash_lse_reference", "route", "tma_ready", "FlashAttention",
           "flash_attention_bwd", "flash_bwd_reference", "bwd_route",
           "BLOCK_Q", "BLOCK_K", "HEAD_DIMS"]

#: the routes' kernels by operand dtype, and their codes in the C interface
ROUTES = {torch.float32: "f32", torch.bfloat16: "tc"}
_ROUTE_CODE = {"f32": 0, "tc": 1}
#: tile sizes each route's kernel is compiled for, and its head dimensions
BLOCK_Q = {"f32": 64, "tc": 128}
BLOCK_K = {"f32": 64, "tc": 128}
HEAD_DIMS = (16, 32, 64, 128)
#: the backward's kernel by operand dtype, and its code in the C interface
BWD_ROUTES = {torch.float32: "f32", torch.bfloat16: "tc"}
_BWD_ROUTE_CODE = {"f32": 0, "tc": 1}
#: query rows per block of the reference's backward scan
BWD_BLOCK_Q = 128


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


def flash_lse_reference(q, k, *, causal: bool = False,
                        sm_scale: Optional[float] = None,
                        q_offset: int = 0, k_offset: int = 0):
    """Each row's natural log-sum-exp of its scaled, masked scores, in
    plain PyTorch: float32 [B, H, Tq], what the forward kernel writes for
    the backward.  Scores and masks as in :func:`mha_reference`; a row with
    every key masked gives 0."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        qi = q_offset + torch.arange(q.shape[2], device=q.device)[:, None]
        kj = k_offset + torch.arange(k.shape[2], device=q.device)[None, :]
        s = s.masked_fill(kj > qi, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    return torch.where(torch.isfinite(lse), lse, 0.0)


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


def _bhtd_like(t):
    """An empty [B, H, T, D] view of [B, T, H, D] memory, like ``t``: the
    layout the caller's merge of the heads reads for free."""
    B, H, T, D = t.shape
    return torch.empty((B, T, H, D), dtype=t.dtype,
                       device=t.device).transpose(1, 2)


def _kernel():
    from ..utils import cuda_build

    fn = cuda_build.load("flash_attention").bigdl_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, causal: bool, sm_scale: float, rt: str,
            with_lse: bool):
    fn = _kernel()
    B, H, Tq, D = q.shape
    o = _bhtd_like(q)
    lse = (torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr() if with_lse else None,
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
        flash_attention.lse_launches += bool(with_lse)
    return o, lse


def _check_cuda(q, k, v, block_q=None, block_k=None) -> str:
    """Refuse what no kernel takes; returns the route."""
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
    otherwise a contiguous copy (a fresh, aligned buffer).  The
    tensor-core routes (B6 and B7 ``"tc"``) load 16 bytes at a time
    (:func:`tma_ready`); the ``"f32"`` routes take any unit last
    stride."""
    if rt == "tc":
        return t if tma_ready(t) else t.clone(
            memory_format=torch.contiguous_format)
    return t if t.stride(3) == 1 else t.contiguous()


def _flops(q, k, per: int) -> int:
    """``per``·B·H·Tq·Tk·D, B6's (4) or B7's (8) count for an open FLOP
    count (``utils/flops.py``), the mask not subtracted."""
    B, H, Tq, D = q.shape
    return per * B * H * Tq * k.shape[2] * D


def _forward(q, k, v, causal: bool, sm_scale: float,
             with_lse: bool = False):
    """(o, lse) on ``q``'s device: the plain version on the CPU, B6 on
    CUDA.  ``lse`` is None unless ``with_lse``: then on CUDA the kernel
    writes it beside o, on the CPU :func:`flash_lse_reference` computes
    it."""
    if flops.COUNTING:
        return flops.kernel(_flops(q, k, 4), _forward_impl, q, k, v, causal,
                            sm_scale, with_lse)
    return _forward_impl(q, k, v, causal, sm_scale, with_lse)


def _forward_impl(q, k, v, causal, sm_scale, with_lse):
    if q.device.type == "cpu":
        o = mha_reference(q, k, v, causal=causal, sm_scale=sm_scale)
        return o, (flash_lse_reference(q, k, causal=causal,
                                       sm_scale=sm_scale)
                   if with_lse else None)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no route for device {q.device}")
    rt = _check_cuda(q, k, v)
    if q.shape[2] == 0 or k.shape[2] == 0:
        # no rows, or no keys: every row is fully masked and gives 0
        B, H, Tq, _ = q.shape
        return torch.zeros_like(q), (torch.zeros(
            (B, H, Tq), dtype=torch.float32, device=q.device)
            if with_lse else None)
    q, k, v = (_operand(t, rt) for t in (q, k, v))
    return _launch(q, k, v, causal, sm_scale, rt, with_lse)


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (the reference's ``_flash_diff``):
    the forward of :func:`flash_attention`, and :func:`flash_attention_bwd`
    as its backward.  It saves q, k, v, the output o (the backward's
    rowsum(do * o)) and, on the card, the log-sum-exp the forward kernel
    writes beside o (the CPU's backward recomputes it)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        o, lse = _forward(q, k, v, causal, sm_scale,
                          with_lse=q.device.type == "cuda")
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse=lse,
                                         causal=ctx.causal,
                                         sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None


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
    [B, H, Tq, D] view of [B, Tq, H, D] memory.  Where autograd records,
    the call goes through :class:`FlashAttention`."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        _check_cuda(q, k, v, block_q, block_k)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, sm_scale)
    return _forward(q, k, v, causal, sm_scale)[0]


def flash_attention_with_lse(q, k, v, *, causal: bool = False,
                             sm_scale: Optional[float] = None):
    """(o, lse): :func:`flash_attention`'s output and each row's natural
    log-sum-exp, float32 [B, H, Tq] (0 for a row whose every key is
    masked), the pair :class:`FlashAttention` saves for
    :func:`flash_attention_bwd`.  On CUDA one B6 launch writes both; on
    the CPU they are :func:`mha_reference` and :func:`flash_lse_reference`.
    Records no autograd graph."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    with torch.no_grad():
        return _forward(q, k, v, causal, sm_scale, with_lse=True)


flash_attention.launches = 0
flash_attention.route_launches = {"tc": 0, "f32": 0}
#: the launches that also wrote the log-sum-exp (training's forward)
flash_attention.lse_launches = 0


# -- the backward (B7) --------------------------------------------------------

def flash_bwd_reference(q, k, v, do, *, causal: bool = False,
                        sm_scale: Optional[float] = None,
                        block_q: int = BWD_BLOCK_Q,
                        q_offset: int = 0, k_offset: int = 0):
    """(dq, dk, dv) of attention in plain PyTorch: the reference's
    ``_flash_bwd_chunked`` (``:182-253``), a loop over blocks of
    ``block_q`` query rows that rebuilds each block's probabilities and
    accumulates dk and dv in float32.  Math is float32; results are in the
    operands' dtype.  The query tail is padded with zero rows (whose zero
    do contributes nothing); a row whose every key is masked gets zero
    gradient (its non-finite max goes to 0 and its zero sum to 1).
    ``q_offset``/``k_offset`` place the causal mask as in
    :func:`mha_reference`, of which this is the backward."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    kf, vf = k.float(), v.float()
    dk = torch.zeros((B, H, Tk, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    dq = torch.zeros((B, H, Tq, D), dtype=torch.float32, device=q.device)
    c = min(block_q, Tq)
    col = k_offset + torch.arange(Tk, device=q.device)
    for r0 in range(0, Tq, max(c, 1)):
        qc = q[:, :, r0:r0 + c].float()
        gc = do[:, :, r0:r0 + c].float()
        if qc.shape[2] < c:  # the padded tail: zero rows, zero do
            pad = (0, 0, 0, c - qc.shape[2])
            qc, gc = F.pad(qc, pad), F.pad(gc, pad)
        s = torch.einsum("bhqd,bhkd->bhqk", qc, kf) * sm_scale
        if causal:
            row = q_offset + r0 + torch.arange(c, device=q.device)
            s = s.masked_fill(row[:, None] < col[None, :], float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, 0.0)
        p = torch.exp(s - m)
        denom = p.sum(dim=-1, keepdim=True)
        p = p / torch.where(denom == 0.0, 1.0, denom)
        dv += torch.einsum("bhqk,bhqd->bhkd", p, gc)
        dp = torch.einsum("bhqd,bhkd->bhqk", gc, vf)
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
        n = min(c, Tq - r0)
        dq[:, :, r0:r0 + n] = (torch.einsum("bhqk,bhkd->bhqd", ds, kf)
                               * sm_scale)[:, :, :n]
        dk += torch.einsum("bhqk,bhqd->bhkd", ds, qc) * sm_scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bwd_route(dtype) -> str:
    """The backward kernel that takes operands of ``dtype`` on the card."""
    if dtype not in BWD_ROUTES:
        raise TypeError(f"flash_attention_bwd takes float32 or bfloat16 "
                        f"operands, got {dtype}")
    return BWD_ROUTES[dtype]


def _bwd_kernel():
    from ..utils import cuda_build

    fn = cuda_build.load("flash_attention_bwd").bigdl_flash_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _bwd_launch(q, k, v, o, do, lse, causal: bool, sm_scale: float,
                rt: str):
    fn = _bwd_kernel()
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    dq, dk, dv = _bhtd_like(q), _bhtd_like(k), _bhtd_like(v)
    # rowsum(do * o): launch 1 writes it, launch 2 reads it
    delta = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    strides = torch.tensor([s for t in (q, k, v, o, do, dq, dk, dv)
                            for s in _strides(t)], dtype=torch.int64)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             lse.data_ptr(), delta.data_ptr(),
             _BWD_ROUTE_CODE[rt], B, H, Tq, Tk, D, strides.data_ptr(),
             float(sm_scale), int(bool(causal)),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {err} at shape {tuple(q.shape)} x "
                           f"{tuple(k.shape)} {q.dtype}")
    with _launch_lock:
        flash_attention_bwd.launches += 2
        flash_attention_bwd.route_launches[rt] += 2
    return dq, dk, dv


def _check_bwd(q, k, v, o, do, lse) -> str:
    """Refuse what the backward kernels do not take; returns the route.
    Besides :func:`_check_cuda`'s rules: o and do shaped and typed like q,
    and the forward's log-sum-exp, float32 [B, H, Tq] contiguous on q's
    device (the kernels never recompute it)."""
    _check_cuda(q, k, v)
    rt = bwd_route(q.dtype)
    if o.shape != q.shape or do.shape != q.shape or not (
            o.dtype == do.dtype == q.dtype):
        raise ValueError(f"o {tuple(o.shape)} {o.dtype} and do "
                         f"{tuple(do.shape)} {do.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype}")
    if lse is None:
        raise ValueError("flash_attention_bwd on CUDA takes the forward's "
                         "log-sum-exp (lse=, from flash_attention_with_lse "
                         "or FlashAttention); it does not recompute it")
    if (lse.shape != q.shape[:3] or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be float32 {tuple(q.shape[:3])} "
                         f"contiguous on {q.device}, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")
    return rt


def flash_attention_bwd(q, k, v, o, do, *, lse=None, causal: bool = False,
                        sm_scale: Optional[float] = None):
    """(dq, dk, dv) of :func:`flash_attention`'s output ``o`` against its
    gradient ``do``, all [B, H, T, D] (B7), given the forward's
    log-sum-exp ``lse`` (float32 [B, H, Tq], :func:`flash_attention_with_lse`).
    CPU tensors take :func:`flash_bwd_reference` (``o`` and ``lse``
    unused).  CUDA tensors need ``lse`` (a ``ValueError`` without it) and
    launch the backward kernel of their dtype's route, two launches (dq
    with rowsum(do * o), then dk and dv), reading every operand through its
    (B, H, T) strides; the gradients come back as [B, H, T, D] views of
    [B, T, H, D] memory."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if flops.COUNTING:
        return flops.kernel(_flops(q, k, 8), _bwd, q, k, v, o, do, lse,
                            causal, sm_scale)
    return _bwd(q, k, v, o, do, lse, causal, sm_scale)


def _bwd(q, k, v, o, do, lse, causal, sm_scale):
    if q.shape[2] == 0 or k.shape[2] == 0:
        # no rows, or no keys: nothing attends, every gradient is 0
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, do, causal=causal,
                                   sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: no route for device "
                         f"{q.device}")
    rt = _check_bwd(q, k, v, o, do, lse)
    q, k, v, o, do = (_operand(t, rt) for t in (q, k, v, o, do))
    return _bwd_launch(q, k, v, o, do, lse, causal, sm_scale, rt)


flash_attention_bwd.launches = 0
flash_attention_bwd.route_launches = {"f32": 0, "tc": 0}
