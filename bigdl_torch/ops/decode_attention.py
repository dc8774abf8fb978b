"""Cached decode attention (B8): a hand-written CUDA kernel for Hopper, and
its plain PyTorch version.

One query row per (slot, head) against a KV cache, each slot at its own
position: the attention of every decode tick and every prefill position.
It is the counterpart of the jnp attention in
``bigdl_tpu/serve/decode.py`` ``_slot_attention`` (``:146-155``) and
``bigdl_tpu/models/decode.py`` ``_cached_attention``: scores in float32
divided by sqrt(D), keys past a slot's position at exactly zero weight,
a float32 softmax and P.V, cast to q's dtype.

:func:`decode_attention` launches ``bigdl_torch/csrc/decode_attention.cu``
(built with ``nvcc`` for ``sm_90a`` at first use, bound with ``ctypes``)
for tensors on a CUDA device, and computes
:func:`decode_attention_reference` for tensors on the CPU.  On a CUDA tensor
it launches the kernel or raises: there is no fallback and no switch.  The
route is q's dtype: ``"bf16"`` or ``"f32"`` (the cache may be either).
``decode_attention.launches`` counts every launch and
``decode_attention.route_launches`` each route's.  The caller appends the
new k and v to the cache before the call (``models/decode.py``).
"""

from __future__ import annotations

import ctypes
import threading

import torch

__all__ = ["decode_attention", "decode_attention_reference", "route",
           "HEAD_DIMS", "MAX_LEN"]

#: the route by q's dtype
ROUTES = {torch.bfloat16: "bf16", torch.float32: "f32"}
#: head dimensions the kernel is compiled for
HEAD_DIMS = (16, 32, 64, 128)
#: the longest cache the kernel takes: its scores stage in shared memory,
#: 4 bytes a key
MAX_LEN = 32768

_launch_lock = threading.Lock()


def decode_attention_reference(q, k_cache, v_cache, pos):
    """The plain version, line for line the reference's
    (``bigdl_tpu/serve/decode.py:146-155``): q [S, H, 1, D], caches
    [S, H, L, D], pos int [S] -> [S, H, 1, D] in q's dtype.  A float32
    einsum over the whole cache length, -inf past each slot's position,
    softmax, einsum with V, cast."""
    L, D = k_cache.shape[2], q.shape[-1]
    scores = torch.einsum("bhqd,bhld->bhql", q.float(),
                          k_cache.float()) / (D ** 0.5)
    live = (torch.arange(L, device=q.device)[None, None, None, :]
            <= pos.long()[:, None, None, None])
    scores = scores.masked_fill(~live, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhql,bhld->bhqd", w, v_cache.float())
    return o.to(q.dtype)


def route(dtype) -> str:
    """The kernel route that takes q of ``dtype``."""
    if dtype not in ROUTES:
        raise ValueError(f"decode_attention takes a float32 or bfloat16 q, "
                         f"got {dtype}")
    return ROUTES[dtype]


def _check(q, k_cache, v_cache, pos) -> str:
    """Refuse what the kernel does not take, on any device; returns the
    route."""
    if q.dim() != 4 or k_cache.dim() != 4 or v_cache.dim() != 4:
        raise ValueError("decode_attention: q must be [S, H, 1, D] and the "
                         "caches [S, H, L, D]")
    S, H, one, D = q.shape
    rt = route(q.dtype)
    if one != 1:
        raise ValueError(f"decode_attention: one query row per (slot, head), "
                         f"got q {tuple(q.shape)}")
    if k_cache.shape != v_cache.shape or k_cache.shape[:2] != (S, H) or \
            k_cache.shape[3] != D:
        raise ValueError(f"decode_attention: shape mismatch: q "
                         f"{tuple(q.shape)}, k {tuple(k_cache.shape)}, v "
                         f"{tuple(v_cache.shape)}")
    if k_cache.dtype != v_cache.dtype or k_cache.dtype not in ROUTES:
        raise ValueError(f"decode_attention: the caches must be both float32 "
                         f"or both bfloat16, got {k_cache.dtype}, "
                         f"{v_cache.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {D} has no kernel "
                         f"instance (built for {HEAD_DIMS})")
    L = k_cache.shape[2]
    if not 1 <= L <= MAX_LEN:
        raise ValueError(f"decode_attention: cache length {L} outside "
                         f"1..{MAX_LEN}")
    if pos.dtype != torch.int32 or tuple(pos.shape) != (S,):
        raise ValueError(f"decode_attention: pos must be int32 [{S}], got "
                         f"{pos.dtype} {tuple(pos.shape)}")
    if not (q.device == k_cache.device == v_cache.device == pos.device):
        raise ValueError(f"decode_attention: q, the caches and pos must be "
                         f"on one device, got {q.device}, {k_cache.device}, "
                         f"{v_cache.device}, {pos.device}")
    if q.stride(3) != 1:
        raise ValueError("decode_attention: q needs a unit last stride")
    vec = 16 // k_cache.element_size()
    for name, c in (("k", k_cache), ("v", v_cache)):
        if c.stride(3) != 1 or c.stride(2) != D or \
                c.stride(0) % vec or c.stride(1) % vec or c.data_ptr() % 16:
            raise ValueError(
                f"decode_attention: the {name} cache must hold whole rows of "
                f"D in order (strides (*, *, {D}, 1)), with 16-byte aligned "
                f"base and (S, H) strides; got strides {c.stride()}")
    return rt


def _kernel():
    from ..utils import cuda_build

    fn = cuda_build.load("decode_attention").bigdl_decode_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def decode_attention(q, k_cache, v_cache, pos):
    """Attention of one query row per (slot, head) against the cache.

    q: [S, H, 1, D] float32 or bfloat16 (any (S, H) strides, unit last
    stride); k_cache, v_cache: [S, H, L, D] float32 or bfloat16, rows of D
    in order (a slot view ``cache[s:s+1]`` is fine); pos: int32 [S], slot
    s reads keys 0..pos[s].  Returns [S, H, 1, D] in q's dtype (contiguous
    on CUDA).  Positions are read on the device; one outside 0..L-1 is
    clamped into it by the kernel and is the caller's fault."""
    rt = _check(q, k_cache, v_cache, pos)
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, pos)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no route for device {q.device}")
    S, H, _, D = q.shape
    o = torch.empty((S, H, 1, D), dtype=q.dtype, device=q.device)
    if S == 0:
        return o
    pos = pos.contiguous()
    err = _kernel()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), o.data_ptr(),
        pos.data_ptr(), int(q.dtype == torch.bfloat16),
        int(k_cache.dtype == torch.bfloat16), S, H, k_cache.shape[2], D,
        q.stride(0), q.stride(1), k_cache.stride(0), k_cache.stride(1),
        v_cache.stride(0), v_cache.stride(1),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err} at q {tuple(q.shape)} {q.dtype}, "
                           f"cache {tuple(k_cache.shape)} {k_cache.dtype}")
    with _launch_lock:
        decode_attention.launches += 1
        decode_attention.route_launches[rt] += 1
    return o


decode_attention.launches = 0
decode_attention.route_launches = {"bf16": 0, "f32": 0}
