"""Cached decode attention with the cache append (B8): a hand-written CUDA
kernel for Hopper, and its plain PyTorch version.

One query row per (slot, head) against a KV cache, each slot at its own
position: the attention of every decode tick and every prefill position,
with the new key and value written into the cache at that position first.
It is the counterpart of ``bigdl_tpu/serve/decode.py`` ``_slot_attention``
(``:129-155``) and ``bigdl_tpu/models/decode.py`` ``_cached_attention``
(``:94-118``): k and v rounded to the cache dtype and written at each
slot's position, then scores in float32 divided by sqrt(D), keys past the
position at exactly zero weight, a float32 softmax and P.V, cast to q's
dtype.

:func:`decode_attention` launches ``bigdl_torch/csrc/decode_attention.cu``
(built with ``nvcc`` for ``sm_90a`` at first use, bound with ``ctypes``)
for tensors on a CUDA device, and computes
:func:`decode_attention_reference` for tensors on the CPU.  On a CUDA tensor
it launches the kernel or raises: there is no fallback and no switch.  The
route is q's dtype: ``"bf16"`` or ``"f32"`` (the cache may be either).
``decode_attention.launches`` counts every launch and
``decode_attention.route_launches`` each route's.  A call made while the
current stream captures a CUDA graph launches nothing, and counts nothing:
inside :func:`counting_captures` it is tallied by route instead, and each
replay of the graph counts that tally (:func:`count_replay`).  The kernel
splits each (slot, head)'s live keys over a thread-block cluster of
:func:`splits` blocks.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

__all__ = ["decode_attention", "decode_attention_reference", "route",
           "splits", "counting_captures", "count_replay", "HEAD_DIMS",
           "MAX_LEN"]

#: the route by q's dtype
ROUTES = {torch.bfloat16: "bf16", torch.float32: "f32"}
#: head dimensions the kernel is compiled for
HEAD_DIMS = (16, 32, 64, 128)
#: the longest cache the kernel takes: positions, row counts and the
#: bounds of a block's rows are int32 in the kernel, and 2^30 keeps every
#: one of them (n + C - 1 at most) inside it
MAX_LEN = 2 ** 30
#: streaming multiprocessors of an H100 SXM, the card the splits are for
SMS = 132
#: the most blocks of a cluster (8 is the portable cluster size)
MAX_SPLITS = 8
#: the fewest cache rows a block of the cluster is given
MIN_ROWS = 32

_launch_lock = threading.Lock()
# per thread: the tally of launches recorded into the graph this thread is
# capturing (counting_captures)
_capture = threading.local()


def decode_attention_reference(q, k_new, v_new, k_cache, v_cache, pos):
    """The plain version, line for line the reference's
    (``bigdl_tpu/serve/decode.py:129-155``): q, k_new, v_new [S, H, 1, D],
    caches [S, H, L, D], pos int [S] -> [S, H, 1, D] in q's dtype.  k_new
    and v_new are rounded to the cache dtype and written at row pos[s] of
    each (slot, head), in place (an indexed ``scatter_``); then a float32
    einsum over the whole cache length, -inf past each slot's position,
    softmax, einsum with V, cast."""
    S, H, _, D = q.shape
    idx = pos.long().view(S, 1, 1, 1).expand(S, H, 1, D)
    k_cache.scatter_(2, idx, k_new.to(k_cache.dtype))
    v_cache.scatter_(2, idx, v_new.to(v_cache.dtype))
    L = k_cache.shape[2]
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


def splits(S: int, H: int, L: int) -> int:
    """Blocks per (slot, head) in the kernel's cluster, from the shapes
    alone (never the positions, which stay on the device): the smallest
    power of two with S * H * C >= SMS, at most MAX_SPLITS, and no more
    than leaves every block MIN_ROWS rows of the cache length."""
    c = 1
    while S * H * c < SMS and c < MAX_SPLITS:
        c *= 2
    while c > 1 and L // c < MIN_ROWS:
        c //= 2
    return c


def _check(q, k_new, v_new, k_cache, v_cache, pos) -> str:
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
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if tuple(t.shape) != (S, H, 1, D) or t.dtype != q.dtype or \
                t.stride(3) != 1:
            raise ValueError(
                f"decode_attention: {name} must be [{S}, {H}, 1, {D}] of q's "
                f"dtype {q.dtype} with a unit last stride, got "
                f"{tuple(t.shape)} {t.dtype} strides {t.stride()}")
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
    devices = {t.device for t in (q, k_new, v_new, k_cache, v_cache, pos)}
    if len(devices) != 1:
        raise ValueError(f"decode_attention: q, k_new, v_new, the caches and "
                         f"pos must be on one device, got {q.device}, "
                         f"{k_new.device}, {v_new.device}, {k_cache.device}, "
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


def _library():
    from ..utils import cuda_build

    return cuda_build.load("decode_attention")


def _kernel():
    fn = _library().bigdl_decode_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 10 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k_new, v_new, k_cache, v_cache, pos, C):
    """One launch of the kernel with clusters of ``C`` blocks on checked
    CUDA operands; returns o.  Counts nothing."""
    S, H, _, D = q.shape
    o = torch.empty((S, H, 1, D), dtype=q.dtype, device=q.device)
    if S == 0:
        return o
    pos = pos.contiguous()
    err = _kernel()(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), o.data_ptr(), pos.data_ptr(),
        int(q.dtype == torch.bfloat16), int(k_cache.dtype == torch.bfloat16),
        S, H, k_cache.shape[2], D, C, q.stride(0), q.stride(1),
        k_new.stride(0), k_new.stride(1), v_new.stride(0), v_new.stride(1),
        k_cache.stride(0), k_cache.stride(1), v_cache.stride(0),
        v_cache.stride(1), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err} at q {tuple(q.shape)} {q.dtype}, "
                           f"cache {tuple(k_cache.shape)} {k_cache.dtype}, "
                           f"{C} blocks a cluster")
    return o


def decode_attention(q, k_new, v_new, k_cache, v_cache, pos):
    """Append k_new and v_new to the cache, then attend one query row per
    (slot, head) to it.

    q, k_new, v_new: [S, H, 1, D] float32 or bfloat16, one dtype (any
    (S, H) strides, unit last stride); k_cache, v_cache: [S, H, L, D]
    float32 or bfloat16, rows of D in order (a slot view ``cache[s:s+1]``
    is fine); pos: int32 [S].  Row pos[s] of each (s, h) of the caches
    becomes k_new, v_new rounded to the cache dtype, in place; no other
    row is written.  Returns the attention over rows 0..pos[s], that row
    included: [S, H, 1, D] in q's dtype (contiguous on CUDA).  Positions
    are read on the device; one outside 0..L-1 is clamped into it by the
    kernel and is the caller's fault."""
    rt = _check(q, k_new, v_new, k_cache, v_cache, pos)
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_new, v_new, k_cache, v_cache,
                                          pos)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no route for device {q.device}")
    S, H, _, _ = q.shape
    o = _launch(q, k_new, v_new, k_cache, v_cache, pos,
                splits(S, H, k_cache.shape[2]))
    if torch.cuda.is_current_stream_capturing():
        tally = getattr(_capture, "tally", None)
        if tally is not None:
            tally[rt] += 1
    else:
        count_replay({rt: 1})
    return o


decode_attention.launches = 0
decode_attention.route_launches = {"bf16": 0, "f32": 0}


@contextlib.contextmanager
def counting_captures():
    """Tally, by route, the launches this thread records into the CUDA
    graph it captures inside the block; yields the tally (route ->
    launches), which a replay of that graph hands to :func:`count_replay`."""
    tally = {rt: 0 for rt in decode_attention.route_launches}
    outer = getattr(_capture, "tally", None)
    _capture.tally = tally
    try:
        yield tally
    finally:
        _capture.tally = outer


def count_replay(tally):
    """Count the launches of one replay of a graph that captured ``tally``
    (route -> launches), as the wrapper counts a launch of its own."""
    with _launch_lock:
        for rt, n in tally.items():
            decode_attention.launches += n
            decode_attention.route_launches[rt] += n


def _floor(S, H, D, C, cache_dtype, device):
    """Launch the empty kernel with the grid, cluster, block and shared
    memory the kernel takes at (S, H, D, C, cache dtype): the launch floor
    its times are read against.  Counts nothing."""
    fn = _library().bigdl_decode_attention_floor
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(int(cache_dtype == torch.bfloat16), D, S, H, C,
             torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention floor launch failed: CUDA "
                           f"error {err}")

