"""Training-mode BatchNorm: four hand-written CUDA kernels for Hopper,
their plain PyTorch versions, and ``bn_train`` and ``bn_train_sync`` as
autograd Functions.

Counterpart of ``bigdl_tpu/ops/batchnorm.py``.  Every function works on x
viewed as [R, C] (rows = all leading axes, channels last):

- :func:`bn_forward` (B1, ``_bn_fwd_pallas``): (y, mean, var) with float32
  one-pass statistics (biased var = Σx²/R − mean²) and y computed in
  float32, cast to x's dtype.
- :func:`bn_backward` (B2, ``_bn_bwd_pallas``): (dx, Σdy, Σdy·x̂).
- :func:`bn_stats` (B3, ``_bn_stats_pallas``): the float32 (Σx, Σx²) of
  this rank's rows, for sync-BN's forward.
- :func:`bn_grad_stats` (B4, ``_bn_grad_stats_pallas``): (Σdy, Σdy·x̂)
  alone, for the fused conv-BN backward (``ops/convbn.py``) and sync-BN's
  backward.

Each wrapper computes its plain version (``*_reference``) for tensors on
the CPU, and on a CUDA tensor launches ``bigdl_torch/csrc/batchnorm.cu``
(built with ``nvcc`` for ``sm_90a`` at first use, bound with ``ctypes``) or
raises: there is no fallback and no switch.  ``fn.launches`` counts calls
that launched the kernel.

Each kernel has two routes, picked by :func:`route` from dtype, C and the
bases' alignment before the launch: ``"vec"`` where every row is whole
16-byte pieces and the bases are 16-byte aligned, ``"scalar"`` (one
element a thread, a separate finish launch) for the rest.  On ``"vec"`` a
thread owns a 16-byte piece of a row, and one launch takes the sums and
their finish: B3's and B4's sums, B1's mean, var and coefficients, B2's
sums and coefficients; B1's normalize and B2's dx are a second launch that
walks the rows back through L2.  B1 and B3 pick their route from x alone,
so for the same x they take the same route and chunking, and B3's sums
give B1's mean and var bit for bit.  ``fn.route_launches`` counts each
route's launches.

The plain forward follows the TPU *kernel*, which computes y in float32 and
casts (``ops/batchnorm.py:113``), not the reference's jnp oracle, which
computes y in x's dtype (``:67``); the two agree in bf16 to rounding.

:func:`bn_train` (B1 forward, B2 backward) is the single-device route;
:func:`bn_train_sync` (B3 and B4, with the per-channel sums all-reduced
over the Engine's data group) is the data-parallel one.
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.distributed as dist

from ..utils.engine import Engine

__all__ = ["bn_train", "bn_train_sync", "bn_forward", "bn_backward",
           "bn_stats", "bn_grad_stats", "route", "bn_forward_reference",
           "bn_backward_reference", "bn_stats_reference",
           "bn_grad_stats_reference"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: channels per block of the stat passes (``TX`` in batchnorm.cu)
_TILE_C = 32
#: stat-pass blocks to aim for: about 8 resident on each of 132 SMs
_TARGET_BLOCKS = 1056
_MIN_CHUNK_ROWS = 64
# route "vec" (``VT``, ``VEC_PIECES``, ``VEC_X_PIECES``, ``VEC_MAX_TILES``
# in batchnorm.cu): threads a block, 16-byte pieces in a column tile of
# (x, dy) (B4, B2) and of x alone (B1, B3), ticket counters
_VEC_THREADS = 256
_VEC_PIECES = 32
_VEC_X_PIECES = 16
_VEC_MAX_TILES = 4096
#: "vec" blocks to aim for on each SM, and the fewest rows a row lane takes
_VEC_BLOCKS_PER_SM = 2
_VEC_MIN_LANE_ROWS = 8


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


def bn_stats_reference(x2):
    """(Σx, Σx²) in float32 over the rows of x2 [R, C]."""
    xf = x2.float()
    return xf.sum(0), (xf * xf).sum(0)


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
    # x, sum, sumsq, part, dtype, R, C, n_chunks, rows
    "bigdl_bn_stats": [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p],
    # x, dy, mean, inv, sdy, sdyx, part, dtype, R, C, n_chunks, rows
    "bigdl_bn_grad_stats": [ctypes.c_void_p] * 7 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p],
    # x, dy, mean, inv, sdy, sdyx, part, tickets, dtype, R, C, n_chunks, rows
    "bigdl_bn_grad_stats_vec": [ctypes.c_void_p] * 8 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p],
    # x, dy, mean, inv, w, dx, sdy, sdyx, part, coef, tickets, dtype, R, C,
    # n_chunks, rows
    "bigdl_bn_backward_vec": [ctypes.c_void_p] * 11 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p],
    # x, w, b, y, mean, var, part, coef, tickets, dtype, R, C, eps,
    # n_chunks, rows
    "bigdl_bn_forward_vec": [ctypes.c_void_p] * 9 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p],
    # x, sum, sumsq, part, tickets, dtype, R, C, n_chunks, rows
    "bigdl_bn_stats_vec": [ctypes.c_void_p] * 5 + [
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
    """(n_chunks, rows_per_chunk) of route "scalar"'s stat passes: enough
    (row chunk x 32-channel tile) blocks to fill the card, each chunk at
    least 64 rows.  Depends on the shape only, so the summation order is
    fixed."""
    tiles = -(-C // _TILE_C)
    n = max(1, min(-(-R // _MIN_CHUNK_ROWS), -(-_TARGET_BLOCKS // tiles)))
    rows = -(-R // n)
    return -(-R // rows), rows


def _vec_layout(C: int, itemsize: int, max_pieces: int):
    """(pieces, row lanes, column tiles, tile width) of a route-"vec" block
    over rows of C channels of ``itemsize`` bytes: a thread owns one
    16-byte piece, a block covers a tile of at most ``max_pieces`` pieces
    (tile width channels) and 256 // pieces rows a step."""
    per = 16 // itemsize
    pieces = C // per
    pt = min(pieces, max_pieces)
    return pt, _VEC_THREADS // pt, -(-pieces // pt), pt * per


def _max_pieces(dy2) -> int:
    """The widest "vec" column tile, in 16-byte pieces: 32 for B4 and B2
    (x and dy), 16 for B1 and B3 (x alone).  The tile sets the partials
    that the finishing block of a tile reads, n_chunks x 2 x tile floats;
    a narrower tile spreads the finish over more blocks.  For B1 and B3 a
    16-piece tile beat 8 and 32 pieces over the ResNet-50 step's shapes on
    an H100 (the 32-piece finish read 0.5 MB alone at [50176, 256])."""
    return _VEC_X_PIECES if dy2 is None else _VEC_PIECES


def route(x2, dy2=None) -> str:
    """The kernel that takes x2 [R, C] on the card (B1, B3), or x2 and dy2
    (B4, B2): ``"vec"`` where each row is whole 16-byte pieces (C a
    multiple of 8 in bf16, of 4 in float32) and every base is 16-byte
    aligned, ``"scalar"`` otherwise.  Reads dtype, C and the bases'
    alignment only; B1's y and B2's dx, which the wrappers allocate, are
    always aligned."""
    item = x2.element_size()
    C = x2.shape[-1]
    if (x2.dtype not in _DTYPE_CODE or C == 0 or C * item % 16
            or x2.data_ptr() % 16
            or (dy2 is not None and dy2.data_ptr() % 16)):
        return "scalar"
    tiles = _vec_layout(C, item, _max_pieces(dy2))[2]
    return "vec" if tiles <= _VEC_MAX_TILES else "scalar"


def _vec_chunks(R: int, C: int, itemsize: int, sm_count: int,
                max_pieces: int):
    """(n_chunks, rows_per_chunk) of route "vec": about two blocks per SM
    over (row chunk x column tile), each row lane at least 8 rows, chunks a
    whole number of row steps.  A function of (R, C, itemsize, sm_count)
    and the kernel's tile (``max_pieces``) only, so the summation order is
    fixed."""
    _, rl, tiles, _ = _vec_layout(C, itemsize, max_pieces)
    n = max(1, min(-(-R // (rl * _VEC_MIN_LANE_ROWS)),
                   -(-_VEC_BLOCKS_PER_SM * sm_count // tiles)))
    rows = -(-R // n)
    rows = -(-rows // rl) * rl
    return -(-R // rows), rows


_per_device = {}


def _device_state(device):
    """(SM count, route-"vec" ticket counters) of a CUDA device, made once:
    the counters are zeroed here and every launch leaves them zero, so a
    CUDA graph's replay starts from zero too."""
    with _launch_lock:
        st = _per_device.get(device)
        if st is None:
            st = _per_device[device] = (
                torch.cuda.get_device_properties(device).multi_processor_count,
                torch.zeros(_VEC_MAX_TILES, dtype=torch.int32, device=device))
        return st


def _plan(x2, dy2=None):
    """(route, n_chunks, rows_per_chunk, tickets) of a launch over x2
    [R, C] (and dy2) on the card: :func:`route`'s choice with its chunking
    (``_vec_chunks`` or ``_chunks``), and on ``"vec"`` the device's ticket
    counters (else None).

    Every ``"vec"`` launch finishes through these counters: the last block
    of a column tile to take its ticket sums the tile, and resets it.  Two
    launches that finish by ticket must never run at once on one counter
    array; they do not, because every wrapper launches on the current
    stream and the port runs each device on one stream."""
    R, C = x2.shape
    rt = route(x2, dy2)
    if rt == "vec":
        sms, tickets = _device_state(x2.device)
        return (rt, *_vec_chunks(R, C, x2.element_size(), sms,
                                 _max_pieces(dy2)), tickets)
    return (rt, *_chunks(R, C), None)


def _count(fn, rt):
    with _launch_lock:
        fn.launches += 1
        fn.route_launches[rt] += 1


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
    float32, on the kernel :func:`route` picks from x2.  CPU tensors take
    :func:`bn_forward_reference`."""
    if x2.device.type == "cpu":
        return bn_forward_reference(x2, weight, bias, eps)
    _cuda("bn_forward", x2)
    w, b = weight.float().contiguous(), bias.float().contiguous()
    _check("bn_forward", x2, w, b)
    R, C = x2.shape
    _check_vec("bn_forward", C, w, b)
    rt, n_chunks, rows, tickets = _plan(x2)
    f32 = dict(dtype=torch.float32, device=x2.device)
    y = torch.empty_like(x2)
    mean, var = torch.empty(C, **f32), torch.empty(C, **f32)
    part = torch.empty(2 * n_chunks * C, **f32)
    coef = torch.empty(2 * C, **f32)
    ptrs = (x2.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
            mean.data_ptr(), var.data_ptr(), part.data_ptr(),
            coef.data_ptr())
    if rt == "vec":
        err = _kernel("bigdl_bn_forward_vec")(
            *ptrs, tickets.data_ptr(), _DTYPE_CODE[x2.dtype], R, C,
            float(eps), n_chunks, rows, _stream(x2))
    else:
        err = _kernel("bigdl_bn_forward")(
            *ptrs, _DTYPE_CODE[x2.dtype], R, C, float(eps), n_chunks, rows,
            _stream(x2))
    _raise_on(err, f"bn_forward ({rt})", x2)
    _count(bn_forward, rt)
    return y, mean, var


def bn_backward(x2, dy2, mean, inv, weight):
    """Training BN backward over [R, C] (B2): (dx, Σdy, Σdy·x̂), on the
    kernel :func:`route` picks; its sums are B4's bit for bit.  CPU tensors
    take :func:`bn_backward_reference`."""
    if x2.device.type == "cpu":
        return bn_backward_reference(x2, dy2, mean, inv, weight)
    _cuda("bn_backward", x2)
    w = weight.float().contiguous()
    _check("bn_backward", x2, dy2, mean, inv, w)
    _check_dy("bn_backward", x2, dy2)
    R, C = x2.shape
    _check_vec("bn_backward", C, mean, inv, w)
    rt, n_chunks, rows, tickets = _plan(x2, dy2)
    f32 = dict(dtype=torch.float32, device=x2.device)
    dx = torch.empty_like(x2)
    sdy, sdyx = torch.empty(C, **f32), torch.empty(C, **f32)
    coef = torch.empty(3 * C, **f32)
    part = torch.empty(2 * n_chunks * C, **f32)
    ptrs = (x2.data_ptr(), dy2.data_ptr(), mean.data_ptr(), inv.data_ptr(),
            w.data_ptr(), dx.data_ptr(), sdy.data_ptr(), sdyx.data_ptr())
    if rt == "vec":
        err = _kernel("bigdl_bn_backward_vec")(
            *ptrs, part.data_ptr(), coef.data_ptr(), tickets.data_ptr(),
            _DTYPE_CODE[x2.dtype], R, C, n_chunks, rows, _stream(x2))
    else:
        err = _kernel("bigdl_bn_backward")(
            *ptrs, part.data_ptr(), coef.data_ptr(), _DTYPE_CODE[x2.dtype],
            R, C, n_chunks, rows, _stream(x2))
    _raise_on(err, f"bn_backward ({rt})", x2)
    _count(bn_backward, rt)
    return dx, sdy, sdyx


def bn_stats(x2):
    """(Σx, Σx²) over the rows of x2 [R, C] (B3), float32: B1's
    statistics phase alone, on the route B1 takes for the same x2, so its
    sums give B1's mean and var bit for bit.  CPU tensors take
    :func:`bn_stats_reference`."""
    if x2.device.type == "cpu":
        return bn_stats_reference(x2)
    _cuda("bn_stats", x2)
    _check("bn_stats", x2)
    R, C = x2.shape
    rt, n_chunks, rows, tickets = _plan(x2)
    f32 = dict(dtype=torch.float32, device=x2.device)
    s, ss = torch.empty(C, **f32), torch.empty(C, **f32)
    part = torch.empty(2 * n_chunks * C, **f32)
    ptrs = (x2.data_ptr(), s.data_ptr(), ss.data_ptr(), part.data_ptr())
    if rt == "vec":
        err = _kernel("bigdl_bn_stats_vec")(
            *ptrs, tickets.data_ptr(), _DTYPE_CODE[x2.dtype], R, C,
            n_chunks, rows, _stream(x2))
    else:
        err = _kernel("bigdl_bn_stats")(
            *ptrs, _DTYPE_CODE[x2.dtype], R, C, n_chunks, rows, _stream(x2))
    _raise_on(err, f"bn_stats ({rt})", x2)
    _count(bn_stats, rt)
    return s, ss


def bn_grad_stats(x2, dy2, mean, inv):
    """(Σdy, Σdy·x̂) over the rows of [R, C] (B4), float32, on the kernel
    :func:`route` picks.  CPU tensors take
    :func:`bn_grad_stats_reference`."""
    if x2.device.type == "cpu":
        return bn_grad_stats_reference(x2, dy2, mean, inv)
    _cuda("bn_grad_stats", x2)
    _check("bn_grad_stats", x2, dy2, mean, inv)
    _check_dy("bn_grad_stats", x2, dy2)
    R, C = x2.shape
    _check_vec("bn_grad_stats", C, mean, inv)
    rt, n_chunks, rows, tickets = _plan(x2, dy2)
    f32 = dict(dtype=torch.float32, device=x2.device)
    sdy, sdyx = torch.empty(C, **f32), torch.empty(C, **f32)
    part = torch.empty(2 * n_chunks * C, **f32)
    ptrs = (x2.data_ptr(), dy2.data_ptr(), mean.data_ptr(), inv.data_ptr(),
            sdy.data_ptr(), sdyx.data_ptr())
    if rt == "vec":
        err = _kernel("bigdl_bn_grad_stats_vec")(
            *ptrs, part.data_ptr(), tickets.data_ptr(),
            _DTYPE_CODE[x2.dtype], R, C, n_chunks, rows, _stream(x2))
    else:
        err = _kernel("bigdl_bn_grad_stats")(
            *ptrs, part.data_ptr(), _DTYPE_CODE[x2.dtype], R, C, n_chunks,
            rows, _stream(x2))
    _raise_on(err, f"bn_grad_stats ({rt})", x2)
    _count(bn_grad_stats, rt)
    return sdy, sdyx


bn_forward.launches = 0
bn_backward.launches = 0
bn_stats.launches = 0
bn_grad_stats.launches = 0
bn_forward.route_launches = {"vec": 0, "scalar": 0}
bn_backward.route_launches = {"vec": 0, "scalar": 0}
bn_stats.route_launches = {"vec": 0, "scalar": 0}
bn_grad_stats.route_launches = {"vec": 0, "scalar": 0}


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


def all_reduce_pair(a, b, kind: str, group):
    """(a, b) summed over ``group`` as one packed float32 buffer."""
    buf = Engine.all_reduce(torch.cat([a, b]), kind, group)
    return buf[:a.numel()], buf[a.numel():]


def global_rows(rows: int, group) -> int:
    """The row count statistics are taken over: this rank's ``rows``, times
    the world size under a group (reference ``_global_n``).  The ops use it
    for the statistics and dx, the modules for the running EMA."""
    return rows if group is None else rows * dist.get_world_size(group)


class _BNTrainSync(torch.autograd.Function):
    """Sync-BN over a process group (reference ``bn_train_sync``,
    ``:417-482``): statistics of the global batch, this rank's rows in and
    out."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        C = x.shape[-1]
        x2 = x.reshape(-1, C)
        s, ss = all_reduce_pair(*bn_stats(x2), "bn_stats", group)
        n = global_rows(x2.shape[0], group)
        mean = s / n
        var = ss / n - mean * mean
        inv = torch.rsqrt(var + eps)
        scale = weight.float() * inv
        shift = bias.float() - mean * scale
        y = x * scale.to(x.dtype) + shift.to(x.dtype)
        ctx.save_for_backward(x, mean, inv, weight)
        ctx.mark_non_differentiable(mean, var)
        ctx.group = group
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, inv, weight = ctx.saved_tensors
        C = x.shape[-1]
        x2 = x.reshape(-1, C)
        sdy_local, sdyx_local = bn_grad_stats(
            x2, dy.contiguous().reshape(-1, C), mean, inv)
        sdy, sdyx = all_reduce_pair(sdy_local, sdyx_local, "bn_grad_stats",
                                    ctx.group)
        n = global_rows(x2.shape[0], ctx.group)
        xhat = (x.float() - mean) * inv
        scale = (weight.float() * inv).to(x.dtype)
        dx = scale * (dy - (sdy / n).to(x.dtype)
                      - xhat.to(x.dtype) * (sdyx / n).to(x.dtype))
        # dγ, dβ are this rank's sums: the Optimizer averages gradients
        # over the group, which makes them the global-batch gradient;
        # returning the global sums would count them world-size times
        return (dx, sdyx_local.to(weight.dtype), sdy_local.to(weight.dtype),
                None, None)


def bn_train_sync(x, weight, bias, eps: float, group):
    """Training-mode sync-BN over ``group`` (the Engine's data group on the
    training path): (x[..., C], weight[C], bias[C]) -> (y, mean, var),
    mean and var the biased float32 statistics of the global batch (not
    differentiable).

    The forward is B3 on this rank's rows, one all-reduce of the packed
    [2C] (Σx, Σx²), and the normalize as PyTorch elementwise ops in x's
    dtype (XLA fuses it in the reference); the backward is B4, one
    all-reduce of (Σdy, Σdy·x̂), and dx with the global row count.  x must
    be contiguous."""
    return _BNTrainSync.apply(x, weight, bias, eps, group)
