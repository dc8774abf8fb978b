"""B8's append and its cluster split, on the CPU.

The kernel (``bigdl_torch/csrc/decode_attention.cu``) runs only on the
card; what it computes is held here at small sizes:

- The append of the plain version (``decode_attention_reference``, what
  the wrapper computes for CPU tensors): row pos[s] of every (slot, head)
  becomes k_new, v_new rounded to the cache dtype, bit for bit, and every
  other row of the caches is bit-identical to what it was.
- The split-and-combine arithmetic, emulated in float32 with numpy: each
  (slot, head)'s n = pos + 1 live rows cut into C blocks of ceil(n / C)
  rows (blocks past the horizon empty), each block an online softmax over
  tiles of its rows (running max, sum and accumulator, rescaled per tile),
  the blocks combined in order with weights e^(m_c - M).  Within 1e-5 of
  the plain version in float32: both take the scores, softmax and P.V in
  float32 and differ only in summation order.
- :func:`splits`, the host's rule for C, on the shapes the decode engine
  and a prefill position give it.

Inputs come from numpy's ``default_rng``; rows past each position hold
large garbage, so an emulation or a kernel that read them would be far
off.
"""

import math

import numpy as np
import pytest
import torch

from bigdl_torch.ops import decode_attention as tops

F32_ATOL = 1e-5
GARBAGE = 1e4


def _operands(S, H, L, D, positions, seed, q_dtype=torch.float32,
              cache_dtype=torch.float32):
    rng = np.random.default_rng(seed)
    q, kn, vn = (torch.from_numpy(rng.standard_normal((S, 1, H, D))
                                  .astype(np.float32)).transpose(1, 2)
                 .to(q_dtype) for _ in range(3))
    k = rng.standard_normal((S, H, L, D)).astype(np.float32)
    v = rng.standard_normal((S, H, L, D)).astype(np.float32)
    if positions == "zero":
        pos = np.zeros(S, np.int32)
    elif positions == "last":
        pos = np.full(S, L - 1, np.int32)
    else:
        pos = rng.integers(0, L, S).astype(np.int32)
        pos[0], pos[-1] = 0, L - 1
    past = np.arange(L)[None, None, :, None] > pos[:, None, None, None]
    k = np.where(past, GARBAGE, k).astype(np.float32)
    v = np.where(past, -GARBAGE, v).astype(np.float32)
    return (q, kn, vn, torch.from_numpy(k).to(cache_dtype),
            torch.from_numpy(v).to(cache_dtype), torch.from_numpy(pos))


# ---------------------------------------------------------------------------
# the append
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q_dtype,cache_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
def test_append_writes_row_pos_only(q_dtype, cache_dtype):
    q, kn, vn, k, v, pos = _operands(5, 2, 24, 16, "mixed", seed=1,
                                     q_dtype=q_dtype,
                                     cache_dtype=cache_dtype)
    k0, v0 = k.clone(), v.clone()
    tops.decode_attention(q, kn, vn, k, v, pos)
    at = (torch.arange(24)[None, None, :, None]
          == pos.long()[:, None, None, None]).expand_as(k)
    for new, cache, before in ((kn, k, k0), (vn, v, v0)):
        assert cache.dtype == cache_dtype
        rows = cache[at].view(5, 2, 16)
        assert torch.equal(rows, new[:, :, 0].to(cache_dtype))
        assert torch.equal(cache[~at], before[~at])


def test_append_is_attended():
    """The written row takes part in the attention: at position 0 the
    output is v_new itself (one live key, weight 1)."""
    q, kn, vn, k, v, _ = _operands(3, 2, 8, 16, "zero", seed=2)
    pos = torch.zeros(3, dtype=torch.int32)
    o = tops.decode_attention(q, kn, vn, k, v, pos)
    np.testing.assert_allclose(o.numpy(), vn.numpy(), atol=F32_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the split over a cluster, emulated
# ---------------------------------------------------------------------------

def _block(qv, kr, vr, sqrt_d, tile):
    """One block's online softmax over its rows, ``tile`` rows at a time:
    (m, l, acc), or (-inf, 0, 0) with no rows."""
    m, l, acc = -np.inf, np.float32(0), np.zeros(qv.shape, np.float32)
    for t0 in range(0, len(kr), tile):
        sc = (kr[t0:t0 + tile] @ qv).astype(np.float32) / sqrt_d
        m_new = max(m, float(sc.max()))
        scale = np.float32(0 if m == -np.inf else math.exp(m - m_new))
        p = np.exp(sc - np.float32(m_new)).astype(np.float32)
        l = l * scale + p.sum(dtype=np.float32)
        acc = acc * scale + (p @ vr[t0:t0 + tile]).astype(np.float32)
        m = m_new
    return m, l, acc


def _split_emulation(q, k, v, pos, C, tile=4):
    """The kernel's arithmetic on float32 numpy arrays whose caches hold
    the appended rows already: q [S, H, 1, D] -> [S, H, 1, D]."""
    S, H, _, D = q.shape
    sqrt_d = np.float32(math.sqrt(D))
    out = np.zeros((S, H, 1, D), np.float32)
    for s in range(S):
        n = int(pos[s]) + 1
        chunk = -(-n // C)
        for h in range(H):
            parts = []
            for c in range(C):
                r0 = min(n, c * chunk)
                r1 = min(n, r0 + chunk)
                parts.append(_block(q[s, h, 0], k[s, h, r0:r1],
                                    v[s, h, r0:r1], sqrt_d, tile))
            M = max(m for m, _, _ in parts)
            assert M > -np.inf        # block 0 holds row 0
            w = [np.float32(0 if m == -np.inf else math.exp(m - M))
                 for m, _, _ in parts]
            num = sum(wc * acc for wc, (_, _, acc) in zip(w, parts))
            den = sum(wc * l for wc, (_, l, _) in zip(w, parts))
            out[s, h, 0] = num / den
    return out


@pytest.mark.parametrize("positions", ["zero", "last", "mixed"])
@pytest.mark.parametrize("C", [1, 2, 4, 8, 16])
def test_split_combine_matches_plain(C, positions):
    q, kn, vn, k, v, pos = _operands(4, 2, 40, 16, positions, seed=3 + C)
    plain = tops.decode_attention_reference(q, kn, vn, k, v, pos)
    # the caches now hold the appended rows, as the kernel's tiles do
    got = _split_emulation(q.numpy(), k.numpy(), v.numpy(), pos.numpy(), C)
    n = pos.long() + 1
    if positions != "last" and C > 1:
        assert (-(-n // C) * (C - 1) >= n).any()   # empty blocks occur
    np.testing.assert_allclose(got, plain.numpy(), atol=F32_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the host's rule for C
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,want", [
    ((8, 8, 128), 4), ((8, 8, 256), 4), ((8, 8, 512), 4),    # engine ticks
    ((8, 8, 4096), 4),
    ((1, 8, 128), 4), ((1, 8, 256), 8), ((1, 8, 512), 8),    # prefill
    ((2, 8, 512), 8), ((4, 8, 512), 8), ((16, 8, 512), 2),
    ((32, 8, 512), 1), ((1, 8, 32), 1), ((1, 8, 63), 1), ((1, 1, 4096), 8),
])
def test_splits_on_the_paths_shapes(shape, want):
    assert tops.splits(*shape) == want


@pytest.mark.parametrize("S", [1, 2, 3, 8, 17, 64])
@pytest.mark.parametrize("L", [1, 31, 64, 100, 512, 4096])
def test_splits_rule(S, L):
    H = 8
    c = tops.splits(S, H, L)
    assert c >= 1 and c & (c - 1) == 0 and c <= tops.MAX_SPLITS
    assert c == 1 or L // c >= tops.MIN_ROWS
    if S * H * c < tops.SMS:        # only the caps stop it short
        assert c == tops.MAX_SPLITS or L // (2 * c) < tops.MIN_ROWS
    if c > 1:                       # and it is the smallest that fills
        assert S * H * (c // 2) < tops.SMS
