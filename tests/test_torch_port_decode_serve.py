"""Continuous-batching decode serving in the port against the JAX package.

``DecodeEngine(device="cpu")`` (``serve/decode.py``) serves
TransformerLM(vocab 64, max_len 64, E 32, H 2, L 2), built by the JAX
package and carried over with ``load_reference_tree``; every sequence it
returns must equal both oracles, the JAX package's ``cached_generate`` and
the port's, token for token (greedy argmax over float32 log-probs that
agree to about 1e-6; the slot a sequence decodes in and its batch-mates
change nothing, because keys past each slot's position get exactly zero
weight).  Prompts come from numpy's ``default_rng``.  Also the admission
pieces ported beside it: ``DecodeQueue`` and ``pad_rows(length=)``
(``serve/batcher.py``), ``TenantQuotas`` (``serve/control.py``) and
``page_ladder``.  No tolerance is used: every comparison is exact.
"""

import time

import numpy as np
import pytest
import torch

import jax
from bigdl_tpu.models import decode as jdec
from bigdl_tpu.models import transformer_lm as jlm

from bigdl_torch.models import decode as tdec
from bigdl_torch.models import transformer_lm as tlm
from bigdl_torch.serve import (DecodeEngine, DecodeQueue, QuotaExceeded,
                               RequestTimeout, ServeError, ServerOverloaded,
                               SlotFault, TenantQuotas, page_ladder,
                               pad_rows)
from bigdl_torch.utils.convert import load_reference_tree

CFG = dict(vocab_size=64, max_len=64, d_model=32, num_heads=2,
           num_layers=2)


@pytest.fixture(scope="module")
def pair():
    jm = jlm.TransformerLM(**CFG).build(jax.random.key(0))
    tm = tlm.TransformerLM(**CFG).build("cpu")
    load_reference_tree(tm, jax.tree.map(np.asarray, jm.params),
                        jax.tree.map(np.asarray, jm.state))
    return jm, tm


def _prompts(n, lo=3, hi=10, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 64, size=int(rng.integers(lo, hi)))
            .astype(np.int32) for _ in range(n)]


def _oracles(pair, prompt, max_tokens):
    """The port's cached_generate (cache of exactly the row's length, as
    the reference's tests take it) and the JAX package's (at the model's
    cap: one compile serves every row); they must agree."""
    jm, tm = pair
    port = tdec.cached_generate(tm, prompt, max_tokens,
                                max_len=len(prompt) + max_tokens)
    ref = jdec.cached_generate(jm, prompt, max_tokens, max_len=CFG["max_len"])
    np.testing.assert_array_equal(port, np.asarray(ref))
    return port


def _engine(pair, **kw):
    return DecodeEngine(pair[1], device="cpu", **kw)


# ---------------------------------------------------------------------------
# pad_rows(length=), DecodeQueue, TenantQuotas, page_ladder
# ---------------------------------------------------------------------------

def test_pad_rows_trailing_axis_pads_with_zeros():
    arr = np.arange(6, dtype=np.int32).reshape(2, 3)
    out = pad_rows(arr, 4, length=8)
    assert out.shape == (4, 8) and out.dtype == np.int32
    np.testing.assert_array_equal(out[:2, :3], arr)
    # rows repeat the last row; the trailing axis pads with zeros
    np.testing.assert_array_equal(out[2:, :3], np.tile(arr[-1], (2, 1)))
    assert not out[:, 3:].any()


def test_pad_rows_length_zero_rows_and_dtype():
    out = pad_rows(np.zeros((0, 3), np.float16), 2, length=5)
    assert out.shape == (2, 5) and out.dtype == np.float16
    assert not out.any()


def test_pad_rows_refuses_to_truncate():
    with pytest.raises(ValueError, match="refusing to truncate"):
        pad_rows(np.ones((2, 9), np.float32), 2, length=4)


def test_decode_queue_take_is_nonblocking_and_bounded():
    q = DecodeQueue(queue_limit=8)
    reqs = [q.submit({"max_tokens": 4, "i": i}) for i in range(3)]
    assert q.depth() == 3
    assert q.take(0) == []
    got = q.take(2)
    assert [r.payload["i"] for r in got] == [0, 1]
    assert q.take(5) == [reqs[2]]
    t0 = time.monotonic()
    assert q.take(1) == []           # empty: returns, never parks
    assert time.monotonic() - t0 < 0.5
    assert q.depth() == 0


def test_decode_queue_sheds_expired_deadline_at_dequeue():
    t = [0.0]
    q = DecodeQueue(queue_limit=8, clock=lambda: t[0])
    late = q.submit({"max_tokens": 4}, deadline=1.0)
    live = q.submit({"max_tokens": 4}, deadline=50.0, tenant="team-a")
    t[0] = 2.0
    assert q.take(2) == [live]
    assert live.tenant == "team-a"
    with pytest.raises(RequestTimeout):
        late.result(0.1)
    assert q.shed_timeout == 1


def test_decode_queue_retry_after_scales_with_token_budget():
    q = DecodeQueue(queue_limit=64)
    q.note_service(100, 1.0)         # the EMA learns 10 ms a token
    q.submit({"max_tokens": 200})
    q.submit({"max_tokens": 200})
    # 400 queued tokens at ~10 ms a token, far above the 0.05 s floor
    assert q.retry_after_s() >= 1.0
    q.take(2)
    assert q.retry_after_s() < 0.1


def test_decode_queue_wait_for_work():
    q = DecodeQueue(queue_limit=4)
    t0 = time.monotonic()
    assert q.wait_for_work(0.05) is False
    assert time.monotonic() - t0 >= 0.04
    q.submit({"max_tokens": 1})
    assert q.wait_for_work(10.0) is True
    q.take(1)
    q.close()
    assert q.wait_for_work(10.0) is True


def test_tenant_quotas_token_bucket():
    t = [0.0]
    quotas = TenantQuotas(2.0, burst=2, clock=lambda: t[0])
    quotas.admit("a")
    quotas.admit("a")
    with pytest.raises(QuotaExceeded) as exc:
        quotas.admit("a")
    assert isinstance(exc.value, ServerOverloaded)
    assert exc.value.retry_after_s == pytest.approx(0.5)
    quotas.admit("b")                # another tenant's own bucket
    t[0] = 0.5                       # one token refilled at 2 a second
    quotas.admit("a")
    st = quotas.stats()
    assert st["denied"] == 1 and st["denied_by_tenant"] == {"a": 1}
    TenantQuotas(0.0).admit("a")     # qps <= 0 admits everything


def test_page_ladder_pow2_pages_capped_at_max_len():
    assert page_ladder(16, 128) == (16, 32, 64, 128)
    assert page_ladder(16, 100) == (16, 32, 64, 100)
    assert page_ladder(8, 8) == (8,)
    with pytest.raises(ValueError):
        page_ladder(0, 64)


# ---------------------------------------------------------------------------
# the engine on the CPU
# ---------------------------------------------------------------------------

def test_continuous_batching_matches_oracles(pair):
    # 5 mixed-length sequences through 2 slots: slots are reused the tick
    # they free and in-flight positions differ
    prompts = _prompts(5, seed=1)
    budgets = [4, 7, 3, 6, 5]
    with _engine(pair, slots=2, page=8) as eng:
        handles = [eng.submit(p, mt) for p, mt in zip(prompts, budgets)]
        outs = [h.result(120.0) for h in handles]
        st = eng.stats()
    for p, mt, out in zip(prompts, budgets, outs):
        np.testing.assert_array_equal(out, _oracles(pair, p, mt))
    assert st["seqs_done"] == 5 and st["seqs_failed"] == 0
    assert st["prefill_steps"] == 5      # one prefill per admitted sequence
    assert st["tokens_out"] == sum(budgets)
    assert "aot" not in st and "compile_cards" not in st


def test_batch_admission_gives_the_same_tokens(pair):
    prompts = _prompts(4, seed=4)
    with _engine(pair, slots=2, page=8, admission="batch") as eng:
        outs = [h.result(120.0) for h in [eng.submit(p, 4) for p in prompts]]
    for p, out in zip(prompts, outs):
        np.testing.assert_array_equal(out, _oracles(pair, p, 4))
    with pytest.raises(ValueError, match="admission"):
        _engine(pair, admission="sometimes")


def test_cache_grows_through_the_page_ladder(pair):
    short, long = _prompts(2, lo=4, hi=6, seed=3)
    with _engine(pair, slots=2, page=8, min_step_s=0.01) as eng:
        # A takes a slot at the 32 page; once it is in flight, B needs the
        # 64 page: a mid-flight grow (an idle engine would re-page)
        ha = eng.submit(short, 25)
        deadline = time.monotonic() + 60.0
        while eng.stats()["active"] == 0:
            assert time.monotonic() < deadline, "A never admitted"
            time.sleep(0.002)
        assert eng.stats()["cache_len"] == 32
        hb = eng.submit(long, 50)
        first, out = ha.result(120.0), hb.result(120.0)
        st = eng.stats()
    np.testing.assert_array_equal(first, _oracles(pair, short, 25))
    np.testing.assert_array_equal(out, _oracles(pair, long, 50))
    assert st["cache_len"] == 64 and st["cache_grows"] >= 1
    # layers x {k, v} x heads x cache_len x head_dim x 4 bytes
    assert st["cache_bytes_per_slot"] == 2 * 2 * 2 * 64 * 16 * 4


@pytest.mark.parametrize("seed,k", [(0, 2), (2, 0)])
def test_eos_frees_slot_same_step(pair, seed, k):
    # EOS is the oracle's third generated token; the engine stops at its
    # FIRST occurrence, the k-th generated token.  Seed 0: the third is
    # new (k = 2).  Seed 2 is the reference test's data: the oracle
    # alternates 41 44 41 ..., so its third token is also its first
    # (k = 0), the data fault behind the reference's failing
    # test_eos_frees_slot_same_step.
    prompt = _prompts(1, seed=seed)[0]
    full = _oracles(pair, prompt, 8)
    gen = full[len(prompt):]
    eos = int(gen[2])
    assert int(np.flatnonzero(gen == eos)[0]) == k
    with _engine(pair, slots=1, page=8) as eng:
        out = eng.generate(prompt, 8, eos_token=eos)
        after = eng.generate(prompt, 2)  # the freed slot serves again
        st = eng.stats()
    np.testing.assert_array_equal(out, full[: len(prompt) + k + 1])
    np.testing.assert_array_equal(after, full[: len(prompt) + 2])
    assert st["tokens_out"] == k + 1 + 2 and st["seqs_done"] == 2


def test_submit_rejects_bad_requests_typed(pair):
    eng = _engine(pair, slots=1, page=8)   # never started: pure checks
    with pytest.raises(ServeError, match="non-empty"):
        eng.submit(np.zeros((0,), np.int32), 4)
    with pytest.raises(ServeError, match="max_tokens"):
        eng.submit(np.ones(3, np.int32), 0)
    with pytest.raises(ServeError, match="max_len"):
        eng.submit(np.ones(3, np.int32), 1000)
    with pytest.raises(ValueError, match="max_len"):
        _engine(pair, max_len=4096)     # beyond the positional cap
    with pytest.raises(NotImplementedError, match="tp-sharded"):
        _engine(pair, mesh=object())


def test_queue_deadline_times_out_typed(pair):
    prompt = _prompts(1, seed=6)[0]
    with _engine(pair, slots=1, page=8, min_step_s=0.02) as eng:
        slow = eng.submit(prompt, 30)
        late = eng.submit(prompt, 4, deadline_ms=40.0)
        with pytest.raises(RequestTimeout):
            late.result(120.0)
        np.testing.assert_array_equal(slow.result(120.0),
                                      _oracles(pair, prompt, 30))
        assert eng.stats()["queue"]["shed_timeout"] == 1


def test_tenant_quota_rejects_typed(pair):
    prompt = _prompts(1, seed=7)[0]
    with _engine(pair, slots=1, page=8, tenant_qps=0.001,
                 tenant_burst=1) as eng:
        first = eng.submit(prompt, 2, tenant="team-a")
        with pytest.raises(QuotaExceeded):
            eng.submit(prompt, 2, tenant="team-a")
        first.result(120.0)
        assert eng.stats()["quota"]["denied_by_tenant"] == {"team-a": 1}


def test_prefill_fault_fails_one_sequence(pair, monkeypatch):
    prompts = _prompts(4, seed=8)
    bad = prompts[1]
    real = DecodeEngine._prefill

    def prefill(self, s, prompt):
        if np.array_equal(prompt, bad):
            raise RuntimeError("injected prefill fault")
        return real(self, s, prompt)

    monkeypatch.setattr(DecodeEngine, "_prefill", prefill)
    with _engine(pair, slots=2, page=8) as eng:
        handles = [eng.submit(p, 5) for p in prompts]
        with pytest.raises(SlotFault, match="injected"):
            handles[1].result(120.0)
        outs = [h.result(120.0) for i, h in enumerate(handles) if i != 1]
        st = eng.stats()
    assert st["seqs_failed"] == 1 and st["seqs_done"] == 3
    for p, out in zip([p for i, p in enumerate(prompts) if i != 1], outs):
        np.testing.assert_array_equal(out, _oracles(pair, p, 5))


def test_engine_needs_a_device(pair, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeEngine(pair[1])
    with pytest.raises(ValueError, match="lives on cpu"):
        DecodeEngine(pair[1], device="meta")
