"""The port's InferenceServer serving TransformerLM with seq_buckets,
against its own Predictor and against the JAX InferenceServer.

Mirrors tests/test_serve_seq.py: requests of mixed lengths coalesce onto
(batch bucket, sequence bucket) shapes, each answer has its bucket's
length, oversized and rank-stray samples are refused at admission, and a
request whose deadline passed is shed before the device.  The batcher's
admission policy (expiry sweep, priority eviction, overload refusal,
no-drain close) is driven through the JAX batcher and the port's alike.

Tolerances:
- port server vs the port's Predictor on the same padded row: exact.  The
  same arithmetic, and torch's CPU matmul gives bit-equal rows whether the
  row runs alone or inside a padded batch of up to four.
- port server vs JAX server: 1e-4 absolute, the float32 whole-model bound
  of test_torch_port_lm.py.
"""

import numpy as np
import pytest

import jax
from bigdl_tpu import Engine
from bigdl_tpu.models import transformer_lm as jlm
from bigdl_tpu.serve import InferenceServer as JServer
from bigdl_tpu.serve.batcher import DynamicBatcher as JBatcher

from bigdl_torch.models import TransformerLM
from bigdl_torch.optim import Predictor
from bigdl_torch.serve import (DynamicBatcher, InferenceServer,
                               RequestTimeout, ServeError, ServerClosed,
                               fit_bucket, pad_tail)
from bigdl_torch.utils.convert import load_reference_tree

CFG = dict(vocab_size=97, max_len=64, d_model=32, num_heads=4,
           num_layers=2)
LADDER = (16, 32, 64)
LENGTHS = [3, 16, 17, 9, 40, 64, 25, 33]
REF_ATOL = 1e-4


def _models():
    jm = jlm.TransformerLM(**CFG).build(jax.random.key(0))
    tm = TransformerLM(**CFG).build("cpu")
    load_reference_tree(tm, jax.tree.map(np.asarray, jm.params),
                        jax.tree.map(np.asarray, jm.state))
    return jm, tm


def _tokens(n, seed):
    return np.random.RandomState(seed).randint(0, 97, (n,)).astype(np.int64)


def test_seq_buckets_serve_matches_predictor_and_reference():
    jm, tm = _models()
    xs = [_tokens(n, seed=i) for i, n in enumerate(LENGTHS)]
    server = InferenceServer(tm, device="cpu", seq_buckets=LADDER,
                             max_batch=4, max_wait_ms=10,
                             example=np.zeros((16,), np.int64))
    handles = [server.submit(x) for x in xs]  # queued before start
    server.start()
    outs = [h.result(60) for h in handles]
    stats = server.stats()
    server.stop()
    assert stats["batch_rows"] == len(LENGTHS)
    assert stats["warmup_batches"] == 3 * len(LADDER)  # buckets 1, 2, 4
    # two collects of four, each split into one batch per seq bucket:
    # {3, 16, 9}->16 and {17}->32, then {25}->32 and {40, 64, 33}->64
    assert stats["batches"] == 4, stats
    assert stats["shed_timeout"] == stats["shed_overload"] == 0

    Engine.init()
    jserver = JServer(jm, seq_buckets=LADDER, max_batch=4, max_wait_ms=10)
    jhandles = [jserver.submit(x.astype(np.int32)) for x in xs]
    jserver.start()
    jouts = [h.result(120) for h in jhandles]
    jserver.stop()

    predictor = Predictor(tm, device="cpu")
    for x, out, jout in zip(xs, outs, jouts):
        seq = fit_bucket(len(x), LADDER)
        assert out.shape == (seq, CFG["vocab_size"]) == jout.shape
        assert out.dtype == np.float32 and np.isfinite(out).all()
        ref = predictor.predict(pad_tail(x, seq)[None, :])[0]
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_allclose(out, np.asarray(jout), atol=REF_ATOL,
                                   rtol=0)


def test_oversized_and_rank_strays_rejected_at_admission():
    _, tm = _models()
    with InferenceServer(tm, device="cpu", seq_buckets=LADDER,
                         max_wait_ms=2,
                         example=np.zeros((16,), np.int64)) as server:
        with pytest.raises(ServeError, match="exceeds"):
            server.submit(np.zeros((LADDER[-1] + 1,), np.int64))
        with pytest.raises(ServeError, match="leading dims"):
            server.submit(np.zeros((2, 4), np.int64))
        assert server.predict(_tokens(5, 0), timeout=60).shape == (16, 97)
    with pytest.raises(ServerClosed):
        server.submit(_tokens(5, 0))


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def test_expired_deadline_sheds_before_device():
    _, tm = _models()
    clock = _Clock()
    server = InferenceServer(tm, device="cpu", seq_buckets=LADDER,
                             max_batch=4, max_wait_ms=2, clock=clock,
                             example=np.zeros((16,), np.int64))
    late = [server.submit(_tokens(n, n), deadline_ms=5) for n in (3, 20)]
    clock.t += 1.0  # both deadlines are now in the past
    fresh = server.submit(_tokens(6, 0))
    server.start()
    for h in late:
        with pytest.raises(RequestTimeout):
            h.result(60)
    assert fresh.result(60).shape == (16, 97)
    stats = server.stats()
    server.stop()
    assert stats["shed_timeout"] == 2
    assert stats["batch_rows"] == 1


def _admission_script(batcher_cls):
    """One admission sequence against a full queue of two: an expired
    entry swept at admission, a higher-priority arrival evicting the
    newest lowest-priority entry, an equal-priority arrival refused, then
    a no-drain close.  Returns what each request saw, and the counters."""
    clock = _Clock()
    b = batcher_cls(max_batch=4, max_wait_s=0.0, queue_limit=2, clock=clock)
    seen = {}

    def outcome(h):
        if not h.done():
            return "queued"
        try:
            h.result(0)
            return "ok"
        except Exception as e:  # noqa: BLE001 - the type is the outcome
            return type(e).__name__

    a = b.submit("a", deadline=clock.t + 0.5)
    low = b.submit("low", priority=0)
    clock.t += 1.0                       # a's deadline passes
    c = b.submit("c", priority=0)        # sweeps a, takes its slot
    hi = b.submit("hi", priority=2)      # evicts c (newest of priority 0)
    try:
        b.submit("d", priority=0)        # nothing below it: refused
        seen["d"] = "admitted"
    except Exception as e:  # noqa: BLE001 - each side has its own class
        seen["d"] = (type(e).__name__, e.retry_after_s is not None)
    b.close(drain=False)                 # low and hi fail typed
    for name, h in (("a", a), ("low", low), ("c", c), ("hi", hi)):
        seen[name] = outcome(h)
    stats = b.stats()
    return seen, {k: stats[k] for k in ("submitted", "shed_overload",
                                        "shed_timeout", "shed_priority",
                                        "shed_by_priority")}


def test_batcher_admission_matches_reference():
    port_seen, port_stats = _admission_script(DynamicBatcher)
    ref_seen, ref_stats = _admission_script(JBatcher)
    assert port_stats == ref_stats
    assert port_seen == ref_seen  # by class name: each side has its own
    assert port_seen["d"] == ("ServerOverloaded", True)
    assert port_seen["a"] == "RequestTimeout"
    assert port_seen["c"] == "ServerOverloaded"
    assert port_seen["low"] == port_seen["hi"] == "ServerClosed"
    assert port_stats["shed_by_priority"] == {"0": 3}
