"""The decode engine's step bodies, which CUDA graphs capture per bucket,
run eagerly on the CPU against the JAX package and the port's eager path;
and the scoring answer's trip to the host.

``DecodeEngine(device="cpu")`` (``serve/decode.py``) keeps one cache set
per rung of its page ladder, prefills each prompt on a [1, H, L, D]
scratch cache with the token and position read from a device cursor, and
commits the scratch into the slot; a tick runs every slot from the static
[2, slots] tokens-and-positions input.  On CUDA each of those bodies is
captured once per (kind, cache_len) and replayed; on the CPU the same
bodies run with no graph, so ``stats()["graphs"]`` counts no capture.
TransformerLM(vocab 64, max_len 64, E 32, H 2, L 2) is built by the JAX
package and carried over with ``load_reference_tree``; prompts come from
numpy's ``default_rng``.  Every comparison is exact: the bodies compute
the eager path's arithmetic on the same operands (a scratch [1, H, L, D]
cache and a slot view of the engine's cache have the same shape and
strides), and greedy rows equal ``cached_generate`` of the JAX package and
of the port, as ``tests/test_torch_port_decode_serve.py`` holds them.

``HostCopy`` (``optim/optimizer.py``), which ``ModelVersion.predict`` and
``Predictor.predict`` bring answers through, gives ``to_host``'s answers
bit for bit, float32 and bfloat16 outputs alike.
"""

import time

import numpy as np
import pytest
import torch

import jax
from bigdl_tpu.models import decode as jdec
from bigdl_tpu.models import transformer_lm as jlm

from bigdl_torch.common import DTypePolicy, get_policy, set_policy
from bigdl_torch.models import decode as tdec
from bigdl_torch.models import transformer_lm as tlm
from bigdl_torch.ops import decode_attention as dec_ops
from bigdl_torch.optim import Predictor
from bigdl_torch.optim.optimizer import HostCopy, _Forward, to_host
from bigdl_torch.serve import DecodeEngine
from bigdl_torch.serve.server import ModelVersion
from bigdl_torch.utils.convert import load_reference_tree

CFG = dict(vocab_size=64, max_len=64, d_model=32, num_heads=2,
           num_layers=2)
NO_GRAPHS = {"captures": 0, "replays": 0, "buckets": []}


@pytest.fixture(scope="module")
def pair():
    jm = jlm.TransformerLM(**CFG).build(jax.random.key(0))
    tm = tlm.TransformerLM(**CFG).build("cpu")
    load_reference_tree(tm, jax.tree.map(np.asarray, jm.params),
                        jax.tree.map(np.asarray, jm.state))
    return jm, tm


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(1, 64, n).astype(np.int32)


def _oracle(pair, prompt, max_tokens):
    """The port's cached_generate, held to the JAX package's."""
    jm, tm = pair
    port = tdec.cached_generate(tm, prompt, max_tokens,
                                max_len=len(prompt) + max_tokens)
    ref = jdec.cached_generate(jm, prompt, max_tokens, max_len=CFG["max_len"])
    np.testing.assert_array_equal(port, np.asarray(ref))
    return port


def _wait_active(eng):
    deadline = time.monotonic() + 60.0
    while eng.stats()["active"] == 0:
        assert time.monotonic() < deadline, "never admitted"
        time.sleep(0.002)


def _clone(caches):
    return [{n: t.clone() for n, t in c.items()} for c in caches]


def _garbage(caches, seed):
    """Fill every cache row with values no step wrote."""
    gen = torch.Generator().manual_seed(seed)
    for c in caches:
        for t in c.values():
            t.copy_(torch.randn(t.shape, generator=gen) * 100)


def _eager_prefill(model, caches, s, prompt):
    """The eager prefill on slot ``s``'s cache views: one rows=1
    ``decode_step`` a position; the last position's log-probs [vocab]."""
    sub = [{n: t[s:s + 1] for n, t in c.items()} for c in caches]
    toks = torch.from_numpy(prompt)
    for i in range(len(prompt)):
        logits = tdec.decode_step(model, sub, toks[i:i + 1],
                                  torch.tensor([i], dtype=torch.int32))
    return logits[0].float()


# ---------------------------------------------------------------------------
# the engine's rows across a grow and an idle re-page
# ---------------------------------------------------------------------------

def test_rows_match_oracles_across_grow_and_repage(pair):
    short, long = _prompt(5, 1), _prompt(9, 2)
    tiny, again = _prompt(3, 3), _prompt(6, 4)
    with DecodeEngine(pair[1], device="cpu", slots=2, page=8,
                      min_step_s=0.01) as eng:
        # short takes the 32 page; long, arriving in flight, needs 64
        ha = eng.submit(short, 25)
        _wait_active(eng)
        hb = eng.submit(long, 50)
        rows = [ha.result(120.0), hb.result(120.0)]
        grown = eng.stats()
        # idle: re-page down to 8, then up to 32 on the rung kept from
        # the first admission
        rows.append(eng.generate(tiny, 4))
        small = eng.stats()["cache_len"]
        rows.append(eng.generate(again, 20))
        st = eng.stats()
        rungs = sorted(eng._rungs)
    for (p, n), row in zip([(short, 25), (long, 50), (tiny, 4),
                            (again, 20)], rows):
        np.testing.assert_array_equal(row, _oracle(pair, p, n))
    assert grown["cache_len"] == 64 and grown["cache_grows"] == 1
    assert small == 8 and st["cache_len"] == 32 and rungs == [8, 32, 64]
    assert st["seqs_done"] == 4 and st["prefill_steps"] == 4
    assert st["graphs"] == NO_GRAPHS


def test_stats_report_no_capture_on_the_cpu(pair):
    eng = DecodeEngine(pair[1], device="cpu", slots=2, page=8)
    assert eng.stats()["graphs"] == NO_GRAPHS
    with eng:
        eng.generate(_prompt(4, 5), 3)
    assert eng.stats()["graphs"] == NO_GRAPHS


# ---------------------------------------------------------------------------
# the step bodies against the eager path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,n", [(0, 1), (1, 7), (2, 16)])
def test_cursor_prefill_and_commit_equal_eager_slot_prefill(pair, s, n):
    model = pair[1]
    eng = DecodeEngine(model, device="cpu", slots=3, page=8)
    prompt = _prompt(n, 10 + n)
    with torch.inference_mode():
        eng._ensure_cache(n + 4, idle=True)
        _garbage(eng._caches, seed=n)
        _garbage(eng._scratch[eng._cache_len], seed=n + 1)
        ref = _clone(eng._caches)
        want = _eager_prefill(model, ref, s, prompt)
        got = eng._prefill(s, prompt)
        assert int(eng._cursor[0]) == n
    assert got.dtype == torch.float32 and torch.equal(got, want)
    for c, r in zip(eng._caches, ref):
        for name in c:
            # the prompt's rows of slot s; every other slot untouched
            assert torch.equal(c[name][s, :, :n], r[name][s, :, :n])
            others = [i for i in range(3) if i != s]
            assert torch.equal(c[name][others], r[name][others])
    # rows past the prompt are the scratch's: never read, not compared


def test_prefill_rows_equal_cached_generate(pair):
    # the prefill's log-probs pick cached_generate's first token, and a
    # tick from the committed slot its second
    model = pair[1]
    prompt = _prompt(11, 20)
    eng = DecodeEngine(model, device="cpu", slots=2, page=8)
    with torch.inference_mode():
        eng._ensure_cache(len(prompt) + 2, idle=True)
        first = int(eng._prefill(1, prompt).argmax())
        tp = np.array([[0, first], [0, len(prompt)]], np.int32)
        second = int(eng._step_all(tp)[1].argmax())
    np.testing.assert_array_equal(
        np.concatenate([prompt, [first, second]]), _oracle(pair, prompt, 2))


def test_tick_body_equals_eager_decode_step(pair):
    model = pair[1]
    eng = DecodeEngine(model, device="cpu", slots=4, page=16)
    rng = np.random.default_rng(30)
    with torch.inference_mode():
        eng._ensure_cache(40, idle=True)
        _garbage(eng._caches, seed=30)
        tp = np.stack([rng.integers(0, 64, 4), [0, 5, 31, 17]]).astype(
            np.int32)
        ref = _clone(eng._caches)
        want = tdec.decode_step(model, ref, torch.from_numpy(tp[0]),
                                torch.from_numpy(tp[1])).float()
        got = eng._step_all(tp)
        assert torch.equal(eng._static["tp"], torch.from_numpy(tp))
    assert got.shape == (4, 64) and torch.equal(got, want)
    for c, r in zip(eng._caches, ref):
        for name in c:
            assert torch.equal(c[name], r[name])


# ---------------------------------------------------------------------------
# the per-rung buffers
# ---------------------------------------------------------------------------

def test_grow_equals_cat_with_zeros_and_repage_zeroes(pair):
    eng = DecodeEngine(pair[1], device="cpu", slots=2, page=8)
    with torch.inference_mode():
        eng._ensure_cache(6, idle=True)
        first = eng._caches
        ptrs = [c["k"].data_ptr() for c in first]
        _garbage(first, seed=40)
        old = _clone(first)
        eng._ensure_cache(20, idle=False)          # in flight: grow to 32
        assert eng._cache_len == 32 and eng.cache_grows == 1
        for c, o in zip(eng._caches, old):
            for name, t in c.items():
                pad = o[name].new_zeros(o[name].shape[:2] + (24,)
                                        + o[name].shape[3:])
                assert torch.equal(t, torch.cat([o[name], pad], dim=2))
        assert eng.cache_bytes_per_slot() == 2 * 2 * 2 * 32 * 16 * 4
        _garbage(eng._caches, seed=41)
        eng._ensure_cache(20, idle=False)          # fits: nothing moves
        assert eng._cache_len == 32 and eng.cache_grows == 1
        eng._ensure_cache(5, idle=True)            # idle: back to 8
        assert eng._caches is first and eng._cache_len == 8
        assert [c["k"].data_ptr() for c in eng._caches] == ptrs
        assert all(not t.any() for c in eng._caches for t in c.values())
        assert eng.cache_bytes_per_slot() == 2 * 2 * 2 * 8 * 16 * 4
        eng._ensure_cache(20, idle=True)           # idle: 32, zeroed
        assert all(not t.any() for c in eng._caches for t in c.values())
    assert sorted(eng._rungs) == sorted(eng._scratch) == [8, 32]
    assert eng.cache_grows == 1


# ---------------------------------------------------------------------------
# B8's launch count across captures and replays
# ---------------------------------------------------------------------------

def test_replays_count_what_the_capture_tallied():
    fn = dec_ops.decode_attention
    before, routes = fn.launches, dict(fn.route_launches)
    with dec_ops.counting_captures() as outer:
        with dec_ops.counting_captures() as inner:
            inner["bf16"] += 8
        assert dec_ops._capture.tally is outer
        assert outer == {"bf16": 0, "f32": 0}
    assert getattr(dec_ops._capture, "tally", None) is None
    dec_ops.count_replay(inner)
    dec_ops.count_replay(inner)
    assert fn.launches == before + 16
    assert fn.route_launches == {"bf16": routes["bf16"] + 16,
                                 "f32": routes["f32"]}
    fn.launches, fn.route_launches = before, routes


# ---------------------------------------------------------------------------
# the scoring answer's trip to the host
# ---------------------------------------------------------------------------

@pytest.fixture(params=[torch.float32, torch.bfloat16],
                ids=["float32", "bfloat16"])
def compute_dtype(request):
    old = get_policy()
    set_policy(DTypePolicy(compute_dtype=request.param))
    yield request.param
    set_policy(old)


def test_host_copy_gives_to_host_answers(compute_dtype):
    t = torch.randn((3, 5, 7), generator=torch.Generator().manual_seed(50))
    t = t.to(compute_dtype)
    got = HostCopy()(t)
    want = t.float().numpy()
    assert got.dtype == np.float32 and got.shape == (3, 5, 7)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, to_host(t))


def test_predict_answers_are_unchanged(pair, compute_dtype):
    lm = tlm.TransformerLM(**CFG).build(
        "cpu", torch.Generator().manual_seed(51))
    batch = np.random.default_rng(52).integers(0, 64, (3, 16))
    out, _ = _Forward(lm, "cpu")(batch)
    assert out.dtype == compute_dtype
    before = to_host(out)[:len(batch)]   # the route before HostCopy
    served = ModelVersion(1, lm, "v1", device="cpu").predict(batch)
    bulk = Predictor(lm, batch_size=2, device="cpu").predict(batch)
    for got in (served, bulk):
        assert got.dtype == np.float32 and got.shape == (3, 16, 64)
        np.testing.assert_array_equal(got, before)
