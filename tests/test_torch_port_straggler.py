"""The straggler drop and the log interval's loss read of the port's
Optimizer, held to the JAX package's.

- ``utils/util.py`` ``kth_largest``: equal to the reference's (and to a
  sort) for every k of seeded lists with ties.
- ``_straggler_check``: both packages' Optimizers, configured by
  ``set_drop_module_property``, are given the same replayed data waits,
  iteration numbers and prefetch queue depths; every decision, threshold
  and counter agrees exactly (both run the same float comparisons).
- ``set_log_interval(3)``: LeNet-5 with the reference's weights copied in
  trains 7 iterations over two epochs in each package with a
  ``step.loss_nan`` schedule armed; the ``state["loss"]`` that the end
  trigger sees before each iteration is the reference's (NaN where the
  reference's is NaN, else within 1e-5: float32 sums in another order),
  and so are the chaos point's counts and the iteration the NaN aborts.
  The previous tree read every step's loss: there the trigger saw step 1's
  loss before iteration 2, where the reference sees NaN.
- A run that drops an iteration: the injected data wait at one batch gives
  exactly one drop, that batch never reaches the step.
"""

import math

import numpy as np
import pytest

import jax
from bigdl_tpu import Engine as JEngine
import bigdl_tpu.nn as jnn
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.models import LeNet5 as JLeNet5
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Optimizer as JOptimizer
from bigdl_tpu.optim.trigger import Trigger as JTrigger
from bigdl_tpu.utils import chaos as jchaos
from bigdl_tpu.utils.util import kth_largest as jkth

import bigdl_torch.nn as tnn
from bigdl_torch.dataset import DataSet as TDataSet
from bigdl_torch.dataset import Sample as TSample
from bigdl_torch.models import LeNet5 as TLeNet5
from bigdl_torch.optim import SGD as TSGD
from bigdl_torch.optim import NonFiniteLossError
from bigdl_torch.optim import Optimizer as TOptimizer
from bigdl_torch.optim import Trigger as TTrigger
from bigdl_torch.utils import chaos as tchaos
from bigdl_torch.utils.convert import load_reference_tree
from bigdl_torch.utils.util import kth_largest as tkth

LOSS_TOL = 1e-5
N, BATCH = 32, 8


@pytest.fixture(autouse=True)
def _clean():
    from bigdl_tpu.common import get_default_rng
    state = get_default_rng().get_state()
    jchaos.clear()
    tchaos.clear()
    yield
    jchaos.clear()
    tchaos.clear()
    get_default_rng().set_state(state)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kth_largest_like_reference(seed):
    rs = np.random.RandomState(seed)
    vals = list(rs.randint(0, 6, 17).astype(float)) + \
        list(rs.standard_normal(9))
    want = sorted(vals, reverse=True)
    for k in range(1, len(vals) + 1):
        assert tkth(vals, k) == jkth(vals, k) == want[k - 1]
    with pytest.raises(ValueError):
        tkth(vals, 0)
    with pytest.raises(ValueError):
        tkth(vals, len(vals) + 1)


def _mnist(n, seed):
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((n, 28, 28, 1)).astype(np.float32)
    y = rs.randint(0, 10, n).astype(np.int32)
    return x, y


def _pair():
    jm = JLeNet5(10).build(jax.random.key(3))
    tm = TLeNet5(10).build("cpu")
    load_reference_tree(tm, jax.tree.map(np.asarray, jm.params),
                        jax.tree.map(np.asarray, jm.state))
    return jm, tm


CASES = [dict(drop=0.1, max_drop=0.2, window=10, warmup=3),
         dict(drop=0.25, max_drop=0.25, window=8, warmup=0),
         dict(drop=0.05, max_drop=1.0, window=2, warmup=5)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: str(c["window"]))
def test_straggler_check_replays_like_reference(case):
    jm, tm = _pair()
    x, y = _mnist(N, 0)
    JEngine.init()
    jopt = JOptimizer(jm, JDataSet.array([JSample(a, b) for a, b in
                                          zip(x, y)]),
                      jnn.ClassNLLCriterion(), batch_size=BATCH)
    topt = TOptimizer(tm, TDataSet.array([TSample(a, b) for a, b in
                                          zip(x, y)]),
                      tnn.ClassNLLCriterion(), batch_size=BATCH,
                      device="cpu")
    for o in (jopt, topt):
        o.set_drop_module_property(case["drop"], case["max_drop"],
                                   case["window"], case["warmup"])
    rs = np.random.RandomState(7)
    waits = rs.exponential(0.01, 120)
    waits[rs.randint(0, 120, 14)] *= 40   # stragglers
    depths = [None if i % 5 == 0 else int(d)
              for i, d in enumerate(rs.randint(0, 3, 120))]
    got, want = [], []
    for i, (w, d) in enumerate(zip(waits, depths)):
        want.append((jopt._straggler_check(float(w), i + 1, d),
                     jopt._drop_threshold))
        got.append((topt._straggler_check(float(w), i + 1, d),
                     topt._drop_threshold))
    assert got == want
    assert sum(g for g, _ in got) > 0
    for name in ("dropped iterations", "prefetch queue depth"):
        assert topt.metrics.get(name) == tuple(jopt.metrics.get(name))
    with pytest.raises(ValueError):
        topt.set_drop_module_property(0.5, 0.1)


def _loss_seen(Trigger, seen, steps):
    def fn(state):
        seen.append((state["neval"], state["loss"]))
        return state["neval"] > steps
    return Trigger(fn, "steps")


def _same_losses(got, want):
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert math.isnan(g) == math.isnan(w), (got, want)
        if not math.isnan(w):
            assert abs(g - w) <= LOSS_TOL, (got, want)


@pytest.mark.parametrize("spec", [None, "step.loss_nan=nan@4"])
def test_log_interval_stale_loss_like_reference(spec):
    """7 iterations of 4 batches an epoch at ``set_log_interval(3)``:
    iterations 1, 2, 4, 5 read the previous step's loss after the next
    step, 3 and 6 their own, and an epoch's end the pending one."""
    jm, tm = _pair()
    x, y = _mnist(N, 1)
    JEngine.init()
    runs = {}
    for name, (Opt, DS, S, nn, SGD, Trigger, chaos) in {
            "jax": (JOptimizer, JDataSet, JSample, jnn, JSGD, JTrigger,
                    jchaos),
            "torch": (TOptimizer, TDataSet, TSample, tnn, TSGD, TTrigger,
                      tchaos)}.items():
        kw = {"device": "cpu"} if name == "torch" else {}
        opt = Opt(jm if name == "jax" else tm,
                  DS.array([S(a, b) for a, b in zip(x, y)]),
                  nn.ClassNLLCriterion(), batch_size=BATCH, **kw)
        seen = []
        opt.set_optim_method(SGD(0.05)).set_log_interval(3)
        opt.set_end_when(_loss_seen(Trigger, seen, 7))
        err = None
        with chaos.scoped(spec or ""):
            try:
                opt.optimize()
            except Exception as e:  # noqa: BLE001 - compared below
                err = type(e).__name__
            counts = chaos.counts().get("step.loss_nan", 0)
        runs[name] = (seen, counts, err)
    (jseen, jcounts, jerr), (tseen, tcounts, terr) = \
        runs["jax"], runs["torch"]
    _same_losses(tseen, jseen)
    assert tcounts == jcounts
    assert (terr is None) == (jerr is None)
    if spec is None:
        assert math.isnan(dict(tseen)[2])   # step 1's loss not read yet
    else:
        assert terr == NonFiniteLossError.__name__ and tcounts >= 4


class _SlowAt:
    """The dataset's batches, kept in ``yielded``; a sleep before batch
    ``at``."""

    def __init__(self, base, at, seconds):
        self.base, self.at, self.seconds = base, at, seconds
        self.yielded = []

    def __getattr__(self, name):
        return getattr(self.base, name)

    def data(self, train):
        import time
        for i, batch in enumerate(self.base.data(train)):
            if i == self.at:
                time.sleep(self.seconds)
            self.yielded.append(batch)
            yield batch


def test_injected_wait_drops_one_iteration(monkeypatch):
    from bigdl_torch.dataset import SampleToMiniBatch
    monkeypatch.setenv("BIGDL_TORCH_PREFETCH_DEPTH", "0")
    _, tm = _pair()
    x, y = _mnist(8 * 12, 2)
    seen = []
    ds = _SlowAt(TDataSet.array([TSample(a, b) for a, b in zip(x, y)])
                 .transform(SampleToMiniBatch(8, drop_last=True)), 10, 0.3)
    opt = TOptimizer(tm, ds, tnn.ClassNLLCriterion(), device="cpu")
    # a window of 20 waits: a threshold from the 10th fetch on, and a
    # budget of one drop (1/20 <= 0.05 < 2/20) that no window end renews,
    # so the first iteration that may drop is the injected one and host
    # jitter cannot add a second
    opt.set_drop_module_property(0.05, 0.05, batch_size=20,
                                 warmup_iteration=0)
    inputs = []
    tm.register_forward_pre_hook(lambda m, i: inputs.append(i[0].clone()))
    opt.set_optim_method(TSGD(0.01)).set_end_when(
        _loss_seen(TTrigger, seen, 11))
    opt.optimize()
    assert opt.metrics.get("dropped iterations") == (1.0, 1)
    assert len(ds.yielded) == 12 and len(inputs) == 11
    kept = [b for i, b in enumerate(ds.yielded) if i != 10]
    assert all(np.array_equal(t.numpy(), b.get_input())
               for t, b in zip(inputs, kept))
