"""The port's input pipeline against the JAX package's contracts.

``bigdl_torch/dataset/prefetch.py`` keeps the reference's
``PrefetchIterator`` contracts (tests/test_prefetch.py): the depth knob,
order and completeness, exceptions re-raised at their item, a clean
``close()``, and overlap.  The Optimizer's pipeline (one worker thread
assembling and staging each batch) must train bit-identically to the
synchronous path at ``BIGDL_TORCH_PREFETCH_DEPTH=0`` and visit the batches
in the reference's ``DataSet.array`` order from the same seed.  On the CPU
a staged batch is ``torch.as_tensor`` of the host arrays; the pinned,
side-stream staging runs on the card (chip_smoke.py's ``train``)."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.dataset import SampleToMiniBatch as JSampleToMiniBatch

import bigdl_torch.nn as tnn
from bigdl_torch.dataset import DataSet, Sample
from bigdl_torch.dataset.prefetch import PrefetchIterator, prefetch_depth
from bigdl_torch.optim import SGD, Optimizer, Trigger
from bigdl_torch.optim import optimizer as opt_mod

BATCH = 8


def test_depth_env_knob(monkeypatch):
    monkeypatch.delenv("BIGDL_TORCH_PREFETCH_DEPTH", raising=False)
    assert prefetch_depth() == 2  # the documented default
    monkeypatch.setenv("BIGDL_TORCH_PREFETCH_DEPTH", "0")
    assert prefetch_depth() == 0
    monkeypatch.setenv("BIGDL_TORCH_PREFETCH_DEPTH", "5")
    assert prefetch_depth() == 5
    monkeypatch.setenv("BIGDL_TORCH_PREFETCH_DEPTH", "-3")
    assert prefetch_depth() == 0


def test_order_completeness_and_transform():
    with PrefetchIterator(iter(range(100)), depth=3,
                          transform=lambda x: x * 2) as pipe:
        out = list(pipe)
    assert out == [2 * i for i in range(100)]
    assert not pipe._thread.is_alive()


def test_order_holds_under_fast_thread_switching():
    """A consumer that also runs Python while the worker produces, with the
    interpreter switching threads every microsecond: every item arrives
    once, in order, and the worker exits."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with PrefetchIterator(iter(range(2000)), depth=2,
                              transform=lambda x: (x, x * x)) as pipe:
            out = [item for item in pipe if sum(range(20)) >= 0]
        pipe._thread.join(timeout=10)
    finally:
        sys.setswitchinterval(old)
    assert out == [(i, i * i) for i in range(2000)]
    assert not pipe._thread.is_alive()


def test_transform_and_pre_fire_run_in_the_worker():
    threads = set()

    def note(x=None):
        threads.add(threading.current_thread().name)
        return x

    with PrefetchIterator(iter(range(5)), depth=2, transform=note,
                          pre_fire=note, name="t-worker") as pipe:
        assert list(pipe) == list(range(5))
    assert threads == {"t-worker"}


@pytest.mark.parametrize("where", ["source", "transform"])
def test_exception_reraised_in_order(where):
    def source():
        yield from (0, 1, 2)
        if where == "source":
            raise ValueError("boom at item 4")
        yield 3

    def transform(x):
        if x == 3:
            raise ValueError("boom at item 4")
        return x

    pipe = PrefetchIterator(source(), depth=2, transform=transform)
    try:
        assert [next(pipe) for _ in range(3)] == [0, 1, 2]
        with pytest.raises(ValueError, match="boom at item 4"):
            next(pipe)
        with pytest.raises(StopIteration):  # terminal after the raise
            next(pipe)
    finally:
        pipe.close()


def test_close_unblocks_producer_and_joins():
    """A worker parked on a full queue (an endless source) sees close()
    and exits; close() closes the source and may be called again."""
    before = threading.active_count()
    closed = []

    def forever():
        i = 0
        try:
            while True:
                yield i
                i += 1
        finally:
            closed.append(True)

    pipe = PrefetchIterator(forever(), depth=2)
    assert next(pipe) == 0
    time.sleep(0.1)  # let the worker fill the queue and park
    assert pipe.queue_depth() == 2
    pipe.close()
    pipe.close()
    assert not pipe._thread.is_alive() and closed == [True]
    with pytest.raises(StopIteration):
        next(pipe)
    deadline = time.monotonic() + 2.0
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before


def test_overlap_wallclock_near_single_cost_bound():
    """50 ms a batch in the worker and 50 ms a step in the consumer, 20
    steps at depth 2: the wall stays under 1.6x the single-cost bound
    (serialized it would be about 2x)."""
    n, data_s, step_s = 20, 0.05, 0.05

    def source():
        for i in range(n):
            time.sleep(data_s)
            yield i

    t0 = time.perf_counter()
    consumed = 0
    with PrefetchIterator(source(), depth=2) as pipe:
        for _ in pipe:
            time.sleep(step_s)
            consumed += 1
    wall = time.perf_counter() - t0
    assert consumed == n
    bound = n * max(data_s, step_s)
    assert wall < 1.6 * bound, (wall, bound)


# -- the Optimizer's pipeline ------------------------------------------------

def _samples(n=48, seed=0):
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((n, 12)).astype(np.float32)
    y = rs.integers(0, 5, n).astype(np.int32)
    return x, y


def _model():
    return (tnn.Sequential().add(tnn.Linear(12, 16)).add(tnn.ReLU())
            .add(tnn.Linear(16, 5))).build(
                "cpu", torch.Generator().manual_seed(3))


def _train(monkeypatch, depth, stage="1", steps=5, dataset=None):
    """``steps`` SGD steps over two epochs' worth of batches; returns (the
    losses the driver observed, the inputs the model saw, the params, the
    optimizer)."""
    monkeypatch.setenv("BIGDL_TORCH_PREFETCH_DEPTH", depth)
    monkeypatch.setenv("BIGDL_TORCH_PREFETCH_STAGE", stage)
    x, y = _samples()
    model = _model()
    seen, losses = [], {}
    model.register_forward_pre_hook(
        lambda mod, inp: seen.append(inp[0].clone()))

    def end(state):
        if state["neval"] > 1:
            losses[state["neval"] - 1] = state["loss"]
        return state["neval"] > steps

    opt = Optimizer(model, dataset or DataSet.array(
        [Sample(x[i], y[i]) for i in range(len(x))], seed=7),
        tnn.CrossEntropyCriterion(), batch_size=BATCH, device="cpu")
    opt.set_optim_method(SGD(0.1, momentum=0.9)).set_end_when(
        Trigger(end, "steps"))
    opt.optimize()
    return ([losses[k] for k in sorted(losses)], seen,
            [p.detach().clone() for p in model.parameters()], opt)


def test_training_bit_identical_depth0_vs_depth2(monkeypatch):
    """Depth 0 (the synchronous path), depth 2 with staging and depth 2
    without it give the same losses, inputs and params bit for bit, over
    an epoch boundary (48 records, batch 8: 6 steps an epoch, 8 steps)."""
    ref_losses, ref_seen, ref_params, _ = _train(monkeypatch, "0", steps=8)
    assert len(ref_losses) == 8 and len(ref_seen) == 8
    for depth, stage in (("2", "1"), ("2", "0"), ("1", "1")):
        losses, seen, params, _ = _train(monkeypatch, depth, stage, steps=8)
        assert losses == ref_losses  # exact float equality
        assert all(torch.equal(a, b) for a, b in zip(seen, ref_seen))
        assert all(torch.equal(a, b) for a, b in zip(params, ref_params))


@pytest.mark.parametrize("depth", ["0", "2"])
def test_batch_order_matches_reference(monkeypatch, depth):
    """The port's Optimizer feeds the batches of the reference's
    DataSet.array at the same seed, in its order (one shuffle per epoch
    before the pass)."""
    x, y = _samples()
    ref = JDataSet.array([JSample.from_ndarray(x[i], y[i])
                          for i in range(len(x))], seed=7).transform(
        JSampleToMiniBatch(BATCH, drop_last=True))
    ref.shuffle()
    want = [np.asarray(b.get_input()) for b in ref.data(train=True)]
    _, seen, _, _ = _train(monkeypatch, depth, steps=len(want))
    assert len(seen) == len(want) == len(x) // BATCH
    for a, b in zip(seen, want):
        np.testing.assert_array_equal(a.numpy(), b)


def test_counters_and_epoch_close(monkeypatch):
    """The reference's two driver counters, one entry a step; every epoch's
    pipe is closed (no worker outlives optimize)."""
    before = {t for t in threading.enumerate()}
    _, _, _, opt = _train(monkeypatch, "2", steps=8)
    for name in ("get batch time average", "computing time average"):
        total, count = opt.metrics.get(name)
        assert count == 8 and total >= 0
    leftover = [t for t in threading.enumerate()
                if t not in before and t.name == "bigdl-torch-prefetch"]
    assert not leftover


class _Poisoned:
    """A dataset whose transformer chain raises on its fourth batch."""

    def __init__(self, base):
        self.base = base

    def size(self):
        return self.base.size()

    def shuffle(self):
        self.base.shuffle()

    def data(self, train):
        for i, batch in enumerate(self.base.data(train)):
            if i == 3:
                raise KeyError("corrupt batch 4")
            yield batch

    def transform(self, t):
        self.base = self.base.transform(t)
        return self


@pytest.mark.parametrize("depth", ["0", "2"])
def test_worker_exception_reaches_optimize_at_its_batch(monkeypatch, depth):
    """An exception in the transformer chain surfaces from optimize() after
    exactly the batches before it trained, and the pipe is closed."""
    x, y = _samples()
    ds = _Poisoned(DataSet.array([Sample(x[i], y[i])
                                  for i in range(len(x))], seed=7))
    losses = []
    monkeypatch.setattr(Optimizer, "_observe_loss", staticmethod(
        lambda lossf, state: losses.append(lossf) or lossf))
    with pytest.raises(KeyError, match="corrupt batch 4"):
        _train(monkeypatch, depth, steps=8, dataset=ds)
    assert len(losses) == 3
    assert not [t for t in threading.enumerate()
                if t.name == "bigdl-torch-prefetch" and t.is_alive()]


@pytest.mark.parametrize("arrays", [
    [np.arange(12, dtype=np.float32).reshape(3, 4) + i for i in range(5)],
    [np.arange(6, dtype=np.int64)[::2] * i for i in range(3)],  # strided
    [np.int32(3), np.int32(4)],                   # numpy scalars
    [np.array([True, False]), np.array([False, False])],
], ids=["float32", "strided", "scalars", "bool"])
def test_cpu_stager_is_as_tensor(arrays):
    """On the CPU a staged batch is the collated host arrays as tensors,
    with no event to wait on; a batch without targets stages its input
    alone."""
    from bigdl_torch.dataset import MiniBatch
    from bigdl_torch.dataset import SampleToMiniBatch

    x = SampleToMiniBatch._batch([Sample(a) for a in arrays]).get_input()
    y = np.arange(len(arrays), dtype=np.int32)
    assert x.dtype == np.stack(arrays).dtype
    stager = opt_mod._Stager(torch.device("cpu"), 4)
    inp, tgt, event = stager(MiniBatch(x, y))
    assert event is None and torch.equal(inp, torch.from_numpy(x))
    np.testing.assert_array_equal(inp.numpy(), np.stack(arrays))
    assert torch.equal(tgt, torch.from_numpy(y))
    assert opt_mod._consume((inp, tgt, event)) == (inp, tgt)
    inp, tgt, event = stager(MiniBatch(x))
    assert tgt is None and torch.equal(inp, torch.from_numpy(x))
