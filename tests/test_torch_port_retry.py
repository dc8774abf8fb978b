"""The fault-tolerant run of the port: chaos points, the supervisor, the
retry loop and preemption, on the CPU, held to the JAX package where both
run the same thing.

- ``utils/chaos.py``: every spec string below is installed in both
  packages and its points invoked 8 times each (at driver positions epoch
  2, iteration 1 to 8); what each invocation does (pass, raise, mutate,
  gate) and the counters agree.
- ``utils/supervisor.py``: on an injected clock, both packages' monitors
  report the same stalls (phase, idle seconds, deadline) for the same
  beats; the port's ``poll`` holds the deadlines, prefix lookup and
  channels; a ``raise`` stall lands in a thread sleeping in a chaos stall;
  a stalled prefetch worker reaches the consumer's ``next()``.
- The retry loop, as the reference's ``tests/test_fault_tolerance.py:
  51-245``: a failure before the first snapshot restores the starting
  weights bit for bit and the run ends bit-equal to one started afresh;
  after a snapshot the run recovers and ends bit-equal to an uninterrupted
  one, for a failure, a ``StallError`` and a non-finite loss; exhaustion
  raises the original error; no checkpoint path fails at once; a
  ``ConfigurationError`` is never retried.
- Preemption, as ``tests/test_preemption.py:63``: SIGTERM at iteration k
  gives a snapshot at k and ``TrainingPreempted``; ``resume_from`` then
  ends bit-equal to an uninterrupted run; under the Engine's group each
  boundary all-reduces the flag once.
"""

import json
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from bigdl_tpu.utils import chaos as jchaos
from bigdl_tpu.utils import supervisor as jsup

import bigdl_torch.nn as tnn
from bigdl_torch.dataset import DataSet, Sample, Transformer
from bigdl_torch.dataset import LocalArrayDataSet, SampleToMiniBatch
from bigdl_torch.dataset.prefetch import PrefetchIterator
from bigdl_torch.models import resnet as tresnet
from bigdl_torch.optim import (SGD, Adam, ConfigurationError,
                               NonFiniteLossError, Optimizer,
                               TrainingPreempted, Trigger)
from bigdl_torch.utils import chaos as tchaos
from bigdl_torch.utils import file_io
from bigdl_torch.utils import supervisor as tsup


# -- chaos ---------------------------------------------------------------------

SPECS = [
    "ckpt.write=corrupt@3",
    "ckpt.write=truncate@2,4",
    "fs.remote=fail*2@1",
    "data.batch=fail@6",
    "data.batch=nan@2",
    "step.stall=stall*0.01@5",
    "step.loss_nan=nan@3",
    "data.batch=fail@2:3",
    "ckpt.write=corrupt@3;fs.remote=fail*2@1;data.batch=fail@6",
    "host.return@1=@2:2",
    "host.return@1=join@3",
    "step.stall=stall*0.01@2:5;step.loss_nan=nan@4,7",
]

_PAYLOAD = {"ckpt.write": b"abcdefghijklmnop", "step.loss_nan": 1.5,
            "data.batch": np.ones((2, 3), np.float32)}


def _outcome(mod, point):
    if point.startswith("host.return"):
        return "gate" if mod.gate(point) else "-"
    payload = _PAYLOAD.get(point, b"x")
    t0 = time.perf_counter()
    try:
        out = mod.transform(point, payload)
    except mod.ChaosFault:
        return "raise"
    if time.perf_counter() - t0 >= 0.01:
        return "stall"
    if isinstance(out, float):
        return "nan" if out != out else out
    if isinstance(out, np.ndarray):
        return "nan" if np.isnan(out).any() else "same"
    return out


@pytest.mark.parametrize("spec", SPECS)
def test_chaos_spec_fires_like_reference(spec):
    points = [p.partition("=")[0] for p in spec.split(";")]
    got = {}
    for name, mod in (("ref", jchaos), ("port", tchaos)):
        with mod.scoped(spec):
            runs = []
            for i in range(1, 9):
                mod.at_position(2, i)
                runs.append([_outcome(mod, p) for p in points])
            got[name] = (runs, mod.counts(),
                         {p: [repr(s) for s in mod._POINTS[p].schedules]
                          for p in points})
    assert got["port"] == got["ref"]
    # every spec fires somewhere in the 8 invocations
    assert any(o in ("raise", "gate", "nan", "stall") or (
        isinstance(o, bytes) and o != _PAYLOAD.get(p, b"x"))
        for run in got["port"][0] for o, p in zip(run, points))


@pytest.mark.parametrize("bad", ["nope", "data.batch=fail", "x=zap@1",
                                 "fs.remote=fail*2@1,2"])
def test_bad_specs_raise_like_reference(bad):
    for mod in (jchaos, tchaos):
        with pytest.raises(ValueError):
            with mod.scoped(bad):
                pass


def test_exit_and_wedge_schedules_parse_like_reference():
    spec = "host.lost@1=exit@4;host.lost@2=wedge*30@2;host.lost@3=lost@1"
    reprs = []
    for mod in (jchaos, tchaos):
        with mod.scoped(spec):
            reprs.append({p: [repr(s) for s in v.schedules]
                          for p, v in mod._POINTS.items()})
    assert reprs[0] == reprs[1]


def test_chaos_env_knob(monkeypatch):
    monkeypatch.setenv("BIGDL_TORCH_CHAOS", "step.loss_nan=nan@2")
    tchaos.clear()
    try:
        assert tchaos.armed("step.loss_nan")
        assert tchaos.transform("step.loss_nan", 1.0) == 1.0
        assert tchaos.transform("step.loss_nan", 1.0) != 1.0
    finally:
        monkeypatch.delenv("BIGDL_TORCH_CHAOS")
        tchaos.clear()


# -- the supervisor ------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _stalls_of(mod):
    """Beats and clock moves through a monitor thread polling every 10 ms;
    the stalls it reports (phase, idle, deadline)."""
    clock, seen, hit = _Clock(), [], threading.Event()

    def on_stall(info):
        seen.append((info["phase"], info["idle_seconds"],
                     info["deadline_seconds"]))
        hit.set()
        return False
    sup = mod.Supervisor({"step": 5.0, "data": 2.0}, 10.0, clock=clock,
                         on_stall=on_stall, poll_interval=0.01)
    sup.beat("data")
    sup.start()
    try:
        for phase, dt in (("data", 1.5), ("step", 4.0), ("step", 6.0),
                          ("compile:b5", 9.0), ("compile:b5", 11.0),
                          ("data", 2.5)):
            hit.clear()
            sup.beat(phase)
            clock.t += dt
            hit.wait(0.3)
    finally:
        sup.stop()
    return seen


def test_supervisor_deadlines_like_reference():
    ref, port = _stalls_of(jsup), _stalls_of(tsup)
    assert port == ref
    assert [p for p, _, _ in port] == ["step", "compile:b5", "data"]


def test_supervisor_poll_deadlines_and_channels():
    clock = _Clock()
    sup = tsup.Supervisor({"step": 5.0}, clock=clock,
                          on_stall=lambda info: False)
    sup.beat("step")
    clock.t += 5.0
    assert not sup.poll() and sup.stalls == 0
    clock.t += 0.5
    sup.poll()
    assert sup.stalls == 1
    assert sup.deadline_for("step:x") == 5.0
    assert sup.deadline_for("data") is None
    ch = sup.channel("worker", phase="step")
    clock.t += 6.0
    sup.poll()
    # the channel's stall, then the main slot's grace: one more report
    assert sup.stalls == 2
    ch.close()
    # the peer half is ported: without a peer dir there is nothing to
    # watch, and a peer dir alone (a world of one) publishes nothing
    assert sup.check_peers() == {} and sup.stale_peers() == {}
    lone = tsup.Supervisor(peer_dir="/x")
    lone._publish_heartbeat()
    assert lone.heartbeat_errors == 0 and lone.lost_peers() == {}
    with pytest.raises(ValueError, match="policy"):
        tsup.Supervisor(policy="ignore")


def test_env_deadlines(monkeypatch):
    monkeypatch.setenv("BIGDL_TORCH_SUPERVISE_STEP", "7")
    monkeypatch.setenv("BIGDL_TORCH_SUPERVISE_DEADLINE", "30")
    assert tsup.env_deadlines() == ({"step": 7.0}, 30.0)


def test_stall_raises_into_the_sleeping_thread(tmp_path):
    """The raise policy: a StallError lands in a thread blocked in a chaos
    stall; the crash report parses as JSON and holds the timeline, every
    thread's stack, the chaos counters and the platform."""
    sup = tsup.Supervisor({"step": 0.2}, report_dir=str(tmp_path),
                          poll_interval=0.05)
    box = {}

    def work():
        sup.beat("step")
        try:
            with tchaos.scoped("step.stall=stall*20@1"):
                tchaos.fire("step.stall")
            box["err"] = None
        except tsup.StallError as e:
            box["err"] = e
    t = threading.Thread(target=work)
    sup.start()
    t.start()
    t.join(10)
    sup.stop()
    assert isinstance(box["err"], tsup.StallError)
    assert "'step'" in str(box["err"])
    report = json.load(open(sup.reports[0]))
    assert report["phase"] == "step" and report["timeline"]
    assert any("work" in "".join(s) for s in report["threads"].values())
    assert report["chaos_counts"] == {"step.stall": 1}
    assert report["platform"]["torch"] == torch.__version__


def test_stalled_prefetch_worker_reaches_consumer():
    sup = tsup.Supervisor({"data": 0.3}, poll_interval=0.05)
    sup.start()
    try:
        with tchaos.scoped("data.stall=stall*20@2"):
            pipe = PrefetchIterator(iter(range(5)), depth=1, supervisor=sup,
                                    pre_fire=lambda: tchaos.fire(
                                        "data.stall"))
            try:
                assert next(pipe) == 0
                with pytest.raises(tsup.StallError, match="worker channel"):
                    next(pipe)
            finally:
                pipe.close()
    finally:
        sup.stop()


# -- the retry loop -------------------------------------------------------------

class ExceptionTest(Transformer):
    """Raises when its batch count hits a scheduled one (the reference's
    test transformer)."""

    def __init__(self, failure_counts):
        self.failure_counts = set(failure_counts)
        self.count = 0

    def __call__(self, it):
        for batch in it:
            self.count += 1
            if self.count in self.failure_counts:
                raise RuntimeError(f"injected failure at batch {self.count}")
            yield batch


def _dataset(fault=None, n=64, d=6):
    rng = np.random.default_rng(0)
    samples = [Sample(rng.standard_normal(d).astype(np.float32),
                      np.int32(i % 2)) for i in range(n)]
    ds = DataSet.array(samples).transform(SampleToMiniBatch(16,
                                                            drop_last=True))
    return ds.transform(fault) if fault is not None else ds


def _linear():
    return tnn.Sequential().add(tnn.Linear(6, 2)).build(
        "cpu", torch.Generator().manual_seed(5))


def test_retry_before_first_checkpoint_restores_initial_weights(tmp_path):
    fault = ExceptionTest([2])
    model = _linear()
    start = [p.detach().clone() for p in model.parameters()]
    opt = (Optimizer(model, _dataset(fault), tnn.CrossEntropyCriterion(),
                     device="cpu")
           .set_optim_method(Adam(1e-2))
           .set_end_when(Trigger.max_epoch(1))
           .set_checkpoint(str(tmp_path), Trigger.several_iteration(1000)))
    captured = {}
    orig = opt._recover_from_checkpoint

    def spy():
        captured["updated"] = [p.detach().clone()
                               for p in model.parameters()]
        orig()
        captured["restored"] = [p.detach().clone()
                                for p in model.parameters()]
    opt._recover_from_checkpoint = spy
    opt.optimize()
    # step 1 had moved the weights in place; recovery put the start back
    assert not all(torch.equal(a, b)
                   for a, b in zip(captured["updated"], start))
    assert all(torch.equal(a, b)
               for a, b in zip(captured["restored"], start))
    assert opt._initial_blob is None   # released after the run
    assert fault.count == 6             # 2 batches, then the retry's 4


def test_retry_recovers_from_checkpoint(tmp_path):
    fault = ExceptionTest([6])
    opt = (Optimizer(_linear(), _dataset(fault), tnn.CrossEntropyCriterion(),
                     device="cpu")
           .set_optim_method(Adam(1e-2))
           .set_end_when(Trigger.max_epoch(4))
           .set_checkpoint(str(tmp_path), Trigger.several_iteration(1)))
    opt.optimize()
    assert fault.count > 6
    assert any(f.startswith("model.") for f in os.listdir(str(tmp_path)))


def test_retry_exhaustion_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("BIGDL_TORCH_RETRY_TIMES", "2")
    fault = ExceptionTest(range(1, 10_000))
    opt = (Optimizer(_linear(), _dataset(fault), tnn.CrossEntropyCriterion(),
                     device="cpu")
           .set_optim_method(Adam(1e-2))
           .set_end_when(Trigger.max_epoch(2))
           .set_checkpoint(str(tmp_path), Trigger.several_iteration(1)))
    with pytest.raises(RuntimeError, match="injected failure at batch 3"):
        opt.optimize()


def test_no_checkpoint_fails_fast():
    fault = ExceptionTest([2])
    opt = (Optimizer(_linear(), _dataset(fault), tnn.CrossEntropyCriterion(),
                     device="cpu")
           .set_end_when(Trigger.max_epoch(2)))
    with pytest.raises(RuntimeError, match="injected failure"):
        opt.optimize()
    assert fault.count == 2


def test_configuration_error_is_not_retried(tmp_path):
    opt = (Optimizer(_linear(), _dataset(), tnn.CrossEntropyCriterion(),
                     device="cpu")
           .set_checkpoint(str(tmp_path), Trigger.several_iteration(1))
           .set_gradient_accumulation(3))
    calls = []
    opt._recover_from_checkpoint = lambda: calls.append(1)
    with pytest.raises(ConfigurationError):
        opt.optimize()
    assert not calls


class _Fixed(LocalArrayDataSet):
    """Records in their given order every epoch: a run that restarts an
    epoch after recovery then sees the batches an uninterrupted run sees."""

    def shuffle(self):
        pass


def _every_two_done():
    box = {"last": None}

    def fn(state):
        done = state["neval"] - 1
        if done % 2 or done == box["last"]:
            return False
        box["last"] = done
        return True
    return Trigger(fn, "everyTwoDone")


def _resnet_run(path=None, chaos_spec=None, iters=7, resume=None,
                sigterm_at=None, supervise=None):
    """A small fused ResNet (BatchNorm) with SGD momentum, 2 batches an
    epoch: (losses by iteration, final parameters and buffers)."""
    m = tnn.Sequential()
    m.add(tresnet._conv(3, 8, 3, 3, 2, 2, 1, 1))
    m.add(tnn.SpatialBatchNormalization(8)).add(tnn.ReLU())
    b1, ch = tresnet._bottleneck(8, 4, 2, "B")
    m.add(tnn.Sequential().add(b1))
    m.add(tnn.SpatialAveragePooling(4, 4, 1, 1))
    m.add(tnn.Reshape((ch,))).add(tnn.Linear(ch, 10))
    tnn.fuse_conv_bn(m)
    m.build("cpu", torch.Generator().manual_seed(1))
    rs = np.random.RandomState(3)
    x = rs.standard_normal((16, 16, 16, 3)).astype(np.float32)
    y = rs.randint(0, 10, 16).astype(np.int32)
    ds = _Fixed([Sample.from_ndarray(x[i], y[i]) for i in range(16)])
    opt = Optimizer(m, ds, tnn.CrossEntropyCriterion(), batch_size=8,
                    device="cpu")
    opt.set_optim_method(SGD(0.1, momentum=0.9))
    if path is not None:
        opt.set_checkpoint(path, _every_two_done())
    if supervise is not None:
        opt.set_supervision(step=supervise, poll_interval=0.05)
    if resume is not None:
        opt.resume_from(*resume)
    losses = {}

    def end(state):
        if state["neval"] > 1:
            losses[state["neval"] - 1] = state["loss"]
        if sigterm_at is not None and state["neval"] == sigterm_at:
            # only with the Optimizer's handler installed: never kill
            assert signal.getsignal(signal.SIGTERM) not in (
                signal.SIG_DFL, signal.SIG_IGN, None)
            os.kill(os.getpid(), signal.SIGTERM)
        return state["neval"] > iters
    opt.set_end_when(Trigger(end, "record"))
    if chaos_spec is None:
        opt.optimize()
    else:
        with tchaos.scoped(chaos_spec):
            opt.optimize()
    return losses, [t.detach().clone() for t in
                    list(m.parameters()) + list(m.buffers())], opt


@pytest.fixture(scope="module")
def uninterrupted():
    return _resnet_run()


@pytest.mark.parametrize("spec", ["step.stall=fail@5",
                                  "step.loss_nan=nan@5"])
def test_recovered_run_bit_equal_to_uninterrupted(spec, tmp_path,
                                                  uninterrupted):
    """The failure at iteration 5 recovers from snapshot 4 and the run
    ends bit-equal to an uninterrupted one."""
    losses, final, _ = _resnet_run(str(tmp_path), spec)
    want_losses, want_final, _ = uninterrupted
    assert [losses[k] for k in range(1, 8)] == \
        [want_losses[k] for k in range(1, 8)]
    assert all(torch.equal(a, b) for a, b in zip(final, want_final))


def test_non_finite_loss_without_checkpoint_raises():
    with pytest.raises(NonFiniteLossError):
        _resnet_run(None, "step.loss_nan=nan@2")


def test_stall_recovered_by_supervisor(tmp_path, uninterrupted):
    """A step deadline with a chaos stall at iteration 5: the StallError
    is recovered from snapshot 4, a crash report is written, and the run
    ends bit-equal to an uninterrupted one.  The deadline (3 s) is far
    above a normal step of this small ResNet on a loaded host (tens of
    ms alone; a whole suite's workers beside it once pushed one past
    0.5 s, a second report), and the planted 30 s stall crosses it by
    27 s."""
    m_losses, final, _ = _resnet_run(str(tmp_path), "step.stall=stall*30@5",
                                     supervise=3.0)
    want_losses, want_final, _ = uninterrupted
    assert [m_losses[k] for k in range(1, 8)] == \
        [want_losses[k] for k in range(1, 8)]
    assert all(torch.equal(a, b) for a, b in zip(final, want_final))
    reports = [f for f in os.listdir(str(tmp_path))
               if f.startswith("crash_report") and f.endswith(".json")]
    assert len(reports) == 1
    assert json.load(open(os.path.join(str(tmp_path),
                                       reports[0])))["phase"] == "step"


def test_stager_survives_retries(tmp_path):
    fault = ExceptionTest([3, 7])
    opt = (Optimizer(_linear(), _dataset(fault), tnn.CrossEntropyCriterion(),
                     device="cpu")
           .set_optim_method(Adam(1e-2))
           .set_end_when(Trigger.max_epoch(3))
           .set_checkpoint(str(tmp_path), Trigger.several_iteration(1)))
    stagers = []
    orig = opt._open_data_pipeline

    def spy():
        out = orig()
        stagers.append(opt._stager)
        return out
    opt._open_data_pipeline = spy
    opt.optimize()
    assert fault.count > 7 and len(set(map(id, stagers))) == 1
    assert opt._stager.pinned_bytes() == 0   # the CPU stages no pinned copy


# -- preemption -----------------------------------------------------------------

@pytest.mark.skipif(threading.current_thread() is not threading.main_thread(),
                    reason="SIGTERM handlers install on the main thread only")
def test_sigterm_snapshot_and_resume(tmp_path, uninterrupted):
    """SIGTERM during iteration 4 (an epoch's end): the snapshot of
    iteration 4, ``TrainingPreempted``; resumed, the run ends bit-equal to
    an uninterrupted one."""
    before = signal.getsignal(signal.SIGTERM)
    with pytest.raises(TrainingPreempted, match="iteration 4"):
        _resnet_run(str(tmp_path), sigterm_at=4)
    assert signal.getsignal(signal.SIGTERM) == before
    latest = file_io.latest_checkpoint(str(tmp_path))
    assert latest[2] == 4
    losses, final, _ = _resnet_run(resume=latest[:2])
    want_losses, want_final, _ = uninterrupted
    assert [losses[k] for k in range(5, 8)] == \
        [want_losses[k] for k in range(5, 8)]
    assert all(torch.equal(a, b) for a, b in zip(final, want_final))


def test_preemption_flag_reduced_over_the_group(tmp_path):
    """Under the Engine's group every boundary all-reduces the SIGTERM
    flag once (one rank's signal stops every rank at the same boundary);
    without a checkpoint path no collective is made."""
    from bigdl_torch import Engine
    Engine.init(device="cpu")
    try:
        Engine.all_reduces.clear()
        opt = (Optimizer(_linear(), _dataset(), tnn.CrossEntropyCriterion())
               .set_optim_method(Adam(1e-2))
               .set_end_when(Trigger.max_iteration(3))
               .set_checkpoint(str(tmp_path), Trigger.several_iteration(100)))
        opt.optimize()
        # 3 iteration boundaries and the epoch boundary the end
        # trigger's stop passes through
        assert Engine.all_reduces["preemption"] == 4
        Engine.all_reduces.clear()
        (Optimizer(_linear(), _dataset(), tnn.CrossEntropyCriterion())
         .set_end_when(Trigger.max_iteration(2)).optimize())
        assert Engine.all_reduces["preemption"] == 0
        opt._preempted = True
        assert opt._global_preempted()
    finally:
        Engine.reset()
