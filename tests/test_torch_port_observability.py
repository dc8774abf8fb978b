"""The port's observability modules against the JAX package's.

- ``utils/timing.py`` on the CPU: ``fetch_scalar``, ``measure_chain``
  (the reference's detail keys and heartbeats), ``measure_sync``,
  ``measure_step_seconds``, ``measure_roofline`` at a small ``n``.
- ``utils/flops.py``: ``fn_flops`` of a train step (forward, loss and
  backward) equal, as exact integers, to the reference's count of the
  same step: LeNet-5, a ResNet basic block with a 1x1 conv shortcut
  (unfused) and a 2-layer ``TransformerLM`` (where B6 counts 4 and B7 8
  times B·H·Tq·Tk·D).  The reference counts with
  ``BIGDL_TPU_CONV_PAD_MIN_CIN=0``, its nominal model (``bench.py``
  ``_step_flops``).  Under ``fuse_conv_bn`` the port's block counts the
  same as unfused; the reference's fused count is printed beside it: it
  counts B5's body once per call of its Pallas kernel, not once per grid
  step (a defect of the reference, not carried over).
  ``device_peak_flops`` on the CPU and its override.
- The ``train`` counter track of a traced LeNet-5 run: ``mfu`` and
  ``model_flops_per_step`` (the count of one step), ``collective_s`` 0 at
  a world of one; ``collective_s`` > 0 over 2 gloo ranks.
- ``utils/profiling.py``: ``ModuleProfiler`` times in the reference's
  module order, non-zero; ``Module.get_times`` reads them; nested
  profilers; ``trace_steps`` writes a Chrome trace.
- ``utils/memstats.py``: ``memory_record``'s keys are the reference's.
- ``utils/logger_filter.py``: ``redirect``.
- ``bigdl_torch.tools.trace_report``: its ``--json`` output equal to the
  repo tool's on the same port trace (the breakdown, ``--requests`` and
  ``--diff``), and its exit codes.

Tolerances: FLOP counts exact; the rest compares keys, orders and signs.
"""

import importlib.util
import io
import json
import logging
import os
import subprocess
import sys
import textwrap
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import bigdl_tpu.nn as jnn
from bigdl_tpu.models import LeNet5 as JLeNet5
from bigdl_tpu.models import resnet as jresnet
from bigdl_tpu.models import transformer_lm as jlm
from bigdl_tpu.utils import flops as jflops
from bigdl_tpu.utils import memstats as jmem
from bigdl_tpu.utils import profiling as jprof
from bigdl_tpu.utils import telemetry as jtel
from bigdl_tpu.utils import timing as jtiming

import bigdl_torch.nn as tnn
from bigdl_torch.dataset import DataSet, Sample
from bigdl_torch.models import LeNet5
from bigdl_torch.models import resnet as tresnet
from bigdl_torch.models import transformer_lm as tlm
from bigdl_torch.optim import SGD, Optimizer, Trigger
from bigdl_torch.tools import trace_report as ttrace_report
from bigdl_torch.utils import flops, logger_filter, memstats, profiling
from bigdl_torch.utils import telemetry as ttel
from bigdl_torch.utils import timing
from bigdl_torch.utils.convert import load_reference_tree

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_tracer():
    ttel.set_active(None)
    jtel.set_active(None)
    yield
    ttel.set_active(None)
    jtel.set_active(None)


# -- timing ------------------------------------------------------------------

def _chain_run():
    state = {"x": torch.ones((64, 64))}

    def run():
        state["x"] = torch.tanh(state["x"] @ state["x"] / 64.0)
        return state["x"]
    return run


def test_fetch_scalar():
    assert timing.fetch_scalar(torch.tensor([[3.5, 1.0]])) == 3.5
    assert timing.fetch_scalar([torch.tensor(2.0), 1]) == 2.0
    assert timing.fetch_scalar(7) == 7.0


def test_measure_chain_keys_and_heartbeats():
    beats = []
    dt, detail = timing.measure_chain(_chain_run(), n1=2, n2=6, reps=2,
                                      progress=lambda: beats.append(1))
    jbeats = []
    state = {"x": jnp.ones((8, 8))}

    def jrun():
        state["x"] = jnp.tanh(state["x"] @ state["x"] / 8.0)
        return state["x"]
    _, jdetail = jtiming.measure_chain(jrun, n1=2, n2=6, reps=2,
                                       progress=lambda: jbeats.append(1))
    assert sorted(detail) == sorted(jdetail)
    assert len(beats) == len(jbeats) == 1 + 2 * 2
    assert detail["n1"] == 2 and detail["n2"] == 6
    assert detail["t_n2"] > 0 and detail["fixed_overhead_seconds"] >= 0
    assert np.isfinite(dt)


def test_measure_sync_and_step_seconds():
    assert timing.measure_sync(_chain_run(), iters=3) > 0
    dt, detail = timing.measure_step_seconds(_chain_run(), n1=2, n2=6,
                                             reps=2)
    assert dt > 0 and detail["step_seconds_sync"] > 0
    assert dt == detail["step_seconds_sync"] or "fallback" not in detail


def test_measure_roofline_on_the_host():
    rate = timing.measure_roofline(n=128, device="cpu")
    assert rate is None or rate > 0


# -- FLOPs -------------------------------------------------------------------

def _pair(jm, tm, seed=0):
    jm.build(jax.random.key(seed))
    tm.build("cpu")
    load_reference_tree(tm, jax.tree.map(np.asarray, jm.params),
                        jax.tree.map(np.asarray, jm.state))
    return jm, tm


def _ref_step_flops(jm, jcrit, x, y, monkeypatch):
    """The reference's count of one train step (the loss's value and
    gradient with respect to the params), its nominal model."""
    monkeypatch.setenv("BIGDL_TPU_CONV_PAD_MIN_CIN", "0")

    def step(p, s, x_, y_):
        def loss(p_):
            out, _ = jm.apply(p_, s, x_, training=True,
                              rng=jax.random.key(1))
            return jcrit.loss(out, y_)
        return jax.value_and_grad(loss)(p)
    return int(jflops.fn_flops(step, jm.params, jm.state, jnp.asarray(x),
                               jnp.asarray(y)))


def _port_step_flops(tm, tcrit, x, y):
    def step():
        tcrit(tm(torch.from_numpy(x)), torch.from_numpy(y)).backward()
    return flops.fn_flops(step)


def _lenet():
    return JLeNet5(10), LeNet5(10), jnn.ClassNLLCriterion(), \
        tnn.ClassNLLCriterion()


def _block(fuse):
    """``_basic_block(256, 128, 1, "B")``: two 3x3 conv-BN pairs and a 1x1
    conv shortcut (B5 at [1024, 256] x [256, 128] where fused on
    [4, 16, 16, 256] inputs), then a head."""
    def make(mod, nn):
        b, ch = mod._basic_block(256, 128, 1, "B")
        m = (nn.Sequential().add(b).add(nn.SpatialAveragePooling(16, 16))
             .add(nn.Reshape((ch,))).add(nn.Linear(ch, 10)))
        return nn.fuse_conv_bn(m) if fuse else m
    return make(jresnet, jnn), make(tresnet, tnn), \
        jnn.CrossEntropyCriterion(), tnn.CrossEntropyCriterion()


LM = dict(vocab_size=97, max_len=16, d_model=32, num_heads=4, num_layers=2)


def _lm():
    crit = (jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion(),
                                         size_average=True),
            tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion(),
                                         size_average=True))
    return (jlm.TransformerLM(**LM), tlm.TransformerLM(**LM)) + crit


def _inputs(kind):
    rs = np.random.RandomState(0)
    if kind == "lenet":
        return (rs.standard_normal((4, 28, 28, 1)).astype(np.float32),
                np.arange(4).astype(np.int32))
    if kind == "block":
        return (rs.standard_normal((4, 16, 16, 256)).astype(np.float32),
                np.arange(4).astype(np.int32))
    toks = rs.randint(0, LM["vocab_size"], (2, LM["max_len"] + 1))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


@pytest.mark.parametrize("kind", ["lenet", "block", "lm"])
def test_step_flops_equal_reference(kind, monkeypatch):
    jm, tm, jcrit, tcrit = {"lenet": _lenet, "block": lambda: _block(False),
                            "lm": _lm}[kind]()
    jm, tm = _pair(jm, tm)
    x, y = _inputs(kind)
    ref = _ref_step_flops(jm, jcrit, x, y, monkeypatch)
    got = _port_step_flops(tm, tcrit, x, y)
    print(f"{kind}: port {got}, reference {ref}")
    assert isinstance(got, int) and got == ref > 0


def test_lm_attention_counts_four_and_eight():
    """B6's and B7's formulas: the step's count less the same step's
    products outside attention is 12·B·H·T²·D per layer."""
    _, tm, _, tcrit = _lm()
    tm.build("cpu")
    x, y = _inputs("lm")
    total = _port_step_flops(tm, tcrit, x, y)
    B, T = x.shape
    H, D = LM["num_heads"], LM["d_model"] // LM["num_heads"]
    E, V, L = LM["d_model"], LM["vocab_size"], LM["num_layers"]
    linears = L * (4 * E * E + 2 * E * 4 * E) + E * V
    assert total == 3 * 2 * B * T * linears + L * 12 * B * H * T * T * D


def test_fused_block_counts_as_unfused(monkeypatch):
    _, tm_u, _, tcrit = _block(False)
    jm_f, tm_f, jcrit, _ = _block(True)
    tm_u.build("cpu")
    jm_f, tm_f = _pair(jm_f, tm_f)
    assert any(type(m).__name__ == "ConvBN" for m in tm_f.modules())
    x, y = _inputs("block")
    unfused = _port_step_flops(tm_u, tcrit, x, y)
    fused = _port_step_flops(tm_f, tcrit, x, y)
    monkeypatch.setenv("BIGDL_TPU_BN_IMPL", "pallas_interpret")
    ref_fused = _ref_step_flops(jm_f, jcrit, x, y, monkeypatch)
    print(f"fused block: port {fused} (unfused {unfused}); the reference's "
          f"fused count {ref_fused} ({ref_fused - unfused:+d}: B5's Pallas "
          f"body counted once a call, a defect of the reference not "
          f"carried over)")
    assert fused == unfused
    assert ref_fused != unfused


def test_kernel_counts_hide_the_plain_version():
    """Inside a count, B5's plain version counts its formula, not its own
    products; outside, nothing is recorded."""
    from bigdl_torch.ops.convbn import matmul_stats
    x2, w2 = torch.ones((64, 32)), torch.ones((32, 16))
    assert flops.fn_flops(matmul_stats, x2, w2) == 2 * 64 * 32 * 16
    assert flops.fn_flops(lambda: x2 @ w2) == 2 * 64 * 32 * 16
    assert flops.fn_flops(lambda: torch.tanh(x2)) == 0
    assert not flops.COUNTING
    with flops.counting() as outer:
        with flops.counting() as inner:
            matmul_stats(x2, w2)
        x2 @ w2
    assert inner.total == 2 * 64 * 32 * 16 and outer.total == 2 * inner.total


def test_kernel_counts_only_the_counting_thread():
    """A kernel launched on another thread while a count is open (a
    serving replica beside a counted trainer step) does not land in it;
    the thread's own plain products are not counted either."""
    import threading
    from bigdl_torch.ops.convbn import matmul_stats
    x2, w2 = torch.ones((64, 32)), torch.ones((32, 16))
    with flops.counting() as c:
        t = threading.Thread(target=lambda: (matmul_stats(x2, w2),
                                             x2 @ w2))
        t.start()
        t.join()
        assert flops.COUNTING
        matmul_stats(x2[:8], w2)
    assert c.total == 2 * 8 * 32 * 16
    assert not flops.COUNTING


def test_device_peak_flops(monkeypatch):
    assert flops.device_peak_flops("cpu") == (flops.CPU_NOMINAL_PEAK,
                                              "nominal")
    assert flops.CPU_NOMINAL_PEAK == jflops.CPU_NOMINAL_PEAK
    monkeypatch.setenv("BIGDL_TORCH_PEAK_FLOPS", "5e14")
    assert flops.device_peak_flops("cpu") == (5e14, "env")


# -- the train track -----------------------------------------------------------

def _lenet_samples(n=16, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((n, 28, 28, 1)).astype(np.float32)
    y = rs.randint(0, 10, n).astype(np.float32)
    return [Sample(x[i], y[i]) for i in range(n)], x, y


def _train_counters(trace_dir):
    merged = ttel.merge_traces(trace_dir)
    return [e["args"] for e in merged["traceEvents"]
            if e.get("ph") == "C" and e.get("name") == "train"]


def test_traced_lenet_run_carries_mfu(tmp_path, monkeypatch):
    monkeypatch.setenv("BIGDL_TORCH_TRACE", str(tmp_path / "trace"))
    samples, x, y = _lenet_samples()
    model = LeNet5(10).build("cpu", torch.Generator().manual_seed(0))
    opt = Optimizer(model, DataSet.array(samples), tnn.ClassNLLCriterion(),
                    batch_size=4, device="cpu")
    opt.set_optim_method(SGD(0.01)).set_end_when(Trigger.max_iteration(3))
    opt.optimize()
    rows = _train_counters(str(tmp_path / "trace"))
    assert len(rows) == 3
    probe = LeNet5(10).build("cpu", torch.Generator().manual_seed(0))
    want = _port_step_flops(probe, tnn.ClassNLLCriterion(), x[:4],
                            y[:4].astype(np.int64))
    for r in rows:
        assert r["model_flops_per_step"] == want > 0
        assert 0 < r["mfu"] and np.isfinite(r["mfu"])
        assert r["collective_s"] == 0.0 and r["collective_fraction"] == 0.0
        assert {"data_wait_s", "step_s", "records_per_sec",
                "prefetch_queue_depth"} <= set(r)
    # the trace rounds a counter's values to 6 decimals; step_s too
    step_s = rows[0]["step_s"]
    assert rows[0]["mfu"] == pytest.approx(
        want / step_s / flops.CPU_NOMINAL_PEAK,
        rel=1e-6 / step_s, abs=5e-7)


def test_a_failing_formula_disarms_the_counter(tmp_path, monkeypatch,
                                              caplog):
    """A formula that raises leaves the step to run and the run without
    ``mfu`` (a diagnostic never fails training); ``fn_flops`` raises."""
    def broken(*args, **kwargs):
        raise ValueError("no formula")
    formulas = dict(flops._formulas())
    formulas[torch.ops.aten.mm] = broken
    monkeypatch.setattr(flops, "_FORMULAS", formulas)
    with pytest.raises(RuntimeError, match="no formula"):
        flops.fn_flops(lambda: torch.ones((4, 4)) @ torch.ones((4, 4)))
    monkeypatch.setenv("BIGDL_TORCH_TRACE", str(tmp_path / "trace"))
    samples, _, _ = _lenet_samples(8)
    model = LeNet5(10).build("cpu", torch.Generator().manual_seed(0))
    opt = Optimizer(model, DataSet.array(samples), tnn.ClassNLLCriterion(),
                    batch_size=4, device="cpu")
    opt.set_optim_method(SGD(0.01)).set_end_when(Trigger.max_iteration(2))
    with caplog.at_level(logging.INFO, logger="bigdl_torch"):
        opt.optimize()
    assert any("mfu counter disarmed" in r.getMessage()
               for r in caplog.records)
    rows = _train_counters(str(tmp_path / "trace"))
    assert len(rows) == 2 and not any("mfu" in r for r in rows)
    assert all(r["collective_s"] == 0.0 for r in rows)


def test_untraced_run_counts_nothing():
    samples, _, _ = _lenet_samples(8)
    model = LeNet5(10).build("cpu", torch.Generator().manual_seed(0))
    opt = Optimizer(model, DataSet.array(samples), tnn.ClassNLLCriterion(),
                    batch_size=4, device="cpu")
    opt.set_optim_method(SGD(0.01)).set_end_when(Trigger.max_iteration(2))
    opt.optimize()
    assert opt._step_flops is None and opt._collective_s is None


_COLLECTIVE_WORKER = textwrap.dedent('''
    import sys
    import numpy as np
    import torch
    from bigdl_torch import Engine
    import bigdl_torch.nn as nn
    from bigdl_torch.dataset import DataSet, Sample
    from bigdl_torch.models import LeNet5
    from bigdl_torch.optim import SGD, Optimizer, Trigger

    Engine.init(device="cpu")
    rs = np.random.RandomState(0)
    x = rs.standard_normal((16, 28, 28, 1)).astype(np.float32)
    y = rs.randint(0, 10, 16).astype(np.float32)
    model = LeNet5(10).build("cpu", torch.Generator().manual_seed(0))
    opt = Optimizer(model, DataSet.array(
        [Sample(x[i], y[i]) for i in range(16)], distributed=True),
        nn.ClassNLLCriterion(), batch_size=4)
    opt.set_optim_method(SGD(0.01)).set_end_when(Trigger.max_iteration(2))
    opt.optimize()
    Engine.reset()
''')


def test_collective_s_over_two_gloo_ranks(tmp_path):
    (tmp_path / "worker.py").write_text(_COLLECTIVE_WORKER)
    trace = str(tmp_path / "trace")
    env = {**os.environ, "PYTHONPATH": _REPO, "BIGDL_TORCH_TRACE": trace,
           "BIGDL_TORCH_COORDINATOR": f"file://{tmp_path / 'store'}",
           "BIGDL_TORCH_NUM_PROCESSES": "2"}
    procs = [subprocess.Popen(
        [sys.executable, str(tmp_path / "worker.py")],
        env={**env, "BIGDL_TORCH_PROCESS_ID": str(i)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    try:
        errs = [p.communicate(timeout=180)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
    rows = _train_counters(trace)
    assert len(rows) == 4   # two steps on each rank
    for r in rows:
        assert r["collective_s"] > 0
        assert 0 < r["collective_fraction"] <= 1
        assert r["model_flops_per_step"] > 0 and r["mfu"] > 0


# -- the module profiler -----------------------------------------------------

def test_module_profiler_order_and_times():
    jm, tm, _, tcrit = _lenet()
    jm, tm = _pair(jm, tm)
    x, y = _inputs("lenet")
    with profiling.ModuleProfiler(tm) as prof:
        tcrit(tm(torch.from_numpy(x)), torch.from_numpy(y)).backward()
    with jprof.ModuleProfiler(jm) as jp:
        jm.forward(jnp.asarray(x))
    times = prof.get_times()
    assert [type(m).__name__ for m, _, _ in times] == \
        [type(m).__name__ for m, _, _ in jp.get_times()]
    assert [m for m, _, _ in times] == list(tm.unique_modules())
    for m, f, b in times:
        assert f > 0, m.name
        if list(m.parameters(recurse=False)):
            assert b > 0, m.name
    root = times[0]
    assert root[2] == pytest.approx(sum(b for m, _, b in times
                                        if not len(getattr(m, "layers",
                                                           ()))))
    assert tm.get_times() == times
    assert "fwd_ms" in prof.summary(top=3)
    tm.reset_times()
    assert all(f == b == 0.0 for _, f, b in tm.get_times())


def test_nested_profilers_remove_their_hooks():
    _, tm, _, _ = _lenet()
    tm.build("cpu")
    x = torch.from_numpy(_inputs("lenet")[0])
    hooks = lambda: sum(len(m._forward_pre_hooks) + len(m._forward_hooks)
                        + len(m._backward_hooks)
                        for m in tm.modules())
    before = hooks()
    with profiling.ModuleProfiler(tm) as outer:
        with profiling.ModuleProfiler(tm, measure_backward=False) as inner:
            tm(x)
        tm(x)
    assert hooks() == before
    assert all(b == 0.0 for _, _, b in inner.get_times())
    for (m, fo, _), (_, fi, _) in zip(outer.get_times(), inner.get_times()):
        assert fo > fi > 0, m.name


def test_trace_steps_writes_a_chrome_trace(tmp_path):
    run = _chain_run()
    out = profiling.trace_steps(run, 3, str(tmp_path / "prof"))
    assert out == str(tmp_path / "prof")
    doc = json.load(open(os.path.join(out, profiling.TRACE_FILE)))
    names = {e.get("name") for e in doc["traceEvents"]}
    assert any("mm" in str(n) for n in names)


# -- memory, logger ------------------------------------------------------------

def test_memory_record_keys_are_the_reference():
    _, tm, _, _ = _lenet()
    tm.build("cpu")
    jm = JLeNet5(10).build(jax.random.key(0))
    slots = [torch.zeros_like(p) for p in tm.parameters()]
    rec = memstats.memory_record(tm, slots, device="cpu")
    jrec = jmem.memory_record(jm.params, jm.params)
    assert sorted(rec) == sorted(jrec)
    assert rec["source"] == "live_buffer_sum"
    total = sum(p.numel() * 4 for p in tm.parameters())
    assert rec["param_bytes_total"] == rec["param_bytes_per_device"] == total
    assert rec["slot_bytes_total"] == total
    assert rec["bytes_in_use"] >= total
    assert memstats.device_memory_stats("cpu") is None
    assert memstats.tree_total_bytes({"a": [torch.zeros(3)]}) == 12


def test_redirect(tmp_path, monkeypatch):
    path = str(tmp_path / "deps.log")
    got = logger_filter.redirect(["bigdl_test.noisy"], log_file=path)
    assert got == path
    lg = logging.getLogger("bigdl_test.noisy")
    assert lg.propagate is False and len(lg.handlers) == 1
    assert logger_filter.redirect(["bigdl_test.noisy"], log_file=path) == path
    assert len(lg.handlers) == 1     # one handler per path, reused
    lg.info("to the file")
    lg.handlers[0].flush()
    assert "to the file" in open(path).read()
    monkeypatch.setenv("BIGDL_TORCH_LOG_FILE", str(tmp_path / "env.log"))
    assert logger_filter.redirect(["bigdl_test.other"]) == \
        str(tmp_path / "env.log")
    monkeypatch.setenv("BIGDL_TORCH_DISABLE_LOGGER_FILTER", "1")
    assert logger_filter.redirect(["bigdl_test.third"]) is None
    assert logger_filter._NOISY == ("torch", "torch._dynamo",
                                    "torch.distributed")


# -- the trace reader ------------------------------------------------------------

class _Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def _scripted_trace(path, step_s, flows=True):
    """A port trace: training steps with the train track, a serving
    request's flow, instants."""
    clock = _Clock()
    tr = ttel.Tracer(path, rank=0, flush_every=0, clock=clock,
                     wall_clock=lambda: 1e9)
    ttel.set_active(tr)
    for i in range(4):
        ttel.complete("data", 0.001, neval=i + 1)
        clock.t += step_s
        ttel.complete("step", step_s, neval=i + 1)
        ttel.counter("train", data_wait_s=0.001, step_s=step_s,
                     records_per_sec=4 / step_s, prefetch_queue_depth=1.0,
                     mfu=0.01 / step_s, model_flops_per_step=1e10)
    if flows:
        rid = ttel.mint_request_id()
        ttel.flow_start(rid, hop="queue.enqueue", depth=1)
        clock.t += 0.003
        ttel.flow_step(rid, hop="batch.assemble", size=1, bucket=1)
        clock.t += 0.005
        ttel.flow_finish(rid, hop="resolve", status="ok")
    ttel.set_active(None)
    tr.close()


def _repo_tool():
    spec = importlib.util.spec_from_file_location(
        "repo_trace_report", os.path.join(_REPO, "tools", "trace_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("mode", ["breakdown", "requests", "diff"])
def test_trace_report_json_equals_repo_tool(tmp_path, mode):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _scripted_trace(a, 0.05)
    _scripted_trace(b, 0.04)
    argv = {"breakdown": [a, "--json"],
            "requests": [a, "--requests", "--json", "--slowest", "2"],
            "diff": [a, "--diff", b, "--json"]}[mode]
    rc, out = _run(ttrace_report.main, argv)
    jrc, jout = _run(_repo_tool().main, argv)
    assert rc == jrc == 0
    assert json.loads(out) == json.loads(jout)
    doc = json.loads(out)
    if mode == "breakdown":
        assert "step" in doc["phases"]
        assert "train.mfu" in json.dumps(doc)
    elif mode == "requests":
        assert doc["count"] == 1


def test_trace_report_text_and_exit_codes(tmp_path, capsys):
    a = str(tmp_path / "a")
    _scripted_trace(a, 0.05)
    rc, out = _run(ttrace_report.main, [a, "--out",
                                        str(tmp_path / "m.json")])
    jrc, jout = _run(_repo_tool().main, [a])
    assert rc == jrc == 0 and out == jout
    assert json.load(open(tmp_path / "m.json"))["traceEvents"]
    (tmp_path / "empty").mkdir()
    assert ttrace_report.main([str(tmp_path / "empty")]) == 2
    c = str(tmp_path / "c")
    tr = ttel.Tracer(c, rank=0, flush_every=0)
    tr.counter("train", step_s=1.0)
    tr.close()
    assert _run(ttrace_report.main, [c])[0] == 3
    nf = str(tmp_path / "nf")
    _scripted_trace(nf, 0.05, flows=False)
    assert _run(ttrace_report.main, [nf, "--requests"])[0] == 3
    assert _run(ttrace_report.main, [a, "--diff",
                                     str(tmp_path / "empty")])[0] == 2
