"""Pipeline parallelism (``parallel/pipeline.py``) against the JAX package.

- ``partition_pipeline`` on a ``Sequential`` and a linear ``Graph``: the
  same prelude, pipeline and postlude as the reference's, and its typed
  ``PipelinePartitionError`` where the reference raises one.
- Without a ``pipe`` axis the partitioned model runs its stages in turn
  off the stacked rows: forward and 3 training steps bit-equal to the
  unpartitioned port model; ``remat=True`` gives the same gradients.
- The Engine's one named axis: a 1-D ``DeviceMesh`` without a data group
  (no ``DataParallel``, the whole batch on the rank); what needs the
  mesh layouts raises.
- The stacked tree of a model the reference's ``partition_pipeline``
  split loads into the port's partitioned model, and back, leaf-equal
  (v = 1 and v = 2, the device-major stacking order); a built port model
  partitioned gives the reference's stacked tree.
- ``pipeline_stage_bytes`` equal to the reference's replicated branch;
  the knob readers as the reference's.
- Two gloo CPU ranks (subprocesses, ``Engine.init(mesh_shape={"pipe":
  2})``): a 4-block MLP and a 4-layer ``TransformerLM`` (4 identical
  blocks, so that v = 2 over 2 ranks has its 4 stages) trained 5 steps
  under ``gpipe``, ``1f1b`` and ``1f1b`` v = 2 with 4 microbatches (the
  MLP also with ``remat=True``, each stage checkpointed).  Each
  rank's losses within 2e-3 (the roadmap's training-parity bound) of the
  reference's pipe = 2 run on two of the suite's virtual CPU devices
  (``MeshLayout(1, 1, 1, 2, 1)`` and ``LayoutSharding``), equal on both
  ranks; the run's description (stages, schedule, virtual stages,
  microbatches, bubble) and each rank's live-stash peak equal to the
  table's; the traced run carries ``pipe_bubble_fraction``; a
  microbatch count that does not divide the batch is clamped with one
  warning, as the reference clamps it.
"""

import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import bigdl_tpu.nn as jnn
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.models import transformer_lm as jlm
from bigdl_tpu.nn.graph import Graph as JGraph
from bigdl_tpu.nn.graph import Input as JInput
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Optimizer as JOptimizer
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu.parallel import LayoutSharding, MeshLayout
from bigdl_tpu.parallel import pipeline as jpipe
from bigdl_tpu.utils import memstats as jmem
from bigdl_tpu.utils.engine import Engine as JEngine

import bigdl_torch.nn as tnn
from bigdl_torch.dataset import DataSet as TDataSet
from bigdl_torch.dataset import Sample as TSample
from bigdl_torch.models import transformer_lm as tlm
from bigdl_torch.nn.graph import Graph as TGraph
from bigdl_torch.nn.graph import Input as TInput
from bigdl_torch.optim import SGD as TSGD
from bigdl_torch.optim import Optimizer as TOptimizer
from bigdl_torch.optim import Trigger as TTrigger
from bigdl_torch.parallel import pipeline as tpipe
from bigdl_torch.parallel.schedule import (build_schedule, bubble_fraction,
                                           stack_index)
from bigdl_torch.utils import memstats
from bigdl_torch.utils.convert import load_reference_tree, to_reference_tree

LOSS_TOL = 2e-3
STEPS = 5
BATCH = 16
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM = dict(vocab_size=50, max_len=16, d_model=32, num_heads=4, num_layers=4)
#: (name, model, schedule, virtual stages, microbatches, traced, remat)
RUNS = [("mlp-gpipe", "mlp", "gpipe", 1, 4, True, False),
        ("mlp-1f1b", "mlp", "1f1b", 1, 4, False, False),
        ("mlp-1f1b-v2", "mlp", "1f1b", 2, 4, False, False),
        ("lm-gpipe", "lm", "gpipe", 1, 4, False, False),
        ("lm-1f1b", "lm", "1f1b", 1, 4, False, False),
        ("lm-1f1b-v2", "lm", "1f1b", 2, 4, False, False),
        ("mlp-clamp", "mlp", "1f1b", 1, 3, False, False),
        ("mlp-gpipe-remat", "mlp", "gpipe", 1, 4, False, True),
        ("mlp-1f1b-v2-remat", "mlp", "1f1b", 2, 4, False, True)]


@pytest.fixture(autouse=True)
def _keep_reference_rng():
    """The JAX Optimizer draws a key a step from the JAX package's default
    stream; put it back for the later tests of this process."""
    from bigdl_tpu.common import get_default_rng

    state = get_default_rng().get_state()
    yield
    get_default_rng().set_state(state)


def _mlp(nn, **kw):
    """Four identical Linear + ReLU blocks and a head."""
    layers = []
    for _ in range(4):
        layers += [nn.Linear(16, 16, **kw), nn.ReLU()]
    return nn.Sequential(*layers, nn.Linear(16, 8, **kw))


def _data(kind):
    rs = np.random.RandomState(0)
    if kind == "mlp":
        return (rs.standard_normal((BATCH * STEPS, 16)).astype(np.float32),
                rs.randint(0, 8, BATCH * STEPS).astype(np.int32))
    toks = rs.randint(0, LM["vocab_size"], (BATCH * STEPS, LM["max_len"] + 1))
    toks = toks.astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _reference_model(kind):
    if kind == "mlp":
        return _mlp(jnn).build(jax.random.key(0))
    return jlm.TransformerLM(**LM).build(jax.random.key(0))


def _port_model(kind):
    return (_mlp(tnn) if kind == "mlp" else tlm.TransformerLM(**LM))


def _criterion(nn, kind):
    if kind == "mlp":
        return nn.CrossEntropyCriterion()
    return nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                       size_average=True)


def _recorder(trigger_cls, losses):
    def fn(state):
        if state["neval"] > 1:
            losses[state["neval"] - 1] = state["loss"]
        return state["neval"] > STEPS
    return trigger_cls(fn, "record")


# -- partitioning -------------------------------------------------------------

@pytest.mark.parametrize("stages", [2, 4])
def test_partition_sequential_like_reference(stages):
    j = jpipe.partition_pipeline(_mlp(jnn), stages)
    t = tpipe.partition_pipeline(_mlp(tnn), stages)
    assert [type(m).__name__ for m in t.layers] == \
        [type(m).__name__ for m in j.modules]
    assert t.layers[0].num_stages == len(j.modules[0].stages) == stages
    assert isinstance(t.layers[0], tpipe.GPipeSequential)


def test_partition_linear_graph_like_reference():
    def graph(nn, G, I):
        inp = I()
        h = nn.Linear(16, 16, with_bias=False)(inp)
        h = nn.Linear(16, 16, with_bias=False)(h)
        return G(inp, h)
    j = jpipe.partition_pipeline(graph(jnn, JGraph, JInput), 2)
    t = tpipe.partition_pipeline(graph(tnn, TGraph, TInput), 2)
    assert [type(m).__name__ for m in t.layers] == \
        [type(m).__name__ for m in j.modules] == ["GPipeSequential"]
    j.build(jax.random.key(1))
    t.build("cpu")
    params, _ = jax.tree.map(np.asarray, (j.params, j.state))
    load_reference_tree(t, params, j.state)
    x = np.random.RandomState(0).standard_normal((4, 16)).astype(np.float32)
    want = np.asarray(j.forward(x))
    got = t(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_partition_typed_errors_like_reference():
    cases = [
        lambda nn, p: p.partition_pipeline(
            nn.Sequential(nn.Linear(8, 16), nn.Linear(16, 8)), 2),
        lambda nn, p: p.GPipeSequential([nn.BatchNormalization(8),
                                         nn.BatchNormalization(8)]),
        lambda nn, p: p.partition_pipeline(
            nn.ConcatTable(nn.Linear(4, 4), nn.Linear(4, 4)), 2),
        lambda nn, p: p.GPipeSequential([nn.Linear(4, 4)] * 3,
                                        virtual_stages=2),
        lambda nn, p: p.partition_pipeline(_mlp(nn), 0),
        lambda nn, p: p.GPipeSequential([]),
    ]
    for case in cases:
        msgs = []
        for nn, p in ((jnn, jpipe), (tnn, tpipe)):
            with pytest.raises(p.PipelinePartitionError) as err:
                case(nn, p)
            msgs.append(str(err.value).split(":")[0].split("(")[0])
        assert msgs[0] == msgs[1]
    assert issubclass(tpipe.PipelinePartitionError, TypeError)


def test_branching_graph_refused():
    inp = TInput()
    a = tnn.Linear(4, 4)(inp)
    b = tnn.Linear(4, 4)(inp)
    model = TGraph(inp, tnn.CAddTable()([a, b]))
    with pytest.raises(tpipe.PipelinePartitionError, match="LINEAR"):
        tpipe.partition_pipeline(model, 2)


def test_sequential_path_remat_equal():
    """remat=True checkpoints each stage: the same forward and, without
    a pipe axis, the same gradients as without it."""
    plain = _port_model("lm").build("cpu", torch.Generator().manual_seed(4))
    x, _ = _data("lm")
    xt = torch.from_numpy(x[:4]).long()
    grads = []
    for remat in (False, True):
        piped = tpipe.partition_pipeline(plain, 2, remat=remat)
        out = piped(xt)
        out.float().pow(2).mean().backward()
        grads.append([p.grad.clone() for p in piped.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("v", [1, 2])
def test_sequential_path_bit_equal(v):
    """No pipe axis: forward and 3 SGD steps bit-equal to the
    unpartitioned model; the unpartitioned model is left as it was."""
    plain = _port_model("lm").build("cpu", torch.Generator().manual_seed(3))
    before = [p.detach().clone() for p in plain.parameters()]
    piped = tpipe.partition_pipeline(plain, 2 * v, virtual_stages=v)
    assert all(torch.equal(a, b) for a, b in zip(before, plain.parameters()))
    x, y = _data("lm")
    xt = torch.from_numpy(x[:4]).long()
    assert torch.equal(piped(xt), plain(xt))
    losses = []
    for model in (plain, piped):
        got = {}
        TOptimizer(model, TDataSet.array([TSample.from_ndarray(x[i], y[i])
                                          for i in range(BATCH * 3)]),
                   _criterion(tnn, "lm"), batch_size=BATCH, device="cpu") \
            .set_optim_method(TSGD(0.1, momentum=0.9)) \
            .set_end_when(TTrigger(lambda s: s["neval"] > 3, "three")) \
            .set_train_summary(_Loss(got)).optimize()
        losses.append(got)
    assert losses[0] == losses[1] and len(losses[0]) == 3
    # the trained stacks unstack into the trained blocks
    tp, _ = to_reference_tree(plain)
    pp, _ = to_reference_tree(piped)
    g = 4 // (2 * v)   # blocks a stage
    stacked = jax.tree.leaves(pp[2])
    for s in range(2 * v):
        blocks = tp[2 + s * g: 2 + (s + 1) * g]
        k = stack_index(s, 2, v)
        for row, leaf in zip(stacked, jax.tree.leaves(
                blocks if g > 1 else blocks[0])):
            assert np.array_equal(row[k], leaf)


class _Loss:
    """A train summary that keeps the logged losses by iteration."""

    def __init__(self, into):
        self.into = into

    def add_scalar(self, name, value, step):
        if name == "Loss":
            self.into[step] = value

    def get_summary_trigger(self, name):
        return None


@pytest.mark.parametrize("v", [1, 2])
@pytest.mark.parametrize("kind", ["mlp", "lm"])
def test_reference_stack_loads_and_back(kind, v):
    jm = _reference_model(kind)
    jp = jpipe.partition_pipeline(jm, 2 * v, virtual_stages=v)
    jparams = jax.tree.map(np.asarray, jp.params)
    jstate = jax.tree.map(np.asarray, jp.state)
    # into an unbuilt partition, built on the host
    tp = tpipe.partition_pipeline(_port_model(kind), 2 * v,
                                  virtual_stages=v).build("cpu")
    load_reference_tree(tp, jparams, jstate)
    back, state = to_reference_tree(tp)
    assert jax.tree.structure(back) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert jax.tree.structure(state) == jax.tree.structure(jstate)
    # a built port model, loaded with the reference's unpartitioned
    # weights and partitioned, stacks them as the reference does
    tm = _port_model(kind).build("cpu")
    load_reference_tree(tm, jax.tree.map(np.asarray, jm.params),
                        jax.tree.map(np.asarray, jm.state))
    tq, _ = to_reference_tree(tpipe.partition_pipeline(tm, 2 * v,
                                                       virtual_stages=v))
    for a, b in zip(jax.tree.leaves(tq), jax.tree.leaves(jparams)):
        assert np.array_equal(a, b)
    x, _ = _data(kind)
    want = np.asarray(jp.forward(x[:4]))
    got = tp(torch.from_numpy(x[:4]).long() if kind == "lm"
             else torch.from_numpy(x[:4])).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_pipeline_stage_bytes_replicated_like_reference():
    jp = jpipe.partition_pipeline(_reference_model("lm"), 2)
    tp = tpipe.partition_pipeline(_port_model("lm"), 2).build("cpu")
    want = jmem.pipeline_stage_bytes(jp, jp.params)
    assert memstats.pipeline_stage_bytes(tp, device="cpu") == want
    assert want[0]["param_bytes_per_device"] == \
        want[0]["stacked_param_bytes"]
    assert memstats.pipeline_stage_bytes(_port_model("mlp").build(
        "cpu")) is None


def test_knob_readers_like_reference(monkeypatch):
    assert (tpipe.pipe_microbatches(), tpipe.pipe_schedule(),
            tpipe.pipe_virtual_stages()) == (4, "gpipe", 1)
    for pkg, mod in (("TORCH", tpipe), ("TPU", jpipe)):
        monkeypatch.setenv(f"BIGDL_{pkg}_PIPE_MICROBATCHES", "0")
        monkeypatch.setenv(f"BIGDL_{pkg}_PIPE_SCHEDULE", " 1F1B ")
        monkeypatch.setenv(f"BIGDL_{pkg}_PIPE_VIRTUAL_STAGES", "3")
        assert (mod.pipe_microbatches(), mod.pipe_schedule(),
                mod.pipe_virtual_stages()) == (1, "1f1b", 3)
        monkeypatch.setenv(f"BIGDL_{pkg}_PIPE_SCHEDULE", "zb")
        with pytest.raises(ValueError, match="PIPE_SCHEDULE"):
            mod.pipe_schedule()
    # the stacking order is fixed at construction from the knob
    assert tpipe.GPipeSequential([tnn.Linear(4, 4) for _ in range(3)]) \
        .virtual_stages == 3


def test_stack_stage_params():
    trees = [{"w": torch.full((2, 3), float(i)), "b": [torch.ones(3) * i]}
             for i in range(3)]
    got = tpipe.stack_stage_params(trees)
    assert got["w"].shape == (3, 2, 3) and got["b"][0].shape == (3, 3)
    assert torch.equal(got["w"][2], trees[2]["w"])
    with pytest.raises(tpipe.PipelinePartitionError):
        tpipe.stack_stage_params([{"w": torch.ones(1)}, [torch.ones(1)]])


def test_pipelined_call_needs_a_pipe_axis():
    with pytest.raises(tpipe.PipelinePartitionError, match="pipe"):
        tpipe.pipeline_apply(lambda p, x: x @ p, torch.ones(2, 3, 3),
                             torch.ones(4, 3))


# -- two gloo ranks against the reference's pipe = 2 run ----------------------

_WORKER = textwrap.dedent('''
    import json, logging, os, pickle, sys
    import numpy as np
    import torch
    import bigdl_torch.nn as tnn
    from bigdl_torch.dataset import DataSet, Sample
    from bigdl_torch.models import transformer_lm as tlm
    from bigdl_torch.optim import SGD, Optimizer, Trigger
    from bigdl_torch.parallel import partition_pipeline
    from bigdl_torch.utils.convert import load_reference_tree
    from bigdl_torch.utils.engine import Engine

    spec, out = pickle.load(open(sys.argv[1], "rb")), sys.argv[2]
    torch.set_num_threads(1)   # the ranks share the host's cores
    rank = int(os.environ["BIGDL_TORCH_PROCESS_ID"])
    Engine.init(device="cpu", mesh_shape={"pipe": 2})
    warned = []

    class Keep(logging.Handler):
        def emit(self, rec):
            if "clamped" in rec.getMessage():
                warned.append(rec.getMessage())
    logging.getLogger("bigdl_torch").addHandler(Keep())
    res = {}
    for name, kind, sched, v, m, traced, remat in spec["runs"]:
        if kind == "mlp":
            layers = []
            for _ in range(4):
                layers += [tnn.Linear(16, 16), tnn.ReLU()]
            model = tnn.Sequential(*layers, tnn.Linear(16, 8))
            crit = tnn.CrossEntropyCriterion()
        else:
            model = tlm.TransformerLM(**spec["lm"])
            crit = tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion(),
                                                size_average=True)
        model.build("cpu")
        load_reference_tree(model, *spec["params"][kind])
        piped = partition_pipeline(model, 2 * v, num_microbatches=m,
                                   remat=remat, schedule=sched,
                                   virtual_stages=v)
        x, y = spec["data"][kind]
        losses = {}

        def rec(state, losses=losses):
            if state["neval"] > 1:
                losses[state["neval"] - 1] = state["loss"]
            return state["neval"] > spec["steps"]
        trace = os.path.join(out, f"trace-{name}-{rank}") if traced else ""
        if trace:
            os.environ["BIGDL_TORCH_TRACE"] = trace
        opt = Optimizer(piped, DataSet.array(
            [Sample.from_ndarray(x[i], y[i]) for i in range(len(x))]),
            crit, batch_size=spec["batch"])
        opt.set_optim_method(SGD(0.1, momentum=0.9))
        opt.set_end_when(Trigger(rec, "record")).optimize()
        os.environ.pop("BIGDL_TORCH_TRACE", None)
        blob = ""
        for root, _, files in os.walk(trace or os.devnull):
            for f in files:
                blob += open(os.path.join(root, f), errors="replace").read()
        pipe = [mod for mod in piped.layers
                if type(mod).__name__ == "GPipeSequential"][0]
        res[name] = {"losses": [losses[i] for i in sorted(losses)],
                     "description": opt.run_description,
                     "peak": pipe.last_peak_stash,
                     "traced_bubble": "pipe_bubble_fraction" in blob,
                     "warnings": len(warned)}
    json.dump({"rank": rank, "runs": res},
              open(os.path.join(out, f"rank{rank}.json"), "w"))
    # every rank done before any closes its connections
    torch.distributed.barrier()
    Engine.reset()
''')


def _reference_losses(kind, sched, v, m, remat):
    jm = _reference_model(kind)
    jp = jpipe.partition_pipeline(jm, 2 * v, num_microbatches=m,
                                  remat=remat, schedule=sched,
                                  virtual_stages=v)
    x, y = _data(kind)
    losses = {}
    JEngine.reset()
    MeshLayout(1, 1, 1, 2, 1).install(jax.devices()[:2])
    try:
        JOptimizer(jp, JDataSet.array([JSample.from_ndarray(x[i], y[i])
                                       for i in range(len(x))]),
                   _criterion(jnn, kind), batch_size=BATCH,
                   strategy=LayoutSharding(jp, min_size=0)) \
            .set_optim_method(JSGD(0.1, momentum=0.9)) \
            .set_end_when(_recorder(JTrigger, losses)).optimize()
    finally:
        JEngine.reset()
    return [losses[i] for i in range(1, STEPS + 1)]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The port's runs on two gloo ranks, started first, and the
    reference's runs on two virtual devices, computed while they run."""
    tmp = tmp_path_factory.mktemp("pipe")
    params = {k: jax.tree.map(np.asarray, (m.params, m.state))
              for k, m in (("mlp", _reference_model("mlp")),
                           ("lm", _reference_model("lm")))}
    spec = {"runs": RUNS, "lm": LM, "steps": STEPS, "batch": BATCH,
            "params": params,
            "data": {k: _data(k) for k in ("mlp", "lm")}}
    pickle.dump(spec, open(tmp / "spec.pkl", "wb"))
    (tmp / "worker.py").write_text(_WORKER)
    env = {**os.environ, "PYTHONPATH": _REPO,
           "BIGDL_TORCH_COORDINATOR": f"file://{tmp}/store",
           "BIGDL_TORCH_NUM_PROCESSES": "2"}
    procs = [subprocess.Popen(
        [sys.executable, str(tmp / "worker.py"), str(tmp / "spec.pkl"),
         str(tmp)], env={**env, "BIGDL_TORCH_PROCESS_ID": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        ref = {name: _reference_losses(kind, sched, v, m, remat)
               for name, kind, sched, v, m, _, remat in RUNS}
        errs = [p.communicate(timeout=240)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, f"rank failed:\n{err[-4000:]}"
    ranks = [json.load(open(tmp / f"rank{r}.json")) for r in range(2)]
    return ref, ranks


@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_two_rank_losses_match_reference(two_ranks, name):
    ref, ranks = two_ranks
    got = [r["runs"][name]["losses"] for r in ranks]
    assert got[0] == got[1], "the ranks' losses differ"
    assert len(got[0]) == STEPS and np.all(np.isfinite(got[0]))
    np.testing.assert_allclose(got[0], ref[name], atol=LOSS_TOL, rtol=0)
    assert got[0][-1] != got[0][0]


@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_two_rank_description_and_stash(two_ranks, name):
    _, ranks = two_ranks
    _, _, sched, v, m, _, _ = next(r for r in RUNS if r[0] == name)
    m_eff = 2 if m == 3 else m   # the clamp: the largest divisor of 16 <= m
    for r in ranks:
        run = r["runs"][name]
        d = run["description"]
        assert (d["pipe_stages"], d["pipe_schedule"],
                d["pipe_virtual_stages"], d["pipe_microbatches"]) == \
            (2, sched, v, m_eff)
        assert d["pipe_bubble_fraction"] == round(
            bubble_fraction(2, m_eff, sched, v), 4)
        tbl = build_schedule(sched, 2, m_eff, v)
        want = (tbl.peak_inflight if sched == "gpipe"
                else tbl.peak_inflight_per_device[r["rank"]])
        assert run["peak"] == want


def test_two_rank_trace_and_clamp_warning(two_ranks):
    _, ranks = two_ranks
    for r in ranks:
        assert r["runs"]["mlp-gpipe"]["traced_bubble"]
        assert not r["runs"]["mlp-1f1b"]["traced_bubble"]
        # one warning, logged by the clamped run alone
        assert r["runs"]["lm-1f1b-v2"]["warnings"] == 0
        assert r["runs"]["mlp-clamp"]["warnings"] == 1


# -- the Engine's one named axis ------------------------------------------------

@pytest.mark.parametrize("shape,match", [
    ({"data": 2, "pipe": 2}, "needs 4 processes"),
    ({"pipe": 2, "seq": 2}, "item 8"),
    ({"tp": 1}, "item 8"), ({"pipe": 1, "seq": 1}, "item 8")])
def test_engine_refuses_what_needs_the_layouts(shape, match):
    """A pipe axis beside a batch axis is a layout (in one process
    ``{"data": 2, "pipe": 2}`` wants 4 processes); a seq axis beside any
    axis but data still waits for the rest of the layouts; a mesh of the
    layouts' axes alone (``{"tp": 1}``) forms the layout's mesh."""
    from bigdl_torch.utils.engine import LAYOUT_AXES, Engine
    Engine.reset()
    if set(shape) <= set(LAYOUT_AXES) and "pipe" not in shape:
        try:
            mesh = Engine.init(device="cpu", mesh_shape=shape)
            assert mesh is Engine.mesh() and \
                mesh.mesh_dim_names == ("data", "fsdp", "tp")
            assert Engine.group_size() == 1
        finally:
            Engine.reset()
        return
    error = ValueError if "processes" in match else NotImplementedError
    with pytest.raises(error, match=match):
        Engine.init(device="cpu", mesh_shape=shape)
    assert Engine.mesh() is None


def test_engine_one_named_axis_has_no_data_group():
    """A 1-wide pipe mesh in one process: a DeviceMesh named "pipe", no
    data group, the whole batch on the rank, no DataParallel by default,
    the process the writer; the partitioned LM runs its stages in turn.
    A mesh_shape that the world does not fill raises."""
    from bigdl_torch.utils.engine import Engine
    Engine.reset()
    try:
        mesh = Engine.init(device="cpu", mesh_shape={"pipe": 1})
        assert mesh is Engine.mesh() and mesh.mesh_dim_names == ("pipe",)
        assert Engine.group() is None and Engine.device().type == "cpu"
        assert Engine.data_shard_info() == (0, 1) and Engine.is_writer()
        assert Engine.process_rank() == Engine.rank() == 0
        assert Engine.init() is mesh
        model = tpipe.partition_pipeline(_port_model("lm"), 2)
        x, y = _data("lm")
        opt = TOptimizer(model, TDataSet.array(
            [TSample.from_ndarray(x[i], y[i]) for i in range(BATCH)]),
            _criterion(tnn, "lm"), batch_size=BATCH)
        assert opt.strategy is None and opt.device.type == "cpu"
        opt.set_end_when(TTrigger.max_iteration(1)).optimize()
        # a 1-wide axis pipelines nothing: no pipe knobs described
        assert "pipe_stages" not in opt.run_description
        assert opt.step_knobs == {"fused_update": False,
                                  "wire_bucket_mb": 0.0}
    finally:
        Engine.reset()
    with pytest.raises(ValueError, match="needs 2 processes"):
        Engine.init(device="cpu", mesh_shape={"pipe": 2})
    assert Engine.mesh() is None
    assert not torch.distributed.is_initialized()


def test_facade_reads_the_stack():
    """The stateful facade's leaf lists walk a pipeline as its stage's
    tree of stacked leaves, the reference's order."""
    tp = tpipe.partition_pipeline(_port_model("mlp"), 2).build("cpu")
    ws, gs = tp.weights_and_grads()
    stack = [p for _, p in tp.layers[0].stage.named_parameters()]
    assert [w.shape[0] for w in ws[:len(stack)]] == [2] * len(stack)
    assert len(ws) == len(gs) == len(list(tp.parameters()))
    flat, _ = tp.get_parameters()
    assert flat.numel() == sum(p.numel() for p in tp.parameters())
