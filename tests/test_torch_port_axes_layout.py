"""The pipe, expert and seq axes beside the batch axes, on gloo CPU ranks,
against the JAX package's ``LayoutSharding`` on the suite's virtual CPU
devices.

Four rank processes (and two more for the two-rank layouts) run every
scenario in turn while this process computes the reference's, each on
the same numpy batches with the reference's weights copied in
(``utils/convert.py``), float32, dropout and the router's jitter off,
SGD with momentum for 5 steps:

- The pipelined MLP (4 identical blocks and a head, the reference's
  ``tests/test_pipeline_expert.py`` ``_mlp4``) under (1,1,1,2,1),
  (2,1,1,2,1) and (1,2,1,2,1), each with ``gpipe``, ``1f1b`` and ``1f1b``
  v = 2: the losses within 2e-3 (the reference's ``LOSS_TOL``) and the
  weights within 1e-5 of the reference's run on the same layout, bit-equal
  on every rank; each rank's stage stack exactly 1/2 of the whole (its
  ``pipeline_stage_bytes`` too); the run's description.  The reference's
  own ``1f1b`` beside a batch axis moves its weights 4.3e-4 away from its
  ``gpipe`` on the same layout and from its ``1f1b`` on (1,1,1,2,1),
  which agree with each other to 2e-8: there the port is held to the
  reference's ``1f1b`` run on (1,1,1,2,1), the same global batch on one
  pipe row.
- The MoE MLP (the reference's ``_moe_mlp``, 4 experts, capacity factor
  4) under (1,1,1,1,2), (2,1,1,1,2) and (1,2,1,1,2): the same gates, the
  tables exactly 1/2 a rank (1/4 under (1,2,1,1,2), whose tables the
  role table splits over fsdp too, as the reference's per device), the
  expert collectives by kind; beside a batch axis the routing is the
  global batch's, as the reference's.  The MoE LM under (2,1,1,1,2) on
  random tokens at capacity factor 1.25, where tokens overflow their
  experts, against one process given the ranks' global order; the same
  run with a planted fault (the ``expert_out`` gather's backward handing
  every rank rank 0's slice) fails the card's 2e-2 weight-change gate.
- A checkpoint written under (2,1,1,2,1) and under (2,1,1,1,2): it loads
  into one process and into the reference's reader, equal to the ranks'
  gathered weights, and resumes under (1,2,1,2,1) and (1,2,1,1,2) as one
  process resumes it; ``Predictor`` under each layout equals the dense
  forward of the trained weights.
- The seq-parallel LM on ``{"data": 2, "seq": 2}`` against the
  reference's on the same mesh (its no-grad forward against the
  reference's seq-parallel forward too).
- The ring seam (``BIGDL_TORCH_RING_ATTN=1``): the bench-shaped small LM
  under (2,1,2) against the reference's seam under (2,1,2);
  ``MultiHeadAttention`` on (1,1,2) within 2e-5 of the dense attention,
  and inert (the dense output, no hop) where T does not divide or the
  knob is off, as the reference's ``test_seam_inert_when_indivisible_
  or_ungated``.
- The re-gather in the backward: the small LM under (1,2,2) against the
  reference's run on (1,2,2), the whole bytes held at once no more than
  the largest unit's (and less than every unit's together), the
  backward's gathers one a unit that saves a weight; before its steps a
  backward abandoned on other weights, whose copies the steps must not
  use.
- ``Engine.reform`` on (2,1,1,2,1) and (2,1,1,1,2): the pipe and expert
  block kept or the reference's ``MeshReformError``; in this process,
  the typed refusals of the seq combinations that still wait, and the
  meshes of pipe beside tp or expert and of expert beside tp formed.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import bigdl_tpu.nn as jnn
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.models import transformer_lm as jlm
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Optimizer as JOptimizer
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu.parallel import LayoutSharding as JLayoutSharding
from bigdl_tpu.parallel import MeshLayout as JMeshLayout
from bigdl_tpu.parallel import MoEFFN as JMoEFFN
from bigdl_tpu.parallel import partition_pipeline as jpartition
from bigdl_tpu.utils import file_io as jfile_io
from bigdl_tpu.utils import memstats as jmem
from bigdl_tpu.utils.engine import Engine as JEngine

import bigdl_torch.nn as tnn
from bigdl_torch.dataset import DataSet as TDataSet
from bigdl_torch.dataset import Sample as TSample
from bigdl_torch.optim import SGD as TSGD
from bigdl_torch.optim import Optimizer as TOptimizer
from bigdl_torch.optim import Trigger as TTrigger
from bigdl_torch.parallel import MoEFFN as TMoEFFN
from bigdl_torch.parallel import partition_pipeline as tpartition
from bigdl_torch.utils import file_io as tfile_io
from bigdl_torch.utils.convert import load_reference_tree, to_reference_tree
from bigdl_torch.utils.engine import Engine

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 2e-3
TOL = 1e-5
SEAM_TOL = 2e-5
STEPS, BATCH, MORE = 5, 16, 2
#: (schedule, virtual stages) of each pipelined run
PIPE_RUNS = (("gpipe", 1), ("1f1b", 1), ("1f1b", 2))
PIPE_LAYOUTS = ((1, 1, 1, 2, 1), (2, 1, 1, 2, 1), (1, 2, 1, 2, 1))
EXPERT_LAYOUTS = ((1, 1, 1, 1, 2), (2, 1, 1, 1, 2), (1, 2, 1, 1, 2))
LM = dict(vocab_size=64, max_len=16, d_model=64, num_heads=4, num_layers=2)
MOE_LM = dict(LM, num_experts=4)
SEAM_LAYOUT = (2, 1, 2)
REGATHER_LAYOUT = (1, 2, 2)


@pytest.fixture(autouse=True)
def _keep_reference_rng():
    """The JAX Optimizer draws a key a step from the JAX package's default
    stream; put it back for the later tests of this process."""
    from bigdl_tpu.common import get_default_rng

    state = get_default_rng().get_state()
    yield
    get_default_rng().set_state(state)


def _mlp4(nn):
    """The reference's ``_mlp4``: four identical blocks and a head."""
    layers = []
    for _ in range(4):
        layers += [nn.Linear(64, 64, with_bias=False), nn.ReLU()]
    return nn.Sequential(*layers, nn.Linear(64, 8, with_bias=False))


def _moe(nn, moe):
    """The reference's ``_moe_mlp``, the router's jitter off."""
    m = moe(32, 64, num_experts=4, capacity_factor=4.0)
    m.router_jitter = 0.0
    return nn.Sequential(nn.Linear(64, 32, with_bias=False), nn.ReLU(), m,
                         nn.Linear(32, 8, with_bias=False))


def _data():
    rs = np.random.RandomState(3)
    n = BATCH * (STEPS + MORE)
    out = {"mlp": (rs.standard_normal((n, 64)).astype(np.float32),
                   rs.randint(0, 8, n).astype(np.int32))}
    toks = rs.randint(0, LM["vocab_size"], (n, LM["max_len"] + 1))
    out["lm"] = (toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32))
    out["attn"] = [rs.standard_normal((2, t, 32)).astype(np.float32)
                   for t in (16, 15)]
    return out


def _trees(m):
    return jax.tree.map(np.asarray, (m.params, m.state))


def _size(lay):
    return int(np.prod(lay))


def _key(lay):
    return "x".join(map(str, lay))


_WORKER = textwrap.dedent('''
    import os, pickle, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import bigdl_torch.nn as tnn
    from bigdl_torch.dataset import DataSet, Sample
    from bigdl_torch.models import transformer_lm as tlm
    from bigdl_torch.optim import SGD, Optimizer, Predictor, Trigger
    from bigdl_torch.parallel import (LayoutSharding, MeshLayout,
                                      MeshReformError, MoEFFN,
                                      partition_pipeline)
    from bigdl_torch.parallel import hops
    from bigdl_torch.utils import memstats
    from bigdl_torch.utils.convert import (load_reference_tree,
                                           to_reference_tree)
    from bigdl_torch.utils.engine import Engine, GroupReformError

    job, tmp = pickle.load(open(sys.argv[1], "rb")), sys.argv[2]
    torch.set_num_threads(1)   # the ranks share the host's cores
    rank = int(os.environ["BIGDL_TORCH_PROCESS_ID"])
    world = int(os.environ["BIGDL_TORCH_NUM_PROCESSES"])
    res, n_init = {}, [0]
    x_mlp, y_mlp = job["data"]["mlp"]
    x_lm, y_lm = job["data"]["lm"]
    N = job["batch"] * job["steps"]

    def init(shape):
        n_init[0] += 1
        os.environ["BIGDL_TORCH_COORDINATOR"] = \\
            f"file://{tmp}/store{world}-{n_init[0]}"
        Engine.init(device="cpu", mesh_shape=shape)

    def reset():
        dist.barrier()
        Engine.reset()

    def leaves(t):
        # in the reference's leaf order (dict keys sorted)
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in leaves(t[k])]
        if isinstance(t, (list, tuple)):
            return [x for v in t for x in leaves(v)]
        return [np.asarray(t)]

    def samples(x, y):
        return DataSet.array([Sample.from_ndarray(x[i], y[i])
                              for i in range(len(x))], distributed=True)

    def train(m, x, y, crit, strat, steps, ckpt=None, resume=None):
        losses = {}

        def fn(state):
            if state["neval"] > 1:
                losses[state["neval"] - 1] = state["loss"]
            return state["neval"] > steps
        opt = Optimizer(m, samples(x, y), crit,
                        batch_size=job["batch"] // Engine.group_size(),
                        strategy=strat)
        opt.set_optim_method(SGD(0.05, momentum=0.9))
        if ckpt:
            opt.set_checkpoint(ckpt, Trigger.every_epoch())
        if resume:
            opt.resume_from(resume + f".{job['steps']}",
                            resume.replace("model", "optimMethod")
                            + f".{job['steps']}")
            opt.set_end_when(Trigger.max_iteration(steps))
        else:
            opt.set_end_when(Trigger(fn, "steps"))
        opt.optimize()
        return [losses[i] for i in sorted(losses)], opt

    def lm_crit():
        return tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion(),
                                            size_average=True)

    def mlp4():
        layers = []
        for _ in range(4):
            layers += [tnn.Linear(64, 64, with_bias=False), tnn.ReLU()]
        return tnn.Sequential(*layers, tnn.Linear(64, 8, with_bias=False))

    def moe():
        m = MoEFFN(32, 64, num_experts=4, capacity_factor=4.0)
        m.router_jitter = 0.0
        return tnn.Sequential(tnn.Linear(64, 32, with_bias=False),
                              tnn.ReLU(), m,
                              tnn.Linear(32, 8, with_bias=False))

    def piped(sched, v):
        m = mlp4().build("cpu")
        load_reference_tree(m, *job["mlp4_params"])
        return partition_pipeline(m, 2 * v, num_microbatches=4,
                                  schedule=sched, virtual_stages=v)

    def moe_model():
        m = moe().build("cpu")
        load_reference_tree(m, *job["moe_params"])
        return m

    def bytes_of(tensors):
        return (memstats.tree_device_bytes(tensors, "cpu"),
                memstats.tree_total_bytes(tensors))

    def key(lay):
        return "x".join(map(str, lay))

    # the pipelined MLP under each pipe layout of this world
    for lay in job["pipe_layouts"]:
        for sched, v in job["pipe_runs"]:
            init(MeshLayout(*lay).shape())
            m = piped(sched, v)
            strat = LayoutSharding(m, min_size=0)
            first = lay[0] == 2 and sched == "gpipe"
            ckpt = os.path.join(tmp, "ckpt_pipe") if first else None
            Engine.clear_counts()
            losses, opt = train(m, x_mlp[:N], y_mlp[:N],
                                tnn.CrossEntropyCriterion(), strat,
                                job["steps"], ckpt=ckpt)
            pipe = m.layers[0]
            rec = {"losses": losses,
                   "stack": bytes_of(list(pipe.stage.parameters())),
                   "stage_bytes": memstats.pipeline_stage_bytes(
                       m, device="cpu"),
                   "description": dict(opt.run_description),
                   "collectives": Engine.collectives(),
                   "weights": leaves(to_reference_tree(m)[0])}
            if first:
                rec["predict"] = Predictor(m, batch_size=8,
                                           strategy=strat).predict(
                    x_mlp[:8])
            res["pipe", key(lay), sched, v] = rec
            reset()
    # the MoE MLP under each expert layout of this world
    for lay in job["expert_layouts"]:
        init(MeshLayout(*lay).shape())
        m = moe_model()
        strat = LayoutSharding(m, min_size=0)
        first = lay[0] == 2
        Engine.clear_counts()
        losses, opt = train(m, x_mlp[:N], y_mlp[:N],
                            tnn.CrossEntropyCriterion(), strat,
                            job["steps"],
                            ckpt=os.path.join(tmp, "ckpt_moe")
                            if first else None)
        tables = [getattr(m.layers[2], n) for n in MoEFFN.TABLES]
        rec = {"losses": losses, "tables": bytes_of(tables),
               "collectives": Engine.collectives(),
               "has_ep": "_ep" in m.layers[2].__dict__,
               "weights": leaves(to_reference_tree(m)[0])}
        if first:
            rec["predict"] = Predictor(m, batch_size=8,
                                       strategy=strat).predict(x_mlp[:8])
        res["expert", key(lay)] = rec
        reset()
    # resumes under the other batch layout
    for kind, lay, ck in job["resumes"]:
        init(MeshLayout(*lay).shape())
        m = piped("gpipe", 1) if kind == "pipe" else moe_model()
        train(m, x_mlp[N:], y_mlp[N:], tnn.CrossEntropyCriterion(),
              LayoutSharding(m, min_size=0), job["steps"] + job["more"],
              resume=os.path.join(tmp, ck, "model"))
        res["resumed", kind] = leaves(to_reference_tree(m)[0])
        reset()

    if world == 4:
        # the seq-parallel LM on data x seq
        init({"data": 2, "seq": 2})
        m = tlm.TransformerLM(**job["lm"], seq_parallel=True).build("cpu")
        load_reference_tree(m, *job["lm_params"])
        m.eval()
        with torch.no_grad():
            logp0 = m(torch.from_numpy(x_lm[:4])).numpy()
        m.train()
        hops.host_copies.clear()
        Engine.clear_counts()
        losses, _ = train(m, x_lm[:N], y_lm[:N], lm_crit(), None,
                          job["steps"])
        res["seq"] = {"losses": losses, "logp0": logp0,
                      "batch_group": Engine.group_size(),
                      "coord": Engine.mesh_coordinate(),
                      "collectives": Engine.collectives(),
                      "weights": leaves(to_reference_tree(m)[0])}
        reset()
        # the seam over tp under (2,1,2)
        os.environ["BIGDL_TORCH_RING_ATTN"] = "1"
        init(MeshLayout(*job["seam_layout"]).shape())
        m = tlm.TransformerLM(**job["lm"]).build("cpu")
        load_reference_tree(m, *job["lm_params"])
        strat = LayoutSharding(m, min_size=0)
        Engine.clear_counts()
        losses, _ = train(m, x_lm[:N], y_lm[:N], lm_crit(), strat,
                          job["steps"])
        res["seam"] = {"losses": losses,
                       "collectives": Engine.collectives(),
                       "tp_modules": len(m._layout_plan.tp_modules()),
                       "weights": leaves(to_reference_tree(m)[0])}
        os.environ.pop("BIGDL_TORCH_RING_ATTN")
        reset()
        # the LM under (1,2,2), the backward re-gathering its weights: first
        # a backward abandoned on other weights (the input gradient of the
        # blocks alone: no bucket's reduce-scatter runs), then the
        # reference's weights loaded into the shards and 5 steps
        init(MeshLayout(*job["regather_layout"]).shape())
        m = tlm.TransformerLM(**job["lm"]).build("cpu")
        strat = LayoutSharding(m, min_size=0)
        plan = strat.place(m)
        inp = []
        hook = m.layers[2].register_forward_pre_hook(
            lambda mod, a: inp.append(a[0]))
        Engine.clear_counts()
        out = m(torch.from_numpy(x_lm[:4]))
        hook.remove()
        torch.autograd.grad(out.sum(), inp[0])
        abandoned = Engine.collectives()
        del out, inp
        load_reference_tree(m, *job["lm_params"])
        plan.reset_held()
        Engine.clear_counts()
        losses, _ = train(m, x_lm[:N], y_lm[:N], lm_crit(), strat,
                          job["steps"])
        res["regather"] = {
            "losses": losses, "held_peak": plan.held_peak,
            "gathered": plan.gathered_bytes(),
            "abandoned": abandoned,
            "collectives": Engine.collectives(),
            "weights": leaves(to_reference_tree(m)[0])}
        reset()
        # the MoE LM under (2,1,1,1,2) on random tokens at capacity factor
        # 1.25: its experts overflow, and the global batch's routing
        # decides which tokens drop
        init(MeshLayout(2, 1, 1, 1, 2).shape())
        m = tlm.TransformerLM(**job["moe_lm"]).build(
            "cpu", torch.Generator().manual_seed(0))
        for x in m.modules():
            if isinstance(x, MoEFFN):
                x.router_jitter = 0.0
        losses, _ = train(m, x_lm[:N], y_lm[:N], lm_crit(),
                          LayoutSharding(m, min_size=0), job["steps"])
        res["moe_drops"] = {"losses": losses,
                            "weights": leaves(to_reference_tree(m)[0])}
        reset()
        # the same run with a planted fault: the expert_out gather's
        # backward hands every expert rank rank 0's slice of the gradient
        from bigdl_torch.parallel import mesh_plan
        gather = mesh_plan._Gather

        class Planted(gather):
            @staticmethod
            def forward(ctx, ax, x, dim, kind):
                ctx.kind = kind
                return gather.forward(ctx, ax, x, dim, kind)

            @staticmethod
            def backward(ctx, g):
                if ctx.kind != "expert_out":
                    return gather.backward(ctx, g)
                c = g.shape[ctx.dim] // ctx.ax.n
                return None, g.narrow(ctx.dim, 0, c).contiguous(), None, None
        mesh_plan._Gather = Planted
        init(MeshLayout(2, 1, 1, 1, 2).shape())
        m = tlm.TransformerLM(**job["moe_lm"]).build(
            "cpu", torch.Generator().manual_seed(0))
        for x in m.modules():
            if isinstance(x, MoEFFN):
                x.router_jitter = 0.0
        train(m, x_lm[:N], y_lm[:N], lm_crit(),
              LayoutSharding(m, min_size=0), job["steps"])
        res["moe_planted"] = {"weights": leaves(to_reference_tree(m)[0])}
        mesh_plan._Gather = gather
        reset()
        # re-forming the pipe and expert layouts
        errs = {}
        for lay, n in (((2, 1, 1, 2, 1), 2), ((2, 1, 1, 1, 2), 3)):
            init(MeshLayout(*lay).shape())
            try:
                errs[key(lay), "shape"] = Engine._reform_data_axis(n)
            except MeshReformError as err:
                errs[key(lay), "shape"] = ["MeshReformError", str(err)]
            try:
                Engine.reform(world=n, rank=0, survivors=list(range(n)))
            except (MeshReformError, GroupReformError) as err:
                errs[key(lay)] = [type(err).__name__, str(err)]
            reset()
        res["reform"] = errs
    else:
        # the seam on (1,1,2): on, indivisible, ungated
        init(MeshLayout(1, 1, 2).shape())
        mha = tnn.MultiHeadAttention(32, 4, causal=True).build("cpu")
        load_reference_tree(mha, *job["mha_params"])
        out = {}
        for name, t, on in (("ring", 0, "1"), ("indivisible", 1, "1"),
                            ("ungated", 0, "0")):
            os.environ["BIGDL_TORCH_RING_ATTN"] = on
            Engine.clear_counts()
            with torch.no_grad():
                y = mha(torch.from_numpy(job["data"]["attn"][t])).numpy()
            out[name] = (y, dict(Engine.permutes))
        os.environ.pop("BIGDL_TORCH_RING_ATTN")
        res["mha"] = out
        reset()
    pickle.dump(res, open(os.path.join(tmp, f"w{world}-rank{rank}.pkl"),
                          "wb"))
''')


def _reference_train(model, layout, data, crit, env=None, seq=False,
                     steps=STEPS):
    """The reference's 5 steps (SGD 0.05 with momentum, batch 16) on
    ``layout`` (or a ``data x seq`` mesh): (losses, weights, the model)."""
    x, y = data
    losses = {}

    def fn(state):
        if state["neval"] > 1:
            losses[state["neval"] - 1] = state["loss"]
        return state["neval"] > steps
    old = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    JEngine.reset()
    try:
        if seq:
            JEngine.init(mesh_shape={"data": 2, "seq": 2},
                         devices=jax.devices()[:4])
            strat = None
        else:
            JMeshLayout(*layout).install(jax.devices()[:_size(layout)])
            strat = JLayoutSharding(model, min_size=0)
        JOptimizer(model, JDataSet.array([JSample.from_ndarray(x[i], y[i])
                                          for i in range(BATCH * steps)]),
                   crit, batch_size=BATCH, strategy=strat) \
            .set_optim_method(JSGD(0.05, momentum=0.9)) \
            .set_end_when(JTrigger(fn, "steps")).optimize()
        per_dev = jmem.tree_device_bytes(model.params)
    finally:
        JEngine.reset()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return {"losses": [losses[i] for i in sorted(losses)],
            "weights": [np.asarray(a) for a in jax.tree.leaves(model.params)],
            "device_bytes": per_dev}


def _reference_layout(lay, sched):
    """The reference's layout the port's pipelined run is held to: its
    own, but (1,1,1,2,1) for ``1f1b`` beside a batch axis (module
    docstring)."""
    if sched == "1f1b" and lay[0] * lay[1] > 1:
        return PIPE_LAYOUTS[0]
    return lay


def _ref_mlp4(params):
    jm = _mlp4(jnn)
    jm.build(jax.random.key(0))
    jm.params = jax.tree.map(jnp.asarray, params[0])
    return jm


def _ref_pipe(params, data, lay, sched, v):
    jp = jpartition(_ref_mlp4(params), 2 * v, num_microbatches=4,
                    schedule=sched, virtual_stages=v)
    out = _reference_train(jp, lay, data, jnn.CrossEntropyCriterion())
    out["stack"] = (jmem.tree_device_bytes(jp.params[0]),
                    jmem.tree_total_bytes(jp.params[0]))
    return out


def _ref_moe(params, data, lay):
    jm = _moe(jnn, JMoEFFN)
    jm.build(jax.random.key(1))
    jm.params = jax.tree.map(jnp.asarray, params[0])
    out = _reference_train(jm, lay, data, jnn.CrossEntropyCriterion())
    tables = {k: jm.params[2][k] for k in ("w1", "w2", "b1", "b2")}
    out["tables"] = (jmem.tree_device_bytes(tables),
                     jmem.tree_total_bytes(tables))
    return out


def _ref_lm(params, seq=False):
    jm = jlm.TransformerLM(**LM, seq_parallel=seq)
    jm.build(jax.random.key(2))
    jm.params = jax.tree.map(jnp.asarray, params[0])
    return jm


def _lm_crit(nn):
    return nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                       size_average=True)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The port's scenarios on four and on two gloo ranks, started first,
    and the reference's computed while they run (the JAX package's
    default key stream, which its Optimizer draws from, put back after)."""
    from bigdl_tpu.common import get_default_rng

    rng_state = get_default_rng().get_state()
    try:
        return _run(tmp_path_factory)
    finally:
        get_default_rng().set_state(rng_state)


def _run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("axes")
    data = _data()
    jmlp, jmoe = _mlp4(jnn), _moe(jnn, JMoEFFN)
    jlm_m = jlm.TransformerLM(**LM)
    jmha = jnn.MultiHeadAttention(32, 4, causal=True)
    for i, m in enumerate((jmlp, jmoe, jlm_m, jmha)):
        m.build(jax.random.key(i))
    params = {"mlp4_params": _trees(jmlp), "moe_params": _trees(jmoe),
              "lm_params": _trees(jlm_m), "mha_params": _trees(jmha)}
    base = {"data": data, "steps": STEPS, "batch": BATCH, "more": MORE,
            "lm": LM, "pipe_runs": PIPE_RUNS, "seam_layout": SEAM_LAYOUT,
            "regather_layout": REGATHER_LAYOUT, "moe_lm": MOE_LM, **params}
    jobs = {4: {**base, "pipe_layouts": PIPE_LAYOUTS[1:],
                "expert_layouts": EXPERT_LAYOUTS[1:],
                "resumes": [("pipe", (1, 2, 1, 2, 1), "ckpt_pipe"),
                            ("moe", (1, 2, 1, 1, 2), "ckpt_moe")]},
            2: {**base, "pipe_layouts": PIPE_LAYOUTS[:1],
                "expert_layouts": EXPERT_LAYOUTS[:1], "resumes": []}}
    (tmp / "worker.py").write_text(_WORKER)
    procs = []
    for world, job in jobs.items():
        (tmp / f"job{world}.pkl").write_bytes(pickle.dumps(job))
        env = {**os.environ, "PYTHONPATH": _REPO,
               "BIGDL_TORCH_NUM_PROCESSES": str(world)}
        procs += [subprocess.Popen(
            [sys.executable, str(tmp / "worker.py"),
             str(tmp / f"job{world}.pkl"), str(tmp)],
            env={**env, "BIGDL_TORCH_PROCESS_ID": str(r)},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]
    try:
        ref = {}
        for lay in PIPE_LAYOUTS:
            for sched, v in PIPE_RUNS:
                ref["pipe", lay, sched, v] = _ref_pipe(
                    params["mlp4_params"], data["mlp"],
                    _reference_layout(lay, sched), sched, v)
        for lay in EXPERT_LAYOUTS:
            ref["expert", lay] = _ref_moe(params["moe_params"], data["mlp"],
                                          lay)
        ref["seq"] = _reference_train(_ref_lm(params["lm_params"], True),
                                      None, data["lm"], _lm_crit(jnn),
                                      seq=True)
        sp = _ref_lm(params["lm_params"], True)
        sp.evaluate()
        with Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                  ("data", "seq")):
            fwd, _ = jax.jit(lambda p, st, x: sp.apply(
                p, st, x, training=False, rng=None))(
                    sp.params, sp.state, jnp.asarray(data["lm"][0][:4]))
        ref["seq_logp0"] = np.asarray(fwd)
        ref["seam"] = _reference_train(
            _ref_lm(params["lm_params"]), SEAM_LAYOUT, data["lm"],
            _lm_crit(jnn), env={"BIGDL_TPU_RING_ATTN": "1"})
        ref["regather"] = _reference_train(
            _ref_lm(params["lm_params"]), REGATHER_LAYOUT, data["lm"],
            _lm_crit(jnn))
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, f"rank failed:\n{err[-4000:]}"
    ranks = {w: [pickle.load(open(tmp / f"w{w}-rank{r}.pkl", "rb"))
                 for r in range(w)] for w in jobs}
    return jobs, params, ref, ranks, tmp


def _close(a, b, tol=TOL):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=tol,
                                   rtol=tol)


def _bit_equal(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def _ranks_of(ranks, lay):
    return ranks[_size(lay)]


@pytest.mark.parametrize("sched,v", PIPE_RUNS,
                         ids=[f"{s}-v{v}" for s, v in PIPE_RUNS])
@pytest.mark.parametrize("lay", PIPE_LAYOUTS,
                         ids=[_key(x) for x in PIPE_LAYOUTS])
def test_pipe_layouts_match_reference(run, lay, sched, v):
    """Losses, weights, the stage stack 1/2 a rank, the description."""
    _, _, ref, ranks, _ = run
    want = ref["pipe", lay, sched, v]
    rs = _ranks_of(ranks, lay)
    for r in rs:
        got = r["pipe", _key(lay), sched, v]
        assert len(got["losses"]) == STEPS
        _close(got["losses"], want["losses"], LOSS_TOL)
        _close(got["weights"], want["weights"])
        assert _bit_equal(got["weights"],
                          rs[0]["pipe", _key(lay), sched, v]["weights"])
        dev, total = got["stack"]
        assert dev * 2 == total == want["stack"][1]
        assert want["stack"][0] * 2 == total
        (sb,) = got["stage_bytes"]
        assert sb["param_bytes_per_device"] * 2 == sb["stacked_param_bytes"]
        d = got["description"]
        assert (d["pipe_stages"], d["pipe_schedule"],
                d["pipe_virtual_stages"], d["pipe_microbatches"]) == \
            (2, sched, v, 4)
        # nothing summed over pipe: the stack's rows are each rank's own
        assert "pipe_grads" not in got["collectives"]["all_reduce"]


@pytest.mark.parametrize("lay", EXPERT_LAYOUTS,
                         ids=[_key(x) for x in EXPERT_LAYOUTS])
def test_expert_layouts_match_reference(run, lay):
    """Losses, weights, the tables 1/2 a rank, the expert collectives."""
    _, _, ref, ranks, _ = run
    want = ref["expert", lay]
    rs = _ranks_of(ranks, lay)
    for r in rs:
        got = r["expert", _key(lay)]
        assert got["has_ep"]
        assert len(got["losses"]) == STEPS
        _close(got["losses"], want["losses"], LOSS_TOL)
        _close(got["weights"], want["weights"])
        assert _bit_equal(got["weights"], rs[0]["expert", _key(lay)][
            "weights"])
        # 1/2 a rank over expert, and 1/2 of that again over fsdp
        dev, total = got["tables"]
        assert dev * 2 * lay[1] == total == want["tables"][1]
        assert want["tables"][0] == dev
        # a training step: one output gather and one input-gradient gather
        # over expert; a Predictor batch adds its forward's gathers
        c = got["collectives"]["all_gather"]
        assert c["expert_in"] == STEPS
        assert c["expert_out"] >= STEPS


@pytest.mark.parametrize("kind,lay", [("pipe", (2, 1, 1, 2, 1)),
                                      ("expert", (2, 1, 1, 1, 2))])
def test_checkpoint_loads_and_predictor(run, kind, lay):
    """The checkpoint at step 5 loads into one process and into the
    reference's reader; ``Predictor`` under the layout equals the dense
    forward of the trained weights."""
    jobs, params, _, ranks, tmp = run
    rs = ranks[4]
    rec = rs[0][(kind, _key(lay)) + (("gpipe", 1) if kind == "pipe"
                                     else ())]
    path = tmp / ("ckpt_pipe" if kind == "pipe" else "ckpt_moe") / \
        f"model.{STEPS}"
    blob = tfile_io.load(str(path))
    jblob = jfile_io.load(str(path))
    assert _bit_equal([np.asarray(a) for a in jax.tree.leaves(
        jblob["params"])], rec["weights"])
    if kind == "pipe":
        m = tpartition(_mlp4(tnn).build("cpu"), 2, num_microbatches=4)
    else:
        m = _moe(tnn, TMoEFFN).build("cpu")
    load_reference_tree(m, blob["params"], blob["state"])
    tree, _ = to_reference_tree(m)
    assert _bit_equal([np.asarray(a) for a in jax.tree.leaves(tree)],
                      rec["weights"])
    m.evaluate()
    x = jobs[4]["data"]["mlp"][0][:8]
    with torch.no_grad():
        want = m(torch.from_numpy(x)).numpy()
    for r in rs:
        got = r[(kind, _key(lay)) + (("gpipe", 1) if kind == "pipe"
                                     else ())]["predict"]
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kind", ["pipe", "moe"])
def test_checkpoint_resumes_under_another_layout(run, kind):
    """The snapshot of (2,1,1,2,1) resumed under (1,2,1,2,1), and that of
    (2,1,1,1,2) under (1,2,1,1,2), for 2 steps, as one process resumes
    it."""
    jobs, _, _, ranks, tmp = run
    x, y = jobs[4]["data"]["mlp"]
    n = BATCH * STEPS
    if kind == "pipe":
        m = tpartition(_mlp4(tnn).build("cpu"), 2, num_microbatches=4)
        ck = "ckpt_pipe"
    else:
        m = _moe(tnn, TMoEFFN).build("cpu")
        ck = "ckpt_moe"
    opt = TOptimizer(m, TDataSet.array([TSample.from_ndarray(x[i], y[i])
                                        for i in range(n, len(x))]),
                     tnn.CrossEntropyCriterion(), batch_size=BATCH,
                     device="cpu")
    opt.set_optim_method(TSGD(0.05, momentum=0.9))
    opt.resume_from(str(tmp / ck / f"model.{STEPS}"),
                    str(tmp / ck / f"optimMethod.{STEPS}"))
    opt.set_end_when(TTrigger.max_iteration(STEPS + MORE)).optimize()
    tree, _ = to_reference_tree(m)
    want = [np.asarray(a) for a in jax.tree.leaves(tree)]
    for r in ranks[4]:
        _close(r["resumed", kind], want)


def test_seq_parallel_lm_on_data_x_seq(run):
    """{"data": 2, "seq": 2}: the batch group is the data axis, each data
    row rings its own rows; the forward equals the reference's on the
    same mesh, the 5 steps its run's."""
    _, _, ref, ranks, _ = run
    rs = ranks[4]
    for r in rs:
        got = r["seq"]
        assert got["batch_group"] == 2
        np.testing.assert_allclose(got["logp0"], ref["seq_logp0"], atol=TOL,
                                   rtol=TOL)
        assert len(got["losses"]) == STEPS
        _close(got["losses"], ref["seq"]["losses"], LOSS_TOL)
        _close(got["weights"], ref["seq"]["weights"])
        assert _bit_equal(got["weights"], rs[0]["seq"]["weights"])
        # one ring a layer forward and one backward, one hop a step of each
        assert got["collectives"]["permute"]["ring"] == \
            STEPS * LM["num_layers"] * (1 + 2)
        assert got["collectives"]["all_reduce"]["grads"] == STEPS
    assert [r["seq"]["coord"] for r in rs] == [
        {"data": d, "seq": s} for d in (0, 1) for s in (0, 1)]


def test_seam_trains_like_the_reference_seam(run):
    """BIGDL_TORCH_RING_ATTN=1 under (2,1,2): the attention rings over
    tp (the kernels gathered over tp, not split: the Linears alone
    compute their tp slices), the losses and weights the reference
    seam's."""
    _, _, ref, ranks, _ = run
    rs = ranks[4]
    for r in rs:
        got = r["seam"]
        assert len(got["losses"]) == STEPS
        _close(got["losses"], ref["seam"]["losses"], LOSS_TOL)
        _close(got["weights"], ref["seam"]["weights"])
        assert _bit_equal(got["weights"], rs[0]["seam"]["weights"])
        assert got["tp_modules"] == 2 * LM["num_layers"] + 1
        assert got["collectives"]["permute"]["ring"] == \
            STEPS * LM["num_layers"] * (1 + 2)


def test_seam_parity_and_inert(run):
    """MultiHeadAttention on (1,1,2): the ring over tp within 2e-5 of the
    dense attention; with T = 15 (indivisible) or the knob off, the dense
    path, no hop."""
    jobs, params, _, ranks, _ = run
    mha = tnn.MultiHeadAttention(32, 4, causal=True).build("cpu")
    load_reference_tree(mha, *params["mha_params"])
    for r in ranks[2]:
        out = r["mha"]
        for name, t in (("ring", 0), ("indivisible", 1), ("ungated", 0)):
            with torch.no_grad():
                want = mha(torch.from_numpy(
                    jobs[2]["data"]["attn"][t])).numpy()
            y, hops = out[name]
            tol = SEAM_TOL if name == "ring" else 1e-6
            np.testing.assert_allclose(y, want, atol=tol, rtol=tol)
            assert bool(hops) == (name == "ring")


def test_regather_in_the_backward(run):
    """The LM under (1,2,2), its weights gathered again in the backward:
    the steps are the reference's; the whole bytes held at once are at
    most the largest unit's and less than every unit's together; the
    backward gathers each unit that saved a gathered weight once a
    step."""
    _, _, ref, ranks, _ = run
    rs = ranks[4]
    for r in rs:
        got = r["regather"]
        assert len(got["losses"]) == STEPS
        _close(got["losses"], ref["regather"]["losses"], LOSS_TOL)
        _close(got["weights"], ref["regather"]["weights"])
        assert _bit_equal(got["weights"], rs[0]["regather"]["weights"])
        assert got["held_peak"] <= max(got["gathered"]) < \
            sum(got["gathered"])
        c = got["collectives"]
        L = LM["num_layers"]
        assert c["all_gather"]["params"] == (L + 3) * STEPS
        # each block and the head save their kernels; the two embedding
        # tables save none (their backward reads the indices alone)
        assert c["all_gather"]["params_bwd"] == (L + 1) * STEPS


def test_abandoned_backward_leaves_no_stale_weights(run):
    """A backward that re-gathered the blocks' weights and never reached
    their reduce-scatter (the input gradient of the blocks alone), then
    other weights loaded: the next steps compute with the new weights,
    not the abandoned backward's copies, and match the reference."""
    _, _, ref, ranks, _ = run
    L = LM["num_layers"]
    for r in ranks[4]:
        got = r["regather"]
        # the abandoned backward gathered each block and the head again
        # and scattered no gradient
        assert got["abandoned"]["all_gather"]["params_bwd"] == L + 1
        assert not got["abandoned"].get("reduce_scatter", {}).get("grads")
        _close(got["weights"], ref["regather"]["weights"])


def _rank_major(records, n, batch, seed=1):
    """``records`` reordered so that one process's shuffled batches
    (``DataSet.array``'s first epoch, ``seed``) hold each global batch's
    rows in the order its ``n`` batch ranks hold them, rank 0's first:
    rank r takes rows r, r + n, ... of each batch of the same
    permutation."""
    perm = np.arange(len(records))
    np.random.default_rng(seed).shuffle(perm)
    b = batch // n
    out = list(records)
    for k in range(len(records) // batch):
        for q in range(batch):
            out[perm[k * batch + q]] = records[
                perm[k * batch + n * (q % b) + q // b]]
    return out


def _moe_lm_one_process(x, y):
    """The MoE LM of the ranks' runs trained in one process on the ranks'
    global order: (its weights as built, as trained)."""
    from bigdl_torch.models import transformer_lm as tlm
    n = BATCH * STEPS
    m = tlm.TransformerLM(**MOE_LM).build(
        "cpu", torch.Generator().manual_seed(0))
    for mod in m.modules():
        if isinstance(mod, TMoEFFN):
            mod.router_jitter = 0.0
    # copies: on the CPU the tree's leaves share the parameters' memory
    built = [np.array(a) for a in jax.tree.leaves(to_reference_tree(m)[0])]
    records = [TSample.from_ndarray(x[i], y[i]) for i in range(n)]
    opt = TOptimizer(m, TDataSet.array(_rank_major(records, 2, BATCH)),
                     _lm_crit(tnn), batch_size=BATCH, device="cpu")
    opt.set_optim_method(TSGD(0.05, momentum=0.9))
    opt.set_end_when(TTrigger.max_iteration(STEPS)).optimize()
    return built, [np.asarray(a)
                   for a in jax.tree.leaves(to_reference_tree(m)[0])]


def test_moe_capacity_drops_route_the_global_batch(run, monkeypatch):
    """The MoE LM under (2,1,1,1,2) on random tokens at capacity factor
    1.25, where tokens overflow their experts: the ranks route the
    global batch in rank order, so one process given that order (the
    port's, itself held to the reference in test_torch_port_moe.py) drops
    the same tokens and trains to the same weights."""
    from bigdl_torch.parallel import expert as texpert
    jobs, _, _, ranks, _ = run
    x, y = jobs[4]["data"]["lm"]
    kept = []
    route = texpert._route

    def spy(logits, *a, **k):
        out = route(logits, *a, **k)
        kept.append((float(out[1].sum()), logits.shape[0]))
        return out
    monkeypatch.setattr(texpert, "_route", spy)
    _, want = _moe_lm_one_process(x, y)
    # the layers' routings dropped tokens on most steps
    assert len(kept) == STEPS * MOE_LM["num_layers"]
    assert sum(d < t for d, t in kept) > len(kept) // 2
    rs = ranks[4]
    for r in rs:
        _close(r["moe_drops"]["weights"], want)
        assert _bit_equal(r["moe_drops"]["weights"],
                          rs[0]["moe_drops"]["weights"])


def test_planted_expert_out_fault_fails_the_gate(run):
    """The expert-parallel MoE gate on the card holds each part's change
    over a run within 2e-2 of one process's (|Δ - Δref| / |Δref|).  On
    the same run as the capacity test, the ranks pass it; with the
    ``expert_out`` gather's backward handing every expert rank rank 0's
    slice of the gradient, they fail it."""
    jobs, _, _, ranks, _ = run
    built, want = _moe_lm_one_process(*jobs[4]["data"]["lm"])

    def worst(got):
        # Δ - Δref = got - want, both from the same built weights; a leaf
        # that moves by less than 1e-6 (a norm's bias) is left out
        return max(float(np.linalg.norm(g - v) / np.linalg.norm(v - w))
                   for g, v, w in zip(got, want, built)
                   if np.linalg.norm(v - w) > 1e-6)
    for r in ranks[4]:
        assert worst(r["moe_drops"]["weights"]) <= 1e-3
        assert worst(r["moe_planted"]["weights"]) > 2e-2


def test_reform_keeps_the_pipe_and_expert_block(run):
    """The reference's test_shrink_keeps_pipe_expert_block and
    test_typed_error_when_block_cannot_survive on the real meshes, then
    the live group's GroupReformError."""
    _, _, _, ranks, _ = run
    for r in ranks[4]:
        e = r["reform"]
        assert e["2x1x1x2x1", "shape"] == {"data": 1, "fsdp": 1, "tp": 1,
                                           "pipe": 2, "expert": 1}
        assert e["2x1x1x2x1"][0] == "GroupReformError"
        assert e["2x1x1x1x2", "shape"][0] == "MeshReformError" and \
            "shard groups intact" in e["2x1x1x1x2", "shape"][1]
        assert e["2x1x1x1x2"][0] == "MeshReformError"


@pytest.mark.parametrize("shape,what", [
    ({"fsdp": 2, "seq": 2}, "a seq axis beside ['fsdp']"),
    ({"tp": 2, "seq": 2}, "a seq axis beside ['tp']"),
    ({"pipe": 2, "seq": 2}, "a seq axis beside ['pipe']"),
    ({"expert": 2, "seq": 2}, "a seq axis beside ['expert']")])
def test_the_waiting_combinations_raise_typed(shape, what):
    Engine.reset()
    with pytest.raises(NotImplementedError, match="item 8") as e:
        Engine.init(device="cpu", mesh_shape=shape)
    assert what in str(e.value)
    assert Engine.mesh() is None


@pytest.mark.parametrize("shape,kind,arg", [
    ({"data": 2, "pipe": 2}, "layout", (2, 1, 1, 2, 1)),
    ({"fsdp": 2, "pipe": 2}, "layout", (1, 2, 1, 2, 1)),
    ({"data": 2, "expert": 2}, "layout", (2, 1, 1, 1, 2)),
    ({"fsdp": 2, "expert": 2}, "layout", (1, 2, 1, 1, 2)),
    ({"seq": 2, "data": 2}, "named", ("data", "seq")),
    ({"pipe": 2, "data": 1}, "axis", "pipe"),
    ({"data": 2, "tp": 2, "pipe": 2}, "layout", (2, 1, 2, 2, 1)),
    ({"pipe": 2, "expert": 2}, "layout", (1, 1, 1, 2, 2)),
    ({"fsdp": 2, "tp": 2, "expert": 2}, "layout", (1, 2, 2, 1, 2))])
def test_engine_forms_the_new_meshes(shape, kind, arg):
    got, a = Engine._mesh_kind(shape)
    assert got == kind
    if kind == "layout":
        assert a.sizes == arg
    else:
        assert a == arg
