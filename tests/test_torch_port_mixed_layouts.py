"""The whole 5-axis layout on gloo CPU ranks: pipe x tp, expert x tp and
pipe x expert, ``set_remat``, the wire's buckets and ``LBFGS`` under a
mesh strategy, and ``memstats.embedding_table_bytes``, against the JAX
package's ``LayoutSharding`` on the suite's virtual CPU devices.

Four rank processes (and eight more for the layouts beside ``data``) run
every scenario in turn while this process computes the reference's, each
on the same numpy batches with the reference's weights copied in
(``utils/convert.py``), float32, the router's jitter off, SGD with
momentum for 5 steps, batch 16:

- pipe x tp, (1,1,2,2,1) and (2,1,2,2,1): the reference's ``_mlp4`` in 2
  stages under ``gpipe`` and ``1f1b`` (with the stage-level remat of
  ``partition_pipeline(remat=True)`` too: bit-equal to ``1f1b`` without
  it), and a 2-layer LM in 2 stages; the stack 1/2 a rank, the stage's
  layers computing every head (no ``_tp``), the embeddings and the head
  on tp.  A planted fault, every pipe hop handing a tp rank tp rank 0's
  activations, leaves the numbers as they are (the tp ranks of a stage
  hold the same rows) and fails the gate that reads each hop's peers: a
  rank's hops stay inside its own pipe group.  Under (2,1,2,2,1) a
  planted hop to the other data coordinate's stage moves the weights
  past the gate.
- expert x tp, (1,1,2,1,2) and (2,1,2,1,2): the reference's ``_moe_mlp``
  and a 2-layer MoE LM; the tables 1/2 a rank over expert and never split
  over tp, the expert collectives over the expert group of this rank's
  tp coordinate.  A planted fault, the expert collectives over the tp
  group in place of the expert group, moves the weights past the gate.
- pipe x expert, (1,1,1,2,2) and (2,1,1,2,2): the reference cannot
  partition a ``transformer_moe`` (its ``MoEFFN`` carries state, which a
  stage refuses: ROADMAP.md queue C), so the run held to it is the
  nearest that works: an LM whose first block is a MoE block, outside
  the pipeline with its tables over expert, and whose two dense blocks
  are the 2 stages over pipe; and ``_mlp4`` in 2 stages.  The expert
  collectives planted over the pipe group move the weights past the
  gate.
- ``set_remat("full")`` under (1,2,2): bit-equal to the run without it,
  and within the bounds of the reference's (1,2,2) run; the recompute
  gathers each block's weights again.
- ``BIGDL_TORCH_WIRE_BUCKET_MB`` with ``BIGDL_TORCH_FUSED_UPDATE=1`` under
  (2,1,1,2,1): bit-equal to the fused run without buckets, one all-reduce
  a bucket.
- ``LBFGS`` under (2,2,1): within 1e-5 of the reference's ``LBFGS`` under
  (2,2,1), and its whole state (gathered from the shards) within 1e-5 of
  one process's.
- ``embedding_table_bytes`` of the reference's ``tests/test_widedeep.py``
  model at (1,2,2) and (1,1,2,1,2): equal key by key to the reference's.
- ``Engine.reform`` on the three new layouts: the reference's
  ``MeshReformError`` before the live group's ``GroupReformError``.

Each run's losses are within 2e-3 and its weights within 1e-5 of the
reference's run on the same layout, bit-equal on every rank, and each
leaf's local shape is the reference's shard shape.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import FeatureSpec as JFeatureSpec
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.models import WideDeep as JWideDeep
from bigdl_tpu.models import transformer_lm as jlm
from bigdl_tpu.optim import LBFGS as JLBFGS
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Optimizer as JOptimizer
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu.parallel import LayoutSharding as JLayoutSharding
from bigdl_tpu.parallel import MeshLayout as JMeshLayout
from bigdl_tpu.parallel import MoEFFN as JMoEFFN
from bigdl_tpu.parallel import partition_pipeline as jpartition
from bigdl_tpu.utils import memstats as jmem
from bigdl_tpu.utils.engine import Engine as JEngine

import bigdl_torch.nn as tnn
from bigdl_torch.dataset import DataSet as TDataSet
from bigdl_torch.dataset import Sample as TSample
from bigdl_torch.optim import LBFGS as TLBFGS
from bigdl_torch.optim import Optimizer as TOptimizer
from bigdl_torch.optim import Trigger as TTrigger
from bigdl_torch.utils.convert import load_reference_tree
from bigdl_torch.utils.engine import Engine

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 2e-3
TOL = 1e-5
STEPS, BATCH = 5, 16
LM = dict(vocab_size=64, max_len=16, d_model=64, num_heads=4, num_layers=2)
MOE_LM = dict(LM, num_experts=4)
PIPE_TP, EXPERT_TP, PIPE_EXPERT = (1, 1, 2, 2, 1), (1, 1, 2, 1, 2), \
    (1, 1, 1, 2, 2)
#: (name, model, layout, pipeline schedule or None, stage-level remat)
RUNS = (
    ("mlp4-gpipe", "mlp4", PIPE_TP, "gpipe", False),
    ("mlp4-1f1b", "mlp4", PIPE_TP, "1f1b", False),
    ("mlp4-1f1b-remat", "mlp4", PIPE_TP, "1f1b", True),
    ("lm-gpipe", "lm", PIPE_TP, "gpipe", False),
    ("moe", "moe", EXPERT_TP, None, False),
    ("moe-lm", "moe_lm", EXPERT_TP, None, False),
    ("mlp4-pe", "mlp4", PIPE_EXPERT, "gpipe", False),
    ("hybrid", "hybrid", PIPE_EXPERT, "gpipe", False),
    # beside data, on eight ranks
    ("mlp4-data", "mlp4", (2,) + PIPE_TP[1:], "gpipe", False),
    ("moe-data", "moe", (2,) + EXPERT_TP[1:], None, False),
    ("hybrid-data", "hybrid", (2,) + PIPE_EXPERT[1:], "gpipe", False),
    # set_remat under (1,2,2), and the run without it
    ("lm-122", "lm", (1, 2, 2), None, False),
)
REMAT_LAYOUT = (1, 2, 2)
BUCKET_LAYOUT, BUCKET_MB = (2, 1, 1, 2, 1), "0.01"
LBFGS_LAYOUT = (2, 2, 1)
TABLE_LAYOUTS = ((1, 2, 2), (1, 1, 2, 1, 2))
REFORMS = (PIPE_TP, EXPERT_TP, PIPE_EXPERT)


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


def _hybrid(nn, lm):
    """A MoE block, then two dense blocks (the pipeline's stages), of the
    LM's width."""
    m = nn.Sequential()
    m.add(nn.LookupTable(LM["vocab_size"], LM["d_model"]))
    m.add(lm.PositionalEmbedding(LM["max_len"], LM["d_model"]))
    m.add(lm.TransformerBlock(LM["d_model"], LM["num_heads"],
                              num_experts=4))
    for _ in range(2):
        m.add(lm.TransformerBlock(LM["d_model"], LM["num_heads"]))
    m.add(nn.LayerNorm(LM["d_model"]))
    m.add(nn.Linear(LM["d_model"], LM["vocab_size"]))
    m.add(nn.LogSoftMax())
    return m


def _table_spec(FeatureSpec):
    """``tests/test_widedeep.py``'s ``_small_spec``."""
    return FeatureSpec(n_cat=4, n_dense=2, multihot_slots=2,
                       deep_buckets=512, wide_buckets=256)


def _data():
    rs = np.random.RandomState(5)
    n = BATCH * STEPS
    out = {"mlp": (rs.standard_normal((n, 64)).astype(np.float32),
                   rs.randint(0, 8, n).astype(np.int32))}
    toks = rs.randint(0, LM["vocab_size"], (n, LM["max_len"] + 1))
    out["lm"] = (toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32))
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
    from bigdl_torch.dataset import DataSet, FeatureSpec, Sample
    from bigdl_torch.models import WideDeep
    from bigdl_torch.models import transformer_lm as tlm
    from bigdl_torch.optim import LBFGS, SGD, Optimizer, Trigger
    from bigdl_torch.parallel import (GPipeSequential, LayoutSharding,
                                      MeshLayout, MeshReformError, MoEFFN,
                                      partition_pipeline)
    from bigdl_torch.parallel import hops, mesh_plan
    from bigdl_torch.utils import memstats
    from bigdl_torch.utils.convert import (_param_tree, load_reference_tree,
                                           to_reference_tree)
    from bigdl_torch.utils.engine import Engine, GroupReformError

    job, tmp = pickle.load(open(sys.argv[1], "rb")), sys.argv[2]
    torch.set_num_threads(1)   # the ranks share the host's cores
    rank = int(os.environ["BIGDL_TORCH_PROCESS_ID"])
    world = int(os.environ["BIGDL_TORCH_NUM_PROCESSES"])
    res, n_init = {}, [0]

    def init(lay):
        n_init[0] += 1
        os.environ["BIGDL_TORCH_COORDINATOR"] = \\
            f"file://{tmp}/store{world}-{n_init[0]}"
        Engine.init(device="cpu", mesh_shape=MeshLayout(*lay).shape())

    def reset():
        dist.barrier()
        Engine.reset()

    def leaves(t):
        # in the reference's leaf order (dict keys sorted)
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in leaves(t[k])]
        if isinstance(t, (list, tuple)):
            return [x for v in t for x in leaves(v)]
        return [t]

    def weights(m):
        return [np.asarray(a) for a in leaves(to_reference_tree(m)[0])]

    def local_shapes(m):
        return [tuple(p.shape) for p in leaves(_param_tree(m, getattr))]

    def jitter_off(m):
        for x in m.modules():
            if isinstance(x, MoEFFN):
                x.router_jitter = 0.0
        return m

    def hybrid():
        m = tnn.Sequential()
        m.add(tnn.LookupTable(job["lm"]["vocab_size"], job["lm"]["d_model"]))
        m.add(tlm.PositionalEmbedding(job["lm"]["max_len"],
                                      job["lm"]["d_model"]))
        m.add(tlm.TransformerBlock(job["lm"]["d_model"],
                                   job["lm"]["num_heads"], num_experts=4))
        for _ in range(2):
            m.add(tlm.TransformerBlock(job["lm"]["d_model"],
                                       job["lm"]["num_heads"]))
        m.add(tnn.LayerNorm(job["lm"]["d_model"]))
        m.add(tnn.Linear(job["lm"]["d_model"], job["lm"]["vocab_size"]))
        m.add(tnn.LogSoftMax())
        return m

    def mlp4():
        layers = []
        for _ in range(4):
            layers += [tnn.Linear(64, 64, with_bias=False), tnn.ReLU()]
        return tnn.Sequential(*layers, tnn.Linear(64, 8, with_bias=False))

    def moe():
        return tnn.Sequential(tnn.Linear(64, 32, with_bias=False),
                              tnn.ReLU(),
                              MoEFFN(32, 64, num_experts=4,
                                     capacity_factor=4.0),
                              tnn.Linear(32, 8, with_bias=False))

    BUILD = {"mlp4": mlp4, "moe": moe, "hybrid": hybrid,
             "lm": lambda: tlm.TransformerLM(**job["lm"]),
             "moe_lm": lambda: tlm.TransformerLM(**job["moe_lm"])}

    def model(kind, sched=None, remat=False):
        m = jitter_off(BUILD[kind]().build("cpu"))
        load_reference_tree(m, *job["params"][kind])
        if sched:
            m = partition_pipeline(m, 2, num_microbatches=4,
                                   schedule=sched, remat=remat)
        return m

    def lm_crit():
        return tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion(),
                                            size_average=True)

    def train(m, kind, strat, method=None, ckpt=None):
        x, y = job["data"]["mlp" if kind in ("mlp4", "moe") else "lm"]
        crit = tnn.CrossEntropyCriterion() if kind in ("mlp4", "moe") \\
            else lm_crit()
        losses = {}

        def fn(state):
            if state["neval"] > 1:
                losses[state["neval"] - 1] = state["loss"]
            return state["neval"] > job["steps"]
        opt = Optimizer(m, DataSet.array([Sample.from_ndarray(x[i], y[i])
                                          for i in range(len(x))],
                                         distributed=True), crit,
                        batch_size=job["batch"] // Engine.group_size(),
                        strategy=strat)
        opt.set_optim_method(method or SGD(0.05, momentum=0.9))
        opt.set_end_when(Trigger(fn, "steps"))
        return losses, opt

    peers = []
    hop = hops.AxisGroup.hop

    def recording(self, sends, recvs, kind="hop"):
        for _, off, _ in list(sends) + list(recvs):
            peers.append(self.global_rank(self.rank + off))
        return hop(self, sends, recvs, kind)
    hops.AxisGroup.hop = recording

    def run(name, kind, lay, sched, remat, env=None, method=None):
        init(lay)
        os.environ.update(env or {})
        m = model(kind, sched, remat)
        strat = LayoutSharding(m, min_size=0)
        plan = strat.place(m)
        del peers[:]
        Engine.clear_counts()
        losses, opt = train(m, kind, strat, method)
        if name.startswith("remat"):
            opt.set_remat("full")
        opt.optimize()
        rec = {"losses": [losses[i] for i in sorted(losses)],
               "weights": weights(m),
               "local": local_shapes(m),
               "collectives": Engine.collectives(),
               "elements": plan.local_elements(),
               "tp_modules": [type(x).__name__ for x in plan.tp_modules()],
               "ep": sum("_ep" in x.__dict__ for x in m.modules()),
               "peers": sorted(set(peers)),
               "pipe_group": sorted(
                   dist.get_process_group_ranks(Engine.mesh().get_group(
                       "pipe"))) if "pipe" in Engine.mesh().mesh_dim_names
               else [],
               "stage_bytes": memstats.pipeline_stage_bytes(m,
                                                            device="cpu"),
               "held_peak": plan.held_peak}
        if method is not None:
            whole = opt.final_opt_state
            rec["state"] = {k: [np.asarray(t) for t in v]
                            for k, v in whole.items() if isinstance(v, list)}
            # the whole rows cut again are this rank's own
            cut = strat.shard_state(whole)
            rec["state_cut_back"] = all(
                torch.equal(a, b) for k, v in opt._final_state.items()
                if isinstance(v, list) for a, b in zip(v, cut[k]))
        for k in env or {}:
            os.environ.pop(k)
        reset()
        return rec

    for name, kind, lay, sched, remat in job["runs"]:
        if _size(lay) == world:
            res[name] = run(name, kind, lay, sched, remat)
    lay_of = {r[0]: r[2] for r in job["runs"]}

    def across_data(self, sends, recvs, kind="hop"):
        # the planted fault: each pipe hop goes to the next stage of the
        # other data coordinate and comes from its previous stage
        c = Engine.mesh_coordinate()
        ranks = Engine.mesh().mesh

        def at(off):
            return int(ranks[1 - c["data"], c["fsdp"], c["tp"],
                             (c["pipe"] + off) % self.n, c["expert"]])
        ops, bufs = [], []
        for t, off, tag in sends:
            ops.append(dist.P2POp(dist.isend, t.detach().contiguous(),
                                  at(off), tag=tag))
            peers.append(at(off))
        for like, off, tag in recvs:
            buf = torch.empty_like(like)
            bufs.append(buf)
            ops.append(dist.P2POp(dist.irecv, buf, at(off), tag=tag))
            peers.append(at(off))
        for w in dist.batch_isend_irecv(ops) if ops else []:
            w.wait()
        Engine.permutes[kind] += 1
        return bufs

    def wrong_expert_group(rows):
        # the planted fault: a MoEFFN slices and gathers its experts'
        # rows over the group of the layout's other wide axis (tp or
        # pipe) in place of its expert group
        def planted(self, plan):
            out = rows(self, plan)
            ep = self.__dict__.get("_ep")
            if ep is not None:
                other = next(a for a in ("tp", "pipe")
                             if plan.sizes.get(a, 1) > 1)
                self._ep = mesh_plan.TpAxis(Engine.axis_group((other,)),
                                            ep.n, ep.rank)
            return out
        return planted

    if world == 8:
        hops.AxisGroup.hop = across_data
        res["planted-data"] = run("planted-data", "mlp4",
                                  lay_of["mlp4-data"], "gpipe", False)
        hops.AxisGroup.hop = recording

    if world == 4:
        lay = job["remat_layout"]
        res["remat"] = run("remat", "lm", lay, None, False)
        env = {"BIGDL_TORCH_FUSED_UPDATE": "1"}
        lay = job["bucket_layout"]
        res["fused"] = run("fused", "mlp4", lay, "gpipe", False, env)
        res["buckets"] = run("buckets", "mlp4", lay, "gpipe", False, {
            **env, "BIGDL_TORCH_WIRE_BUCKET_MB": job["bucket_mb"]})
        res["lbfgs"] = run("lbfgs", "mlp4", job["lbfgs_layout"], None,
                           False, method=LBFGS(0.1))
        # the planted fault: each pipe hop hands a tp rank tp rank 0's
        # activations (tp rank 0 sends to every tp rank of the next stage,
        # the others send nothing)
        def planted(self, sends, recvs, kind="hop"):
            c = Engine.mesh_coordinate()
            ranks = Engine.mesh().mesh

            def at(off, t):
                return int(ranks[c["data"], c["fsdp"], t,
                                 (c["pipe"] + off) % self.n, c["expert"]])
            ops, bufs = [], []
            for t, off, tag in sends:
                if c["tp"] == 0:
                    for q in range(ranks.shape[2]):
                        ops.append(dist.P2POp(dist.isend,
                                              t.detach().contiguous(),
                                              at(off, q), tag=tag))
                        peers.append(at(off, q))
            for like, off, tag in recvs:
                buf = torch.empty_like(like)
                bufs.append(buf)
                ops.append(dist.P2POp(dist.irecv, buf, at(off, 0),
                                      tag=tag))
                peers.append(at(off, 0))
            for w in dist.batch_isend_irecv(ops) if ops else []:
                w.wait()
            Engine.permutes[kind] += 1
            return bufs
        hops.AxisGroup.hop = planted
        res["planted"] = run("planted", "mlp4", job["runs"][0][2], "gpipe",
                             False)
        hops.AxisGroup.hop = recording
        rows = MoEFFN.mesh_rows
        MoEFFN.mesh_rows = wrong_expert_group(rows)
        res["planted-moe"] = run("planted-moe", "moe", lay_of["moe"], None,
                                 False)
        res["planted-hybrid"] = run("planted-hybrid", "hybrid",
                                    lay_of["hybrid"], "gpipe", False)
        MoEFFN.mesh_rows = rows
        # embedding_table_bytes of the widedeep model
        spec = FeatureSpec(n_cat=4, n_dense=2, multihot_slots=2,
                           deep_buckets=512, wide_buckets=256)
        for lay in job["table_layouts"]:
            init(lay)
            m = WideDeep.from_spec(spec, embed_dim=8, hidden=(16,)) \\
                .build("cpu")
            LayoutSharding(m, min_size=0).place(m)
            res["tables", key(lay)] = memstats.embedding_table_bytes(
                m, device="cpu")
            reset()
        # re-forming the new layouts
        for lay in job["reforms"]:
            init(lay)
            errs = []
            try:
                errs.append(Engine._reform_data_axis(2))
            except MeshReformError as err:
                errs.append(["MeshReformError", str(err)])
            try:
                Engine.reform(world=2, rank=0, survivors=[0, 1])
            except (MeshReformError, GroupReformError) as err:
                errs.append([type(err).__name__, str(err)])
            res["reform", key(lay)] = errs
            reset()
    pickle.dump(res, open(os.path.join(tmp, f"w{world}-rank{rank}.pkl"),
                          "wb"))
''').replace("_size(lay)", "int(np.prod(lay))").replace(
    "key(lay)", '"x".join(map(str, lay))')


def _reference_train(model, layout, data, crit, method=None):
    """The reference's 5 steps (SGD 0.05 with momentum, batch 16) on
    ``layout``: losses, weights, each leaf's shard shape, the model."""
    x, y = data
    losses = {}

    def fn(state):
        if state["neval"] > 1:
            losses[state["neval"] - 1] = state["loss"]
        return state["neval"] > STEPS
    JEngine.reset()
    try:
        JMeshLayout(*layout).install(jax.devices()[:_size(layout)])
        JOptimizer(model, JDataSet.array([JSample.from_ndarray(x[i], y[i])
                                          for i in range(BATCH * STEPS)]),
                   crit, batch_size=BATCH,
                   strategy=JLayoutSharding(model, min_size=0)) \
            .set_optim_method(method or JSGD(0.05, momentum=0.9)) \
            .set_end_when(JTrigger(fn, "steps")).optimize()
        leaves = jax.tree.leaves(model.params)
        local = [tuple(a.addressable_shards[0].data.shape) for a in leaves]
    finally:
        JEngine.reset()
    return {"losses": [losses[i] for i in sorted(losses)],
            "weights": [np.asarray(a) for a in leaves], "local": local}


def _lm_crit(nn):
    return nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                       size_average=True)


#: the reference's models of each kind
_BUILD = {"mlp4": lambda: _mlp4(jnn), "moe": lambda: _moe(jnn, JMoEFFN),
          "hybrid": lambda: _hybrid(jnn, jlm),
          "lm": lambda: jlm.TransformerLM(**LM),
          "moe_lm": lambda: jlm.TransformerLM(**MOE_LM)}


def _ref_model(kind, params, sched=None, remat=False):
    m = _BUILD[kind]()
    m.build(jax.random.key(0))
    m.params = jax.tree.map(jnp.asarray, params[kind][0])
    _jitter_off(m)
    if sched:
        m = jpartition(m, 2, num_microbatches=4, schedule=sched, remat=remat)
    return m


def _jitter_off(m):
    if isinstance(m, JMoEFFN):
        m.router_jitter = 0.0
    for c in getattr(m, "modules", None) or []:
        _jitter_off(c)


def _ref_run(kind, params, data, lay, sched=None, remat=False, method=None):
    m = _ref_model(kind, params, sched, remat)
    lm = kind not in ("mlp4", "moe")
    return _reference_train(m, lay, data["lm" if lm else "mlp"],
                            _lm_crit(jnn) if lm else
                            jnn.CrossEntropyCriterion(), method)


def _ref_tables(lay):
    spec = _table_spec(JFeatureSpec)
    JEngine.reset()
    try:
        m = JWideDeep.from_spec(spec, embed_dim=8, hidden=(16,)).build(
            jax.random.key(0))
        mesh = JMeshLayout(*lay).install(jax.devices()[:_size(lay)])
        placed = jax.device_put(m.params, JLayoutSharding(
            m, min_size=0).param_sharding(mesh, m.params))
        return jmem.embedding_table_bytes(m, placed)
    finally:
        JEngine.reset()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The port's scenarios on four and on eight gloo ranks, started
    first, and the reference's computed while they run."""
    from bigdl_tpu.common import get_default_rng

    rng_state = get_default_rng().get_state()
    try:
        return _run(tmp_path_factory)
    finally:
        get_default_rng().set_state(rng_state)


def _run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mixed")
    data = _data()
    params = {}
    for i, kind in enumerate(_BUILD):
        m = _BUILD[kind]()
        m.build(jax.random.key(i))
        params[kind] = _trees(m)
    job = {"data": data, "steps": STEPS, "batch": BATCH, "lm": LM,
           "moe_lm": MOE_LM, "params": params, "runs": RUNS,
           "remat_layout": REMAT_LAYOUT, "bucket_layout": BUCKET_LAYOUT,
           "bucket_mb": BUCKET_MB, "lbfgs_layout": LBFGS_LAYOUT,
           "table_layouts": TABLE_LAYOUTS, "reforms": REFORMS}
    (tmp / "worker.py").write_text(_WORKER)
    (tmp / "job.pkl").write_bytes(pickle.dumps(job))
    procs = []
    for world in (4, 8):
        env = {**os.environ, "PYTHONPATH": _REPO,
               "BIGDL_TORCH_NUM_PROCESSES": str(world)}
        procs += [subprocess.Popen(
            [sys.executable, str(tmp / "worker.py"), str(tmp / "job.pkl"),
             str(tmp)], env={**env, "BIGDL_TORCH_PROCESS_ID": str(r)},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]
    try:
        ref = {}
        for name, kind, lay, sched, remat in RUNS:
            ref[name] = _ref_run(kind, params, data, lay, sched, remat)
        ref["lbfgs"] = _ref_run("mlp4", params, data, LBFGS_LAYOUT,
                                method=JLBFGS(0.1))
        for lay in TABLE_LAYOUTS:
            ref["tables", _key(lay)] = _ref_tables(lay)
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, f"rank failed:\n{err[-4000:]}"
    ranks = {w: [pickle.load(open(tmp / f"w{w}-rank{r}.pkl", "rb"))
                 for r in range(w)] for w in (4, 8)}
    return job, ref, ranks


def _close(a, b, tol=TOL):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=tol,
                                   rtol=tol)


def _bit_equal(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


def _held_to_reference(got, want):
    assert len(got["losses"]) == STEPS
    _close(got["losses"], want["losses"], LOSS_TOL)
    _close(got["weights"], want["weights"])
    assert got["local"] == want["local"]


@pytest.mark.parametrize("name,kind,lay,sched,remat", RUNS[:-1],
                         ids=[r[0] for r in RUNS[:-1]])
def test_new_layouts_match_reference(run, name, kind, lay, sched, remat):
    """Losses, weights and each leaf's shard the reference's; the ranks
    bit-equal; the stack 1/2 a rank; a stage's layers compute every head
    while the head and the attention outside a stage compute on tp; the
    expert tables computed on their rows."""
    _, ref, ranks = run
    rs = ranks[_size(lay)]
    for r in rs:
        got = r[name]
        _held_to_reference(got, ref[name])
        assert _bit_equal(got["weights"], rs[0][name]["weights"])
        assert got["elements"] == sum(int(np.prod(s)) for s in got["local"])
        if sched:
            (sb,) = got["stage_bytes"]
            assert sb["param_bytes_per_device"] * 2 == \
                sb["stacked_param_bytes"]
            # nothing summed over pipe, and each hop inside the pipe group
            assert "pipe_grads" not in got["collectives"]["all_reduce"]
            assert set(got["peers"]) <= set(got["pipe_group"])
            assert got["peers"]
        tp = lay[2] > 1
        if kind == "mlp4" and sched:
            # every Linear is in a stage but the head
            assert got["tp_modules"] == (["Linear"] if tp else [])
        if kind == "lm" and sched:
            # the head alone: the stages' attention and MLP hold pipe rows
            assert got["tp_modules"] == ["Linear"]
        if kind in ("moe", "moe_lm", "hybrid"):
            n_moe = MOE_LM["num_layers"] if kind == "moe_lm" else 1
            assert got["ep"] == n_moe
            c = got["collectives"]["all_gather"]
            assert c["expert_in"] == STEPS * n_moe
            assert c["expert_out"] == STEPS * n_moe
        if kind == "moe_lm":
            # every attention and the head compute on tp
            assert got["tp_modules"].count("MultiHeadAttention") == \
                LM["num_layers"]


def test_remat_under_a_layout_is_bit_equal(run):
    """``set_remat("full")`` under (1,2,2): the weights bit-equal to the
    run without it (itself held to the reference's (1,2,2) run); the
    recompute gathers each block's and the head's weights again in the
    forward's order, and the plan's own re-gather stands aside."""
    _, ref, ranks = run
    L = LM["num_layers"]
    for r in ranks[4]:
        plain, remat = r["lm-122"], r["remat"]
        _held_to_reference(plain, ref["lm-122"])
        assert _bit_equal(remat["weights"], plain["weights"])
        assert remat["losses"] == plain["losses"]
        cp, cr = plain["collectives"], remat["collectives"]
        assert cp["all_gather"]["params_bwd"] == (L + 1) * STEPS
        assert "params_bwd" not in cr["all_gather"]
        # a unit whose backward reads a saved tensor is recomputed, its
        # gather run again: the blocks, the head and the token table (the
        # positional table's add saves nothing)
        assert cr["all_gather"]["params"] == \
            cp["all_gather"]["params"] + (L + 2) * STEPS
        assert cr["reduce_scatter"] == cp["reduce_scatter"]


def test_stage_remat_composes_with_1f1b(run):
    """The reference's ``test_remat_composes_with_1f1b`` on pipe x tp:
    ``partition_pipeline(remat=True)`` under ``1f1b`` bit-equal to
    ``1f1b`` without it, and within 2e-3 of the reference's run."""
    _, ref, ranks = run
    for r in ranks[4]:
        assert _bit_equal(r["mlp4-1f1b-remat"]["weights"],
                          r["mlp4-1f1b"]["weights"])
        _close(r["mlp4-1f1b-remat"]["losses"], ref["mlp4-1f1b-remat"][
            "losses"], LOSS_TOL)


def test_buckets_with_the_fused_update_are_bit_equal(run):
    """``BIGDL_TORCH_WIRE_BUCKET_MB`` beside ``BIGDL_TORCH_FUSED_UPDATE=1``
    under (2,1,1,2,1), as the reference's
    ``test_pipe_composes_with_fused_wire_knobs``: the weights bit-equal to
    the fused run without buckets, the data axis's one all-reduce a step
    cut into one a bucket."""
    _, _, ranks = run
    for r in ranks[4]:
        f, b = r["fused"], r["buckets"]
        assert _bit_equal(b["weights"], f["weights"])
        assert b["losses"] == f["losses"]
        nf = f["collectives"]["all_reduce"]["grads"]
        nb = b["collectives"]["all_reduce"]["grads"]
        assert nf == STEPS and nb > nf and nb % STEPS == 0


def test_lbfgs_under_a_layout(run):
    """``LBFGS`` under (2,2,1): losses and weights within 1e-5 of the
    reference's ``LBFGS`` under (2,2,1), the dot products summed over the
    shards; its whole state gathered from the shards equals one
    process's, and cut again gives back each rank's rows."""
    job, ref, ranks = run
    x, y = job["data"]["mlp"]
    m = _mlp4(tnn).build("cpu")
    load_reference_tree(m, *job["params"]["mlp4"])
    opt = TOptimizer(m, TDataSet.array([TSample.from_ndarray(x[i], y[i])
                                        for i in range(len(x))]),
                     tnn.CrossEntropyCriterion(), batch_size=BATCH,
                     device="cpu")
    opt.set_optim_method(TLBFGS(0.1))
    opt.set_end_when(TTrigger.max_iteration(STEPS)).optimize()
    one = {k: [t.numpy() for t in v] for k, v in
           opt.final_opt_state.items() if isinstance(v, list)}
    for r in ranks[4]:
        got = r["lbfgs"]
        assert len(got["losses"]) == STEPS
        _close(got["losses"], ref["lbfgs"]["losses"])
        _close(got["weights"], ref["lbfgs"]["weights"])
        assert got["local"] == ref["lbfgs"]["local"]
        assert got["collectives"]["all_reduce"]["dot"] > 0
        assert got["state_cut_back"]
        assert sorted(got["state"]) == sorted(one)
        for k in one:
            _close(got["state"][k], one[k])


def test_planted_pipe_hop_fault_fails_the_gate(run):
    """Every pipe hop under (1,1,2,2,1) handing each tp rank tp rank 0's
    activations: the tp ranks of a stage hold the same rows, so the
    numbers do not move, and the gate on each hop's peers (inside the
    rank's own pipe group) fails on every rank: tp rank 0 sends across
    the tp axis, the others receive across it."""
    _, ref, ranks = run
    crossed = 0
    for r in ranks[4]:
        got = r["planted"]
        _close(got["weights"], ref["mlp4-gpipe"]["weights"])
        crossed += not set(got["peers"]) <= set(got["pipe_group"])
        assert set(r["mlp4-gpipe"]["peers"]) <= set(r["mlp4-gpipe"][
            "pipe_group"])
    assert crossed == 4


#: (ranks, planted run, the clean run it stands in for)
PLANTED = ((8, "planted-data", "mlp4-data"), (4, "planted-moe", "moe"),
           (4, "planted-hybrid", "hybrid"))


@pytest.mark.parametrize("world,name,clean", PLANTED,
                         ids=[p[1] for p in PLANTED])
def test_planted_faults_move_the_weights_past_the_gate(run, world, name,
                                                       clean):
    """Faults that change the rows a rank computes on fail the 1e-5
    weight gate that the clean run meets: under (2,1,2,2,1) each pipe hop
    to the other data coordinate's stage (pipe x tp beside data); under
    (1,1,2,1,2) and (1,1,1,2,2) the expert collectives over the tp or
    pipe group in place of the expert group."""
    _, ref, ranks = run
    for r in ranks[world]:
        _close(r[clean]["weights"], ref[clean]["weights"])
        with pytest.raises(AssertionError):
            _close(r[name]["weights"], ref[clean]["weights"])
        err = max(float(np.max(np.abs(a - b))) for a, b in zip(
            r[name]["weights"], ref[clean]["weights"]))
        assert err > 10 * TOL, err
        assert len(r[name]["losses"]) == STEPS
    if name == "planted-data":
        # the hops left the rank's pipe group
        assert all(not set(r[name]["peers"]) <= set(r[name]["pipe_group"])
                   for r in ranks[world])


@pytest.mark.parametrize("lay", TABLE_LAYOUTS,
                         ids=[_key(x) for x in TABLE_LAYOUTS])
def test_embedding_table_bytes(run, lay):
    """The reference's ``embedding_table_bytes`` key by key on
    ``tests/test_widedeep.py``'s model: both tables 1/4 a rank."""
    _, ref, ranks = run
    want = ref["tables", _key(lay)]
    assert len(want) == 2
    for r in ranks[4]:
        assert r["tables", _key(lay)] == want
        assert all(t["device_fraction"] == 0.25 for t in want)


def test_embedding_table_bytes_in_one_process():
    """Replicated tables count whole; a model without any is None."""
    from bigdl_torch.dataset import FeatureSpec
    from bigdl_torch.models import WideDeep
    from bigdl_torch.utils import memstats
    spec = _table_spec(FeatureSpec)
    got = memstats.embedding_table_bytes(
        WideDeep.from_spec(spec, embed_dim=8, hidden=(16,)).build("cpu"),
        device="cpu")
    assert [(t["rows"], t["device_fraction"]) for t in got] == \
        [(spec.deep_buckets, 1.0), (spec.wide_buckets, 1.0)]
    assert memstats.embedding_table_bytes(
        _mlp4(tnn).build("cpu"), device="cpu") is None


@pytest.mark.parametrize("lay", REFORMS, ids=[_key(x) for x in REFORMS])
def test_reform_on_the_new_layouts(run, lay):
    """The non-data block of 4 cannot survive on 2 ranks: the reference's
    ``MeshReformError``, before the live group's ``GroupReformError``."""
    _, _, ranks = run
    for r in ranks[4]:
        shape, live = r["reform", _key(lay)]
        assert shape[0] == "MeshReformError"
        assert live[0] == "MeshReformError"


@pytest.mark.parametrize("shape", [
    {"tp": 2, "pipe": 2}, {"data": 2, "tp": 2, "pipe": 2},
    {"tp": 2, "expert": 2}, {"fsdp": 2, "tp": 2, "expert": 2},
    {"pipe": 2, "expert": 2}, {"data": 2, "pipe": 2, "expert": 2}])
def test_the_new_meshes_want_their_processes(shape):
    """In one process each new mesh passes the check and wants its
    ranks."""
    Engine.reset()
    n = int(np.prod(list(shape.values())))
    with pytest.raises(ValueError, match=f"needs {n} processes"):
        Engine.init(device="cpu", mesh_shape=shape)
    assert Engine.mesh() is None
