"""Training, scoring and decoding under the mesh layouts on four gloo CPU
ranks, against the JAX package on four of the suite's virtual devices.

Four rank processes (one intra-op thread each, a barrier before every
``Engine.reset()``) run every scenario in turn while this process computes
the reference's:

- ``tools/shard_smoke.py``'s MLP under ``(4,1,1)``, ``(2,2,1)`` and
  ``(1,2,2)`` (``LayoutSharding(min_size=0)``, SGD with momentum, 5
  steps, float32) against the reference's ``LayoutSharding`` on the same
  layouts: the losses and the gathered weights within 1e-5, the gathered
  weights bit-equal on the four ranks, each rank's ``tree_device_bytes``
  equal to the reference's per device, ``tree_total_bytes`` the whole
  tree's; the fused update bit-equal to the per-leaf one; clipping by L2
  norm under ``(1,2,2)``.
- A small LM (2 layers, 4 heads, width 64) under ``(1,2,2)``: the
  forward's log-probs (``Predictor`` under the strategy) against the
  reference's forward; the global gradient against the one-process
  port's; 3 SGD steps against the reference's ``(1,2,2)`` run; the
  Engine's collectives a step by kind; a checkpoint at step 3 that loads
  into a one-process port model, into the reference's reader, and that
  resumes under ``(2,2,1)`` for 2 more steps as one process resumes it.
- ``cached_generate(mesh=)`` on the trained LM: the tokens equal to the
  reference's ``cached_generate`` on the gathered weights, the log-prob
  rows within 1e-5 of the reference's forward.
- ``TensorParallel`` over ``{"model": 2, "data": 2}`` (the reference's
  ``tests/test_multihost_tp.py`` MLP and rule, 3 steps with Adam and
  again with SGD): losses and weights within 1e-5.
- The embedding rows of rank (f, t) under ``(1,2,2)``: the reference's
  device (f, t)'s, and DTensor's ``distribute_tensor`` with
  ``assign_shardings``' placements.
- Dropout: the ranks of a tp group draw the same masks (their trained
  weights bit-equal), the batch shards different ones.
- ``Engine.reform`` on a real ``(2,2,1)`` mesh and on a mesh without a
  data axis: the reference's ``MeshReformError`` cases, then the live
  group's ``GroupReformError``; the wire's buckets under ``(2,2,1)``
  bit-equal to the run without them.
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
from jax.sharding import NamedSharding, Mesh
from jax.sharding import PartitionSpec as P

import bigdl_tpu.nn as jnn
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.models import decode as jdec
from bigdl_tpu.models import transformer_lm as jlm
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Adam as JAdam
from bigdl_tpu.optim import Optimizer as JOptimizer
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu.parallel import LayoutSharding as JLayoutSharding
from bigdl_tpu.parallel import MeshLayout as JMeshLayout
from bigdl_tpu.parallel.sharding import TensorParallel as JTensorParallel
from bigdl_tpu.utils import file_io as jfile_io
from bigdl_tpu.utils import memstats as jmem
from bigdl_tpu.utils.engine import Engine as JEngine

import bigdl_torch.nn as tnn
from bigdl_torch.dataset import DataSet as TDataSet
from bigdl_torch.dataset import Sample as TSample
from bigdl_torch.models import transformer_lm as tlm
from bigdl_torch.optim import SGD as TSGD
from bigdl_torch.optim import Optimizer as TOptimizer
from bigdl_torch.optim import Trigger as TTrigger
from bigdl_torch.parallel import LayoutSharding, MeshLayout
from bigdl_torch.utils import file_io as tfile_io
from bigdl_torch.utils.convert import load_reference_tree, to_reference_tree
from bigdl_torch.utils.engine import Engine

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
MLP_STEPS, MLP_BATCH = 5, 32
MLP_LAYOUTS = ((4, 1, 1), (2, 2, 1), (1, 2, 2))
LM = dict(vocab_size=64, max_len=16, d_model=64, num_heads=4, num_layers=2)
LM_STEPS, LM_BATCH, LM_MORE = 3, 16, 2
TP_STEPS, TP_BATCH = 3, 32
CLIP = 0.5
PROMPTS, NEW = 8, 4


@pytest.fixture(autouse=True)
def _keep_reference_rng():
    """The JAX Optimizer draws a key a step from the JAX package's default
    stream; put it back for the later tests of this process."""
    from bigdl_tpu.common import get_default_rng

    state = get_default_rng().get_state()
    yield
    get_default_rng().set_state(state)


def _mlp(nn):
    """``tools/shard_smoke.py``'s model."""
    return nn.Sequential(
        nn.Linear(64, 256, with_bias=False), nn.ReLU(),
        nn.Linear(256, 256, with_bias=False), nn.ReLU(),
        nn.Linear(256, 8, with_bias=False))


def _tp_mlp(nn):
    """``tests/test_multihost_tp.py``'s model."""
    return nn.Sequential(nn.Linear(16, 32), nn.ReLU(), nn.Linear(32, 4),
                         nn.LogSoftMax())


def _data():
    rs = np.random.RandomState(0)
    out = {"mlp": (rs.standard_normal((MLP_BATCH * MLP_STEPS, 64))
                   .astype(np.float32),
                   rs.randint(0, 8, MLP_BATCH * MLP_STEPS).astype(np.int32))}
    toks = rs.randint(0, LM["vocab_size"],
                      (LM_BATCH * (LM_STEPS + LM_MORE), LM["max_len"] + 1))
    out["lm"] = (toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32))
    r = np.random.default_rng(7)
    ys = r.integers(0, 4, size=TP_BATCH * TP_STEPS)
    centers = r.normal(0, 2.0, size=(4, 16)).astype(np.float32)
    xs = (centers[ys] + r.normal(0, 0.3, size=(len(ys), 16))).astype(
        np.float32)
    out["tp"] = (xs, ys.astype(np.int32))
    out["prompts"] = rs.randint(0, LM["vocab_size"], (PROMPTS, 5)).astype(
        np.int32)
    return out


def _trees(m):
    return jax.tree.map(np.asarray, (m.params, m.state))


_WORKER = textwrap.dedent('''
    import json, os, pickle, sys
    import numpy as np
    import torch
    import bigdl_torch.nn as tnn
    from bigdl_torch.dataset import DataSet, Sample
    from bigdl_torch.models import decode as tdec
    from bigdl_torch.models import transformer_lm as tlm
    from bigdl_torch.optim import (SGD, Adam, Optimizer, Predictor,
                                   Trigger)
    from bigdl_torch.optim.optimizer import dropout_seed
    from bigdl_torch.parallel import (LayoutSharding, MeshLayout,
                                      MeshReformError, TensorParallel,
                                      assign_shardings)
    from bigdl_torch.utils import memstats
    from bigdl_torch.utils.convert import (load_reference_tree,
                                           to_reference_tree)
    from bigdl_torch.utils.engine import Engine, GroupReformError
    import torch.distributed as dist

    job, tmp = pickle.load(open(sys.argv[1], "rb")), sys.argv[2]
    torch.set_num_threads(1)   # the ranks share the host's cores
    rank = int(os.environ["BIGDL_TORCH_PROCESS_ID"])
    res, n_init = {}, [0]

    def init(shape):
        n_init[0] += 1
        os.environ["BIGDL_TORCH_COORDINATOR"] = \\
            f"file://{tmp}/store{n_init[0]}"
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

    def recorder(losses, steps):
        def fn(state):
            if state["neval"] > 1:
                losses[state["neval"] - 1] = state["loss"]
            return state["neval"] > steps
        return Trigger(fn, "steps")

    def samples(x, y):
        return DataSet.array([Sample.from_ndarray(x[i], y[i])
                              for i in range(len(x))], distributed=True)

    def mlp():
        return tnn.Sequential(
            tnn.Linear(64, 256, with_bias=False), tnn.ReLU(),
            tnn.Linear(256, 256, with_bias=False), tnn.ReLU(),
            tnn.Linear(256, 8, with_bias=False))

    def lm_crit():
        return tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion(),
                                            size_average=True)

    def train_mlp(sizes, fused=False, clip=None, steps=None):
        init(MeshLayout(*sizes).shape())
        m = mlp().build("cpu")
        load_reference_tree(m, *job["mlp_params"])
        strat = LayoutSharding(m, min_size=0)
        x, y = job["data"]["mlp"]
        losses = {}
        steps = steps or job["mlp_steps"]
        os.environ["BIGDL_TORCH_FUSED_UPDATE"] = "1" if fused else "0"
        opt = Optimizer(m, samples(x, y), tnn.CrossEntropyCriterion(),
                        batch_size=job["mlp_batch"] // Engine.group_size(),
                        strategy=strat)
        opt.set_optim_method(SGD(0.05, momentum=0.9))
        if clip:
            opt.set_gradient_clipping_by_l2_norm(clip)
        opt.set_end_when(recorder(losses, steps)).optimize()
        os.environ.pop("BIGDL_TORCH_FUSED_UPDATE")
        out = {"losses": [losses[i] for i in sorted(losses)],
               "device_bytes": memstats.tree_device_bytes(m, "cpu"),
               "total_bytes": memstats.tree_total_bytes(m),
               "local": m._layout_plan.local_elements(),
               "weights": leaves(to_reference_tree(m)[0]),
               "velocity": [t.numpy().copy() for t in
                            opt.final_opt_state["velocity"]],
               "all_reduces": Engine.all_reduces["grads"]}
        reset()
        return out

    for sizes in job["mlp_layouts"]:
        res["mlp", sizes] = train_mlp(sizes)
    res["mlp_fused"] = train_mlp((1, 2, 2), fused=True)
    # the wire's buckets under (2,2,1), whose data axis all-reduces every
    # gradient: bit-equal to the run without them, one all-reduce a bucket
    os.environ["BIGDL_TORCH_WIRE_BUCKET_MB"] = "0.05"
    res["buckets"] = train_mlp((2, 2, 1))
    os.environ.pop("BIGDL_TORCH_WIRE_BUCKET_MB")
    res["mlp_clip"] = train_mlp((1, 2, 2), clip=job["clip"], steps=2)

    # the small LM under (1,2,2)
    init(MeshLayout(1, 2, 2).shape())
    m = tlm.TransformerLM(**job["lm"]).build("cpu")
    load_reference_tree(m, *job["lm_params"])
    strat = LayoutSharding(m, min_size=0)
    x, y = job["data"]["lm"]
    res["lm_logp0"] = Predictor(m, batch_size=8, strategy=strat).predict(
        x[:8])
    # the global gradient of the first batch
    plan = strat.place(m)
    m.train()
    lo = Engine.group_rank() * (job["lm_batch"] // Engine.group_size())
    hi = lo + job["lm_batch"] // Engine.group_size()
    first = slice(0, job["lm_batch"])
    xb, yb = (torch.from_numpy(a[first][lo:hi]) for a in (x, y))
    loss = lm_crit()(m(xb), yb)
    loss.backward()
    params = list(m.parameters())
    grads, gl = strat.reduce([p.grad for p in params], loss.detach())
    res["lm_grads"] = [g.numpy() for g in plan.gather_whole(grads)]
    res["lm_grad_loss"] = float(gl)
    for p in params:
        p.grad = None
    Engine.clear_counts()
    losses = {}
    opt = Optimizer(m, samples(x[:job["lm_batch"] * job["lm_steps"]],
                               y[:job["lm_batch"] * job["lm_steps"]]),
                    lm_crit(), batch_size=job["lm_batch"] //
                    Engine.group_size(), strategy=strat)
    opt.set_optim_method(SGD(0.1, momentum=0.9))
    opt.set_checkpoint(os.path.join(tmp, "ckpt"), Trigger.every_epoch())
    opt.set_end_when(recorder(losses, job["lm_steps"])).optimize()
    res["lm_collectives"] = Engine.collectives()
    res["lm_losses"] = [losses[i] for i in sorted(losses)]
    res["lm_weights"] = leaves(to_reference_tree(m)[0])
    res["lm_local"] = plan.local_elements()
    res["lm_tp_modules"] = len(plan.tp_modules())
    res["lm_logp"] = Predictor(m, batch_size=8, strategy=strat).predict(
        x[:8])
    toks, rows = tdec.cached_generate_rows(
        m, job["data"]["prompts"], job["new"], job["lm"]["max_len"],
        mesh=Engine.mesh())
    res["decode"] = (toks, np.stack(rows))
    # the embedding rows of this rank, and DTensor's placement of them
    e = tnn.Sequential(tnn.LookupTable(16, 4)).build("cpu")
    with torch.no_grad():
        e.layers[0].weight.copy_(torch.arange(64.).reshape(16, 4))
    from torch.distributed.tensor import distribute_tensor
    whole = e.layers[0].weight.detach().clone()
    pl = assign_shardings(e, None, Engine.mesh(), min_size=0)[0]["weight"]
    res["embedding"] = {
        "coord": Engine.mesh_coordinate(),
        "dtensor": distribute_tensor(whole, Engine.mesh(), pl)
        .to_local().numpy(),
        "plan": LayoutSharding(e, min_size=0).place(e).leaves[0]
        .param.detach().numpy().copy()}
    reset()

    # resume the checkpoint under (2,2,1)
    init(MeshLayout(2, 2, 1).shape())
    m = tlm.TransformerLM(**job["lm"]).build("cpu")
    losses = {}
    n = job["lm_batch"] * job["lm_more"]
    opt = Optimizer(m, samples(x[-n:], y[-n:]), lm_crit(),
                    batch_size=job["lm_batch"] // Engine.group_size(),
                    strategy=LayoutSharding(m, min_size=0))
    opt.set_optim_method(SGD(0.1, momentum=0.9))
    opt.resume_from(os.path.join(tmp, "ckpt", f"model.{job['lm_steps']}"),
                    os.path.join(tmp, "ckpt",
                                 f"optimMethod.{job['lm_steps']}"))
    opt.set_end_when(Trigger.max_iteration(job["lm_steps"] + job["lm_more"]))
    opt.optimize()
    res["resumed"] = leaves(to_reference_tree(m)[0])
    # the reference's MeshReformError cases on the real mesh
    errs = {}
    for world in (3, 1, 2):
        try:
            Engine.reform(world=world, rank=0, survivors=list(range(world)))
        except (MeshReformError, GroupReformError) as err:
            errs[world] = [type(err).__name__, str(err)]
    from torch.distributed.device_mesh import DeviceMesh
    Engine.set_mesh(DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                               mesh_dim_names=("fsdp", "tp")))
    try:
        Engine.reform(world=2, rank=0, survivors=[0, 1])
    except MeshReformError as err:
        errs["no_data"] = [type(err).__name__, str(err)]
    res["reform"] = errs
    reset()

    # Dropout under (1,2,2)
    init(MeshLayout(1, 2, 2).shape())
    m = tlm.TransformerLM(**job["lm"], dropout=0.1).build("cpu")
    opt = Optimizer(m, samples(x[:32], y[:32]), lm_crit(),
                    batch_size=job["lm_batch"] // Engine.group_size(),
                    strategy=LayoutSharding(m, min_size=0))
    opt.set_optim_method(SGD(0.1)).set_end_when(Trigger.max_iteration(2))
    opt.optimize()
    res["dropout"] = {"seed": dropout_seed(Engine.rank()),
                      "batch_rank": Engine.group_rank(),
                      "weights": leaves(to_reference_tree(m)[0])}
    reset()

    # TensorParallel over {"model": 2, "data": 2}, with Adam and with SGD
    # (whose weights see the gradients' scale)
    init({"model": 2, "data": 2})

    def rule(path, leaf):
        if leaf.ndim == 2 and leaf.shape[-1] % 2 == 0:
            return (None, "model")
        return ()
    x, y = job["data"]["tp"]
    for key, method in (("tp", lambda: Adam(1e-2)),
                        ("tp_sgd", lambda: SGD(0.1))):
        torch.manual_seed(0)
        m = tnn.Sequential(tnn.Linear(16, 32), tnn.ReLU(),
                           tnn.Linear(32, 4), tnn.LogSoftMax()).build("cpu")
        load_reference_tree(m, *job["tp_params"])
        losses = {}
        opt = Optimizer(m, samples(x, y), tnn.ClassNLLCriterion(),
                        batch_size=job["tp_batch"] // Engine.group_size(),
                        strategy=TensorParallel(rule=rule))
        opt.set_optim_method(method())
        opt.set_end_when(recorder(losses, job["tp_steps"])).optimize()
        res[key] = {"losses": [losses[i] for i in sorted(losses)],
                    "batch_group": Engine.group_size(),
                    "weights": leaves(to_reference_tree(m)[0])}
    reset()
    pickle.dump(res, open(os.path.join(tmp, f"rank{rank}.pkl"), "wb"))
''')


def _reference_mlp(sizes, params, data, clip=None, steps=MLP_STEPS):
    jm = _mlp(jnn)
    jm.build(jax.random.key(0))
    jm.params = jax.tree.map(jnp.asarray, params[0])
    x, y = data
    losses = {}

    def fn(state):
        if state["neval"] > 1:
            losses[state["neval"] - 1] = state["loss"]
        return state["neval"] > steps
    JEngine.reset()
    JMeshLayout(*sizes).install(jax.devices()[:4])
    try:
        opt = JOptimizer(jm, JDataSet.array(
            [JSample.from_ndarray(x[i], y[i]) for i in range(len(x))]),
            jnn.CrossEntropyCriterion(), batch_size=MLP_BATCH,
            strategy=JLayoutSharding(jm, min_size=0))
        opt.set_optim_method(JSGD(0.05, momentum=0.9))
        if clip:
            opt.set_gradient_clipping_by_l2_norm(clip)
        opt.set_end_when(JTrigger(fn, "steps")).optimize()
        per_dev = jmem.tree_device_bytes(jm.params)
    finally:
        JEngine.reset()
    return {"losses": [losses[i] for i in sorted(losses)],
            "weights": [np.asarray(a) for a in jax.tree.leaves(jm.params)],
            "device_bytes": per_dev,
            "total_bytes": jmem.tree_total_bytes(jm.params)}


def _reference_lm(params, data):
    jm = jlm.TransformerLM(**LM)
    jm.build(jax.random.key(0))
    jm.params = jax.tree.map(jnp.asarray, params[0])
    jm.evaluate()
    x, y = data
    logp0 = np.asarray(jm.forward(jnp.asarray(x[:8])))
    n = LM_BATCH * LM_STEPS
    losses = {}

    def fn(state):
        if state["neval"] > 1:
            losses[state["neval"] - 1] = state["loss"]
        return state["neval"] > LM_STEPS
    JEngine.reset()
    JMeshLayout(1, 2, 2).install(jax.devices()[:4])
    try:
        JOptimizer(jm, JDataSet.array([JSample.from_ndarray(x[i], y[i])
                                       for i in range(n)]),
                   jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion(),
                                                size_average=True),
                   batch_size=LM_BATCH,
                   strategy=JLayoutSharding(jm, min_size=0)) \
            .set_optim_method(JSGD(0.1, momentum=0.9)) \
            .set_end_when(JTrigger(fn, "steps")).optimize()
    finally:
        JEngine.reset()
    return {"logp0": logp0, "losses": [losses[i] for i in sorted(losses)],
            "weights": [np.asarray(a) for a in jax.tree.leaves(jm.params)]}


def _reference_tp(params, data, method):
    from bigdl_tpu.common import set_seed
    set_seed(123)
    jm = _tp_mlp(jnn)
    jm.build(jax.random.key(0))
    jm.params = jax.tree.map(jnp.asarray, params[0])
    x, y = data
    losses = {}

    def fn(state):
        if state["neval"] > 1:
            losses[state["neval"] - 1] = state["loss"]
        return state["neval"] > TP_STEPS

    def rule(path, leaf):
        if leaf.ndim == 2 and leaf.shape[-1] % 2 == 0:
            return P(None, "model")
        return P()
    JEngine.reset()
    JEngine.init(mesh_shape={"model": 2, "data": 2},
                 devices=jax.devices()[:4])
    try:
        JOptimizer(jm, JDataSet.array([JSample.from_ndarray(x[i], y[i])
                                       for i in range(len(x))]),
                   jnn.ClassNLLCriterion(), batch_size=TP_BATCH,
                   strategy=JTensorParallel(rule=rule)) \
            .set_optim_method(method) \
            .set_end_when(JTrigger(fn, "steps")).optimize()
    finally:
        JEngine.reset()
    return {"losses": [losses[i] for i in sorted(losses)],
            "weights": [np.asarray(a) for a in jax.tree.leaves(jm.params)]}


def _port_lm(params):
    m = tlm.TransformerLM(**LM).build("cpu")
    load_reference_tree(m, *params)
    return m


def _lm_crit():
    return tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion(),
                                        size_average=True)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The port's scenarios on four gloo ranks, started first, and the
    reference's computed while they run (the JAX package's default key
    stream, which its Optimizer draws from, put back after)."""
    from bigdl_tpu.common import get_default_rng

    rng_state = get_default_rng().get_state()
    try:
        return _run(tmp_path_factory)
    finally:
        get_default_rng().set_state(rng_state)


def _run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("layout")
    data = _data()
    jmlp, jlm_m, jtp = _mlp(jnn), jlm.TransformerLM(**LM), _tp_mlp(jnn)
    for i, m in enumerate((jmlp, jlm_m, jtp)):
        m.build(jax.random.key(i + 3))
    job = {"data": data, "mlp_params": _trees(jmlp),
           "lm_params": _trees(jlm_m), "tp_params": _trees(jtp),
           "mlp_layouts": MLP_LAYOUTS, "mlp_steps": MLP_STEPS,
           "mlp_batch": MLP_BATCH, "lm": LM, "lm_steps": LM_STEPS,
           "lm_batch": LM_BATCH, "lm_more": LM_MORE, "clip": CLIP,
           "tp_steps": TP_STEPS, "tp_batch": TP_BATCH, "new": NEW}
    (tmp / "job.pkl").write_bytes(pickle.dumps(job))
    (tmp / "worker.py").write_text(_WORKER)
    env = {**os.environ, "PYTHONPATH": _REPO,
           "BIGDL_TORCH_NUM_PROCESSES": "4"}
    procs = [subprocess.Popen(
        [sys.executable, str(tmp / "worker.py"), str(tmp / "job.pkl"),
         str(tmp)], env={**env, "BIGDL_TORCH_PROCESS_ID": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    try:
        ref = {("mlp", s): _reference_mlp(s, job["mlp_params"],
                                          data["mlp"])
               for s in MLP_LAYOUTS}
        ref["mlp_clip"] = _reference_mlp((1, 2, 2), job["mlp_params"],
                                         data["mlp"], clip=CLIP, steps=2)
        ref["lm"] = _reference_lm(job["lm_params"], data["lm"])
        ref["tp"] = _reference_tp(job["tp_params"], data["tp"],
                                  JAdam(1e-2))
        ref["tp_sgd"] = _reference_tp(job["tp_params"], data["tp"],
                                      JSGD(0.1))
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, f"rank failed:\n{err[-4000:]}"
    ranks = [pickle.load(open(tmp / f"rank{r}.pkl", "rb")) for r in range(4)]
    return job, ref, ranks, tmp


def _close(a, b, tol=TOL):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("sizes", MLP_LAYOUTS,
                         ids=["x".join(map(str, s)) for s in MLP_LAYOUTS])
def test_mlp_layouts_match_reference(run, sizes):
    _, ref, ranks, _ = run
    want = ref["mlp", sizes]
    for r in ranks:
        got = r["mlp", sizes]
        assert len(got["losses"]) == MLP_STEPS
        _close(got["losses"], want["losses"])
        _close(got["weights"], want["weights"])
        assert got["device_bytes"] == want["device_bytes"]
        assert got["total_bytes"] == want["total_bytes"]
        assert all(np.array_equal(a, b) for a, b in zip(
            got["weights"], ranks[0]["mlp", sizes]["weights"]))
    d, f, t = sizes
    assert ranks[0]["mlp", sizes]["local"] * f * t == sum(
        w.size for w in want["weights"])


def test_fused_update_bit_equal_under_layout(run):
    _, _, ranks, _ = run
    for r in ranks:
        a, b = r["mlp", (1, 2, 2)], r["mlp_fused"]
        assert a["losses"] == b["losses"]
        assert all(np.array_equal(x, y) for x, y in zip(a["weights"],
                                                        b["weights"]))
        assert all(np.array_equal(x, y) for x, y in zip(a["velocity"],
                                                        b["velocity"]))


def test_clipping_by_l2_norm_under_layout(run):
    _, ref, ranks, _ = run
    for r in ranks:
        _close(r["mlp_clip"]["losses"], ref["mlp_clip"]["losses"])
        _close(r["mlp_clip"]["weights"], ref["mlp_clip"]["weights"])
    # the clip bites: the clipped run's change is not the unclipped one's
    assert not np.allclose(ranks[0]["mlp_clip"]["weights"][0],
                           ranks[0]["mlp", (1, 2, 2)]["weights"][0])


def test_lm_forward_and_gradient_under_layout(run):
    job, ref, ranks, _ = run
    for r in ranks:
        np.testing.assert_allclose(r["lm_logp0"], ref["lm"]["logp0"],
                                   atol=TOL, rtol=0)
    m = _port_lm(job["lm_params"])
    x, y = job["data"]["lm"]
    loss = _lm_crit()(m(torch.from_numpy(x[:LM_BATCH])),
                      torch.from_numpy(y[:LM_BATCH]))
    loss.backward()
    want = [p.grad.numpy() for p in m.parameters()]
    for r in ranks:
        assert abs(r["lm_grad_loss"] - float(loss.detach())) < TOL
        _close(r["lm_grads"], want)


def test_lm_steps_match_reference(run):
    _, ref, ranks, _ = run
    for r in ranks:
        assert len(r["lm_losses"]) == LM_STEPS
        _close(r["lm_losses"], ref["lm"]["losses"])
        _close(r["lm_weights"], ref["lm"]["weights"])
        assert all(np.array_equal(a, b) for a, b in zip(
            r["lm_weights"], ranks[0]["lm_weights"]))
        # every Linear and both attentions compute their tp slice
        assert r["lm_tp_modules"] == 2 * 3 + 1


def test_lm_collectives_a_step(run):
    """Per step of the 2-layer LM under (1,2,2): the parameters gathered
    at use, one all-gather a unit (the token table, the position table,
    each block, the head; the final LayerNorm's leaves are replicated) and
    as many reduce-scatters; gathered again in the backward, one
    all-gather a unit that saved a gathered weight (each block and the
    head: the tables' backward reads the indices alone); over tp 2 output
    gathers an attention, 2 a
    feed-forward, 1 for the head, and as many input all-reduces, and one
    bias-slice gather an attention; one all-reduce of the replicated
    leaves and the loss; the snapshot's one gather of the parameters and
    one of the method state at the epoch's end (step 3)."""
    _, _, ranks, _ = run
    L = LM["num_layers"]
    for r in ranks:
        c = r["lm_collectives"]
        assert c["reduce_scatter"] == {"grads": (L + 3) * LM_STEPS}
        assert c["all_reduce"]["tp_in"] == (4 * L + 1) * LM_STEPS
        assert c["all_reduce"]["grads"] == LM_STEPS
        assert c["all_gather"]["params"] == (L + 3) * LM_STEPS
        assert c["all_gather"]["params_bwd"] == (L + 1) * LM_STEPS
        assert c["all_gather"]["tp_out"] == (4 * L + 1) * LM_STEPS
        assert c["all_gather"]["tp_bias"] == L * LM_STEPS
        assert c["all_gather"]["whole"] == 1
        assert c["all_gather"]["opt_state"] == 1


def test_predictor_under_layout(run):
    job, _, ranks, _ = run
    jm = jlm.TransformerLM(**LM)
    jm.build(jax.random.key(0))
    tree = _unflatten(job["lm_params"][0], ranks[0]["lm_weights"])
    jm.params = jax.tree.map(jnp.asarray, tree)
    jm.evaluate()
    x, _ = job["data"]["lm"]
    want = np.asarray(jm.forward(jnp.asarray(x[:8])))
    for r in ranks:
        np.testing.assert_allclose(r["lm_logp"], want, atol=TOL, rtol=0)


def _unflatten(like, leaves):
    it = iter(leaves)
    return jax.tree.map(lambda _: next(it), like)


def test_cached_generate_on_the_mesh(run):
    job, _, ranks, _ = run
    jm = jlm.TransformerLM(**LM)
    jm.build(jax.random.key(0))
    jm.params = jax.tree.map(jnp.asarray, _unflatten(job["lm_params"][0],
                                                     ranks[0]["lm_weights"]))
    prompts = job["data"]["prompts"]
    want = jdec.cached_generate(jm, prompts, NEW, LM["max_len"],
                                cache_dtype=jnp.float32)
    jm.evaluate()
    logp = np.asarray(jm.forward(jnp.asarray(want)))
    t0 = prompts.shape[1]
    rows = np.stack([logp[:, t0 - 1 + i] for i in range(NEW)])
    for r in ranks:
        toks, got = r["decode"]
        assert np.array_equal(toks, want)
        np.testing.assert_allclose(got, rows, atol=TOL, rtol=0)


def test_checkpoint_loads_into_one_process_and_the_reference(run):
    job, _, ranks, tmp = run
    path = tmp / "ckpt" / f"model.{LM_STEPS}"
    blob = tfile_io.load(str(path))
    m = _port_lm(job["lm_params"])
    load_reference_tree(m, blob["params"], blob["state"])
    _close([p.detach().numpy() for p in _leaves_of(m)],
           ranks[0]["lm_weights"], tol=0)
    jblob = jfile_io.load(str(path))
    assert all(np.array_equal(np.asarray(a), b) for a, b in zip(
        jax.tree.leaves(jblob["params"]), ranks[0]["lm_weights"]))
    oblob = jfile_io.load(str(tmp / "ckpt" / f"optimMethod.{LM_STEPS}"))
    assert jax.tree.structure(oblob["opt_state"]["velocity"]) == \
        jax.tree.structure(blob["params"])


def _leaves_of(m):
    tree, _ = to_reference_tree(m, fetch=lambda t: t)
    return jax.tree.leaves(tree)


def test_checkpoint_resumes_under_another_layout(run):
    """The (1,2,2) snapshot resumed under (2,2,1) for 2 steps, as one
    process resumes it."""
    job, _, ranks, tmp = run
    m = _port_lm(job["lm_params"])
    x, y = job["data"]["lm"]
    n = LM_BATCH * LM_MORE
    opt = TOptimizer(m, TDataSet.array([TSample.from_ndarray(x[i], y[i])
                                        for i in range(len(x) - n, len(x))]),
                     _lm_crit(), batch_size=LM_BATCH, device="cpu")
    opt.set_optim_method(TSGD(0.1, momentum=0.9))
    opt.resume_from(str(tmp / "ckpt" / f"model.{LM_STEPS}"),
                    str(tmp / "ckpt" / f"optimMethod.{LM_STEPS}"))
    opt.set_end_when(TTrigger.max_iteration(LM_STEPS + LM_MORE)).optimize()
    want = [t.detach().numpy() for t in _leaves_of(m)]
    for r in ranks:
        _close(r["resumed"], want)
    assert not np.allclose(ranks[0]["resumed"][0], ranks[0]["lm_weights"][0])


def test_tensor_parallel_model_data_mesh(run):
    _, ref, ranks, _ = run
    for r in ranks:
        assert r["tp"]["batch_group"] == 2
        assert len(r["tp"]["losses"]) == TP_STEPS
        _close(r["tp"]["losses"], ref["tp"]["losses"])
        _close(r["tp"]["weights"], ref["tp"]["weights"])
        assert all(np.array_equal(a, b) for a, b in zip(
            r["tp"]["weights"], ranks[0]["tp"]["weights"]))


def test_tensor_parallel_sgd_weights_match_reference(run):
    """SGD under TensorParallel: the weights move by the gradients
    themselves, so a wrong average over the batch group shows in them
    (Adam's update all but divides the scale out)."""
    _, ref, ranks, _ = run
    for r in ranks:
        assert len(r["tp_sgd"]["losses"]) == TP_STEPS
        _close(r["tp_sgd"]["losses"], ref["tp_sgd"]["losses"])
        _close(r["tp_sgd"]["weights"], ref["tp_sgd"]["weights"])
        assert all(np.array_equal(a, b) for a, b in zip(
            r["tp_sgd"]["weights"], ranks[0]["tp_sgd"]["weights"]))


def test_embedding_rows_in_the_reference_device_order(run):
    """Rows of a (16, 4) table under (1,2,2): rank (f, t) holds block
    f * 2 + t, the reference's device (f, t) the same rows, and DTensor
    with the placements of ``assign_shardings`` too."""
    whole = np.arange(64, dtype=np.float32).reshape(16, 4)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 2, 2),
                ("data", "fsdp", "tp"))
    arr = jax.device_put(whole, NamedSharding(mesh, P(("fsdp", "tp"),
                                                      None)))
    by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    for r in ranks_of(run):
        c = r["embedding"]["coord"]
        want = by_dev[mesh.devices[0, c["fsdp"], c["tp"]]]
        assert np.array_equal(r["embedding"]["plan"], want)
        assert np.array_equal(r["embedding"]["dtensor"], want)
        blk = c["fsdp"] * 2 + c["tp"]
        assert np.array_equal(want, whole[4 * blk:4 * blk + 4])


def ranks_of(run):
    return run[2]


def test_dropout_masks_follow_the_batch_shard(run):
    _, _, ranks, _ = run
    d = [r["dropout"] for r in ranks]
    # (f, t) = (r // 2, r % 2): the tp peers share the batch rank and seed
    assert [x["batch_rank"] for x in d] == [0, 0, 1, 1]
    assert d[0]["seed"] == d[1]["seed"] != d[2]["seed"] == d[3]["seed"]
    for x in d[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(
            x["weights"], d[0]["weights"]))


def test_reform_on_the_mesh_and_the_buckets(run):
    _, _, ranks, _ = run
    for r in ranks:
        e = r["reform"]
        assert e[3][0] == "MeshReformError" and \
            "shard groups intact" in e[3][1]
        assert e[1][0] == "MeshReformError"
        assert e[2][0] == "GroupReformError"
        assert e["no_data"][0] == "MeshReformError" and \
            "no 'data' axis" in e["no_data"][1]
        # the wire's buckets train bit-equal to the run without them
        b, plain = r["buckets"], r["mlp", (2, 2, 1)]
        assert all(np.array_equal(u, v) for u, v in zip(b["weights"],
                                                        plain["weights"]))
        assert b["losses"] == plain["losses"]
        steps = len(b["losses"])
        assert plain["all_reduces"] < b["all_reduces"]
        assert plain["all_reduces"] % steps == b["all_reduces"] % steps == 0


def test_layout_in_one_process():
    """A (1,1,1) layout in one process: the mesh, a batch group of one,
    LayoutSharding a plain step; with the wire's buckets the same
    weights."""
    Engine.reset()
    try:
        mesh = MeshLayout(1, 1, 1).install(device="cpu")
        assert mesh is Engine.mesh() and \
            mesh.mesh_dim_names == ("data", "fsdp", "tp")
        assert Engine.group_size() == 1 and Engine.data_shard_info() == (
            0, 1) and Engine.is_writer()
        m = tnn.Sequential(tnn.Linear(4, 3)).build("cpu")
        samples = [TSample.from_ndarray(np.ones((4,), np.float32),
                                        np.int32(1))] * 4
        opt = TOptimizer(m, samples, tnn.CrossEntropyCriterion(),
                         batch_size=4, strategy=LayoutSharding(m))
        opt.set_end_when(TTrigger.max_iteration(2)).optimize()
        assert m._layout_plan.local_elements() == 15
        os.environ["BIGDL_TORCH_WIRE_BUCKET_MB"] = "1"
        try:
            m2 = tnn.Sequential(tnn.Linear(4, 3)).build("cpu")
            with torch.no_grad():
                for p, q in zip(m2.parameters(), m.parameters()):
                    p.copy_(q)
            m3 = tnn.Sequential(tnn.Linear(4, 3)).build("cpu")
            with torch.no_grad():
                for p, q in zip(m3.parameters(), m.parameters()):
                    p.copy_(q)
            TOptimizer(m2, samples, tnn.CrossEntropyCriterion(),
                       batch_size=4, strategy=LayoutSharding(m2)) \
                .set_end_when(TTrigger.max_iteration(2)).optimize()
        finally:
            os.environ.pop("BIGDL_TORCH_WIRE_BUCKET_MB")
        TOptimizer(m3, samples, tnn.CrossEntropyCriterion(), batch_size=4,
                   strategy=LayoutSharding(m3)) \
            .set_end_when(TTrigger.max_iteration(2)).optimize()
        assert all(torch.equal(p, q) for p, q in zip(m2.parameters(),
                                                     m3.parameters()))
    finally:
        Engine.reset()
