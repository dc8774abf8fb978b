"""``affine=False`` BatchNorm under the Engine's data group against the
JAX package.

The reference's data-parallel step is one program over the global batch,
so its ``affine=False`` BatchNorm (``jnp.mean`` over the batch) takes the
global batch's statistics.  The port all-reduces (Σx, Σx², rows) forward
and (Σdy, Σdy·x̂) backward over the group.  Two gloo ranks run in worker
processes (torch, numpy and ``bigdl_torch`` only) that meet through a
``file://`` store.

- The module on two ranks with unequal rows (3 and 5) against the
  reference's module on the 8 rows together, training mode: each rank's
  output rows, input gradient rows and the running statistics within
  1e-5 of the larger of 1 and the reference's magnitude (float32 sums in
  another order).
- ``Optimizer`` on two ranks at local batch 4 (float32 wire) against the
  JAX ``Optimizer`` at batch 8 on two virtual devices, 3 steps: every
  loss, every parameter and the running statistics within 1e-5.
- A world of one gives today's numbers bit for bit (the route without a
  group); ``sync_axis="data"`` is accepted and needs the group.
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
import bigdl_tpu.nn as jnn
from bigdl_tpu import Engine as JEngine
from bigdl_tpu.common import DTypePolicy as JPolicy
from bigdl_tpu.common import get_policy as jget_policy
from bigdl_tpu.common import set_policy as jset_policy
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Optimizer as JOptimizer
from bigdl_tpu.optim import Trigger as JTrigger

import bigdl_torch.nn as tnn
from bigdl_torch import Engine
from torch_port_harness import close, x

WORKER_TIMEOUT = 120
STEPS = 3
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _port_engine():
    Engine.reset()
    yield
    Engine.reset()


_WORKER = textwrap.dedent('''
    import pickle, sys
    import numpy as np
    import torch
    from bigdl_torch import Engine
    import bigdl_torch.nn as nn
    from bigdl_torch.common import DTypePolicy, set_policy
    from bigdl_torch.dataset import DataSet, Sample
    from bigdl_torch.optim import SGD, Optimizer, Trigger
    from bigdl_torch.utils.convert import load_reference_tree, to_reference_tree

    job = pickle.load(open(sys.argv[1], "rb"))
    Engine.init(device="cpu")
    rank = Engine.rank()
    out = {"rank": rank, "world": Engine.world()}
    if job["kind"] == "module":
        m = nn.BatchNormalization(job["C"], momentum=job["momentum"],
                                  affine=False, sync_axis="data").build("cpu")
        load_reference_tree(m, {}, job["state"])
        lo, hi = job["rows"][rank]
        xt = torch.from_numpy(job["x"][lo:hi]).requires_grad_()
        y = m.train()(xt)
        y.backward(torch.from_numpy(job["ct"][lo:hi]))
        out.update(y=y.detach().numpy(), dx=xt.grad.numpy(),
                   state=to_reference_tree(m)[1])
    else:
        set_policy(DTypePolicy(wire_dtype=torch.float32))
        model = (nn.Sequential().add(nn.Linear(6, 5))
                 .add(nn.BatchNormalization(5, affine=False))
                 .add(nn.Linear(5, 3))).build("cpu")
        load_reference_tree(model, job["params"], job["state"])
        losses = {}
        def end(state):
            if state["neval"] > 1:
                losses[state["neval"] - 1] = state["loss"]
            return state["neval"] > job["steps"]
        x, y = job["x"], job["y"]
        Optimizer(model, DataSet.array(
            [Sample.from_ndarray(x[i], y[i]) for i in range(len(x))],
            distributed=True), nn.CrossEntropyCriterion(),
            batch_size=job["batch"]).set_optim_method(SGD(0.1)) \\
            .set_end_when(Trigger(end, "steps")).optimize()
        params, state = to_reference_tree(model)
        out.update(losses=losses, params=params, state=state)
    out["all_reduces"] = dict(Engine.all_reduces)
    pickle.dump(out, open(job["out"] + "." + str(rank), "wb"))
    Engine.reset()
''')


def _run_ranks(job, tmp_path, n=2):
    job = dict(job, out=str(tmp_path / "result"))
    (tmp_path / "job.pkl").write_bytes(pickle.dumps(job))
    (tmp_path / "worker.py").write_text(_WORKER)
    env = {**os.environ, "PYTHONPATH": _REPO,
           "BIGDL_TORCH_COORDINATOR": f"file://{tmp_path / 'store'}",
           "BIGDL_TORCH_NUM_PROCESSES": str(n)}
    procs = [subprocess.Popen(
        [sys.executable, str(tmp_path / "worker.py"),
         str(tmp_path / "job.pkl")],
        env={**env, "BIGDL_TORCH_PROCESS_ID": str(i)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(n)]

    def wait():
        try:
            errs = [p.communicate(timeout=WORKER_TIMEOUT)[1] for p in procs]
        finally:
            for p in procs:
                p.kill()
        for p, err in zip(procs, errs):
            assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        return [pickle.loads((tmp_path / f"result.{i}").read_bytes())
                for i in range(n)]
    return wait


def test_unequal_rows_match_the_global_batch(tmp_path):
    C = 4
    xs = x((8, C), 1, scale=2.0) + 0.5
    ct = x((8, C), 2)
    jm = jnn.BatchNormalization(C, affine=False, momentum=0.3)
    jm.build(jax.random.key(0))
    state = {"running_mean": np.full((C,), 0.2, np.float32),
             "running_var": np.full((C,), 1.5, np.float32)}
    wait = _run_ranks(dict(kind="module", C=C, x=xs, ct=ct, state=state,
                           momentum=0.3, rows=[(0, 3), (3, 8)]), tmp_path)

    def f(v):
        return jm.apply({}, {k: jnp.asarray(a) for k, a in state.items()},
                        v, training=True)
    (jy, jstate), vjp = jax.vjp(f, jnp.asarray(xs))
    (jdx,) = vjp((jnp.asarray(ct), jax.tree.map(jnp.zeros_like, jstate)))
    ranks = wait()
    assert [r["world"] for r in ranks] == [2, 2]
    for r, (lo, hi) in zip(ranks, [(0, 3), (3, 8)]):
        close(r["y"], np.asarray(jy)[lo:hi], what="y")
        close(r["dx"], np.asarray(jdx)[lo:hi], what="dx")
        for k in state:
            close(r["state"][k], jstate[k], what=k)
        assert r["all_reduces"] == {"bn_plain_stats": 1,
                                    "bn_plain_grad_stats": 1}


def test_optimizer_matches_reference_on_two_devices(tmp_path):
    def model(nn):
        return (nn.Sequential().add(nn.Linear(6, 5))
                .add(nn.BatchNormalization(5, affine=False))
                .add(nn.Linear(5, 3)))
    jm = model(jnn).build(jax.random.key(3))
    rs = np.random.RandomState(4)
    xs = (rs.standard_normal((8 * STEPS, 6)) * 1.5).astype(np.float32)
    xs[::2] += 1.0  # the two ranks' rows differ in distribution
    ys = rs.randint(0, 3, 8 * STEPS).astype(np.int32)
    wait = _run_ranks(dict(kind="optimizer", x=xs, y=ys, steps=STEPS,
                           batch=4,
                           params=jax.tree.map(np.asarray, jm.params),
                           state=jax.tree.map(np.asarray, jm.state)),
                      tmp_path)
    old = jget_policy()
    jset_policy(JPolicy(wire_dtype=jnp.float32))
    JEngine.init(devices=jax.devices()[:2])
    jlosses = {}

    def end(state):
        if state["neval"] > 1:
            jlosses[state["neval"] - 1] = state["loss"]
        return state["neval"] > STEPS
    try:
        JOptimizer(jm, JDataSet.array([JSample.from_ndarray(a, b)
                                       for a, b in zip(xs, ys)]),
                   jnn.CrossEntropyCriterion(), batch_size=8) \
            .set_optim_method(JSGD(0.1)) \
            .set_end_when(JTrigger(end, "steps")).optimize()
    finally:
        JEngine.reset()
        jset_policy(old)
    r0, r1 = wait()
    assert r0["losses"] == r1["losses"]
    assert sorted(r0["losses"]) == sorted(jlosses) == [1, 2, 3]
    for k in jlosses:
        close(r0["losses"][k], jlosses[k], what=f"loss {k}")
    for a, b in zip(jax.tree.leaves(r0["params"]),
                    jax.tree.leaves(jm.params)):
        close(a, b, what="param")
    for a, b in zip(jax.tree.leaves(r0["state"]), jax.tree.leaves(jm.state)):
        close(a, b, what="running statistic")
    assert r0["all_reduces"]["bn_plain_stats"] == STEPS
    assert r0["all_reduces"]["bn_plain_grad_stats"] == STEPS


def test_world_of_one_is_the_plain_route():
    """Under a group of one the numbers are the route without a group's,
    bit for bit, and no collective runs; ``sync_axis="data"`` is taken
    and needs the group."""
    xt = torch.from_numpy(x((6, 4), 3))
    ct = torch.from_numpy(x((6, 4), 4))

    def run():
        m = tnn.BatchNormalization(4, affine=False, sync_axis=None)
        m.build("cpu").train()
        xg = xt.clone().requires_grad_()
        y = m(xg)
        y.backward(ct)
        return y.detach(), xg.grad, m.running_mean, m.running_var
    alone = run()
    Engine.init(device="cpu")
    grouped = run()
    for a, b in zip(alone, grouped):
        assert torch.equal(a, b)
    assert dict(Engine.all_reduces) == {}
    m = tnn.BatchNormalization(4, affine=False, sync_axis="data").build("cpu")
    m.train()(xt)
    Engine.reset()
    with pytest.raises(RuntimeError, match="data group"):
        m(xt)
