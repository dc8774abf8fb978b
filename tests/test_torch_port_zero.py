"""ZeRO (``ShardedDataParallel``) against the JAX package: the slicing
plan, the method state's slicing, ``remap``, two gloo ranks training the
small ResNet, and checkpoints that move between ZeRO and
``DataParallel`` runs of both packages.

Plans are compared through ``jax.eval_shape`` trees (no JAX ResNet-50 is
built) on the conftest's 8-device CPU mesh, leaf by leaf: exact.  Two
gloo ranks run in subprocesses (``test_torch_port_dp._spawn_ranks``).

Tolerances, as a bound on max|port − reference| relative to
max(1, max|reference|):
- two ranks at local batch 8 against the JAX ``Optimizer`` under
  ``ShardedDataParallel`` at batch 16 on the 8-device mesh, after 3 steps,
  every loss, parameter and running statistic: ``TRAIN_TOL`` = 2e-3, the
  two-rank bound of ``test_torch_port_dp.py`` (summation order, amplified
  by three steps, both through the bf16 wire).
- ZeRO against ``DataParallel`` at two ranks, and the fused update and
  the buckets against the plain run: bit-equal (every route sums the same
  two numbers for each element, and a + b commutes).  With L2-norm
  clipping the norm's summation order differs (each rank's slices, then
  the group), so ZeRO and ``DataParallel`` are held to 1e-6 there, in
  float32 without the wire (through it, a last-bit difference can flip a
  bf16 rounding and move that element by 2^-8).
- A checkpoint resumed in another run, one step on: ``TRAIN_TOL`` against
  the uninterrupted run.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import bigdl_tpu.nn as jnn
from bigdl_tpu import Engine as JEngine
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.models import LeNet5 as JLeNet5
from bigdl_tpu.models import resnet as jresnet
from bigdl_tpu.models import transformer_lm as jlm
from bigdl_tpu.optim import EMA as JEMA
from bigdl_tpu.optim import LBFGS as JLBFGS
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Adam as JAdam
from bigdl_tpu.optim import Optimizer as JOptimizer
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu.parallel import ShardedDataParallel as JZeRO

import bigdl_torch.nn as tnn
from bigdl_torch import Engine
from bigdl_torch.models import resnet as tresnet
from bigdl_torch.optim import LBFGS, SGD, Adam
from bigdl_torch.optim.optimizer import opt_state_nbytes
from bigdl_torch.parallel import ShardedDataParallel, bucket_count

from test_torch_port_dp import _data, _small_resnet, _spawn_ranks

TRAIN_TOL = 2e-3
CLIP_RTOL = 1e-6
STEPS = 3
LOCAL_BATCH = 8
#: small enough that the small ResNet has sliced and replicated leaves
MIN_SIZE = 256
CLIP = 1.0


@pytest.fixture(autouse=True)
def _port_engine():
    Engine.reset()
    yield
    Engine.reset()


def _axis(sharding):
    axes = [i for i, a in enumerate(sharding.spec) if a == "data"]
    return axes[0] if axes else None


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("data",))


_TREES = {
    "resnet50": lambda: jax.eval_shape(
        jnn.fuse_conv_bn(jresnet.ResNet(50, class_num=1000,
                                        dataset="imagenet")).init,
        jax.random.key(0))[0],
    "transformer_lm": lambda: jax.eval_shape(
        jlm.TransformerLM(vocab_size=32000, max_len=512, d_model=512,
                          num_heads=8, num_layers=8).init,
        jax.random.key(0))[0],
    "lenet5": lambda: jax.eval_shape(JLeNet5(10).init, jax.random.key(0))[0],
}


@pytest.mark.parametrize("min_size", [2 ** 14, 1024, 1])
@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("tree", sorted(_TREES))
def test_plan_matches_reference(tree, n, min_size):
    """The axis of every leaf equals the reference's ``param_sharding``."""
    params = _TREES[tree]()
    ref = JZeRO(min_size=min_size).param_sharding(_mesh(n), params)
    shapes = [tuple(a.shape) for a in jax.tree.leaves(params)]
    got = ShardedDataParallel(min_size=min_size).param_axes(shapes, n)
    assert got == [_axis(s) for s in jax.tree.leaves(ref)]


def test_port_resnet50_has_the_reference_leaves():
    """The port's fused ResNet-50 has the reference's 214 leaves, so the
    module docstring's memory figures hold for it: 25,489,408 elements in
    sliced leaves, 94,184 replicated; one slot per rank 12,838,888
    elements at N = 2 and 6,466,536 at N = 4."""
    ref = sorted(tuple(a.shape)
                 for a in jax.tree.leaves(_TREES["resnet50"]()))
    tm = tnn.fuse_conv_bn(tresnet.ResNet(50, class_num=1000,
                                         dataset="imagenet")).build("cpu")
    shapes = [tuple(p.shape) for p in tm.parameters()]
    assert sorted(shapes) == ref and len(ref) == 214
    size = [int(np.prod(s)) for s in shapes]
    assert sum(size) == 25_583_592
    for n, slot in ((2, 12_838_888), (4, 6_466_536)):
        axes = ShardedDataParallel().param_axes(shapes, n)
        assert sum(s for s, a in zip(size, axes) if a is not None) \
            == 25_489_408
        assert sum(s // n if a is not None else s
                   for s, a in zip(size, axes)) == slot


def _state_axes(ref_shardings):
    return [_axis(s) for s in jax.tree.leaves(ref_shardings)]


@pytest.mark.parametrize("method", ["sgd_momentum", "adam", "lbfgs"])
def test_opt_state_sharding_matches_reference(method):
    """SGD's velocity and Adam's m and v inherit the parameters' slicing
    and Adam's ``t`` stays replicated; LBFGS, whose update is not
    elementwise, keeps every leaf replicated in both packages."""
    params = _TREES["lenet5"]()
    mesh = _mesh(2)
    # the weights sliced, the biases (LBFGS's rho has the last one's
    # shape) replicated
    jz = JZeRO(min_size=1024)
    jmethod, tmethod = {
        "sgd_momentum": (JSGD(0.1, momentum=0.9), SGD(0.1, momentum=0.9)),
        "adam": (JAdam(), Adam()),
        "lbfgs": (JLBFGS(), LBFGS())}[method]
    ref = jz.opt_state_sharding(mesh, jax.eval_shape(jmethod.init_state,
                                                     params),
                                params, jz.param_sharding(mesh, params))
    leaves = [torch.empty(a.shape, device="meta")
              for a in jax.tree.leaves(params)]
    tz = ShardedDataParallel(min_size=1024)
    axes = (tz.param_axes(leaves, 2) if tmethod.supports_fused
            else [None] * len(leaves))
    got = tz.opt_state_sharding(tmethod.init_state(leaves), leaves, axes)
    assert set(_state_axes(ref)) != {None} or method == "lbfgs"
    if method == "lbfgs":
        assert set(_state_axes(ref)) == {None}
        flat = [a for v in got.values()
                for a in (v if isinstance(v, list) else [v])]
        assert set(flat) == {None}
        return
    for key, slots in got.items():
        want = _state_axes(ref[key])
        assert (slots if isinstance(slots, list) else [slots]) == want, key


def test_opt_state_sharding_ambiguous_shapes_match_reference():
    """Two same-shaped parameters with different slicings leave a state
    leaf of that shape replicated; a shape only one parameter has passes
    its axis on; scalars and unknown shapes stay replicated."""
    mesh = _mesh(2)
    shapes = [(4, 8), (4, 8), (6, 2)]
    specs = [P(None, "data"), P(), P("data", None)]
    params = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    state = {"amb": jax.ShapeDtypeStruct((4, 8), jnp.float32),
             "one": jax.ShapeDtypeStruct((6, 2), jnp.float32),
             "other": jax.ShapeDtypeStruct((3,), jnp.float32),
             "t": jax.ShapeDtypeStruct((), jnp.int32)}
    ref = JZeRO().opt_state_sharding(
        mesh, state, params, [NamedSharding(mesh, s) for s in specs])
    tstate = {k: torch.empty(v.shape, device="meta")
              for k, v in state.items()}
    got = ShardedDataParallel().opt_state_sharding(tstate, shapes,
                                                   [1, None, 0])
    assert got == {k: _axis(v) for k, v in ref.items()}
    assert got == {"amb": None, "one": 0, "other": None, "t": None}


@pytest.mark.parametrize("n", [2, 4])
def test_remap_matches_reference(n):
    """Whole LeNet-5 weights remapped through the host for a world of n:
    rank r's slices equal the reference's device r shards."""
    rs = np.random.RandomState(n)
    params = jax.tree.map(lambda a: rs.standard_normal(a.shape)
                          .astype(np.float32), _TREES["lenet5"]())
    placed = JZeRO(min_size=1).remap(_mesh(n), params)
    leaves = [torch.from_numpy(a) for a in jax.tree.leaves(params)]
    for r in range(n):
        got = ShardedDataParallel(min_size=1).remap(leaves, leaves, n, r)
        dev = jax.devices()[r]
        for t, arr in zip(got, jax.tree.leaves(placed)):
            shard = [s for s in arr.addressable_shards if s.device == dev]
            assert np.array_equal(t.numpy(), np.asarray(shard[0].data))


# -- two gloo ranks against the JAX Optimizer ---------------------------------

_WORKER = '''
import os, pickle, sys
import torch
from bigdl_torch import Engine
import bigdl_torch.nn as nn
from bigdl_torch.common import DTypePolicy, get_policy, set_policy
from bigdl_torch.dataset import DataSet, Sample
from bigdl_torch.models import resnet as mod
from bigdl_torch.optim import EMA, LBFGS, SGD, Adam, Optimizer, Trigger
from bigdl_torch.parallel import (DataParallel, ShardedDataParallel,
                                  measure_collective_seconds)
from bigdl_torch.utils.convert import (load_reference_tree,
                                       to_reference_opt_state,
                                       to_reference_tree)

METHODS = {"sgd": lambda: SGD(0.1, momentum=0.9, weight_decay=1e-4),
           "adam": lambda: Adam(1e-2),
           "ema": lambda: EMA(SGD(0.1, momentum=0.9), 0.5),
           "lbfgs": lambda: LBFGS(0.1)}
job = pickle.load(open(sys.argv[1], "rb"))
torch.set_num_threads(1)    # two ranks share the host's cores
Engine.init(device="cpu")
samples = [Sample.from_ndarray(a, b) for a, b in zip(job["x"], job["y"])]
out = {"rank": Engine.rank(), "world": Engine.world(), "runs": {}}
wire = get_policy()
for run in job["runs"]:
    os.environ.update(run.get("env", {}))
    set_policy(DTypePolicy(wire_dtype=None) if run.get("f32") else wire)
    model = _small_resnet(mod, nn, True).build("cpu")
    load_reference_tree(model, job["params"], job["state"])
    strategy = (ShardedDataParallel(min_size=job["min_size"])
                if run["zero"] else DataParallel())
    method = METHODS[run["method"]]()
    losses, first = {}, []
    def end(state):
        first.append(state["neval"])
        if state["neval"] > first[0]:
            losses[state["neval"] - 1] = state["loss"]
        return state["neval"] > job["steps"]
    opt = Optimizer(model, DataSet.array(samples, distributed=True),
                    nn.CrossEntropyCriterion(), batch_size=job["batch"],
                    strategy=strategy).set_optim_method(method)
    if run.get("accum"):
        opt.set_gradient_accumulation(run["accum"])
    if run.get("clip"):
        opt.set_gradient_clipping_by_l2_norm(run["clip"])
    if run.get("ckpt"):
        opt.set_checkpoint(run["ckpt"], Trigger(
            lambda s: s["neval"] - 1 == 2, "after2"))
    if run.get("resume"):
        opt.resume_from(*run["resume"])
    Engine.clear_counts()
    opt.set_end_when(Trigger(end, "steps")).optimize()
    params, state = to_reference_tree(model)
    steps = Engine.collectives()
    whole = opt.final_opt_state     # under ZeRO its first read gathers
    out["runs"][run["name"]] = {
        "losses": losses, "params": params, "state": state,
        "collectives": steps,
        "final_gathers": Engine.collectives()["all_gather"].get(
            "opt_state", 0) - steps["all_gather"].get("opt_state", 0),
        "state_bytes": opt.opt_state_bytes,
        "opt_state": to_reference_opt_state(model, method, whole),
        "again": opt.final_opt_state is whole}
    for k in run.get("env", {}):
        del os.environ[k]
if job.get("probe"):
    ps = list(model.parameters())
    out["collective_s"] = [measure_collective_seconds(ps, torch.float32, mb)
                           for mb in (0, 0.002)]
pickle.dump(out, open(job["out"] + "." + str(Engine.rank()), "wb"))
Engine.reset()
'''

FUSED = {"BIGDL_TORCH_FUSED_UPDATE": "1"}
BUCKETS = {"BIGDL_TORCH_WIRE_BUCKET_MB": "0.002"}


def _initial():
    jm = _small_resnet(jresnet, jnn, True)
    jm.build(jax.random.key(0))
    return jax.tree.map(np.asarray, (jm.params, jm.state))


def _job(runs, **kw):
    params, state = _initial()
    x, y = _data(2 * LOCAL_BATCH)
    return dict(params=params, state=state, x=x, y=y, runs=runs,
                batch=LOCAL_BATCH, min_size=MIN_SIZE, steps=STEPS, **kw)


_JMETHODS = {"sgd": lambda: JSGD(0.1, momentum=0.9, weight_decay=1e-4),
             "adam": lambda: JAdam(1e-2),
             "ema": lambda: JEMA(JSGD(0.1, momentum=0.9), 0.5)}


def _jax_run(method, accum=1, clip=None, ckpt=None, resume=None):
    """The JAX Optimizer under ShardedDataParallel on the 8-device mesh at
    batch 16 (every step sees every row): (losses by iteration, model)."""
    jm = _small_resnet(jresnet, jnn, True)
    jm.build(jax.random.key(0))
    x, y = _data(2 * LOCAL_BATCH)
    JEngine.init()
    losses, first = {}, []

    def end(state):
        first.append(state["neval"])
        if state["neval"] > first[0]:
            losses[state["neval"] - 1] = state["loss"]
        return state["neval"] > STEPS
    opt = JOptimizer(jm, JDataSet.array(
        [JSample.from_ndarray(x[i], y[i]) for i in range(len(x))]),
        jnn.CrossEntropyCriterion(), batch_size=2 * LOCAL_BATCH,
        strategy=JZeRO(min_size=MIN_SIZE))
    opt.set_optim_method(_JMETHODS[method]())
    if accum > 1:
        opt.set_gradient_accumulation(accum)
    if clip:
        opt.set_gradient_clipping_by_l2_norm(clip)
    if ckpt:
        opt.set_checkpoint(ckpt, JTrigger(lambda s: s["neval"] - 1 == 2,
                                          "after2"))
    if resume:
        opt.resume_from(*resume)
    opt.set_end_when(JTrigger(end, "steps")).optimize()
    return losses, (jm.params, jm.state)


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


def _close(run, losses, tree, tol=TRAIN_TOL):
    """``run``'s losses and (params, state) within ``tol`` of ``losses``
    and ``tree``."""
    assert sorted(run["losses"]) == sorted(losses)
    for k in losses:
        assert abs(run["losses"][k] - losses[k]) <= tol, (run["losses"],
                                                          losses)
    got, want = _leaves((run["params"], run["state"])), _leaves(tree)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol)


def _tree(run):
    return run["params"], run["state"]


def _same(a, b):
    assert a["losses"] == b["losses"]
    for x, y in zip(_leaves((a["params"], a["state"], a["opt_state"])),
                    _leaves((b["params"], b["state"], b["opt_state"]))):
        assert np.array_equal(x, y)


def _plan_numel():
    """Elements each of two ranks updates under the reference's plan."""
    shapes = [tuple(a.shape) for a in jax.tree.leaves(_initial()[0])]
    axes = JZeRO(min_size=MIN_SIZE).param_sharding(
        _mesh(2), [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes])
    size = [int(np.prod(s)) for s in shapes]
    return sum(n // 2 if _axis(a) is not None else n
               for n, a in zip(size, axes)), sum(size)


def test_two_ranks_zero_like_reference(tmp_path):
    """Two gloo ranks under ZeRO against the JAX Optimizer under
    ShardedDataParallel (SGD with momentum and weight decay; Adam; EMA of
    SGD with accumulation 2 and L2-norm clipping), and against the port's
    own DataParallel, the fused update and the buckets; ranks bit-equal,
    each holding exactly the plan's state bytes, collective counts
    exact."""
    def run(name, zero, method, **kw):
        return dict(name=name, zero=zero, method=method, **kw)
    both = {**FUSED, **BUCKETS}
    runs = [run("dp", False, "sgd"),
            run("dp_buckets", False, "sgd", env=BUCKETS),
            run("zero", True, "sgd"),
            run("zero_fused_buckets", True, "sgd", env=both),
            run("zero_adam", True, "adam"),
            run("zero_adam_fused_buckets", True, "adam", env=both),
            run("zero_ema", True, "ema", accum=2, clip=CLIP),
            # float32, no wire: a bf16 rounding cannot flip on the
            # norm's last bits
            run("zero_ema_f32", True, "ema", accum=2, clip=CLIP, f32=True),
            run("dp_ema_f32_buckets", False, "ema", accum=2, clip=CLIP,
                f32=True, env=BUCKETS),
            run("zero_lbfgs", True, "lbfgs")]
    wait = _spawn_ranks(_job(runs, probe=True), tmp_path, worker=_WORKER)
    refs = {"zero": _jax_run("sgd"), "zero_adam": _jax_run("adam"),
            "zero_ema": _jax_run("ema", accum=2, clip=CLIP)}
    r0, r1 = wait()
    assert (r0["rank"], r1["rank"], r0["world"]) == (0, 1, 2)
    for name in r0["runs"]:
        _same(r0["runs"][name], r1["runs"][name])
    got = r0["runs"]
    for name, (losses, tree) in refs.items():
        _close(got[name], losses, tree)
    for a, b in (("dp_buckets", "dp"), ("zero", "dp"),
                 ("zero_fused_buckets", "zero"),
                 ("zero_adam_fused_buckets", "zero_adam")):
        _same(got[a], got[b])
    # the EMA's shadow gathered whole, the clipping norm summed otherwise
    _close(got["zero_ema_f32"], got["dp_ema_f32_buckets"]["losses"],
           _tree(got["dp_ema_f32_buckets"]), tol=CLIP_RTOL)
    for a, b in zip(_leaves(got["zero_ema_f32"]["opt_state"]),
                    _leaves(got["dp_ema_f32_buckets"]["opt_state"])):
        np.testing.assert_allclose(a, b, atol=CLIP_RTOL, rtol=CLIP_RTOL)
    own, whole = _plan_numel()
    assert own < whole
    nbytes = {k: v["state_bytes"] for k, v in got.items()}
    assert nbytes["dp"] == 4 * whole and nbytes["zero"] == 4 * own
    assert nbytes["zero_adam"] == nbytes["zero_ema"] == 2 * 4 * own
    lbfgs = LBFGS(0.1).init_state([torch.empty(a.shape) for a in
                                   jax.tree.leaves(_initial()[0])])
    assert nbytes["zero_lbfgs"] == opt_state_nbytes(lbfgs)
    # collectives over the steps: under ZeRO one reduce-scatter, one
    # all-reduce (the replicated leaves and the loss) and one all-gather a
    # step; a bucket one all-reduce a step; clipping one all-reduce of the
    # norm.  The whole final state: one gather of every slot at its first
    # read, none after
    n_bn = sum(isinstance(m, tnn.BatchNormalization)
               for m in _small_resnet(tresnet, tnn, True).modules())
    bn = {"bn_stats": n_bn * STEPS, "bn_grad_stats": n_bn * STEPS}
    assert got["zero"]["collectives"] == {
        "all_reduce": {**bn, "grads": STEPS},
        "reduce_scatter": {"grads": STEPS},
        "all_gather": {"params": STEPS}}
    assert got["zero_adam"]["collectives"]["all_gather"] == {
        "params": STEPS}
    assert {k: v["final_gathers"] for k, v in got.items()} == {
        k: int(k.startswith("zero") and k != "zero_lbfgs") for k in got}
    assert all(v["again"] for v in got.values())
    assert got["zero_ema"]["collectives"]["all_reduce"] == {
        "bn_stats": 2 * n_bn * STEPS, "bn_grad_stats": 2 * n_bn * STEPS,
        "grads": STEPS, "clip_norm": STEPS}
    model = _small_resnet(tresnet, tnn, True).build("cpu")
    n_buckets = bucket_count(list(model.parameters()), torch.float32,
                             float(BUCKETS["BIGDL_TORCH_WIRE_BUCKET_MB"]))
    assert n_buckets > 3
    assert got["dp_buckets"]["collectives"] == {
        "all_reduce": {**bn, "grads": n_buckets * STEPS},
        "reduce_scatter": {}, "all_gather": {}}
    assert got["zero_lbfgs"]["collectives"]["reduce_scatter"] == {}
    assert got["zero_lbfgs"]["collectives"]["all_gather"] == {}
    assert all(s > 0 for s in r0["collective_s"])


def test_zero_checkpoints_move_both_ways(tmp_path):
    """A port ZeRO snapshot resumes in the port's DataParallel and in the
    reference's Optimizer, and a reference ZeRO snapshot in the port's
    ZeRO run: one step on, each within TRAIN_TOL of an uninterrupted
    run."""
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_losses, ref_tree = _jax_run("sgd", ckpt=ref_dir)
    ref_snap = (os.path.join(ref_dir, "model.2"),
                os.path.join(ref_dir, "optimMethod.2"))
    port_snap = (os.path.join(port_dir, "model.2"),
                 os.path.join(port_dir, "optimMethod.2"))
    runs = [dict(name="zero", zero=True, method="sgd", ckpt=port_dir),
            dict(name="dp_from_zero", zero=False, method="sgd",
                 resume=port_snap),
            dict(name="zero_from_ref", zero=True, method="sgd",
                 resume=ref_snap)]
    r0, r1 = _spawn_ranks(_job(runs), tmp_path, worker=_WORKER)()
    for name in r0["runs"]:
        _same(r0["runs"][name], r1["runs"][name])
    got = r0["runs"]
    _close(got["zero"], ref_losses, ref_tree)
    last = {STEPS: got["zero"]["losses"][STEPS]}
    _close(got["dp_from_zero"], last, _tree(got["zero"]))
    _close(got["zero_from_ref"], {STEPS: ref_losses[STEPS]}, ref_tree)
    jlosses, (jparams, jstate) = _jax_run("sgd", resume=port_snap)
    _close({"losses": jlosses, "params": jparams, "state": jstate}, last,
           _tree(got["zero"]))
    # the snapshot holds the reference's whole tree, not a rank's slices
    opt = got["zero"]["opt_state"]["velocity"]
    for v, p in zip(_leaves(opt), _leaves(got["zero"]["params"])):
        assert v.shape == p.shape


def test_zero_world_of_one_is_data_parallel():
    """In a world of one ZeRO slices every large leaf into one slice: the
    step's values equal DataParallel's bit for bit, and the own views are
    the parameters themselves."""
    model = _small_resnet(tresnet, tnn, True).build("cpu")
    Engine.init(device="cpu")
    z = ShardedDataParallel(min_size=MIN_SIZE)
    z.setup(model, SGD())
    params = list(model.parameters())
    own = z.own(params)
    assert all(torch.equal(a, b) and a.shape == b.shape
               for a, b in zip(own, params))
    assert z.own_shapes() == [tuple(p.shape) for p in params]
    state = {"velocity": [torch.randn_like(p) for p in params],
             "t": torch.tensor(3)}
    back = z.full_state(z.shard_state(state))
    assert back["t"] is state["t"]
    assert all(torch.equal(a, b) and a.shape == b.shape
               for a, b in zip(back["velocity"], state["velocity"]))
