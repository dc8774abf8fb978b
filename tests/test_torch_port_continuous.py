"""The port's train-to-serve deployment against the JAX package's.

- ``file_io.frame_fingerprint`` gives the same pair for files either
  package wrote; ``file_io.watch_lineage`` yields the same ids in the same
  order and backs off alike under one fake clock.
- Release entries pass both ways: the reference's ``read_release`` reads
  what the port's ``ReleasePublisher`` wrote and the other way round.
- ``Optimizer.set_checkpoint(publish=True, publish_every=2)`` on LeNet-5
  publishes the reference's release ids, epochs and iterations (and,
  with asynchronous writes, only once the snapshot is on storage).
- ``DeployController`` over a scripted stub server (as the reference's
  own tests drive it): it deploys, rejects a torn entry and a snapshot
  rewritten after publication, rolls back and freezes at its budget, with
  the reference's timeline (every field but the wall time).  Over a live
  CPU ``InferenceServer`` it canaries and promotes the trainer's releases
  and the server then answers bit for bit as ``Predictor`` does on the
  last release's weights.  A fleet target raises.
"""

import os
import pickle
import shutil
import threading
import time

import jax
import numpy as np
import pytest

import bigdl_tpu.nn as jnn
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.dataset import SampleToMiniBatch as JToBatch
from bigdl_tpu.models.lenet import LeNet5 as JLeNet5
from bigdl_tpu.optim import Adam as JAdam
from bigdl_tpu.optim import Optimizer as JOptimizer
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu.serve import continuous as jct
from bigdl_tpu.utils import file_io as jio

import bigdl_torch.nn as tnn
from bigdl_torch.dataset import DataSet, Sample, SampleToMiniBatch
from bigdl_torch.models import LeNet5
from bigdl_torch.optim import Adam, Optimizer, Predictor, Trigger
from bigdl_torch.serve import InferenceServer
from bigdl_torch.serve import continuous as tct
from bigdl_torch.utils import file_io as tio
from bigdl_torch.utils.convert import load_reference_tree


def _wait(pred, timeout=15.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert pred(), "condition not reached in time"


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"params": [{"weight": rng.random((6, 2)).astype(np.float32),
                        "bias": rng.random(2).astype(np.float32)}],
            "state": [{}]}


# -- frame_fingerprint and watch_lineage ------------------------------------

@pytest.mark.parametrize("writer", ["ref", "port"])
def test_frame_fingerprint_agrees(tmp_path, writer):
    io = jio if writer == "ref" else tio
    p = str(tmp_path / "blob")
    io.save(_tree(0), p)
    fp = tio.frame_fingerprint(p)
    assert fp == jio.frame_fingerprint(p) and fp is not None
    assert fp[0] == os.path.getsize(p) - 20
    io.save(_tree(1), p)
    assert tio.frame_fingerprint(p) != fp
    raw = tmp_path / "legacy"
    raw.write_bytes(pickle.dumps({"w": 1}))
    short = tmp_path / "short"
    short.write_bytes(b"x")
    for path in (raw, short):
        assert tio.frame_fingerprint(str(path)) is None
        assert jio.frame_fingerprint(str(path)) is None


def _watch(io, d, **kw):
    t = [0.0]
    sleeps, got = [], []

    def clock():
        return t[0]

    def sleep(s):
        sleeps.append(round(s, 9))
        t[0] += max(s, 1e-3)

    for n, p in io.watch_lineage(d, since=kw.pop("since", 0),
                                 pattern=jct.RELEASE_PATTERN, clock=clock,
                                 sleep=sleep, idle_timeout=1.0, **kw):
        got.append((n, os.path.basename(p)))
        if n == 2:
            with open(os.path.join(d, "release.9"), "wb") as f:
                f.write(b"z")
    return got, sleeps


@pytest.mark.parametrize("since", [0, 1])
def test_watch_lineage_agrees(tmp_path, since):
    got = []
    for io in (jio, tio):
        d = tmp_path / f"lin{len(got)}"
        d.mkdir()
        for name in ("release.2", "release.1", "release.3.corrupt",
                     "release.4.tmp", "model.5"):
            (d / name).write_bytes(b"x")
        got.append(_watch(io, str(d), since=since))
    assert got[0] == got[1]
    ids = [n for n, _ in got[1][0]]
    assert ids == ([1, 2, 9] if since == 0 else [2, 9])
    assert got[1][1] and got[1][1][1] > got[1][1][0]   # backs off


def test_watch_lineage_stop_and_missing_dir(tmp_path):
    out = list(tio.watch_lineage(str(tmp_path / "none"), clock=lambda: 0,
                                 sleep=lambda s: None, stop=lambda: True))
    assert out == []


# -- release entries, both ways -----------------------------------------------

@pytest.mark.parametrize("writer", ["ref", "port"])
def test_release_entries_cross_read(tmp_path, writer):
    pub_mod, read_mod = (jct, tct) if writer == "ref" else (tct, jct)
    io = jio if writer == "ref" else tio
    snap = str(tmp_path / "model.3")
    io.save(_tree(3), snap)
    (tmp_path / "release.4.corrupt").write_bytes(b"q")   # ids skip past it
    pub = pub_mod.ReleasePublisher(str(tmp_path), clock=lambda: 12.5)
    assert pub.publish(snap, neval=3, epoch=1,
                       metrics={"loss": 0.5}) == 5
    entry = read_mod.read_release(str(tmp_path / "release.5"))
    assert entry["format"] == "bigdl_tpu-release-v1"
    assert (entry["release_id"], entry["neval"], entry["epoch"],
            entry["iteration"], entry["metrics"], entry["model_name"],
            entry["wall_time"]) == (5, 3, 1, 3, {"loss": 0.5}, "model.3",
                                    12.5)
    assert tuple(entry["fingerprint"]) == tio.frame_fingerprint(snap)
    io.save({"format": "something else"}, str(tmp_path / "release.6"))
    with pytest.raises(read_mod.ReleaseRejected, match="not a release"):
        read_mod.read_release(str(tmp_path / "release.6"))


def test_publish_chaos_corrupts_the_framed_entry(tmp_path):
    from bigdl_torch.utils import chaos
    snap = str(tmp_path / "model.1")
    tio.save(_tree(1), snap)
    with chaos.scoped("deploy.publish=corrupt@1"):
        tct.ReleasePublisher(str(tmp_path)).publish(snap, neval=1)
    with pytest.raises(tio.CorruptCheckpoint):
        tct.read_release(str(tmp_path / "release.1"))
    with pytest.raises(tct.ReleaseRejected, match="fingerprint"):
        tct.ReleasePublisher(str(tmp_path)).publish(
            str(tmp_path / "nope"), neval=2)


# -- the Optimizer publishes --------------------------------------------------

def _digits(n=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 28, 28, 1)).astype(np.float32)
    y = (np.arange(n) % 10).astype(np.int32)   # 0-based, as the reference
    return x, y


def _releases(d):
    out = []
    for name in sorted(os.listdir(d)):
        if name.startswith("release.") and name[8:].isdigit():
            e = jct.read_release(os.path.join(d, name))
            out.append((e["release_id"], e["epoch"], e["iteration"],
                        e["neval"], e["model_name"]))
            assert tuple(e["fingerprint"]) == \
                jio.frame_fingerprint(e["model_path"])
            assert "loss" in e["metrics"]
    return sorted(out)


def _port_publishing_run(d, async_write=False):
    x, y = _digits()
    ds = DataSet.array([Sample(a, b) for a, b in zip(x, y)]).transform(
        SampleToMiniBatch(16, drop_last=True))
    import torch
    opt = (Optimizer(LeNet5(10).build("cpu",
                                      torch.Generator().manual_seed(0)),
                     ds, tnn.ClassNLLCriterion(), device="cpu")
           .set_optim_method(Adam(1e-3))
           .set_end_when(Trigger.max_epoch(2)))
    opt.set_checkpoint(str(d), Trigger.several_iteration(1),
                       async_write=async_write, publish=True,
                       publish_every=2)
    opt.optimize()
    return opt


def test_optimizer_publishes_the_reference_releases(tmp_path):
    x, y = _digits()
    jds = JDataSet.array([JSample(a, b) for a, b in zip(x, y)]).transform(
        JToBatch(16, drop_last=True))
    jopt = (JOptimizer(JLeNet5(10), jds, jnn.ClassNLLCriterion())
            .set_optim_method(JAdam(1e-3))
            .set_end_when(JTrigger.max_epoch(2)))
    jopt.set_checkpoint(str(tmp_path / "ref"),
                        JTrigger.several_iteration(1), publish=True,
                        publish_every=2)
    jopt.optimize()
    opt = _port_publishing_run(tmp_path / "port")
    ref, port = _releases(tmp_path / "ref"), _releases(tmp_path / "port")
    assert port == ref and len(port) >= 2
    assert opt._publisher.published == len(port)
    assert [r[0] for r in port] == list(range(1, len(port) + 1))


def test_optimizer_publishes_after_async_writes(tmp_path):
    sync_dir, async_dir = tmp_path / "sync", tmp_path / "async"
    _port_publishing_run(sync_dir)
    _port_publishing_run(async_dir, async_write=True)
    n = len(_releases(sync_dir))
    _wait(lambda: os.path.exists(async_dir / f"release.{n}"))
    assert _releases(async_dir) == _releases(sync_dir)


# -- the deploy controller ------------------------------------------------------

class _StubServer:
    """swap/stats target answering the canary verdicts a test scripts."""

    def __init__(self, default="promoted", decisions=None):
        self.swaps = []
        self.default = default
        self.decisions = dict(decisions or {})
        self.deploy = None
        self._vid = 1

    def attach_deploy(self, controller):
        self.deploy = controller

    def swap(self, source, canary_fraction=None):
        self._vid += 1
        self.swaps.append((os.path.basename(str(source)), canary_fraction))
        return self._vid

    def stats(self):
        state = self.decisions.get(len(self.swaps), self.default)
        return {"canary": {"version": self._vid, "state": state,
                           "reason": "scripted", "routed": 1, "total": 4}}


def _lineage(root):
    """A lineage the reference's publisher writes: good, torn, quarantined,
    good, a snapshot rewritten after publication, good."""
    src = root / "src"
    src.mkdir()
    for n in (1, 2, 3):
        jio.save(_tree(n), str(src / f"model.{n}"))
    pub = jct.ReleasePublisher(str(src))
    pub.publish(str(src / "model.1"), neval=1)
    framed = jio.frame_bytes(pickle.dumps({"format": "bigdl_tpu-"
                                                     "release-v1"}))
    (src / "release.2").write_bytes(framed[20:])
    (src / "release.3.corrupt").write_bytes(framed)
    pub._next = 4
    pub.publish(str(src / "model.2"), neval=2)
    pub.publish(str(src / "model.3"), neval=3)
    jio.save(_tree(33), str(src / "model.3"))      # rewritten: new CRC
    pub.publish(str(src / "model.2"), neval=4)
    return src


def _drive(mod, lineage, root, name, srv, **kw):
    d = root / name
    shutil.copytree(lineage, d)
    ctl = mod.DeployController(srv, str(d), poll_s=0.01, **kw).start()
    try:
        _wait(lambda: not ctl.healthy() or
              ctl.stats()["seen"] >= 4)
        time.sleep(0.1)
    finally:
        ctl.stop()
    timeline = []
    for e in ctl.versions()["timeline"]:
        e = {k: v for k, v in e.items() if k != "time"}
        if "reason" in e:
            e["reason"] = e["reason"].replace(str(d), "<dir>")
        timeline.append(e)
    st = {k: v for k, v in ctl.stats().items()
          if k not in ("watching", "timeline")}
    return timeline, st, srv.swaps, sorted(os.listdir(d))


@pytest.mark.parametrize("scenario", ["full_swaps", "canary_promote",
                                      "rollback_freeze", "promote_resets"])
def test_controller_timeline_equal(tmp_path, scenario):
    lineage = _lineage(tmp_path)
    kw = {"full_swaps": dict(canary_fraction=0),
          "canary_promote": dict(canary_fraction=0.25),
          "rollback_freeze": dict(canary_fraction=0.25, rollback_budget=1),
          "promote_resets": dict(canary_fraction=0.5,
                                 rollback_budget=1)}[scenario]
    stub = {"rollback_freeze": dict(default="rolled_back"),
            "promote_resets": dict(default="rolled_back",
                                   decisions={1: "promoted"})}.get(
        scenario, {})
    a = _drive(jct, lineage, tmp_path, "ref", _StubServer(**stub), **kw)
    b = _drive(tct, lineage, tmp_path, "port", _StubServer(**stub), **kw)
    assert a == b
    timeline, st, swaps, names = b
    actions = [(e["release"], e["action"]) for e in timeline]
    assert (2, "rejected") in actions and "release.2.corrupt" in names
    if scenario == "rollback_freeze":
        assert st["frozen"] and actions[-1][1] == "frozen"
        assert "consecutive canary rollbacks" in st["frozen_reason"]
    else:
        assert (5, "rejected") in actions
        fp = [e for e in timeline if e["release"] == 5][0]
        assert "fingerprint" in fp["reason"]
        assert [s[0] for s in swaps] == ["model.1", "model.2", "model.2"]


def test_controller_refuses_a_fleet_target(tmp_path):
    class Fleet(_StubServer):
        fleet = True
    with pytest.raises(NotImplementedError, match="item 5"):
        tct.DeployController(Fleet(), str(tmp_path))


def test_live_server_canaries_and_promotes_the_trainer(tmp_path):
    d = tmp_path / "ckpt"
    opt = _port_publishing_run(d)
    n = opt._publisher.published
    jm = JLeNet5(10).build(jax.random.key(5))
    arch = load_reference_tree(LeNet5(10).build("cpu"),
                               jax.tree.map(np.asarray, jm.params),
                               jax.tree.map(np.asarray, jm.state))
    x = _digits(8, seed=4)[0]
    server = InferenceServer(arch, device="cpu", example=x[0], max_batch=1,
                             max_wait_ms=1, canary_min_batches=2,
                             clock=lambda: 0.0).start()
    ctl = tct.DeployController(server, str(d), canary_fraction=0.5,
                               poll_s=0.01).start()
    done = threading.Event()

    def traffic():
        i = 0
        while not done.is_set():
            server.submit(x[i % len(x)]).result(30)
            i += 1

    t = threading.Thread(target=traffic, daemon=True)
    t.start()
    try:
        _wait(lambda: ctl.stats()["promoted"] >= n)
    finally:
        done.set()
        t.join(10)
        ctl.stop()
    try:
        st = server.stats()
        assert st["deploy"]["healthy"] and st["deploy"]["promoted"] == n
        assert st["version"] == 1 + n
        last = jct.read_release(str(d / f"release.{n}"))
        blob = jio.load(last["model_path"])
        ref = load_reference_tree(LeNet5(10).build("cpu"), blob["params"],
                                  blob["state"])
        want = Predictor(ref, device="cpu")
        for row in x:
            np.testing.assert_array_equal(server.predict(row, timeout=30),
                                          want.predict(row[None])[0])
    finally:
        server.stop()
