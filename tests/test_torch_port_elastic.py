"""Elastic training on the port, held to the JAX package on the CPU:
``parallel/elastic.py``, the supervisor's peer half, the Engine's logical
topology and the Optimizer's shrink, grow and join.

- Every case of ``tests/test_elastic.py`` has a counterpart here: the
  lineage survey and negotiation, the intents, detection by publication
  silence, heartbeat hygiene, the grow protocol, the Engine's topology,
  the batch rescale, arming without a fault, the in-process recovery and
  the two drills with processes (``bigdl_torch/tools/elastic_smoke.py``
  with ``--device cpu``).
- The protocol files cross-read: lineage entries, intents, views,
  heartbeats, join intents and grow offers written by either package are
  read by the other, and ``negotiate`` reaches the same plan from them.
- The reference's multi-axis mesh re-forms have no counterpart (the port
  runs one device per process): a live group refuses to re-form, typed,
  and ``reform(devices=)`` takes the one device.
- A logical world-2 rank without a group steps exactly like a world-1 run
  on its shard: nothing divides by the logical world.
"""

import json
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from bigdl_tpu.parallel import elastic as jel
from bigdl_tpu.utils import file_io as jio
from bigdl_tpu.utils import supervisor as jsup
from bigdl_tpu.utils.engine import Engine as JEngine

import bigdl_torch.nn as nn
from bigdl_torch.common import set_seed
from bigdl_torch.dataset import DataSet, Sample, SampleToMiniBatch
from bigdl_torch.optim import SGD, Adam, Optimizer, Predictor, Trigger
from bigdl_torch.optim.optimizer import _ElasticJoinSignal, _find_batchers
from bigdl_torch.parallel import elastic as tel
from bigdl_torch.parallel.sharding import ShardedDataParallel
from bigdl_torch.utils import chaos, file_io, telemetry
from bigdl_torch.utils import supervisor as tsup
from bigdl_torch.utils.engine import Engine, GroupReformError

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the drills' own limit, and the test's around it
DRILL_TIMEOUT_S = 80
#: the peer-lost threshold the drills run with: wide against the pace,
#: so a rank slowed by a loaded host is not taken for a lost one; the
#: paces and epochs below keep rank 0 training well past its rank's
#: death (shrink) and the joiner's start (grow) on a loaded host
DRILL_PEER_LOST_S = 2.0

PACKAGES = {"ref": (jel, jio), "port": (tel, file_io)}


@pytest.fixture(autouse=True)
def _clean():
    chaos.clear()
    yield
    chaos.clear()
    tsup.set_active(None)
    telemetry.set_active(None)
    Engine.reset()


def _write_lineage(io, path, nevals):
    for n in nevals:
        io.save_checkpoint(str(path), n,
                           {"params": {"w": np.arange(4.0) + n},
                            "state": {}},
                           {"method": {}, "driver_state": {}})


def _both(tmp_path, nevals):
    """The same lineage written by each package into its own dir."""
    out = {}
    for name, (_, io) in PACKAGES.items():
        d = tmp_path / name
        d.mkdir()
        _write_lineage(io, d, nevals)
        out[name] = str(d)
    return out


# -- lineage negotiation (files only) ----------------------------------------

def test_survey_lists_valid_entries_newest_first(tmp_path):
    dirs = _both(tmp_path, [3, 5, 8])
    for name, d in dirs.items():
        assert tel.survey(d) == jel.survey(d) == [8, 5, 3], name


def test_survey_excludes_corrupt_entries_without_quarantining(tmp_path):
    dirs = _both(tmp_path, [3, 5])
    for d in dirs.values():
        p = os.path.join(d, "model.5")
        data = open(p, "rb").read()
        with open(p, "wb") as f:
            f.write(data[:10] + bytes([data[10] ^ 0xFF]) + data[11:])
        assert tel.survey(d) == jel.survey(d) == [3]
        assert os.path.exists(p)


def test_negotiate_single_survivor_picks_newest(tmp_path):
    dirs = _both(tmp_path, [3, 5, 8])
    plans = {name: mod.negotiate(dirs[name], rank=0, survivors=[0],
                                 epoch=1, timeout=0.1, poll=0.01)
             for name, (mod, _) in PACKAGES.items()}
    for plan in plans.values():
        assert plan.neval == 8 and plan.model_path.endswith("model.8")
        assert plan.survivors == (0,)


def _plan_fields(plan):
    return (plan.neval, os.path.basename(plan.model_path),
            os.path.basename(plan.optim_path), plan.survivors, plan.epoch)


def test_negotiate_disjoint_newest_entries(tmp_path):
    """Rank 1's view (published by the OTHER package) lacks entry 8: both
    negotiate entry 5 and quarantine the tail."""
    dirs = _both(tmp_path, [3, 5, 8])
    plans = {}
    for name, (mod, _) in PACKAGES.items():
        other = jel if mod is tel else tel
        other.publish_lineage_view(dirs[name], 1, 2, [5, 3])
        plans[name] = mod.negotiate(dirs[name], rank=0, survivors=[0, 1],
                                    epoch=2, timeout=1.0, poll=0.01)
        d = dirs[name]
        assert os.path.exists(os.path.join(d, "model.8.corrupt"))
        assert os.path.exists(os.path.join(d, "optimMethod.8.corrupt"))
        assert not os.path.exists(os.path.join(d, "model.8"))
        assert tel.survey(d)[0] == jel.survey(d)[0] == 5
    assert _plan_fields(plans["ref"]) == _plan_fields(plans["port"])
    assert plans["port"].neval == 5


def test_negotiate_corrupt_on_one_rank_skipped_cluster_wide(tmp_path):
    dirs = _both(tmp_path, [3, 5, 8])
    for name, (mod, _) in PACKAGES.items():
        mod.publish_lineage_view(dirs[name], 1, 4, [5, 3])
        plan = mod.negotiate(dirs[name], rank=0, survivors=[0, 1], epoch=4,
                             my_valid=[8, 5, 3], timeout=1.0, poll=0.01)
        assert plan.neval == 5
        assert os.path.exists(os.path.join(dirs[name], "model.8.corrupt"))


def _fake_time():
    fake = {"t": 0.0}
    return (fake, lambda: fake["t"],
            lambda s: fake.__setitem__("t", fake["t"] + s))


def test_negotiate_empty_lineage_typed_failure_no_hang(tmp_path):
    for name, (mod, _) in PACKAGES.items():
        fake, clock, sleep = _fake_time()
        with pytest.raises(mod.ElasticNegotiationError,
                           match="no checkpoint lineage entry"):
            mod.negotiate(str(tmp_path / name), rank=0, survivors=[0, 1],
                          epoch=1, timeout=5.0, poll=0.5, clock=clock,
                          sleep=sleep)
        assert fake["t"] >= 5.0


def test_negotiate_drops_silent_survivor_after_timeout(tmp_path):
    dirs = _both(tmp_path, [3, 5])
    for name, (mod, _) in PACKAGES.items():
        _, clock, sleep = _fake_time()
        plan = mod.negotiate(dirs[name], rank=0, survivors=[0, 1], epoch=1,
                             timeout=2.0, poll=0.5, clock=clock, sleep=sleep)
        assert plan.neval == 5 and plan.survivors == (0,)


def test_joiner_divergent_tail_quarantined_then_adopted(tmp_path):
    """The port's joiner (rank 1) against the reference's survivor (rank
    0), in one dir: the joiner adopts 5 without touching the tail, the
    survivor's own round quarantines it."""
    d = str(tmp_path)
    _write_lineage(jio, d, [3, 5, 8])
    jel.publish_lineage_view(d, 0, 7, [5, 3])
    plan = tel.negotiate(d, rank=1, survivors=[0, 1], epoch=7,
                         my_valid=[8, 5, 3], timeout=1.0, poll=0.01)
    assert plan.neval == 5 and plan.survivors == (0, 1)
    assert plan.model_path.endswith("model.5")
    assert os.path.exists(os.path.join(d, "model.8"))
    plan0 = jel.negotiate(d, rank=0, survivors=[0, 1], epoch=7,
                          my_valid=[5, 3], timeout=1.0, poll=0.01)
    assert plan0.neval == 5
    assert os.path.exists(os.path.join(d, "model.8.corrupt"))
    assert not os.path.exists(os.path.join(d, "model.8"))
    assert tel.survey(d)[0] == 5


def test_stale_intents_from_previous_rounds_ignored(tmp_path):
    d = str(tmp_path)
    tel.publish_intent(d, 1, epoch=1, lost=[2], wall_time=0.0)
    jel.publish_intent(d, 2, epoch=3, lost=[0], wall_time=0.0)
    for mod in (tel, jel):
        intents = mod.read_intents(d, min_epoch=2)
        assert list(intents) == [2] and intents[2]["lost"] == [0]
        assert mod.read_intents(d, min_epoch=2, exclude_rank=2) == {}


# -- the protocol files, cross-read ------------------------------------------

def _heartbeat(sup_mod, peer_dir, rank, now, generation=0):
    sup = sup_mod.Supervisor({}, peer_dir=peer_dir, rank=rank, world=2,
                             wall_clock=lambda: now, publish_interval=0.0,
                             generation=generation)
    sup.beat("step")
    sup._publish_heartbeat()


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_protocol_files_cross_read(tmp_path, writer):
    """Everything one package writes, the other reads the same way, and
    the reader's negotiation reaches the writer's plan."""
    wmod, wio = PACKAGES[writer]
    rmod = tel if wmod is jel else jel
    wsup = jsup if wmod is jel else tsup
    rsup = tsup if wmod is jel else jsup
    d = str(tmp_path)
    _write_lineage(wio, d, [3, 5, 8])
    wmod.publish_intent(d, 1, epoch=2, lost=[2], wall_time=5.0)
    wmod.publish_lineage_view(d, 1, 2, [5, 3])
    wmod.publish_join_intent(d, 2, 6.0, generation=3)
    wmod.publish_grow_offer(d, 0, 4, [0, 2], 7.0)
    _heartbeat(wsup, os.path.join(d, "heartbeats"), 1, 100.0, generation=2)
    assert rmod.survey(d) == wmod.survey(d) == [8, 5, 3]
    assert rmod.read_intents(d, min_epoch=1) == wmod.read_intents(d, 1)
    assert rmod.read_lineage_view(d, 1, 2) == wmod.read_lineage_view(d, 1, 2)
    assert rmod.read_join_intents(d) == wmod.read_join_intents(d)
    assert rmod.latest_grow_epoch(d) == 4
    assert rmod.read_grow_offer(d, 0, rank=2) == \
        wmod.read_grow_offer(d, 0, rank=2)
    assert rmod.previous_generation(d, 1) == 2
    assert rmod.death_certificate(d, 2) == wmod.death_certificate(d, 2) == 2
    assert rmod.cluster_position(d) is None
    reader = rsup.Supervisor({}, peer_dir=os.path.join(d, "heartbeats"),
                             rank=0, world=2, peer_stale=5.0,
                             wall_clock=lambda: 107.0)
    assert reader.check_peers() == {1: pytest.approx(7.0)}
    plan = rmod.negotiate(d, rank=0, survivors=[0, 1], epoch=2,
                          my_valid=[8, 5, 3], timeout=1.0, poll=0.01)
    assert plan.neval == 5 and plan.survivors == (0, 1)
    # the reader's published view reads back on the writer's side
    assert wmod.read_lineage_view(d, 0, 2)["valid"] == [8, 5, 3]


def test_protocol_files_have_the_reference_fields(tmp_path):
    """The JSON docs of each call are the reference's, field for field."""
    docs = {}
    for name, (mod, _) in PACKAGES.items():
        d = str(tmp_path / name)
        mod.publish_intent(d, 1, epoch=2, lost=[3, 2], wall_time=5.0)
        mod.publish_lineage_view(d, 1, 2, [3, 8, 5])
        mod.publish_join_intent(d, 2, 6.0, generation=3)
        mod.publish_grow_offer(d, 0, 4, [2, 0], 7.0)
        mod.announce_join(d, 4, 9.0)
        edir = mod.elastic_dir(d)
        docs[name] = {f: json.load(open(os.path.join(edir, f)))
                      for f in sorted(os.listdir(edir))}
        docs[name]["heartbeat.4"] = json.load(
            open(os.path.join(d, "heartbeats", "heartbeat.4")))
    assert docs["port"] == docs["ref"]


# -- detection: publication silence -> PeerLostError ------------------------

def _lost_supervisor(ckpt, rank, wall, **kw):
    return tsup.Supervisor({}, peer_dir=os.path.join(ckpt, "heartbeats"),
                           rank=rank, world=2, peer_stale=5.0,
                           peer_lost=10.0, wall_clock=lambda: wall["now"],
                           publish_interval=0.0, lineage_dir=ckpt,
                           poll_interval=0.05, **kw)


def _supervised_wait(sup, name):
    caught = {}

    def worker():
        sup.beat("step")
        try:
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                time.sleep(0.01)
            caught["err"] = None
        except tel.PeerLostError as e:
            caught["err"] = e
    t = threading.Thread(target=worker, name=name)
    t.start()
    time.sleep(0.1)
    return t, caught


def test_peer_lost_promotion_raises_and_publishes_intent(tmp_path):
    """The reference's rank 1 goes publication-silent; the port's rank 0
    raises PeerLostError into its supervised thread and publishes the
    intent the reference reads."""
    ckpt = str(tmp_path)
    wall = {"now": 1000.0}
    dead = jsup.Supervisor({}, peer_dir=os.path.join(ckpt, "heartbeats"),
                           rank=1, world=2, wall_clock=lambda: wall["now"],
                           publish_interval=0.0)
    dead.beat("step")
    dead._publish_heartbeat()
    sup = _lost_supervisor(ckpt, 0, wall)
    t, caught = _supervised_wait(sup, "elastic-supervised")
    sup.start()
    wall["now"] = 1030.0
    t.join(10)
    sup.stop()
    assert not t.is_alive(), "PeerLostError never landed"
    err = caught["err"]
    assert isinstance(err, tel.PeerLostError)
    assert err.lost_ranks == (1,) and err.epoch == 1
    assert "host(s) [1]" in str(err)
    intents = jel.read_intents(ckpt, min_epoch=1)
    assert intents[0]["lost"] == [1] and intents[0]["epoch"] == 1
    assert list(sup.stale_peers()) == [1]
    assert sup.lost_peers()[1] == pytest.approx(30.0)
    sup.reform(rank=0, world=1, epoch=1, lost=[1])
    assert sup.elastic_epoch == 1 and sup.stale_peers() == {}


def test_foreign_intent_converges_other_survivor(tmp_path):
    ckpt = str(tmp_path)
    wall = {"now": 50.0}
    jel.publish_intent(ckpt, 1, epoch=1, lost=[2], wall_time=50.0)
    sup = tsup.Supervisor({}, peer_dir=os.path.join(ckpt, "heartbeats"),
                          rank=0, world=3, peer_stale=500.0,
                          peer_lost=1000.0, wall_clock=lambda: wall["now"],
                          publish_interval=0.0, lineage_dir=ckpt,
                          poll_interval=0.05)
    t, caught = _supervised_wait(sup, "elastic-follower")
    sup.start()
    t.join(10)
    sup.stop()
    assert not t.is_alive(), "intent convergence never fired"
    assert isinstance(caught["err"], tel.PeerLostError)
    assert caught["err"].lost_ranks == (2,) and caught["err"].epoch == 1


def test_stale_peer_ages_on_telemetry_counter_track(tmp_path):
    ckpt = str(tmp_path)
    wall = {"now": 100.0}
    seen = []
    dead = _lost_supervisor(ckpt, 1, wall)
    dead.beat("step")
    dead._publish_heartbeat()
    sup = _lost_supervisor(ckpt, 0, wall,
                           on_peer_stale=lambda r, age: seen.append((r,
                                                                     age)))
    tr = telemetry.Tracer(str(tmp_path / "trace"), rank=0)
    telemetry.set_active(tr)
    try:
        wall["now"] = 107.0
        sup._check_peers(log=True)
        sup._check_peers(log=True)
    finally:
        telemetry.set_active(None)
        tr.close()
    counters = [e for e in tr.events_tail(64)
                if e.get("ph") == "C" and e.get("name") == "peers"]
    assert counters and counters[-1]["args"]["stale_age_r1"] == \
        pytest.approx(7.0)
    assert seen == [(1, pytest.approx(7.0))]


class _FlakyFS:
    def __init__(self, fail_first):
        self.fail_first = fail_first
        self.writes = 0
        self.stored = {}

    def write_bytes(self, path, data):
        self.writes += 1
        if self.writes <= self.fail_first:
            raise IOError("store flake")
        self.stored[path] = data

    def read_bytes(self, path):
        return self.stored[path]

    def exists(self, path):
        return path in self.stored

    def isdir(self, path):
        return True

    def listdir(self, path):
        return [p.rsplit("/", 1)[-1] for p in self.stored]

    def makedirs(self, path):
        pass

    def rename(self, src, dst):
        self.stored[dst] = self.stored.pop(src)

    def remove(self, path):
        self.stored.pop(path, None)


def test_heartbeat_publish_failure_counted_retried_monitor_survives():
    fs = _FlakyFS(fail_first=5)
    file_io.register_filesystem("elastictest", fs)
    prev = file_io.set_retry_timebase(lambda: 0.0, lambda s: None)
    try:
        sup = tsup.Supervisor({"step": 60.0}, peer_dir="elastictest://hb",
                              rank=0, world=2, publish_interval=0.0)
        sup.beat("step")
        sup._publish_heartbeat()
        assert sup.heartbeat_errors == 1 and sup._last_publish is None
        sup._publish_heartbeat()
        assert sup.heartbeat_errors == 1
        blob = json.loads(fs.read_bytes("elastictest://hb/heartbeat.0"))
        assert "published" in blob and "time" in blob
    finally:
        file_io.set_retry_timebase(*prev)


def test_suspend_heartbeat_stops_publication(tmp_path):
    wall = {"now": 10.0}
    sup = _lost_supervisor(str(tmp_path), 0, wall)
    sup.beat("step")
    sup._publish_heartbeat()
    hb = os.path.join(str(tmp_path), "heartbeats", "heartbeat.0")
    first = open(hb).read()
    wall["now"] = 20.0
    sup.suspend_heartbeat()
    sup._publish_heartbeat()
    assert open(hb).read() == first
    sup.resume_heartbeat()
    sup._publish_heartbeat()
    assert json.loads(open(hb).read())["published"] == 20.0


def test_supervisor_peer_returned_once_per_episode(tmp_path):
    """The reference's announce_join restamps rank 1; the port's rank 0
    sees the return once."""
    ckpt = str(tmp_path)
    wall = {"now": 1000.0}
    dead = _lost_supervisor(ckpt, 1, wall)
    dead.beat("step")
    dead._publish_heartbeat()
    seen = []
    sup = _lost_supervisor(ckpt, 0, wall,
                           on_peer_returned=lambda r, g: seen.append((r, g)))
    sup._check_peers(log=True)
    sup.reform(rank=0, world=1, epoch=1, lost=[1])
    sup._check_peers(log=True)
    assert seen == [] and sup.returned_peers() == {}
    jel.announce_join(ckpt, 1, wall["now"])
    sup._check_peers(log=True)
    sup._check_peers(log=True)
    assert seen == [(1, 1)] and sup.returned_peers() == {1: 1}
    sup.reform(rank=0, world=2, epoch=2, returned=[1])
    assert sup.returned_peers() == {}
    wall["now"] = 1020.0
    assert sup._check_peers(log=False)[1] == pytest.approx(20.0)


def test_reform_grace_holds_promotion_then_rearms(tmp_path):
    ckpt = str(tmp_path)
    wall = {"now": 1000.0}
    dead = _lost_supervisor(ckpt, 1, wall)
    dead.beat("step")
    dead._publish_heartbeat()
    mono = {"t": 100.0}
    sup = _lost_supervisor(ckpt, 0, wall, clock=lambda: mono["t"])
    sup._thread_id = 1 << 30   # the raise's delivery is another test's
    sup.reform(rank=0, world=2, epoch=0)
    assert sup._promotion_grace_until == pytest.approx(
        100.0 + sup.reform_grace)
    wall["now"] = 1030.0
    sup._check_elastic(sup._check_peers(log=False))
    assert jel.read_intents(ckpt, min_epoch=1) == {}
    assert not sup.peer_lost_pending()
    mono["t"] += sup.reform_grace + 0.1
    sup._check_elastic(sup._check_peers(log=False))
    assert jel.read_intents(ckpt, min_epoch=1)[0]["lost"] == [1]
    assert sup.peer_lost_pending()


def test_crash_report_names_stale_peers(tmp_path):
    """``crash_report(stale=)``: the stale peers in the report, as the
    reference's."""
    reports = {}
    for name, mod in (("ref", jsup), ("port", tsup)):
        sup = mod.Supervisor({"step": 1.0})
        reports[name] = sup.crash_report("step", 2.0, 1.0, {3: 94.04},
                                         "why")
    for rep in reports.values():
        assert rep["stale_peers"] == {"3": 94.0}
        assert rep["reason"] == "why"


# -- the grow protocol -------------------------------------------------------

def test_join_intent_roundtrip_and_clear(tmp_path):
    ckpt = str(tmp_path)
    jel.publish_join_intent(ckpt, 1, 5.0, generation=3)
    intents = tel.read_join_intents(ckpt)
    assert intents[1]["generation"] == 3 and intents[1]["rank"] == 1
    assert tel.read_join_intents(ckpt, exclude_rank=1) == {}
    tel.clear_join_intent(ckpt, 1)
    assert jel.read_join_intents(ckpt) == {}
    tel.clear_join_intent(ckpt, 1)


def test_announce_join_hygiene_and_generation_bump(tmp_path):
    ckpt = str(tmp_path)
    hb_dir = tmp_path / "heartbeats"
    hb_dir.mkdir()
    (hb_dir / "heartbeat.1").write_text(json.dumps(
        {"rank": 1, "phase": "step", "count": 7, "time": 1.0,
         "published": 1.0, "generation": 3}))
    jel.publish_intent(ckpt, 1, epoch=1, lost=[0], wall_time=1.0)
    jel.publish_lineage_view(ckpt, 1, 1, [5, 3])
    jel.publish_grow_offer(ckpt, 0, 2, [0, 1], 1.0)
    info = tel.announce_join(ckpt, 1, 9.0)
    assert info == {"generation": 4, "floor": 2}
    edir = tmp_path / "elastic"
    assert not (edir / "recover.1").exists()
    assert not (edir / "lineage.1").exists()
    hb = json.loads((hb_dir / "heartbeat.1").read_text())
    assert hb["generation"] == 4 and hb["phase"] == "join"
    assert jel.read_join_intents(ckpt)[1]["generation"] == 4
    assert tel.announce_join(str(tmp_path / "other"), 0, 9.0) == \
        {"generation": 1, "floor": 0}


def test_death_certificate_and_previous_generation(tmp_path):
    ckpt = str(tmp_path)
    assert tel.previous_generation(ckpt, 1) is None
    assert tel.death_certificate(ckpt, 1) == 0
    wall = {"now": 10.0}
    dead = _lost_supervisor(ckpt, 1, wall)
    dead.beat("step")
    dead._publish_heartbeat()
    assert tel.previous_generation(ckpt, 1) == \
        jel.previous_generation(ckpt, 1) == 0
    jel.publish_intent(ckpt, 0, epoch=3, lost=[1], wall_time=10.0)
    assert tel.death_certificate(ckpt, 1) == 3
    assert tel.death_certificate(ckpt, 0) == 0
    assert tel.death_certificate(ckpt, 1, floor=3) == 0
    assert tel.death_certificate(ckpt, 1, floor=2) == 3


def test_grow_offer_floor_and_wait_for_admission(tmp_path):
    ckpt = str(tmp_path)
    assert tel.latest_grow_epoch(ckpt) == 0
    tel.publish_grow_offer(ckpt, 0, 2, [0, 1], 1.0)
    jel.publish_grow_offer(ckpt, 0, 5, [0, 2], 2.0)
    assert tel.latest_grow_epoch(ckpt) == 5
    assert tel.read_grow_offer(ckpt, min_epoch=0, rank=1)["epoch"] == 2
    assert tel.read_grow_offer(ckpt, min_epoch=2, rank=1) is None
    assert tel.read_grow_offer(ckpt, min_epoch=0, rank=2)["epoch"] == 5
    got = tel.wait_for_admission(ckpt, 2, floor=2, timeout=1.0, poll=0.01)
    assert got["epoch"] == 5 and got["survivors"] == [0, 2]
    fake, clock, sleep = _fake_time()
    with pytest.raises(tel.ElasticJoinError, match="no survivor"):
        tel.wait_for_admission(ckpt, 7, floor=5, timeout=30.0, poll=1.0,
                               clock=clock, sleep=sleep)
    assert fake["t"] >= 30.0


def test_grow_offer_sweep_keeps_newest(tmp_path, monkeypatch):
    for name, env in (("ref", "BIGDL_TPU_PROTOCOL_KEEP"),
                      ("port", "BIGDL_TORCH_PROTOCOL_KEEP")):
        monkeypatch.setenv(env, "2")
        mod = PACKAGES[name][0]
        d = str(tmp_path / name)
        for epoch in range(1, 6):
            mod.publish_grow_offer(d, 0, epoch, [0, 1], float(epoch))
        names = sorted(n for n in os.listdir(mod.elastic_dir(d))
                       if n.startswith("grow."))
        assert names == ["grow.4", "grow.5"]
        assert mod.latest_grow_epoch(d) == 5


def test_cluster_position_reads_newest_loadable_driver_state(tmp_path):
    for name, (mod, io) in PACKAGES.items():
        d = str(tmp_path / name)
        assert tel.cluster_position(d) is None
        io.save_checkpoint(d, 4, {"params": {}, "state": {}},
                           {"method": {},
                            "driver_state": {"epoch": 2, "neval": 5}})
        io.save_checkpoint(d, 9, {"params": {}, "state": {}},
                           {"method": {}, "driver_state": {}})
        assert tel.cluster_position(d) == jel.cluster_position(d) == (2, 5)


def _dataset(n=64, batch=16, distributed=False):
    rng = np.random.default_rng(0)
    samples = [Sample(rng.standard_normal(6).astype(np.float32),
                      np.float32(i % 2)) for i in range(n)]
    return DataSet.array(samples, distributed=distributed).transform(
        SampleToMiniBatch(batch, drop_last=True))


def _linear_opt(ds, **kw):
    return Optimizer(nn.Sequential().add(nn.Linear(6, 2)), ds,
                     nn.CrossEntropyCriterion(), device="cpu", **kw)


def test_join_deferred_during_inflight_shrink(tmp_path, monkeypatch):
    monkeypatch.setenv("BIGDL_TORCH_ELASTIC_WORLD", "2")
    monkeypatch.setenv("BIGDL_TORCH_ELASTIC_RANK", "0")
    monkeypatch.setenv("BIGDL_TORCH_ELASTIC_PEER_LOST", "3600")
    opt = _linear_opt(_dataset()).set_checkpoint(str(tmp_path),
                                                 Trigger.every_epoch())
    Engine.reform(world=1, rank=0, survivors=[0])
    jel.publish_join_intent(str(tmp_path), 1, 0.0, generation=1)
    sup = tsup.Supervisor({}, peer_dir=os.path.join(str(tmp_path),
                                                    "heartbeats"),
                          rank=0, world=1, publish_interval=0.0)
    opt._sup = sup
    sup.hold_elastic()
    opt._check_join(None)
    sup.reform(rank=0, world=1, epoch=1, lost=[1])
    with pytest.raises(_ElasticJoinSignal) as ei:
        opt._check_join(None)
    assert ei.value.joiners == (1,)
    tel.clear_join_intent(str(tmp_path), 1)
    tel.publish_join_intent(str(tmp_path), 0, 0.0, generation=1)
    opt._check_join(None)


# -- the Engine's topology, the batch rescale --------------------------------

def test_engine_logical_world_env_and_reform(monkeypatch):
    monkeypatch.setenv("BIGDL_TORCH_ELASTIC_WORLD", "2")
    monkeypatch.setenv("BIGDL_TORCH_ELASTIC_RANK", "1")
    monkeypatch.setenv("BIGDL_TPU_ELASTIC_WORLD", "2")
    monkeypatch.setenv("BIGDL_TPU_ELASTIC_RANK", "1")
    try:
        views = []
        for eng in (JEngine, Engine):
            before = (eng.world(), eng.rank(), eng.elastic_active(),
                      eng.data_shard_info(), eng.is_writer())
            eng.reform(world=1, rank=1, survivors=[1])
            after = (eng.world(), eng.rank(), eng.survivors(),
                     eng.data_shard_info(), eng.is_writer())
            with pytest.raises(ValueError, match="not in survivors"):
                eng.reform(rank=0, survivors=[1])
            with pytest.raises(ValueError, match="explicit survivor set"):
                eng.reform(world=2)
            views.append((before, after))
            eng.reset()
            assert eng._elastic is None
        assert views[0] == views[1] == (
            (2, 1, True, (1, 2), False), (1, 1, (1,), (0, 1), True))
        # the group is untouched: nothing sums or slices over the logical
        # world
        assert Engine.group_size() == 1 and Engine.group_rank() == 0
    finally:
        JEngine.reset()


def test_engine_reform_device_subset_rebuilds_mesh():
    """The reference's in-process path rebuilds a mesh over a device
    subset; a port process has one device, which ``reform`` takes (and
    more it refuses)."""
    Engine.reform(world=1, rank=0, survivors=[0], devices=["cpu"])
    assert Engine.device() == torch.device("cpu")
    assert Engine.world() == 1 and Engine.survivors() == (0,)
    with pytest.raises(ValueError, match="one device"):
        Engine.reform(world=1, devices=["cpu", "cpu"])


def test_mesh_reform_error_when_widened_world_breaks_shard_groups(
        monkeypatch):
    """The reference refuses a re-form that would break its shard groups;
    the port's counterpart is a live group, which cannot re-form in place
    and says so, typed."""
    monkeypatch.setenv("BIGDL_TORCH_NUM_PROCESSES", "2")
    with pytest.raises(GroupReformError, match="cannot re-form in place"):
        Engine.reform(world=1, rank=0, survivors=[0])
    assert Engine._elastic is None


@pytest.mark.parametrize("world,rank", [(1, 0), (2, 0), (2, 1)])
def test_sharding_remap_widens_zero_params_value_equal(world, rank):
    """ZeRO's remap for a grow (1 -> 2): each rank's slice of a whole
    tree, concatenated over the ranks, is the tree."""
    params = [torch.arange(32.0).reshape(4, 8), torch.arange(8.0)]
    strategy = ShardedDataParallel(min_size=1)
    got = strategy.remap(params, params, world, rank)
    axes = strategy.param_axes(params, world)
    for p, g, ax in zip(params, got, axes):
        want = p if ax is None else p.chunk(world, ax)[rank]
        assert torch.equal(g, want)


def test_sharding_remap_reslices_zero_params():
    """A shrink (2 -> 1): the slices gathered whole and remapped for one
    rank are the tree."""
    params = [torch.arange(64.0).reshape(8, 8), torch.arange(8.0)]
    strategy = ShardedDataParallel(min_size=1)
    halves = [strategy.remap(params, params, 2, r) for r in (0, 1)]
    axes = strategy.param_axes(params, 2)
    whole = [h0 if ax is None else torch.cat([h0, h1], ax)
             for h0, h1, ax in zip(*halves, axes)]
    back = strategy.remap(params, whole, 1, 0)
    assert all(torch.equal(a, b) for a, b in zip(back, params))


def test_rescale_batches_ceil_rounding_rule():
    opt = _linear_opt(_dataset())
    opt._rescale_batches(4, 2)
    b = _find_batchers(opt.dataset)[0]
    assert b.batch_size == 32
    opt._rescale_batches(2, 3)
    assert b.batch_size == math.ceil(64 / 3) == 22
    opt._rescale_batches(3, 3)
    assert b.batch_size == 22


def test_rescale_batches_grow_restores_configured_value():
    opt = _linear_opt(_dataset())
    b = _find_batchers(opt.dataset)[0]
    opt._rescale_batches(2, 1)
    assert b.batch_size == 32
    opt._rescale_batches(1, 2)
    assert b.batch_size == 16
    opt._rescale_batches(2, 3)
    assert b.batch_size == math.ceil(32 / 3) == 11


# -- the Optimizer -----------------------------------------------------------

def _train_losses(tmp_path, tag):
    losses = []
    set_seed(11)
    opt = (_linear_opt(_dataset())
           .set_optim_method(Adam(1e-2))
           .set_end_when(Trigger.max_epoch(2))
           .set_checkpoint(str(tmp_path / tag), Trigger.every_epoch()))
    orig = opt._observe_loss
    opt._observe_loss = lambda lossf, state: losses.append(
        orig(lossf, state)) or losses[-1]
    trained = opt.optimize()
    return losses, [p.detach().numpy().tobytes()
                    for p in trained.parameters()]


def test_elasticity_armed_no_fault_bit_identical(tmp_path, monkeypatch):
    base_losses, base_params = _train_losses(tmp_path, "plain")
    monkeypatch.setenv("BIGDL_TORCH_ELASTIC_PEER_LOST", "60")
    monkeypatch.setenv("BIGDL_TORCH_SUPERVISE_STEP", "120")
    armed_losses, armed_params = _train_losses(tmp_path, "armed")
    assert armed_losses == base_losses
    assert armed_params == base_params


def _recovering_run(tmp_path, monkeypatch, rank):
    monkeypatch.setenv("BIGDL_TORCH_ELASTIC_WORLD", "2")
    monkeypatch.setenv("BIGDL_TORCH_ELASTIC_RANK", str(rank))
    monkeypatch.setenv("BIGDL_TORCH_ELASTIC_PEER_LOST", "3600")
    return (_linear_opt(_dataset(n=128, batch=16, distributed=True))
            .set_optim_method(Adam(1e-2))
            .set_end_when(Trigger.max_epoch(2))
            .set_checkpoint(str(tmp_path), Trigger.several_iteration(1)))


def test_optimizer_elastic_recover_in_process_zero(tmp_path, monkeypatch):
    """The reference recovers ZeRO over a virtual mesh in one process; the
    port recovers a logical world 2 -> 1 without a group: a staged
    PeerLostError drives ``_elastic_recover``, the batch doubles, the
    shard becomes the whole corpus and the run trains on to its end."""
    opt = _recovering_run(tmp_path, monkeypatch, 0)
    opt.optimize()
    latest = file_io.latest_checkpoint(str(tmp_path))
    assert latest is not None
    assert Engine.data_shard_info() == (0, 2)
    tel.set_last_peer_lost("host 1 gone", [1], 1)
    opt._elastic_recover(tel.PeerLostError())
    assert opt._elastic_plan.neval == latest[2]
    assert Engine.world() == 1 and Engine.survivors() == (0,)
    assert _find_batchers(opt.dataset)[0].batch_size == 32
    assert opt._stager is None and opt._forward is None
    assert all(p.grad is None for p in opt.model.parameters())
    assert opt._elastic_history == [{"kind": "shrink", "neval": latest[2],
                                     "epoch": 1, "world": 1, "batch": 32}]
    opt.set_end_when(Trigger.max_epoch(3))
    trained = opt.optimize()
    assert all(torch.isfinite(p).all() for p in trained.parameters())
    assert Engine.data_shard_info() == (0, 1)


def test_survivor_rank_one_becomes_the_writer(tmp_path, monkeypatch):
    """Rank 1 writes nothing while rank 0 lives; once rank 0 is lost it is
    the lowest survivor and writes the lineage on."""
    _recovering_run(tmp_path, monkeypatch, 0).optimize()
    first = file_io.latest_checkpoint(str(tmp_path))[2]
    Engine.reset()
    opt = _recovering_run(tmp_path, monkeypatch, 1)
    opt.set_end_when(Trigger.max_epoch(1))
    opt.optimize()
    assert not Engine.is_writer()
    assert file_io.latest_checkpoint(str(tmp_path))[2] == first
    tel.set_last_peer_lost("host 0 gone", [0], 1)
    opt._elastic_recover(tel.PeerLostError())
    assert Engine.is_writer() and Engine.data_shard_info() == (0, 1)
    opt.set_end_when(Trigger.max_epoch(4))
    opt.optimize()
    assert file_io.latest_checkpoint(str(tmp_path))[2] > first


def _bn_samples(n=64):
    rng = np.random.default_rng(3)
    return [Sample(rng.standard_normal(6).astype(np.float32),
                   np.float32(i % 3)) for i in range(n)]


def _bn_run(ds, seed=0):
    model = (nn.Sequential().add(nn.Linear(6, 8))
             .add(nn.BatchNormalization(8)).add(nn.ReLU())
             .add(nn.Linear(8, 3)).add(nn.LogSoftMax()))
    model.build("cpu", torch.Generator().manual_seed(seed))
    ds.shuffle = lambda: None
    losses = []
    opt = (Optimizer(model, ds, nn.ClassNLLCriterion(), device="cpu")
           .set_optim_method(SGD(0.1, momentum=0.9))
           .set_end_when(Trigger.max_epoch(2)))
    orig = opt._observe_loss
    opt._observe_loss = lambda lossf, state: losses.append(
        orig(lossf, state)) or losses[-1]
    trained = opt.optimize()
    x = np.random.default_rng(5).standard_normal((10, 6)).astype(np.float32)
    return (losses, [p.detach().clone() for p in trained.parameters()],
            Predictor(trained, batch_size=4, device="cpu").predict(x))


def test_logical_world_two_steps_like_world_one_on_its_shard(monkeypatch):
    """Rank 1 of a logical world of 2 (no group) trains its shard exactly
    as a world-1 run trains the same rows: no gradient, loss or BatchNorm
    statistic is divided by the logical world, and Predictor forwards
    every row itself."""
    samples = _bn_samples()
    monkeypatch.setenv("BIGDL_TORCH_ELASTIC_WORLD", "2")
    monkeypatch.setenv("BIGDL_TORCH_ELASTIC_RANK", "1")
    shard = DataSet.array(samples, distributed=True).transform(
        SampleToMiniBatch(8, drop_last=True))
    got = _bn_run(shard)
    monkeypatch.delenv("BIGDL_TORCH_ELASTIC_WORLD")
    monkeypatch.delenv("BIGDL_TORCH_ELASTIC_RANK")
    want = _bn_run(DataSet.array(samples[1::2]).transform(
        SampleToMiniBatch(8, drop_last=True)))
    assert got[0] == want[0] and len(got[0]) == 8
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    np.testing.assert_array_equal(got[2], want[2])


# -- the drills, with processes ----------------------------------------------

def _drill(tmp_path, *extra):
    proc = subprocess.run(
        [sys.executable, "-m", "bigdl_torch.tools.elastic_smoke",
         "--device", "cpu", "--ckpt-dir", str(tmp_path),
         "--peer-lost", str(DRILL_PEER_LOST_S),
         "--timeout", str(DRILL_TIMEOUT_S), *extra],
        capture_output=True, text=True, timeout=DRILL_TIMEOUT_S + 8,
        env={**os.environ, "PYTHONPATH": _REPO_ROOT})
    lines = [line for line in proc.stdout.splitlines()
             if line.startswith("{")]
    assert lines, f"no JSON from the drill:\n{proc.stderr[-3000:]}"
    out = json.loads(lines[-1])
    assert proc.returncode == 0, out
    return out


def test_elastic_drill_two_ranks_end_to_end(tmp_path):
    """Rank 1 dies at epoch 1 (chaos exit 117); rank 0 detects, negotiates,
    shrinks to world 1 at batch 32, resumes with the elastic events in its
    trace, and ends on the loss of a clean world-1 run from the same
    entry."""
    out = _drill(tmp_path, "--pace", "0.25")
    assert out["recovered"] is True
    assert out["world_after"] == 1 and out["batch_after"] == 32
    assert out["rank1_rc"] == 117
    assert out["loss_match"] is True
    assert {"elastic.detect", "elastic.negotiate", "elastic.reform",
            "elastic.resume"} <= set(out["elastic_events"])
    assert out["neval_resumed"] >= 1
    assert [n for n in os.listdir(tmp_path / "ckpt")
            if n.startswith("model.")], "the drill left no lineage"


def test_elastic_grow_drill_two_ranks_end_to_end(tmp_path):
    """Kill, then return: world 2 -> 1 -> 2 and batch 16 -> 32 -> 16, the
    joiner admitted at a checkpoint boundary, the release feed gap-free
    with a promotion after the grow, and both ranks on the losses of clean
    world-2 runs from the join snapshot."""
    out = _drill(tmp_path, "--grow", "--epochs", "16")
    assert out["recovered"] is True and out["joined"] is True
    assert out["rank1_rc"] == 117
    assert [h["kind"] for h in out["history_rank0"]] == ["shrink", "grow"]
    assert [h["world"] for h in out["history_rank0"]] == [1, 2]
    assert [h["batch"] for h in out["history_rank0"]] == [32, 16]
    assert [h["kind"] for h in out["history_joiner"]] == ["join"]
    assert out["loss_match"] is True
    assert out["release_gap_free"] is True and out["rejected"] == 0
    assert out["promoted_after_grow"] >= 1
    for events in out["elastic_events"].values():
        assert {"elastic.join", "elastic.agree", "elastic.reform",
                "elastic.resume"} <= set(events)


# -- the training loop's telemetry -------------------------------------------

def _loop_events(tracer_mod, run):
    tr = tracer_mod.Tracer(str(_loop_events.dir), rank=0)
    tracer_mod.set_active(tr)
    try:
        run()
    finally:
        tracer_mod.set_active(None)
        tr.close()
    return tr.events_tail(4096)


def test_training_loop_spans_and_counter_track(tmp_path, monkeypatch):
    """The loop's ``data``, ``step``, ``validation`` and ``checkpoint``
    spans, the ``train`` counter track, the prefetch worker's
    ``prefetch.item`` spans and bulk inference's ``evaluate`` and
    ``predict``: the reference's names and counter fields."""
    import bigdl_tpu.nn as jnn
    from bigdl_tpu.dataset import DataSet as JDataSet
    from bigdl_tpu.dataset import Sample as JSample
    from bigdl_tpu.dataset import SampleToMiniBatch as JToBatch
    from bigdl_tpu.optim import Adam as JAdam
    from bigdl_tpu.optim import Loss as JLoss
    from bigdl_tpu.optim import Evaluator as JEvaluator
    from bigdl_tpu.optim import Optimizer as JOptimizer
    from bigdl_tpu.optim import Predictor as JPredictor
    from bigdl_tpu.optim import Trigger as JTrigger
    from bigdl_tpu.utils import telemetry as jtel
    from bigdl_torch.optim import Evaluator, Loss
    monkeypatch.setenv("BIGDL_TPU_PREFETCH_DEPTH", "2")
    monkeypatch.setenv("BIGDL_TORCH_PREFETCH_DEPTH", "2")
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((32, 6)).astype(np.float32)
    ys = (np.arange(32) % 2).astype(np.float32)

    def port():
        samples = [Sample(x, y) for x, y in zip(xs, ys)]
        model = nn.Sequential().add(nn.Linear(6, 2))
        (Optimizer(model, DataSet.array(samples).transform(
            SampleToMiniBatch(8, drop_last=True)),
            nn.CrossEntropyCriterion(), device="cpu")
         .set_optim_method(Adam(1e-2))
         .set_validation(Trigger.every_epoch(), samples, [Loss()], 8)
         .set_checkpoint(str(tmp_path / "port"), Trigger.every_epoch())
         .set_end_when(Trigger.max_epoch(1)).optimize())
        Evaluator(model, device="cpu").test(samples, [Loss()], 8)
        Predictor(model, batch_size=8, device="cpu").predict(samples)

    def ref():
        samples = [JSample(x, y) for x, y in zip(xs, ys)]
        model = jnn.Sequential().add(jnn.Linear(6, 2))
        (JOptimizer(model, JDataSet.array(samples).transform(
            JToBatch(8, drop_last=True)), jnn.CrossEntropyCriterion())
         .set_optim_method(JAdam(1e-2))
         .set_validation(JTrigger.every_epoch(), samples, [JLoss()], 8)
         .set_checkpoint(str(tmp_path / "ref"), JTrigger.every_epoch())
         .set_end_when(JTrigger.max_epoch(1)).optimize())
        JEvaluator(model).test(samples, [JLoss()], 8)
        JPredictor(model, batch_size=8).predict(samples)

    _loop_events.dir = tmp_path / "trace"
    want = {"data", "step", "validation", "checkpoint", "prefetch.item",
            "evaluate", "predict"}
    names, fields = {}, {}
    for name, (tmod, run) in {"port": (telemetry, port),
                              "ref": (jtel, ref)}.items():
        events = _loop_events(tmod, run)
        names[name] = {e["name"] for e in events if e.get("ph") == "X"}
        fields[name] = {k for e in events if e.get("ph") == "C"
                        and e.get("name") == "train" for k in e["args"]}
    assert want <= names["port"] and want <= names["ref"]
    assert fields["port"] == {"data_wait_s", "step_s", "records_per_sec",
                              "prefetch_queue_depth"} <= fields["ref"]
