"""The serving fleet of the port (``serve/fleet.py``, ``serve/fleetfront.py``,
``tools/serve_worker.py``, ``DeployController``'s fleet mode), held to the
JAX package on the CPU.

Every case of ``tests/test_fleet.py`` has a counterpart here:

- member records are CRC-framed (a torn or bit-rotted one reads as
  absent), the newest verified generation wins, the writer sweeps dead
  generations, condemnation is a monotonic generation bump that hides
  every record at or below it, and liveness is heartbeat publication
  freshness; the records and heartbeats of either package read in the
  other (``file_io.sweep_numbered`` is held to the reference's; its grow
  offers' sweep is in ``test_torch_port_elastic.py``);
- the supervisor condemns and respawns a silent member, degrades past its
  restart budget, spawns past a ghost heartbeat and condemns its members
  when it stops;
- the front: a typed ``MemberLostError`` with no live member, stale and
  condemned entries never routed, the typed error map, the routing key,
  a swap that needs a path; two real members (``InferenceServer`` behind
  ``tools/serve_http.py`` on 127.0.0.1) answering as ``Predictor`` does,
  a rolling swap to the reference's snapshot and a failover off a closed
  member;
- ``DeployController`` in fleet mode, the plain server unchanged;
- a worker process (``--device cpu``) that registers, answers and exits
  on its condemnation.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest

import bigdl_tpu.nn as jnn
from bigdl_tpu.serve import fleet as jfl
from bigdl_tpu.serve.fleetfront import FleetFront as JFleetFront
from bigdl_tpu.utils import file_io as jio

import bigdl_torch.nn as nn
from bigdl_torch.optim import Predictor
from bigdl_torch.serve import (DeployController, FleetFront, FleetSupervisor,
                               InferenceServer, MemberLostError,
                               ReleasePublisher, ReplicaLostError,
                               RequestTimeout, ServeError, ServerOverloaded)
from bigdl_torch.serve import fleet
from bigdl_torch.tools import serve_http
from bigdl_torch.utils import file_io
from bigdl_torch.utils.convert import load_reference_tree

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: a member's answer against Predictor's: float32 survives the JSON round
#: trip exactly, but the member's batch and Predictor's differ in shape,
#: and the host's matmul may then sum in another order
ANSWER_ATOL = 1e-6


def _wait(pred, timeout=15.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert pred(), "condition not reached in time"


# -- the registry ------------------------------------------------------------

@pytest.mark.parametrize("writer", ["ref", "port"])
def test_member_record_roundtrip(tmp_path, writer):
    """A record and a heartbeat written by either package read the same
    in both."""
    w, r = (jfl, fleet) if writer == "ref" else (fleet, jfl)
    d = str(tmp_path)
    path = w.publish_member(d, index=2, generation=3, pid=4242, port=8011,
                            devices=["cpu:0"], buckets=[1, 2, 4],
                            max_batch=4)
    rec = r.read_member(path)
    assert rec == w.read_member(path)
    assert rec["index"] == 2 and rec["generation"] == 3
    assert rec["pid"] == 4242 and rec["port"] == 8011
    assert rec["buckets"] == [1, 2, 4] and rec["max_batch"] == 4
    assert rec["format"] == fleet.MEMBER_FORMAT == jfl.MEMBER_FORMAT
    assert r.read_registry(d) == {2: rec}
    w.beat(d, 2, 3, 7, wall_time=1000.0)
    assert r.read_heartbeat(d, 2) == w.read_heartbeat(d, 2)
    assert r.member_alive(d, 2, generation=3, lost_after=5.0, now=1004.0)
    w.condemn(d, 2, 3)
    assert r.condemned_generation(d, 2) == 3 and r.read_registry(d) == {}


def test_torn_record_reads_absent(tmp_path):
    d = str(tmp_path)
    good = fleet.publish_member(d, index=0, generation=2, pid=1, port=8000)
    blob = open(good, "rb").read()
    (tmp_path / "member.0.3").write_bytes(blob[: len(blob) // 2])
    flipped = bytearray(blob)
    flipped[len(blob) // 2] ^= 0xFF
    (tmp_path / "member.0.4").write_bytes(bytes(flipped))
    for mod in (fleet, jfl):
        assert mod.read_member(str(tmp_path / "member.0.3")) is None
        assert mod.read_member(str(tmp_path / "member.0.4")) is None
        assert mod.read_registry(d)[0]["generation"] == 2


def test_registry_newest_generation_wins(tmp_path):
    d = str(tmp_path)
    for gen in (1, 2, 3):
        fleet.publish_member(d, index=0, generation=gen, pid=gen, port=8000)
    assert fleet.read_registry(d)[0]["generation"] == 3


def test_publish_sweeps_dead_generations(tmp_path, monkeypatch):
    monkeypatch.setenv("BIGDL_TORCH_FLEET_KEEP_GENERATIONS", "3")
    d = str(tmp_path)
    for gen in range(1, 9):
        fleet.publish_member(d, index=0, generation=gen, pid=gen, port=8000)
    names = sorted(n for n in os.listdir(d) if n.startswith("member."))
    assert names == ["member.0.6", "member.0.7", "member.0.8"]
    fleet.publish_member(d, index=1, generation=1, pid=99, port=8001)
    assert (tmp_path / "member.0.8").exists()


def test_condemn_is_monotonic(tmp_path):
    d = str(tmp_path)
    assert fleet.condemned_generation(d, 0) == 0
    fleet.condemn(d, 0, 5)
    assert jfl.condemned_generation(d, 0) == 5
    jfl.condemn(d, 0, 3)     # a late verdict, from the other package
    assert fleet.condemned_generation(d, 0) == 5


def test_registry_skips_condemned_generations(tmp_path):
    d = str(tmp_path)
    for gen in (1, 2, 3):
        fleet.publish_member(d, index=0, generation=gen, pid=gen, port=8000)
    fleet.condemn(d, 0, 3)
    assert fleet.read_registry(d) == {}
    fleet.publish_member(d, index=0, generation=4, pid=4, port=8000)
    assert fleet.read_registry(d)[0]["generation"] == 4


def test_member_alive_is_publication_freshness(tmp_path):
    d = str(tmp_path)
    assert not fleet.member_alive(d, 0, lost_after=5.0)
    fleet.beat(d, 0, 2, 1, wall_time=1000.0)
    assert fleet.member_alive(d, 0, lost_after=5.0, now=1003.0)
    assert not fleet.member_alive(d, 0, lost_after=5.0, now=1006.0)
    assert not fleet.member_alive(d, 0, generation=3, lost_after=5.0,
                                  now=1001.0)
    assert fleet.member_alive(d, 0, generation=2, lost_after=5.0,
                              now=1001.0)


@pytest.mark.parametrize("name", ["ref", "port"])
def test_sweep_numbered_retention(tmp_path, name):
    sweep = (jio if name == "ref" else file_io).sweep_numbered
    for i in (1, 3, 5, 7, 9):
        (tmp_path / f"grow.{i}").write_text("x")
    (tmp_path / "grow.2.corrupt").write_text("x")
    (tmp_path / "other.4").write_text("x")
    removed = sweep(str(tmp_path), r"grow\.(\d+)", keep=2)
    assert sorted(removed) == ["grow.1", "grow.3", "grow.5"]
    assert sorted(os.listdir(tmp_path)) == ["grow.2.corrupt", "grow.7",
                                            "grow.9", "other.4"]
    assert sweep(str(tmp_path), r"grow\.(\d+)", keep=0) == []
    assert (tmp_path / "grow.7").exists()


# -- the supervisor ----------------------------------------------------------

class _FakeProc:
    """A Popen stand-in the supervisor can poll and kill."""

    _pids = iter(range(30000, 40000))

    def __init__(self):
        self.pid = next(self._pids)
        self.returncode = None
        self.killed = False

    def poll(self):
        return self.returncode

    def kill(self):
        self.killed = True
        self.returncode = -9

    def terminate(self):
        self.returncode = -15

    def wait(self, timeout=None):
        return self.returncode


class _FakeMember:
    """A fake worker life: publishes its record and beats on a thread
    until it goes silent (the wedge) or is killed."""

    def __init__(self, fleet_dir, index, generation):
        self.proc = _FakeProc()
        self.fleet_dir, self.index, self.generation = \
            fleet_dir, index, generation
        self._silent = threading.Event()
        fleet.publish_member(fleet_dir, index=index, generation=generation,
                             pid=self.proc.pid, port=8000 + index)
        fleet.beat(fleet_dir, index, generation, 0)
        self._thread = threading.Thread(target=self._beat, daemon=True)
        self._thread.start()

    def _beat(self):
        count = 0
        while not self._silent.is_set() and self.proc.poll() is None:
            count += 1
            fleet.beat(self.fleet_dir, self.index, self.generation, count)
            self._silent.wait(0.03)

    def wedge(self):
        self._silent.set()


def test_supervisor_condemns_and_respawns_silent_member(tmp_path):
    d = str(tmp_path)
    lives = []

    def spawn(index, generation):
        lives.append(_FakeMember(d, index, generation))
        return lives[-1].proc

    sup = FleetSupervisor(d, spawn, members=1, lost_after_s=0.15,
                          poll_s=0.03, backoff_s=0.03, grace_s=5.0,
                          restart_budget=10)
    sup.start()
    try:
        _wait(lambda: sup.live_count() == 1)
        lives[0].wedge()
        _wait(lambda: len(lives) >= 2 and sup.live_count() == 1)
    finally:
        sup.stop(terminate=False)
    assert [m.generation for m in lives[:2]] == [1, 2]
    assert jfl.condemned_generation(d, 0) >= 1
    assert lives[0].proc.killed
    assert isinstance(sup.last_error, MemberLostError)
    assert isinstance(sup.last_error, ReplicaLostError)
    assert sup.last_error.index == 0 and sup.last_error.generation == 1
    st = sup.stats()
    assert st["restarts"] >= 1 and st["degraded"] == 0
    assert jfl.read_registry(d)[0]["generation"] == lives[-1].generation


def test_supervisor_degrades_past_restart_budget(tmp_path):
    d = str(tmp_path)
    spawns = []

    def spawn(index, generation):
        spawns.append(generation)
        return _FakeProc()

    sup = FleetSupervisor(d, spawn, members=1, lost_after_s=0.05,
                          poll_s=0.02, backoff_s=0.01, grace_s=0.05,
                          restart_budget=2)
    sup.start()
    try:
        _wait(lambda: sup.stats()["degraded"] == 1)
        n = len(spawns)
        time.sleep(0.1)
        assert len(spawns) == n
    finally:
        sup.stop(terminate=False)
    assert spawns == [1, 2, 3]
    assert not sup.healthy()
    st = sup.stats()
    assert st["slots"]["0"]["degraded"] and st["live"] == 0


def test_supervisor_spawns_past_ghost_heartbeat(tmp_path):
    """The reference left a condemnation and a stale ghost heartbeat; the
    port's supervisor spawns past both."""
    d = str(tmp_path)
    jfl.condemn(d, 0, 3)
    jfl.beat(d, 0, 7, 42, wall_time=time.time() - 3600)
    seen = []

    def spawn(index, generation):
        seen.append((index, generation))
        return _FakeProc()

    sup = FleetSupervisor(d, spawn, members=1, grace_s=30.0)
    sup._spawn(0)
    assert seen == [(0, 8)]
    assert sup.stats()["slots"]["0"]["generation"] == 8


def test_supervisor_stop_condemns_survivors(tmp_path):
    d = str(tmp_path)
    lives = []

    def spawn(index, generation):
        lives.append(_FakeMember(d, index, generation))
        return lives[-1].proc

    sup = FleetSupervisor(d, spawn, members=2, lost_after_s=5.0,
                          poll_s=0.02, grace_s=5.0)
    sup.start()
    _wait(lambda: sup.live_count() == 2)
    sup.stop()
    for idx in (0, 1):
        assert fleet.condemned_generation(d, idx) >= 1
    assert all(m.proc.poll() is not None for m in lives)


def test_default_spawner_runs_the_port_worker(tmp_path, monkeypatch):
    """The stock spawner starts ``python -m bigdl_torch.tools.
    serve_worker``, never the repository's JAX worker."""
    seen = {}

    class _Popen:
        def __init__(self, cmd, env=None):
            seen["cmd"], seen["env"] = cmd, env
    monkeypatch.setattr(fleet.subprocess, "Popen", _Popen)
    fleet.default_spawner(str(tmp_path), model="lenet",
                          extra_args=("--device", "cpu"), env={})(1, 4)
    assert seen["cmd"][1:3] == ["-m", "bigdl_torch.tools.serve_worker"]
    assert seen["cmd"][3:] == ["--fleet-dir", str(tmp_path), "--index", "1",
                               "--generation", "4", "--model", "lenet",
                               "--device", "cpu"]
    assert seen["env"]["PYTHONPATH"] == _REPO_ROOT


# -- the front ---------------------------------------------------------------

def test_front_no_live_member_is_typed(tmp_path):
    front = FleetFront(str(tmp_path), refresh_s=0)
    assert not front.healthy()
    with pytest.raises(MemberLostError) as ei:
        front.submit(np.zeros((4,), np.float32))
    assert isinstance(ei.value, ReplicaLostError)
    assert ei.value.retry_after_s is not None
    front.close()


def test_front_ignores_stale_registry_entry(tmp_path):
    d = str(tmp_path)
    jfl.publish_member(d, index=7, generation=1, pid=1, port=9999)
    front = FleetFront(d, refresh_s=0, lost_after_s=0.5)
    assert front.members() == {}
    jfl.beat(d, 7, 1, 1, wall_time=time.time() - 60)
    assert front.members() == {}
    jfl.publish_member(d, index=0, generation=2, pid=2, port=8000)
    jfl.beat(d, 0, 2, 1)
    assert sorted(front.members()) == [0]
    jfl.condemn(d, 0, 2)
    assert front.members() == {}
    front.close()


def test_front_typed_error_mapping():
    for front, serve in ((FleetFront, None), (JFleetFront, "ref")):
        err = front._typed(429, {"error": "full", "retry_after_s": 2.5})
        assert type(err).__name__ == "ServerOverloaded"
        assert err.retry_after_s == 2.5
        assert type(front._typed(504, {"error": "late"})).__name__ == \
            "RequestTimeout"
        assert type(front._typed(400, {"error": "bad"})).__name__ == \
            "ServeError"
        assert front._typed(503, {}) is None and front._typed(500, {}) is None
    assert isinstance(FleetFront._typed(429, {}), ServerOverloaded)
    assert isinstance(FleetFront._typed(504, {}), RequestTimeout)
    assert isinstance(FleetFront._typed(400, {}), ServeError)


def test_front_pick_routing_key(tmp_path):
    d = str(tmp_path)
    for i in (0, 1):
        fleet.publish_member(d, index=i, generation=1, pid=i,
                             port=8000 + i, max_batch=4)
        fleet.beat(d, i, 1, 1)
    fronts = [FleetFront(d, refresh_s=0, lost_after_s=60),
              JFleetFront(d, refresh_s=0, lost_after_s=60)]
    try:
        for front in fronts:
            assert front._pick() == 0
            front._inflight = {0: 9}
            assert front._pick() == 1
            assert front._pick(exclude={1}) == 0
            assert front._pick(exclude={0, 1}) is None
            front._inflight = {}
            front._deploying = {0}
            assert front._pick() == 1
            front._deploying = {0, 1}
            assert front._pick() == 0
    finally:
        for front in fronts:
            front.close()


def test_front_swap_requires_path(tmp_path):
    d = str(tmp_path)
    fleet.publish_member(d, index=0, generation=1, pid=1, port=8000)
    fleet.beat(d, 0, 1, 1)
    front = FleetFront(d, refresh_s=0, lost_after_s=60)
    with pytest.raises(ServeError):
        front.swap({"params": {}})
    front.close()


def _ref_linear(seed):
    return jnn.Sequential().add(jnn.Linear(4, 3)).build(
        jax.random.key(seed))


def _port_linear(jmodel):
    return load_reference_tree(
        nn.Sequential().add(nn.Linear(4, 3)).build("cpu"),
        jax.tree.map(np.asarray, jmodel.params),
        jax.tree.map(np.asarray, jmodel.state))


def _start_member(tmp_path, index, server):
    httpd = serve_http.serve_forever(server, "127.0.0.1", 0)
    fleet.publish_member(str(tmp_path), index=index, generation=1,
                         pid=os.getpid(), port=httpd.server_address[1],
                         max_batch=server.max_batch)
    fleet.beat(str(tmp_path), index, 1, 1)
    return httpd


def test_front_end_to_end_route_retry_and_roll(tmp_path):
    """Two real members (the reference's weights) behind the front: the
    answers are Predictor's (within ``ANSWER_ATOL``), a rolling swap to the reference's snapshot
    lands on both, and a closed member's requests fail over."""
    j0 = _ref_linear(0)
    servers = [InferenceServer(_port_linear(j0), max_wait_ms=2,
                               example=np.zeros((4,), np.float32),
                               device="cpu").start() for _ in range(2)]
    httpds = [_start_member(tmp_path, i, s) for i, s in enumerate(servers)]
    front = FleetFront(str(tmp_path), refresh_s=0, lost_after_s=3600,
                       retries=2, timeout_s=30)
    try:
        assert front.healthy() and sorted(front.members()) == [0, 1]
        x = np.random.default_rng(7).standard_normal((6, 4)).astype(
            np.float32)
        want = Predictor(_port_linear(j0), device="cpu").predict(x)
        handles = [front.submit(row) for row in x]
        got = np.stack([h.result(timeout=30) for h in handles])
        np.testing.assert_allclose(got, want, rtol=0, atol=ANSWER_ATOL)
        st = front.stats()
        assert st["replicas_live"] == 2
        assert sum(m["routed"] for m in st["fleet"]["members"].values()) \
            == 6
        j1 = _ref_linear(1)
        jio.save({"params": jax.tree.map(np.asarray, j1.params),
                  "state": jax.tree.map(np.asarray, j1.state)},
                 str(tmp_path / "model.new"))
        front.swap(str(tmp_path / "model.new"))
        want2 = Predictor(_port_linear(j1), device="cpu").predict(x)
        np.testing.assert_allclose(
            np.stack([front.predict(row, timeout=30) for row in x]), want2,
            rtol=0, atol=ANSWER_ATOL)
        assert front.stats()["canary"]["reason"] == "full_swap"
        assert front.stats()["fleet"]["deploy"]["rolled"] == 1
        httpds[0].shutdown()
        httpds[0].server_close()
        np.testing.assert_allclose(front.predict(x[0], timeout=30),
                                   want2[0], rtol=0, atol=ANSWER_ATOL)
        assert front.stats()["fleet"]["retried"] >= 1
    finally:
        front.close()
        for httpd in httpds:
            httpd.shutdown()
        for s in servers:
            s.stop()


# -- the deploy controller's fleet mode --------------------------------------

class _StubFront:
    """A fleet target recording the rolling deploy's arguments."""

    fleet = True

    def __init__(self):
        self.swaps = []
        self.deploy = None
        self._vid = 1

    def attach_deploy(self, controller):
        self.deploy = controller

    def swap(self, source, canary_fraction=None, max_unavailable=None):
        self._vid += 1
        self.swaps.append((str(source), canary_fraction, max_unavailable))
        return self._vid

    def stats(self):
        return {"canary": {"version": self._vid, "state": "promoted",
                           "fraction": 0.25, "routed": 8, "total": 32}}

    def healthy(self):
        return True


def _release(tmp_path):
    j = _ref_linear(1)
    jio.save({"params": jax.tree.map(np.asarray, j.params),
              "state": jax.tree.map(np.asarray, j.state)},
             str(tmp_path / "model.1"))
    ReleasePublisher(str(tmp_path)).publish(str(tmp_path / "model.1"),
                                            neval=1)


def test_deploy_controller_fleet_mode(tmp_path):
    _release(tmp_path)
    front = _StubFront()
    ctl = DeployController(front, str(tmp_path), canary_fraction=0.25,
                           poll_s=0.01, max_unavailable=2).start()
    try:
        _wait(lambda: ctl.stats()["promoted"] >= 1)
    finally:
        ctl.stop()
    assert ctl.fleet_mode and front.deploy is ctl
    assert front.swaps == [(str(tmp_path / "model.1"), 0.25, 2)]
    deployed = [e for e in ctl.versions()["timeline"]
                if e["action"] == "deployed"]
    assert deployed and deployed[0]["fleet"] is True


def test_deploy_controller_plain_server_unchanged(tmp_path):
    class _Plain:
        def __init__(self):
            self.kwargs = []
            self._vid = 1

        def swap(self, source, canary_fraction=None):
            self._vid += 1
            self.kwargs.append(canary_fraction)
            return self._vid

        def stats(self):
            return {"canary": {"version": self._vid, "state": "promoted"}}

    _release(tmp_path)
    srv = _Plain()
    ctl = DeployController(srv, str(tmp_path), canary_fraction=0.25,
                           poll_s=0.01).start()
    try:
        _wait(lambda: ctl.stats()["promoted"] >= 1)
    finally:
        ctl.stop()
    assert not ctl.fleet_mode and srv.kwargs == [0.25]
    deployed = [e for e in ctl.versions()["timeline"]
                if e["action"] == "deployed"]
    assert "fleet" not in deployed[0]


# -- a worker process --------------------------------------------------------

def test_worker_process_registers_and_exits_on_condemn(tmp_path):
    """One worker process on the host: it registers its bound port (read
    by the reference's registry too), beats, answers /v1/predict, and
    exits 0 once the reference condemns its generation."""
    d = str(tmp_path / "fleet")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BIGDL_TORCH_ELASTIC", "BIGDL_TORCH_CHAOS",
                                "BIGDL_TORCH_TRACE"))}
    env.update(PYTHONPATH=_REPO_ROOT, BIGDL_TORCH_FLEET_HEARTBEAT="0.1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "bigdl_torch.tools.serve_worker",
         "--fleet-dir", d, "--index", "0", "--generation", "1",
         "--model", "linear", "--device", "cpu"],
        env=env, stdout=subprocess.PIPE, text=True)
    try:
        _wait(lambda: 0 in jfl.read_registry(d), timeout=60)
        _wait(lambda: jfl.member_alive(d, 0, generation=1, lost_after=5.0),
              timeout=30)
        rec = fleet.read_registry(d)[0]
        assert rec["pid"] == proc.pid and rec["port"] > 0
        assert rec["devices"] == ["cpu"]
        body = json.dumps({"inputs": [0.0, 0.0, 0.0, 0.0]}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{rec['port']}/v1/predict", data=body,
            method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            out = json.loads(r.read())
        assert np.asarray(out["outputs"]).shape == (3,)
        jfl.condemn(d, 0, 1)
        assert proc.wait(timeout=30) == 0
        lines = [json.loads(line) for line in proc.stdout.read().splitlines()
                 if line.startswith("{")]
        assert lines[0]["ready_s"] > 0 and lines[-1]["condemned"] is True
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
