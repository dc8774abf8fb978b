"""Remote and asynchronous checkpoints of the port against the JAX
package, on the CPU.

- ``RetryPolicy``: the same backoff schedule and, on an injected clock,
  the same sleeps and deadline cut as the reference's.
- A registered in-process store behind ``RetryingFileSystem``: with
  ``FailN(2)`` on ``fs.remote`` a pair is retried, written, read back and
  verified; each package reads the other's pair from the same store; a
  torn write (``ckpt.write`` truncated) is caught when read and the
  lineage falls back.  fsspec's own in-memory store (``memory://``,
  imported only when used) serves the same calls.
- ``set_checkpoint(async_write=True)``: every asynchronous snapshot of a
  ResNet run (a snapshot every iteration) is bit-equal to the synchronous
  run's of the same iteration; a write error surfaces at the next
  boundary, and at ``wait_for_async_checkpoints``.
"""

import os
import posixpath

import numpy as np
import pytest
import torch

import jax
from bigdl_tpu.utils import file_io as jio

import bigdl_torch.nn as tnn
from bigdl_torch.dataset import DataSet, Sample
from bigdl_torch.models import resnet as tresnet
from bigdl_torch.optim import SGD, Optimizer, Trigger
from bigdl_torch.utils import chaos as tchaos
from bigdl_torch.utils import file_io as tio


class MemStore:
    """A flat in-process object store: the filesystem interface of
    ``file_io`` over a dict of path -> bytes."""

    def __init__(self, blobs=None):
        self.blobs = {} if blobs is None else blobs
        self.writes = 0

    def write_bytes(self, path, data):
        self.writes += 1
        self.blobs[path] = bytes(data)

    def read_bytes(self, path):
        return self.blobs[path]

    def exists(self, path):
        return path in self.blobs

    def isdir(self, path):
        return any(k.startswith(path.rstrip("/") + "/") for k in self.blobs)

    def listdir(self, path):
        pre = path.rstrip("/") + "/"
        return sorted({k[len(pre):].split("/")[0] for k in self.blobs
                       if k.startswith(pre)})

    def makedirs(self, path):
        pass

    def rename(self, src, dst):
        self.blobs[dst] = self.blobs.pop(src)

    def remove(self, path):
        del self.blobs[path]


@pytest.fixture
def store():
    shared = {}
    tstore, jstore = MemStore(shared), MemStore(shared)
    tio.register_filesystem("memt", tstore)
    jio.register_filesystem("memt", jstore)
    yield tstore
    tio._REGISTRY.pop("memt", None)
    jio._REGISTRY.pop("memt", None)


def _blob(seed):
    rs = np.random.RandomState(seed)
    return ({"params": [{"weight": rs.standard_normal((3, 2))
                         .astype(np.float32)}], "state": [{}]},
            {"method": {"hyper": {"neval": seed}}, "driver_state":
             {"neval": seed + 1, "epoch": 1}})


def _same(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(la, lb))


# -- RetryPolicy ---------------------------------------------------------------

def test_backoff_schedule_like_reference():
    kw = dict(retries=8, base=0.05, max_delay=2.0, deadline=60.0)
    t, j = tio.RetryPolicy(**kw), jio.RetryPolicy(**kw)
    assert [t.delay(a) for a in range(1, 9)] == \
        [j.delay(a) for a in range(1, 9)]


@pytest.mark.parametrize("fails,deadline", [(2, 60.0), (6, 60.0),
                                            (6, 0.3)])
def test_retry_run_like_reference(fails, deadline):
    """The same attempts, sleeps and outcome on an injected clock."""
    out = []
    for mod in (jio, tio):
        now, slept, calls = [0.0], [], [0]

        def sleep(d, now=now, slept=slept):
            slept.append(d)
            now[0] += d

        def fn(calls=calls):
            calls[0] += 1
            if calls[0] <= fails:
                raise OSError(f"flake {calls[0]}")
            return "ok"
        pol = mod.RetryPolicy(retries=4, base=0.1, max_delay=1.0,
                              deadline=deadline, clock=lambda: now[0],
                              sleep=sleep)
        try:
            res = pol.run(fn)
        except OSError as e:
            res = str(e)
        out.append((res, calls[0], slept))
    assert out[0] == out[1]


def test_retry_timebase_swap():
    prev = tio.set_retry_timebase(clock=lambda: 5.0, sleep=lambda d: None)
    try:
        assert tio.RetryPolicy().clock() == 5.0
    finally:
        tio.set_retry_timebase(*prev)


# -- a registered store ---------------------------------------------------------

def test_remote_pair_retried_written_verified(store):
    with tchaos.scoped("fs.remote=fail*2@1"):
        mp, op = tio.save_checkpoint("memt://run", 3, *_blob(3))
        assert tchaos.counts()["fs.remote"] > 2
    assert (mp, op) == ("memt://run/model.3", "memt://run/optimMethod.3")
    tio.verify(mp)
    assert _same(tio.load(mp), _blob(3)[0])
    assert tio.latest_checkpoint("memt://run")[2] == 3


def test_packages_read_each_others_remote_pairs(store):
    tio.save_checkpoint("memt://a", 1, *_blob(1))
    jio.save_checkpoint("memt://a", 2, *_blob(2))
    assert _same(jio.load("memt://a/model.1"), _blob(1)[0])
    assert _same(tio.load("memt://a/optimMethod.2"), _blob(2)[1])
    assert [n for *_, n in tio.checkpoint_lineage("memt://a")] == \
        [n for *_, n in jio.checkpoint_lineage("memt://a")] == [2, 1]


def test_torn_remote_write_caught_and_lineage_falls_back(store):
    tio.save_checkpoint("memt://b", 1, *_blob(1))
    with tchaos.scoped("ckpt.write=truncate@1"):
        tio.save_checkpoint("memt://b", 2, *_blob(2))
    with pytest.raises(tio.CorruptCheckpoint, match="truncated"):
        tio.load("memt://b/model.2")
    tio.quarantine_checkpoint("memt://b/model.2", "memt://b/optimMethod.2")
    assert tio.latest_checkpoint("memt://b")[2] == 1
    assert "b/model.2.corrupt" in "".join(store.blobs)


def test_fsspec_memory_store():
    pytest.importorskip("fsspec")
    path = "memory://bigdl-torch-test/run"
    try:
        tio.save_checkpoint(path, 4, *_blob(4))
        assert _same(tio.load(path + "/model.4"), _blob(4)[0])
        assert _same(jio.load(path + "/model.4"), _blob(4)[0])
        assert tio.latest_checkpoint(path)[2] == 4
    finally:
        tio._REGISTRY["memory"].remove(path + "/model.4")
        tio._REGISTRY["memory"].remove(path + "/optimMethod.4")


# -- asynchronous writes ---------------------------------------------------------

def _resnet_opt(path, async_write):
    m = tnn.Sequential()
    m.add(tresnet._conv(3, 8, 3, 3, 2, 2, 1, 1))
    m.add(tnn.SpatialBatchNormalization(8)).add(tnn.ReLU())
    b1, ch = tresnet._bottleneck(8, 4, 2, "B")
    m.add(tnn.Sequential().add(b1))
    m.add(tnn.SpatialAveragePooling(4, 4, 1, 1))
    m.add(tnn.Reshape((ch,))).add(tnn.Linear(ch, 10))
    tnn.fuse_conv_bn(m)
    m.build("cpu", torch.Generator().manual_seed(1))
    rs = np.random.RandomState(3)
    x = rs.standard_normal((16, 16, 16, 3)).astype(np.float32)
    y = rs.randint(0, 10, 16).astype(np.int32)
    opt = Optimizer(m, DataSet.array([Sample.from_ndarray(x[i], y[i])
                                      for i in range(16)]),
                    tnn.CrossEntropyCriterion(), batch_size=8, device="cpu")
    opt.set_optim_method(SGD(0.1, momentum=0.9))
    opt.set_checkpoint(path, Trigger.several_iteration(1),
                       async_write=async_write)
    opt.set_end_when(Trigger.max_iteration(4))
    return opt


def test_async_snapshots_bit_equal_to_sync(tmp_path):
    sync, asyn = str(tmp_path / "sync"), str(tmp_path / "async")
    _resnet_opt(sync, False).optimize()
    opt = _resnet_opt(asyn, True)
    opt.optimize()
    assert not opt._ckpt_futures
    names = sorted(os.listdir(sync))
    assert names == sorted(os.listdir(asyn))
    assert "model.4" in names and "optimMethod.3" in names
    for n in names:
        a, b = tio.load(os.path.join(sync, n)), tio.load(os.path.join(asyn,
                                                                      n))
        assert _same(a, b), n
        assert posixpath.basename(n).startswith(("model", "optimMethod"))


def test_async_write_error_surfaces_at_next_boundary(tmp_path, monkeypatch):
    monkeypatch.setenv("BIGDL_TORCH_RETRY_TIMES", "0")
    target = tmp_path / "not-a-dir"
    target.write_text("a file where the checkpoint directory would be")
    opt = _resnet_opt(str(target), True)
    with pytest.raises((FileExistsError, NotADirectoryError, OSError)):
        opt.optimize()


def test_async_write_error_surfaces_at_wait(tmp_path):
    target = tmp_path / "not-a-dir"
    target.write_text("file blocks the directory")
    tio.save_checkpoint_async(str(target), 1, {"p": np.zeros(2)}, {"o": 1})
    with pytest.raises(Exception):
        tio.wait_for_async_checkpoints()


def test_async_pair_lands_and_joins(tmp_path):
    futs = [tio.save_checkpoint_async(str(tmp_path), n, *_blob(n))
            for n in (1, 2, 3)]
    tio.join_checkpoints(futs)
    assert [n for *_, n in tio.checkpoint_lineage(str(tmp_path))] == \
        [3, 2, 1]
    assert _same(jio.load(str(tmp_path / "model.3")), _blob(3)[0])
