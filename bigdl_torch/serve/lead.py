"""One rank leads, the others follow: the messages of a model served on a mesh.

The reference runs a version served on a mesh as one SPMD program in one
process.  Here a mesh is several processes, one a rank, so what that
program decides once is decided by one rank and sent to the others:

- The **leader** is the rank at coordinate 0 of the mesh, unless the
  caller names another (the topology router's rank 0 leads every member,
  ``serve/router.py``).  It owns the queue, the batcher, the tenant
  quotas, the canary, the choice of version, and in the decode engine the
  admissions and every sampled token.  ``submit`` and ``predict`` are
  called on it alone.
- The **lead group** is the leader and the mesh's ranks: a gloo group
  (messages are host tensors) formed on every rank of the world when the
  mesh is registered (``Engine.register_mesh``; the router forms the
  groups of leaders off the mesh), with the Engine's timeout.  A
  follower waits there while its leader is idle, so an idle leader sends
  a no-op every :data:`KEEPALIVE_S` seconds (:meth:`Lead.keep_alive`,
  until it sends stop): a rank that stops following fails the leader's
  next message within the timeout instead of hanging it.
- A **message** is a broadcast from the leader over the lead group: a
  fixed int64 header (the op, up to 16 integers, an array's dtype and
  shape, a blob's length), then the array, then the blob (a pickle),
  each where present.  The ops: a padded batch with its version id, a
  swap, a decode engine's prefill plan and tick plan, the activation and
  retirement of a router member, and stop.
- The **followers**, every other rank of the lead group, run a follow
  loop: take one message, act on it, until the message that ends it.
  Every rank of the mesh runs the forward a batch message starts (its
  collectives span the mesh).  A leader off the mesh takes the answer
  from the mesh's coordinate-0 rank, sent to it alone (point to point
  over the lead group).
- **One lock a lead** (re-entrant): on the leader a message and the
  forward it starts hold it together, so the threads that share one mesh
  (a server's replicas, its restarts, a swap, the autoscaler) issue its
  collectives in one order; two threads that issue collectives on one
  group in different orders deadlock.  No other thread uses the group.
"""

from __future__ import annotations

import pickle
import threading
import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Lead", "Message", "BATCH", "SWAP", "PREFILL", "TICK",
           "ACTIVATE", "RETIRE", "STOP"]

# the ops
BATCH, SWAP, PREFILL, TICK, ACTIVATE, RETIRE, STOP, NOOP = range(1, 9)
OP_NAMES = {BATCH: "batch", SWAP: "swap", PREFILL: "prefill",
            TICK: "tick", ACTIVATE: "activate", RETIRE: "retire",
            STOP: "stop"}

#: seconds an idle leader waits before a no-op (well inside the Engine's
#: 300 s collective timeout)
KEEPALIVE_S = 60.0

_HEADER = 32
_MAX_INTS = 16
_MAX_DIMS = 8
_DTYPES = (torch.float32, torch.float64, torch.int32, torch.int64,
           torch.uint8, torch.bool, torch.float16, torch.int16, torch.int8)


class Message(NamedTuple):
    """One message as a follower receives it."""

    op: int
    ints: tuple
    array: Optional[np.ndarray]
    blob: object


def _header(op: int, ints: Sequence[int], array: Optional[torch.Tensor],
            blob_len: int) -> torch.Tensor:
    if len(ints) > _MAX_INTS:
        raise ValueError(f"a message holds at most {_MAX_INTS} integers")
    h = torch.zeros(_HEADER, dtype=torch.int64)
    h[0], h[1] = op, len(ints)
    h[2:2 + len(ints)] = torch.tensor([int(i) for i in ints],
                                      dtype=torch.int64)
    h[18] = -1
    if array is not None:
        if array.dim() > _MAX_DIMS:
            raise ValueError(f"a message's array has at most {_MAX_DIMS} "
                             "dimensions")
        h[18] = _DTYPES.index(array.dtype)
        h[19] = array.dim()
        h[20:20 + array.dim()] = torch.tensor(array.shape, dtype=torch.int64)
    h[28] = blob_len
    return h


def _array_of(h: torch.Tensor) -> Optional[torch.Tensor]:
    code = int(h[18])
    if code < 0:
        return None
    shape = [int(d) for d in h[20:20 + int(h[19])]]
    return torch.empty(shape, dtype=_DTYPES[code])


def _host(array) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(array)).contiguous()


class Lead:
    """The lead of one mesh on this rank (module docstring): the mesh, its
    ranks, the leader's rank, the lead group and the lock.  ``leader``
    None: the mesh's coordinate-0 rank, and ``group`` the mesh's lead
    group; a leader off the mesh needs the ``group`` of it and the mesh's
    ranks, formed on every rank."""

    def __init__(self, mesh, leader: Optional[int] = None, group=None):
        from ..utils.engine import Engine
        st = Engine.mesh_state(mesh)
        self.mesh = mesh
        self.ranks = list(st.ranks)
        self.leader = self.ranks[0] if leader is None else int(leader)
        if group is None:
            if self.leader not in self.ranks:
                raise ValueError(f"a leader off the mesh (rank "
                                 f"{self.leader}, mesh {self.ranks}) needs "
                                 "the lead group of it and the mesh")
            group = st.lead
        self.group = group
        self.rank = dist.get_rank()
        self.on_mesh = self.rank in self.ranks
        self.is_leader = self.rank == self.leader
        if not (self.on_mesh or self.is_leader):
            raise ValueError(f"rank {self.rank} neither leads nor is on the "
                             f"mesh of ranks {self.ranks}")
        #: the rank that answers a leader off the mesh (coordinate 0)
        self.replier = None if self.leader in self.ranks else self.ranks[0]
        self.lock = threading.RLock()
        #: messages sent (leader) or received (follower), by op name, and
        #: the no-ops apart
        self.counts = {}
        self.noops = 0
        self._last_send = time.monotonic()
        self._quiet = threading.Event()   # set: no more no-ops
        self._beat: Optional[threading.Thread] = None

    def keep_alive(self) -> None:
        """Start (once) the leader's thread that sends a no-op whenever
        nothing was sent for :data:`KEEPALIVE_S` seconds, until stop."""
        if self._beat is None and self.is_leader:
            self._beat = threading.Thread(target=self._keep_alive,
                                          daemon=True,
                                          name="bigdl-torch-lead-keepalive")
            self._beat.start()

    def _keep_alive(self) -> None:
        while not self._quiet.wait(KEEPALIVE_S / 4):
            with self.lock:
                if not self._quiet.is_set() and \
                        time.monotonic() - self._last_send >= KEEPALIVE_S:
                    self.send(NOOP)

    def _count(self, op: int) -> None:
        name = OP_NAMES.get(op, str(op))
        self.counts[name] = self.counts.get(name, 0) + 1

    def _bcast(self, t: torch.Tensor) -> torch.Tensor:
        dist.broadcast(t, self.leader, group=self.group)
        return t

    def send(self, op: int, ints: Sequence[int] = (), array=None,
             blob=None) -> None:
        """Broadcast one message to the followers (the leader only)."""
        if not self.is_leader:
            raise RuntimeError(f"rank {self.rank} is not the leader "
                               f"({self.leader})")
        with self.lock:
            t = None if array is None else _host(array)
            data = None if blob is None else pickle.dumps(blob)
            self._bcast(_header(op, ints, t, 0 if data is None
                                else len(data)))
            if t is not None:
                self._bcast(t)
            if data is not None:
                self._bcast(torch.frombuffer(bytearray(data),
                                             dtype=torch.uint8))
            self._last_send = time.monotonic()
            if op == STOP:
                self._quiet.set()
            if op == NOOP:
                self.noops += 1
            else:
                self._count(op)

    def recv(self) -> Message:
        """The leader's next message but a no-op (a follower only; blocks
        until it comes)."""
        while True:
            h = self._bcast(torch.zeros(_HEADER, dtype=torch.int64))
            if int(h[0]) != NOOP:
                break
            self.noops += 1
        op, n = int(h[0]), int(h[1])
        array = _array_of(h)
        if array is not None:
            array = self._bcast(array).numpy()
        blob = None
        if int(h[28]) > 0:
            raw = self._bcast(torch.empty(int(h[28]), dtype=torch.uint8))
            blob = pickle.loads(raw.numpy().tobytes())
        self._count(op)
        return Message(op, tuple(int(i) for i in h[2:2 + n]), array, blob)

    # -- answers to a leader off the mesh ---------------------------------

    @property
    def replies(self) -> bool:
        """True on the rank that sends a leader off the mesh its answers."""
        return self.replier is not None and self.rank == self.replier

    def reply(self, array) -> None:
        """Send one answer (a host array) to the leader."""
        self.send_to(self.leader, array)

    def answer(self) -> np.ndarray:
        """The answer the mesh's coordinate-0 rank sends (the leader off
        the mesh only)."""
        return self.recv_from(self.replier)

    def send_to(self, rank: int, array) -> None:
        """One host array to ``rank`` alone, over the lead group."""
        t = _host(array)
        dist.send(_header(0, (), t, 0), rank, group=self.group)
        dist.send(t, rank, group=self.group)

    def recv_from(self, rank: int) -> np.ndarray:
        """The next array :meth:`send_to` sends from ``rank``."""
        h = torch.zeros(_HEADER, dtype=torch.int64)
        dist.recv(h, rank, group=self.group)
        t = _array_of(h)
        dist.recv(t, rank, group=self.group)
        return t.numpy()
