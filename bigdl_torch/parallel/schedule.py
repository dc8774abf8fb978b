"""Pipeline schedule tables: GPipe and 1F1B (+ interleaved virtual stages).

Counterpart of ``bigdl_tpu/parallel/schedule.py``, pure Python and copied
so that every table is the reference's, field for field.  GPipe pays an
idle "bubble" of ``(n-1)/(m+n-1)`` per step (n stages, m microbatches)
and activation memory that grows with *m*, because every microbatch's
forward completes before any backward starts.  This module builds the
**per-tick schedule table** that ``parallel/pipeline.py`` executes over
the ranks of a ``pipe`` process group.

Model
-----
Time is sliced into **ticks**; per tick each of the ``n`` pipe ranks
performs exactly one unit of work — a stage **forward** on one
microbatch, a stage **backward** (the stage recomputed from its stashed
input and differentiated), or an idle slot — and one send/recv hop per
direction delivers the values produced at tick ``t`` to their neighbour
at tick ``t+1``.  With ``virtual_stages = v`` each rank owns ``v``
non-contiguous stage slices (global stage ``s`` lives on rank
``s mod n`` — the Megatron interleaved placement), so a microbatch rings
around the group ``v`` times.

Two table kinds:

- ``"gpipe"`` — forward-only.  The backward is the transpose of the
  forward table, run tick by tick in reverse (the reverse pipeline), so
  only the forward order needs a table; the combined bubble fraction
  equals the forward one.
- ``"1f1b"`` — combined forward+backward, one-forward-one-backward
  (PipeDream-flush / Megatron).  Per rank: a warmup run of forwards,
  then strict F/B alternation, then a backward cooldown.  Microbatches
  advance in **chunk groups of n** across the ``v`` slices (ascending
  slices forward, descending backward) — the interleaved order that
  cuts the warmup/cooldown bubble by ``~1/v``.

``build_schedule`` list-schedules those per-rank orders against the real
dependencies (activation/cotangent arrival one tick after production)
and then assigns **stash slots**: every in-flight stage input (saved for
its backward) and every in-flight cotangent gets a buffer slot whose
lifetime the table knows exactly.  The peak number of live stage-input
slots IS the schedule's activation-memory claim — ``n`` microbatches in
steady state for 1F1B (``≈ 2(n-1)+(v-1)n+1`` interleaved) versus
``m·v`` for GPipe — exposed as :attr:`ScheduleTable.peak_inflight`.

Every built table is re-verified step by step (:meth:`ScheduleTable
.verify`): each unit exactly once, every read slot holds the value the
dependency produced, no slot is overwritten while live.  Tables are
tiny (T×n ints) and built once per geometry, so verification is always
on.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

__all__ = ["ScheduleTable", "build_schedule", "bubble_fraction",
           "stack_index", "stage_of_stack_index", "SCHEDULES"]

#: the two schedules BIGDL_TORCH_PIPE_SCHEDULE accepts
SCHEDULES = ("gpipe", "1f1b")

#: action codes in ScheduleTable.act
IDLE, FWD, BWD = 0, 1, 2


def stack_index(stage: int, n_devices: int, virtual_stages: int) -> int:
    """Row of global stage ``s`` in the stacked param axis.  Stages are
    stacked device-major (device ``s mod n`` holds rows ``[d*v, d*v+v)``)
    so a contiguous split of the ``n*v``-row stack hands every device
    exactly its ``v`` interleaved slices.  Identity when v=1."""
    d, j = stage % n_devices, stage // n_devices
    return d * virtual_stages + j


def stage_of_stack_index(k: int, n_devices: int, virtual_stages: int) -> int:
    """Inverse of :func:`stack_index`: global stage held in stack row k."""
    d, j = k // virtual_stages, k % virtual_stages
    return j * n_devices + d


def _fwd_order(n: int, v: int, m: int, d: int) -> List[Tuple[int, int]]:
    """Device d's forward work order: microbatches in chunk groups of n,
    slices ascending within a group (Megatron interleaved order; plain
    FIFO when v == 1)."""
    seq = []
    g = 0
    while g * n < m:
        mbs = range(g * n, min((g + 1) * n, m))
        for j in range(v):
            seq.extend((j * n + d, i) for i in mbs)
        g += 1
    return seq


def _bwd_order(n: int, v: int, m: int, d: int) -> List[Tuple[int, int]]:
    """Device d's backward work order: same chunk groups, slices
    descending (cotangents flow from the deepest slice back out)."""
    seq = []
    g = 0
    while g * n < m:
        mbs = range(g * n, min((g + 1) * n, m))
        for j in reversed(range(v)):
            seq.extend((j * n + d, i) for i in mbs)
        g += 1
    return seq


def _warmup(n: int, v: int, d: int, total: int) -> int:
    """1F1B warmup forwards for device d before strict F/B alternation:
    the classic ``n-d-1`` at v=1, Megatron's ``2(n-d-1)+(v-1)n`` when
    interleaved, both capped at the device's total forward count."""
    w = (n - d - 1) if v == 1 else (n - d - 1) * 2 + (v - 1) * n
    return min(w, total)


@dataclass
class ScheduleTable:
    """A fully resolved per-tick schedule (see module docstring).

    All per-tick fields are ``ticks x n_devices`` nested lists of ints —
    the executor reads them on the host.  Slot index
    conventions: ``fstash``/``bstash`` hold one microbatch-shaped value
    per slot, slot ``fstash_slots`` (resp. ``bstash_slots``) is the
    write-discard "trash" slot, and ``out``/``dx`` buffers use row ``m``
    as trash."""

    schedule: str
    n_devices: int
    virtual_stages: int
    microbatches: int
    with_bwd: bool
    ticks: int = 0
    # per-tick [T][n] tables
    act: List[List[int]] = field(default_factory=list)
    slice_idx: List[List[int]] = field(default_factory=list)
    mb: List[List[int]] = field(default_factory=list)
    fwd_feed: List[List[int]] = field(default_factory=list)
    fwd_in_slot: List[List[int]] = field(default_factory=list)
    fwd_store_slot: List[List[int]] = field(default_factory=list)
    recv_f_slot: List[List[int]] = field(default_factory=list)
    out_idx: List[List[int]] = field(default_factory=list)
    bwd_feed: List[List[int]] = field(default_factory=list)
    bwd_in_slot: List[List[int]] = field(default_factory=list)
    bwd_x_slot: List[List[int]] = field(default_factory=list)
    recv_b_slot: List[List[int]] = field(default_factory=list)
    dx_idx: List[List[int]] = field(default_factory=list)
    # stash geometry + headline metrics
    fstash_slots: int = 0
    bstash_slots: int = 0
    idle_slots: int = 0
    peak_inflight_per_device: List[int] = field(default_factory=list)

    @property
    def num_stages(self) -> int:
        return self.n_devices * self.virtual_stages

    @property
    def bubble_fraction(self) -> float:
        """Idle fraction of the schedule's device-tick grid."""
        return self.idle_slots / max(self.n_devices * self.ticks, 1)

    @property
    def peak_inflight(self) -> int:
        """Max stage-input activations simultaneously live on any one
        device (saved-for-backward microbatches) — the schedule's
        activation-memory bound.  GPipe's backward-by-transpose keeps
        every microbatch alive, so its effective value is ``m * v``
        regardless of this (forward-only) table's stash."""
        if not self.with_bwd:
            return self.microbatches * self.virtual_stages
        return max(self.peak_inflight_per_device, default=0)

    def verify(self) -> None:
        """Replay the table against an abstract stash machine; raise
        AssertionError on any inconsistency (missed/duplicate unit, read
        of a slot holding the wrong value, overwrite of a live slot,
        send/recv mismatch)."""
        n, v, m, S = (self.n_devices, self.virtual_stages,
                      self.microbatches, self.num_stages)
        fstash = [[None] * (self.fstash_slots + 1) for _ in range(n)]
        bstash = [[None] * (self.bstash_slots + 1) for _ in range(n)]
        f_done: Dict[Tuple[int, int], int] = {}
        b_done: Dict[Tuple[int, int], int] = {}
        y_wire = [None] * n  # value in flight dev d -> d+1
        g_wire = [None] * n  # value in flight dev d -> d-1
        out_seen, dx_seen = set(), set()
        idle = 0
        for t in range(self.ticks):
            # deliver last tick's sends (the hop at tick start)
            for d in range(n):
                slot = self.recv_f_slot[t][d]
                val = y_wire[(d - 1) % n]
                if slot != self.fstash_slots:
                    assert val is not None, (t, d, "recv_f of nothing")
                    assert fstash[d][slot] is None, \
                        (t, d, slot, "fstash overwrite of live slot")
                    fstash[d][slot] = val
                slot = self.recv_b_slot[t][d]
                val = g_wire[(d + 1) % n]
                if slot != self.bstash_slots:
                    assert val is not None, (t, d, "recv_b of nothing")
                    assert bstash[d][slot] is None, \
                        (t, d, slot, "bstash overwrite of live slot")
                    bstash[d][slot] = val
            y_next, g_next = [None] * n, [None] * n
            for d in range(n):
                a = self.act[t][d]
                if a == IDLE:
                    idle += 1
                    continue
                j, i = self.slice_idx[t][d], self.mb[t][d]
                s = j * n + d
                if a == FWD:
                    assert (s, i) not in f_done, (t, d, s, i, "dup F")
                    if self.fwd_feed[t][d]:
                        assert s == 0
                        x_val = ("x", i)
                    else:
                        slot = self.fwd_in_slot[t][d]
                        x_val = fstash[d][slot]
                        assert x_val == ("act", s - 1, i), \
                            (t, d, s, i, x_val, "wrong F input")
                        if not self.with_bwd:
                            fstash[d][slot] = None  # consumed by F
                    if self.fwd_store_slot[t][d] != self.fstash_slots:
                        assert fstash[d][self.fwd_store_slot[t][d]] is None
                        fstash[d][self.fwd_store_slot[t][d]] = x_val
                    f_done[(s, i)] = t
                    y_next[d] = ("act", s, i)
                    if self.out_idx[t][d] != m:
                        assert s == S - 1 and self.out_idx[t][d] == i
                        out_seen.add(i)
                else:
                    assert self.with_bwd, "BWD action in a fwd-only table"
                    assert (s, i) not in b_done, (t, d, s, i, "dup B")
                    assert f_done.get((s, i), t) < t, (s, i, "B before F")
                    slot = self.bwd_x_slot[t][d]
                    x_val = fstash[d][slot]
                    want = ("x", i) if s == 0 else ("act", s - 1, i)
                    assert x_val == want, (t, d, s, i, x_val, "wrong B x")
                    fstash[d][slot] = None  # saved input consumed
                    if self.bwd_feed[t][d]:
                        assert s == S - 1
                    else:
                        gslot = self.bwd_in_slot[t][d]
                        g_val = bstash[d][gslot]
                        assert g_val == ("cot", s + 1, i), \
                            (t, d, s, i, g_val, "wrong B cotangent")
                        bstash[d][gslot] = None
                    b_done[(s, i)] = t
                    g_next[d] = ("cot", s, i)
                    if self.dx_idx[t][d] != m:
                        assert s == 0 and self.dx_idx[t][d] == i
                        dx_seen.add(i)
            y_wire, g_wire = y_next, g_next
        assert len(f_done) == S * m, "missing forwards"
        assert idle == self.idle_slots
        if self.with_bwd:
            assert len(b_done) == S * m, "missing backwards"
            assert dx_seen == set(range(m)), "missing dx microbatches"
        else:
            assert out_seen == set(range(m)), "missing outputs"


class _SlotPool:
    """Interval slot allocator: first free slot at acquire, freed slots
    reusable the tick AFTER release (a consumer reads during its tick;
    same-tick rebirth would race the arrival write)."""

    def __init__(self):
        self.free: List[int] = []
        self.next = 0
        self.pending: List[Tuple[int, int]] = []  # (free_at_tick, slot)

    def acquire(self, t: int) -> int:
        self.pending.sort()
        while self.pending and self.pending[0][0] <= t:
            self.free.append(self.pending.pop(0)[1])
        if self.free:
            return self.free.pop(0)
        slot = self.next
        self.next += 1
        return slot

    def release(self, t: int, slot: int) -> None:
        self.pending.append((t + 1, slot))


@lru_cache(maxsize=64)
def build_schedule(schedule: str, n_devices: int, microbatches: int,
                   virtual_stages: int = 1) -> ScheduleTable:
    """Build (and verify) the schedule table for the given geometry.

    ``schedule="gpipe"`` builds the forward-only table (the backward is
    its transpose); ``"1f1b"`` builds the combined forward+backward
    table.  Cached: geometry is tiny and reused every step."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {schedule!r} "
                         f"(expected one of {SCHEDULES})")
    n, v, m = int(n_devices), int(virtual_stages), int(microbatches)
    if n < 1 or v < 1 or m < 1:
        raise ValueError(f"bad schedule geometry n={n} v={v} m={m}")
    with_bwd = schedule == "1f1b"
    S = n * v
    tbl = ScheduleTable(schedule=schedule, n_devices=n, virtual_stages=v,
                        microbatches=m, with_bwd=with_bwd)

    orders: List[List[Tuple[str, int, int]]] = []
    for d in range(n):
        f = _fwd_order(n, v, m, d)
        if not with_bwd:
            orders.append([("F",) + u for u in f])
            continue
        b = _bwd_order(n, v, m, d)
        w = _warmup(n, v, d, len(f))
        seq = [("F",) + u for u in f[:w]]
        fi, bi = w, 0
        while fi < len(f) or bi < len(b):
            if fi < len(f):
                seq.append(("F",) + f[fi])
                fi += 1
            if bi < len(b):
                seq.append(("B",) + b[bi])
                bi += 1
        orders.append(seq)

    ptr = [0] * n
    f_done: Dict[Tuple[int, int], int] = {}
    b_done: Dict[Tuple[int, int], int] = {}
    # slot bookkeeping: where each (stage, mb) activation/cotangent lives
    fpool = [_SlotPool() for _ in range(n)]
    bpool = [_SlotPool() for _ in range(n)]
    f_slot: Dict[Tuple[int, int], int] = {}
    b_slot: Dict[Tuple[int, int], int] = {}
    rows: List[List[Optional[Tuple[str, int, int]]]] = []
    recv_f: List[List[Tuple[int, int]]] = []   # per tick: (d, slot) writes
    recv_b: List[List[Tuple[int, int]]] = []
    t = 0
    total = sum(len(o) for o in orders)
    done = 0
    while done < total:
        assert t < 4 * (total + S), "schedule failed to converge"
        row: List[Optional[Tuple[str, int, int]]] = [None] * n
        rf: List[Tuple[int, int]] = []
        rb: List[Tuple[int, int]] = []
        # arrivals from tick t-1's work land first (consumable this tick)
        for d in range(n):
            prev = rows[t - 1][(d - 1) % n] if t else None
            if prev is not None and prev[0] == "F":
                _, s, i = prev
                if s < S - 1:  # last stage's y has no consumer
                    slot = fpool[d].acquire(t)
                    f_slot[(s + 1, i)] = slot  # stage input of s+1
                    rf.append((d, slot))
            prev = rows[t - 1][(d + 1) % n] if t else None
            if prev is not None and prev[0] == "B":
                _, s, i = prev
                if s > 0:  # stage 0's dx exits via dx_buf, not the ring
                    slot = bpool[d].acquire(t)
                    b_slot[(s, i)] = slot  # cotangent consumed by B(s-1)
                    rb.append((d, slot))
        fd, bd = dict(f_done), dict(b_done)
        for d in range(n):
            if ptr[d] >= len(orders[d]):
                continue
            kind, s, i = orders[d][ptr[d]]
            if kind == "F":
                ok = s == 0 or fd.get((s - 1, i), t) < t
            else:
                ok = fd.get((s, i), t) < t and (
                    s == S - 1 or bd.get((s + 1, i), t) < t)
            if ok:
                row[d] = (kind, s, i)
                ptr[d] += 1
                done += 1
                if kind == "F":
                    f_done[(s, i)] = t
                    if with_bwd and s == 0:
                        # feed stored at F time, consumed by B(0, i)
                        f_slot[(0, i)] = fpool[d].acquire(t)
                else:
                    b_done[(s, i)] = t
        # releases: consumed slots free next tick
        for d in range(n):
            ch = row[d]
            if ch is None:
                continue
            kind, s, i = ch
            if kind == "F" and s > 0 and not with_bwd:
                fpool[d].release(t, f_slot[(s, i)])
            elif kind == "B":
                fpool[d].release(t, f_slot[(s, i)])
                if s < S - 1:
                    bpool[d].release(t, b_slot[(s + 1, i)])
        rows.append(row)
        recv_f.append(rf)
        recv_b.append(rb)
        t += 1

    T = len(rows)
    Sf = max(p.next for p in fpool)
    Sb = max((p.next for p in bpool), default=0)
    tbl.ticks = T
    tbl.fstash_slots = Sf
    tbl.bstash_slots = Sb
    trash_f, trash_b, trash_m = Sf, Sb, m

    def grid(fill):
        return [[fill] * n for _ in range(T)]

    tbl.act = grid(IDLE)
    tbl.slice_idx = grid(0)
    tbl.mb = grid(0)
    tbl.fwd_feed = grid(0)
    tbl.fwd_in_slot = grid(0)
    tbl.fwd_store_slot = grid(trash_f)
    tbl.recv_f_slot = grid(trash_f)
    tbl.out_idx = grid(trash_m)
    tbl.bwd_feed = grid(0)
    tbl.bwd_in_slot = grid(0)
    tbl.bwd_x_slot = grid(0)
    tbl.recv_b_slot = grid(trash_b)
    tbl.dx_idx = grid(trash_m)

    idle = 0
    for t, row in enumerate(rows):
        for d, slot in recv_f[t]:
            tbl.recv_f_slot[t][d] = slot
        for d, slot in recv_b[t]:
            tbl.recv_b_slot[t][d] = slot
        for d in range(n):
            ch = row[d]
            if ch is None:
                idle += 1
                continue
            kind, s, i = ch
            tbl.slice_idx[t][d] = s // n
            tbl.mb[t][d] = i
            if kind == "F":
                tbl.act[t][d] = FWD
                if s == 0:
                    tbl.fwd_feed[t][d] = 1
                    if with_bwd:
                        tbl.fwd_store_slot[t][d] = f_slot[(0, i)]
                else:
                    tbl.fwd_in_slot[t][d] = f_slot[(s, i)]
                if s == S - 1 and not with_bwd:
                    tbl.out_idx[t][d] = i
            else:
                tbl.act[t][d] = BWD
                tbl.bwd_x_slot[t][d] = f_slot[(s, i)]
                if s == S - 1:
                    tbl.bwd_feed[t][d] = 1
                else:
                    tbl.bwd_in_slot[t][d] = b_slot[(s + 1, i)]
                if s == 0:
                    tbl.dx_idx[t][d] = i
    tbl.idle_slots = idle

    # in-flight stage inputs per device: live from arrival (or stage-0
    # feed) until the backward consumes them
    if with_bwd:
        for d in range(n):
            ev = []
            for j in range(v):
                for i in range(m):
                    s = j * n + d
                    birth = f_done[(s, i)] if s == 0 else f_done[(s - 1, i)] + 1
                    ev.append((birth, 1))
                    ev.append((b_done[(s, i)] + 1, -1))
            ev.sort()
            cur = peak = 0
            for _, delta in ev:
                cur += delta
                peak = max(peak, cur)
            tbl.peak_inflight_per_device.append(peak)

    tbl.verify()
    return tbl


def bubble_fraction(num_stages: int, num_microbatches: int,
                    schedule: str = "gpipe",
                    virtual_stages: int = 1) -> float:
    """Idle fraction of the pipeline schedule's device-tick grid.

    ``num_stages`` is the **pipe-mesh width** (devices); the model runs
    ``num_stages * virtual_stages`` stage slices.  For the classic GPipe
    geometry (v=1) this is the closed form ``(n-1)/(m+n-1)``; every
    other (schedule, v) combination is measured off the actual table —
    1F1B at v=1 matches GPipe exactly (its win is memory: ``n`` in-flight
    microbatches instead of ``m``), and interleaving cuts the
    warmup/cooldown bubble by ``~1/v``."""
    n, m, v = int(num_stages), int(num_microbatches), int(virtual_stages)
    if n <= 1:
        return 0.0
    if schedule == "gpipe" and v == 1:
        return (n - 1) / max(m + n - 1, 1)
    return build_schedule(schedule, n, m, v).bubble_fraction
