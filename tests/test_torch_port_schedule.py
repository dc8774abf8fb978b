"""The pipeline schedule tables of the port against the JAX package's.

``bigdl_torch/parallel/schedule.py`` is the reference's pure-Python
``build_schedule``, copied: every field of every ``ScheduleTable`` (the per-tick
grids, the stash geometry, the idle count, the per-device in-flight
peaks) must equal the reference's, for ``gpipe`` and ``1f1b`` over a grid
of (devices n, microbatches m, virtual stages v) that includes the
reference tests' (2, 8, 2) and (2, 16, 2).  So must ``bubble_fraction``,
``peak_inflight``, ``stack_index`` and ``stage_of_stack_index``,
``verify()`` must catch a corrupted table, and bad inputs must raise as
the reference's do.  Comparisons are exact (ints and the same float
expressions).
"""

import copy
import dataclasses

import pytest

from bigdl_tpu.parallel import schedule as jsched

from bigdl_torch.parallel import schedule as tsched

GRID = [(n, m, v) for n in (1, 2, 3, 4) for m in (1, 2, 3, 4, 8, 16)
        for v in (1, 2, 3)] + [(2, 8, 2), (2, 16, 2), (8, 8, 1), (4, 32, 2)]


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_tables_field_equal(schedule):
    for n, m, v in GRID:
        got = tsched.build_schedule(schedule, n, m, v)
        want = jsched.build_schedule(schedule, n, m, v)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), \
            (schedule, n, m, v)
        assert got.peak_inflight == want.peak_inflight
        assert got.bubble_fraction == want.bubble_fraction
        assert got.num_stages == want.num_stages == n * v


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_bubble_fraction_equal(schedule):
    for n, m, v in GRID:
        assert tsched.bubble_fraction(n, m, schedule, v) == \
            jsched.bubble_fraction(n, m, schedule, v), (schedule, n, m, v)


def test_stack_index_and_inverse_equal():
    for n in (1, 2, 3, 4):
        for v in (1, 2, 3):
            rows = [tsched.stack_index(s, n, v) for s in range(n * v)]
            assert rows == [jsched.stack_index(s, n, v)
                            for s in range(n * v)]
            assert sorted(rows) == list(range(n * v))
            for k in range(n * v):
                s = tsched.stage_of_stack_index(k, n, v)
                assert s == jsched.stage_of_stack_index(k, n, v)
                assert tsched.stack_index(s, n, v) == k


def test_known_values():
    """The reference tests' headline numbers: 1F1B's bubble equals
    GPipe's at v = 1 and interleaving cuts it; 1F1B holds n stage inputs
    where GPipe holds m·v."""
    assert tsched.bubble_fraction(2, 4) == pytest.approx(1 / 5)
    g, f = (tsched.build_schedule(s, 2, 8, 1) for s in ("gpipe", "1f1b"))
    assert g.bubble_fraction == f.bubble_fraction
    assert g.peak_inflight == 8 and f.peak_inflight == 2
    f2 = tsched.build_schedule("1f1b", 2, 8, 2)
    assert f2.bubble_fraction < f.bubble_fraction
    assert tsched.bubble_fraction(1, 8, "1f1b", 3) == 0.0


def _target(tbl, field, i, d):
    """Whether tick i of device d holds an entry of ``field`` to
    corrupt."""
    if field == "recv_f_slot":
        return tbl.recv_f_slot[i][d] != tbl.fstash_slots
    want = {"fwd_in_slot": 1, "bwd_in_slot": 2}.get(field)
    if want is None:
        return tbl.act[i][d] != 0
    return (tbl.act[i][d] == want and not tbl.fwd_feed[i][d]
            and not tbl.bwd_feed[i][d])


@pytest.mark.parametrize("field", ["act", "fwd_in_slot", "bwd_in_slot",
                                   "mb", "recv_f_slot"])
def test_verify_catches_corruption(field):
    """One entry of the first tick of a device (1, else 0) that holds one
    of the field's kind changed: both packages' ``verify()`` raise the same
    AssertionError; the intact table verifies."""
    msgs = []
    for mod in (tsched, jsched):
        tbl = copy.deepcopy(mod.build_schedule("1f1b", 2, 4, 1))
        tbl.verify()
        grid = getattr(tbl, field)
        t, d = next((i, d) for d in (1, 0) for i in range(tbl.ticks)
                    if _target(tbl, field, i, d))
        grid[t][d] = {"act": 0, "mb": (grid[t][d] + 1) % 4,
                      "recv_f_slot": tbl.fstash_slots}.get(
                          field, grid[t][d] + 1)
        with pytest.raises(AssertionError) as err:
            tbl.verify()
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("args", [("zb", 2, 4, 1), ("gpipe", 0, 4, 1),
                                  ("1f1b", 2, 0, 1), ("1f1b", 2, 4, 0)])
def test_bad_inputs_raise_alike(args):
    for mod in (tsched, jsched):
        with pytest.raises(ValueError) as err:
            mod.build_schedule(*args)
        assert ("unknown pipeline schedule" in str(err.value)) == \
            (args[0] == "zb")
    assert tsched.SCHEDULES == jsched.SCHEDULES
    assert (tsched.IDLE, tsched.FWD, tsched.BWD) == \
        (jsched.IDLE, jsched.FWD, jsched.BWD)
