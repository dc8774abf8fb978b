"""A data-parallel run with Dropout, resumed from a snapshot, draws the
masks the uninterrupted run draws.

Two gloo ranks (started with ``subprocess``) train ``TransformerLM(vocab
97, 2 layers, dropout 0.1)`` with ``DataSet.array(distributed=True)``,
three iterations an epoch, and snapshot after iteration 3.  A second pair
of ranks resumes from that snapshot (each shuffling its dataset once first,
as the snapshot's one epoch did: the permutation is not in the snapshot,
as in the reference) and trains iterations 4 and 5.  The snapshot carries
every rank's Dropout generator (``"torch_rng_states"``, gathered to the
writer), so each rank restores its own and the losses of iterations 4 and
5 are bit-equal to the uninterrupted run's, on both ranks.  A resume at
another world (one process) seeds the generator as at a start and warns.

No tolerance: the losses compare bit for bit (float32 on the CPU, one
order of operations on both runs).
"""

import logging
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import bigdl_torch.nn as tnn
from bigdl_torch.dataset import DataSet, Sample
from bigdl_torch.models import transformer_lm as tlm
from bigdl_torch.optim import SGD, Optimizer, Trigger
from bigdl_torch.utils import file_io

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = textwrap.dedent('''
    import pickle, sys
    import numpy as np
    import torch
    from bigdl_torch import Engine
    import bigdl_torch.nn as nn
    from bigdl_torch.dataset import DataSet, Sample
    from bigdl_torch.models.transformer_lm import TransformerLM
    from bigdl_torch.optim import SGD, Optimizer, Trigger

    ckpt, out, resume = sys.argv[1], sys.argv[2], sys.argv[3] == "resume"
    Engine.init(device="cpu")
    toks = np.random.RandomState(0).randint(0, 97, (24, 17))
    toks = toks.astype(np.int32)
    ds = DataSet.array([Sample(toks[i, :-1], toks[i, 1:])
                        for i in range(24)], distributed=True)
    model = TransformerLM(97, max_len=16, d_model=32, num_heads=4,
                          num_layers=2, dropout=0.1).build(
        "cpu", torch.Generator().manual_seed(1))
    opt = Optimizer(model, ds, nn.TimeDistributedCriterion(
        nn.ClassNLLCriterion(), size_average=True), batch_size=4)
    opt.set_optim_method(SGD(0.1, momentum=0.9))
    if resume:
        ds.shuffle()
        opt.resume_from(ckpt + "/model.3", ckpt + "/optimMethod.3")
    else:
        opt.set_checkpoint(ckpt, Trigger(
            lambda s: s["neval"] - 1 == 3, "afterThird"))
    losses = {}

    def end(state):
        if state["neval"] > 1:
            losses[state["neval"] - 1] = state["loss"]
        return state["neval"] > 5
    opt.set_end_when(Trigger(end, "record")).optimize()
    pickle.dump(losses, open(out + "." + str(Engine.rank()), "wb"))
    Engine.reset()
''')


def _two_ranks(tmp_path, name, mode):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = {**os.environ, "PYTHONPATH": _REPO,
           "BIGDL_TORCH_COORDINATOR": f"file://{tmp_path / (name + '.store')}",
           "BIGDL_TORCH_NUM_PROCESSES": "2"}
    out = str(tmp_path / name)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(tmp_path / "ckpt"), out, mode],
        env={**env, "BIGDL_TORCH_PROCESS_ID": str(i)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    try:
        errs = [p.communicate(timeout=240)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
    return [pickle.load(open(f"{out}.{r}", "rb")) for r in range(2)]


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """(dir, each rank's losses) of the uninterrupted two-rank run, whose
    snapshot after iteration 3 is ``dir/ckpt/*.3``."""
    root = tmp_path_factory.mktemp("dropout_dp")
    return root, _two_ranks(root, "full", "full")


def test_resumed_two_rank_dropout_run_is_bit_equal(uninterrupted):
    root, full = uninterrupted
    assert sorted(full[0]) == [1, 2, 3, 4, 5]
    oblob = file_io.load(str(root / "ckpt" / "optimMethod.3"))
    states = oblob["torch_rng_states"]
    assert sorted(states) == [0, 1]
    assert oblob["torch_rng_state"] is None    # the one-rank key
    assert not np.array_equal(states[0]["state"], states[1]["state"])
    resumed = _two_ranks(root, "resumed", "resume")
    for r in range(2):
        assert [resumed[r][k] for k in (4, 5)] == \
            [full[r][k] for k in (4, 5)], (r, resumed[r], full[r])
    assert full[0][4] == full[1][4]      # the global batch's loss


def test_resume_at_another_world_reseeds_and_warns(uninterrupted, caplog):
    root, _ = uninterrupted
    toks = np.random.RandomState(0).randint(0, 97, (24, 17)).astype(
        np.int32)
    model = tlm.TransformerLM(97, max_len=16, d_model=32, num_heads=4,
                              num_layers=2, dropout=0.1).build(
        "cpu", torch.Generator().manual_seed(1))
    opt = Optimizer(model, DataSet.array(
        [Sample(toks[i, :-1], toks[i, 1:]) for i in range(24)]),
        tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion(),
                                     size_average=True),
        batch_size=8, device="cpu")
    opt.set_optim_method(SGD(0.1, momentum=0.9))
    opt.resume_from(str(root / "ckpt" / "model.3"),
                    str(root / "ckpt" / "optimMethod.3"))
    with caplog.at_level(logging.WARNING, logger="bigdl_torch"):
        opt.set_end_when(Trigger.max_iteration(4)).optimize()
    assert any("seeded as at a start" in r.getMessage()
               for r in caplog.records)
    assert np.isfinite(opt.optim_method.hyper["loss"])
