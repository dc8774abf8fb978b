"""Elastic host-loss drills with real processes: shrink, and shrink then
grow.

Counterpart of the repository's ``tools/elastic_smoke.py``, on the port.
The ranks are separate processes that share only the checkpoint store
(the logical topology of ``BIGDL_TORCH_ELASTIC_WORLD`` / ``_RANK``), each
training a one-layer model on its own shard of 128 samples with
``Adam(1e-2)``, a snapshot every iteration, the data order pinned and
``BIGDL_TORCH_PREFETCH_DEPTH=0``, so that a drilled run and a clean one
see the same batches.

Shrink (default):

1. Two ranks start; rank 1 carries chaos ``host.lost@1=exit@1:<iter>`` and
   exits 117 at epoch 1, iteration ``--lost-iter``.
2. Rank 0 must detect the silence (``PeerLostError``), negotiate the newest
   common lineage entry, shrink to world 1 with its batch rescaled 16 ->
   32, resume and finish, with the ``elastic.*`` events in its trace.
3. A clean world-1 process resumes from the same entry at batch 32; its
   final loss must equal rank 0's bit for bit.

``--grow``: the same loss, rank 0 publishing a release per snapshot; then
rank 1 comes back as a joiner (``BIGDL_TORCH_ELASTIC_JOIN=1``, chaos
``host.return@1=join@<--return-at>``), waits for its death certificate,
announces itself and is admitted at rank 0's next checkpoint boundary.
Asserted: world 2 -> 1 -> 2 and batch 16 -> 32 -> 16 in rank 0's history,
one ``join`` in the joiner's, the grow events in both traces, release ids
gap-free across both resizes, a stub-served ``DeployController``
promoting a release published after the grow, and clean world-2 ranks
resumed from the join snapshot ending on both ranks' final losses.

Prints one JSON line (the reference's fields); exit 0 when the drill
closed::

    python -m bigdl_torch.tools.elastic_smoke --device cpu [--grow]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

#: the exit code of chaos ``ExitAt`` (``utils/chaos.py``)
LOST_EXIT = 117

_PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _worker(args) -> int:
    """One logical rank, or a clean comparison run."""
    import numpy as np
    import torch

    from .. import nn
    from ..dataset import DataSet, Sample, SampleToMiniBatch
    from ..dataset.transformer import Transformer
    from ..optim import Adam, Optimizer, Trigger
    from ..optim.optimizer import _find_batchers
    from ..utils.engine import Engine

    rng = np.random.default_rng(0)
    samples = [Sample(rng.standard_normal(6).astype(np.float32),
                      np.float32(i % 2)) for i in range(128)]

    class Pace(Transformer):
        """A sleep per minibatch, so that the run outlives the detection
        window (the drill's clock is the loss threshold)."""

        def __init__(self, seconds):
            self.seconds = seconds

        def __call__(self, it):
            for x in it:
                if self.seconds:
                    time.sleep(self.seconds)
                yield x

    ds = (DataSet.rdd(samples)
          .transform(SampleToMiniBatch(args.batch, drop_last=True))
          .transform(Pace(args.pace)))
    # the same order for the drilled and the clean runs: the shuffle's
    # generator is not in the snapshot
    ds.shuffle = lambda: None
    opt = (Optimizer(nn.Sequential().add(nn.Linear(6, 2)), ds,
                     nn.CrossEntropyCriterion(), device=args.device)
           .set_optim_method(Adam(1e-2))
           .set_end_when(Trigger.max_epoch(args.epochs)))
    out = {"rank": args.rank, "recovered": False}
    if args.resume_neval:
        # a clean run from the negotiated entry writes no snapshot: the
        # lineage under test stays as it is
        opt.resume_from(os.path.join(args.ckpt_dir,
                                     f"model.{args.resume_neval}"),
                        os.path.join(args.ckpt_dir,
                                     f"optimMethod.{args.resume_neval}"))
    else:
        opt.set_checkpoint(args.ckpt_dir, Trigger.several_iteration(1),
                           publish=True if args.publish else None)
    trained = opt.optimize()
    plan = opt._elastic_plan
    if plan is not None:
        out.update(recovered=True, neval_resumed=plan.neval,
                   world_after=Engine.world(),
                   batch_after=_find_batchers(opt.dataset)[0].batch_size)
    out["history"] = opt._elastic_history
    out["loss"] = float(opt.optim_method.hyper["loss"])
    out["finite"] = bool(all(torch.isfinite(p).all()
                             for p in trained.parameters()))
    print(json.dumps(out), flush=True)
    return 0


def _spawn(args, rank: int, extra_env: dict, worker_args: list):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BIGDL_TORCH_ELASTIC", "BIGDL_TORCH_CHAOS",
                                "BIGDL_TORCH_TRACE",
                                "BIGDL_TORCH_SUPERVISE"))}
    env.update({"PYTHONPATH": _PACKAGE_PARENT,
                # the synchronous data path: drilled and clean runs must
                # compare bit for bit
                "BIGDL_TORCH_PREFETCH_DEPTH": "0", **extra_env})
    return subprocess.Popen(
        [sys.executable, "-m", "bigdl_torch.tools.elastic_smoke",
         "--worker", "--rank", str(rank), *worker_args],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _last_json(out: str):
    lines = [line for line in out.splitlines() if line.startswith("{")]
    return json.loads(lines[-1]) if lines else None


def _trace_events(trace_dir: str) -> dict:
    """Per trace file, the sorted ``elastic.*`` event names."""
    by_file = {}
    for tf in glob.glob(os.path.join(trace_dir, "trace.*.json")):
        names = set()
        try:
            with open(tf) as f:
                events = json.load(f).get("traceEvents", [])
        except ValueError:
            events = []
        for ev in events:
            if str(ev.get("name", "")).startswith("elastic."):
                names.add(ev["name"])
        by_file[os.path.basename(tf)] = sorted(names)
    return by_file


def _worker_args(args, pace=None, batch=None, resume=0, publish=False):
    out = ["--ckpt-dir", args.ckpt, "--epochs", str(args.epochs),
           "--batch", str(args.batch if batch is None else batch),
           "--pace", str(args.pace if pace is None else pace)]
    if args.device:
        out += ["--device", args.device]
    if resume:
        out += ["--resume-neval", str(resume)]
    if publish:
        out.append("--publish")
    return out


def _common_env(args) -> dict:
    return {"BIGDL_TORCH_ELASTIC_WORLD": "2",
            "BIGDL_TORCH_ELASTIC_PEER_LOST": str(args.peer_lost),
            "BIGDL_TORCH_SUPERVISE_PEER_STALE": str(args.peer_lost / 2),
            # a live phase deadline beside elasticity: the recovery runs
            # under the checkpoint phase and must not trip it
            "BIGDL_TORCH_SUPERVISE_STEP": "20"}


def _keep(ckpt, tag, stdout, stderr):
    """A worker's output beside the lineage, for the post-mortem."""
    try:
        with open(os.path.join(ckpt, f"{tag}.log"), "w") as f:
            f.write(stdout + "\n--- stderr ---\n" + stderr)
    except OSError:
        pass


def _shrink_drill(args, out) -> int:
    wargs = _worker_args(args)
    common = _common_env(args)
    p0 = _spawn(args, 0, {**common, "BIGDL_TORCH_ELASTIC_RANK": "0",
                          "BIGDL_TORCH_TRACE": args.trace}, wargs)
    p1 = _spawn(args, 1, {**common, "BIGDL_TORCH_ELASTIC_RANK": "1",
                          "BIGDL_TORCH_CHAOS":
                              f"host.lost@1=exit@1:{args.lost_iter}"},
                wargs)
    args.procs += [p0, p1]
    out1, err1 = p1.communicate(timeout=args.timeout)
    out0, err0 = p0.communicate(timeout=args.timeout)
    _keep(args.ckpt, "rank1", out1, err1)
    _keep(args.ckpt, "rank0", out0, err0)
    out["rank1_rc"], out["rank0_rc"] = p1.returncode, p0.returncode
    if p1.returncode != LOST_EXIT:
        out["error"] = (f"rank 1 exited {p1.returncode}, expected the "
                        f"host-lost drill's {LOST_EXIT}: {err1[-1500:]}")
        return 1
    if p0.returncode != 0:
        out["error"] = f"rank 0 failed: {err0[-2000:]}"
        return 1
    r0 = _last_json(out0)
    if not r0 or not r0.get("recovered") or not r0.get("finite"):
        out["error"] = f"rank 0 never ran elastic recovery: {r0}"
        return 1
    out.update(recovered=True, neval_resumed=r0["neval_resumed"],
               world_after=r0["world_after"], batch_after=r0["batch_after"],
               loss=r0["loss"])
    if r0["world_after"] != 1 or r0["batch_after"] != 2 * args.batch:
        out["error"] = f"the shrink did not keep the global batch: {r0}"
        return 1
    events = set()
    for names in _trace_events(args.trace).values():
        events.update(names)
    out["elastic_events"] = sorted(events)
    need = {"elastic.detect", "elastic.negotiate", "elastic.reform",
            "elastic.resume"}
    if not need <= events:
        out["error"] = f"missing elastic trace events: {need - events}"
        return 1
    pc = _spawn(args, 0, {}, _worker_args(args, pace=0,
                                          batch=2 * args.batch,
                                          resume=r0["neval_resumed"]))
    args.procs.append(pc)
    outc, errc = pc.communicate(timeout=args.timeout)
    if pc.returncode != 0:
        out["error"] = f"clean run failed: {errc[-2000:]}"
        return 1
    out["clean_loss"] = _last_json(outc)["loss"]
    out["loss_match"] = out["clean_loss"] == r0["loss"]
    if not out["loss_match"]:
        out["error"] = (f"recovered loss {r0['loss']!r} != clean world-1 "
                        f"loss {out['clean_loss']!r}")
        return 1
    return 0


class _StubServer:
    """Serves a DeployController by counting swaps."""

    def __init__(self):
        self.versions = 0

    def swap(self, source, canary_fraction=None):
        self.versions += 1
        return self.versions

    def stats(self):
        return {}


def _grow_drill(args, out) -> int:
    wargs = _worker_args(args)
    common = _common_env(args)
    # rank 0, the survivor, traces and publishes the release feed whose
    # continuity across both resizes is under test
    p0 = _spawn(args, 0, {**common, "BIGDL_TORCH_ELASTIC_RANK": "0",
                          "BIGDL_TORCH_TRACE": args.trace},
                _worker_args(args, publish=True))
    p1 = _spawn(args, 1, {**common, "BIGDL_TORCH_ELASTIC_RANK": "1",
                          "BIGDL_TORCH_CHAOS":
                              f"host.lost@1=exit@1:{args.lost_iter}"},
                wargs)
    args.procs += [p0, p1]
    out1, err1 = p1.communicate(timeout=args.timeout)
    _keep(args.ckpt, "rank1", out1, err1)
    out["rank1_rc"] = p1.returncode
    if p1.returncode != LOST_EXIT:
        out["error"] = (f"rank 1 exited {p1.returncode}, expected the "
                        f"host-lost drill's {LOST_EXIT}: {err1[-1500:]}")
        return 1
    # rank 1 comes back: the same logical rank, a joiner, gated on the
    # survivor's checkpoint stream reaching --return-at
    pj = _spawn(args, 1, {**common, "BIGDL_TORCH_ELASTIC_RANK": "1",
                          "BIGDL_TORCH_ELASTIC_JOIN": "1",
                          "BIGDL_TORCH_ELASTIC_JOIN_POLL": "0.05",
                          "BIGDL_TORCH_ELASTIC_JOIN_TIMEOUT": "60",
                          "BIGDL_TORCH_TRACE": args.trace,
                          "BIGDL_TORCH_CHAOS":
                              f"host.return@1=join@{args.return_at}"},
                wargs)
    args.procs.append(pj)
    outj, errj = pj.communicate(timeout=args.timeout)
    _keep(args.ckpt, "joiner", outj, errj)
    out0, err0 = p0.communicate(timeout=args.timeout)
    _keep(args.ckpt, "rank0", out0, err0)
    out["rank0_rc"], out["joiner_rc"] = p0.returncode, pj.returncode
    if pj.returncode != 0:
        out["error"] = f"joiner failed: {errj[-2000:]}"
        return 1
    if p0.returncode != 0:
        out["error"] = f"rank 0 failed: {err0[-2000:]}"
        return 1
    r0, rj = _last_json(out0), _last_json(outj)
    if not r0 or not r0.get("recovered") or not r0.get("finite"):
        out["error"] = f"rank 0 never ran elastic recovery: {r0}"
        return 1
    if not rj or not rj.get("recovered") or not rj.get("finite"):
        out["error"] = f"the joiner never joined: {rj}"
        return 1
    out["recovered"] = True
    out["history_rank0"], out["history_joiner"] = r0["history"], \
        rj["history"]
    kinds = [h["kind"] for h in r0["history"]]
    if kinds != ["shrink", "grow"]:
        out["error"] = f"rank 0 episodes {kinds} != ['shrink', 'grow']"
        return 1
    shrink, grow = r0["history"]
    if [shrink["world"], grow["world"]] != [1, 2] or \
            [shrink["batch"], grow["batch"]] != [2 * args.batch, args.batch]:
        out["error"] = ("resize trajectory wrong (want world 2->1->2, "
                        f"batch {args.batch}->{2 * args.batch}->"
                        f"{args.batch}): {r0['history']}")
        return 1
    if [h["kind"] for h in rj["history"]] != ["join"] or \
            rj["history"][0]["world"] != 2 or \
            rj["history"][0]["batch"] != args.batch:
        out["error"] = f"joiner episode wrong: {rj['history']}"
        return 1
    out["joined"] = True
    grow_neval = int(grow["neval"])
    out["grow_neval"] = grow_neval
    if int(rj["history"][0]["neval"]) != grow_neval:
        out["error"] = ("survivor and joiner adopted different snapshots: "
                        f"{grow_neval} != {rj['history'][0]['neval']}")
        return 1
    out["elastic_events"] = _trace_events(args.trace)
    need = {"elastic.join", "elastic.agree", "elastic.reform",
            "elastic.resume"}
    for rk in (0, 1):
        have = set(out["elastic_events"].get(f"trace.{rk}.json", []))
        if not need <= have:
            out["error"] = (f"rank {rk} trace misses the grow events "
                            f"{sorted(need - have)}")
            return 1
    from ..serve.continuous import DeployController, RELEASE_PATTERN
    ids = sorted(int(m.group(1)) for n in os.listdir(args.ckpt)
                 for m in [re.fullmatch(RELEASE_PATTERN, n)] if m)
    out["releases"] = len(ids)
    out["release_gap_free"] = bool(
        ids and ids == list(range(ids[0], ids[0] + len(ids))))
    if not out["release_gap_free"]:
        out["error"] = f"the release feed has gaps: {ids}"
        return 1
    # canary_fraction=0: full swaps, each release promoted at once
    ctrl = DeployController(_StubServer(), args.ckpt, canary_fraction=0.0,
                            since=0)
    for rid in ids:
        ctrl._handle(rid, os.path.join(args.ckpt, f"release.{rid}"))
    out["promoted"] = ctrl.counts["promoted"]
    out["rejected"] = ctrl.counts["rejected"]
    after = [t for t in ctrl.timeline if t.get("action") == "promoted"
             and (t.get("neval") or -1) > grow_neval]
    out["promoted_after_grow"] = len(after)
    if ctrl.counts["rejected"] or not after:
        out["error"] = ("the deployment did not survive the resizes: "
                        f"rejected={ctrl.counts['rejected']} "
                        f"promoted_after_grow={len(after)}")
        return 1
    cleans = [_spawn(args, rk, {"BIGDL_TORCH_ELASTIC_WORLD": "2",
                                "BIGDL_TORCH_ELASTIC_RANK": str(rk)},
                     _worker_args(args, pace=0, resume=grow_neval))
              for rk in (0, 1)]
    args.procs += cleans
    losses = {0: r0["loss"], 1: rj["loss"]}
    for rk, pc in zip((0, 1), cleans):
        outc, errc = pc.communicate(timeout=args.timeout)
        if pc.returncode != 0:
            out["error"] = f"clean rank {rk} failed: {errc[-2000:]}"
            return 1
        loss = _last_json(outc)["loss"]
        out[f"clean_loss_rank{rk}"] = loss
        if loss != losses[rk]:
            out["error"] = (f"rank {rk}: drilled loss {losses[rk]!r} != "
                            f"clean world-2 loss {loss!r}")
            return 1
    out["loss"], out["join_loss"] = r0["loss"], rj["loss"]
    out["loss_match"] = True
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m bigdl_torch.tools."
                                      "elastic_smoke")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--pace", type=float, default=None)
    ap.add_argument("--resume-neval", type=int, default=0)
    ap.add_argument("--lost-iter", type=int, default=3,
                    help="the epoch-1 iteration at which rank 1 dies")
    ap.add_argument("--grow", action="store_true",
                    help="the kill-then-return drill")
    ap.add_argument("--return-at", default="2:2",
                    help="epoch:iteration of the joiner's announcement gate")
    ap.add_argument("--publish", action="store_true",
                    help="worker: publish a release per snapshot")
    ap.add_argument("--peer-lost", type=float, default=0.8)
    ap.add_argument("--timeout", type=int, default=240)
    args = ap.parse_args(argv)
    if args.pace is None:
        # the grow drill paces slower: the survivor must still be training
        # when the joiner has started, gated and negotiated
        args.pace = 0.35 if args.grow else 0.05
    if args.epochs is None:
        args.epochs = 12 if args.grow else 10
    if args.worker:
        return _worker(args)

    base = args.ckpt_dir or tempfile.mkdtemp(prefix="elastic_smoke_")
    cleanup = args.ckpt_dir is None
    args.ckpt = os.path.join(base, "ckpt")
    args.trace = os.path.join(base, "trace")
    args.procs = []
    os.makedirs(args.ckpt, exist_ok=True)
    out = {"metric": "elastic_grow_smoke" if args.grow else "elastic_smoke",
           "recovered": False, "loss_match": False}
    if args.grow:
        out.update(joined=False, elastic_events={})
    else:
        out["elastic_events"] = []
    rc = 1
    try:
        rc = (_grow_drill if args.grow else _shrink_drill)(args, out)
    except subprocess.TimeoutExpired as e:
        out["error"] = f"drill timed out: {e}"
    except Exception as e:  # noqa: BLE001 - one JSON line, always
        out["error"] = f"{type(e).__name__}: {e}"
    finally:
        for p in args.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        print(json.dumps(out), flush=True)
        if cleanup:
            shutil.rmtree(base, ignore_errors=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
