"""Scaling evidence over gloo ranks: collectives by route and records/s.

Counterpart of ``bigdl_tpu/tools/scaling.py``, which compiles the train
step over an n-device virtual mesh and counts the XLA collectives in its
optimized HLO.  The port runs eagerly, one process a rank, and every
collective goes through ``Engine`` (``utils/engine.py``), which counts
it by operation and kind, so the counts here come from
``Engine.collectives()`` after one step of each route on n ranks:

1. **Collectives by route** (:func:`strategy_signatures`): one LeNet-5
   SGD step under ``DataParallel`` (the gradient all-reduce), under
   ``ShardedDataParallel`` (ZeRO: reduce-scatter and all-gather of the
   slices), under ``TensorParallel`` on a ``{"model": 2, "data": n/2}``
   mesh (the tp layers' output gathers and input-gradient all-reduces
   beside the batch axis's), and one ring and one Ulysses attention over a
   ``seq`` axis of the n ranks (the ring's hops, the all-to-alls).  Each
   route's counts are summed by operation under the reference's HLO
   names (``all-reduce``, ``all-gather``, ``reduce-scatter``,
   ``collective-permute``, ``all-to-all``); ``strategy_detail`` keeps the
   ``Engine``'s kinds.
2. **Per-rank records/s** (:func:`measure`): LeNet-5 SGD steps with the
   same per-rank batch on one rank and on n ranks (``DataParallel``).
   Ranks that share one host (or one card, over gloo) share its cores
   and memory, so the ratio is a lower bound on the efficiency of ranks
   that each own a device.

Usage (ranks are child processes of this one, on the CUDA device unless
``--device cpu``; ranks that share a card run gloo)::

    python -m bigdl_torch.tools.scaling [--devices 4] \\
        [--batch-per-device 64] [--no-strategies] [--device cpu]

Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

#: the Engine's operations under the reference's HLO names
HLO_NAMES = {"all_reduce": "all-reduce", "all_gather": "all-gather",
             "reduce_scatter": "reduce-scatter",
             "permute": "collective-permute", "all_to_all": "all-to-all"}

_CHILD_TIMEOUT = 600


def route_counts(collectives: dict) -> dict:
    """``Engine.collectives()`` summed by operation, under the reference's
    HLO names; operations with no call left out."""
    out = {}
    for op, kinds in collectives.items():
        n = sum(kinds.values())
        if n:
            out[HLO_NAMES[op]] = n
    return out


def _spawn(task: str, world: int, device: str, extra: dict) -> list:
    """``world`` ranks of this module running ``task``; their results in
    rank order.  Every child is killed and reaped before it returns."""
    with tempfile.TemporaryDirectory() as tmp:
        job = os.path.join(tmp, "job.json")
        with open(job, "w") as f:
            json.dump({"task": task, "device": device, "dir": tmp, **extra},
                      f)
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = {**os.environ,
               "PYTHONPATH": repo + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""),
               "BIGDL_TORCH_NUM_PROCESSES": str(world)}
        procs = [subprocess.Popen(
            [sys.executable, "-m", "bigdl_torch.tools.scaling", "--child",
             job], env={**env, "BIGDL_TORCH_PROCESS_ID": str(r)},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]
        try:
            outs = [p.communicate(timeout=_CHILD_TIMEOUT) for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        for p, (_, err) in zip(procs, outs):
            if p.returncode != 0:
                raise RuntimeError(f"scaling: a {task} rank failed "
                                   f"({p.returncode}):\n{err[-4000:]}")
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                results.append(json.load(f))
        return results


def measure(n_devices: int, batch_per_device: int = 64, device=None,
            steps: int = 8) -> dict:
    """Per-rank records/s of LeNet-5 SGD steps at the same per-rank batch
    on one rank and on ``n_devices`` ranks (``DataParallel``), and the
    collectives of one step on n ranks."""
    device = _device_name(device)
    one = _spawn("measure", 1, device, {"batch": batch_per_device,
                                        "steps": steps})[0]
    many = _spawn("measure", n_devices, device, {"batch": batch_per_device,
                                                 "steps": steps})
    thr1 = batch_per_device / one["step_s"]
    # the slowest rank sets the step
    dtn = max(r["step_s"] for r in many)
    thrn = n_devices * batch_per_device / dtn
    return {
        "n_devices": n_devices,
        "batch_per_device": batch_per_device,
        "device": device,
        "throughput_1dev_records_s": round(thr1, 1),
        "throughput_ndev_records_s": round(thrn, 1),
        "per_device_efficiency": round(thrn / n_devices / thr1, 3),
        "note": ("ranks of one host (or one card over gloo) share its cores "
                 "and memory: the efficiency here is a lower bound"),
        "collectives_ndev_step": route_counts(many[0]["collectives"])}


def strategy_signatures(n_devices: int, device=None) -> dict:
    """The collectives of one step of every route on ``n_devices`` ranks
    (module docstring), by the reference's HLO names; the Engine's kinds
    under ``"detail"``."""
    out = _spawn("signatures", n_devices, _device_name(device), {})[0]
    sig = {k: route_counts(v) for k, v in out["routes"].items()}
    sig["detail"] = out["routes"]
    return sig


def _device_name(device) -> str:
    from ..common import resolve_device
    return str(resolve_device(device))


# -- the ranks ---------------------------------------------------------------

def _init(job: dict, name: str, mesh_shape=None):
    from ..utils.engine import Engine
    os.environ["BIGDL_TORCH_COORDINATOR"] = \
        f"file://{job['dir']}/store_{name}"
    Engine.init(device=job["device"], backend="gloo", mesh_shape=mesh_shape)


def _reset():
    import torch.distributed as dist

    from ..utils.engine import Engine
    dist.barrier()
    Engine.reset()


def _lenet_step(job: dict, strategy, batch: int):
    """(one SGD step of LeNet-5 under ``strategy`` on this rank's
    ``batch`` rows, as a callable; the device)."""
    import numpy as np
    import torch

    from ..dataset import Sample
    from ..models.lenet import LeNet5
    from ..nn import ClassNLLCriterion
    from ..optim import SGD, Optimizer
    from ..utils.engine import Engine

    device = Engine.device()
    model = LeNet5(10).build(device, torch.Generator().manual_seed(0))
    r = np.random.default_rng(1 + Engine.group_rank())
    x = r.standard_normal((batch, 28, 28, 1)).astype(np.float32)
    y = r.integers(0, 10, batch).astype(np.float32)
    opt = Optimizer(model, [Sample(x[0], y[0])], ClassNLLCriterion(),
                    strategy=strategy, device=device)
    opt.set_optim_method(SGD(learning_rate=0.05, momentum=0.9))
    params = opt._params()
    strategy.setup(model, opt.optim_method, 0.0)
    state = [opt.optim_method.init_state(strategy.own(params))]
    rng = opt._dropout_generator()
    xd, yd = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)
    model.train()

    def step():
        loss, state[0] = opt._step(params, state[0], xd, yd, 0.05, rng)
        return loss
    return step, device


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _task_measure(job: dict) -> dict:
    from ..parallel import DataParallel
    from ..utils.engine import Engine
    _init(job, "measure")
    step, device = _lenet_step(job, DataParallel(), job["batch"])
    step()    # the first step builds what it needs
    Engine.clear_counts()
    step()
    coll = Engine.collectives()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(job["steps"]):
        float(step())
    _sync(device)
    out = {"step_s": (time.perf_counter() - t0) / job["steps"],
           "collectives": coll}
    _reset()
    return out


def _task_signatures(job: dict) -> dict:
    import numpy as np
    import torch

    from ..parallel import (DataParallel, ShardedDataParallel,
                            TensorParallel, ring_attention,
                            ulysses_attention)
    from ..utils.engine import Engine
    n = int(os.environ["BIGDL_TORCH_NUM_PROCESSES"])
    routes = {}

    def one_step(name, strategy, batch=8):
        step, _ = _lenet_step(job, strategy, batch)
        Engine.clear_counts()
        float(step())
        routes[name] = Engine.collectives()

    _init(job, "data")
    one_step(f"dp{n}", DataParallel())
    one_step(f"zero{n}", ShardedDataParallel(min_size=1))
    _reset()
    if n % 2 == 0:
        _init(job, "tp", {"model": 2, "data": n // 2})

        def tp_rule(path, leaf):
            # every even last axis, as the reference's: TensorParallel's
            # default floor of 2^16 elements leaves LeNet-5 replicated
            if leaf.ndim >= 2 and leaf.shape[-1] % 2 == 0:
                return (None,) * (leaf.ndim - 1) + ("model",)
            return ()
        one_step(f"dp{n // 2}xtp2", TensorParallel(rule=tp_rule))
        _reset()
    _init(job, "seq", {"seq": n})
    B, H, T, D = 2, n, 4 * n, 8
    r = np.random.default_rng(2)
    rank, t = Engine.process_rank(), 4
    q, k, v = (torch.from_numpy(r.standard_normal((B, H, T, D)).astype(
        np.float32)[:, :, rank * t:(rank + 1) * t].copy()).to(
        Engine.device()) for _ in range(3))
    for name, fn in ((f"ring_sp{n}", ring_attention),
                     (f"ulysses_sp{n}", ulysses_attention)):
        Engine.clear_counts()
        with torch.inference_mode():
            fn(q, k, v, causal=True)
        routes[name] = Engine.collectives()
    _reset()
    return {"routes": routes}


def _child(job_path: str) -> int:
    import torch
    with open(job_path) as f:
        job = json.load(f)
    torch.set_num_threads(1)   # the ranks share the host's cores
    out = {"measure": _task_measure,
           "signatures": _task_signatures}[job["task"]](job)
    rank = int(os.environ["BIGDL_TORCH_PROCESS_ID"])
    with open(os.path.join(job["dir"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m bigdl_torch.tools.scaling")
    ap.add_argument("--devices", type=int, default=4,
                    help="ranks of the n-rank runs")
    ap.add_argument("--batch-per-device", type=int, default=64)
    ap.add_argument("--no-strategies", action="store_true",
                    help="skip the collectives by route")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return _child(args.child)
    result = measure(args.devices, args.batch_per_device, args.device)
    if not args.no_strategies:
        result["strategy_collectives"] = strategy_signatures(
            args.devices, args.device)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
