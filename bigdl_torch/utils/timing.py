"""Device timing for benchmarks.

Counterpart of ``bigdl_tpu/utils/timing.py``, with the same functions and
return shapes.  The reference synchronizes by fetching a scalar of the
result, because its backend's ``block_until_ready`` returned early; here
a CUDA result is timed between ``torch.cuda.Event`` records and the
device is synchronized before the events are read, and a CPU result is
timed with ``time.perf_counter`` (a CPU op has finished when it returns).

- :func:`measure_chain`: the differenced time of chained runs,
  ``(T(n2) - T(n1)) / (n2 - n1)``, which cancels the fixed cost of the
  synchronization;
- :func:`measure_sync`: the median of single runs, each synchronized;
- :func:`measure_step_seconds`: the chained time, or the synchronized
  median where the two disagree;
- :func:`measure_roofline`: the bf16 matrix-product rate of the card, a
  chain of ``n = 8192`` ``torch.matmul`` products (a measurement of the
  card, not a kernel of the repo), or None where repeats disagree.

Every helper beats the caller's ``progress`` callback and the process's
supervisor (``utils/supervisor.py``) once a repeat, so a watchdog sees a
heartbeat while a long measurement runs.
"""

from __future__ import annotations

import time

import torch

__all__ = ["fetch_scalar", "measure_chain", "measure_sync",
           "measure_step_seconds", "measure_roofline"]


def _first_tensor(x):
    while isinstance(x, (list, tuple)):
        x = x[0]
    return x


def fetch_scalar(x) -> float:
    """The first element of ``x`` (a tensor, or the first tensor of a
    nested list or tuple) as a host float: a read that waits for
    everything ``x`` depends on."""
    x = _first_tensor(x)
    if isinstance(x, torch.Tensor):
        return float(x.detach().reshape(-1)[0].item()) if x.numel() else 0.0
    return float(x)


def _device_of(x):
    x = _first_tensor(x)
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


class _Clock:
    """Seconds between :meth:`start` and :meth:`stop` on the device of the
    first result: CUDA events (then a synchronize) on a card,
    ``perf_counter`` on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.device = device

    def start(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)
            self.ev = [torch.cuda.Event(enable_timing=True) for _ in (0, 1)]
            self.ev[0].record()
        self.t0 = time.perf_counter()

    def stop(self, out) -> float:
        if self.cuda:
            self.ev[1].record()
            torch.cuda.synchronize(self.device)
            return self.ev[0].elapsed_time(self.ev[1]) / 1e3
        fetch_scalar(out)
        return time.perf_counter() - self.t0


def _progress(progress) -> None:
    """One heartbeat: the caller's callback, if any, and the process's
    supervisor."""
    if progress:
        progress()
    from . import supervisor
    supervisor.notify()


def measure_chain(run, n1=4, n2=16, reps=3, progress=None):
    """Differenced chained timing of ``run()`` (whose result depends on
    every earlier call's, e.g. the loss of a step that updates the
    parameters): the best of ``reps`` chains of ``n1`` and of ``n2`` calls.
    Returns (seconds a run, details)."""
    out = run()
    fetch_scalar(out)
    clock = _Clock(_device_of(out))
    _progress(progress)
    times = {}
    for n in (n1, n2):
        best = float("inf")
        for _ in range(reps):
            clock.start()
            out = None
            for _ in range(n):
                out = run()
            best = min(best, clock.stop(out))
            _progress(progress)
        times[n] = best
    dt = (times[n2] - times[n1]) / (n2 - n1)
    overhead = max(times[n1] - n1 * dt, 0.0)
    return dt, {"n1": n1, "n2": n2, "t_n1": round(times[n1], 6),
                "t_n2": round(times[n2], 6),
                "fixed_overhead_seconds": round(overhead, 6)}


def measure_sync(run, iters=6, progress=None) -> float:
    """The median seconds of ``iters`` single calls of ``run()``, each
    timed to its synchronization."""
    out = run()
    fetch_scalar(out)
    clock = _Clock(_device_of(out))
    _progress(progress)
    ts = []
    for _ in range(iters):
        clock.start()
        ts.append(clock.stop(run()))
        _progress(progress)
    ts.sort()
    return ts[len(ts) // 2]


def measure_step_seconds(run, n1=4, n2=16, reps=3, log=None, progress=None):
    """The chained time of a step, or the synchronized median where the
    differencing is inconsistent (not positive, or over 1.5x the median).
    Returns (seconds a step, details)."""
    dt, detail = measure_chain(run, n1=n1, n2=n2, reps=reps,
                               progress=progress)
    dt_sync = measure_sync(run, progress=progress)
    detail["step_seconds_sync"] = round(dt_sync, 6)
    if dt <= 0 or dt > dt_sync * 1.5:
        if log:
            log(f"chained dt={dt:.6f}s inconsistent with sync="
                f"{dt_sync:.6f}s; using sync timing")
        detail["fallback"] = "sync"
        dt = dt_sync
    return dt, detail


def measure_roofline(n=8192, reps=2, tolerance=1.25, device=None):
    """The measured bf16 matrix-product rate, FLOP/s, of ``device``
    (default: the current CUDA device): chains of 2 and 8 products of
    n x n bf16 matrices differenced, ``reps`` times; None (inconclusive)
    unless every estimate is within ``tolerance``x of the others."""
    device = torch.device(device or "cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)
    a = torch.randn((n, n), generator=gen).to(device, torch.bfloat16)
    b = torch.randn((n, n), generator=gen).to(device, torch.bfloat16)
    scale = 1.0 / n ** 0.5

    def chain(length):
        c = a
        for _ in range(length):
            c = torch.matmul(c, b) * scale
        return c

    clock = _Clock(device)

    def timed(length):
        clock.start()
        return clock.stop(chain(length))

    timed(2)
    timed(8)
    estimates = []
    for _ in range(reps):
        t2 = min(timed(2) for _ in range(3))
        t8 = min(timed(8) for _ in range(3))
        per_mm = (t8 - t2) / 6.0
        if per_mm <= 0:
            return None
        estimates.append(2.0 * n ** 3 / per_mm)
    if max(estimates) > tolerance * min(estimates):
        return None
    return sum(estimates) / len(estimates)
