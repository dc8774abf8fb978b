"""Per-module profiling and traced steps.

Counterpart of ``bigdl_tpu/utils/profiling.py`` (reference
``nn/abstractnn/AbstractModule.scala:193-217``: every module accumulates
its forward and backward time, and ``getTimes()`` returns (module,
forward time, backward time) triples).

- :class:`ModuleProfiler` times each module of a model while the block
  runs: forward pre- and post-hooks on every module (a container's time
  includes its children's, as the reference's wrapper time does) and
  full-backward pre- and post-hooks on every leaf, so a backward run inside
  the block times each leaf's share; a container's backward time is the
  sum of its leaves'.  On the card the hooks record CUDA events on the
  current stream and the times are read once, at the block's end, after
  a synchronize; on the CPU they read ``perf_counter``.  The hooks add a
  Python call per module and call, so a profiled step runs slower than an
  unprofiled one.
- :func:`trace_steps` runs a step ``n`` times under ``torch.profiler``
  (CPU and CUDA activities) and writes a Chrome trace, the per-kernel
  device times the reference reads from its XLA trace.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Tuple

import torch

__all__ = ["ModuleProfiler", "trace_steps", "TRACE_FILE"]

#: the Chrome trace :func:`trace_steps` writes into its ``logdir``
TRACE_FILE = "trace_steps.json"


class _Times:
    """Start and stop marks of one module's calls: CUDA events on the
    card, ``perf_counter`` seconds on the CPU."""

    def __init__(self):
        self.open: List[Any] = []
        self.spans: List[Tuple[Any, Any]] = []

    def start(self, cuda: bool):
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.open.append(ev)
        else:
            self.open.append(time.perf_counter())

    def stop(self, cuda: bool):
        if not self.open:
            return
        begin = self.open.pop()
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.spans.append((begin, ev))
        else:
            self.spans.append((begin, time.perf_counter()))

    def seconds(self) -> float:
        total = 0.0
        for a, b in self.spans:
            total += (a.elapsed_time(b) / 1e3
                      if isinstance(a, torch.cuda.Event) else b - a)
        return total


def _is_cuda(x) -> bool:
    while isinstance(x, (list, tuple)) and x:
        x = x[0]
    return isinstance(x, torch.Tensor) and x.device.type == "cuda"


def _leaf(m) -> bool:
    return not len(getattr(m, "layers", ()))


class ModuleProfiler:
    """Per-module wall times (the reference's ``getTimes`` role).

    Usage::

        with ModuleProfiler(model) as prof:
            loss = criterion(model(x), y)
            loss.backward()
        for mod, fwd_s, bwd_s in prof.get_times():
            ...

    On exit every module keeps ``_profile_times`` = (forward s, backward
    s), which ``Module.get_times()`` reads.  With ``measure_backward=False``
    no backward hook is set and every backward time is 0."""

    def __init__(self, model, measure_backward: bool = True):
        self.model = model
        self.measure_backward = measure_backward
        self.fwd: Dict[int, float] = {}
        self.bwd: Dict[int, float] = {}
        self._mods: List = []
        self._handles: List = []
        self._fwd_marks: Dict[int, _Times] = {}
        self._bwd_marks: Dict[int, _Times] = {}
        self._cuda = False

    def _hooks(self, m):
        key = id(m)
        fm = self._fwd_marks[key] = _Times()

        def pre(mod, args):
            self._cuda = self._cuda or _is_cuda(args)
            fm.start(self._cuda)

        def post(mod, args, out):
            fm.stop(self._cuda)

        self._handles += [m.register_forward_pre_hook(pre),
                          m.register_forward_hook(post)]
        if not (self.measure_backward and _leaf(m)):
            return
        bm = self._bwd_marks[key] = _Times()

        def bwd_pre(mod, grad_output):
            bm.start(self._cuda)

        def bwd_post(mod, grad_input, grad_output):
            bm.stop(self._cuda)

        self._handles += [m.register_full_backward_pre_hook(bwd_pre),
                          m.register_full_backward_hook(bwd_post)]

    def __enter__(self):
        self._mods = list(self.model.unique_modules())
        for m in self._mods:
            self._hooks(m)
        return self

    def __exit__(self, *exc):
        for h in reversed(self._handles):
            h.remove()
        self._handles = []
        if self._cuda:
            torch.cuda.synchronize()
        for m in self._mods:
            self.fwd[id(m)] = self._fwd_marks[id(m)].seconds()
            marks = self._bwd_marks.get(id(m))
            self.bwd[id(m)] = marks.seconds() if marks else 0.0
        for m in self._mods:
            if not _leaf(m):
                self.bwd[id(m)] = sum(
                    self.bwd.get(id(c), 0.0) for c in m.unique_modules()
                    if c is not m and _leaf(c))
        for m in self._mods:
            m._profile_times = (self.fwd.get(id(m), 0.0),
                                self.bwd.get(id(m), 0.0))
        return False

    def get_times(self) -> List[Tuple[Any, float, float]]:
        """(module, forward seconds, backward seconds) for each module of
        ``unique_modules()``, in its pre-order."""
        return [(m, self.fwd.get(id(m), 0.0), self.bwd.get(id(m), 0.0))
                for m in self._mods]

    def summary(self, top: int = 20) -> str:
        rows = sorted(self.get_times(), key=lambda r: -(r[1] + r[2]))[:top]
        lines = [f"{'module':40s} {'fwd_ms':>9s} {'bwd_ms':>9s}"]
        for m, f, b in rows:
            lines.append(f"{m.name[:40]:40s} {f*1e3:9.3f} {b*1e3:9.3f}")
        return "\n".join(lines)


def trace_steps(run, n: int, logdir: str):
    """Run ``run()`` ``n`` times under ``torch.profiler`` (CPU and, where
    there is one, CUDA activity), the device synchronized at the end, and
    write the Chrome trace to ``logdir``/:data:`TRACE_FILE` (Perfetto or
    ``chrome://tracing`` load it).  Returns ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    with profile(activities=acts) as prof:
        for _ in range(n):
            run()
        if cuda:
            torch.cuda.synchronize()
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
    return logdir
