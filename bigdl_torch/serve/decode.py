"""Continuous-batching generative decode serving.

Counterpart of ``bigdl_tpu/serve/decode.py``:

- :class:`DecodeEngine` runs a persistent step loop, in a thread of its
  own, over a fixed number of KV-cache slots.  Every tick decodes all
  active slots at once, each at its own position (one [slots, 1, E]
  forward, B8 once per layer); a sequence that emits EOS or exhausts its
  budget leaves and frees its slot that same tick.
- Prefill admits one sequence into a free slot: the rows=1 step of
  ``cached_generate`` over each prompt position, on a [1, H, L, D] scratch
  cache, its token and position read from a device cursor that the step
  advances; then a commit writes the scratch into the slot (the
  reference's ``dynamic_slice``, ``fori_loop``, ``dynamic_update_slice``).
  Greedy tokens are those of ``cached_generate`` for the sequence alone.
- The cache length comes from a (slots, cache-page) ladder: power-of-2
  multiples of ``page`` up to ``max_len``.  The engine keeps one cache set
  (and one scratch) per rung it has used, for its lifetime.  A grow
  mid-flight copies rows [0, old) into the next rung and zeroes the rest
  (keys past a slot's position are never read); an idle engine re-pages
  to the rung the next admission needs and zeroes it.
- Executables per bucket, the counterpart of the reference's ``_step_exe``
  and ``_prefill_exe``: on CUDA each (kind, cache_len) bucket, kind
  ``tick`` (all slots), ``prefill`` (one position on the scratch) or
  ``commit``, is a CUDA graph.  The bucket's first call runs the real step
  eagerly on the engine's stream, then captures it (nothing runs during a
  capture); every later call replays the graph.  All graphs share one
  memory pool, and each graph's output is copied out before another
  replays.  A warm engine on a fixed ladder captures nothing new.  On the
  CPU the same step bodies run eagerly.  ``stats()["graphs"]`` counts
  captures and replays and names the buckets captured.
- Admission goes through a :class:`~bigdl_torch.serve.batcher.DecodeQueue`
  (bounded, per-sequence deadline = time to last token, priority
  eviction) and per-tenant :class:`~bigdl_torch.serve.control.TenantQuotas`.
- Tokens and positions reach the device once a tick as one int32
  [2, slots] tensor, copied from a pinned host buffer; the one host sync
  of a tick is the [slots, vocab] log-prob row sampling needs, brought
  back through a pinned buffer.

- Hooks, all on the host around the steps and never inside a captured
  graph: the ``serve.decode@<slot>`` fault point at each admission into a
  slot and at each tick of an active slot (a fault fails that sequence
  with :class:`SlotFault` and frees the slot; the others decode on); with
  a tracer active (``utils/telemetry``) each sequence's flow
  (``decode.admit``, one ``decode.tick`` a token, ``decode.fault``) and
  the ``serve.decode`` counter track a tick (tokens/s, slot fill, prefill
  and decode shares, cache bytes); with the metrics registry armed the
  ``bigdl_decode_ttlt_seconds`` histogram (time to last token).
- ``record_trace`` / ``stop_trace`` capture offered sequences with their
  generation settings (``serve/tracefile.py``).

Not ported: the persistent compile cache and its compile cards (the CUDA
graphs are the port's warm start).  ``mesh=`` raises
``NotImplementedError``: an engine on a layout needs one rank to lead the
others' admissions (queue A item 8); ``models/decode.py``
``cached_generate(mesh=)`` decodes a batch on one.

Knobs (``utils/config``; constructor arguments override):
``BIGDL_TORCH_DECODE_SLOTS`` (4), ``_PAGE`` (128), ``_MAX_LEN`` (0 = the
model's positional cap), ``_QUEUE_LIMIT`` (64), ``_DEADLINE_MS`` (0 =
none), ``_ADMISSION`` (``continuous``, or ``batch``: run to completion)
and ``_MIN_STEP_MS`` (0: a per-tick pacing floor).
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from ..common import get_policy, resolve_device
from ..models import decode as kv
from ..models.transformer_lm import PositionalEmbedding, sample_next
from ..ops.decode_attention import count_replay, counting_captures
from ..utils import chaos, config, metrics_export, telemetry
from .batcher import DecodeQueue, PendingRequest, ServeError
from .control import TenantQuotas

logger = logging.getLogger("bigdl_torch")

__all__ = ["DecodeEngine", "SlotFault", "page_ladder"]

_UNSET = object()


class SlotFault(ServeError):
    """A decode slot faulted mid-generation: its sequence fails typed, the
    slot frees the same tick, the other slots keep decoding."""


def page_ladder(page: int, max_len: int) -> tuple:
    """The cache-length ladder: power-of-2 multiples of ``page`` below
    ``max_len``, then ``max_len`` itself."""
    if page < 1:
        raise ValueError(f"page must be >= 1, got {page}")
    sizes = []
    c = int(page)
    while c < max_len:
        sizes.append(c)
        c *= 2
    sizes.append(int(max_len))
    return tuple(sizes)


class _Graph:
    """One captured bucket: the CUDA graph, its static output and the B8
    launches it recorded, by route (``count_replay`` counts them at every
    replay)."""

    __slots__ = ("graph", "out", "b8")

    def __init__(self, graph, out, b8):
        self.graph, self.out, self.b8 = graph, out, b8


class _Seq:
    """Host-side state of one in-flight sequence (one slot)."""

    __slots__ = ("req", "buf", "t0", "pos", "emitted", "max_tokens", "eos",
                 "temperature", "top_k", "generator")

    def __init__(self, req: PendingRequest, prompt: np.ndarray,
                 max_tokens: int, eos, temperature: float, top_k: int,
                 generator):
        self.req = req
        self.t0 = len(prompt)
        self.buf = np.zeros(self.t0 + max_tokens, np.int32)
        self.buf[: self.t0] = prompt
        self.pos = self.t0 - 1   # last position fed to the device
        self.emitted = 0
        self.max_tokens = max_tokens
        self.eos = eos
        self.temperature = temperature
        self.top_k = top_k
        self.generator = generator


class DecodeEngine:
    """Persistent continuous-batching decode loop (module docstring).

    Usage::

        engine = DecodeEngine(model).start()
        row = engine.generate(prompt, max_tokens=32)   # blocking
        h = engine.submit(prompt, 32, eos_token=2)     # async handle
        engine.stop()                                  # drain, then stop

    Also a context manager.  Runs on ``device`` (default: the CUDA device;
    raises without one); a built model must already live there.  On CUDA
    every step replays a CUDA graph once its bucket has been captured
    (module docstring).  The step methods run in the loop thread, inside
    ``_on_device()``; on an engine not started, in the caller's."""

    def __init__(self, model, *, slots: Optional[int] = None,
                 page: Optional[int] = None,
                 max_len: Optional[int] = None,
                 queue_limit: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 admission: Optional[str] = None,
                 eos_token: Optional[int] = None,
                 cache_dtype=None, mesh=None,
                 tenant_qps: Optional[float] = None,
                 tenant_burst: Optional[float] = None,
                 min_step_s: Optional[float] = None,
                 clock=None, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "DecodeEngine(mesh=...): serving the tp-sharded cache needs "
                "one rank to lead the others' admissions and ticks "
                "(ROADMAP.md queue A item 8: serving on a layout); "
                "cached_generate(mesh=) decodes a batch on a layout")
        self.device = resolve_device(device)
        if not model.built:
            model.build(self.device)
        p = next(model.parameters())
        if p.device != self.device:
            raise ValueError(f"the model lives on {p.device}, the engine "
                             f"runs on {self.device}: move it with "
                             f"model.to({str(self.device)!r})")
        self.model = model.eval()
        self.slots = int(slots if slots is not None
                         else config.get_int("DECODE_SLOTS", 4))
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {self.slots}")
        self.page = int(page if page is not None
                        else config.get_int("DECODE_PAGE", 128))
        model_cap = min((pe.max_len for pe in kv._modules_of_type(
            model, PositionalEmbedding)), default=0)
        cap = int(max_len if max_len is not None
                  else config.get_int("DECODE_MAX_LEN", 0)) or model_cap
        if model_cap and cap > model_cap:
            raise ValueError(f"max_len {cap} > model positional "
                             f"embedding max_len {model_cap}")
        if cap < 1:
            raise ValueError("DecodeEngine needs a positive max_len "
                             "(model has no PositionalEmbedding cap)")
        self.max_len = cap
        self.ladder = page_ladder(self.page, self.max_len)
        self.admission = str(admission if admission is not None else
                             config.get_str("DECODE_ADMISSION",
                                            "continuous"))
        if self.admission not in ("continuous", "batch"):
            raise ValueError(f"admission must be 'continuous' or "
                             f"'batch', got {self.admission!r}")
        self.default_deadline_ms = float(
            deadline_ms if deadline_ms is not None
            else config.get_float("DECODE_DEADLINE_MS", 0.0))
        self.min_step_s = float(
            min_step_s if min_step_s is not None
            else config.get_float("DECODE_MIN_STEP_MS", 0.0) / 1e3)
        self.eos_token = eos_token
        self.cache_dtype = cache_dtype or get_policy().compute_dtype
        self.clock = clock or time.monotonic
        self.queue = DecodeQueue(
            int(queue_limit if queue_limit is not None
                else config.get_int("DECODE_QUEUE_LIMIT", 64)),
            clock=self.clock)
        self.quotas = TenantQuotas(tenant_qps or 0.0, burst=tenant_burst,
                                   clock=self.clock)
        self._slots: List[Optional[_Seq]] = [None] * self.slots
        self._caches = None
        self._cache_len = 0
        self._rungs: dict = {}     # cache_len -> caches [slots, H, L, D]
        self._scratch: dict = {}   # cache_len -> caches [1, H, L, D]
        self._graphs: dict = {}    # (kind, cache_len) -> _Graph
        # the steps' static inputs: a tick's tokens and positions, a prompt
        # and the cursor into it, the slot a commit writes; each is filled
        # from a host mirror (pinned on CUDA) that is rewritten only after
        # the host has waited on a later copy of the engine's stream
        self._static = {
            "tp": torch.zeros((2, self.slots), dtype=torch.int32,
                              device=self.device),
            "prompt": torch.zeros((self.max_len,), dtype=torch.int32,
                                  device=self.device),
            "slot": torch.zeros((1,), dtype=torch.int64,
                                device=self.device)}
        self._cursor = torch.zeros((1,), dtype=torch.int32,
                                   device=self.device)
        on_cuda = self.device.type == "cuda"
        self._host_in = {n: torch.zeros(t.shape, dtype=t.dtype,
                                        pin_memory=on_cuda)
                         for n, t in self._static.items()}
        self._host_out: dict = {}  # (shape, dtype) -> pinned buffer
        if on_cuda:
            self._stream = torch.cuda.Stream(self.device)
            self._done = torch.cuda.Event()
            self._pool = torch.cuda.graph_pool_handle()
        self._recorder = None     # serve/tracefile.TraceRecorder
        self._thread: Optional[threading.Thread] = None
        # cumulative counters (stats(), the serve.decode track)
        self.prefill_steps = 0
        self.decode_steps = 0
        self.tokens_out = 0
        self.seqs_done = 0
        self.seqs_failed = 0
        self.cache_grows = 0
        self.graph_captures = 0
        self.graph_replays = 0
        self._busy_s = 0.0

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "DecodeEngine":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="bigdl-torch-decode-engine",
                daemon=True)
            self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Close admissions; ``drain=True`` finishes every queued and
        in-flight sequence first.  Whatever is still queued fails typed."""
        self.queue.close(drain=drain)
        t = self._thread
        if t is not None:
            t.join(timeout=120.0)
            self._thread = None
        self.queue.fail_pending()

    def __enter__(self) -> "DecodeEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=not any(exc))

    # -- admission ------------------------------------------------------

    def submit(self, prompt, max_tokens: int, *,
               deadline_ms: Optional[float] = None,
               tenant: Optional[str] = None, priority: int = 0,
               temperature: float = 0.0, top_k: int = 0,
               eos_token=_UNSET, seed: int = 0,
               request_id: Optional[str] = None) -> PendingRequest:
        """Enqueue one sequence; returns a handle whose ``result()`` is the
        full int32 token row (prompt + generated, ``cached_generate``'s
        contract, cut after EOS).  Typed rejections: ServeError (a bad
        request), QuotaExceeded, ServerOverloaded, ServerClosed;
        RequestTimeout resolves later if the time-to-last-token deadline
        passes in the queue.  Sampling (temperature > 0) draws from a CPU
        ``torch.Generator`` seeded with ``seed``.  ``request_id`` is an
        upstream flow id (``X-BigDL-Request-Id``)."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.shape[0] == 0:
            raise ServeError("decode: prompt must be a non-empty 1-D "
                             f"token row, got shape {prompt.shape}")
        max_tokens = int(max_tokens)
        if max_tokens < 1:
            raise ServeError(f"decode: max_tokens must be >= 1, got "
                             f"{max_tokens}")
        need = prompt.shape[0] + max_tokens
        if need > self.max_len:
            raise ServeError(
                f"decode: prompt ({prompt.shape[0]}) + max_tokens "
                f"({max_tokens}) exceeds max_len ({self.max_len})")
        self.quotas.admit(tenant)
        eos = self.eos_token if eos_token is _UNSET else eos_token
        dl_ms = self.default_deadline_ms \
            if deadline_ms is None else float(deadline_ms)
        deadline = self.clock() + dl_ms / 1e3 if dl_ms > 0 else None
        gen = {"max_tokens": max_tokens, "temperature": float(temperature),
               "top_k": int(top_k), "seed": int(seed)}
        if eos is not None:
            gen["eos_token"] = int(eos)
        if self._recorder is not None:
            self._recorder.note(prompt, tenant=tenant, priority=priority,
                                deadline_ms=dl_ms if dl_ms > 0 else None,
                                gen=gen)
        payload = dict(gen, prompt=prompt, eos=eos)
        return self.queue.submit(payload, deadline, tenant=tenant,
                                 priority=priority, request_id=request_id)

    def generate(self, prompt, max_tokens: int,
                 timeout: Optional[float] = 120.0, **kw) -> np.ndarray:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(prompt, max_tokens, **kw).result(timeout)

    # -- trace recording (the server's contract) ------------------------

    def record_trace(self, path: Optional[str] = None, *, limit=None):
        """Arm offered-sequence recording; returns the recorder (the same
        path again is a no-op)."""
        from .tracefile import TraceRecorder
        if self._recorder is not None and (path is None or
                                           self._recorder.path == path):
            return self._recorder
        self._recorder = TraceRecorder(clock=self.clock, limit=limit,
                                       path=path)
        return self._recorder

    def stop_trace(self, path: Optional[str] = None):
        """Disarm recording, writing the trace where a path is armed or
        given; returns the recorder."""
        rec, self._recorder = self._recorder, None
        if rec is not None and (path or rec.path):
            rec.save(path)
        return rec

    # -- (slots, cache-page) ladder -------------------------------------

    def _bucket_for(self, need: int) -> int:
        for c in self.ladder:
            if c >= need:
                return c
        return self.ladder[-1]

    def _rung(self, cache_len: int) -> list:
        """The caches of one rung, allocated (with the rung's scratch) at
        its first use and kept: graphs bind their addresses."""
        if cache_len not in self._rungs:
            self._rungs[cache_len] = kv.init_kv_cache(
                self.model, self.slots, cache_len, self.cache_dtype,
                device=self.device)
            self._scratch[cache_len] = kv.init_kv_cache(
                self.model, 1, cache_len, self.cache_dtype,
                device=self.device)
        return self._rungs[cache_len]

    def _ensure_cache(self, need: int, idle: bool) -> None:
        want = self._bucket_for(need)
        if self._caches is None or (idle and want != self._cache_len):
            # idle engine: re-page to exactly what the next admission
            # needs (a 17-token prompt must not pay for max_len), zeroed
            # as a fresh cache is
            self._caches = self._rung(want)
            for c in self._caches:
                for t in c.values():
                    t.zero_()
            self._cache_len = want
            return
        if want > self._cache_len:
            # grow to the next page: rows [0, old) copied, the rest zeros.
            # Keys past a slot's position are never read, so the in-flight
            # slots decode on unchanged
            old = self._cache_len
            grown = self._rung(want)
            for c, g in zip(self._caches, grown):
                for n, t in c.items():
                    g[n][:, :, :old].copy_(t)
                    g[n][:, :, old:].zero_()
            self._caches = grown
            self._cache_len = want
            self.cache_grows += 1

    def cache_bytes_per_slot(self) -> int:
        if self._caches is None:
            return 0
        total = sum(t.numel() * t.element_size() for c in self._caches
                    for t in c.values())
        return total // self.slots

    # -- the persistent step loop ---------------------------------------

    @contextlib.contextmanager
    def _on_device(self):
        """The context of the engine's device work: its device and, on
        CUDA, its stream, which every step, copy and graph runs on."""
        if self.device.type != "cuda":
            yield
            return
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            yield

    def _upload(self, name: str, values) -> None:
        """Write ``values`` into the leading entries of the static input
        ``name`` through its host mirror."""
        values = np.asarray(values).reshape(-1)
        n = values.shape[0]
        host = self._host_in[name].view(-1)[:n]
        host.numpy()[:] = values
        self._static[name].view(-1)[:n].copy_(host, non_blocking=True)

    def _download(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (float32) on the host.  On CUDA it is copied into a pinned
        buffer kept for its shape, and the host waits on an event after
        the copy; the next download of that shape rewrites the buffer."""
        if self.device.type != "cuda":
            return t
        key = (tuple(t.shape), t.dtype)
        buf = self._host_out.get(key)
        if buf is None:
            buf = self._host_out[key] = torch.empty(
                t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        self._done.record()
        self._done.synchronize()
        return buf

    def _run(self, kind: str, body):
        """``body()`` for the bucket (kind, current cache length).  On the
        CPU it runs eagerly.  On CUDA the bucket's first call runs it
        eagerly, the real step on live state, then captures it into a CUDA
        graph (B8's library and cuBLAS's workspace already exist by then,
        and nothing executes during the capture); every later call replays
        the graph.  Returns the step's output, which the next call of
        another bucket may overwrite."""
        if self.device.type != "cuda":
            return body()
        key = (kind, self._cache_len)
        g = self._graphs.get(key)
        if g is None:
            out = body()
            graph = torch.cuda.CUDAGraph()
            # thread_local: another thread's CUDA calls cannot invalidate
            # the capture
            with counting_captures() as b8, torch.cuda.graph(
                    graph, pool=self._pool, stream=self._stream,
                    capture_error_mode="thread_local"):
                static_out = body()
            self._graphs[key] = _Graph(graph, static_out, dict(b8))
            self.graph_captures += 1
            return out
        g.graph.replay()
        count_replay(g.b8)
        self.graph_replays += 1
        return g.out

    def _loop(self) -> None:
        telemetry.thread_name("decode engine")
        # inference mode, the current device and stream are per thread
        with torch.inference_mode(), self._on_device():
            while True:
                try:
                    if not self._tick():
                        return
                except Exception as e:  # noqa: BLE001 - engine must survive
                    # a fault no one slot owns fails every in-flight
                    # sequence typed instead of wedging the loop; the
                    # queue keeps serving later ticks
                    logger.exception("decode: step loop error; failing the "
                                     "in-flight sequences")
                    now = self.clock()
                    for s in range(self.slots):
                        seq = self._slots[s]
                        if seq is not None:
                            seq.req._resolve(error=e, now=now)
                            self._slots[s] = None
                            self.seqs_failed += 1

    def _fail_slot(self, s: int, err: Exception) -> None:
        seq = self._slots[s]
        if seq is not None:
            if seq.req.rid is not None:
                telemetry.flow_step(seq.req.rid, hop="decode.fault",
                                    slot=s, error=type(err).__name__)
            seq.req._resolve(error=err, now=self.clock())
            self._slots[s] = None
            self.seqs_failed += 1

    def _finish_slot(self, s: int) -> None:
        seq = self._slots[s]
        out = seq.buf[: seq.t0 + seq.emitted].copy()
        seq.req._resolve(result=out, version="decode", now=self.clock())
        reg = metrics_export._REGISTRY
        if reg is not None and seq.req.latency_s is not None:
            reg.observe("bigdl_decode_ttlt_seconds", seq.req.latency_s,
                        help="time to last token (submit to full row), "
                             "seconds")
        self._slots[s] = None
        self.seqs_done += 1

    def _sample(self, seq: _Seq, logits_row) -> int:
        tok = sample_next(logits_row[None], seq.temperature, seq.top_k,
                          seq.generator)
        return int(tok[0])

    def _advance(self, s: int, tok: int) -> None:
        """Record one emitted token for slot ``s``; finish the sequence the
        same tick when it hits EOS or its budget."""
        seq = self._slots[s]
        seq.pos += 1
        seq.buf[seq.pos] = tok
        seq.emitted += 1
        self.tokens_out += 1
        if seq.req.rid is not None:
            telemetry.flow_step(seq.req.rid, hop="decode.tick", slot=s,
                                n=seq.emitted)
        if (seq.eos is not None and tok == seq.eos) or \
                seq.emitted >= seq.max_tokens:
            self._finish_slot(s)

    def _prefill(self, s: int, prompt: np.ndarray) -> torch.Tensor:
        """Run the prompt into slot ``s``: the rows=1 step of
        ``cached_generate`` once per position on the rung's scratch cache,
        then the scratch committed into the slot.  Returns the last
        position's log-probs, float32 [vocab] on the host."""
        L = self._cache_len
        scratch = self._scratch[L]
        self._upload("prompt", prompt)
        self._cursor.zero_()
        for _ in range(len(prompt)):
            logits = self._run("prefill", lambda: self._prompt_step(scratch))
        out = self._download(logits)[0]   # before another graph replays
        self._upload("slot", [s])
        self._run("commit", lambda: self._commit(L))
        return out

    def _prompt_step(self, scratch) -> torch.Tensor:
        """One prompt position on ``scratch``: token prompt[cursor] at
        position cursor, both read on the device; advances the cursor.
        Returns float32 log-probs [1, vocab]."""
        cursor = self._cursor
        tok = self._static["prompt"].index_select(0, cursor)
        logits = kv.decode_step(self.model, scratch, tok, cursor)
        cursor.add_(1)
        return logits.float()

    def _commit(self, cache_len: int) -> None:
        """Write rung ``cache_len``'s scratch into the slot the static
        ``slot`` input names: every row of it, for every layer."""
        slot = self._static["slot"]
        for c, sc in zip(self._rungs[cache_len], self._scratch[cache_len]):
            for n, t in c.items():
                t.index_copy_(0, slot, sc[n])

    def _step_all(self, tp: np.ndarray) -> torch.Tensor:
        """One decode tick of every slot at ``tp``, int32 [2, slots]
        (tokens, positions): returns float32 [slots, vocab] log-probs on
        the host."""
        caches, static = self._caches, self._static["tp"]
        self._upload("tp", tp)
        logits = self._run("tick", lambda: kv.decode_step(
            self.model, caches, static[0], static[1]).float())
        return self._download(logits)

    def _admit(self, req: PendingRequest, s: int) -> None:
        p = req.payload
        generator = (torch.Generator().manual_seed(p["seed"])
                     if p["temperature"] > 0 else None)
        seq = _Seq(req, p["prompt"], p["max_tokens"], p["eos"],
                   p["temperature"], p["top_k"], generator)
        self._slots[s] = seq
        if req.rid is not None:
            telemetry.flow_step(req.rid, hop="decode.admit", slot=s,
                                prompt_len=len(p["prompt"]))
        try:
            chaos.fire(f"serve.decode@{s}", thread_exc=SlotFault)
        except Exception as e:  # noqa: BLE001 - typed per-sequence fail
            self._fail_slot(s, e)
            return
        try:
            logits = self._prefill(s, p["prompt"])
        except Exception as e:  # noqa: BLE001 - typed per-sequence fail
            self._fail_slot(s, SlotFault(f"decode: prefill failed in "
                                         f"slot {s}: {e!r}"))
            return
        self.prefill_steps += 1
        self._advance(s, self._sample(seq, logits))

    def _tick(self) -> bool:
        """One loop iteration: admit into free slots, then decode every
        active slot one position.  False when closed and drained."""
        q = self.queue
        free = [s for s in range(self.slots) if self._slots[s] is None]
        n_active = self.slots - len(free)
        incoming: List[PendingRequest] = []
        if free and (self.admission == "continuous" or n_active == 0):
            incoming = q.take(len(free))
        if n_active == 0 and not incoming:
            if q.closed and q.depth() == 0:
                return False
            q.wait_for_work(DecodeQueue._SLICE)
            return True
        t_start = self.clock()
        tokens_before = self.tokens_out
        if incoming:
            need = max(len(r.payload["prompt"]) + r.payload["max_tokens"]
                       for r in incoming)
            self._ensure_cache(need, idle=(n_active == 0))
            for r in incoming:
                self._admit(r, free.pop(0))
        # every still-active slot (freshly prefilled ones too: their first
        # token is already in the buffer) advances one position
        active = [s for s in range(self.slots) if self._slots[s] is not None]
        for s in list(active):
            try:
                chaos.fire(f"serve.decode@{s}", thread_exc=SlotFault)
            except Exception as e:  # noqa: BLE001 - typed per-sequence
                self._fail_slot(s, e)
                active.remove(s)
        if active:
            tp = np.zeros((2, self.slots), np.int32)   # tokens, positions
            for s in active:
                seq = self._slots[s]
                tp[0, s] = seq.buf[seq.pos]
                tp[1, s] = seq.pos
            logits = self._step_all(tp)   # the tick's one host sync
            self.decode_steps += 1
            for s in active:
                self._advance(s, self._sample(self._slots[s], logits[s]))
        dt = self.clock() - t_start
        if self.min_step_s > 0 and dt < self.min_step_s:
            time.sleep(self.min_step_s - dt)
            dt = self.min_step_s
        self._busy_s += dt
        q.note_service(max(self.tokens_out - tokens_before, 1), dt)
        if telemetry.get_active() is not None or \
                metrics_export._REGISTRY is not None:
            n_active = sum(1 for x in self._slots if x is not None)
            steps = self.prefill_steps + self.decode_steps
            telemetry.counter(
                "serve.decode",
                tokens_per_s=self.tokens_out / max(self._busy_s, 1e-9),
                fill=n_active / self.slots,
                prefill_frac=self.prefill_steps / max(steps, 1),
                decode_frac=self.decode_steps / max(steps, 1),
                cache_bytes_per_slot=self.cache_bytes_per_slot(),
                cache_len=self._cache_len)
        return True

    # -- introspection --------------------------------------------------

    def tokens_per_s(self) -> float:
        """Tokens emitted per second of busy loop time."""
        return self.tokens_out / max(self._busy_s, 1e-9)

    def stats(self) -> dict:
        out = {
            "slots": self.slots,
            "active": sum(1 for x in self._slots if x is not None),
            "admission": self.admission,
            "cache_len": self._cache_len,
            "cache_bytes_per_slot": self.cache_bytes_per_slot(),
            "cache_grows": self.cache_grows,
            "prefill_steps": self.prefill_steps,
            "decode_steps": self.decode_steps,
            "tokens_out": self.tokens_out,
            "tokens_per_s": round(self.tokens_per_s(), 3),
            "seqs_done": self.seqs_done,
            "seqs_failed": self.seqs_failed,
            "queue": self.queue.stats(),
            "quota": self.quotas.stats(),
            "graphs": {"captures": self.graph_captures,
                       "replays": self.graph_replays,
                       "buckets": sorted(f"{kind}/{n}" for kind, n
                                         in list(self._graphs))},
        }
        if self._recorder is not None:
            out["trace_recording"] = self._recorder.stats()
        return out
