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

``mesh=`` (the reference's ``:226-283``, ``:504-545``): the engine on a
layout, a mesh ``MeshLayout.build_mesh`` (or ``Engine.init(mesh_shape=
...)``) registered.  The parameters are placed by ``LayoutSharding``
over the mesh's ranks at construction and gathered once for the loop's
life (a tp-split attention keeps its own heads), and each rung's caches
follow the ``kv_cache`` role: the slots over data x fsdp, the heads over
tp, page growth included.  One rank leads (``serve/lead.py``): the
mesh's coordinate-0 rank owns the queue, the quotas, the admissions and
the sampling; construction, ``start`` and ``stop`` are called on every
rank of the mesh, ``submit`` and ``generate`` on the leader alone.  Each
loop turn with admissions sends a prefill plan (the cache rung and each
admitted slot's prompt): every rank prefills the slots it holds, and the
first rank of each block of slots (tp coordinate 0) sends their log-prob
rows to the leader, which samples the first tokens.  Each tick sends a
tick plan (every slot's token and position, the tokens the leader
sampled): every rank decodes its slots and heads, the blocks' rows go to
the leader, and it samples.  Followers never sample, so greedy and
temperature / top-k decoding agree on every rank.  Under a mesh every
step runs eagerly: its tensor-parallel gathers go over gloo on the host,
which a CUDA graph cannot capture, so ``stats()["graphs"]`` shows no
capture (graph capture over NCCL waits for a four-card mesh).

Not ported: the persistent compile cache and its compile cards (the CUDA
graphs are the port's warm start).

Knobs (``utils/config``; constructor arguments override):
``BIGDL_TORCH_DECODE_SLOTS`` (4), ``_PAGE`` (128), ``_MAX_LEN`` (0 = the
model's positional cap), ``_QUEUE_LIMIT`` (64), ``_DEADLINE_MS`` (0 =
none), ``_ADMISSION`` (``continuous``, or ``batch``: run to completion)
and ``_MIN_STEP_MS`` (0: a per-tick pacing floor).
"""

from __future__ import annotations

import contextlib
import itertools
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
from . import lead as lead_mod
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
    ``_on_device()``; on an engine not started, in the caller's.  On a
    mesh (module docstring) a follower's steps run in its follow thread
    (:meth:`follow`)."""

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
        lay = None if mesh is None else kv._layout_of(mesh)
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
        self._mesh = mesh
        self._lead = self._plan = None
        #: this rank's slots [lo, lo + n) of the engine's
        self._lo, self._n = 0, self.slots
        if mesh is not None:
            self._on_mesh(lay)
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
            "tp": torch.zeros((2, self._n), dtype=torch.int32,
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
        self._ended = False

    def _on_mesh(self, lay) -> None:
        """Place the model over the mesh (collective: every rank of it
        constructs the engine), find this rank's slots, and the rank that
        sends each block of slots' rows to the leader (tp coordinate 0)."""
        from ..parallel.sharding import LayoutSharding
        from ..utils.engine import Engine
        mesh = self._mesh
        self._lead = lead_mod.Lead(mesh)
        mha = kv._mha_modules(self.model)
        with Engine.pinned(mesh):
            self._plan = LayoutSharding(self.model).place(self.model)
        heads, dim = (mha[0].num_heads, mha[0].head_dim) if mha else (1, 1)
        self._lo, self._n, axes = kv._rows_of(lay, self.slots, heads,
                                              self.max_len, dim, mesh)
        names, sizes = tuple(mesh.mesh_dim_names), lay.shape()
        self._senders = {}
        for coord in itertools.product(*(range(sizes[a]) for a in names)):
            if any(c for a, c in zip(names, coord) if a not in axes):
                continue
            block = 0
            for a in axes:
                block = block * sizes[a] + coord[names.index(a)]
            self._senders[block] = int(mesh.mesh[coord])
        #: prompt positions the leader planned, by block of slots
        self.prefill_positions = [0] * len(self._senders)

    @property
    def following(self) -> bool:
        """True on a rank of the mesh that follows another's lead."""
        return self._lead is not None and not self._lead.is_leader

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "DecodeEngine":
        if self._lead is not None:
            self._lead.keep_alive()
        if self._thread is None:
            self._thread = threading.Thread(
                target=self.follow if self.following else self._loop,
                name="bigdl-torch-decode-engine", daemon=True)
            self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Close admissions; ``drain=True`` finishes every queued and
        in-flight sequence first.  Whatever is still queued fails typed.
        On a mesh the leader's loop tells the followers to stop as it
        ends; a follower's ``stop`` waits for that."""
        t = self._thread
        if self.following:
            if t is not None:
                t.join()
                self._thread = None
            return
        self.queue.close(drain=drain)
        if t is not None:
            t.join(timeout=120.0)
            self._thread = None
        self.queue.fail_pending()
        self._end()

    def _end(self) -> None:
        """The leader's last message to its followers (once)."""
        if self._lead is not None and not self._ended:
            self._ended = True
            self._lead.send(lead_mod.STOP)

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
        upstream flow id (``X-BigDL-Request-Id``).  On a mesh the leader
        alone takes submissions."""
        if self.following:
            raise ServeError(
                f"decode: submit on rank {self._lead.rank}, which follows "
                f"rank {self._lead.leader}: call it on the leader")
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
                mesh=self._mesh, device=self.device)
            self._scratch[cache_len] = kv.init_kv_cache(
                self.model, 1, cache_len, self.cache_dtype,
                mesh=self._mesh, device=self.device)
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
        return total // self._n   # this rank's slots (and heads)

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
        another bucket may overwrite.  On a mesh it runs eagerly (module
        docstring)."""
        if self.device.type != "cuda" or self._mesh is not None:
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

    @contextlib.contextmanager
    def _placed(self):
        """On a mesh: the mesh pinned to this thread and the parameters
        gathered for the block (collective: the leader's loop and every
        follower's enter it together)."""
        if self._mesh is None:
            yield
            return
        from ..utils.engine import Engine
        with Engine.pinned(self._mesh), self._plan.materialized():
            yield

    def _loop(self) -> None:
        telemetry.thread_name("decode engine")
        # inference mode, the current device and stream are per thread
        with torch.inference_mode(), self._on_device(), self._placed():
            try:
                self._serve()
            finally:
                self._end()

    def _serve(self) -> None:
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

    def follow(self) -> None:
        """A follower's loop on a mesh (module docstring): mirror each
        prefill plan's cache rung and prefill the admitted slots held
        here, decode each tick plan's slots, send the leader this block's
        rows where this rank sends them, until the leader stops."""
        telemetry.thread_name("decode follower")
        with torch.inference_mode(), self._on_device(), self._placed():
            while True:
                msg = self._lead.recv()
                if msg.op == lead_mod.STOP:
                    return
                if msg.op == lead_mod.PREFILL:
                    self._ensure_cache(msg.ints[0], bool(msg.ints[1]))
                    self._prefill_mesh(msg.blob)
                elif msg.op == lead_mod.TICK:
                    self._tick_mesh(msg.array)
                else:
                    raise ServeError(f"decode: unexpected message "
                                     f"{lead_mod.OP_NAMES.get(msg.op)}")

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
        the host.  On a mesh the tick plan goes to the followers first and
        the rows come from every block of slots."""
        if self._lead is not None:
            with self._lead.lock:   # the plan and the rows it brings back
                self._lead.send(lead_mod.TICK, array=tp)
                return self._tick_mesh(tp)
        return self._step_local(tp)

    def _step_local(self, tp: np.ndarray) -> torch.Tensor:
        """The tick of this rank's slots at ``tp`` (int32 [2, n])."""
        caches, static = self._caches, self._static["tp"]
        self._upload("tp", tp)
        logits = self._run("tick", lambda: kv.decode_step(
            self.model, caches, static[0], static[1]).float())
        return self._download(logits)

    # -- the mesh's steps (module docstring) ------------------------------

    def _to_leader(self, rows: Optional[np.ndarray]) -> None:
        """A follower's rows of its block of slots to the leader, from the
        rank that sends the block's (its tp coordinate 0); nothing where
        there are none."""
        lead = self._lead
        if rows is not None and \
                self._senders[self._lo // self._n] == lead.rank:
            lead.send_to(lead.leader, rows)

    def _tick_mesh(self, tp: np.ndarray) -> Optional[np.ndarray]:
        """Every rank's half of one tick plan: decode this rank's slots;
        the leader (block 0) gets every block's, [slots, vocab]."""
        lo, n = self._lo, self._n
        local = np.array(self._step_local(tp[:, lo:lo + n]))
        if not self._lead.is_leader:
            self._to_leader(local)
            return None
        return np.concatenate([local] + [
            self._lead.recv_from(r)
            for b, r in sorted(self._senders.items()) if b])

    def _prefill_mesh(self, items) -> dict:
        """Every rank's half of one prefill plan ``items`` [(slot,
        prompt)]: prefill the slots held here; the leader gets {slot:
        log-prob row} of every item."""
        lo, n = self._lo, self._n
        mine = [(s, p) for s, p in items if lo <= s < lo + n]
        rows = np.stack([np.array(self._prefill(s - lo, p))
                         for s, p in mine]) if mine else None
        if not self._lead.is_leader:
            self._to_leader(rows)
            return {}
        out = {s: rows[i] for i, (s, _) in enumerate(mine)}
        by_block: dict = {}
        for s, _ in items:
            if not lo <= s < lo + n:
                by_block.setdefault(s // n, []).append(s)
        for b, slots in sorted(by_block.items()):
            out.update(zip(slots, self._lead.recv_from(self._senders[b])))
        return out

    def _seat(self, req: PendingRequest, s: int) -> bool:
        """Seat ``req`` in slot ``s``; False where the slot's fault point
        fails it at admission."""
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
            return False
        return True

    def _admit(self, req: PendingRequest, s: int) -> None:
        if not self._seat(req, s):
            return
        p, seq = req.payload, self._slots[s]
        try:
            logits = self._prefill(s, p["prompt"])
        except Exception as e:  # noqa: BLE001 - typed per-sequence fail
            self._fail_slot(s, SlotFault(f"decode: prefill failed in "
                                         f"slot {s}: {e!r}"))
            return
        self.prefill_steps += 1
        self._advance(s, self._sample(seq, logits))

    def _admit_mesh(self, incoming, free, need: int, idle: bool) -> None:
        """The leader's admissions on a mesh: seat them, send one prefill
        plan (the cache rung to mirror and the seated slots' prompts),
        prefill with the followers, sample each first token."""
        items = [(s, r.payload["prompt"]) for r, s in
                 ((r, free.pop(0)) for r in incoming) if self._seat(r, s)]
        with self._lead.lock:   # the plan and the rows it brings back
            self._lead.send(lead_mod.PREFILL, (need, int(idle)), blob=items)
            rows = self._prefill_mesh(items)
        for s, p in items:
            self.prefill_positions[s // self._n] += len(p)
            self.prefill_steps += 1
            self._advance(s, self._sample(self._slots[s], rows[s]))

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
            if self._lead is None:
                for r in incoming:
                    self._admit(r, free.pop(0))
            else:
                self._admit_mesh(incoming, free, need, n_active == 0)
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
        if self._lead is not None:
            out["mesh"] = {"ranks": list(self._lead.ranks),
                           "leader": self._lead.leader,
                           "role": "follower" if self.following
                           else "leader", "slots_here": [self._lo, self._n],
                           "prefill_positions": list(self.prefill_positions),
                           "messages": dict(self._lead.counts)}
        return out
