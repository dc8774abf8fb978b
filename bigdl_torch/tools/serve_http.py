"""HTTP front door of the port's online inference server (stdlib only).

Counterpart of the repo's ``tools/serve_http.py``: the same routes, status
codes and JSON, over ``bigdl_torch.serve``.  ``ThreadingHTTPServer`` runs
one thread a connection, each blocking on its request's handle while the
server's replica pool batches across connections.  Routes:

    POST /v1/predict   {"inputs": <sample or list of samples>,
                        "tenant": "team-a", "priority": 2}
                       -> {"outputs": ..., "version": N, "latency_ms": x}
                          (inputs are cast to float32, as the reference
                          does: token-id models are scored through
                          ``InferenceServer.submit``)
    POST /v1/generate  {"prompt": [1, 5, 9], "max_tokens": 32,
                        "temperature": 0.0, "eos_token": 2, ...}
                       -> {"tokens": [...], "generated": N,
                           "latency_ms": x} through the attached
                          ``DecodeEngine`` (``--generate``; 404 without
                          one); the deadline is time to last token
    POST /v1/swap      {"source": "<ckpt dir | snapshot | module file>",
                        "quantized": false, "canary_fraction": 0.1}
                       -> {"version": N}
    GET  /v1/stats     -> server.stats() (with the decode engine's under
                          "decode", the deploy controller's under
                          "deploy")
    GET  /v1/versions  -> the deploy controller's version timeline, or
                          {"deploy": false, ...} without one
    GET  /healthz      -> {"ok": true, "version": N}, or 503 once a
                          replica's restart budget is spent
    GET  /metrics      -> Prometheus text (``utils/metrics_export``)

Typed shedding maps onto status codes: 429 ServerOverloaded /
QuotaExceeded (with Retry-After), 504 RequestTimeout, 503 ServerClosed or
an unhealthy pool (with Retry-After), 400 a bad request.  The
``X-BigDL-Record-Trace: <path>`` header arms offered-traffic recording
(``off`` writes it and stops).  SIGTERM stops accepting and drains: every
admitted request is answered before the process exits 0.

Usage (on the CUDA device unless ``--device cpu``)::

    python -m bigdl_torch.tools.serve_http --model lenet --port 8000
    python -m bigdl_torch.tools.serve_http --model lenet --generate \
        --checkpoint /ckpts/run1 --watch /ckpts/run1 --autoscale-max 2

``--routed --router-layout d,f,t --replicas n`` fronts a
``TopologyRouter`` (``serve/router.py``): ``n`` members, each a mesh of
``d·f·t`` ranks serving the model sharded by its layout, over a world of
gloo ranks.  Start the same command once a rank with the ``Engine``'s
env contract (``BIGDL_TORCH_COORDINATOR``, ``_NUM_PROCESSES``,
``_PROCESS_ID``); rank 0 binds HTTP and leads, the other ranks follow
its members' batches and swaps and exit once rank 0 has stopped::

    BIGDL_TORCH_COORDINATOR=file:///tmp/rv BIGDL_TORCH_NUM_PROCESSES=4 \
    BIGDL_TORCH_PROCESS_ID=$r python -m bigdl_torch.tools.serve_http \
        --routed --router-layout 1,1,2 --replicas 2 --port 0
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def retry_after_headers(seconds) -> dict:
    """The Retry-After header for a typed backoff estimate: whole
    seconds, rounded UP, never below 1 (a 0s hint would tell the client
    to hammer).  One rounding rule for every 429 and 503."""
    return {"Retry-After": str(max(1, int(float(seconds) + 0.999)))}


def build_model(name: str, device=None):
    """A built architecture with seeded random weights, and its example
    sample; real weights come from ``--checkpoint`` or ``POST /v1/swap``."""
    import numpy as np
    import torch

    gen = torch.Generator().manual_seed(0)
    if name == "lenet":
        from ..models.lenet import LeNet5
        return (LeNet5(10).build(device, gen),
                np.zeros((28, 28, 1), np.float32))
    if name == "linear":
        from .. import nn
        return (nn.Sequential().add(nn.Linear(4, 3)).build(device, gen),
                np.zeros((4,), np.float32))
    raise SystemExit(f"unknown --model {name!r} (lenet|linear)")


def make_handler(server):
    import numpy as np

    from ..serve import (ReplicaLostError, RequestTimeout, ServeError,
                         ServerClosed, ServerOverloaded)
    from ..utils import metrics_export, telemetry

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet; stats has the counters
            pass

        def _reply(self, code: int, obj: dict, headers=None) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            # echo the caller's request id so a trace of the client side
            # can be joined to ours even when the request is shed early
            rid = self.headers.get(telemetry.REQUEST_ID_HEADER)
            if rid:
                self.send_header(telemetry.REQUEST_ID_HEADER, rid)
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _reply_text(self, code: int, text: str, ctype: str) -> None:
            body = text.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        @staticmethod
        def _retry_after(seconds=None) -> dict:
            """Retry-After header for every 503/429: the batcher's typed
            drain estimate unless the error carried its own — the
            orchestrator-facing backoff hint, not just on the 429 path."""
            if seconds is None:
                try:
                    seconds = server.batcher.retry_after_s()
                except AttributeError:  # a front end with no one queue
                    seconds = 1.0
            return retry_after_headers(seconds)

        def _body(self):
            length = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(length) if length else b"{}"
            return json.loads(raw.decode() or "{}")

        def _arm_trace(self):
            """`X-BigDL-Record-Trace: <path>` arms offered-traffic
            recording (serve/tracefile.py) on the live server; `off`
            stops it and writes the armed path."""
            rt = self.headers.get("X-BigDL-Record-Trace")
            if not rt:
                return
            if rt.strip().lower() in ("off", "stop", "0"):
                server.stop_trace()
            else:
                server.record_trace(rt.strip())

        def do_GET(self):
            if self.path == "/healthz":
                if not server.healthy():
                    st = server.stats()
                    return self._reply(503, {
                        "ok": False,
                        "reason": st.get("unhealthy_reason"),
                        "type": st.get("unhealthy_type"),
                        "version": getattr(server.version, "id", None)},
                        headers=self._retry_after())
                self._reply(200, {"ok": True,
                                  "version": server.version.id})
            elif self.path == "/v1/stats":
                st = server.stats()
                eng = getattr(server, "decode_engine", None)
                if eng is not None:
                    st["decode"] = eng.stats()
                self._reply(200, st)
            elif self.path == "/metrics":
                # Prometheus text exposition: a front exposing
                # metrics_text() answers with it, a server renders the
                # process-wide registry
                if not metrics_export.enabled():
                    return self._reply(404, {
                        "error": "metrics plane disabled "
                                 "(BIGDL_TORCH_METRICS=0)"})
                try:
                    fn = getattr(server, "metrics_text", None)
                    if fn is not None:
                        text = fn()
                    else:
                        reg = metrics_export.registry()
                        text = reg.render() if reg is not None else ""
                except Exception as e:  # noqa: BLE001 — surface it
                    return self._reply(500, {"error": str(e),
                                             "type": type(e).__name__})
                self._reply_text(200, text, metrics_export.CONTENT_TYPE)
            elif self.path == "/v1/versions":
                ctl = getattr(server, "_deploy", None)
                if ctl is None:
                    return self._reply(200, {
                        "deploy": False, "timeline": [],
                        "version": server.version.id})
                out = ctl.versions()
                out["deploy"] = True
                out["version"] = server.version.id
                self._reply(200, out)
            else:
                self._reply(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            try:
                body = self._body()
            except (ValueError, json.JSONDecodeError) as e:
                return self._reply(400, {"error": f"bad JSON: {e}"})
            if self.path == "/v1/predict":
                return self._predict(body)
            if self.path == "/v1/generate":
                return self._generate(body)
            if self.path == "/v1/swap":
                return self._swap(body)
            self._reply(404, {"error": f"no route {self.path}"})

        def _predict(self, body):
            self._arm_trace()
            if "inputs" not in body:
                return self._reply(400, {"error": "missing 'inputs'"})
            x = np.asarray(body["inputs"], np.float32)
            batched = x.ndim > server.sample_ndim
            rows = x if batched else x[None]
            deadline = body.get("deadline_ms")
            tenant = body.get("tenant")
            priority = int(body.get("priority", 0))
            # a request id minted upstream rides in on the header, so
            # this process's spans join the caller's flow
            rid = self.headers.get(telemetry.REQUEST_ID_HEADER)
            try:
                # submit every row FIRST (they coalesce into one bucket),
                # then wait — a row-at-a-time predict() would serialize
                handles = [server.submit(r, deadline_ms=deadline,
                                         tenant=tenant, priority=priority,
                                         request_id=rid)
                           for r in rows]
                outs = [h.result(timeout=body.get("timeout_s", 120))
                        for h in handles]
            except ServerOverloaded as e:
                # covers QuotaExceeded too (a subclass): typed 429 with
                # the server's retry estimate in the standard header
                retry = getattr(e, "retry_after_s", None)
                hdrs = retry_after_headers(retry) if retry else None
                return self._reply(429, {"error": str(e),
                                         "type": type(e).__name__,
                                         "retry_after_s": retry},
                                   headers=hdrs)
            except RequestTimeout as e:
                return self._reply(504, {"error": str(e),
                                         "type": "RequestTimeout"})
            except ReplicaLostError as e:
                # the unhealthy path (restart budget spent / no live
                # replica): 503 WITH Retry-After, same as /healthz —
                # the caller should back off while the orchestrator
                # replaces the process
                return self._reply(503, {"error": str(e),
                                         "type": type(e).__name__},
                                   headers=self._retry_after())
            except ServerClosed as e:
                return self._reply(503, {"error": str(e),
                                         "type": "ServerClosed"},
                                   headers=self._retry_after())
            except ServeError as e:
                # remaining admission rejections (e.g. sample shape does
                # not match the served model) are the client's fault
                return self._reply(400, {"error": str(e),
                                         "type": type(e).__name__})
            except Exception as e:  # noqa: BLE001 — typed per-request
                return self._reply(500, {"error": str(e),
                                         "type": type(e).__name__})
            out = np.stack(outs)
            lat = max(h.latency_s or 0.0 for h in handles)
            self._reply(200, {
                "outputs": (out if batched else out[0]).tolist(),
                "version": handles[-1].version,
                "latency_ms": round(lat * 1e3, 3)})

        def _generate(self, body):
            eng = getattr(server, "decode_engine", None)
            if eng is None:
                return self._reply(404, {
                    "error": "no decode engine attached (start "
                             "serve_http with --generate)"})
            rt = self.headers.get("X-BigDL-Record-Trace")
            if rt:
                if rt.strip().lower() in ("off", "stop", "0"):
                    eng.stop_trace()
                else:
                    eng.record_trace(rt.strip())
            if "prompt" not in body:
                return self._reply(400, {"error": "missing 'prompt'"})
            kw = dict(deadline_ms=body.get("deadline_ms"),
                      tenant=body.get("tenant"),
                      priority=int(body.get("priority", 0)),
                      temperature=float(body.get("temperature", 0.0)),
                      top_k=int(body.get("top_k", 0)),
                      seed=int(body.get("seed", 0)))
            if "eos_token" in body:
                kw["eos_token"] = (int(body["eos_token"])
                                   if body["eos_token"] is not None
                                   else None)
            kw["request_id"] = self.headers.get(
                telemetry.REQUEST_ID_HEADER)
            prompt = np.asarray(body["prompt"], np.int32)
            try:
                h = eng.submit(prompt, int(body.get("max_tokens", 16)),
                               **kw)
                out = h.result(timeout=body.get("timeout_s", 120))
            except ServerOverloaded as e:
                retry = getattr(e, "retry_after_s", None)
                hdrs = retry_after_headers(retry) if retry else None
                return self._reply(429, {"error": str(e),
                                         "type": type(e).__name__,
                                         "retry_after_s": retry},
                                   headers=hdrs)
            except RequestTimeout as e:
                return self._reply(504, {"error": str(e),
                                         "type": "RequestTimeout"})
            except ServerClosed as e:
                return self._reply(503, {"error": str(e),
                                         "type": "ServerClosed"},
                                   headers=self._retry_after())
            except ServeError as e:
                return self._reply(400, {"error": str(e),
                                         "type": type(e).__name__})
            except Exception as e:  # noqa: BLE001 — typed per-request
                return self._reply(500, {"error": str(e),
                                         "type": type(e).__name__})
            out = np.asarray(out)
            self._reply(200, {
                "tokens": out.tolist(),
                "generated": int(out.shape[0] - prompt.shape[0]),
                "latency_ms": round((h.latency_s or 0.0) * 1e3, 3)})

        def _swap(self, body):
            src = body.get("source") or body.get("checkpoint")
            if not src:
                return self._reply(400, {"error": "missing 'source'"})
            canary = body.get("canary_fraction")
            try:
                vid = server.swap(src,
                                  quantized=bool(body.get("quantized")),
                                  canary_fraction=(float(canary)
                                                   if canary else None))
            except Exception as e:  # noqa: BLE001 — surface to the client
                return self._reply(500, {"error": str(e),
                                         "type": type(e).__name__})
            self._reply(200, {"version": vid})

    return Handler


def serve_forever(server, host: str, port: int):
    """Start answering on (host, port) in a daemon thread; returns the
    ThreadingHTTPServer (``shutdown()`` stops it; port 0 picks a free one,
    ``server_address`` says which)."""
    # the sample rank tells one sample from a batch on /v1/predict
    server.sample_ndim = server._example.ndim \
        if server._example is not None else 1
    from ..utils import metrics_export
    if metrics_export.enabled():
        metrics_export.arm()  # idempotent; feeds GET /metrics
    httpd = ThreadingHTTPServer((host, port), make_handler(server))
    t = threading.Thread(target=httpd.serve_forever, daemon=True,
                         name="bigdl-torch-serve-http")
    t.start()
    return httpd


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m bigdl_torch.tools."
                                      "serve_http")
    ap.add_argument("--model", default="lenet", help="lenet|linear")
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint dir / snapshot / module file to load "
                         "as the initial weights (the swap path)")
    ap.add_argument("--quantized", action="store_true",
                    help="int8-quantize the initial checkpoint load")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000,
                    help="0 picks a free port (printed at start)")
    ap.add_argument("--replicas", type=int, default=None)
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument("--max-wait-ms", type=float, default=None)
    ap.add_argument("--queue-limit", type=int, default=None)
    ap.add_argument("--deadline-ms", type=float, default=None)
    ap.add_argument("--routed", action="store_true",
                    help="front a TopologyRouter: replicas become "
                         "mesh-sharded members on disjoint rank subsets "
                         "of a gloo world (one process a rank; rank 0 "
                         "binds HTTP)")
    ap.add_argument("--router-layout", default="1,1,1",
                    help="with --routed: per-member MeshLayout "
                         "'data,fsdp,tp' (e.g. '1,1,2': tp=2 members of 2 "
                         "ranks each)")
    ap.add_argument("--autoscale-max", type=int, default=None,
                    help="pool ceiling; > 0 arms the queue-driven "
                         "autoscaler (BIGDL_TORCH_SERVE_AUTOSCALE_*)")
    ap.add_argument("--watch", default=None, metavar="LINEAGE_DIR",
                    help="continuous deployment: canary every verified new "
                         "release of this lineage dir into the server")
    ap.add_argument("--canary-fraction", type=float, default=None,
                    help="with --watch: canary batch fraction per release "
                         "(0 = plain full swaps)")
    ap.add_argument("--rollback-budget", type=int, default=None,
                    help="with --watch: consecutive canary rollbacks "
                         "before the controller freezes")
    ap.add_argument("--generate", action="store_true",
                    help="attach a DecodeEngine serving POST /v1/generate "
                         "(BIGDL_TORCH_DECODE_* tunes it)")
    ap.add_argument("--gen-vocab", type=int, default=256,
                    help="with --generate: TransformerLM vocab size")
    ap.add_argument("--gen-max-len", type=int, default=512,
                    help="with --generate: positional max_len cap")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from ..common import resolve_device
    from ..serve import InferenceServer, TopologyRouter
    from ..utils import telemetry
    from ..utils.engine import Engine

    device = resolve_device(args.device)
    if args.routed:
        # ranks that share a card need gloo (NCCL refuses two on one GPU)
        Engine.init(device=device, backend="gloo")
    # arm the span tracer per BIGDL_TORCH_TRACE
    tracer = telemetry.maybe_start()
    model, sample = build_model(args.model, device)
    kwargs = dict(example=sample, replicas=args.replicas,
                  max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                  queue_limit=args.queue_limit,
                  deadline_ms=args.deadline_ms,
                  autoscale_max=args.autoscale_max, device=device)
    if args.routed:
        server = TopologyRouter(model, layout=args.router_layout, **kwargs)
    else:
        server = InferenceServer(model, **kwargs)
    server.start()
    if args.routed and not server.leading:
        # a member rank: follow rank 0's members until rank 0 stops
        server.stop()
        _leave(tracer)
        return 0
    if args.checkpoint:
        server.swap(args.checkpoint, quantized=args.quantized)
    engine = None
    if args.generate:
        from ..models.transformer_lm import TransformerLM
        from ..serve import DecodeEngine
        lm = TransformerLM(vocab_size=args.gen_vocab,
                           max_len=args.gen_max_len, d_model=64,
                           num_heads=4, num_layers=2).build(
            device, torch.Generator().manual_seed(0))
        engine = DecodeEngine(lm, device=device).start()
        server.decode_engine = engine
    controller = None
    if args.watch:
        from ..serve.continuous import DeployController
        controller = DeployController(
            server, args.watch, canary_fraction=args.canary_fraction,
            rollback_budget=args.rollback_budget).start()
    httpd = serve_forever(server, args.host, args.port)
    host, port = httpd.server_address[:2]
    print(json.dumps({"serving": f"http://{host}:{port}",
                      "model": args.model, "device": str(device),
                      "routed": ({"layout": list(server.layout.sizes),
                                  "replicas": server.replicas,
                                  "world": Engine.group_size()}
                                 if args.routed else False),
                      "version": server.version.id,
                      "watching": args.watch,
                      "generate": bool(engine),
                      "stats": "/v1/stats"}), flush=True)
    # SIGTERM (a rolling restart): stop accepting, then drain, so every
    # admitted request is answered before the process exits
    stop_ev = threading.Event()

    def _graceful(signum, frame):
        del frame
        print(json.dumps({"stopping": signal.Signals(signum).name,
                          "drain": True}), flush=True)
        stop_ev.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _graceful)
    try:
        stop_ev.wait()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        if controller is not None:
            controller.stop()
        if engine is not None:
            engine.stop(drain=True)
        server.stop(drain=True)
        stats = server.stats()
        if args.routed:
            _leave(tracer)
        elif tracer is not None:
            tracer.close()
    print(json.dumps({"stopped": True, "stats": {
        k: stats.get(k, 0) for k in ("batches", "batch_rows",
                                     "batch_errors", "swaps")}}),
          flush=True)
    return 0


def _leave(tracer) -> None:
    """A routed rank's exit: the tracer closed, then every rank meets
    before the group is torn down (a peer still talking would abort)."""
    import torch.distributed as dist

    from ..utils.engine import Engine
    if tracer is not None:
        tracer.close()
    dist.barrier()
    Engine.reset()


if __name__ == "__main__":
    sys.exit(main())
