"""One fleet member: an InferenceServer process that registers itself.

Counterpart of the repository's ``tools/serve_worker.py``.  The process
``serve/fleet.py``'s supervisor spawns: it builds the model, starts the
server and the HTTP front end of ``tools/serve_http.py`` (so the wire
format is a standalone server's), publishes a CRC-framed member record and
a liveness heartbeat into the shared fleet dir, then beats until it is
stopped, condemned or killed.

- **register**: bind HTTP first (``--port 0`` picks a free port, which
  goes into the record), warm every bucket (``InferenceServer.warmup``:
  the first forwards load the kernels; the reference's shared AOT cache
  is not ported), then publish ``member.<idx>.<generation>`` and print
  ``{"member", "generation", "pid", "port", "ready_s"}``, ``ready_s``
  being the seconds from the start of :func:`main` to here.
- **beat**: restamp ``heartbeats/heartbeat.<idx>`` every
  ``BIGDL_TORCH_FLEET_HEARTBEAT`` seconds (``--heartbeat-s``).  Each turn
  fires the chaos point ``fleet.member@<idx>``: ``=exit@N`` ends the
  process, ``=wedge@N`` blocks this loop so the member goes
  publication-silent while its HTTP threads still answer (the zombie).
- **condemned**: the beat loop reads ``condemn.<idx>``; at or below the
  condemned generation the worker drains and exits 0.
- **signalled**: SIGTERM or SIGINT drain the admitted requests
  (``stop(drain=True)``) before the exit.

Run by hand (``--device cpu`` on the host; the card by default)::

    python -m bigdl_torch.tools.serve_worker --fleet-dir /tmp/fleet \\
        --index 0 --generation 1 --model linear --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time


def main(argv=None):
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(prog="python -m bigdl_torch.tools."
                                      "serve_worker")
    ap.add_argument("--fleet-dir", required=True)
    ap.add_argument("--index", type=int, required=True)
    ap.add_argument("--generation", type=int, default=1)
    ap.add_argument("--model", default="linear", help="lenet|linear")
    ap.add_argument("--checkpoint", default=None,
                    help="initial weights (ckpt dir / snapshot file)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = a free port; the bound port is published in "
                         "the member record")
    ap.add_argument("--replicas", type=int, default=None)
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument("--heartbeat-s", type=float, default=None)
    ap.add_argument("--platform", default=None,
                    help="the reference's spelling of --device (cpu|gpu)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..common import resolve_device
    from ..serve import default_buckets, fleet
    from ..serve.server import InferenceServer
    from ..utils import chaos, config, telemetry
    from .serve_http import build_model, serve_forever

    device = args.device
    if device is None and args.platform is not None:
        device = "cpu" if args.platform == "cpu" else "cuda"
    # no card and no --device: this raises; a member never falls back to
    # the host
    device = resolve_device(device)
    tracer = None
    if config.get_str("TRACE", ""):
        # each member its own track in a merged timeline, past the front's
        tracer = telemetry.Tracer(config.get_str("TRACE", ""),
                                  rank=10 + args.index, flush_every=64)
        telemetry.set_active(tracer)
        telemetry.thread_name(f"fleet member {args.index}")

    model, sample = build_model(args.model, device)
    server = InferenceServer(model, example=sample, replicas=args.replicas,
                             max_batch=args.max_batch, autoscale_max=0,
                             device=device)
    server.start()
    server.warmup(sample)
    if args.checkpoint:
        server.swap(args.checkpoint)

    httpd = serve_forever(server, args.host, args.port)
    port = httpd.server_address[1]
    fleet.publish_member(
        args.fleet_dir, index=args.index, generation=args.generation,
        pid=os.getpid(), port=port, host=args.host, devices=[str(device)],
        buckets=default_buckets(server.max_batch),
        max_batch=server.max_batch)
    fleet.beat(args.fleet_dir, args.index, args.generation, 0)
    telemetry.instant("fleet.register", cat="fleet", index=args.index,
                      generation=args.generation, port=port)
    print(json.dumps({"member": args.index, "generation": args.generation,
                      "pid": os.getpid(), "port": port,
                      "device": str(device),
                      "ready_s": time.perf_counter() - t_start}),
          flush=True)

    stop_ev = threading.Event()

    def _graceful(signum, frame):
        del signum, frame
        stop_ev.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _graceful)

    beat_s = (args.heartbeat_s if args.heartbeat_s is not None
              else config.get_float("FLEET_HEARTBEAT", 0.5))
    count = 0
    while not stop_ev.is_set():
        count += 1
        # the drill point: exit ends the process here; wedge blocks here,
        # so the beat below never runs again while HTTP still answers
        chaos.fire(f"fleet.member@{args.index}")
        if fleet.condemned_generation(args.fleet_dir,
                                      args.index) >= args.generation:
            telemetry.instant("fleet.condemned_exit", cat="fleet",
                              index=args.index, generation=args.generation)
            print(json.dumps({"member": args.index,
                              "generation": args.generation,
                              "condemned": True}), flush=True)
            break
        fleet.beat(args.fleet_dir, args.index, args.generation, count)
        stop_ev.wait(beat_s)

    # either way: answer the admitted requests before the sockets close
    httpd.shutdown()
    server.stop(drain=True)
    if tracer is not None:
        tracer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
