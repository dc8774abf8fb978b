"""The port's HTTP front door against the repo's ``tools/serve_http.py``.

The two handlers serve the same LeNet-5 weights (the reference's, copied
into the port) and, on ``/v1/generate``, the CLI's tiny LM (d_model 64, 4
heads: D = 16) with the same weights, each behind its own
``serve_forever`` on 127.0.0.1 port 0.  Every route gives the same status
code and the same JSON keys (``/v1/stats`` has the port's
``warmup_batches`` beside the reference's, and the decode engine's stats
its ``graphs`` where the reference has its compile cache); predict
outputs agree within 1e-5 (float32 convolution and matmul summed in
another order) and greedy tokens are equal.  Typed refusals map alike
(400, 404, 429 with Retry-After, 500, 503), ``/metrics`` parses, the
trace header records, ``serving_bench.main`` runs at a tiny size, and
the CLI answers predict, generate and swap, then drains on SIGTERM and
exits 0.
"""

import json
import os
import signal
import subprocess
import sys
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from bigdl_tpu import Engine
from bigdl_tpu.models import transformer_lm as jlm
from bigdl_tpu.models.lenet import LeNet5 as JLeNet5
from bigdl_tpu.serve import DecodeEngine as JDecodeEngine
from bigdl_tpu.serve import InferenceServer as JServer
from bigdl_tpu.serve import ReplicaLostError as JReplicaLost
from bigdl_tpu.serve import tracefile as jtf
from bigdl_tpu.utils import file_io as jio
from bigdl_tpu.utils import metrics_export as jmet

from bigdl_torch.models import LeNet5, TransformerLM
from bigdl_torch.serve import DecodeEngine, InferenceServer, ReplicaLostError
from bigdl_torch.tools import serve_http as tsh
from bigdl_torch.tools import serving_bench
from bigdl_torch.utils import metrics_export as tmet
from bigdl_torch.utils.convert import load_reference_tree

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TOOLS = os.path.join(_REPO, "tools")
if _TOOLS not in sys.path:
    sys.path.insert(0, _TOOLS)
import serve_http as jsh  # noqa: E402  the repo's tools/serve_http.py

REF_ATOL = 1e-5
EXAMPLE = np.zeros((28, 28, 1), np.float32)
LM_CFG = dict(vocab_size=256, max_len=64, d_model=64, num_heads=4,
              num_layers=2)
#: /v1/stats keys only the port has
PORT_ONLY_STATS = {"warmup_batches"}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _call(base, path, obj=None, raw=None, headers=None):
    data = raw if raw is not None else (
        None if obj is None else json.dumps(obj).encode())
    req = urllib.request.Request(base + path, data=data,
                                 headers=headers or {},
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            body, code, hdrs = r.read(), r.status, dict(r.headers)
    except urllib.error.HTTPError as e:
        body, code, hdrs = e.read(), e.code, dict(e.headers)
    ctype = hdrs.get("Content-Type", "")
    return code, (json.loads(body) if "json" in ctype
                  else body.decode()), hdrs


@pytest.fixture(scope="module")
def fronts(tmp_path_factory):
    """(reference base URL, port base URL, their servers, a snapshot file
    the reference wrote)."""
    Engine.init()
    jm = JLeNet5(10).build(jax.random.key(0))
    tm = load_reference_tree(LeNet5(10).build("cpu"), _np(jm.params),
                             _np(jm.state))
    jlmod = jlm.TransformerLM(**LM_CFG).build(jax.random.key(1))
    tlmod = load_reference_tree(TransformerLM(**LM_CFG).build("cpu"),
                                _np(jlmod.params), _np(jlmod.state))
    snap = str(tmp_path_factory.mktemp("snap") / "model.3")
    j2 = JLeNet5(10).build(jax.random.key(2))
    jio.save({"params": _np(j2.params), "state": _np(j2.state)}, snap)
    jserver = JServer(jm, example=EXAMPLE, max_batch=2, max_wait_ms=1)
    tserver = InferenceServer(tm, device="cpu", example=EXAMPLE,
                              max_batch=2, max_wait_ms=1)
    out = {}
    for name, sh, server, eng in (
            ("ref", jsh, jserver, JDecodeEngine(jlmod, slots=2, page=32)),
            ("port", tsh, tserver,
             DecodeEngine(tlmod, slots=2, page=32, device="cpu"))):
        server.start()
        server.decode_engine = eng.start()
        httpd = sh.serve_forever(server, "127.0.0.1", 0)
        out[name] = (f"http://127.0.0.1:{httpd.server_address[1]}", server,
                     httpd, eng)
    yield out, snap
    for base, server, httpd, eng in out.values():
        httpd.shutdown()
        eng.stop()
        server.stop()
    jmet.disarm()
    tmet.disarm()


def _both(fronts, path, obj=None, **kw):
    (out, _) = fronts
    return [_call(out[n][0], path, obj, **kw) for n in ("ref", "port")]


def _rows(n, seed=0):
    return np.random.default_rng(seed).random((n, 28, 28, 1)) \
        .astype(np.float32)


@pytest.mark.parametrize("batched", [False, True])
def test_predict_equal(fronts, batched):
    x = _rows(3, 1)
    inputs = x.tolist() if batched else x[0].tolist()
    (jc, jb, _), (tc, tb, _) = _both(fronts, "/v1/predict",
                                     {"inputs": inputs, "tenant": "a",
                                      "priority": 1})
    assert jc == tc == 200 and set(jb) == set(tb) == {
        "outputs", "version", "latency_ms"}
    assert jb["version"] == tb["version"] == 1
    np.testing.assert_allclose(np.asarray(tb["outputs"]),
                               np.asarray(jb["outputs"]), atol=REF_ATOL,
                               rtol=0)
    assert np.asarray(tb["outputs"]).shape == ((3, 10) if batched
                                               else (10,))


@pytest.mark.parametrize("prompt,n", [([3, 1, 4, 1, 5], 8), ([9], 12)])
def test_generate_equal(fronts, prompt, n):
    (jc, jb, _), (tc, tb, _) = _both(fronts, "/v1/generate",
                                     {"prompt": prompt, "max_tokens": n})
    assert jc == tc == 200
    assert set(jb) == set(tb) == {"tokens", "generated", "latency_ms"}
    assert tb["tokens"] == jb["tokens"] and tb["generated"] == n
    assert tb["tokens"][:len(prompt)] == prompt


@pytest.mark.parametrize("path,obj,raw,code", [
    ("/v1/predict", {"nope": 1}, None, 400),
    ("/v1/predict", None, b"{not json", 400),
    ("/v1/predict", {"inputs": [[1.0, 2.0]]}, None, 400),
    ("/v1/generate", {"max_tokens": 3}, None, 400),
    ("/v1/generate", {"prompt": [1], "max_tokens": 999}, None, 400),
    ("/v1/swap", {}, None, 400),
    ("/v1/swap", {"source": "/no/such/thing"}, None, 500),
    ("/v1/nope", {"a": 1}, None, 404),
    ("/nope", None, None, 404),
], ids=["no-inputs", "bad-json", "bad-shape", "no-prompt", "too-long",
        "no-source", "bad-source", "post-no-route", "get-no-route"])
def test_refusals_equal(fronts, path, obj, raw, code):
    (jc, jb, _), (tc, tb, _) = _both(fronts, path, obj, raw=raw)
    assert jc == tc == code, (jb, tb)
    assert set(jb) == set(tb)
    if "type" in tb:
        assert tb["type"] == jb["type"]


@pytest.mark.parametrize("path", ["/healthz", "/v1/versions", "/v1/stats"])
def test_get_routes_keys_equal(fronts, path):
    (jc, jb, _), (tc, tb, _) = _both(fronts, path)
    assert jc == tc == 200
    if path == "/v1/stats":
        assert set(tb) - set(jb) == PORT_ONLY_STATS
        assert set(jb) <= set(tb)
        assert set(tb["decode"]) - set(jb["decode"]) == {"graphs"}
    else:
        assert set(jb) == set(tb)
        assert jb == tb if path == "/v1/versions" else True


def test_metrics_parse(fronts):
    _both(fronts, "/v1/predict", {"inputs": _rows(1, 7)[0].tolist()})
    (jc, jtext, jh), (tc, ttext, th) = _both(fronts, "/metrics")
    assert jc == tc == 200
    assert th["Content-Type"] == tmet.CONTENT_TYPE == jh["Content-Type"]
    parsed = tmet.parse_exposition(ttext)
    assert parsed == jmet.parse_exposition(ttext)
    ok = [v for name, labels, v in
          parsed["bigdl_serve_requests_total"]["samples"]
          if ("status", "ok") in labels]
    assert ok and ok[0] >= 1
    assert "bigdl_decode_ttlt_seconds" in parsed
    assert set(parsed) <= set(jmet.parse_exposition(jtext)) | {
        "bigdl_serve_queue_depth"}


def test_swap_to_a_reference_snapshot(fronts):
    (out, snap) = fronts
    (jc, jb, _), (tc, tb, _) = _both(fronts, "/v1/swap", {"source": snap})
    # both count a version id for every swap tried, a failed one too
    assert jc == tc == 200 and jb == tb and jb["version"] >= 2
    vid = tb["version"]
    x = _rows(2, 3).tolist()
    (jc, jb, _), (tc, tb, _) = _both(fronts, "/v1/predict", {"inputs": x})
    assert jb["version"] == tb["version"] == vid
    np.testing.assert_allclose(np.asarray(tb["outputs"]),
                               np.asarray(jb["outputs"]), atol=REF_ATOL,
                               rtol=0)


def test_record_trace_header(fronts, tmp_path):
    (out, _) = fronts
    base = out["port"][0]
    path = str(tmp_path / "http.trace")
    x = _rows(3, 4)
    for row in x:
        code, _, _ = _call(base, "/v1/predict", {"inputs": row.tolist(),
                                                 "tenant": "t"},
                           headers={"X-BigDL-Record-Trace": path})
        assert code == 200
    code, _, _ = _call(base, "/v1/predict", {"inputs": x[0].tolist()},
                       headers={"X-BigDL-Record-Trace": "off"})
    assert code == 200
    header, events = jtf.read_trace(path)
    assert header["count"] == 3 and [e.tenant for e in events] == ["t"] * 3
    for e, row in zip(events, x):
        np.testing.assert_array_equal(e.payload, row)


def _small_front(sh, server):
    server.start()
    httpd = sh.serve_forever(server, "127.0.0.1", 0)
    return f"http://127.0.0.1:{httpd.server_address[1]}", httpd


def test_quota_429_and_unhealthy_503_alike():
    jm = JLeNet5(10).build(jax.random.key(0))
    tm = load_reference_tree(LeNet5(10).build("cpu"), _np(jm.params),
                             _np(jm.state))
    servers = {
        "ref": (jsh, JServer(jm, example=EXAMPLE, max_batch=1,
                             tenant_qps=0.001, tenant_burst=1),
                JReplicaLost),
        "port": (tsh, InferenceServer(tm, device="cpu", example=EXAMPLE,
                                      max_batch=1, tenant_qps=0.001,
                                      tenant_burst=1), ReplicaLostError)}
    seen = {}
    for name, (sh, server, lost) in servers.items():
        base, httpd = _small_front(sh, server)
        try:
            body = {"inputs": _rows(1, 5)[0].tolist(), "tenant": "a"}
            first = _call(base, "/v1/predict", body)[0]
            code, b, h = _call(base, "/v1/predict", body)
            server._mark_unhealthy(lost("drill: budget spent"))
            hcode, hb, hh = _call(base, "/healthz")
            seen[name] = (first, code, b["type"], set(b), "Retry-After" in h,
                          hcode, set(hb), hb["type"], "Retry-After" in hh)
        finally:
            httpd.shutdown()
            server.stop(drain=False)
    assert seen["ref"] == seen["port"]
    assert seen["port"][:3] == (200, 429, "QuotaExceeded")
    assert seen["port"][5] == 503


def test_serving_bench_tiny(capsys):
    out = serving_bench.main(["--d-model", "32", "--num-heads", "2",
                              "--num-layers", "1", "--vocab", "50",
                              "--max-len", "16", "--batch", "2",
                              "--num-tokens", "4", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out and line["device"] == "cpu"
    assert [r["path"] for r in out["results"]] == ["full_fwd", "kv_cache",
                                                   "kv_int8"]
    assert all(r["tokens_per_sec"] > 0 for r in out["results"])


def test_cli_routed_raises(tmp_path):
    """``--routed`` serves now: two gloo CPU ranks behind the router, one
    (1,1,1) member a rank; rank 0 binds HTTP and answers ``/v1/predict``
    equal to ``Predictor`` on the CLI's seeded LeNet-5, member 1 on rank 1
    warmed its ladder, and SIGTERM drains both ranks to exit 0."""
    from bigdl_torch.optim import Predictor
    env = {**os.environ, "PYTHONPATH": _REPO,
           "BIGDL_TORCH_COORDINATOR": f"file://{tmp_path}/store",
           "BIGDL_TORCH_NUM_PROCESSES": "2"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "bigdl_torch.tools.serve_http", "--model",
         "lenet", "--port", "0", "--routed", "--router-layout", "1,1,1",
         "--replicas", "2", "--device", "cpu"], cwd=_REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**env, "BIGDL_TORCH_PROCESS_ID": str(r)}) for r in range(2)]
    try:
        start = json.loads(procs[0].stdout.readline())
        base = start["serving"]
        assert start["routed"] == {"layout": [1, 1, 1], "replicas": 2,
                                   "world": 2}
        x = _rows(1, 7)[0]
        code, b, _ = _call(base, "/v1/predict", {"inputs": x.tolist()})
        model = tsh.build_model("lenet", "cpu")[0]
        want = Predictor(model, device="cpu").predict(x[None])[0]
        assert code == 200 and b["version"] == 1
        np.testing.assert_array_equal(np.float32(b["outputs"]), want)
        code, st, _ = _call(base, "/v1/stats")
        members = st["router"]["members"]
        assert [m["devices"] for m in members.values()] == [[0], [1]]
        assert members["1"]["messages"] == {"activate": 1, "batch": 4}
    finally:
        procs[0].send_signal(signal.SIGTERM)
        outs = [p.communicate(timeout=60) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    lines = [json.loads(line) for line in outs[0][0].strip().splitlines()]
    assert lines[0] == {"stopping": "SIGTERM", "drain": True}
    assert lines[-1]["stopped"] and lines[-1]["stats"]["batches"] == 1


def test_cli_answers_then_drains_on_sigterm(tmp_path):
    import torch
    module = str(tmp_path / "lenet.module")
    LeNet5(10).build("cpu", torch.Generator().manual_seed(3)).save(module)
    proc = subprocess.Popen(
        [sys.executable, "-m", "bigdl_torch.tools.serve_http", "--model",
         "lenet", "--port", "0", "--generate", "--gen-max-len", "64",
         "--device", "cpu"], cwd=_REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": _REPO})
    try:
        start = json.loads(proc.stdout.readline())
        base = start["serving"]
        assert start["generate"] and start["version"] == 1
        code, b, _ = _call(base, "/v1/predict",
                           {"inputs": _rows(1, 6)[0].tolist()})
        assert code == 200 and len(b["outputs"]) == 10
        code, b, _ = _call(base, "/v1/generate",
                           {"prompt": [1, 2, 3], "max_tokens": 5})
        assert code == 200 and b["generated"] == 5
        code, b, _ = _call(base, "/v1/swap", {"source": module})
        assert code == 200 and b == {"version": 2}
        code, b, _ = _call(base, "/healthz")
        assert code == 200 and b["version"] == 2
    finally:
        proc.send_signal(signal.SIGTERM)
        rest, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err[-2000:]
    lines = [json.loads(line) for line in rest.strip().splitlines()]
    assert lines[0] == {"stopping": "SIGTERM", "drain": True}
    assert lines[-1]["stopped"] and lines[-1]["stats"]["swaps"] == 1

