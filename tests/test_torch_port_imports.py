"""The PyTorch port stands alone: importing ``bigdl_torch`` loads neither
JAX nor the JAX package, no file of the port (or ``chip_smoke.py``)
imports either, and entry points refuse to fall back to the CPU when no
device is named and no CUDA device exists."""

import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import bigdl_torch
from bigdl_torch.dataset import Sample
from bigdl_torch.models import TransformerLM
from bigdl_torch.nn import CrossEntropyCriterion, Linear
from bigdl_torch.optim import Optimizer, Predictor, Trigger
from bigdl_torch.serve import InferenceServer

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    root = os.path.join(_REPO, "bigdl_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
             if f.endswith(".py")]
    return sorted(files) + [os.path.join(_REPO, "chip_smoke.py")]


def test_import_loads_no_jax():
    names = [m.name for m in pkgutil.walk_packages(
        bigdl_torch.__path__, "bigdl_torch.")]
    assert {"bigdl_torch.serve.server", "bigdl_torch.serve.decode",
            "bigdl_torch.serve.control", "bigdl_torch.models.decode",
            "bigdl_torch.ops.decode_attention"} <= set(names)
    code = ("import importlib, sys\n"
            f"for n in {['bigdl_torch'] + names!r}:\n"
            "    importlib.import_module(n)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'bigdl_tpu'))\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                          env={**os.environ, "PYTHONPATH": _REPO},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, _REPO))
def test_no_jax_import_in_source(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            assert m.split(".")[0] not in ("jax", "jaxlib", "bigdl_tpu"), \
                f"{path}:{node.lineno} imports {m}"


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Linear(4, 3).build()
    model = TransformerLM(17, max_len=8, d_model=8, num_heads=2,
                          num_layers=1).build("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceServer(model, example=np.zeros((4,), np.int64))
    # naming the CPU is the way to run on the host
    server = InferenceServer(model, device="cpu")
    assert server.device == torch.device("cpu")
    # a built model is never moved behind the caller's back
    with pytest.raises(ValueError, match="lives on cpu"):
        Predictor(model, device="meta")
    # the training entry point: Optimizer
    samples = [Sample.from_ndarray(np.full((4,), i, np.float32),
                                   np.int32(i % 3)) for i in range(4)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Optimizer(Linear(4, 3), samples, CrossEntropyCriterion(),
                  batch_size=2)
    opt = Optimizer(Linear(4, 3), samples, CrossEntropyCriterion(),
                    batch_size=2, device="cpu")
    trained = opt.set_end_when(Trigger.max_iteration(3)).optimize()
    assert opt.optim_method.hyper["neval"] == 4
    assert opt.optim_method.hyper["epoch"] == 3
    assert trained.weight.device == torch.device("cpu")
    with pytest.raises(ValueError, match="lives on cpu"):
        Optimizer(trained, samples, CrossEntropyCriterion(), batch_size=2,
                  device="meta").optimize()
