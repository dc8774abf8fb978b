"""Bulk inference: the single-device forward engine and ``Predictor``.

Counterpart of the inference half of ``bigdl_tpu/optim/optimizer.py``
(``_ShardedForward``, ``Predictor``).  The reference pads a batch to the
mesh's data-axis multiple and runs one SPMD program; on one device there
is nothing to pad, so the engine moves the batch to the device and runs
the eval forward under ``torch.inference_mode()``.  The Optimizer, the
Evaluator and the DataSet route of ``Predictor.predict`` come with the
training and data slices.
"""

from __future__ import annotations

import numpy as np
import torch

from ..common import resolve_device
from ..nn.module import Module

__all__ = ["Predictor", "to_host"]


def to_host(t: torch.Tensor) -> np.ndarray:
    """A device tensor as a numpy array.  numpy has no bfloat16, so a
    bfloat16 tensor widens to float32 first; that widening is exact."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


class _Forward:
    """The eval forward that ``Predictor`` and the serving replicas share:
    online answers are the same arithmetic as bulk prediction.  Builds the
    model on ``device`` if it has no weights yet; a built model must
    already live there (it is never moved behind the caller's back)."""

    def __init__(self, model: Module, device=None):
        self.device = resolve_device(device)
        if not model.built:
            model.build(self.device)
        for p in model.parameters():
            if p.device != self.device:
                raise ValueError(f"the model lives on {p.device}, the "
                                 f"engine runs on {self.device}: move it "
                                 f"with model.to({str(self.device)!r})")
            break
        self.model = model

    def __call__(self, inp):
        """Forward one host batch; returns (device output, row count)."""
        x = torch.as_tensor(np.asarray(inp)).to(self.device)
        self.model.eval()
        with torch.inference_mode():
            out = self.model(x)
        return out, x.shape[0]


class Predictor:
    """Bulk prediction over an array of samples (reference:
    optim/Predictor.scala:34), in chunks of ``batch_size`` rows."""

    def __init__(self, model: Module, batch_size: int = 128, device=None):
        self.model = model
        self.batch_size = batch_size
        self._engine = _Forward(model, device)

    def predict(self, x) -> np.ndarray:
        x = np.asarray(x)
        outs = []
        for i in range(0, len(x), self.batch_size):
            out, _ = self._engine(x[i:i + self.batch_size])
            outs.append(to_host(out))
        return np.concatenate(outs, axis=0)
