"""Model serving as DataFrame-style UDFs.

Counterpart of ``bigdl_tpu/serving.py`` (reference
``example/udfpredictor/``: ``DataframePredictor.scala`` registers a
trained text classifier as a Spark SQL UDF, ``Utils.scala`` holds the
text preprocessing).  :class:`UDFPredictor` wraps a trained Module as a
vectorized callable, rows in and predictions out, batched through the
port's ``Predictor`` on the card (or the host with ``device="cpu"``), so
it drops into a ``df[udf(df["text"]) == k]`` filter or any row-wise loop.
A DataFrame column is read by duck typing (``to_numpy``); nothing here
imports pandas.  :class:`TextClassifierUDF` packages the reference
example's text pipeline (tokenize, dictionary lookup, pad or crop,
embed).  Batches are cut and padded by ``serve.batcher.
predict_in_fixed_batches``, the online batcher's rule.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from .nn.module import Module
from .optim.optimizer import Predictor
from .serve.batcher import predict_in_fixed_batches

__all__ = ["UDFPredictor", "TextClassifierUDF"]


class UDFPredictor:
    """Vectorized predict-UDF over rows (DataframePredictor.scala role).

    preprocess: row -> feature ndarray (applied per row, host-side).
    postprocess: model outputs (N, ...) -> predictions (N,); defaults to
      argmax over the last axis (the reference UDF returns the class id).
    device: where the model runs (default the CUDA device).
    """

    def __init__(self, model: Module, preprocess: Optional[Callable] = None,
                 postprocess: Optional[Callable] = None,
                 batch_size: int = 128, device=None):
        self.model = model
        self.preprocess = preprocess
        self.postprocess = postprocess or (
            lambda out: np.argmax(out, axis=-1))
        self._predictor = Predictor(model, batch_size=batch_size,
                                    device=device)
        self._out_spec = None  # (trailing shape, dtype) of real outputs

    def __call__(self, rows) -> np.ndarray:
        if hasattr(rows, "to_numpy"):  # pandas Series
            rows = rows.to_numpy()
        if len(rows) == 0:
            # an empty filter: the postprocess's own empty answer, from a
            # zero-row output of the shape the last call saw (a guess
            # before any call, so a postprocess that fails on it gives a
            # plain empty array)
            shape, dtype = self._out_spec or ((1,), np.float32)
            try:
                return np.asarray(
                    self.postprocess(np.empty((0,) + shape, dtype)))
            except Exception:  # noqa: BLE001 - the probe shape was a guess
                return np.empty((0,), np.float32)
        feats = (np.stack([np.asarray(self.preprocess(r), np.float32)
                           for r in rows])
                 if self.preprocess is not None
                 else np.asarray(rows, np.float32))
        # full batches, the last padded: the online batcher's rule
        outs = predict_in_fixed_batches(self._predictor.predict, feats,
                                        self._predictor.batch_size)
        self._out_spec = (outs.shape[1:], outs.dtype)
        return self.postprocess(outs)

    def register(self, namespace: dict, name: str) -> "UDFPredictor":
        """Install the UDF under `name` in any dict (Spark's
        ``udf.register``; ``globals()`` or a query engine's registry)."""
        namespace[name] = self
        return self


class TextClassifierUDF(UDFPredictor):
    """The reference example end-to-end: raw text -> class id
    (example/udfpredictor/Utils.scala getTextClassifierUDF).

    dictionary: dataset.text.Dictionary (word -> index, 0-based).
    embeddings: (>= vocab+1, embed_dim) lookup table; the LAST row is the
      padding row (conventionally zeros) — Dictionary assigns index 0 to a
      real word, so padding must not alias it.
    seq_len: fixed token length (pad/crop), one batch shape throughout.
    """

    def __init__(self, model: Module, dictionary, embeddings: np.ndarray,
                 seq_len: int = 500, batch_size: int = 128,
                 tokenizer: Optional[Callable] = None,
                 pad_index: Optional[int] = None, device=None):
        self.dictionary = dictionary
        self.embeddings = np.asarray(embeddings, np.float32)
        self.seq_len = seq_len
        self.tokenizer = tokenizer or (lambda s: s.lower().split())
        self.pad_index = (len(self.embeddings) - 1 if pad_index is None
                          else pad_index)
        super().__init__(model, preprocess=self._embed,
                         batch_size=batch_size, device=device)

    def embed(self, text: str) -> np.ndarray:
        """Text -> embedded features: the transform the UDF applies, for
        training pipelines to share (example/udfpredictor's Utils role)."""
        return self._embed(text)

    def _embed(self, text: str) -> np.ndarray:
        toks = self.tokenizer(str(text))[:self.seq_len]
        idx = np.full((self.seq_len,), self.pad_index, np.int64)
        for i, t in enumerate(toks):
            j = self.dictionary.get_index(t)
            if not 0 <= j < len(self.embeddings):
                raise IndexError(
                    f"dictionary index {j} for {t!r} outside the embedding "
                    f"table ({len(self.embeddings)} rows)")
            idx[i] = j
        return self.embeddings[idx]
