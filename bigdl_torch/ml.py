"""ML-pipeline estimators: fit/transform adapters over the Optimizer.

Counterpart of ``bigdl_tpu/ml.py`` (reference
``org/apache/spark/ml/DLEstimator.scala:53`` and ``DLClassifier.scala``:
Spark ML estimators that train a module from a DataFrame and return a
``DLModel`` whose ``transform`` appends a prediction column).  The API is
scikit-learn's fit/predict over numpy arrays or DataFrame-like objects
(anything with ``columns`` and ``[name]``: duck typed, pandas is never
imported); training is the port's ``Optimizer`` and prediction its eval
forward, on the CUDA device unless ``device="cpu"`` is given.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .dataset import DataSet, Sample, SampleToMiniBatch
from .nn.criterion import Criterion
from .nn.module import Module
from .optim.method import OptimMethod
from .optim.optimizer import Optimizer
from .optim.trigger import Trigger

__all__ = ["DLEstimator", "DLModel", "DLClassifier", "DLClassifierModel"]


def _as_2d(X) -> np.ndarray:
    X = np.asarray(X, dtype=np.float32)
    return X


def _extract_columns(data, y, features_col, label_col):
    """Resolve (X, y) from either arrays or a DataFrame-like with named
    columns — the reference's featuresCol/labelCol contract
    (DLEstimator.scala:53-109: DataFrame rows -> feature/label tensors)."""
    if hasattr(data, "columns"):  # pandas DataFrame (or anything alike)
        if features_col is None:
            cols = [c for c in data.columns if c != label_col]
        elif isinstance(features_col, str):
            cols = [features_col]
        else:
            cols = list(features_col)
        X = np.stack([np.stack(np.asarray(data[c], dtype=object)
                               ).astype(np.float32)
                      if data[c].dtype == object
                      else np.asarray(data[c], np.float32) for c in cols],
                     axis=-1)
        if X.shape[-1] == 1 and X.ndim > 2:
            X = X[..., 0]
        if y is None and label_col is not None and label_col in data.columns:
            y = np.asarray(data[label_col], np.float32)
        return X, y
    return _as_2d(data), y


class DLEstimator:
    """(reference: DLEstimator.scala:53).  Configure like the Optimizer
    facade, then `fit(X, y)` / `fit(df)` -> DLModel.

    DataFrame column semantics mirror the reference: `features_col` (one
    column of array cells or a list of scalar columns) and `label_col`
    select the training data; the fitted model's `transform(df)` returns a
    copy with `prediction_col` appended.  Validation data + an early-
    stopping patience play the role the reference delegates to
    setValidation/Plateau (optim/Optimizer.scala:98, SGD.scala:534)."""

    def __init__(self, model: Module, criterion: Criterion,
                 feature_size: Optional[Sequence[int]] = None,
                 label_size: Optional[Sequence[int]] = None,
                 batch_size: int = 32, max_epoch: int = 10,
                 optim_method: Optional[OptimMethod] = None,
                 features_col=None, label_col: str = "label",
                 prediction_col: str = "prediction",
                 validation_data=None, early_stopping_patience: int = 0,
                 device=None):
        self.model = model
        self.device = device
        self.criterion = criterion
        self.feature_size = tuple(feature_size) if feature_size else None
        self.label_size = tuple(label_size) if label_size else None
        self.batch_size = batch_size
        self.max_epoch = max_epoch
        self.optim_method = optim_method
        self.features_col = features_col
        self.label_col = label_col
        self.prediction_col = prediction_col
        self.validation_data = validation_data  # (X_val, y_val) or None
        self.early_stopping_patience = early_stopping_patience

    def set_validation(self, X_val, y_val,
                       early_stopping_patience: int = 0) -> "DLEstimator":
        self.validation_data = (X_val, y_val)
        if early_stopping_patience:
            self.early_stopping_patience = early_stopping_patience
        return self

    def _samples(self, X, y):
        X = np.asarray(X, np.float32)
        y = np.asarray(y, np.float32)
        samples = []
        for i in range(len(X)):
            f = X[i].reshape(self.feature_size) if self.feature_size else X[i]
            lbl = (y[i].reshape(self.label_size) if self.label_size
                   else y[i])
            samples.append(Sample(f, lbl))
        return samples

    def fit(self, X, y=None) -> "DLModel":
        from .optim.validation import Loss
        X, y = _extract_columns(X, y, self.features_col, self.label_col)
        if y is None:
            raise ValueError(
                f"no labels: pass y or a DataFrame with a "
                f"'{self.label_col}' column")
        # pad_last: the trailing partial batch is padded to full size, as
        # the reference pads it
        ds = DataSet.array(self._samples(X, y)).transform(
            SampleToMiniBatch(self.batch_size, pad_last=True))
        end = Trigger.max_epoch(self.max_epoch)
        opt = Optimizer(self.model, ds, self.criterion, device=self.device)
        if self.validation_data is not None:
            Xv, yv = self.validation_data
            Xv, yv = _extract_columns(Xv, yv, self.features_col,
                                      self.label_col)
            vds = DataSet.array(self._samples(Xv, yv)).transform(
                SampleToMiniBatch(self.batch_size, pad_last=True))
            opt.set_validation(Trigger.every_epoch(), vds,
                               [Loss(self.criterion)])
            if self.early_stopping_patience:
                end = Trigger.or_(end, Trigger.plateau(
                    "val_loss", patience=self.early_stopping_patience))
        opt.set_end_when(end)
        if self.optim_method is not None:
            opt.set_optim_method(self.optim_method)
        trained = opt.optimize()
        self.optimizer_ = opt  # post-fit introspection (epochs run, state)
        return self._make_model(trained)

    def _make_model(self, trained: Module) -> "DLModel":
        return DLModel(trained, self.feature_size,
                       batch_size=self.batch_size,
                       features_col=self.features_col,
                       label_col=self.label_col,
                       prediction_col=self.prediction_col,
                       device=self.device)


class DLModel:
    """Fitted transformer (reference: DLModel/DLTransformerBase)."""

    def __init__(self, model: Module, feature_size=None, batch_size=128,
                 features_col=None, label_col: str = "label",
                 prediction_col: str = "prediction", device=None):
        self.model = model
        self.feature_size = tuple(feature_size) if feature_size else None
        self.batch_size = batch_size
        self.features_col = features_col
        self.label_col = label_col
        self.prediction_col = prediction_col
        self.device = device
        self._fwd = None

    def _forward_batch(self, xb: np.ndarray) -> np.ndarray:
        from .optim.optimizer import _Forward, to_host
        if self._fwd is None:
            # the eval forward Predictor and Evaluator use
            self._fwd = _Forward(self.model, self.device)
        out, n = self._fwd(np.asarray(xb, np.float32))
        if isinstance(out, (list, tuple)):
            return [to_host(t[:n]) for t in out]
        return to_host(out[:n])

    def _raw_outputs(self, X) -> np.ndarray:
        X = np.asarray(X, np.float32)
        outs = []
        for i in range(0, len(X), self.batch_size):
            xb = X[i:i + self.batch_size]
            if self.feature_size:
                xb = xb.reshape((-1,) + self.feature_size)
            outs.append(self._forward_batch(xb))
        return np.concatenate(outs, axis=0)

    def transform(self, X):
        """Array in -> raw outputs row-aligned with X.  DataFrame in -> a
        COPY with `prediction_col` appended (the reference's
        DLModel.transform contract, DLEstimator.scala)."""
        if hasattr(X, "columns"):
            feats, _ = _extract_columns(X, None, self.features_col,
                                        self.label_col)
            out = self._raw_outputs(feats)
            df = X.copy()
            df[self.prediction_col] = (list(out) if out.ndim > 1
                                       else out)
            return df
        return self._raw_outputs(X)

    def predict(self, X) -> np.ndarray:
        if hasattr(X, "columns"):
            X, _ = _extract_columns(X, None, self.features_col,
                                    self.label_col)
        return self._raw_outputs(X)


class DLClassifier(DLEstimator):
    """(reference: DLClassifier.scala — argmax transform)."""

    def _make_model(self, trained: Module) -> "DLClassifierModel":
        return DLClassifierModel(trained, self.feature_size,
                                 batch_size=self.batch_size,
                                 features_col=self.features_col,
                                 label_col=self.label_col,
                                 prediction_col=self.prediction_col,
                                 device=self.device)


class DLClassifierModel(DLModel):
    def predict(self, X) -> np.ndarray:
        """Class indices (0-based; the reference emitted 1-based ml labels)."""
        if hasattr(X, "columns"):
            X, _ = _extract_columns(X, None, self.features_col,
                                    self.label_col)
        return np.argmax(self._raw_outputs(X), axis=-1)

    def transform(self, X):
        """DataFrame in -> copy with argmax class in `prediction_col`;
        array in -> raw outputs (DLModel behavior)."""
        if hasattr(X, "columns"):
            df = X.copy()
            df[self.prediction_col] = self.predict(X)
            return df
        return self._raw_outputs(X)

    def score(self, X, y=None) -> float:
        if hasattr(X, "columns"):
            X, y = _extract_columns(X, y, self.features_col, self.label_col)
        if y is None:
            raise ValueError(
                f"no labels: pass y or a DataFrame with a "
                f"'{self.label_col}' column")
        return float(np.mean(self.predict(X) == np.asarray(y)))
