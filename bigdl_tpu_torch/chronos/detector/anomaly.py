"""Anomaly detectors — the port of ``bigdl_tpu/chronos/detector/anomaly.py``
(ref: P:chronos/detector/anomaly — ThresholdDetector, AEDetector,
DBScanDetector).

``ThresholdDetector`` and ``DBScanDetector`` are the JAX package's numpy
and sklearn code (sklearn imported when ``DBScanDetector`` runs).
``AEDetector`` trains its autoencoder on ``device`` (``None``: the GPU)
with full-batch Adam and no dropout, so it is deterministic; the window
scores, the per-point max and the quantile threshold are the JAX
package's numpy.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class ThresholdDetector:
    """ref: ThresholdDetector — absolute bounds or pattern-drift threshold
    between actual and forecast; fit() can estimate bounds from a normal
    sample via a ratio-of-outliers target."""

    def __init__(self):
        self.th: Tuple[float, float] = (-np.inf, np.inf)
        self.ratio = 0.01

    def set_params(self, threshold: Optional[Tuple[float, float]] = None,
                   ratio: Optional[float] = None):
        if threshold is not None:
            self.th = threshold
        if ratio is not None:
            self.ratio = ratio
        return self

    def fit(self, y: np.ndarray, y_pred: Optional[np.ndarray] = None):
        """Estimate the residual threshold from normal data."""
        resid = np.abs(y - y_pred) if y_pred is not None else np.asarray(y)
        hi = float(np.quantile(resid, 1 - self.ratio))
        self.th = (-np.inf, hi)
        return self

    def score(self, y: np.ndarray,
              y_pred: Optional[np.ndarray] = None) -> np.ndarray:
        v = np.abs(y - y_pred) if y_pred is not None else np.asarray(y)
        return v.astype(np.float64)

    def anomaly_indexes(self, y: np.ndarray,
                        y_pred: Optional[np.ndarray] = None) -> np.ndarray:
        s = self.score(y, y_pred)
        lo, hi = self.th
        return np.where((s < lo) | (s > hi))[0]


class AEDetector:
    """ref: AEDetector — autoencoder reconstruction error over rolled
    windows; anomaly = error above the (1-ratio) quantile. ``fit``'s
    ``init_params`` (a parameter tree, e.g. the JAX model's) replaces
    the seeded initial weights."""

    def __init__(self, roll_len: int = 24, ratio: float = 0.1,
                 hidden: int = 16, epochs: int = 30, lr: float = 1e-2,
                 seed: int = 0, device=None):
        from bigdl_tpu_torch.device import resolve_device

        self.roll_len = roll_len
        self.ratio = ratio
        self.hidden = hidden
        self.epochs = epochs
        self.lr = lr
        self.seed = seed
        self.device = resolve_device(device)
        self._model = None
        self._th = None

    def _windows(self, y: np.ndarray) -> np.ndarray:
        """The series' rolled windows (n, roll_len): a strided view."""
        y = np.asarray(y, np.float32).reshape(-1)
        n = len(y) - self.roll_len + 1
        if n <= 0:
            raise ValueError("series shorter than roll_len")
        return np.lib.stride_tricks.sliding_window_view(y, self.roll_len)

    def fit(self, y: np.ndarray, init_params=None):
        import torch

        import bigdl_tpu_torch.nn as nn
        from bigdl_tpu_torch.chronos.forecaster.base import apply_update
        from bigdl_tpu_torch.optim.optim_method import Adam

        nn.set_seed(self.seed)
        model = (nn.Sequential()
                 .add(nn.Linear(self.roll_len, self.hidden))
                 .add(nn.Tanh())
                 .add(nn.Linear(self.hidden, self.roll_len)))
        if init_params is not None:
            model.load_parameters_dict(init_params)
        model = model.to(self.device).train()
        xb = torch.from_numpy(np.require(self._windows(y), np.float32, ("C", "W"))).to(
            self.device)
        optim = Adam(learning_rate=self.lr)
        params = list(model.parameters())
        opt_state = optim.init_state(params)
        for _ in range(self.epochs):
            loss = torch.mean((model(xb) - xb) ** 2)
            opt_state = apply_update(optim, self.lr, params,
                                     torch.autograd.grad(loss, params),
                                     opt_state)
        self._model = model
        scores = self.score(y)
        self._th = float(np.quantile(scores, 1 - self.ratio))
        return self

    def score(self, y: np.ndarray) -> np.ndarray:
        import torch

        from bigdl_tpu_torch.nn.module import to_numpy

        if self._model is None:
            raise RuntimeError("fit() first")
        w = self._windows(y)
        with torch.no_grad():
            recon = to_numpy(self._model.evaluate()(torch.from_numpy(
                np.require(w, np.float32, ("C", "W"))).to(self.device)))
        err = ((recon - w) ** 2).mean(axis=1)
        # per-sample score: max window error covering the point
        scores = np.zeros(len(np.asarray(y).reshape(-1)))
        counts = np.zeros_like(scores)
        for i, e in enumerate(err):
            scores[i:i + self.roll_len] = np.maximum(
                scores[i:i + self.roll_len], e)
            counts[i:i + self.roll_len] += 1
        return scores

    def anomaly_indexes(self, y: np.ndarray) -> np.ndarray:
        s = self.score(y)
        return np.where(s > self._th)[0]


class DBScanDetector:
    """ref: DBScanDetector — sklearn DBSCAN over the series values;
    anomalies = points labeled as noise."""

    def __init__(self, eps: float = 0.5, min_samples: int = 5):
        self.eps = eps
        self.min_samples = min_samples

    def anomaly_indexes(self, y: np.ndarray) -> np.ndarray:
        from sklearn.cluster import DBSCAN

        y = np.asarray(y, np.float64).reshape(-1, 1)
        labels = DBSCAN(eps=self.eps,
                        min_samples=self.min_samples).fit_predict(y)
        return np.where(labels == -1)[0]
