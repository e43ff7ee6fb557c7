"""Forecast metrics — a copy of ``bigdl_tpu/chronos/metric.py`` (ref:
P:chronos/metric/forecast_metrics.py)."""

from __future__ import annotations

import numpy as np


def mse(y_true, y_pred):
    return float(np.mean((np.asarray(y_true) - np.asarray(y_pred)) ** 2))


def rmse(y_true, y_pred):
    return float(np.sqrt(mse(y_true, y_pred)))


def mae(y_true, y_pred):
    return float(np.mean(np.abs(np.asarray(y_true) - np.asarray(y_pred))))


def smape(y_true, y_pred):
    t, p = np.asarray(y_true), np.asarray(y_pred)
    denom = (np.abs(t) + np.abs(p)) / 2 + 1e-8
    return float(np.mean(np.abs(t - p) / denom) * 100)


def r2(y_true, y_pred):
    t, p = np.asarray(y_true), np.asarray(y_pred)
    ss_res = np.sum((t - p) ** 2)
    ss_tot = np.sum((t - t.mean()) ** 2) + 1e-12
    return float(1.0 - ss_res / ss_tot)


METRICS = {"mse": mse, "rmse": rmse, "mae": mae, "smape": smape, "r2": r2}


def evaluate(y_true, y_pred, metrics):
    out = []
    for m in metrics:
        fn = METRICS.get(m) if isinstance(m, str) else m
        if fn is None:
            raise ValueError(f"unknown metric {m!r}")
        out.append(fn(y_true, y_pred))
    return out
