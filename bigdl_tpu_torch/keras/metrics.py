"""Metric-name → ValidationMethod mapping — the port of
``bigdl_tpu/keras/metrics.py`` (ref: python keras metrics).

Keras labels are zero-based; the BigDL-core Top-k methods default to
1-based, so the keras mapping constructs them zero-based."""

from __future__ import annotations

from bigdl_tpu_torch.optim import validation as V


def to_validation_methods(metrics) -> list:
    out = []
    for m in metrics:
        if isinstance(m, V.ValidationMethod):
            out.append(m)
            continue
        key = str(m).lower()
        if key in ("accuracy", "acc", "top1accuracy"):
            out.append(V.Top1Accuracy(zero_based_label=True))
        elif key in ("top5", "top5accuracy"):
            out.append(V.Top5Accuracy(zero_based_label=True))
        elif key in ("mae",):
            out.append(V.MAE())
        else:
            raise ValueError(f"unknown metric {m!r}")
    return out
