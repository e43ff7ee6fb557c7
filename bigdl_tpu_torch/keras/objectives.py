"""Loss-name → Criterion mapping — the port of
``bigdl_tpu/keras/objectives.py`` (ref: python keras objectives)."""

from __future__ import annotations

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.nn.module import Criterion

_LOSSES = {
    "categorical_crossentropy": nn.CategoricalCrossEntropy,
    "sparse_categorical_crossentropy":
        lambda: nn.ClassNLLCriterion(logProbAsInput=False,
                                     zero_based_label=True),
    "class_nll": nn.ClassNLLCriterion,
    "binary_crossentropy": nn.BCECriterion,
    "mse": nn.MSECriterion,
    "mean_squared_error": nn.MSECriterion,
    "mae": nn.AbsCriterion,
    "mean_absolute_error": nn.AbsCriterion,
    "mean_absolute_percentage_error": nn.MeanAbsolutePercentageCriterion,
    "mape": nn.MeanAbsolutePercentageCriterion,
    "mean_squared_logarithmic_error": nn.MeanSquaredLogarithmicCriterion,
    "msle": nn.MeanSquaredLogarithmicCriterion,
    "hinge": nn.MarginCriterion,
    "squared_hinge": lambda: nn.MarginCriterion(squared=True),
    "kullback_leibler_divergence": nn.KullbackLeiblerDivergenceCriterion,
    "kld": nn.KullbackLeiblerDivergenceCriterion,
    "poisson": nn.PoissonCriterion,
    "cosine_proximity": nn.CosineProximityCriterion,
}


def to_criterion(loss) -> Criterion:
    if isinstance(loss, Criterion):
        return loss
    if callable(loss) and not isinstance(loss, str):
        return loss()
    key = str(loss).lower()
    if key not in _LOSSES:
        raise ValueError(f"unknown loss {loss!r}; known: {sorted(_LOSSES)}")
    return _LOSSES[key]()
