"""Optimizer-name → OptimMethod mapping — the port of
``bigdl_tpu/keras/optimizers.py`` (ref: python keras optimizers)."""

from __future__ import annotations

from bigdl_tpu_torch.optim import optim_method as om


_OPTIMIZERS = {
    "sgd": lambda: om.SGD(learning_rate=0.01),
    "adam": lambda: om.Adam(),
    "adamax": lambda: om.Adamax(),
    "rmsprop": lambda: om.RMSprop(),
    "adagrad": lambda: om.Adagrad(),
    "adadelta": lambda: om.Adadelta(),
}


def to_optim_method(optimizer) -> om.OptimMethod:
    if isinstance(optimizer, om.OptimMethod):
        return optimizer
    key = str(optimizer).lower()
    if key not in _OPTIMIZERS:
        raise ValueError(f"unknown optimizer {optimizer!r}; "
                         f"known: {sorted(_OPTIMIZERS)}")
    return _OPTIMIZERS[key]()
