"""MNIST autoencoder — the port of ``bigdl_tpu/models/autoencoder.py``
(ref: .../dllib/models/autoencoder/Autoencoder.scala: a 784 → 32 → 784
MLP with a sigmoid reconstruction, trained with MSE)."""

from __future__ import annotations

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.device import resolve_device


def build_model(class_num: int = 32, device=None) -> nn.Sequential:
    """``class_num`` is the bottleneck width (the reference's name), on
    ``device`` (``None``: the GPU)."""
    return (nn.Sequential()
            .add(nn.Reshape([28 * 28]))
            .add(nn.Linear(28 * 28, class_num))
            .add(nn.ReLU())
            .add(nn.Linear(class_num, 28 * 28))
            .add(nn.Sigmoid())).to(resolve_device(device))
