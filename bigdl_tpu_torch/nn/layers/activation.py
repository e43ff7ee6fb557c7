"""Activation layers — the port of ``GELU`` and ``Tanh`` in
``bigdl_tpu/nn/layers/activation.py`` (ref: .../nn/Tanh.scala, ...)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import TensorModule


class Tanh(TensorModule):
    def forward(self, x):
        return torch.tanh(x)


class GELU(TensorModule):
    """``approximate=True`` (the JAX layer's default, ``activation.py:77``)
    is the tanh form; ``False`` is the exact erf form, which the encoder
    layer asks for (HF BERT semantics)."""

    def __init__(self, approximate: bool = True, name: Optional[str] = None):
        super().__init__(name)
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, approximate="tanh" if self.approximate else "none")
