"""Dropout and noise layers — the port of ``bigdl_tpu/nn/layers/
dropout.py`` (ref: .../nn/Dropout.scala, SpatialDropout2D.scala,
GaussianDropout.scala, GaussianNoise.scala): the identity in eval mode.

In train mode each draw comes from the layer's own ``torch.Generator``
(:class:`~bigdl_tpu_torch.nn.module.Stochastic`): the one given, or one
made at first use and seeded from the layer's name. The bits differ
from ``jax.random``'s; what holds in both packages is the contract —
the keep rate, the ``1 / keep`` scaling, the same mask in ``forward``
and ``backward``.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.module import Stochastic, TensorModule


class Dropout(Stochastic, TensorModule):
    """ref: nn/Dropout.scala — inverted dropout (scale at train time)."""

    def __init__(self, init_p: float = 0.5, scale: bool = True,
                 generator: Optional[torch.Generator] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.p = init_p
        self.scale = scale
        self.generator = generator

    def forward(self, x):
        if not self.training or self.p <= 0.0:
            return x
        keep = 1.0 - self.p
        y = torch.where(self._rand(x.shape, x) < keep, x,
                        torch.zeros_like(x))
        return y / keep if self.scale else y


class SpatialDropout2D(Stochastic, TensorModule):
    """Drops whole feature maps (ref: nn/SpatialDropout2D.scala)."""

    def __init__(self, init_p: float = 0.5, format: str = "NCHW",
                 generator: Optional[torch.Generator] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.p = init_p
        self.format = format
        self.generator = generator

    def forward(self, x):
        if not self.training or self.p <= 0.0:
            return x
        keep = 1.0 - self.p
        shape = (x.shape[0], x.shape[1], 1, 1) if self.format == "NCHW" \
            else (x.shape[0], 1, 1, x.shape[3])
        return torch.where(self._rand(shape, x) < keep, x / keep,
                           torch.zeros_like(x))


class GaussianDropout(Stochastic, TensorModule):
    """Multiplicative 1-mean gaussian noise (ref: nn/GaussianDropout.scala)."""

    def __init__(self, rate: float,
                 generator: Optional[torch.Generator] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.rate = rate
        self.generator = generator

    def forward(self, x):
        if not self.training:
            return x
        stddev = (self.rate / (1.0 - self.rate)) ** 0.5
        return x * (1.0 + stddev * self._rand(x.shape, x, normal=True)
                    .to(x.dtype))


class GaussianNoise(Stochastic, TensorModule):
    """Additive gaussian noise (ref: nn/GaussianNoise.scala)."""

    def __init__(self, stddev: float,
                 generator: Optional[torch.Generator] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.stddev = stddev
        self.generator = generator

    def forward(self, x):
        if not self.training:
            return x
        return x + self.stddev * self._rand(x.shape, x, normal=True).to(
            x.dtype)
