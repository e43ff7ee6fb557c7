"""Dropout — the port of ``Dropout`` in ``bigdl_tpu/nn/layers/dropout.py``
(ref: .../nn/Dropout.scala): inverted dropout, the identity in eval mode.

In train mode the keep-mask comes from an explicit ``torch.Generator``:
the one given, or else one made at first use and seeded from the
module's name (as the JAX package folds the scope name into its key).
The bits differ from ``jax.random.bernoulli``'s.
"""

from __future__ import annotations

import zlib
from typing import Optional

import torch

from bigdl_tpu_torch.nn.module import TensorModule


class Dropout(TensorModule):
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
        if self.generator is None:
            self.generator = torch.Generator().manual_seed(
                zlib.crc32(self.name.encode()))
        keep = 1.0 - self.p
        u = torch.rand(x.shape, generator=self.generator,
                       device=self.generator.device)
        y = torch.where(u.to(x.device) < keep, x, torch.zeros_like(x))
        return y / keep if self.scale else y
