"""Normalization layers — the port of ``LayerNorm`` in
``bigdl_tpu/nn/layers/normalization.py`` (keras-era BigDL LayerNorm)."""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.module import TensorModule


class LayerNorm(TensorModule):
    """Layer normalization over the last dim, with the biased variance
    (``normalization.py:120-124``), in the input's dtype."""

    def __init__(self, hidden_size: int, eps: float = 1e-6,
                 name: Optional[str] = None):
        super().__init__(name)
        self.hidden_size = hidden_size
        self.eps = eps
        self.add_param("weight", torch.ones(hidden_size))
        self.add_param("bias", torch.zeros(hidden_size))

    def forward(self, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, keepdim=True, correction=0)
        y = (x - mean) / torch.sqrt(var + self.eps)
        return y * self.weight.to(x.dtype) + self.bias.to(x.dtype)
