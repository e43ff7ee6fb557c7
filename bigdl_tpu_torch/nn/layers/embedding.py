"""Embedding layers — the port of ``bigdl_tpu/nn/layers/embedding.py`` (ref:
.../nn/LookupTable.scala).

Indices are 1-based unless ``zero_based``. As in the JAX layer, an index
out of range is *clipped* to the table (``embedding.py:44``), where
``F.embedding`` would raise (and assert on the device).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.initialization import RandomNormal, init_param
from bigdl_tpu_torch.nn.module import RNG, TensorModule


class LookupTable(TensorModule):
    """ref: nn/LookupTable.scala."""

    def __init__(self, n_index: int, n_output: int,
                 padding_value: float = 0.0, max_norm: float = float("inf"),
                 norm_type: float = 2.0, zero_based: bool = False,
                 name: Optional[str] = None):
        super().__init__(name)
        self.n_index, self.n_output = n_index, n_output
        self.padding_value = padding_value
        self.max_norm = max_norm
        self.norm_type = norm_type
        self.zero_based = zero_based
        self.add_param("weight", init_param(
            RandomNormal(0, 1), RNG, (n_index, n_output),
            fan_in=n_index, fan_out=n_output))

    def forward(self, x):
        w = self.weight
        if self.max_norm != float("inf"):
            norms = torch.linalg.vector_norm(w, ord=self.norm_type, dim=1,
                                             keepdim=True)
            w = w * torch.clamp(self.max_norm / (norms + 1e-12), max=1.0)
        idx = x.long()
        if not self.zero_based:
            idx = idx - 1
        y = F.embedding(idx.clamp(0, self.n_index - 1), w)
        if self.padding_value != 0.0:
            pad_idx = int(self.padding_value) - (0 if self.zero_based else 1)
            y = y.masked_fill((idx == pad_idx)[..., None], 0.0)
        return y


class Embedding(LookupTable):
    """Keras-style zero-based embedding."""

    def __init__(self, input_dim: int, output_dim: int,
                 name: Optional[str] = None):
        super().__init__(input_dim, output_dim, zero_based=True, name=name)
