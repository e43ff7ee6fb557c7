"""Linear layer — the port of ``Linear`` in ``bigdl_tpu/nn/layers/linear.py``
(ref: .../nn/Linear.scala): ``weight (out, in)``, ``y = x W^T + b``, one
plain matmul (the JAX layer is a plain XLA matmul too)."""

from __future__ import annotations

from typing import Optional

import torch.nn.functional as F

from bigdl_tpu_torch.nn.initialization import (InitializationMethod,
                                               Xavier, Zeros, init_param)
from bigdl_tpu_torch.nn.module import RNG, TensorModule


class Linear(TensorModule):
    """y = x W^T + b (ref: nn/Linear.scala)."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True,
                 init_weight: Optional[InitializationMethod] = None,
                 init_bias: Optional[InitializationMethod] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias
        self._init_weight = init_weight or Xavier()
        self._init_bias = init_bias or Zeros()
        self.reset()

    def reset(self):
        shape = (self.output_size, self.input_size)
        kw = dict(fan_in=self.input_size, fan_out=self.output_size)
        self.add_param("weight",
                       init_param(self._init_weight, RNG, shape, **kw))
        if self.with_bias:
            self.add_param("bias", init_param(
                self._init_bias, RNG, (self.output_size,), **kw))
        return self

    def forward(self, x):
        b = self.bias.to(x.dtype) if self.with_bias else None
        return F.linear(x, self.weight.to(x.dtype), b)
