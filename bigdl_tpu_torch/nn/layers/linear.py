"""Linear layers — the port of ``bigdl_tpu/nn/layers/linear.py`` (ref:
.../nn/Linear.scala, Bilinear.scala, CMul.scala, ...). ``Linear``'s
``weight`` is ``(out, in)`` and ``y = x W^T + b``: one plain matmul (the
JAX layer is a plain XLA matmul too), the weight cast to ``x.dtype``."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.initialization import (InitializationMethod,
                                               Xavier, Zeros, init_param)
from bigdl_tpu_torch.nn.module import RNG, TensorModule


class Linear(TensorModule):
    """y = x W^T + b (ref: nn/Linear.scala). The regularizer arguments
    are kept for the signature, as in the JAX layer, and unused."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True, w_regularizer=None,
                 b_regularizer=None,
                 init_weight: Optional[InitializationMethod] = None,
                 init_bias: Optional[InitializationMethod] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias
        self.w_regularizer = w_regularizer
        self.b_regularizer = b_regularizer
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


class Bilinear(TensorModule):
    """y_k = x1 W_k x2 + b_k over a Table of two inputs (ref: Bilinear.scala)."""

    def __init__(self, input_size1: int, input_size2: int, output_size: int,
                 bias_res: bool = True, name: Optional[str] = None):
        super().__init__(name)
        self.input_size1 = input_size1
        self.input_size2 = input_size2
        self.output_size = output_size
        self.bias_res = bias_res
        self.reset()

    def reset(self):
        self.add_param("weight", init_param(
            Xavier(), RNG,
            (self.output_size, self.input_size1, self.input_size2),
            fan_in=self.input_size1 * self.input_size2,
            fan_out=self.output_size))
        if self.bias_res:
            self.add_param("bias", torch.zeros(self.output_size))
        return self

    def forward(self, x):
        x1, x2 = list(x)
        y = torch.einsum("bi,oij,bj->bo", x1, self.weight, x2)
        return y + self.bias if self.bias_res else y


class CMul(TensorModule):
    """Learnable per-element scale, broadcastable size (ref: CMul.scala)."""

    def __init__(self, size, name: Optional[str] = None):
        super().__init__(name)
        self.size = tuple(size)
        self.add_param("weight", torch.ones(self.size))

    def forward(self, x):
        return x * self.weight


class CAdd(TensorModule):
    """Learnable per-element bias (ref: CAdd.scala)."""

    def __init__(self, size, name: Optional[str] = None):
        super().__init__(name)
        self.size = tuple(size)
        self.add_param("bias", torch.zeros(self.size))

    def forward(self, x):
        return x + self.bias


class Add(TensorModule):
    """Learnable bias vector (ref: Add.scala)."""

    def __init__(self, input_size: int, name: Optional[str] = None):
        super().__init__(name)
        self.input_size = input_size
        self.add_param("bias", torch.zeros(input_size))

    def forward(self, x):
        return x + self.bias


class Mul(TensorModule):
    """Single learnable scalar gain (ref: Mul.scala)."""

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.add_param("weight", torch.ones(()))

    def forward(self, x):
        return x * self.weight


class Cosine(TensorModule):
    """Cosine similarity against a weight matrix (ref: Cosine.scala)."""

    def __init__(self, input_size: int, output_size: int,
                 name: Optional[str] = None):
        super().__init__(name)
        self.input_size = input_size
        self.output_size = output_size
        self.add_param("weight", init_param(
            Xavier(), RNG, (output_size, input_size),
            fan_in=input_size, fan_out=output_size))

    def forward(self, x):
        w = self.weight
        xn = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)
        wn = w / (torch.linalg.vector_norm(w, dim=-1, keepdim=True) + 1e-12)
        return xn @ wn.T
