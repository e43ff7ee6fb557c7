"""Activation layers — the port of ``bigdl_tpu/nn/layers/activation.py``
(ref: .../nn/ReLU.scala, Tanh.scala, LogSoftMax.scala, SoftMax.scala,
ELU.scala, PReLU.scala, HardTanh.scala, ...): stateless elementwise
modules, one ATen op or a few each."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import Stochastic, TensorModule


class Identity(TensorModule):
    def forward(self, x):
        return x


class ReLU(TensorModule):
    def __init__(self, ip: bool = False, name: Optional[str] = None):
        super().__init__(name)

    def forward(self, x):
        return F.relu(x)


class ReLU6(TensorModule):
    def forward(self, x):
        return F.relu6(x)


class Tanh(TensorModule):
    def forward(self, x):
        return torch.tanh(x)


class Sigmoid(TensorModule):
    def forward(self, x):
        return torch.sigmoid(x)


class HardSigmoid(TensorModule):
    def forward(self, x):
        return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


class HardTanh(TensorModule):
    def __init__(self, min_value: float = -1.0, max_value: float = 1.0,
                 name: Optional[str] = None):
        super().__init__(name)
        self.min_value, self.max_value = min_value, max_value

    def forward(self, x):
        return torch.clamp(x, self.min_value, self.max_value)


class ELU(TensorModule):
    def __init__(self, alpha: float = 1.0, name: Optional[str] = None):
        super().__init__(name)
        self.alpha = alpha

    def forward(self, x):
        return F.elu(x, self.alpha)


class SELU(TensorModule):
    def forward(self, x):
        return F.selu(x)


class GELU(TensorModule):
    """``approximate=True`` (the JAX layer's default, ``activation.py:77``)
    is the tanh form; ``False`` is the exact erf form, which the encoder
    layer asks for (HF BERT semantics)."""

    def __init__(self, approximate: bool = True, name: Optional[str] = None):
        super().__init__(name)
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, approximate="tanh" if self.approximate else "none")


class SiLU(TensorModule):
    """a.k.a. Swish — used by Llama MLPs."""

    def forward(self, x):
        return F.silu(x)


Swish = SiLU


class Mish(TensorModule):
    def forward(self, x):
        return x * torch.tanh(F.softplus(x))


class LeakyReLU(TensorModule):
    def __init__(self, negval: float = 0.01, name: Optional[str] = None):
        super().__init__(name)
        self.negval = negval

    def forward(self, x):
        return F.leaky_relu(x, self.negval)


class PReLU(TensorModule):
    """Learnable leaky slope (ref: nn/PReLU.scala). n_output_plane=0 → shared."""

    def __init__(self, n_output_plane: int = 0, name: Optional[str] = None):
        super().__init__(name)
        self.n_output_plane = n_output_plane
        self.add_param("weight", torch.full((max(n_output_plane, 1),), 0.25))

    def forward(self, x):
        w = self.weight
        if self.n_output_plane > 0 and x.dim() == 4:
            w = w[:, None, None]  # NCHW channel broadcast
        return torch.where(x >= 0, x, w * x)


class RReLU(Stochastic, TensorModule):
    """Randomized leaky ReLU (ref: nn/RReLU.scala): in training the slope
    of each element is drawn from U(lower, upper) (from the layer's
    generator, see :class:`Stochastic`), else their mean."""

    def __init__(self, lower: float = 1.0 / 8, upper: float = 1.0 / 3,
                 generator: Optional[torch.Generator] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.lower, self.upper = lower, upper
        self.generator = generator

    def forward(self, x):
        if self.training:
            a = self.lower + (self.upper - self.lower) * self._rand(
                x.shape, x).to(x.dtype)
        else:
            a = (self.lower + self.upper) / 2.0
        return torch.where(x >= 0, x, a * x)


class SoftMax(TensorModule):
    def __init__(self, pos: int = -1, name: Optional[str] = None):
        super().__init__(name)
        self.pos = pos

    def forward(self, x):
        return torch.softmax(x, dim=self.pos)


class LogSoftMax(TensorModule):
    def forward(self, x):
        return torch.log_softmax(x, dim=-1)


class SoftMin(TensorModule):
    def forward(self, x):
        return torch.softmax(-x, dim=-1)


class SoftPlus(TensorModule):
    def __init__(self, beta: float = 1.0, name: Optional[str] = None):
        super().__init__(name)
        self.beta = beta

    def forward(self, x):
        return F.softplus(self.beta * x) / self.beta


class SoftSign(TensorModule):
    def forward(self, x):
        return F.softsign(x)


class Threshold(TensorModule):
    def __init__(self, th: float = 1e-6, v: float = 0.0,
                 name: Optional[str] = None):
        super().__init__(name)
        self.th, self.v = th, v

    def forward(self, x):
        return torch.where(x > self.th, x, torch.full_like(x, self.v))


class Power(TensorModule):
    """(shift + scale * x) ** power (ref: nn/Power.scala)."""

    def __init__(self, power: float, scale: float = 1.0, shift: float = 0.0,
                 name: Optional[str] = None):
        super().__init__(name)
        self.power, self.scale, self.shift = power, scale, shift

    def forward(self, x):
        return (self.shift + self.scale * x) ** self.power


class Square(TensorModule):
    def forward(self, x):
        return x * x


class Sqrt(TensorModule):
    def forward(self, x):
        return torch.sqrt(x)


class Log(TensorModule):
    def forward(self, x):
        return torch.log(x)


class Exp(TensorModule):
    def forward(self, x):
        return torch.exp(x)


class Abs(TensorModule):
    def forward(self, x):
        return torch.abs(x)


class Negative(TensorModule):
    def forward(self, x):
        return -x


class Clamp(TensorModule):
    def __init__(self, min_v: float, max_v: float, name: Optional[str] = None):
        super().__init__(name)
        self.min_v, self.max_v = min_v, max_v

    def forward(self, x):
        return torch.clamp(x, self.min_v, self.max_v)


class AddConstant(TensorModule):
    def __init__(self, constant_scalar: float, ip: bool = False,
                 name: Optional[str] = None):
        super().__init__(name)
        self.constant_scalar = constant_scalar

    def forward(self, x):
        return x + self.constant_scalar


class MulConstant(TensorModule):
    def __init__(self, scalar: float, ip: bool = False,
                 name: Optional[str] = None):
        super().__init__(name)
        self.scalar = scalar

    def forward(self, x):
        return x * self.scalar
