"""Parameter initialisation methods — the port of
``bigdl_tpu/nn/initialization.py`` (ref: .../nn/InitializationMethod.scala).

Each method is ``init(generator, shape, fan_in, fan_out) -> tensor``,
drawn on the CPU from the given ``torch.Generator``. Values differ from
the JAX package's ``jax.random`` draws; tests carry weights across
instead. BigDL's defaults are kept (Xavier for Linear weights, zeros for
bias, N(0, 1) for lookup tables, He / ``MsraFiller`` on request).
"""

from __future__ import annotations

import math

import torch


class InitializationMethod:
    def init(self, generator, shape, fan_in, fan_out) -> torch.Tensor:
        raise NotImplementedError


class Zeros(InitializationMethod):
    def init(self, generator, shape, fan_in, fan_out):
        return torch.zeros(shape, dtype=torch.float32)


class Ones(InitializationMethod):
    def init(self, generator, shape, fan_in, fan_out):
        return torch.ones(shape, dtype=torch.float32)


class ConstInitMethod(InitializationMethod):
    def __init__(self, value: float):
        self.value = value

    def init(self, generator, shape, fan_in, fan_out):
        return torch.full(shape, float(self.value), dtype=torch.float32)


class RandomUniform(InitializationMethod):
    def __init__(self, lower: float = -1.0, upper: float = 1.0):
        self.lower, self.upper = lower, upper

    def init(self, generator, shape, fan_in, fan_out):
        return torch.empty(shape, dtype=torch.float32).uniform_(
            self.lower, self.upper, generator=generator)


class RandomNormal(InitializationMethod):
    def __init__(self, mean: float = 0.0, stdv: float = 1.0):
        self.mean, self.stdv = mean, stdv

    def init(self, generator, shape, fan_in, fan_out):
        return self.mean + self.stdv * torch.randn(
            shape, generator=generator, dtype=torch.float32)


class Xavier(InitializationMethod):
    """Glorot uniform — BigDL's default for Linear/Conv weights."""

    def init(self, generator, shape, fan_in, fan_out):
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        return torch.empty(shape, dtype=torch.float32).uniform_(
            -limit, limit, generator=generator)


class MsraFiller(InitializationMethod):
    """Kaiming / He normal (ref: MsraFiller): std sqrt(2 / fan_in), or
    over fan_out with ``var_in_count=False``."""

    def __init__(self, var_in_count: bool = True):
        self.var_in_count = var_in_count

    def init(self, generator, shape, fan_in, fan_out):
        n = fan_in if self.var_in_count else fan_out
        return math.sqrt(2.0 / n) * torch.randn(
            shape, generator=generator, dtype=torch.float32)


def init_param(method: InitializationMethod, generator, shape, fan_in=None,
               fan_out=None) -> torch.Tensor:
    if fan_in is None:
        fan_in = shape[-1] if len(shape) > 1 else shape[0]
    if fan_out is None:
        fan_out = shape[0]
    return method.init(generator, shape, fan_in, fan_out)
