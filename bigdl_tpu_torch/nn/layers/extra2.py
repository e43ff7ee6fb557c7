"""More reference-parity layers — the port of ``bigdl_tpu/nn/layers/
extra2.py`` (ref: one file a class under dllib/nn/*.scala; each class
names its own). All are PyTorch ops: the JAX file reaches no Pallas
kernel. Dimensions are 1-based, as in the reference; a table output is a
:class:`~bigdl_tpu_torch.utils.table.Table` (the JAX layer's list).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch.nn.layers.conv import conv2d
from bigdl_tpu_torch.nn.layers.misc import _pair
from bigdl_tpu_torch.nn.module import RNG, Module, TensorModule
from bigdl_tpu_torch.utils.table import T

__all__ = [
    "ConvLSTMPeephole", "GradientReversal", "L1Penalty", "MaskedFill",
    "MixtureTable", "NarrowTable", "Pack", "Reverse",
    "SpatialContrastiveNormalization", "SpatialDivisiveNormalization",
    "SpatialSubtractiveNormalization", "Tile",
]


class Reverse(TensorModule):
    """Reverse along a dim (ref: nn/Reverse.scala)."""

    def __init__(self, dimension: int = 1, name: Optional[str] = None):
        super().__init__(name)
        self.dimension = dimension

    def forward(self, x):
        return torch.flip(x, (self.dimension - 1,))


class Tile(TensorModule):
    """Repeat along a dim (ref: nn/Tile.scala)."""

    def __init__(self, dimension: int = 1, copies: int = 2,
                 name: Optional[str] = None):
        super().__init__(name)
        self.dimension, self.copies = dimension, copies

    def forward(self, x):
        reps = [1] * x.dim()
        reps[self.dimension - 1] = self.copies
        return x.repeat(*reps)


class Pack(TensorModule):
    """Stack a table of tensors along a new dim (ref: nn/Pack.scala)."""

    def __init__(self, dimension: int = 1, name: Optional[str] = None):
        super().__init__(name)
        self.dimension = dimension

    def forward(self, x):
        return torch.stack(_pair(x), dim=self.dimension - 1)


class MaskedFill(TensorModule):
    """Fill where the mask is set; input ``[tensor, mask]``."""

    def __init__(self, value: float = 0.0, name: Optional[str] = None):
        super().__init__(name)
        self.value = value

    def forward(self, x):
        t, mask = _pair(x)
        return torch.where(mask.bool(), torch.full_like(t, self.value), t)


class L1Penalty(TensorModule):
    """Identity forward; in training the L1 penalty ``l1weight * sum|x|``
    (``/ numel`` when ``size_average``) is kept on ``last_penalty`` for
    drivers that add side losses (ref: nn/L1Penalty.scala)."""

    def __init__(self, l1weight: float = 1e-4, size_average: bool = False,
                 name: Optional[str] = None):
        super().__init__(name)
        self.l1weight = l1weight
        self.size_average = size_average
        self.last_penalty = 0.0

    def penalty_of(self, x):
        pen = x.abs().sum()
        if self.size_average:
            pen = pen / x.numel()
        return pen * self.l1weight

    def forward(self, x):
        if self.training:
            self.last_penalty = self.penalty_of(x.detach())
        return x


class _Reverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lam):
        ctx.lam = lam
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.lam * g, None


class GradientReversal(TensorModule):
    """Identity forward, ``-lambda * grad`` backward (ref: nn/
    GradientReversal.scala — domain-adversarial training)."""

    def __init__(self, the_lambda: float = 1.0, name: Optional[str] = None):
        super().__init__(name)
        self.the_lambda = the_lambda

    def forward(self, x):
        return _Reverse.apply(x, self.the_lambda)


class NarrowTable(Module):
    """A slice of a table (ref: nn/NarrowTable.scala): its one element
    when ``length`` is 1."""

    def __init__(self, offset: int = 1, length: int = 1,
                 name: Optional[str] = None):
        super().__init__(name)
        self.offset, self.length = offset, length

    def forward(self, x):
        out = _pair(x)[self.offset - 1:self.offset - 1 + self.length]
        return out[0] if self.length == 1 else T(*out)


class MixtureTable(Module):
    """Mixture-of-experts combiner (ref: nn/MixtureTable.scala): input
    ``[gates (B, E), table of E experts (B, ...)]`` → the gate-weighted
    sum."""

    def forward(self, x):
        gates, experts = _pair(x)
        stacked = torch.stack(_pair(experts), dim=1)       # (B, E, ...)
        g = gates.reshape(gates.shape + (1,) * (stacked.dim() - 2))
        return (stacked * g.to(stacked.dtype)).sum(dim=1)


def _box_filter(x, kernel: torch.Tensor, format: str):
    """Cross-plane 2-D filter with SAME padding: one (B, 1, H, W) map
    averaged over all input channels (the kernel is sum-normalised; the
    channel count divides here)."""
    c = x.shape[-1 if format == "NHWC" else 1]
    kh, kw = kernel.shape
    k = (kernel.to(x.device)[None, None].expand(1, c, kh, kw) / c).to(x.dtype)
    return conv2d(x, k, None, (1, 1), (-1, -1), (1, 1), 1, format)


def _norm_kernel(kernel) -> torch.Tensor:
    k = np.asarray(kernel if kernel is not None else np.ones((9, 9)),
                   np.float32)
    return torch.from_numpy(k / k.sum())


class SpatialSubtractiveNormalization(TensorModule):
    """Subtract the local weighted mean, divided by the kernel's coverage
    at the borders (ref: nn/SpatialSubtractiveNormalization.scala)."""

    def __init__(self, n_input_plane: int = 1, kernel=None,
                 format: str = "NCHW", name: Optional[str] = None):
        super().__init__(name)
        self._kernel = _norm_kernel(kernel)
        self.format = format

    def forward(self, x):
        cov = _box_filter(torch.ones_like(x), self._kernel, self.format)
        return x - _box_filter(x, self._kernel, self.format) / cov


class SpatialDivisiveNormalization(TensorModule):
    """Divide by the local weighted std, at least ``threshold`` (ref: nn/
    SpatialDivisiveNormalization.scala)."""

    def __init__(self, n_input_plane: int = 1, kernel=None,
                 threshold: float = 1e-4, format: str = "NCHW",
                 name: Optional[str] = None):
        super().__init__(name)
        self._kernel = _norm_kernel(kernel)
        self.threshold = threshold
        self.format = format

    def forward(self, x):
        cov = _box_filter(torch.ones_like(x), self._kernel, self.format)
        var = _box_filter(x * x, self._kernel, self.format) / cov
        std = torch.sqrt(torch.clamp(var, min=0.0))
        return x / torch.clamp(std, min=self.threshold)


class SpatialContrastiveNormalization(TensorModule):
    """Subtractive, then divisive (ref: nn/
    SpatialContrastiveNormalization.scala)."""

    def __init__(self, n_input_plane: int = 1, kernel=None,
                 threshold: float = 1e-4, format: str = "NCHW",
                 name: Optional[str] = None):
        super().__init__(name)
        self._sub = SpatialSubtractiveNormalization(n_input_plane, kernel,
                                                    format)
        self._div = SpatialDivisiveNormalization(n_input_plane, kernel,
                                                 threshold, format)

    def forward(self, x):
        return self._div(self._sub(x))


class ConvLSTMPeephole(TensorModule):
    """Convolutional LSTM over a sequence (ref: nn/ConvLSTMPeephole.scala):
    input (B, T, C, H, W) → outputs (B, T, hidden, ceil(H / stride),
    ceil(W / stride)). The gates are an input convolution (``kernel_i``,
    strided) and a hidden one (``kernel_c``, stride 1), both SAME; the
    peepholes multiply the cell state into the input and forget gates
    (the old cell) and the output gate (the new one)."""

    def __init__(self, input_size: int, output_size: int,
                 kernel_i: int = 3, kernel_c: int = 3, stride: int = 1,
                 with_peephole: bool = True, name: Optional[str] = None):
        super().__init__(name)
        self.input_size, self.output_size = input_size, output_size
        self.ki, self.kc, self.stride = kernel_i, kernel_c, stride
        self.with_peephole = with_peephole
        si = float(np.sqrt(1.0 / (input_size * kernel_i * kernel_i)))
        sc = float(np.sqrt(1.0 / (output_size * kernel_c * kernel_c)))
        o = output_size
        self.add_param("wi", torch.randn(
            (4 * o, input_size, kernel_i, kernel_i), generator=RNG) * si)
        self.add_param("wh", torch.randn(
            (4 * o, o, kernel_c, kernel_c), generator=RNG) * sc)
        self.add_param("b", torch.zeros(4 * o))
        if with_peephole:
            for g in ("wci", "wcf", "wco"):
                self.add_param(g, torch.zeros(o, 1, 1))

    def forward(self, x):
        b, t, _, h, w = x.shape
        o, st = self.output_size, self.stride
        hprev = cprev = x.new_zeros((b, o, -(-h // st), -(-w // st)))
        wi, wh = self.wi.to(x.dtype), self.wh.to(x.dtype)
        bias = self.b.to(x.dtype)[:, None, None]
        ys = []
        for i in range(t):
            z = conv2d(x[:, i], wi, None, (st, st), (-1, -1), (1, 1)) \
                + conv2d(hprev, wh, None, (1, 1), (-1, -1), (1, 1)) + bias
            zi, zf, zc, zo = z.chunk(4, dim=1)
            if self.with_peephole:
                zi = zi + self.wci * cprev
                zf = zf + self.wcf * cprev
            cprev = torch.sigmoid(zf) * cprev \
                + torch.sigmoid(zi) * torch.tanh(zc)
            if self.with_peephole:
                zo = zo + self.wco * cprev
            hprev = torch.sigmoid(zo) * torch.tanh(cprev)
            ys.append(hprev)
        return torch.stack(ys, dim=1)
