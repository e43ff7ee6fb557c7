"""Normalization layers — the port of ``bigdl_tpu/nn/layers/
normalization.py`` (ref: .../nn/BatchNormalization.scala,
SpatialBatchNormalization.scala, Normalize.scala,
SpatialCrossMapLRN.scala, SpatialWithinChannelLRN.scala; LayerNorm and
RMSNorm from the keras / LLM era).

Batch norm follows the JAX layer (``normalization.py:51-92``) step for
step, not ``F.batch_norm``: statistics in f32 in one pass, shifted by
the running mean (``E[(x-c)^2] - (E[x]-c)^2``), ``momentum`` the weight
of the new batch, the running variance unbiased (``n / (n - 1)``), the
output ``x * scale + shift`` cast back to ``x.dtype``; eval mode uses
the running statistics. Training mode replaces the two buffers with the
moved statistics (computed without a graph).

Inside a data-parallel step in plain mode (``DistriOptimizer`` without
gradient compression, ``dp_train_step``) the shifted moments are
averaged over the data group with autograd through the reduce, so
every rank normalises with the global batch's statistics, as the JAX
layer does under the SPMD program; the running variance's ``n`` is the
global count.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import TensorModule
from bigdl_tpu_torch.parallel.collectives import (batch_stats_group,
                                                  differentiable_mean,
                                                  group_size)


class BatchNormalization(TensorModule):
    """1-D batchnorm over (B, C) or (B, C, T) (ref: nn/BatchNormalization.scala).
    The reference's ``momentum`` is the weight of the new batch's
    statistic: ``running = (1 - momentum) * running + momentum * batch``."""

    _feature_axis = 1

    def __init__(self, n_output: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 name: Optional[str] = None):
        super().__init__(name)
        self.n_output = n_output
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        if affine:
            self.add_param("weight", torch.ones(n_output))
            self.add_param("bias", torch.zeros(n_output))
        self.add_state("running_mean", torch.zeros(n_output))
        self.add_state("running_var", torch.ones(n_output))

    def forward(self, x):
        ax = self._feature_axis
        dims = tuple(i for i in range(x.dim()) if i != ax)
        shape = tuple(self.n_output if i == ax else 1 for i in range(x.dim()))
        if self.training:
            c = self.running_mean.float()
            xf = x.float() - c.reshape(shape)
            dmean = xf.mean(dim=dims)
            m2 = (xf * xf).mean(dim=dims)
            n = x.numel() // self.n_output
            group = batch_stats_group()
            if group is not None:
                # a data-parallel step in plain mode: the moments of the
                # global batch (equal shards), differentiable
                dmean, m2 = differentiable_mean(
                    torch.stack([dmean, m2]), group).unbind(0)
                n *= group_size(group)
            mean = dmean + c
            var = torch.clamp(m2 - dmean * dmean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean = (1 - m) * self.running_mean + m * mean
                self.running_var = (1 - m) * self.running_var \
                    + m * (var * n / max(n - 1, 1))
        else:
            mean = self.running_mean.float()
            var = self.running_var.float()
        inv = torch.rsqrt(var + self.eps)
        if self.affine:
            scale = self.weight.float() * inv
            shift = self.bias.float() - mean * scale
        else:
            scale, shift = inv, -mean * inv
        return x * scale.reshape(shape).to(x.dtype) \
            + shift.reshape(shape).to(x.dtype)


class SpatialBatchNormalization(BatchNormalization):
    """NCHW / NHWC batchnorm (ref: nn/SpatialBatchNormalization.scala)."""

    def __init__(self, n_output: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 format: str = "NCHW", name: Optional[str] = None):
        super().__init__(n_output, eps, momentum, affine, name)
        self._fmt = format
        self._feature_axis = 1 if format == "NCHW" else 3


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


class RMSNorm(TensorModule):
    """Root-mean-square norm, statistics in f32 (Llama-family need)."""

    def __init__(self, hidden_size: int, eps: float = 1e-6,
                 name: Optional[str] = None):
        super().__init__(name)
        self.hidden_size = hidden_size
        self.eps = eps
        self.add_param("weight", torch.ones(hidden_size))

    def forward(self, x):
        xf = x.float()
        inv = torch.reciprocal(torch.sqrt(
            (xf * xf).mean(dim=-1, keepdim=True) + self.eps))
        return (xf * inv).to(x.dtype) * self.weight.to(x.dtype)


class GroupNorm(TensorModule):
    def __init__(self, n_groups: int, n_channels: int, eps: float = 1e-5,
                 format: str = "NCHW", name: Optional[str] = None):
        super().__init__(name)
        assert n_channels % n_groups == 0
        self.n_groups, self.n_channels, self.eps = n_groups, n_channels, eps
        self.format = format
        self.add_param("weight", torch.ones(n_channels))
        self.add_param("bias", torch.zeros(n_channels))

    def forward(self, x):
        if self.format == "NHWC":
            x = x.movedim(-1, 1)
        b, c = x.shape[0], x.shape[1]
        xg = x.reshape(b, self.n_groups, c // self.n_groups, *x.shape[2:])
        dims = tuple(range(2, xg.dim()))
        mean = xg.mean(dim=dims, keepdim=True)
        var = xg.var(dim=dims, keepdim=True, correction=0)
        y = ((xg - mean) / torch.sqrt(var + self.eps)).reshape(x.shape)
        shape = (1, c) + (1,) * (x.dim() - 2)
        y = y * self.weight.reshape(shape) + self.bias.reshape(shape)
        return y.movedim(1, -1) if self.format == "NHWC" else y


class Normalize(TensorModule):
    """Lp-normalize over the feature dim (ref: nn/Normalize.scala)."""

    def __init__(self, p: float = 2.0, eps: float = 1e-10,
                 name: Optional[str] = None):
        super().__init__(name)
        self.p, self.eps = p, eps

    def forward(self, x):
        if self.p == float("inf"):
            norm = x.abs().amax(dim=-1, keepdim=True)
        else:
            norm = (x.abs() ** self.p).sum(dim=-1, keepdim=True) \
                ** (1.0 / self.p)
        return x / (norm + self.eps)


class SpatialCrossMapLRN(TensorModule):
    """Local response norm across channels (ref: nn/SpatialCrossMapLRN.scala):
    ``x / (k + alpha / size * sum_{nearby c} x_c^2) ** beta``."""

    def __init__(self, size: int = 5, alpha: float = 1.0,
                 beta: float = 0.75, k: float = 1.0, format: str = "NCHW",
                 name: Optional[str] = None):
        super().__init__(name)
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k
        self.format = format

    def forward(self, x):
        ax = 1 if self.format == "NCHW" else 3
        half = self.size // 2
        pad = [0, 0] * x.dim()
        # F.pad lists dims last-first
        pad[2 * (x.dim() - 1 - ax)] = half
        pad[2 * (x.dim() - 1 - ax) + 1] = self.size - 1 - half
        sq = F.pad(x * x, pad)
        n = x.shape[ax]
        acc = sum(sq.narrow(ax, i, n) for i in range(self.size))
        return x / (self.k + self.alpha / self.size * acc) ** self.beta


class SpatialWithinChannelLRN(TensorModule):
    """LRN within channel over a spatial window (ref: nn/SpatialWithinChannelLRN.scala)."""

    def __init__(self, size: int = 5, alpha: float = 1.0, beta: float = 0.75,
                 name: Optional[str] = None):
        super().__init__(name)
        self.size, self.alpha, self.beta = size, alpha, beta

    def forward(self, x):
        half = self.size // 2
        lo, hi = half, self.size - 1 - half
        s = self.size
        summed = F.avg_pool2d(F.pad(x * x, (lo, hi, lo, hi)), s, 1) * (s * s)
        return x / (1.0 + self.alpha / (s * s) * summed) ** self.beta
