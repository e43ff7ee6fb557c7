"""Assorted layers — the port of ``bigdl_tpu/nn/layers/misc.py`` (ref:
one Scala file per class under dllib/nn — Max.scala, Min.scala,
Mean.scala, Sum.scala, MM.scala, MV.scala, DotProduct.scala,
CosineDistance.scala, PairwiseDistance.scala, Euclidean.scala,
Scale.scala, TimeDistributed.scala, Highway (keras), Maxout.scala,
SReLU.scala, Index.scala, LocallyConnected2D.scala).

Reduce and index layers take the reference's 1-based ``dimension``
(counted over the whole tensor, batch included). ``bigdl_tpu_torch.nn``
exports this module's ``MM``, ``MV``, ``DotProduct`` and
``CosineDistance``, as the JAX ``nn`` does (the containers' versions
stay importable from ``nn.containers``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.initialization import Xavier, init_param
from bigdl_tpu_torch.nn.module import RNG, Module, TensorModule
from bigdl_tpu_torch.utils.table import Table


def _pair(x):
    if isinstance(x, Table):
        return list(x.values())
    return list(x)


def _dim0(dimension: int) -> int:
    """The reference's 1-based dim → a 0-based axis."""
    if dimension < 1:
        raise ValueError(f"dimension is 1-based, got {dimension}")
    return dimension - 1


class Max(TensorModule):
    """max over a dimension (ref: Max.scala)."""

    def __init__(self, dim: int = 1, num_input_dims: int = -1,
                 name: Optional[str] = None):
        super().__init__(name)
        self.dim = dim

    def forward(self, x):
        return torch.amax(x, dim=_dim0(self.dim))


class Min(TensorModule):
    def __init__(self, dim: int = 1, name: Optional[str] = None):
        super().__init__(name)
        self.dim = dim

    def forward(self, x):
        return torch.amin(x, dim=_dim0(self.dim))


class Mean(TensorModule):
    def __init__(self, dimension: int = 1, squeeze: bool = True,
                 name: Optional[str] = None):
        super().__init__(name)
        self.dimension = dimension
        self.squeeze = squeeze

    def forward(self, x):
        return torch.mean(x, dim=_dim0(self.dimension),
                          keepdim=not self.squeeze)


class Sum(TensorModule):
    def __init__(self, dimension: int = 1, squeeze: bool = True,
                 name: Optional[str] = None):
        super().__init__(name)
        self.dimension = dimension
        self.squeeze = squeeze

    def forward(self, x):
        return torch.sum(x, dim=_dim0(self.dimension),
                         keepdim=not self.squeeze)


class Index(TensorModule):
    """Table(tensor, indices) → the tensor indexed along ``dimension``
    (ref: Index.scala; 1-based indices)."""

    def __init__(self, dimension: int = 1, name: Optional[str] = None):
        super().__init__(name)
        self.dimension = dimension

    def forward(self, x):
        t, idx = _pair(x)
        return torch.index_select(t, _dim0(self.dimension),
                                  idx.to(torch.int64).reshape(-1) - 1
                                  ).reshape(
            t.shape[:_dim0(self.dimension)] + idx.shape
            + t.shape[_dim0(self.dimension) + 1:])


class MM(TensorModule):
    """Table(a, b) → a @ b with optional transposes (ref: MM.scala)."""

    def __init__(self, trans_a: bool = False, trans_b: bool = False,
                 name: Optional[str] = None):
        super().__init__(name)
        self.trans_a, self.trans_b = trans_a, trans_b

    def forward(self, x):
        a, b = _pair(x)
        if self.trans_a:
            a = a.transpose(-1, -2)
        if self.trans_b:
            b = b.transpose(-1, -2)
        return a @ b


class MV(TensorModule):
    """Table(matrix, vector) → matrix @ vector (ref: MV.scala)."""

    def __init__(self, trans: bool = False, name: Optional[str] = None):
        super().__init__(name)
        self.trans = trans

    def forward(self, x):
        m, v = _pair(x)
        if self.trans:
            m = m.transpose(-1, -2)
        return torch.einsum("...ij,...j->...i", m, v)


class DotProduct(TensorModule):
    """Table(a, b) → rowwise dot (ref: DotProduct.scala)."""

    def forward(self, x):
        a, b = _pair(x)
        return torch.sum(a * b, dim=-1)


class CosineDistance(TensorModule):
    """Table(a, b) → rowwise cosine similarity (ref: CosineDistance.scala):
    the dot over the product of the norms plus 1e-12."""

    def forward(self, x):
        a, b = _pair(x)
        num = torch.sum(a * b, dim=-1)
        den = (torch.linalg.vector_norm(a, dim=-1)
               * torch.linalg.vector_norm(b, dim=-1) + 1e-12)
        return num / den


class PairwiseDistance(TensorModule):
    """Table(a, b) → the p-norm of (a - b) per row (ref:
    PairwiseDistance.scala)."""

    def __init__(self, norm: int = 2, name: Optional[str] = None):
        super().__init__(name)
        self.norm = norm

    def forward(self, x):
        a, b = _pair(x)
        return torch.linalg.vector_norm(a - b, ord=self.norm, dim=-1)


class Euclidean(TensorModule):
    """Distance to each of ``output_size`` learned centers (ref:
    Euclidean.scala)."""

    def __init__(self, input_size: int, output_size: int,
                 name: Optional[str] = None):
        super().__init__(name)
        self.add_param("weight", init_param(
            Xavier(), RNG, (output_size, input_size),
            fan_in=input_size, fan_out=output_size))

    def forward(self, x):
        diff = x[..., None, :] - self.weight.to(x.dtype)     # (..., O, I)
        return torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)


class Scale(TensorModule):
    """Elementwise learned scale and shift over a given shape (ref:
    Scale.scala = CMul + CAdd)."""

    def __init__(self, size: Sequence[int], name: Optional[str] = None):
        super().__init__(name)
        self.size = tuple(size)
        self.add_param("weight", torch.ones(self.size))
        self.add_param("bias", torch.zeros(self.size))

    def forward(self, x):
        return x * self.weight.to(x.dtype) + self.bias.to(x.dtype)


class TimeDistributed(Module):
    """The inner module at every timestep of (B, T, ...), time folded
    into the batch (ref: TimeDistributed.scala — the same trick)."""

    def __init__(self, layer: Module, name: Optional[str] = None):
        super().__init__(name)
        self._modules["layer"] = layer

    def forward(self, x):
        b, t = x.shape[0], x.shape[1]
        y = self._modules["layer"](x.reshape((b * t,) + x.shape[2:]))
        return y.reshape((b, t) + y.shape[1:])


class Highway(Module):
    """Highway layer: t * h(x) + (1 - t) * x (ref: keras-era Highway).
    ``activation`` is a callable on tensors (``torch.tanh`` by default;
    the Keras wrapper maps its name to one)."""

    def __init__(self, size: int, activation=None,
                 name: Optional[str] = None):
        super().__init__(name)
        from bigdl_tpu_torch.nn.layers.linear import Linear
        self._modules["h"] = Linear(size, size)
        self._modules["t"] = Linear(size, size)
        self.activation = activation or torch.tanh

    def forward(self, x):
        h = self.activation(self._modules["h"](x))
        t = torch.sigmoid(self._modules["t"](x))
        return t * h + (1 - t) * x


class Maxout(TensorModule):
    """Linear to (out, pool), then the max over the pool (ref:
    Maxout.scala)."""

    def __init__(self, input_size: int, output_size: int,
                 maxout_number: int, name: Optional[str] = None):
        super().__init__(name)
        self.output_size = output_size
        self.maxout_number = maxout_number
        self.add_param("weight", init_param(
            Xavier(), RNG, (output_size * maxout_number, input_size),
            fan_in=input_size, fan_out=output_size))
        self.add_param("bias", torch.zeros(output_size * maxout_number))

    def forward(self, x):
        y = F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))
        y = y.reshape(x.shape[:-1] + (self.output_size,
                                      self.maxout_number))
        return torch.amax(y, dim=-1)


class SReLU(TensorModule):
    """S-shaped ReLU with learned thresholds and slopes (ref:
    SReLU.scala)."""

    def __init__(self, shape: Sequence[int], name: Optional[str] = None):
        super().__init__(name)
        shape = tuple(shape)
        self.add_param("t_right", torch.ones(shape))
        self.add_param("a_right", torch.ones(shape))
        self.add_param("t_left", torch.zeros(shape))
        self.add_param("a_left", torch.zeros(shape))

    def forward(self, x):
        tr, ar = self.t_right.to(x.dtype), self.a_right.to(x.dtype)
        tl, al = self.t_left.to(x.dtype), self.a_left.to(x.dtype)
        return torch.where(x >= tr, tr + ar * (x - tr),
                           torch.where(x <= tl, tl + al * (x - tl), x))


class LocallyConnected2D(TensorModule):
    """Unshared 2-D convolution (ref: LocallyConnected2D.scala), NCHW,
    valid padding: every output position owns its kernel. ``F.unfold``
    flattens each patch in (C, KH, KW) order, as
    ``conv_general_dilated_patches`` does in the JAX layer."""

    def __init__(self, n_input_plane: int, input_h: int, input_w: int,
                 n_output_plane: int, kernel_h: int, kernel_w: int,
                 stride_h: int = 1, stride_w: int = 1,
                 with_bias: bool = True, name: Optional[str] = None):
        super().__init__(name)
        self.ci, self.co = n_input_plane, n_output_plane
        self.kh, self.kw = kernel_h, kernel_w
        self.sh, self.sw = stride_h, stride_w
        self.oh = (input_h - kernel_h) // stride_h + 1
        self.ow = (input_w - kernel_w) // stride_w + 1
        fan_in = n_input_plane * kernel_h * kernel_w
        self.add_param("weight", init_param(
            Xavier(), RNG,
            (self.oh * self.ow, n_output_plane, fan_in),
            fan_in=fan_in, fan_out=n_output_plane))
        self.with_bias = with_bias
        if with_bias:
            self.add_param("bias", torch.zeros(n_output_plane, self.oh,
                                               self.ow))

    def forward(self, x):
        b = x.shape[0]
        patches = F.unfold(x, (self.kh, self.kw),
                           stride=(self.sh, self.sw))     # (B, CKK, P)
        y = torch.einsum("bkp,pok->bop", patches,
                         self.weight.to(x.dtype))        # (B, CO, P)
        y = y.reshape(b, self.co, self.oh, self.ow)
        if self.with_bias:
            y = y + self.bias.to(y.dtype)[None]
        return y
