"""Volumetric (3-D) layers — the port of ``bigdl_tpu/nn/layers/
volumetric.py`` (ref: nn/VolumetricConvolution.scala,
VolumetricFullConvolution.scala, VolumetricAveragePooling.scala,
UpSampling3D.scala, Cropping3D.scala, Cropping2D.scala).

Layout NCDHW, as the reference's default. The JAX layers lower to
``lax.conv_general_dilated`` and ``lax.reduce_window``; here
``F.conv3d`` (SAME padded as in :mod:`.conv`), ``F.conv_transpose3d``
and ``F.avg_pool3d``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.initialization import (InitializationMethod,
                                               Xavier, Zeros, init_param)
from bigdl_tpu_torch.nn.layers.conv import conv_nd, same_pads
from bigdl_tpu_torch.nn.module import RNG, TensorModule


class VolumetricConvolution(TensorModule):
    """3-D convolution over (N, C, D, H, W). Any ``pad_* = -1`` makes
    every dim SAME, as XLA's ``"SAME"`` does in the JAX layer."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 k_t: int, k_w: int, k_h: int,
                 d_t: int = 1, d_w: int = 1, d_h: int = 1,
                 pad_t: int = 0, pad_w: int = 0, pad_h: int = 0,
                 with_bias: bool = True,
                 init_weight: Optional[InitializationMethod] = None,
                 init_bias: Optional[InitializationMethod] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.k = (k_t, k_h, k_w)
        self.stride = (d_t, d_h, d_w)
        self.pad = (pad_t, pad_h, pad_w)
        self.with_bias = with_bias
        fan_in = n_input_plane * k_t * k_h * k_w
        fan_out = n_output_plane * k_t * k_h * k_w
        self.add_param("weight", init_param(
            init_weight or Xavier(), RNG,
            (n_output_plane, n_input_plane) + self.k,
            fan_in=fan_in, fan_out=fan_out))
        if with_bias:
            self.add_param("bias", init_param(
                init_bias or Zeros(), RNG, (n_output_plane,),
                fan_in=fan_in, fan_out=fan_out))

    def forward(self, x):
        if any(p == -1 for p in self.pad):
            pads = [same_pads(n, k, s) for n, k, s in
                    zip(x.shape[2:], self.k, self.stride)]
        else:
            pads = [(p, p) for p in self.pad]
        b = self.bias.to(x.dtype) if self.with_bias else None
        return conv_nd(x, self.weight.to(x.dtype), b, self.stride, pads,
                       (1, 1, 1))


class VolumetricFullConvolution(TensorModule):
    """Transposed 3-D convolution (ref: VolumetricFullConvolution): weight
    ``(in, out, kt, kh, kw)``. The JAX layer dilates the input by the
    stride, pads ``k - 1 - pad`` and convolves with the flipped kernel;
    that is ``F.conv_transpose3d`` with ``padding=pad``."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 k_t: int, k_w: int, k_h: int,
                 d_t: int = 1, d_w: int = 1, d_h: int = 1,
                 pad_t: int = 0, pad_w: int = 0, pad_h: int = 0,
                 with_bias: bool = True,
                 name: Optional[str] = None):
        super().__init__(name)
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.k = (k_t, k_h, k_w)
        self.stride = (d_t, d_h, d_w)
        self.pad = (pad_t, pad_h, pad_w)
        self.with_bias = with_bias
        fan_in = n_input_plane * k_t * k_h * k_w
        self.add_param("weight", init_param(
            Xavier(), RNG, (n_input_plane, n_output_plane) + self.k,
            fan_in=fan_in, fan_out=fan_in))
        if with_bias:
            self.add_param("bias", torch.zeros(n_output_plane))

    def forward(self, x):
        b = self.bias.to(x.dtype) if self.with_bias else None
        return F.conv_transpose3d(x, self.weight.to(x.dtype), b,
                                  self.stride, self.pad)


class VolumetricAveragePooling(TensorModule):
    """3-D average pooling (ref: VolumetricAveragePooling.scala): the
    window sum over the zero-padded input, divided by the window's size
    (``count_include_pad``) or by the count of real elements in it."""

    def __init__(self, k_t: int, k_w: int, k_h: int,
                 d_t: Optional[int] = None, d_w: Optional[int] = None,
                 d_h: Optional[int] = None,
                 pad_t: int = 0, pad_w: int = 0, pad_h: int = 0,
                 count_include_pad: bool = True,
                 name: Optional[str] = None):
        super().__init__(name)
        self.k = (k_t, k_h, k_w)
        self.stride = (d_t or k_t, d_h or k_h, d_w or k_w)
        self.pad = (pad_t, pad_h, pad_w)
        self.count_include_pad = count_include_pad

    def forward(self, x):
        flat = [p for p in reversed(self.pad) for _ in (0, 1)]
        mean = F.avg_pool3d(F.pad(x, flat), self.k, self.stride)
        if self.count_include_pad:
            return mean
        ones = F.pad(torch.ones((1, 1) + x.shape[2:], dtype=x.dtype,
                                device=x.device), flat)
        return mean / F.avg_pool3d(ones, self.k, self.stride)


class UpSampling3D(TensorModule):
    """Nearest-neighbour repeat along D, H and W (ref: UpSampling3D.scala)."""

    def __init__(self, size=(2, 2, 2), name: Optional[str] = None):
        super().__init__(name)
        self.size = tuple(size)

    def forward(self, x):
        for axis, s in zip((2, 3, 4), self.size):
            x = torch.repeat_interleave(x, s, dim=axis)
        return x


class Cropping3D(TensorModule):
    """Crop (left, right) per spatial dim (ref: Cropping3D.scala)."""

    def __init__(self, dim1_crop=(0, 0), dim2_crop=(0, 0),
                 dim3_crop=(0, 0), name: Optional[str] = None):
        super().__init__(name)
        self.crops = (tuple(dim1_crop), tuple(dim2_crop),
                      tuple(dim3_crop))

    def forward(self, x):
        sl = [slice(None), slice(None)]
        for (lo, hi), n in zip(self.crops, x.shape[2:]):
            sl.append(slice(lo, n - hi if hi else None))
        return x[tuple(sl)]


class Cropping2D(TensorModule):
    """ref: Cropping2D.scala (NCHW)."""

    def __init__(self, height_crop=(0, 0), width_crop=(0, 0),
                 name: Optional[str] = None):
        super().__init__(name)
        self.crops = (tuple(height_crop), tuple(width_crop))

    def forward(self, x):
        (ht, hb), (wl, wr) = self.crops
        h, w = x.shape[2], x.shape[3]
        return x[:, :, ht:h - hb if hb else None,
                 wl:w - wr if wr else None]
