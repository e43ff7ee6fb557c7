"""Convolution layers — the port of ``bigdl_tpu/nn/layers/conv.py`` (ref:
.../nn/SpatialConvolution.scala, TemporalConvolution.scala,
SpatialFullConvolution.scala, SpatialDilatedConvolution.scala,
SpatialSeparableConvolution.scala, LocallyConnected1D.scala).

The JAX layers lower to ``lax.conv_general_dilated``; here ``F.conv2d`` /
``F.conv1d`` (cuDNN on the card). The weight is OIHW in both packages
and is cast to ``x.dtype`` at each call. ``format="NHWC"`` permutes the
input to a channels-last NCHW view (no copy; cuDNN picks its NHWC
kernels for it) and the output back.

``pad = -1`` is XLA's ``"SAME"``: output ``ceil(in / stride)``, the
total padding split with the odd row or column at the bottom / right.
At stride 2 that is asymmetric (ResNet-50's 7x7/2 stem on 224 pads 2
on top and 3 below), which ``F.conv2d(padding=)`` cannot express, so an
uneven split is padded explicitly with ``F.pad`` before the conv.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.initialization import (InitializationMethod,
                                               Xavier, Zeros, init_param)
from bigdl_tpu_torch.nn.module import RNG, TensorModule


def same_pads(size: int, k: int, stride: int, dilation: int = 1
              ) -> Tuple[int, int]:
    """XLA ``"SAME"`` padding of one spatial dim: ``(low, high)``."""
    eff = (k - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + eff - size, 0)
    return total // 2, total - total // 2


def to_nchw(x, format: str):
    return x.permute(0, 3, 1, 2) if format == "NHWC" else x


def from_nchw(y, format: str):
    return y.permute(0, 2, 3, 1) if format == "NHWC" else y


def conv_nd(x, w, b, stride: Sequence[int], pads, dilation: Sequence[int],
            groups: int = 1):
    """``F.conv1d`` / ``F.conv2d`` / ``F.conv3d`` on channels-first ``x``
    with per-dim ``(low, high)`` pads, padding explicitly when a split is
    uneven."""
    fn = {3: F.conv1d, 4: F.conv2d, 5: F.conv3d}[x.dim()]
    if all(lo == hi for lo, hi in pads):
        return fn(x, w, b, tuple(stride), tuple(lo for lo, _ in pads),
                  tuple(dilation), groups)
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    return fn(F.pad(x, flat), w, b, tuple(stride), 0, tuple(dilation),
              groups)


class SpatialConvolution(TensorModule):
    """2-D convolution (ref: nn/SpatialConvolution.scala).
    ``pad_w / pad_h = -1`` selects SAME padding, as in the reference."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int, stride_w: int = 1,
                 stride_h: int = 1, pad_w: int = 0, pad_h: int = 0,
                 n_group: int = 1, propagate_back: bool = True,
                 with_bias: bool = True, format: str = "NCHW",
                 init_weight: Optional[InitializationMethod] = None,
                 init_bias: Optional[InitializationMethod] = None,
                 dilation_w: int = 1, dilation_h: int = 1,
                 name: Optional[str] = None):
        super().__init__(name)
        assert n_input_plane % n_group == 0 and n_output_plane % n_group == 0
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel_w, self.kernel_h = kernel_w, kernel_h
        self.stride_w, self.stride_h = stride_w, stride_h
        self.pad_w, self.pad_h = pad_w, pad_h
        self.n_group = n_group
        self.with_bias = with_bias
        self.format = format
        self.dilation_w, self.dilation_h = dilation_w, dilation_h
        self._init_weight = init_weight or Xavier()
        self._init_bias = init_bias or Zeros()
        self.reset()

    def reset(self):
        g = self.n_group
        kk = self.kernel_h * self.kernel_w
        kw = dict(fan_in=self.n_input_plane // g * kk,
                  fan_out=self.n_output_plane // g * kk)
        self.add_param("weight", init_param(
            self._init_weight, RNG,
            (self.n_output_plane, self.n_input_plane // g, self.kernel_h,
             self.kernel_w), **kw))
        if self.with_bias:
            self.add_param("bias", init_param(
                self._init_bias, RNG, (self.n_output_plane,), **kw))
        return self

    def forward(self, x):
        x = to_nchw(x, self.format)
        if self.pad_h == -1 or self.pad_w == -1:
            pads = (same_pads(x.shape[2], self.kernel_h, self.stride_h,
                              self.dilation_h),
                    same_pads(x.shape[3], self.kernel_w, self.stride_w,
                              self.dilation_w))
        else:
            pads = ((self.pad_h, self.pad_h), (self.pad_w, self.pad_w))
        b = self.bias.to(x.dtype) if self.with_bias else None
        y = conv_nd(x, self.weight.to(x.dtype), b,
                    (self.stride_h, self.stride_w), pads,
                    (self.dilation_h, self.dilation_w), self.n_group)
        return from_nchw(y, self.format)


class SpatialDilatedConvolution(SpatialConvolution):
    """ref: nn/SpatialDilatedConvolution.scala."""

    def __init__(self, n_input_plane, n_output_plane, kw, kh, dw=1, dh=1,
                 pad_w=0, pad_h=0, dilation_w=1, dilation_h=1, **kwargs):
        super().__init__(n_input_plane, n_output_plane, kw, kh, dw, dh,
                         pad_w, pad_h, dilation_w=dilation_w,
                         dilation_h=dilation_h, **kwargs)


class SpatialFullConvolution(TensorModule):
    """Transposed conv (ref: nn/SpatialFullConvolution.scala): weight
    ``(in, out, kh, kw)``; the input dilated by the stride, padded by
    ``k - 1 - pad`` (``+ adj`` below / right) and convolved with the
    flipped kernel, as the JAX layer writes it, so any ``adj`` works."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kw: int, kh: int, dw: int = 1, dh: int = 1,
                 pad_w: int = 0, pad_h: int = 0,
                 adj_w: int = 0, adj_h: int = 0,
                 with_bias: bool = True, format: str = "NCHW",
                 name: Optional[str] = None):
        super().__init__(name)
        self.n_input_plane, self.n_output_plane = n_input_plane, n_output_plane
        self.kw, self.kh, self.dw, self.dh = kw, kh, dw, dh
        self.pad_w, self.pad_h, self.adj_w, self.adj_h = pad_w, pad_h, adj_w, adj_h
        self.with_bias = with_bias
        self.format = format
        self.add_param("weight", init_param(
            Xavier(), RNG, (n_input_plane, n_output_plane, kh, kw),
            fan_in=n_input_plane * kh * kw,
            fan_out=n_output_plane * kh * kw))
        if with_bias:
            self.add_param("bias", torch.zeros(n_output_plane))

    def forward(self, x):
        x = to_nchw(x, self.format)
        b, c, h, w = x.shape
        if self.dh > 1 or self.dw > 1:
            xd = x.new_zeros(b, c, (h - 1) * self.dh + 1,
                             (w - 1) * self.dw + 1)
            xd[:, :, ::self.dh, ::self.dw] = x
            x = xd
        ph, pw = self.kh - 1 - self.pad_h, self.kw - 1 - self.pad_w
        x = F.pad(x, (pw, pw + self.adj_w, ph, ph + self.adj_h))
        wt = torch.flip(self.weight.to(x.dtype), (-2, -1)).transpose(0, 1)
        bias = self.bias.to(x.dtype) if self.with_bias else None
        return from_nchw(F.conv2d(x, wt, bias), self.format)


class SpatialSeparableConvolution(TensorModule):
    """Depthwise + pointwise conv (ref: nn/SpatialSeparableConvolution.scala)."""

    def __init__(self, n_input_channel: int, n_output_channel: int,
                 depth_multiplier: int, kw: int, kh: int,
                 sw: int = 1, sh: int = 1, pw: int = 0, ph: int = 0,
                 with_bias: bool = True, format: str = "NCHW",
                 name: Optional[str] = None):
        super().__init__(name)
        self.depthwise = SpatialConvolution(
            n_input_channel, n_input_channel * depth_multiplier, kw, kh,
            sw, sh, pw, ph, n_group=n_input_channel, with_bias=False,
            format=format)
        self.pointwise = SpatialConvolution(
            n_input_channel * depth_multiplier, n_output_channel, 1, 1,
            with_bias=with_bias, format=format)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


class TemporalConvolution(TensorModule):
    """1-D conv over (batch, nFrames, frameSize) (ref: TemporalConvolution.scala)."""

    def __init__(self, input_frame_size: int, output_frame_size: int,
                 kernel_w: int, stride_w: int = 1,
                 propagate_back: bool = True, with_bias: bool = True,
                 pad: int = 0, dilation: int = 1,
                 name: Optional[str] = None):
        super().__init__(name)
        self.input_frame_size = input_frame_size
        self.output_frame_size = output_frame_size
        self.kernel_w = kernel_w
        self.stride_w = stride_w
        self.with_bias = with_bias
        self.pad = pad
        self.dilation = dilation
        self.add_param("weight", init_param(
            Xavier(), RNG, (output_frame_size, input_frame_size, kernel_w),
            fan_in=input_frame_size * kernel_w,
            fan_out=output_frame_size * kernel_w))
        if with_bias:
            self.add_param("bias", torch.zeros(output_frame_size))

    def forward(self, x):
        xc = x.transpose(1, 2)
        pads = (same_pads(xc.shape[2], self.kernel_w, self.stride_w,
                          self.dilation) if self.pad == -1
                else (self.pad, self.pad),)
        y = conv_nd(xc, self.weight.to(x.dtype), None, (self.stride_w,),
                    pads, (self.dilation,)).transpose(1, 2)
        return y + self.bias.to(x.dtype) if self.with_bias else y


class LocallyConnected1D(TensorModule):
    """Unshared-weight 1-D conv (ref: nn/LocallyConnected1D.scala)."""

    def __init__(self, n_input_frame: int, input_frame_size: int,
                 output_frame_size: int, kernel_w: int, stride_w: int = 1,
                 with_bias: bool = True, name: Optional[str] = None):
        super().__init__(name)
        self.n_output_frame = (n_input_frame - kernel_w) // stride_w + 1
        self.kernel_w, self.stride_w = kernel_w, stride_w
        self.with_bias = with_bias
        self.add_param("weight", init_param(
            Xavier(), RNG, (self.n_output_frame, output_frame_size,
                            input_frame_size * kernel_w),
            fan_in=input_frame_size * kernel_w, fan_out=output_frame_size))
        if with_bias:
            self.add_param("bias", torch.zeros(self.n_output_frame,
                                               output_frame_size))

    def forward(self, x):
        # (B, T, C): each output frame's window, flattened time-major
        patches = torch.stack(
            [x[:, i * self.stride_w:i * self.stride_w + self.kernel_w]
             .reshape(x.shape[0], -1) for i in range(self.n_output_frame)],
            dim=1)
        y = torch.einsum("bfk,fok->bfo", patches, self.weight)
        return y + self.bias if self.with_bias else y
