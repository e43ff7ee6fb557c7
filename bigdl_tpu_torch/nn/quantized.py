"""nn.quantized — INT8 post-training-quantized inference layers; the port
of ``bigdl_tpu/nn/quantized.py`` (ref: ``S:dllib/nn/quantized/``, the
BigQuant INT8 gemm and conv): ``Linear``, ``SpatialConvolution`` and
``quantize_model``.

Semantics kept from the reference: **weight-only** symmetric INT8 with
per-output-channel scales, computed once at conversion; activations stay
float. ``Linear`` runs the int8 matmul kernel; ``SpatialConvolution``
dequantizes its weights into the input's dtype and convolves with
``F.conv2d`` (cuDNN on the card), as the JAX layer dequantizes into
``lax.conv_general_dilated``: no Pallas kernel is on that path.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.llm.ggml.quantize import QK, true_div
from bigdl_tpu_torch.llm.kernels.int4_matmul import int8_matmul
from bigdl_tpu_torch.nn.layers.conv import (SpatialConvolution as FloatConv,
                                            conv2d)
from bigdl_tpu_torch.nn.layers.linear import Linear as FloatLinear
from bigdl_tpu_torch.nn.module import Module, TensorModule


def _quantize_per_channel(w: torch.Tensor):
    """(O, ...) weights → int8 (O, ...) + f32 (O,) per-channel scales, on
    the weights' device; the JAX package's arithmetic (f32 division,
    half-to-even rounding), so the bits agree."""
    flat = w.to(torch.float32).reshape(w.shape[0], -1)
    scale = true_div(flat.abs().amax(dim=1), 127)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.round(flat / safe[:, None]).clamp(-127, 127).to(torch.int8)
    return q.reshape(w.shape), scale


class Linear(TensorModule):
    """quantized.Linear (ref: nn/quantized/Linear.scala): states ``q``
    (in, out) int8 — the kernel's k-major layout — and ``scale`` (out,)
    f32."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True, name: Optional[str] = None):
        super().__init__(name)
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias

    @classmethod
    def from_float(cls, linear) -> "Linear":
        mod = cls(linear.input_size, linear.output_size,
                  with_bias="bias" in linear._parameters, name=linear.name)
        q, scale = _quantize_per_channel(linear.weight.detach())
        mod.add_state("q", q.t().contiguous())
        mod.add_state("scale", scale)
        if mod.with_bias:
            mod.add_param("bias", linear.bias.detach().clone())
        return mod

    def forward(self, x):
        shape = x.shape
        x2 = x.reshape(-1, shape[-1])
        k, n = self.q.shape
        if k % QK == 0:
            # a per-channel scale is a per-32-group scale with every group
            # of a column equal: one row broadcast to the kernel's
            # (K/32, N) layout, as a stride-0 view (no copy)
            scale_t = self.scale[None, :].expand(k // QK, n)
            y = int8_matmul(x2, self.q, scale_t, out_dtype=x.dtype)
        else:
            # the JAX package computes this case outside its kernel on
            # every backend, the TPU included (quantized.py:72): there is
            # no (K/32, N) scale layout for it. A faithful port, not a
            # fallback: a plain dequant and torch.matmul on any device.
            w = self.q.to(torch.float32) * self.scale[None, :]
            y = torch.matmul(x2.to(torch.float32), w).to(x.dtype)
        if self.with_bias:
            y = y + self.bias.to(y.dtype)
        return y.reshape(*shape[:-1], self.output_size)

    def extra_repr(self):
        return f"{self.input_size} -> {self.output_size}"


class SpatialConvolution(TensorModule):
    """quantized.SpatialConvolution (ref: nn/quantized/SpatialConvolution
    .scala): states ``q`` (O, I / groups, kh, kw) int8 and ``scale`` (O,)
    f32; ``pad = -1`` is SAME; groups, dilation, NCHW and NHWC."""

    def __init__(self, n_input: int, n_output: int, kw: int, kh: int,
                 dw: int = 1, dh: int = 1, pad_w: int = 0, pad_h: int = 0,
                 with_bias: bool = True, format: str = "NCHW",
                 n_group: int = 1, dilation_w: int = 1,
                 dilation_h: int = 1, name: Optional[str] = None):
        super().__init__(name)
        self.n_input, self.n_output = n_input, n_output
        self.kw, self.kh, self.dw, self.dh = kw, kh, dw, dh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.with_bias = with_bias
        self.format = format
        self.n_group = n_group
        self.dilation_w, self.dilation_h = dilation_w, dilation_h

    @classmethod
    def from_float(cls, conv) -> "SpatialConvolution":
        """Quantize one of ``nn``'s ``SpatialConvolution`` layers."""
        mod = cls(conv.n_input_plane, conv.n_output_plane, conv.kernel_w,
                  conv.kernel_h, conv.stride_w, conv.stride_h, conv.pad_w,
                  conv.pad_h, with_bias="bias" in conv._parameters,
                  format=conv.format, n_group=conv.n_group,
                  dilation_w=conv.dilation_w, dilation_h=conv.dilation_h,
                  name=conv.name)
        q, scale = _quantize_per_channel(conv.weight.detach())
        mod.add_state("q", q)
        mod.add_state("scale", scale)
        if mod.with_bias:
            mod.add_param("bias", conv.bias.detach().clone())
        return mod

    def forward(self, x):
        w = self.q.to(x.dtype) * self.scale.to(x.dtype)[:, None, None, None]
        b = self.bias.to(x.dtype) if self.with_bias else None
        return conv2d(x, w, b, (self.dh, self.dw), (self.pad_h, self.pad_w),
                      (self.dilation_h, self.dilation_w), self.n_group,
                      self.format)

    def extra_repr(self):
        return f"{self.n_input} -> {self.n_output}, {self.kw}x{self.kh}"


def quantize_model(model: Module) -> Module:
    """Quantizer.quantize equivalent (ref: nn/quantized/Quantizer.scala):
    swap every float ``nn.Linear`` / ``nn.SpatialConvolution`` for its
    INT8 twin, in place, recursively. Exact type only, as in the JAX
    package: subclasses (dilated, shared) keep their float weights."""
    twins = {FloatLinear: Linear, FloatConv: SpatialConvolution}

    def convert(m: Module):
        for key, child in list(m._modules.items()):
            twin = twins.get(type(child))
            if twin is not None:
                m._modules[key] = twin.from_float(child)
            else:
                convert(child)
        return m

    return convert(model)
