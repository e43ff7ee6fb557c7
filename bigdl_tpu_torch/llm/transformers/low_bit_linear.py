"""LowBitLinear — quantized drop-in for ``nn.Linear``; the port of
``bigdl_tpu/llm/transformers/low_bit_linear.py`` (ref:
P:llm/transformers/low_bit_linear.py).

The weight lives as buffers in the k-major kernel layout
(``to_tpu_layout``): ``q`` (K/2, N) uint8 or (K, N) int8, ``scale`` (and
``zero``) (K/32, N) f32 — the JAX package's state shapes, so states carry
across unchanged. The forward goes through the kernel wrapper of its
qtype: a CUDA input launches the CUDA kernel, a CPU input takes the
kernel's plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.llm.ggml.quantize import _check_qtype, quantize_torch
from bigdl_tpu_torch.llm.kernels.int4_matmul import (asym_int4_matmul,
                                                     int4_matmul,
                                                     int8_matmul,
                                                     to_tpu_layout)
from bigdl_tpu_torch.nn.module import TensorModule


class LowBitLinear(TensorModule):
    """y = x @ dequant(W)^T + b with ggml-block-quantized W
    (``sym_int4``, ``asym_int4`` or ``sym_int8``; the other ggml qtypes
    are ROADMAP Queue 1 item 2)."""

    def __init__(self, input_size: int, output_size: int,
                 qtype: str = "sym_int4", with_bias: bool = False,
                 name: Optional[str] = None):
        _check_qtype(qtype)
        super().__init__(name)
        self.input_size = input_size
        self.output_size = output_size
        self.qtype = qtype
        self.with_bias = with_bias

    @classmethod
    def from_linear(cls, linear, qtype: str = "sym_int4") -> "LowBitLinear":
        """Quantize an ``nn.Linear``'s weight on its own device (ref:
        FP4Params.quantize)."""
        mod = cls(linear.input_size, linear.output_size, qtype,
                  with_bias="bias" in linear._parameters, name=linear.name)
        mod.load_quantized(quantize_torch(linear.weight.detach(), qtype))
        if mod.with_bias:
            mod.add_param("bias", linear.bias.detach().clone())
        return mod

    @classmethod
    def from_weight(cls, w, qtype: str = "sym_int4",
                    bias=None) -> "LowBitLinear":
        """From an (out, in) weight, numpy or a tensor, quantized where
        it lies (numpy on the CPU)."""
        out_f, in_f = w.shape
        mod = cls(in_f, out_f, qtype, with_bias=bias is not None)
        mod.load_quantized(quantize_torch(torch.as_tensor(w), qtype))
        if bias is not None:
            mod.add_param("bias", bias)
        return mod

    def load_quantized(self, qdict):
        """Store a ggml row-major ``quantize()`` dict (numpy or tensors)
        as the k-major states ``q``, ``scale`` and ``zero``."""
        if qdict.get("qtype", self.qtype) != self.qtype:
            raise ValueError((qdict.get("qtype"), self.qtype))
        for k, v in to_tpu_layout(dict(qdict, qtype=self.qtype)).items():
            if k != "qtype":
                # quantized planes are constants, not trainable: buffers
                self.add_state(k, v)

    def forward(self, x):
        shape = x.shape
        x2 = x.reshape(-1, shape[-1])
        if self.qtype == "sym_int4":
            y = int4_matmul(x2, self.q, self.scale, out_dtype=x.dtype)
        elif self.qtype == "asym_int4":
            y = asym_int4_matmul(x2, self.q, self.scale, self.zero,
                                 out_dtype=x.dtype)
        else:
            y = int8_matmul(x2, self.q, self.scale, out_dtype=x.dtype)
        if self.with_bias:
            y = y + self.bias
        return y.reshape(*shape[:-1], self.output_size)

    def extra_repr(self):
        return f"{self.input_size} -> {self.output_size}, {self.qtype}"
