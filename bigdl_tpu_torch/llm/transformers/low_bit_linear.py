"""LowBitLinear — quantized drop-in for ``nn.Linear``; the port of
``bigdl_tpu/llm/transformers/low_bit_linear.py`` (ref:
P:llm/transformers/low_bit_linear.py).

For ``sym_int4``, ``asym_int4`` and ``sym_int8`` the weight lives as
buffers in the k-major kernel layout (``to_tpu_layout``): ``q`` (K/2, N)
uint8 or (K, N) int8, ``scale`` (and ``zero``) (K/32, N) f32, and the
forward goes through the kernel wrapper of its qtype: a CUDA input
launches the CUDA kernel, a CPU input takes the kernel's plain version.
``sym_int5``, ``nf4``, ``fp4``, ``fp8`` and ``bf16`` keep the row-major
ggml states (``q`` (N, K) or (N, K/2), ``scale`` (N, K/32) fp16; the
cast formats ``q`` alone, as bf16 / e4m3fn) and forward ``x @ w`` with
``w`` dequantized in plain PyTorch, as the JAX package computes them
outside any Pallas kernel. Either way the states are the JAX package's,
so they carry across unchanged.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.llm.ggml.quantize import (CAST_QTYPES, FP4_CODE,
                                               NF4_CODE, QK, as_tensor,
                                               quantize_torch)
from bigdl_tpu_torch.llm.kernels.int4_matmul import (asym_int4_matmul,
                                                     int4_matmul,
                                                     int8_matmul,
                                                     to_tpu_layout)
from bigdl_tpu_torch.nn.module import TensorModule


class LowBitLinear(TensorModule):
    """y = x @ dequant(W)^T + b with W in any ggml qtype of
    :func:`~bigdl_tpu_torch.llm.ggml.quantize.ggml_qtypes`."""

    def __init__(self, input_size: int, output_size: int,
                 qtype: str = "sym_int4", with_bias: bool = False,
                 name: Optional[str] = None):
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
        as the states ``q``, ``scale`` and ``zero``: k-major for the
        kernel qtypes, row-major for the rest."""
        if qdict.get("qtype", self.qtype) != self.qtype:
            raise ValueError((qdict.get("qtype"), self.qtype))
        for k, v in to_tpu_layout(dict(qdict, qtype=self.qtype)).items():
            if k != "qtype":
                # quantized planes are constants, not trainable: buffers
                self.add_state(k, as_tensor(v, self.qtype if k == "q"
                                            else ""))

    def forward(self, x):
        shape = x.shape
        x2 = x.reshape(-1, shape[-1])
        if self.qtype == "sym_int4":
            y = int4_matmul(x2, self.q, self.scale, out_dtype=x.dtype)
        elif self.qtype == "asym_int4":
            y = asym_int4_matmul(x2, self.q, self.scale, self.zero,
                                 out_dtype=x.dtype)
        elif self.qtype == "sym_int8":
            y = int8_matmul(x2, self.q, self.scale, out_dtype=x.dtype)
        else:
            y = (x2 @ self._dequant(x.dtype)).to(x.dtype)
        if self.with_bias:
            y = y + self.bias
        return y.reshape(*shape[:-1], self.output_size)

    def _dequant(self, dtype) -> torch.Tensor:
        """w (K, N) of a row-major qtype in ``dtype``, so that forward is
        ``y = x @ w`` (``LowBitLinear._dequant`` of the JAX package)."""
        qtype, n = self.qtype, self.output_size
        if qtype in CAST_QTYPES:
            return self.q.to(dtype).t()
        scale = self.scale.to(torch.float32)
        nb = scale.shape[1]
        if qtype == "sym_int5":
            q = self.q.reshape(n, nb, QK).to(torch.float32) - 16.0
            return (q * scale[..., None]).reshape(n, -1).to(dtype).t()
        if qtype not in ("nf4", "fp4"):
            raise ValueError(f"unknown qtype {qtype!r}")
        lo = (self.q & 0xF).to(torch.int64)
        hi = (self.q >> 4).to(torch.int64)
        idx = torch.stack([lo, hi], dim=-1).reshape(n, -1)
        code = torch.from_numpy(NF4_CODE if qtype == "nf4" else FP4_CODE) \
            .to(self.q.device)
        w = code[idx].reshape(n, nb, QK) * scale[..., None]
        return w.reshape(n, -1).to(dtype).t()

    def extra_repr(self):
        return f"{self.input_size} -> {self.output_size}, {self.qtype}"
