"""The native C++ quantizer — the port of ``bigdl_tpu/native`` (ref: the
reference's BigDL-core / llm.cpp sidecars, SURVEY.md §2.2).

``quant.cpp`` (a copy of the JAX package's) is built with ``g++`` at
first use into ``bigdl_tpu_torch/_build/`` and bound with ``ctypes``.
Every wrapper returns None when it does not build, and every caller then
keeps its numpy path, which gives the same bits.
"""

from bigdl_tpu_torch.native.build import available, get_lib
from bigdl_tpu_torch.native.quantize import (
    native_dequantize_q4_0, native_matmul_q4_0, native_quantize_q4_0,
    native_quantize_q8_0)

__all__ = ["available", "get_lib", "native_quantize_q4_0",
           "native_dequantize_q4_0", "native_quantize_q8_0",
           "native_matmul_q4_0"]
