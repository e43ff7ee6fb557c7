"""Low-bit module surgery of the port (``bigdl_tpu/llm/transformers``)."""

from bigdl_tpu_torch.llm.transformers.convert import (ggml_convert_low_bit,
                                                      optimize_model)
from bigdl_tpu_torch.llm.transformers.low_bit_linear import LowBitLinear

__all__ = ["LowBitLinear", "ggml_convert_low_bit", "optimize_model"]
