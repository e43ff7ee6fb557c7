"""The port of ``bigdl_tpu/llm/transformers``: bigdl-llm's
``AutoModelForCausalLM`` entry point, the safetensors reader, and the
low-bit module surgery."""

from bigdl_tpu_torch.llm.transformers.convert import (ggml_convert_low_bit,
                                                      optimize_model)
from bigdl_tpu_torch.llm.transformers.low_bit_linear import LowBitLinear
from bigdl_tpu_torch.llm.transformers.model import AutoModelForCausalLM
from bigdl_tpu_torch.llm.transformers.st_reader import SafetensorsReader

__all__ = ["AutoModelForCausalLM", "LowBitLinear", "SafetensorsReader",
           "ggml_convert_low_bit", "optimize_model"]
