"""Model families (the port of ``bigdl_tpu.llm.models``): Llama (also
covering Mistral, Mixtral, Qwen2 and the GLM rotary variant), GPT-NeoX,
Bloom and StarCoder."""

from bigdl_tpu_torch.llm.models.bloom import BloomConfig, BloomForCausalLM
from bigdl_tpu_torch.llm.models.gptneox import (GptNeoXConfig,
                                                GptNeoXForCausalLM)
from bigdl_tpu_torch.llm.models.llama import LlamaConfig, LlamaForCausalLM
from bigdl_tpu_torch.llm.models.starcoder import (StarCoderConfig,
                                                  StarCoderForCausalLM)

__all__ = ["BloomConfig", "BloomForCausalLM",
           "GptNeoXConfig", "GptNeoXForCausalLM",
           "LlamaConfig", "LlamaForCausalLM",
           "StarCoderConfig", "StarCoderForCausalLM"]
