"""DLlib ``nn`` of the port (``bigdl_tpu/nn``): the module contract, the
layers BERT needs, the three initialisers they use, and ``nn.quantized``
(import it as ``bigdl_tpu_torch.nn.quantized``)."""

from bigdl_tpu_torch.nn.initialization import (InitializationMethod,
                                               RandomNormal, Xavier, Zeros)
from bigdl_tpu_torch.nn.layers import (GELU, Dropout, Embedding, LayerNorm,
                                       Linear, LookupTable,
                                       MultiHeadAttention, Tanh,
                                       TransformerEncoderLayer)
from bigdl_tpu_torch.nn.module import Module, TensorModule, set_seed

__all__ = ["Dropout", "Embedding", "GELU", "InitializationMethod",
           "LayerNorm", "Linear", "LookupTable", "Module",
           "MultiHeadAttention", "RandomNormal", "Tanh", "TensorModule",
           "TransformerEncoderLayer", "Xavier", "Zeros", "set_seed"]
