"""The port's layers (``bigdl_tpu/nn/layers``): those BERT is built of."""

from bigdl_tpu_torch.nn.layers.activation import GELU, Tanh
from bigdl_tpu_torch.nn.layers.attention import (MultiHeadAttention,
                                                 TransformerEncoderLayer)
from bigdl_tpu_torch.nn.layers.dropout import Dropout
from bigdl_tpu_torch.nn.layers.embedding import Embedding, LookupTable
from bigdl_tpu_torch.nn.layers.linear import Linear
from bigdl_tpu_torch.nn.layers.normalization import LayerNorm

__all__ = ["Dropout", "Embedding", "GELU", "LayerNorm", "Linear",
           "LookupTable", "MultiHeadAttention", "Tanh",
           "TransformerEncoderLayer"]
