"""The port's layers (``bigdl_tpu/nn/layers``): linear, conv, pooling,
normalization, activation, dropout, shape, embedding and attention."""

from bigdl_tpu_torch.nn.layers.activation import (
    Abs, AddConstant, Clamp, ELU, Exp, GELU, HardSigmoid, HardTanh,
    Identity, LeakyReLU, Log, LogSoftMax, Mish, MulConstant, Negative,
    PReLU, Power, ReLU, ReLU6, RReLU, SELU, SiLU, Sigmoid, SoftMax, SoftMin,
    SoftPlus, SoftSign, Sqrt, Square, Swish, Tanh, Threshold)
from bigdl_tpu_torch.nn.layers.attention import (MultiHeadAttention,
                                                 TransformerEncoderLayer)
from bigdl_tpu_torch.nn.layers.conv import (
    LocallyConnected1D, SpatialConvolution, SpatialDilatedConvolution,
    SpatialFullConvolution, SpatialSeparableConvolution,
    TemporalConvolution)
from bigdl_tpu_torch.nn.layers.dropout import (
    Dropout, GaussianDropout, GaussianNoise, SpatialDropout2D)
from bigdl_tpu_torch.nn.layers.embedding import Embedding, LookupTable
from bigdl_tpu_torch.nn.layers.linear import (
    Add, Bilinear, CAdd, CMul, Cosine, Linear, Mul)
from bigdl_tpu_torch.nn.layers.normalization import (
    BatchNormalization, GroupNorm, LayerNorm, Normalize, RMSNorm,
    SpatialBatchNormalization, SpatialCrossMapLRN, SpatialWithinChannelLRN)
from bigdl_tpu_torch.nn.layers.pooling import (
    GlobalAveragePooling2D, GlobalMaxPooling2D, SpatialAveragePooling,
    SpatialMaxPooling, TemporalMaxPooling, VolumetricMaxPooling)
from bigdl_tpu_torch.nn.layers.shape import (
    Contiguous, Flatten, InferReshape, Masking, Narrow, Padding, Permute,
    Replicate, Reshape, Select, SpatialZeroPadding, Squeeze, Transpose,
    Unsqueeze, UpSampling1D, UpSampling2D, View)

__all__ = [
    "Abs", "Add", "AddConstant", "BatchNormalization", "Bilinear", "CAdd",
    "CMul", "Clamp", "Contiguous", "Cosine", "Dropout", "ELU", "Embedding",
    "Exp", "Flatten", "GELU", "GaussianDropout", "GaussianNoise",
    "GlobalAveragePooling2D", "GlobalMaxPooling2D", "GroupNorm",
    "HardSigmoid", "HardTanh", "Identity", "InferReshape", "LayerNorm",
    "LeakyReLU", "Linear", "LocallyConnected1D", "Log", "LogSoftMax",
    "LookupTable", "Masking", "Mish", "Mul", "MulConstant",
    "MultiHeadAttention", "Narrow", "Negative", "Normalize", "PReLU",
    "Padding", "Permute", "Power", "RMSNorm", "RReLU", "ReLU", "ReLU6",
    "Replicate", "Reshape", "SELU", "Select", "SiLU", "Sigmoid", "SoftMax",
    "SoftMin", "SoftPlus", "SoftSign", "SpatialAveragePooling",
    "SpatialBatchNormalization", "SpatialConvolution",
    "SpatialCrossMapLRN", "SpatialDilatedConvolution", "SpatialDropout2D",
    "SpatialFullConvolution", "SpatialMaxPooling",
    "SpatialSeparableConvolution", "SpatialWithinChannelLRN",
    "SpatialZeroPadding", "Sqrt", "Square", "Squeeze", "Swish", "Tanh",
    "TemporalConvolution", "TemporalMaxPooling", "Threshold",
    "TransformerEncoderLayer", "Transpose", "Unsqueeze", "UpSampling1D",
    "UpSampling2D", "View", "VolumetricMaxPooling"]
