"""The port's layers (``bigdl_tpu/nn/layers``): linear, conv, pooling,
normalization, activation, dropout, shape, embedding, attention, misc,
recurrent, volumetric, extra2 and extra3."""

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
from bigdl_tpu_torch.nn.layers.extra2 import (
    ConvLSTMPeephole, GradientReversal, L1Penalty, MaskedFill, MixtureTable,
    NarrowTable, Pack, Reverse, SpatialContrastiveNormalization,
    SpatialDivisiveNormalization, SpatialSubtractiveNormalization, Tile)
from bigdl_tpu_torch.nn.layers.extra3 import (
    ActivityRegularization, Anchor, BifurcateSplitTable, BinaryThreshold,
    Cropping1D, DenseToSparse, GaussianSampler, HardShrink, Input,
    LogSigmoid, MaskedSelect, MultiRNNCell, NegativeEntropyPenalty,
    PriorBox, ResizeBilinear, RoiPooling, SoftShrink,
    SpatialConvolutionMap, SpatialDropout1D, SpatialDropout3D,
    SpatialShareConvolution, TanhShrink)
from bigdl_tpu_torch.nn.layers.misc import (
    CosineDistance, DotProduct, Euclidean, Highway, Index,
    LocallyConnected2D, Max, Maxout, Mean, Min, MM, MV, PairwiseDistance,
    Scale, SReLU, Sum, TimeDistributed)
from bigdl_tpu_torch.nn.layers.recurrent import (
    BiRecurrent, Cell, GRU, LSTM, Recurrent, RnnCell)
from bigdl_tpu_torch.nn.layers.volumetric import (
    Cropping2D, Cropping3D, UpSampling3D, VolumetricAveragePooling,
    VolumetricConvolution, VolumetricFullConvolution)
from bigdl_tpu_torch.nn.layers.shape import (
    Contiguous, Flatten, InferReshape, Masking, Narrow, Padding, Permute,
    Replicate, Reshape, Select, SpatialZeroPadding, Squeeze, Transpose,
    Unsqueeze, UpSampling1D, UpSampling2D, View)

__all__ = [
    "Abs", "ActivityRegularization", "Add", "AddConstant", "Anchor",
    "BatchNormalization", "BiRecurrent", "BifurcateSplitTable", "Bilinear",
    "BinaryThreshold", "CAdd", "CMul", "Cell", "Clamp", "Contiguous",
    "ConvLSTMPeephole", "Cosine", "CosineDistance", "Cropping1D", "Cropping2D",
    "Cropping3D", "DenseToSparse", "DotProduct", "Dropout", "ELU", "Embedding",
    "Euclidean", "Exp", "Flatten", "GELU", "GRU", "GaussianDropout",
    "GaussianNoise", "GaussianSampler", "GlobalAveragePooling2D",
    "GlobalMaxPooling2D", "GradientReversal", "GroupNorm", "HardShrink",
    "HardSigmoid", "HardTanh", "Highway", "Identity", "Index", "InferReshape",
    "Input", "L1Penalty", "LSTM", "LayerNorm", "LeakyReLU", "Linear",
    "LocallyConnected1D", "LocallyConnected2D", "Log", "LogSigmoid",
    "LogSoftMax", "LookupTable", "MM", "MV", "MaskedFill", "MaskedSelect",
    "Masking", "Max", "Maxout", "Mean", "Min", "Mish", "MixtureTable", "Mul",
    "MulConstant", "MultiHeadAttention", "MultiRNNCell", "Narrow",
    "NarrowTable", "Negative", "NegativeEntropyPenalty", "Normalize", "PReLU",
    "Pack", "Padding", "PairwiseDistance", "Permute", "Power", "PriorBox",
    "RMSNorm", "RReLU", "ReLU", "ReLU6", "Recurrent", "Replicate", "Reshape",
    "ResizeBilinear", "Reverse", "RnnCell", "RoiPooling", "SELU", "SReLU",
    "Scale", "Select", "SiLU", "Sigmoid", "SoftMax", "SoftMin", "SoftPlus",
    "SoftShrink", "SoftSign", "SpatialAveragePooling",
    "SpatialBatchNormalization", "SpatialContrastiveNormalization",
    "SpatialConvolution", "SpatialConvolutionMap", "SpatialCrossMapLRN",
    "SpatialDilatedConvolution", "SpatialDivisiveNormalization",
    "SpatialDropout1D", "SpatialDropout2D", "SpatialDropout3D",
    "SpatialFullConvolution", "SpatialMaxPooling",
    "SpatialSeparableConvolution", "SpatialShareConvolution",
    "SpatialSubtractiveNormalization", "SpatialWithinChannelLRN",
    "SpatialZeroPadding", "Sqrt", "Square", "Squeeze", "Sum", "Swish", "Tanh",
    "TanhShrink", "TemporalConvolution", "TemporalMaxPooling", "Threshold",
    "Tile", "TimeDistributed", "TransformerEncoderLayer", "Transpose",
    "Unsqueeze", "UpSampling1D", "UpSampling2D", "UpSampling3D", "View",
    "VolumetricAveragePooling", "VolumetricConvolution",
    "VolumetricFullConvolution", "VolumetricMaxPooling"]
