"""The port's ``keras`` (``bigdl_tpu/keras``): the Keras-1-style user
API (ref: scala .../dllib/keras, python dllib/keras), lowered to the
port's ``nn``, ``nn.graph`` and ``optim``."""

from bigdl_tpu_torch.keras.topology import (
    Input, KerasLayer, KerasTensor, Model, Sequential)
from bigdl_tpu_torch.keras.layers import (
    Activation, AveragePooling1D, AveragePooling2D, BatchNormalization,
    Bidirectional, Conv2D, Convolution1D, Convolution2D, Deconvolution2D,
    Dense, Dropout, ELU, Embedding, Flatten, GRU, GlobalAveragePooling1D,
    GlobalAveragePooling2D, GlobalMaxPooling1D, GlobalMaxPooling2D,
    InputLayer, LSTM, LeakyReLU, MaxPooling1D, MaxPooling2D, Merge, PReLU,
    Permute, RepeatVector, Reshape, SeparableConvolution2D, SimpleRNN,
    ThresholdedReLU, TimeDistributed, UpSampling1D, UpSampling2D,
    ZeroPadding1D, ZeroPadding2D, merge,
    Convolution3D, MaxPooling3D, AveragePooling3D, UpSampling3D,
    Cropping1D, Cropping2D, Highway, Masking, GaussianNoise,
    GaussianDropout, SpatialDropout2D, LocallyConnected1D)
from bigdl_tpu_torch.keras.objectives import to_criterion
from bigdl_tpu_torch.keras.optimizers import to_optim_method
from bigdl_tpu_torch.keras.metrics import to_validation_methods

__all__ = [
    "Input", "KerasLayer", "KerasTensor", "Model", "Sequential",
    "Activation", "AveragePooling1D", "AveragePooling2D",
    "BatchNormalization", "Bidirectional", "Conv2D", "Convolution1D",
    "Convolution2D", "Deconvolution2D", "Dense", "Dropout", "ELU",
    "Embedding", "Flatten", "GRU", "GlobalAveragePooling1D",
    "GlobalAveragePooling2D", "GlobalMaxPooling1D", "GlobalMaxPooling2D",
    "InputLayer", "LSTM", "LeakyReLU", "MaxPooling1D", "MaxPooling2D",
    "Merge", "PReLU", "Permute", "RepeatVector", "Reshape",
    "SeparableConvolution2D", "SimpleRNN", "ThresholdedReLU",
    "TimeDistributed", "UpSampling1D", "UpSampling2D", "ZeroPadding1D",
    "Convolution3D", "MaxPooling3D", "AveragePooling3D", "UpSampling3D",
    "Cropping1D", "Cropping2D", "Highway", "Masking", "GaussianNoise",
    "GaussianDropout", "SpatialDropout2D", "LocallyConnected1D",
    "ZeroPadding2D", "merge", "to_criterion", "to_optim_method",
    "to_validation_methods",
]
