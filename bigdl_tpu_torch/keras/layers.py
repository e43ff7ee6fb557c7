"""Keras-1-style layers — the port of ``bigdl_tpu/keras/layers.py``
(ref: scala .../keras layers, python dllib/keras), each lowered to the
port's ``nn`` modules. Channels-first ('th') image layout; shapes
exclude the batch. Each layer implements ``build_module`` and
``compute_output_shape``, and the shape it computes is the one its
module gives.

``border_mode="same"`` builds ``SpatialConvolution(pad=-1)``: XLA's
SAME, whose stride-2 windows pad one more row and column below and to
the right (``nn/layers/conv.py``). ``Convolution2D`` passes ``(nb_col,
nb_row)`` as (kW, kH), as the JAX layer does.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.keras.topology import KerasLayer, KerasTensor, Shape
from bigdl_tpu_torch.nn.layers.conv import same_pads

_ACTIVATIONS = {
    "relu": nn.ReLU, "tanh": nn.Tanh, "sigmoid": nn.Sigmoid,
    "hard_sigmoid": nn.HardSigmoid, "softmax": nn.SoftMax,
    "log_softmax": nn.LogSoftMax, "softplus": nn.SoftPlus,
    "softsign": nn.SoftSign, "elu": nn.ELU, "selu": nn.SELU,
    "gelu": nn.GELU, "swish": nn.Swish, "silu": nn.SiLU, "mish": nn.Mish,
    "exp": nn.Exp, "linear": nn.Identity, "relu6": nn.ReLU6,
}


def activation_module(name: str) -> nn.Module:
    if name not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r}; "
                         f"known: {sorted(_ACTIVATIONS)}")
    return _ACTIVATIONS[name]()


def _maybe_activate(mod: nn.Module, activation: Optional[str]) -> nn.Module:
    if activation is None or activation == "linear":
        return mod
    return nn.Sequential().add(mod).add(activation_module(activation))


def _conv_len(n: int, k: int, s: int, border_mode: str) -> int:
    if border_mode == "same":
        return -(-n // s)
    return (n - k) // s + 1


class InputLayer(KerasLayer):
    def build_module(self, input_shape):
        return nn.Identity()

    def compute_output_shape(self, input_shape):
        return input_shape


class Dense(KerasLayer):
    """ref: keras Dense → nn.Linear (+ activation)."""

    def __init__(self, output_dim: int, activation: Optional[str] = None,
                 bias: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.output_dim = output_dim
        self.activation = activation
        self.bias = bias

    def build_module(self, input_shape):
        mod = nn.Linear(input_shape[-1], self.output_dim,
                        with_bias=self.bias)
        return _maybe_activate(mod, self.activation)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[:-1]) + (self.output_dim,)


class Activation(KerasLayer):
    def __init__(self, activation: str, **kwargs):
        super().__init__(**kwargs)
        self.activation = activation

    def build_module(self, input_shape):
        return activation_module(self.activation)

    def compute_output_shape(self, input_shape):
        return input_shape


class Dropout(KerasLayer):
    def __init__(self, p: float, **kwargs):
        super().__init__(**kwargs)
        self.p = p

    def build_module(self, input_shape):
        return nn.Dropout(self.p)

    def compute_output_shape(self, input_shape):
        return input_shape


class Flatten(KerasLayer):
    def build_module(self, input_shape):
        return nn.Flatten()

    def compute_output_shape(self, input_shape):
        n = 1
        for s in input_shape:
            n *= s
        return (n,)


class Reshape(KerasLayer):
    def __init__(self, target_shape: Shape, **kwargs):
        super().__init__(**kwargs)
        self.target_shape = tuple(target_shape)

    def build_module(self, input_shape):
        return nn.Reshape(list(self.target_shape))

    def compute_output_shape(self, input_shape):
        if -1 in self.target_shape:
            n = 1
            for s in input_shape:
                n *= s
            known = 1
            for s in self.target_shape:
                if s != -1:
                    known *= s
            return tuple(n // known if s == -1 else s
                         for s in self.target_shape)
        return self.target_shape


class Permute(KerasLayer):
    """dims are 1-based over the non-batch axes (keras semantics)."""

    def __init__(self, dims: Sequence[int], **kwargs):
        super().__init__(**kwargs)
        self.dims = tuple(dims)

    def build_module(self, input_shape):
        return nn.Permute(list(self.dims))

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[d - 1] for d in self.dims)


class RepeatVector(KerasLayer):
    def __init__(self, n: int, **kwargs):
        super().__init__(**kwargs)
        self.n = n

    def build_module(self, input_shape):
        return nn.Replicate(self.n, dim=2)

    def compute_output_shape(self, input_shape):
        return (self.n,) + tuple(input_shape)


class Convolution2D(KerasLayer):
    """ref: keras Convolution2D (th layout) → nn.SpatialConvolution."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation: Optional[str] = None,
                 border_mode: str = "valid",
                 subsample: Tuple[int, int] = (1, 1),
                 bias: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.nb_filter, self.nb_row, self.nb_col = nb_filter, nb_row, nb_col
        self.activation = activation
        self.border_mode = border_mode
        self.subsample = tuple(subsample)
        self.bias = bias

    def build_module(self, input_shape):
        c = input_shape[0]
        pad = -1 if self.border_mode == "same" else 0
        mod = nn.SpatialConvolution(
            c, self.nb_filter, self.nb_col, self.nb_row,
            self.subsample[1], self.subsample[0], pad, pad,
            with_bias=self.bias)
        return _maybe_activate(mod, self.activation)

    def compute_output_shape(self, input_shape):
        _, h, w = input_shape
        return (self.nb_filter,
                _conv_len(h, self.nb_row, self.subsample[0],
                          self.border_mode),
                _conv_len(w, self.nb_col, self.subsample[1],
                          self.border_mode))


Conv2D = Convolution2D


class Deconvolution2D(KerasLayer):
    """ref: keras Deconvolution2D → nn.SpatialFullConvolution."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation: Optional[str] = None,
                 subsample: Tuple[int, int] = (1, 1), **kwargs):
        super().__init__(**kwargs)
        self.nb_filter, self.nb_row, self.nb_col = nb_filter, nb_row, nb_col
        self.activation = activation
        self.subsample = tuple(subsample)

    def build_module(self, input_shape):
        mod = nn.SpatialFullConvolution(
            input_shape[0], self.nb_filter, self.nb_col, self.nb_row,
            self.subsample[1], self.subsample[0])
        return _maybe_activate(mod, self.activation)

    def compute_output_shape(self, input_shape):
        _, h, w = input_shape
        return (self.nb_filter,
                (h - 1) * self.subsample[0] + self.nb_row,
                (w - 1) * self.subsample[1] + self.nb_col)


class SeparableConvolution2D(KerasLayer):
    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation: Optional[str] = None,
                 depth_multiplier: int = 1,
                 subsample: Tuple[int, int] = (1, 1), **kwargs):
        super().__init__(**kwargs)
        self.nb_filter, self.nb_row, self.nb_col = nb_filter, nb_row, nb_col
        self.activation = activation
        self.depth_multiplier = depth_multiplier
        self.subsample = tuple(subsample)

    def build_module(self, input_shape):
        mod = nn.SpatialSeparableConvolution(
            input_shape[0], self.nb_filter, self.depth_multiplier,
            self.nb_col, self.nb_row, self.subsample[1], self.subsample[0])
        return _maybe_activate(mod, self.activation)

    def compute_output_shape(self, input_shape):
        _, h, w = input_shape
        return (self.nb_filter,
                _conv_len(h, self.nb_row, self.subsample[0], "valid"),
                _conv_len(w, self.nb_col, self.subsample[1], "valid"))


class Convolution1D(KerasLayer):
    """ref: keras Convolution1D → nn.TemporalConvolution on (B, T, C)."""

    def __init__(self, nb_filter: int, filter_length: int,
                 activation: Optional[str] = None,
                 subsample_length: int = 1, **kwargs):
        super().__init__(**kwargs)
        self.nb_filter = nb_filter
        self.filter_length = filter_length
        self.activation = activation
        self.subsample_length = subsample_length

    def build_module(self, input_shape):
        mod = nn.TemporalConvolution(
            input_shape[-1], self.nb_filter, self.filter_length,
            self.subsample_length)
        return _maybe_activate(mod, self.activation)

    def compute_output_shape(self, input_shape):
        t, _ = input_shape
        return (_conv_len(t, self.filter_length, self.subsample_length,
                          "valid"), self.nb_filter)


class MaxPooling2D(KerasLayer):
    def __init__(self, pool_size: Tuple[int, int] = (2, 2),
                 strides: Optional[Tuple[int, int]] = None,
                 border_mode: str = "valid", **kwargs):
        super().__init__(**kwargs)
        self.pool_size = tuple(pool_size)
        self.strides = tuple(strides) if strides else self.pool_size
        self.border_mode = border_mode

    def _mod_cls(self):
        return nn.SpatialMaxPooling

    def build_module(self, input_shape):
        pad = -1 if self.border_mode == "same" else 0
        return self._mod_cls()(
            self.pool_size[1], self.pool_size[0],
            self.strides[1], self.strides[0], pad, pad)

    def compute_output_shape(self, input_shape):
        c, h, w = input_shape
        return (c,
                _conv_len(h, self.pool_size[0], self.strides[0],
                          self.border_mode),
                _conv_len(w, self.pool_size[1], self.strides[1],
                          self.border_mode))


class AveragePooling2D(MaxPooling2D):
    def _mod_cls(self):
        return nn.SpatialAveragePooling


class MaxPooling1D(KerasLayer):
    def __init__(self, pool_length: int = 2, stride: Optional[int] = None,
                 **kwargs):
        super().__init__(**kwargs)
        self.pool_length = pool_length
        self.stride = stride or pool_length

    def build_module(self, input_shape):
        return nn.TemporalMaxPooling(self.pool_length, self.stride)

    def compute_output_shape(self, input_shape):
        t, c = input_shape
        return (_conv_len(t, self.pool_length, self.stride, "valid"), c)


class AveragePooling1D(KerasLayer):
    """Composed from 2-D average pooling over a (C, 1, T) view."""

    def __init__(self, pool_length: int = 2, stride: Optional[int] = None,
                 **kwargs):
        super().__init__(**kwargs)
        self.pool_length = pool_length
        self.stride = stride or pool_length

    def build_module(self, input_shape):
        t, c = input_shape
        t_out = _conv_len(t, self.pool_length, self.stride, "valid")
        return (nn.Sequential()
                .add(nn.Transpose([(2, 3)]))       # (B, C, T)
                .add(nn.Reshape([c, 1, t]))
                .add(nn.SpatialAveragePooling(self.pool_length, 1,
                                              self.stride, 1))
                .add(nn.Reshape([c, t_out]))
                .add(nn.Transpose([(2, 3)])))      # (B, T', C)

    def compute_output_shape(self, input_shape):
        t, c = input_shape
        return (_conv_len(t, self.pool_length, self.stride, "valid"), c)


class GlobalMaxPooling2D(KerasLayer):
    def build_module(self, input_shape):
        return nn.GlobalMaxPooling2D()

    def compute_output_shape(self, input_shape):
        return (input_shape[0],)


class GlobalAveragePooling2D(KerasLayer):
    def build_module(self, input_shape):
        return nn.GlobalAveragePooling2D()

    def compute_output_shape(self, input_shape):
        return (input_shape[0],)


class GlobalMaxPooling1D(KerasLayer):
    def build_module(self, input_shape):
        # (B, T, C): max over time
        return nn.Sequential().add(nn.Transpose([(2, 3)])) \
            .add(nn.Reshape([input_shape[1], 1, input_shape[0]])) \
            .add(nn.GlobalMaxPooling2D())

    def compute_output_shape(self, input_shape):
        return (input_shape[1],)


class GlobalAveragePooling1D(KerasLayer):
    def build_module(self, input_shape):
        return nn.Sequential().add(nn.Transpose([(2, 3)])) \
            .add(nn.Reshape([input_shape[1], 1, input_shape[0]])) \
            .add(nn.GlobalAveragePooling2D())

    def compute_output_shape(self, input_shape):
        return (input_shape[1],)


class ZeroPadding2D(KerasLayer):
    def __init__(self, padding: Tuple[int, int] = (1, 1), **kwargs):
        super().__init__(**kwargs)
        self.padding = tuple(padding)

    def build_module(self, input_shape):
        ph, pw = self.padding
        return nn.SpatialZeroPadding(pw, pw, ph, ph)

    def compute_output_shape(self, input_shape):
        c, h, w = input_shape
        return (c, h + 2 * self.padding[0], w + 2 * self.padding[1])


class ZeroPadding1D(KerasLayer):
    def __init__(self, padding: int = 1, **kwargs):
        super().__init__(**kwargs)
        self.padding = padding

    def build_module(self, input_shape):
        # the JAX layer passes nn.Padding an argument it does not take
        # (``n_index_end``) and raises; this is the padding its output
        # shape states: ``padding`` zeros before and after along T
        return (nn.Sequential()
                .add(nn.Padding(1, -self.padding, n_input_dim=2))
                .add(nn.Padding(1, self.padding, n_input_dim=2)))

    def compute_output_shape(self, input_shape):
        t, c = input_shape
        return (t + 2 * self.padding, c)


class UpSampling2D(KerasLayer):
    def __init__(self, size: Tuple[int, int] = (2, 2), **kwargs):
        super().__init__(**kwargs)
        self.size = tuple(size)

    def build_module(self, input_shape):
        return nn.UpSampling2D(self.size)

    def compute_output_shape(self, input_shape):
        c, h, w = input_shape
        return (c, h * self.size[0], w * self.size[1])


class UpSampling1D(KerasLayer):
    def __init__(self, length: int = 2, **kwargs):
        super().__init__(**kwargs)
        self.length = length

    def build_module(self, input_shape):
        return nn.UpSampling1D(self.length)

    def compute_output_shape(self, input_shape):
        t, c = input_shape
        return (t * self.length, c)


class BatchNormalization(KerasLayer):
    """axis=1 (channels-first). 4-D input → SpatialBatchNormalization."""

    def __init__(self, epsilon: float = 1e-3, momentum: float = 0.99,
                 **kwargs):
        super().__init__(**kwargs)
        self.epsilon = epsilon
        self.momentum = momentum

    def build_module(self, input_shape):
        if len(input_shape) >= 3:
            return nn.SpatialBatchNormalization(
                input_shape[0], eps=self.epsilon,
                momentum=1 - self.momentum)
        return nn.BatchNormalization(input_shape[-1], eps=self.epsilon,
                                     momentum=1 - self.momentum)

    def compute_output_shape(self, input_shape):
        return input_shape


class Embedding(KerasLayer):
    def __init__(self, input_dim: int, output_dim: int,
                 input_length: Optional[int] = None, **kwargs):
        if input_length and "input_shape" not in kwargs:
            kwargs["input_shape"] = (input_length,)
        super().__init__(**kwargs)
        self.input_dim = input_dim
        self.output_dim = output_dim

    def build_module(self, input_shape):
        return nn.Embedding(self.input_dim, self.output_dim)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape) + (self.output_dim,)


class _RecurrentLayer(KerasLayer):
    def __init__(self, output_dim: int, return_sequences: bool = False,
                 go_backwards: bool = False, **kwargs):
        super().__init__(**kwargs)
        self.output_dim = output_dim
        self.return_sequences = return_sequences
        self.go_backwards = go_backwards

    def _cell(self, input_size: int) -> nn.Cell:
        raise NotImplementedError

    def build_module(self, input_shape):
        return nn.Recurrent(self._cell(input_shape[-1]),
                            return_sequences=self.return_sequences,
                            reverse=self.go_backwards)

    def compute_output_shape(self, input_shape):
        if self.return_sequences:
            return (input_shape[0], self.output_dim)
        return (self.output_dim,)


class SimpleRNN(_RecurrentLayer):
    def __init__(self, output_dim: int, activation: str = "tanh", **kwargs):
        super().__init__(output_dim, **kwargs)
        self.activation = activation

    def _cell(self, input_size):
        return nn.RnnCell(input_size, self.output_dim, self.activation)


class LSTM(_RecurrentLayer):
    def _cell(self, input_size):
        return nn.LSTM(input_size, self.output_dim)


class GRU(_RecurrentLayer):
    def _cell(self, input_size):
        return nn.GRU(input_size, self.output_dim)


class Bidirectional(KerasLayer):
    def __init__(self, layer: _RecurrentLayer, merge_mode: str = "concat",
                 **kwargs):
        super().__init__(**kwargs)
        self.layer = layer
        self.merge_mode = merge_mode

    def build_module(self, input_shape):
        fwd = self.layer._cell(input_shape[-1])
        bwd = self.layer._cell(input_shape[-1])
        bi = nn.BiRecurrent(fwd, bwd, merge=self.merge_mode)
        if self.layer.return_sequences:
            return bi
        # BiRecurrent always emits sequences; take the last timestep
        return nn.Sequential().add(bi).add(nn.Select(2, -1))

    def compute_output_shape(self, input_shape):
        d = self.layer.output_dim
        if self.merge_mode == "concat":
            d *= 2
        if self.layer.return_sequences:
            return (input_shape[0], d)
        return (d,)


class TimeDistributed(KerasLayer):
    """Apply an inner pointwise layer at every timestep. Dense and other
    last-dim layers broadcast over leading dims already, so the inner
    module is used directly (matching the reference's TimeDistributed over
    Linear)."""

    def __init__(self, layer: KerasLayer, **kwargs):
        super().__init__(**kwargs)
        self.layer = layer

    def build_module(self, input_shape):
        return self.layer.build(input_shape[1:])

    def compute_output_shape(self, input_shape):
        inner = self.layer.compute_output_shape(input_shape[1:])
        return (input_shape[0],) + tuple(inner)


class Merge(KerasLayer):
    """Multi-input merge (ref: keras Merge). Modes: concat/sum/mul/max/ave/
    dot. ``concat_axis`` counts the batch dim (keras th default 1)."""

    def __init__(self, mode: str = "concat", concat_axis: int = 1, **kwargs):
        super().__init__(**kwargs)
        self.mode = mode
        self.concat_axis = concat_axis

    def build_multi(self, input_shapes):
        self._shapes = input_shapes
        mod = {
            "sum": nn.CAddTable, "mul": nn.CMulTable, "max": nn.CMaxTable,
            "ave": nn.CAveTable, "dot": nn.DotProduct,
        }.get(self.mode)
        if self.mode == "dot":
            # the JAX layer's DotProduct drops the last dim, where its
            # output shape states (1,): the port keeps it as 1
            built = nn.Sequential().add(mod()).add(nn.Reshape(
                list(self._multi_output_shape(input_shapes))))
        elif mod is not None:
            built = mod()
        elif self.mode == "concat":
            built = nn.JoinTable(self.concat_axis + 1)
        else:
            raise ValueError(f"unknown merge mode {self.mode!r}")
        self.built_module = built
        self.output_shape = self._multi_output_shape(input_shapes)
        return built

    def _multi_output_shape(self, shapes):
        if self.mode == "concat":
            ax = self.concat_axis - 1   # shapes exclude batch
            out = list(shapes[0])
            out[ax] = sum(s[ax] for s in shapes)
            return tuple(out)
        if self.mode == "dot":
            return tuple(shapes[0][:-1]) + (1,)
        return tuple(shapes[0])


def merge(inputs, mode: str = "concat", concat_axis: int = 1):
    """Functional-API merge over KerasTensors."""
    return Merge(mode=mode, concat_axis=concat_axis)(list(inputs))


class LeakyReLU(KerasLayer):
    def __init__(self, alpha: float = 0.3, **kwargs):
        super().__init__(**kwargs)
        self.alpha = alpha

    def build_module(self, input_shape):
        return nn.LeakyReLU(self.alpha)

    def compute_output_shape(self, input_shape):
        return input_shape


class ELU(KerasLayer):
    def __init__(self, alpha: float = 1.0, **kwargs):
        super().__init__(**kwargs)
        self.alpha = alpha

    def build_module(self, input_shape):
        return nn.ELU(self.alpha)

    def compute_output_shape(self, input_shape):
        return input_shape


class PReLU(KerasLayer):
    def build_module(self, input_shape):
        return nn.PReLU()

    def compute_output_shape(self, input_shape):
        return input_shape


class ThresholdedReLU(KerasLayer):
    def __init__(self, theta: float = 1.0, **kwargs):
        super().__init__(**kwargs)
        self.theta = theta

    def build_module(self, input_shape):
        return nn.Threshold(self.theta)

    def compute_output_shape(self, input_shape):
        return input_shape


# -- the 3-D family and the other Keras-1 wrappers (ref: scala keras
# Convolution3D, MaxPooling3D, ...: the same shape contract over the
# volumetric nn layers) -------------------------------------------------------

class Convolution3D(KerasLayer):
    def __init__(self, nb_filter: int, kernel_dim1: int, kernel_dim2: int,
                 kernel_dim3: int, subsample=(1, 1, 1),
                 border_mode: str = "valid", activation=None, **kwargs):
        super().__init__(**kwargs)
        self.nb_filter = nb_filter
        self.kernel = (kernel_dim1, kernel_dim2, kernel_dim3)
        self.subsample = tuple(subsample)
        self.border_mode = border_mode
        self.activation = activation

    def build_module(self, input_shape):
        pad = -1 if self.border_mode == "same" else 0
        mod = nn.VolumetricConvolution(
            input_shape[0], self.nb_filter,
            self.kernel[0], self.kernel[2], self.kernel[1],
            self.subsample[0], self.subsample[2], self.subsample[1],
            pad, pad, pad)
        return _maybe_activate(mod, self.activation)

    def compute_output_shape(self, input_shape):
        c, d, h, w = input_shape
        return (self.nb_filter,
                _conv_len(d, self.kernel[0], self.subsample[0],
                          self.border_mode),
                _conv_len(h, self.kernel[1], self.subsample[1],
                          self.border_mode),
                _conv_len(w, self.kernel[2], self.subsample[2],
                          self.border_mode))


class MaxPooling3D(KerasLayer):
    def __init__(self, pool_size=(2, 2, 2), strides=None,
                 border_mode: str = "valid", **kwargs):
        super().__init__(**kwargs)
        self.pool_size = tuple(pool_size)
        self.strides = tuple(strides) if strides else self.pool_size
        self.border_mode = border_mode

    def _mod_cls(self):
        return nn.VolumetricMaxPooling

    _PAD_VALUE = float("-inf")

    def build_module(self, input_shape):
        # the volumetric pools take literal, symmetric pads (no -1 = SAME
        # as the spatial ones): "same" pads first as XLA's SAME does, as
        # the 2-D layers pad (where a dim's total is odd, the JAX layer's
        # symmetric ceil(total / 2) gives one more output than its shape)
        pool = self._mod_cls()(
            self.pool_size[0], self.pool_size[2], self.pool_size[1],
            self.strides[0], self.strides[2], self.strides[1])
        if self.border_mode != "same":
            return pool
        pads = [same_pads(n, k, s) for n, k, s in zip(
            input_shape[1:], self.pool_size, self.strides)]
        return nn.Sequential().add(_Pad3D(pads, self._PAD_VALUE)).add(pool)

    def compute_output_shape(self, input_shape):
        c, d, h, w = input_shape
        return (c,) + tuple(
            _conv_len(s, self.pool_size[i], self.strides[i],
                      self.border_mode)
            for i, s in enumerate((d, h, w)))


class AveragePooling3D(MaxPooling3D):
    _PAD_VALUE = 0.0      # counted in the window's size, as JAX's pads are

    def _mod_cls(self):
        return nn.VolumetricAveragePooling


class UpSampling3D(KerasLayer):
    def __init__(self, size=(2, 2, 2), **kwargs):
        super().__init__(**kwargs)
        self.size = tuple(size)

    def build_module(self, input_shape):
        return nn.UpSampling3D(self.size)

    def compute_output_shape(self, input_shape):
        c, d, h, w = input_shape
        return (c, d * self.size[0], h * self.size[1], w * self.size[2])


class Cropping1D(KerasLayer):
    def __init__(self, cropping=(1, 1), **kwargs):
        super().__init__(**kwargs)
        self.cropping = tuple(cropping)

    def build_module(self, input_shape):
        t, c = input_shape
        length = t - self.cropping[0] - self.cropping[1]
        return nn.Narrow(2, self.cropping[0] + 1, length)

    def compute_output_shape(self, input_shape):
        t, c = input_shape
        return (t - self.cropping[0] - self.cropping[1], c)


class Cropping2D(KerasLayer):
    def __init__(self, cropping=((0, 0), (0, 0)), **kwargs):
        super().__init__(**kwargs)
        self.cropping = tuple(tuple(c) for c in cropping)

    def build_module(self, input_shape):
        return nn.Cropping2D(self.cropping[0], self.cropping[1])

    def compute_output_shape(self, input_shape):
        c, h, w = input_shape
        (t, b), (l, r) = self.cropping
        return (c, h - t - b, w - l - r)


def _linear(v):
    return v


class Highway(KerasLayer):
    def __init__(self, activation: str = "tanh", **kwargs):
        super().__init__(**kwargs)
        self.activation = activation

    def build_module(self, input_shape):
        act = {"tanh": torch.tanh, "relu": torch.relu,
               "sigmoid": torch.sigmoid, "linear": _linear,
               None: torch.tanh}[self.activation]
        return nn.Highway(input_shape[-1], activation=act)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape)


class Masking(KerasLayer):
    def __init__(self, mask_value: float = 0.0, **kwargs):
        super().__init__(**kwargs)
        self.mask_value = mask_value

    def build_module(self, input_shape):
        return nn.Masking(self.mask_value)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape)


class GaussianNoise(KerasLayer):
    def __init__(self, sigma: float = 0.1, **kwargs):
        super().__init__(**kwargs)
        self.sigma = sigma

    def build_module(self, input_shape):
        return nn.GaussianNoise(self.sigma)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape)


class GaussianDropout(KerasLayer):
    def __init__(self, p: float = 0.5, **kwargs):
        super().__init__(**kwargs)
        self.p = p

    def build_module(self, input_shape):
        return nn.GaussianDropout(self.p)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape)


class SpatialDropout2D(KerasLayer):
    def __init__(self, p: float = 0.5, **kwargs):
        super().__init__(**kwargs)
        self.p = p

    def build_module(self, input_shape):
        return nn.SpatialDropout2D(self.p)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape)


class LocallyConnected1D(KerasLayer):
    def __init__(self, nb_filter: int, filter_length: int,
                 subsample_length: int = 1, activation=None, **kwargs):
        super().__init__(**kwargs)
        self.nb_filter = nb_filter
        self.filter_length = filter_length
        self.subsample_length = subsample_length
        self.activation = activation

    def build_module(self, input_shape):
        t, c = input_shape
        mod = nn.LocallyConnected1D(t, c, self.nb_filter,
                                    self.filter_length,
                                    self.subsample_length)
        return _maybe_activate(mod, self.activation)

    def compute_output_shape(self, input_shape):
        t, c = input_shape
        return (_conv_len(t, self.filter_length, self.subsample_length,
                          "valid"), self.nb_filter)


class SpatialDropout1D(KerasLayer):
    """Drops whole (B, T, C) channels (keras SpatialDropout1D)."""

    def __init__(self, p: float = 0.5, **kwargs):
        super().__init__(**kwargs)
        self.p = p

    def build_module(self, input_shape):
        return nn.SpatialDropout1D(self.p)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape)


class SpatialDropout3D(KerasLayer):
    """Drops whole 3-D volumes; input (B, C, D, H, W)."""

    def __init__(self, p: float = 0.5, **kwargs):
        super().__init__(**kwargs)
        self.p = p

    def build_module(self, input_shape):
        return nn.SpatialDropout3D(self.p, format="NCDHW")

    def compute_output_shape(self, input_shape):
        return tuple(input_shape)


class Cropping3D(KerasLayer):
    def __init__(self, cropping=((1, 1), (1, 1), (1, 1)), **kwargs):
        super().__init__(**kwargs)
        self.cropping = tuple(tuple(c) for c in cropping)

    def build_module(self, input_shape):
        return nn.Cropping3D(*self.cropping)

    def compute_output_shape(self, input_shape):
        c, d, h, w = input_shape
        (d0, d1), (h0, h1), (w0, w1) = self.cropping
        return (c, d - d0 - d1, h - h0 - h1, w - w0 - w1)


class _Pad3D(nn.TensorModule):
    """Padding of D, H and W with ``value``: ``pads`` is ((lo, hi),) x 3."""

    def __init__(self, pads, value: float = 0.0, name: Optional[str] = None):
        super().__init__(name)
        self.pads = tuple(tuple(p) for p in pads)
        self.value = value

    def forward(self, x):
        flat = [p for lo_hi in reversed(self.pads) for p in lo_hi]
        return torch.nn.functional.pad(x, flat, value=self.value)


class ZeroPadding3D(KerasLayer):
    def __init__(self, padding=(1, 1, 1), **kwargs):
        super().__init__(**kwargs)
        self.padding = tuple(padding)

    def build_module(self, input_shape):
        return _Pad3D([(p, p) for p in self.padding])

    def compute_output_shape(self, input_shape):
        c, d, h, w = input_shape
        pd, ph, pw = self.padding
        return (c, d + 2 * pd, h + 2 * ph, w + 2 * pw)


class _GMP3D(nn.TensorModule):
    """The max over D, H and W."""

    def forward(self, x):
        return torch.amax(x, dim=(2, 3, 4))


class _GAP3D(nn.TensorModule):
    """The mean over D, H and W."""

    def forward(self, x):
        return torch.mean(x, dim=(2, 3, 4))


class GlobalMaxPooling3D(KerasLayer):
    def build_module(self, input_shape):
        return _GMP3D()

    def compute_output_shape(self, input_shape):
        return (input_shape[0],)


class GlobalAveragePooling3D(KerasLayer):
    def build_module(self, input_shape):
        return _GAP3D()

    def compute_output_shape(self, input_shape):
        return (input_shape[0],)


class ActivityRegularization(KerasLayer):
    def __init__(self, l1: float = 0.0, l2: float = 0.0, **kwargs):
        super().__init__(**kwargs)
        self.l1, self.l2 = l1, l2

    def build_module(self, input_shape):
        return nn.ActivityRegularization(self.l1, self.l2)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape)


class SReLU(KerasLayer):
    def build_module(self, input_shape):
        return nn.SReLU((input_shape[-1],))

    def compute_output_shape(self, input_shape):
        return tuple(input_shape)


class LocallyConnected2D(KerasLayer):
    """Unshared 2-D convolution (keras LocallyConnected2D), NCHW."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 subsample=(1, 1), **kwargs):
        super().__init__(**kwargs)
        self.nb_filter = nb_filter
        self.kernel = (nb_row, nb_col)
        self.subsample = tuple(subsample)

    def build_module(self, input_shape):
        c, h, w = input_shape
        return nn.LocallyConnected2D(
            c, h, w, self.nb_filter, self.kernel[0], self.kernel[1],
            self.subsample[0], self.subsample[1])

    def compute_output_shape(self, input_shape):
        c, h, w = input_shape
        oh = (h - self.kernel[0]) // self.subsample[0] + 1
        ow = (w - self.kernel[1]) // self.subsample[1] + 1
        return (self.nb_filter, oh, ow)
