"""Shape-manipulation layers — the port of ``bigdl_tpu/nn/layers/
shape.py`` (ref: .../nn/Reshape.scala, View.scala, Squeeze.scala,
Unsqueeze.scala, Transpose.scala, Select.scala, Narrow.scala,
Padding.scala, SpatialZeroPadding.scala, Replicate.scala, ...). Dims
follow the reference's 1-based convention where the reference uses it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import TensorModule


class Reshape(TensorModule):
    """ref: nn/Reshape.scala — size excludes batch when batch_mode."""

    def __init__(self, size: Sequence[int], batch_mode: Optional[bool] = True,
                 name: Optional[str] = None):
        super().__init__(name)
        self.size = tuple(int(s) for s in size)
        self.batch_mode = batch_mode

    def forward(self, x):
        if self.batch_mode:
            return x.reshape((x.shape[0],) + self.size)
        return x.reshape(self.size)


class InferReshape(Reshape):
    """Reshape with -1 inference (ref: nn/InferReshape.scala); only the
    batch_mode default differs from Reshape."""

    def __init__(self, size: Sequence[int], batch_mode: bool = False,
                 name: Optional[str] = None):
        super().__init__(size, batch_mode, name)


class View(TensorModule):
    def __init__(self, *sizes, name: Optional[str] = None):
        super().__init__(name)
        if len(sizes) == 1 and isinstance(sizes[0], (tuple, list)):
            sizes = tuple(sizes[0])
        self.sizes = tuple(int(s) for s in sizes)
        self.num_input_dims = 0

    def set_num_input_dims(self, n):
        self.num_input_dims = n
        return self

    def forward(self, x):
        return x.reshape((x.shape[0],) + self.sizes) \
            if x.dim() > len(self.sizes) else x.reshape(self.sizes)


class Flatten(TensorModule):
    """Keras-style flatten to (B, -1)."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class Squeeze(TensorModule):
    def __init__(self, dim: Optional[int] = None, num_input_dims: int = 0,
                 name: Optional[str] = None):
        super().__init__(name)
        self.d = dim

    def forward(self, x):
        return torch.squeeze(x) if self.d is None \
            else torch.squeeze(x, self.d - 1)


class Unsqueeze(TensorModule):
    def __init__(self, pos: int, num_input_dims: int = 0,
                 name: Optional[str] = None):
        super().__init__(name)
        self.pos = pos

    def forward(self, x):
        return torch.unsqueeze(x, self.pos - 1)


class Transpose(TensorModule):
    """Sequence of 1-based dim swaps (ref: nn/Transpose.scala)."""

    def __init__(self, permutations: Sequence[Sequence[int]],
                 name: Optional[str] = None):
        super().__init__(name)
        self.permutations = [tuple(p) for p in permutations]

    def forward(self, x):
        for d1, d2 in self.permutations:
            x = x.transpose(d1 - 1, d2 - 1)
        return x


class Permute(TensorModule):
    """Keras-style permute of non-batch dims (1-based)."""

    def __init__(self, dims: Sequence[int], name: Optional[str] = None):
        super().__init__(name)
        self.dims = tuple(dims)

    def forward(self, x):
        return x.permute((0,) + self.dims)


class Contiguous(TensorModule):
    def forward(self, x):
        return x


class Select(TensorModule):
    """Select index along dim, both 1-based; negatives allowed (ref: Select.scala)."""

    def __init__(self, dim: int, index: int, name: Optional[str] = None):
        super().__init__(name)
        self.d, self.index = dim, index

    def forward(self, x):
        d = self.d - 1 if self.d > 0 else x.dim() + self.d
        i = self.index - 1 if self.index > 0 else x.shape[d] + self.index
        return x.select(d, i)


class Narrow(TensorModule):
    """Slice [offset, offset+length) along dim, 1-based (ref: Narrow.scala)."""

    def __init__(self, dimension: int, offset: int, length: int = 1,
                 name: Optional[str] = None):
        super().__init__(name)
        self.dimension, self.offset, self.length = dimension, offset, length

    def forward(self, x):
        d = self.dimension - 1 if self.dimension > 0 \
            else x.dim() + self.dimension
        start = self.offset - 1 if self.offset > 0 \
            else x.shape[d] + self.offset
        length = self.length if self.length > 0 else \
            x.shape[d] - start + self.length + 1
        return x.narrow(d, start, length)


def _pad_dim(x, d, lo, hi, value=0.0):
    pad = [0, 0] * x.dim()
    pad[2 * (x.dim() - 1 - d)] = lo
    pad[2 * (x.dim() - 1 - d) + 1] = hi
    return F.pad(x, pad, value=value)


class Padding(TensorModule):
    """Pad dim with value (ref: nn/Padding.scala). pad<0 → before, >0 → after."""

    def __init__(self, dim: int, pad: int, n_input_dim: int = 0,
                 value: float = 0.0, n_index: int = 1,
                 name: Optional[str] = None):
        super().__init__(name)
        self.d, self.pad, self.value = dim, pad, value
        self.n_input_dim = n_input_dim

    def forward(self, x):
        d = self.d - 1
        if self.n_input_dim and x.dim() > self.n_input_dim:
            d += x.dim() - self.n_input_dim
        lo, hi = (-self.pad, 0) if self.pad < 0 else (0, self.pad)
        return _pad_dim(x, d, lo, hi, self.value)


class SpatialZeroPadding(TensorModule):
    def __init__(self, pad_left: int, pad_right: Optional[int] = None,
                 pad_top: Optional[int] = None, pad_bottom: Optional[int] = None,
                 format: str = "NCHW", name: Optional[str] = None):
        super().__init__(name)
        self.l = pad_left
        self.r = pad_left if pad_right is None else pad_right
        self.t = pad_left if pad_top is None else pad_top
        self.b = pad_left if pad_bottom is None else pad_bottom
        self.format = format

    def forward(self, x):
        h = 2 if self.format == "NCHW" else 1
        return _pad_dim(_pad_dim(x, h, self.t, self.b), h + 1, self.l,
                        self.r)


class Replicate(TensorModule):
    """Insert new dim of size n at position dim (ref: nn/Replicate.scala)."""

    def __init__(self, n_features: int, dim: int = 1, n_dim: int = 0,
                 name: Optional[str] = None):
        super().__init__(name)
        self.n_features, self.d = n_features, dim

    def forward(self, x):
        y = torch.unsqueeze(x, self.d - 1)
        reps = [1] * y.dim()
        reps[self.d - 1] = self.n_features
        return y.repeat(reps)


class Masking(TensorModule):
    """Zero timesteps equal to mask_value (ref: keras Masking)."""

    def __init__(self, mask_value: float = 0.0, name: Optional[str] = None):
        super().__init__(name)
        self.mask_value = mask_value

    def forward(self, x):
        keep = torch.any(x != self.mask_value, dim=-1, keepdim=True)
        return torch.where(keep, x, torch.zeros_like(x))


class UpSampling2D(TensorModule):
    """Nearest-neighbour upsampling (ref: nn/UpSampling2D.scala)."""

    def __init__(self, size: Sequence[int] = (2, 2), format: str = "NCHW",
                 name: Optional[str] = None):
        super().__init__(name)
        self.size = tuple(size)
        self.format = format

    def forward(self, x):
        sh, sw = self.size
        h = 2 if self.format == "NCHW" else 1
        return x.repeat_interleave(sh, dim=h).repeat_interleave(sw,
                                                                dim=h + 1)


class UpSampling1D(TensorModule):
    def __init__(self, length: int = 2, name: Optional[str] = None):
        super().__init__(name)
        self.length = length

    def forward(self, x):
        return x.repeat_interleave(self.length, dim=1)
