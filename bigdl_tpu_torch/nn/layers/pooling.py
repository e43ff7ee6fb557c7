"""Pooling layers — the port of ``bigdl_tpu/nn/layers/pooling.py`` (ref:
.../nn/SpatialMaxPooling.scala, SpatialAveragePooling.scala,
TemporalMaxPooling.scala, VolumetricMaxPooling.scala).

The JAX layers are ``lax.reduce_window`` over explicitly padded windows:
``-inf`` padding for max, zeros for the sum. Here the same pads (SAME
and ``ceil_mode`` from :func:`pool_pads`, the JAX ``_pool_pads``) go in
with ``F.pad`` and the pool itself runs unpadded (``F.max_pool2d`` /
``F.avg_pool2d``), so an asymmetric split — ResNet's 3x3/2 max-pool on
112 pads 0 on top and 1 below — windows as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.layers.conv import from_nchw, same_pads, to_nchw
from bigdl_tpu_torch.nn.module import TensorModule


def pool_pads(ih, iw, kh, kw, dh, dw, pad_h, pad_w, ceil_mode):
    """``((top, bottom), (left, right))``: SAME (pad -1), or the given
    pads with ``ceil_mode``'s extra rows / columns at the high side."""
    if pad_h == -1 or pad_w == -1:
        return same_pads(ih, kh, dh), same_pads(iw, kw, dw)
    extra_h = extra_w = 0
    if ceil_mode:
        extra_h = (-(-(ih + 2 * pad_h - kh) // dh)
                   - (ih + 2 * pad_h - kh) // dh) * dh
        extra_w = (-(-(iw + 2 * pad_w - kw) // dw)
                   - (iw + 2 * pad_w - kw) // dw) * dw
    return (pad_h, pad_h + extra_h), (pad_w, pad_w + extra_w)


def _padded(x, pads, value):
    (t, b), (l, r) = pads
    return F.pad(x, (l, r, t, b), value=value) if t or b or l or r else x


class SpatialMaxPooling(TensorModule):
    """ref: nn/SpatialMaxPooling.scala. pad=-1 → SAME; ceil_mode pads up
    on the high side."""

    def __init__(self, kw: int, kh: int, dw: Optional[int] = None,
                 dh: Optional[int] = None, pad_w: int = 0, pad_h: int = 0,
                 format: str = "NCHW", ceil_mode: bool = False,
                 name: Optional[str] = None):
        super().__init__(name)
        self.kw, self.kh = kw, kh
        self.dw, self.dh = dw or kw, dh or kh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.format = format
        self.ceil_mode = ceil_mode

    def ceil(self):
        self.ceil_mode = True
        return self

    def forward(self, x):
        x = to_nchw(x, self.format)
        pads = pool_pads(x.shape[2], x.shape[3], self.kh, self.kw, self.dh,
                         self.dw, self.pad_h, self.pad_w, self.ceil_mode)
        y = F.max_pool2d(_padded(x, pads, float("-inf")),
                         (self.kh, self.kw), (self.dh, self.dw))
        return from_nchw(y, self.format)


class SpatialAveragePooling(TensorModule):
    """ref: nn/SpatialAveragePooling.scala (count_include_pad default true)."""

    def __init__(self, kw: int, kh: int, dw: Optional[int] = None,
                 dh: Optional[int] = None, pad_w: int = 0, pad_h: int = 0,
                 global_pooling: bool = False, ceil_mode: bool = False,
                 count_include_pad: bool = True, divide: bool = True,
                 format: str = "NCHW", name: Optional[str] = None):
        super().__init__(name)
        self.kw, self.kh = kw, kh
        self.dw, self.dh = dw or kw, dh or kh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.global_pooling = global_pooling
        self.ceil_mode = ceil_mode
        self.count_include_pad = count_include_pad
        self.divide = divide
        self.format = format

    def ceil(self):
        self.ceil_mode = True
        return self

    def forward(self, x):
        x = to_nchw(x, self.format)
        kh, kw, dh, dw = self.kh, self.kw, self.dh, self.dw
        if self.global_pooling:
            kh, kw, dh, dw = x.shape[2], x.shape[3], 1, 1
        pads = pool_pads(x.shape[2], x.shape[3], kh, kw, dh, dw,
                         self.pad_h, self.pad_w, self.ceil_mode)
        # the mean over the whole (padded) window: the window sum / k
        y = F.avg_pool2d(_padded(x, pads, 0.0), (kh, kw), (dh, dw))
        if not self.divide:
            y = y * (kh * kw)
        elif not self.count_include_pad:
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                              device=x.device)
            counts = F.avg_pool2d(_padded(ones, pads, 0.0), (kh, kw),
                                  (dh, dw)) * (kh * kw)
            y = y * (kh * kw) / torch.clamp(counts, min=1.0)
        return from_nchw(y, self.format)


class TemporalMaxPooling(TensorModule):
    """1-D max pooling over (B, T, C) (ref: nn/TemporalMaxPooling.scala)."""

    def __init__(self, k_w: int, d_w: Optional[int] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.k_w = k_w
        self.d_w = d_w or k_w

    def forward(self, x):
        return F.max_pool1d(x.transpose(1, 2), self.k_w,
                            self.d_w).transpose(1, 2)


class GlobalAveragePooling2D(TensorModule):
    def __init__(self, format: str = "NCHW", keep_dims: bool = False,
                 name: Optional[str] = None):
        super().__init__(name)
        self.format = format
        self.keep_dims = keep_dims

    def forward(self, x):
        dims = (2, 3) if self.format == "NCHW" else (1, 2)
        return x.mean(dim=dims, keepdim=self.keep_dims)


class GlobalMaxPooling2D(TensorModule):
    def __init__(self, format: str = "NCHW", name: Optional[str] = None):
        super().__init__(name)
        self.format = format

    def forward(self, x):
        return x.amax(dim=(2, 3) if self.format == "NCHW" else (1, 2))


class VolumetricMaxPooling(TensorModule):
    """3-D max pooling, NCDHW (ref: nn/VolumetricMaxPooling.scala)."""

    def __init__(self, kt: int, kw: int, kh: int, dt: Optional[int] = None,
                 dw: Optional[int] = None, dh: Optional[int] = None,
                 pad_t: int = 0, pad_w: int = 0, pad_h: int = 0,
                 name: Optional[str] = None):
        super().__init__(name)
        self.k = (kt, kh, kw)
        self.d = (dt or kt, dh or kh, dw or kw)
        self.p = (pad_t, pad_h, pad_w)

    def forward(self, x):
        pt, ph, pw = self.p
        x = F.pad(x, (pw, pw, ph, ph, pt, pt), value=float("-inf"))
        return F.max_pool3d(x, self.k, self.d)
