"""The layer zoo's tail — the port of ``bigdl_tpu/nn/layers/extra3.py``
(ref: one file a class under dllib/nn/*.scala; each class names its
own). All are PyTorch ops: the JAX file reaches no Pallas kernel.

The random layers (``SpatialDropout1D``, ``SpatialDropout3D``,
``GaussianSampler``) draw from the layer's own ``torch.Generator``
(:class:`~bigdl_tpu_torch.nn.module.Stochastic`), so they hold the JAX
layers' contract, not their ``jax.random`` bits. ``DenseToSparse``
returns the port's ``SparseTensor`` and ``Anchor`` draws its grid from
the detection module's ``generate_anchors``, as the JAX layers do.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.initialization import Xavier, init_param
from bigdl_tpu_torch.nn.layers.conv import SpatialConvolution
from bigdl_tpu_torch.nn.layers.detection import generate_anchors
from bigdl_tpu_torch.nn.layers.misc import _pair
from bigdl_tpu_torch.nn.module import RNG, Module, Stochastic, TensorModule
from bigdl_tpu_torch.tensor.sparse import SparseTensor

__all__ = [
    "ActivityRegularization", "Anchor", "BifurcateSplitTable",
    "BinaryThreshold", "Cropping1D", "DenseToSparse", "GaussianSampler",
    "HardShrink", "Input", "LogSigmoid", "MaskedSelect", "MultiRNNCell",
    "NegativeEntropyPenalty", "PriorBox", "ResizeBilinear", "RoiPooling",
    "SoftShrink", "SpatialConvolutionMap", "SpatialDropout1D",
    "SpatialDropout3D", "SpatialShareConvolution", "TanhShrink",
]


# -- elementwise activations ----------------------------------------------------

class HardShrink(TensorModule):
    """x if |x| > lambda else 0 (ref: nn/HardShrink.scala)."""

    def __init__(self, the_lambda: float = 0.5,
                 name: Optional[str] = None):
        super().__init__(name)
        self.the_lambda = the_lambda

    def forward(self, x):
        return torch.where(x.abs() > self.the_lambda, x,
                           torch.zeros_like(x))


class SoftShrink(TensorModule):
    """sign(x) * max(|x| - lambda, 0) (ref: nn/SoftShrink.scala)."""

    def __init__(self, the_lambda: float = 0.5,
                 name: Optional[str] = None):
        super().__init__(name)
        self.the_lambda = the_lambda

    def forward(self, x):
        return torch.sign(x) * torch.clamp(x.abs() - self.the_lambda,
                                           min=0.0)


class TanhShrink(TensorModule):
    """x - tanh(x) (ref: nn/TanhShrink.scala)."""

    def forward(self, x):
        return x - torch.tanh(x)


class LogSigmoid(TensorModule):
    """log(sigmoid(x)), stable (ref: nn/LogSigmoid.scala)."""

    def forward(self, x):
        return F.logsigmoid(x)


class BinaryThreshold(TensorModule):
    """1 where x > th, else 0 (ref: nn/BinaryThreshold.scala)."""

    def __init__(self, th: float = 1e-6, name: Optional[str] = None):
        super().__init__(name)
        self.th = th

    def forward(self, x):
        return (x > self.th).to(x.dtype)


# -- dropout family ---------------------------------------------------------------

class SpatialDropout1D(Stochastic, TensorModule):
    """Drops whole channels of (B, T, C) sequences (ref:
    nn/SpatialDropout1D.scala)."""

    def __init__(self, init_p: float = 0.5,
                 generator: Optional[torch.Generator] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.p = init_p
        self.generator = generator

    def forward(self, x):
        if not self.training or self.p <= 0.0:
            return x
        keep = 1.0 - self.p
        mask = self._rand((x.shape[0], 1, x.shape[2]), x) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class SpatialDropout3D(Stochastic, TensorModule):
    """Drops whole 3-D feature volumes (ref: nn/SpatialDropout3D.scala).
    ``format``: "NCDHW" (the reference's default) or "NDHWC"."""

    def __init__(self, init_p: float = 0.5, format: str = "NCDHW",
                 generator: Optional[torch.Generator] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.p = init_p
        if format not in ("NCDHW", "NDHWC"):
            raise ValueError(format)
        self.format = format
        self.generator = generator

    def forward(self, x):
        if not self.training or self.p <= 0.0:
            return x
        keep = 1.0 - self.p
        shape = (x.shape[0], x.shape[1], 1, 1, 1) if self.format == "NCDHW" \
            else (x.shape[0], 1, 1, 1, x.shape[4])
        mask = self._rand(shape, x) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


# -- penalty / regularization identities ---------------------------------------------

class NegativeEntropyPenalty(TensorModule):
    """Identity forward; the penalty beta * sum(p * log p) pushes a
    probability activity toward high entropy (ref:
    nn/NegativeEntropyPenalty.scala). A training forward records it in
    ``last_penalty`` (detached); a step adds :meth:`penalty_of` to its
    loss, as with ``L1Penalty``."""

    def __init__(self, beta: float = 0.01, name: Optional[str] = None):
        super().__init__(name)
        self.beta = beta
        self.last_penalty = 0.0

    def penalty_of(self, p):
        return self.beta * torch.sum(p * torch.log(torch.clamp(p, min=1e-12)))

    def forward(self, x):
        if self.training:
            self.last_penalty = self.penalty_of(x.detach())
        return x


class ActivityRegularization(TensorModule):
    """Identity forward; the penalty l1 * sum|x| + l2 * sum(x^2) (ref:
    the keras-lineage nn/ActivityRegularization.scala), recorded as
    :class:`NegativeEntropyPenalty` records its own."""

    def __init__(self, l1: float = 0.0, l2: float = 0.0,
                 name: Optional[str] = None):
        super().__init__(name)
        self.l1, self.l2 = l1, l2
        self.last_penalty = 0.0

    def penalty_of(self, x):
        return self.l1 * torch.sum(x.abs()) + self.l2 * torch.sum(x * x)

    def forward(self, x):
        if self.training:
            self.last_penalty = self.penalty_of(x.detach())
        return x


# -- shape / table utilities -------------------------------------------------------

class Cropping1D(TensorModule):
    """Crop (B, T, C) along T (ref: keras-lineage nn/Cropping1D)."""

    def __init__(self, crop_left: int = 1, crop_right: int = 1,
                 name: Optional[str] = None):
        super().__init__(name)
        self.crop = (crop_left, crop_right)

    def forward(self, x):
        lo, hi = self.crop
        return x[:, lo:x.shape[1] - hi]


class BifurcateSplitTable(Module):
    """Split a tensor in two halves along the 1-based ``dimension``: a
    list of two (ref: nn/BifurcateSplitTable.scala)."""

    def __init__(self, dimension: int = 1, name: Optional[str] = None):
        super().__init__(name)
        self.dimension = dimension

    def forward(self, x):
        d = self.dimension - 1
        half = x.shape[d] // 2
        return [x.narrow(d, 0, half), x.narrow(d, half, x.shape[d] - half)]


class MaskedSelect(Module):
    """Table(x, mask) → the 1-D tensor of x's elements where the mask is
    set (ref: nn/MaskedSelect.scala). Its length depends on the mask's
    values: the JAX layer is eager-only, and so is this one (it cannot
    run inside a captured CUDA graph)."""

    def forward(self, x):
        t, mask = _pair(x)
        return t[mask.to(torch.bool)]


class DenseToSparse(Module):
    """Dense tensor → :class:`~bigdl_tpu_torch.tensor.sparse.SparseTensor`
    (ref: nn/DenseToSparse.scala), the non-zeros in row-major order as the
    JAX layer gives them. Eager-only, as ``MaskedSelect``."""

    def forward(self, x):
        return SparseTensor.from_dense(x)


class GaussianSampler(Stochastic, Module):
    """VAE reparameterization: Table(mean, log_var) → mean +
    exp(log_var / 2) * eps (ref: nn/GaussianSampler.scala); eps is drawn
    in train and eval mode, as in the JAX layer."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.generator = generator

    def forward(self, x):
        mean, log_var = _pair(x)
        eps = self._rand(mean.shape, mean, normal=True)
        return mean + torch.exp(log_var * 0.5) * eps.to(mean.dtype)


class Input(TensorModule):
    """The identity, a graph's entry module (ref: nn/Input.scala)."""

    def forward(self, x):
        return x


# -- vision -------------------------------------------------------------------------

def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """``jax.image.resize``'s bilinear weight matrix for one axis, (in,
    out): a triangle kernel, widened by the scale when shrinking
    (antialias, on by default there), each output's weights normalised,
    outputs whose sample falls outside the input zeroed
    (``jax/_src/image/scale.py`` ``compute_weight_mat``, translation 0)."""
    scale = n_out / n_in
    inv = 1.0 / scale
    kscale = max(inv, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * inv - 0.5
    dist = (sample[None, :] - torch.arange(
        n_in, dtype=torch.float32, device=device)[:, None]).abs() / kscale
    w = torch.clamp(1.0 - dist, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


class ResizeBilinear(TensorModule):
    """Bilinear resize to (out_height, out_width) (ref:
    nn/ResizeBilinear.scala), NCHW or NHWC. Without ``align_corners`` it
    is ``jax.image.resize(..., "bilinear")`` — half-pixel centres, and
    when it shrinks a triangle filter widened by the scale (its
    ``antialias`` is on by default): the two axes' weight matrices
    (:func:`_resize_weights`) applied in the input's dtype. With
    ``align_corners`` the JAX layer's explicit gather and lerp over the
    inclusive grid, in f32."""

    def __init__(self, out_height: int, out_width: int,
                 align_corners: bool = False, format: str = "NCHW",
                 name: Optional[str] = None):
        super().__init__(name)
        self.out = (out_height, out_width)
        self.align_corners = align_corners
        self.format = format

    @staticmethod
    def _lerp_axis(x, axis: int, out_size: int):
        """align-corners linear interpolation along one axis: output i
        samples src = i * (S - 1) / (out - 1), so corner pixels map to
        corner pixels."""
        s = x.shape[axis]
        if out_size == 1 or s == 1:
            idx = torch.zeros(out_size, dtype=torch.int64, device=x.device)
            return torch.index_select(x, axis, idx)
        src = torch.arange(out_size, dtype=torch.float32,
                           device=x.device) * ((s - 1.0) / (out_size - 1.0))
        lo = torch.clamp(torch.floor(src).to(torch.int64), 0, s - 1)
        hi = torch.clamp(lo + 1, 0, s - 1)
        shape = [1] * x.dim()
        shape[axis] = out_size
        w = (src - lo.to(torch.float32)).reshape(shape)
        xl = torch.index_select(x, axis, lo).to(torch.float32)
        xh = torch.index_select(x, axis, hi).to(torch.float32)
        return xl * (1.0 - w) + xh * w

    def forward(self, x):
        oh, ow = self.out
        hax, wax = (2, 3) if self.format == "NCHW" else (1, 2)
        if self.align_corners:
            y = self._lerp_axis(x, hax, oh)
            return self._lerp_axis(y, wax, ow).to(x.dtype)
        wh = _resize_weights(x.shape[hax], oh, x.device).to(x.dtype)
        ww = _resize_weights(x.shape[wax], ow, x.device).to(x.dtype)
        if self.format == "NCHW":
            return torch.einsum("bchw,hi,wj->bcij", x, wh, ww)
        return torch.einsum("bhwc,hi,wj->bijc", x, wh, ww)


class RoiPooling(Module):
    """Quantized max-pool ROI pooling (ref: nn/RoiPooling.scala, the
    Fast-RCNN pooler). Activity: Table(features (B, H, W, C), rois (N,
    5) [batch_idx, x1, y1, x2, y2]) → (N, P, P, C); an empty bin is 0."""

    def __init__(self, pooled_h: int = 7, pooled_w: int = 7,
                 spatial_scale: float = 1.0, name: Optional[str] = None):
        super().__init__(name)
        self.pooled = (pooled_h, pooled_w)
        self.spatial_scale = spatial_scale

    def forward(self, x):
        feats, rois = _pair(x)
        _, h, w, _ = feats.shape
        ph, pw = self.pooled
        dev = feats.device
        fb = feats[rois[:, 0].to(torch.int64)]                # (N, H, W, C)
        boxes = rois[:, 1:].to(torch.float32) * self.spatial_scale
        x1, y1, x2, y2 = (boxes[:, i:i + 1] for i in range(4))  # (N, 1)
        bw = torch.clamp(x2 - x1 + 1.0, min=1.0)
        bh = torch.clamp(y2 - y1 + 1.0, min=1.0)
        ys = torch.arange(h, dtype=torch.float32, device=dev)[None]
        xs = torch.arange(w, dtype=torch.float32, device=dev)[None]
        yb = torch.floor((ys - y1) * ph / bh)
        xb = torch.floor((xs - x1) * pw / bw)
        yb = torch.where((ys >= torch.floor(y1)) & (ys <= torch.ceil(y2)),
                         torch.clamp(yb, 0, ph - 1), torch.full_like(yb, -1.))
        xb = torch.where((xs >= torch.floor(x1)) & (xs <= torch.ceil(x2)),
                         torch.clamp(xb, 0, pw - 1), torch.full_like(xb, -1.))
        ymask = yb[:, None, :] == torch.arange(
            ph, dtype=torch.float32, device=dev)[None, :, None]  # (N, ph, H)
        xmask = xb[:, None, :] == torch.arange(
            pw, dtype=torch.float32, device=dev)[None, :, None]  # (N, pw, W)
        m = ymask[:, :, None, :, None] & xmask[:, None, :, None, :]
        vals = torch.where(m[..., None], fb[:, None, None],
                           torch.full((), -float("inf"), dtype=fb.dtype,
                                      device=dev))
        out = torch.amax(vals, dim=(3, 4))                    # (N, ph, pw, C)
        return torch.where(torch.isfinite(out), out,
                           torch.zeros_like(out)).to(feats.dtype)


class SpatialShareConvolution(SpatialConvolution):
    """ref: nn/SpatialShareConvolution.scala — the reference's variant
    that shares im2col buffers across a minibatch; the math, and this
    class, are ``SpatialConvolution``'s."""


class SpatialConvolutionMap(TensorModule):
    """Convolution over an explicit input → output connection table
    (ref: nn/SpatialConvolutionMap.scala). ``conn_table`` is (K, 2) of
    1-based (in_plane, out_plane) pairs: one dense conv whose kernel is
    masked to the table, as in the JAX layer. The mask is a constant of
    the layer, not a state."""

    def __init__(self, conn_table, kernel_w: int, kernel_h: int,
                 stride_w: int = 1, stride_h: int = 1,
                 pad_w: int = 0, pad_h: int = 0,
                 name: Optional[str] = None):
        super().__init__(name)
        table = np.asarray(conn_table, np.int32)
        self.n_input = int(table[:, 0].max())
        self.n_output = int(table[:, 1].max())
        self.kernel = (kernel_h, kernel_w)
        self.stride = (stride_h, stride_w)
        self.pad = (pad_h, pad_w)
        mask = np.zeros((self.n_output, self.n_input, kernel_h, kernel_w),
                        np.float32)
        for i, o in table:
            mask[o - 1, i - 1] = 1.0
        self._mask = torch.from_numpy(mask)
        fan_in = kernel_h * kernel_w * self.n_input
        self.add_param("weight", init_param(
            Xavier(), RNG, (self.n_output, self.n_input, kernel_h, kernel_w),
            fan_in=fan_in, fan_out=self.n_output))
        self.add_param("bias", torch.zeros(self.n_output))

    def forward(self, x):
        if self._mask.device != self.weight.device:
            self._mask = self._mask.to(self.weight.device)
        w = self.weight * self._mask.to(self.weight.dtype)
        out = F.conv2d(x, w, None, self.stride, self.pad)
        return out + self.bias.reshape(1, -1, 1, 1)


class PriorBox(TensorModule):
    """SSD prior boxes for one feature map (ref: nn/PriorBox.scala): for
    input (B, C, H, W), the (1, 2, H * W * A * 4) prior / variance
    tensor of A anchors a cell (host numpy, as in the JAX layer)."""

    def __init__(self, min_sizes: Sequence[float],
                 max_sizes: Sequence[float] = (),
                 aspect_ratios: Sequence[float] = (2.0,),
                 flip: bool = True, clip: bool = False,
                 img_h: int = 300, img_w: int = 300,
                 step: float = 0.0,
                 variances: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
                 name: Optional[str] = None):
        super().__init__(name)
        self.min_sizes = list(min_sizes)
        self.max_sizes = list(max_sizes)
        ars = [1.0]
        for ar in aspect_ratios:
            ars.append(ar)
            if flip:
                ars.append(1.0 / ar)
        self.ars = ars
        self.clip = clip
        self.img = (img_h, img_w)
        self.step = step
        self.variances = tuple(variances)

    def forward(self, x):
        h, w = x.shape[-2], x.shape[-1]
        img_h, img_w = self.img
        step_h = self.step or img_h / h
        step_w = self.step or img_w / w
        whs = []
        for ms in self.min_sizes:
            whs.append((ms, ms))
            for mx in self.max_sizes:
                s = float(np.sqrt(ms * mx))
                whs.append((s, s))
            for ar in self.ars:
                if abs(ar - 1.0) < 1e-6:
                    continue
                whs.append((ms * float(np.sqrt(ar)),
                            ms / float(np.sqrt(ar))))
        cy = (np.arange(h) + 0.5) * step_h
        cx = (np.arange(w) + 0.5) * step_w
        boxes = [[(xc - bw / 2) / img_w, (y - bh / 2) / img_h,
                  (xc + bw / 2) / img_w, (y + bh / 2) / img_h]
                 for y in cy for xc in cx for bw, bh in whs]
        pri = np.asarray(boxes, np.float32).ravel()
        if self.clip:
            pri = np.clip(pri, 0.0, 1.0)
        var = np.tile(np.asarray(self.variances, np.float32), len(boxes))
        return torch.from_numpy(np.stack([pri, var])[None]).to(x.device)


class Anchor(TensorModule):
    """RPN anchors (ref: nn/Anchor.scala): (H * W * A, 4) for a feature
    map of the given stride, from
    :func:`~bigdl_tpu_torch.nn.layers.detection.generate_anchors`."""

    def __init__(self, stride: int, sizes: Sequence[float] = (32.,),
                 ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 name: Optional[str] = None):
        super().__init__(name)
        self.stride = stride
        self.sizes = tuple(sizes)
        self.ratios = tuple(ratios)

    def forward(self, x):
        h, w = x.shape[-2], x.shape[-1]
        return torch.from_numpy(generate_anchors(
            h, w, self.stride, self.sizes, self.ratios)).to(x.device)


class MultiRNNCell(Module):
    """A stack of recurrent cells run as one cell (ref:
    nn/MultiRNNCell.scala): ``init_carry`` / ``step`` keep the cell
    contract, so :class:`~.recurrent.Recurrent` drives the stack."""

    def __init__(self, cells, name: Optional[str] = None):
        super().__init__(name)
        self.cells = list(cells)
        for i, c in enumerate(self.cells):
            self._modules[f"cell{i}"] = c
        self.hidden_size = self.cells[-1].hidden_size

    def init_carry(self, batch: int, dtype=torch.float32, device=None):
        return tuple(c.init_carry(batch, dtype, device) for c in self.cells)

    def step(self, carry, x_t):
        new_carry, h = [], x_t
        for c, ci in zip(self.cells, carry):
            ci, h = c.step(ci, h)
            new_carry.append(ci)
        return tuple(new_carry), h

    def forward(self, x):
        _, y = self.step(self.init_carry(x.shape[0], x.dtype, x.device), x)
        return y
