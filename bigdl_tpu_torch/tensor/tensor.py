"""Tensor — the BigDL tensor facade, the port of
``bigdl_tpu/tensor/tensor.py`` (ref: scala/dllib/.../tensor/
DenseTensor.scala, DenseTensorMath).

The facade is for API parity (model-zoo code, tests, user code written
against BigDL's ``Tensor``); the hot path (``nn`` layers, optimizers)
works on plain tensors.

**It never aliases**, as the JAX facade does not: a JAX array is
immutable, so the JAX "in-place" methods (BigDL names: ``add``,
``fill``, ``copy``, ``__setitem__``) rebind ``data`` to a new array and
return ``self``, and ``narrow`` / ``select`` / ``squeeze`` give arrays
that nothing can write through. Here ``data`` is a ``torch.Tensor``,
where those are views, so the facade never writes into a ``data``: each
"in-place" method rebinds it to a new tensor, ``__setitem__`` writes
into a copy, and a tensor handed in from outside is copied. A ``fill``
of a narrowed ``Tensor`` leaves its parent as it was.

Dims and indices are 1-based, as in the reference. ``randn`` / ``rand``
draw from a CPU ``torch.Generator`` seeded with ``seed`` (the JAX
facade's ``jax.random`` bits are not reproduced): the same seed gives
the same values on any device. New tensors land on ``device`` (``None``:
the GPU); a tensor argument keeps its device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch.device import resolve_device

_CANON = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32}


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def _from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """A copy of ``a`` (canonicalised as ``jnp.asarray`` does with x64
    off) on ``device``."""
    a = np.array(a, dtype=_CANON.get(np.asarray(a).dtype), copy=True)
    return torch.from_numpy(a).to(resolve_device(device))


def _unwrap(x, like: Optional[torch.Tensor] = None):
    """An operand: a ``Tensor``'s data, a tensor, a scalar, or numpy on
    ``like``'s device."""
    if isinstance(x, Tensor):
        return x.data
    if isinstance(x, (np.ndarray, list, tuple)) and like is not None:
        return _from_numpy(np.asarray(x), like.device)
    return x


class Tensor:
    __slots__ = ("data",)
    __array_priority__ = 100

    def __init__(self, *args, dtype=torch.float32, device=None):
        dtype = _torch_dtype(dtype)
        if len(args) == 1 and isinstance(args[0], Tensor):
            self.data = args[0].data
            if device is not None:
                self.data = self.data.to(resolve_device(device))
        elif len(args) == 1 and isinstance(args[0], torch.Tensor):
            t = args[0].detach()
            self.data = (t.clone() if device is None
                         else t.to(resolve_device(device), copy=True))
        elif len(args) == 1 and isinstance(args[0], np.ndarray):
            self.data = _from_numpy(args[0], device)
        elif len(args) == 1 and isinstance(args[0], (list, tuple)):
            self.data = torch.tensor(np.asarray(args[0]), dtype=dtype,
                                     device=resolve_device(device))
        else:
            # Tensor() is a 0-d zero; Tensor(d1, d2, ...) zero-filled
            self.data = torch.zeros(tuple(int(a) for a in args),
                                    dtype=dtype,
                                    device=resolve_device(device))

    @classmethod
    def _wrap(cls, data: torch.Tensor) -> "Tensor":
        t = cls.__new__(cls)
        t.data = data
        return t

    # -- shape queries ------------------------------------------------------
    def size(self, dim: Optional[int] = None):
        if dim is None:
            return tuple(self.data.shape)
        return self.data.shape[dim - 1]  # 1-based like the reference

    @property
    def shape(self):
        return tuple(self.data.shape)

    def dim(self) -> int:
        return self.data.dim()

    def n_element(self) -> int:
        return int(self.data.numel())

    nElement = n_element

    def dtype(self):
        return self.data.dtype

    # -- creation helpers ---------------------------------------------------
    @staticmethod
    def zeros(*shape, dtype=torch.float32, device=None):
        return Tensor._wrap(torch.zeros(shape, dtype=_torch_dtype(dtype),
                                        device=resolve_device(device)))

    @staticmethod
    def ones(*shape, dtype=torch.float32, device=None):
        return Tensor._wrap(torch.ones(shape, dtype=_torch_dtype(dtype),
                                       device=resolve_device(device)))

    @staticmethod
    def randn(*shape, seed: int = 0, dtype=torch.float32, device=None):
        g = torch.Generator().manual_seed(seed)
        return Tensor._wrap(torch.randn(
            shape, generator=g, dtype=_torch_dtype(dtype)).to(
                resolve_device(device)))

    @staticmethod
    def rand(*shape, seed: int = 0, dtype=torch.float32, device=None):
        g = torch.Generator().manual_seed(seed)
        return Tensor._wrap(torch.rand(
            shape, generator=g, dtype=_torch_dtype(dtype)).to(
                resolve_device(device)))

    @staticmethod
    def arange(start, stop=None, step=1, dtype=torch.float32, device=None):
        if stop is None:
            start, stop = 1, start + 1  # Tensor.range semantics (1..n inclusive)
        return Tensor._wrap(torch.arange(start, stop, step,
                                         dtype=_torch_dtype(dtype),
                                         device=resolve_device(device)))

    # -- mutation-style ops (rebind + return self) --------------------------
    def _set(self, data):
        self.data = data
        return self

    def fill(self, value):
        return self._set(torch.full_like(self.data, value))

    def zero(self):
        return self.fill(0)

    def copy(self, other: "Tensor"):
        src = _unwrap(other, self.data)
        if not isinstance(src, torch.Tensor):
            src = torch.tensor(src, device=self.data.device)
        return self._set(torch.broadcast_to(src.to(self.data.device),
                                            self.data.shape)
                         .to(self.data.dtype, copy=True))

    def set(self, other: Optional["Tensor"] = None):
        if other is None:
            return self._set(torch.zeros((), dtype=self.data.dtype,
                                         device=self.data.device))
        src = _unwrap(other, self.data)
        return self._set(src.clone() if isinstance(other, torch.Tensor)
                         else src)

    def resize(self, *sizes):
        sizes = tuple(int(s) for s in sizes)
        n_new = int(np.prod(sizes))
        flat = self.data.reshape(-1)
        if flat.numel() < n_new:
            flat = torch.cat([flat, flat.new_zeros(n_new - flat.numel())])
        return self._set(flat[:n_new].reshape(sizes))

    def resize_as(self, other):
        return self.resize(*_unwrap(other).shape)

    def apply_(self, fn):
        return self._set(fn(self.data))

    def add(self, *args):
        """add(value) | add(other) | add(alpha, other) — in-place like reference."""
        if len(args) == 1:
            return self._set(self.data + _unwrap(args[0], self.data))
        alpha, other = args
        return self._set(self.data + alpha * _unwrap(other, self.data))

    def sub(self, *args):
        if len(args) == 1:
            return self._set(self.data - _unwrap(args[0], self.data))
        alpha, other = args
        return self._set(self.data - alpha * _unwrap(other, self.data))

    def mul(self, value):
        return self._set(self.data * _unwrap(value, self.data))

    cmul = mul

    def div(self, value):
        return self._set(self.data / _unwrap(value, self.data))

    cdiv = div

    def pow(self, n):
        return self._set(self.data ** n)

    def sqrt(self):
        return self._set(torch.sqrt(self.data))

    def exp(self):
        return self._set(torch.exp(self.data))

    def log(self):
        return self._set(torch.log(self.data))

    def abs(self):
        return self._set(torch.abs(self.data))

    def clamp(self, min_v, max_v):
        return self._set(torch.clamp(self.data, min_v, max_v))

    def addcmul(self, value, t1, t2):
        return self._set(self.data + value * _unwrap(t1, self.data)
                         * _unwrap(t2, self.data))

    def addcdiv(self, value, t1, t2):
        return self._set(self.data + value * _unwrap(t1, self.data)
                         / _unwrap(t2, self.data))

    @staticmethod
    def _beta_alpha(args):
        """``([beta], [alpha,] a, b)`` → ``(beta, alpha, a, b)``."""
        if len(args) == 2:
            return (1.0, 1.0) + tuple(args)
        if len(args) == 3:
            return (args[0], 1.0) + tuple(args[1:])
        return tuple(args)

    def addmm(self, *args):
        """addmm([beta], [alpha,] mat1, mat2) — self = beta*self + alpha*mat1@mat2."""
        beta, alpha, m1, m2 = self._beta_alpha(args)
        return self._set(beta * self.data + alpha * (
            _unwrap(m1, self.data) @ _unwrap(m2, self.data)))

    def addmv(self, *args):
        beta, alpha, m, v = self._beta_alpha(args)
        return self._set(beta * self.data + alpha * (
            _unwrap(m, self.data) @ _unwrap(v, self.data)))

    def addr(self, alpha, v1, v2):
        return self._set(self.data + alpha * torch.outer(
            _unwrap(v1, self.data), _unwrap(v2, self.data)))

    # -- functional (return new Tensor) -------------------------------------
    def clone(self) -> "Tensor":
        return Tensor._wrap(self.data)

    def contiguous(self) -> "Tensor":
        return self

    def view(self, *sizes) -> "Tensor":
        if len(sizes) == 1 and isinstance(sizes[0], (tuple, list)):
            sizes = tuple(sizes[0])
        return Tensor._wrap(self.data.reshape(sizes))

    reshape = view

    def t(self) -> "Tensor":
        return Tensor._wrap(self.data.permute(
            *reversed(range(self.data.dim()))))

    def transpose(self, dim1: int, dim2: int) -> "Tensor":
        return Tensor._wrap(torch.swapaxes(self.data, dim1 - 1, dim2 - 1))

    def narrow(self, dim: int, index: int, size: int) -> "Tensor":
        """1-based dim & index, like the reference."""
        return Tensor._wrap(self.data.narrow(dim - 1, index - 1, size))

    def select(self, dim: int, index: int) -> "Tensor":
        return Tensor._wrap(self.data.select(dim - 1, index - 1))

    def squeeze(self, dim: Optional[int] = None) -> "Tensor":
        if dim is None:
            return Tensor._wrap(torch.squeeze(self.data))
        return Tensor._wrap(torch.squeeze(self.data, dim - 1))

    def unsqueeze(self, dim: int) -> "Tensor":
        return Tensor._wrap(torch.unsqueeze(self.data, dim - 1))

    def index_select(self, dim: int, indices) -> "Tensor":
        idx = torch.as_tensor(_unwrap(indices, self.data),
                              device=self.data.device).long() - 1
        return Tensor._wrap(torch.index_select(self.data, dim - 1,
                                               idx.reshape(-1)).reshape(
            self.data.shape[:dim - 1] + idx.shape
            + self.data.shape[dim:]))

    def mm(self, other) -> "Tensor":
        return Tensor._wrap(self.data @ _unwrap(other, self.data))

    mv = mm
    __matmul__ = mm

    def dot(self, other) -> float:
        return float(torch.dot(self.data.reshape(-1),
                               _unwrap(other, self.data).reshape(-1)))

    def sum(self, dim: Optional[int] = None):
        if dim is None:
            return float(torch.sum(self.data))
        return Tensor._wrap(torch.sum(self.data, dim - 1, keepdim=True))

    def mean(self, dim: Optional[int] = None):
        if dim is None:
            return float(torch.mean(self.data))
        return Tensor._wrap(torch.mean(self.data, dim - 1, keepdim=True))

    def _extreme(self, dim, fn, arg):
        if dim is None:
            return float(fn(self.data))
        values = torch.amax(self.data, dim - 1, keepdim=True) \
            if fn is torch.max else torch.amin(self.data, dim - 1,
                                               keepdim=True)
        indices = arg(self.data, dim - 1, keepdim=True) + 1
        return Tensor._wrap(values), Tensor._wrap(indices.float())

    def max(self, dim: Optional[int] = None):
        return self._extreme(dim, torch.max, torch.argmax)

    def min(self, dim: Optional[int] = None):
        return self._extreme(dim, torch.min, torch.argmin)

    def norm(self, p: int = 2) -> float:
        return float(torch.sum(torch.abs(self.data) ** p) ** (1.0 / p))

    def almost_equal(self, other, tolerance: float = 1e-5) -> bool:
        o = torch.as_tensor(_unwrap(other, self.data),
                            device=self.data.device)
        return bool(torch.allclose(self.data, o.to(self.data.dtype),
                                   atol=tolerance))

    def to_numpy(self) -> np.ndarray:
        return self.data.detach().cpu().numpy().copy()

    def astype(self, dtype) -> "Tensor":
        return Tensor._wrap(self.data.to(_torch_dtype(dtype)))

    # -- operators ----------------------------------------------------------
    def __add__(self, other):
        return Tensor._wrap(self.data + _unwrap(other, self.data))

    __radd__ = __add__

    def __sub__(self, other):
        return Tensor._wrap(self.data - _unwrap(other, self.data))

    def __rsub__(self, other):
        return Tensor._wrap(_unwrap(other, self.data) - self.data)

    def __mul__(self, other):
        return Tensor._wrap(self.data * _unwrap(other, self.data))

    __rmul__ = __mul__

    def __truediv__(self, other):
        return Tensor._wrap(self.data / _unwrap(other, self.data))

    def __neg__(self):
        return Tensor._wrap(-self.data)

    def __getitem__(self, item):
        return Tensor._wrap(self.data[item])

    def __setitem__(self, item, value):
        d = self.data.clone()
        d[item] = _unwrap(value, d)
        self.data = d

    def __repr__(self):
        return f"Tensor({self.to_numpy()!r})"

    def __float__(self):
        return float(self.data)
