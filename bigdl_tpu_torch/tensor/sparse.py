"""SparseTensor — the port of ``bigdl_tpu/tensor/sparse.py`` (ref:
S:dllib/tensor/SparseTensor.scala, which backs the sparse recsys layers).

A frozen COO triple ``(indices (nnz, ndim) int32, values (nnz,),
shape)``, as in the JAX package. The compute paths are gathers and
``index_add_`` (the JAX ``segment_sum``) on the values' device; the
structural ops (``coalesce``, ``narrow``, ``concat``) stay on that
device too. ``to_torch`` / ``from_torch`` take the place of the JAX
``to_bcoo`` / ``from_bcoo`` over ``torch.sparse_coo_tensor``.

numpy inputs are canonicalised as ``jnp.asarray`` does with x64 off
(f64 → f32, i64 → i32) and land on ``device`` (``None``: the GPU); tensor
inputs keep their device. On CUDA ``index_add_`` adds with atomics, so
an f32 sum's order, and its last bits, vary from run to run.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from bigdl_tpu_torch.device import resolve_device

_CANON = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
          np.dtype(np.uint64): np.uint32}


def _as_tensor(x, device) -> torch.Tensor:
    """A tensor as it is; anything else through numpy, canonicalised as
    ``jnp.asarray`` does, onto ``device``."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    a = a.astype(_CANON.get(a.dtype, a.dtype))
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        resolve_device(device))


def _strides(shape) -> torch.Tensor:
    st = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        st[d] = st[d + 1] * shape[d + 1]
    return torch.tensor(st, dtype=torch.int64)


class SparseTensor:
    """COO: ``indices (nnz, ndim) int32``, ``values (nnz,)``, ``shape``."""

    def __init__(self, indices, values, shape: Sequence[int], device=None):
        if isinstance(values, torch.Tensor):
            device = values.device
        elif isinstance(indices, torch.Tensor):
            device = indices.device
        self.values = _as_tensor(values, device)
        self.indices = _as_tensor(indices, self.values.device).to(
            self.values.device, torch.int32)
        self.shape = tuple(int(s) for s in shape)
        if self.indices.dim() != 2 or \
                self.indices.shape[1] != len(self.shape):
            raise ValueError(
                f"indices {tuple(self.indices.shape)} do not match shape "
                f"{self.shape}")
        if self.indices.shape[0] != self.values.shape[0]:
            raise ValueError("indices/values nnz mismatch")

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_dense(cls, dense, device=None) -> "SparseTensor":
        """The non-zeros of ``dense`` in row-major order."""
        d = _as_tensor(dense, device)
        idx = torch.nonzero(d)
        return cls(idx, d[tuple(idx.T)], d.shape)

    @classmethod
    def from_torch(cls, t: torch.Tensor) -> "SparseTensor":
        """From a ``torch.sparse_coo_tensor``, its entries as stored (a
        tensor that is not coalesced keeps its duplicates)."""
        return cls(t._indices().T, t._values(), t.shape)

    # -- views ---------------------------------------------------------------
    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    def to(self, device) -> "SparseTensor":
        return SparseTensor(self.indices.to(device), self.values.to(device),
                            self.shape)

    def _cols(self):
        return tuple(self.indices.long().T)

    def to_dense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.values.dtype,
                          device=self.device)
        return out.index_put(self._cols(), self.values, accumulate=True)

    def to_torch(self) -> torch.Tensor:
        return torch.sparse_coo_tensor(self.indices.long().T, self.values,
                                       self.shape, check_invariants=True)

    # -- math (the ops the sparse layers need) ------------------------------
    def matmul_dense(self, w: torch.Tensor) -> torch.Tensor:
        """(self: (B, F) sparse) @ (w: (F, O) dense) by gather and
        ``index_add`` — the SparseLinear forward; differentiable in
        ``w`` and in the values."""
        if self.ndim != 2:
            raise ValueError("matmul_dense needs a 2-D sparse tensor")
        rows, cols = self.indices.long().unbind(1)
        contrib = w[cols] * self.values[:, None].to(w.dtype)
        out = torch.zeros((self.shape[0], w.shape[1]), dtype=contrib.dtype,
                          device=contrib.device)
        return out.index_add(0, rows, contrib)

    # -- elementwise / structural ops (ref SparseTensor op surface:
    # add, narrow, concat, transpose, apply/map, reductions) ---------------
    def coalesce(self) -> "SparseTensor":
        """Merge duplicate indices (sum their values), sort row-major."""
        flat = (self.indices.long()
                * _strides(self.shape).to(self.device)).sum(1)
        order = torch.argsort(flat, stable=True)
        flat, vals = flat[order], self.values[order]
        uniq, inverse = torch.unique_consecutive(flat, return_inverse=True)
        summed = torch.zeros(uniq.shape[0], dtype=vals.dtype,
                             device=vals.device).index_add(0, inverse, vals)
        idx = [torch.div(uniq, s, rounding_mode="floor") % n
               for s, n in zip(_strides(self.shape).tolist(), self.shape)]
        return SparseTensor(torch.stack(idx, 1), summed, self.shape)

    def add(self, other) -> "SparseTensor":
        """sparse + sparse (same shape) → coalesced sparse."""
        if not isinstance(other, SparseTensor):
            raise TypeError("add expects a SparseTensor; use to_dense() "
                            "for dense arithmetic")
        if other.shape != self.shape:
            raise ValueError(f"shape mismatch {self.shape} {other.shape}")
        dt = torch.promote_types(self.values.dtype, other.values.dtype)
        idx = torch.cat([self.indices, other.indices], 0)
        vals = torch.cat([self.values.to(dt), other.values.to(dt)], 0)
        return SparseTensor(idx, vals, self.shape).coalesce()

    def mul_scalar(self, a) -> "SparseTensor":
        return SparseTensor(self.indices, self.values * a, self.shape)

    def mul_dense(self, dense) -> "SparseTensor":
        """Elementwise multiply by a dense array (sparsity preserved)."""
        d = _as_tensor(dense, self.device).to(self.device)
        if tuple(d.shape) != self.shape:
            raise ValueError(f"shape mismatch {self.shape} "
                             f"{tuple(d.shape)}")
        return SparseTensor(self.indices, self.values * d[self._cols()],
                            self.shape)

    def transpose(self) -> "SparseTensor":
        if self.ndim != 2:
            raise ValueError("transpose is 2-D only")
        return SparseTensor(self.indices.flip(1), self.values,
                            (self.shape[1], self.shape[0]))

    def narrow(self, dim: int, start: int, length: int) -> "SparseTensor":
        """Slice ``[start, start+length)`` along ``dim`` (0-based; the
        reference's 1-based narrow is the Tensor facade's concern)."""
        col = self.indices[:, dim]
        keep = (col >= start) & (col < start + length)
        idx = self.indices[keep].clone()
        idx[:, dim] -= start
        shape = list(self.shape)
        shape[dim] = length
        return SparseTensor(idx, self.values[keep], shape)

    @staticmethod
    def concat(tensors: Sequence["SparseTensor"],
               dim: int = 0) -> "SparseTensor":
        """Concatenate along ``dim`` (ref: SparseTensor.concat backing
        SparseJoinTable)."""
        base = tensors[0]
        for t in tensors[1:]:
            for d in range(base.ndim):
                if d != dim and t.shape[d] != base.shape[d]:
                    raise ValueError("non-concat dims must match")
        parts_i, off = [], 0
        for t in tensors:
            idx = t.indices.clone()
            idx[:, dim] += off
            parts_i.append(idx)
            off += t.shape[dim]
        shape = list(base.shape)
        shape[dim] = off
        return SparseTensor(torch.cat(parts_i, 0),
                            torch.cat([t.values for t in tensors], 0), shape)

    def sum(self) -> torch.Tensor:
        return torch.sum(self.values)

    def apply(self, fn) -> "SparseTensor":
        """Map ``fn`` over the stored values (ref applyFun; zeros stay
        zero, so fn must satisfy fn(0)=0 for dense equivalence — the
        reference has the same contract)."""
        return SparseTensor(self.indices, fn(self.values), self.shape)

    def __repr__(self):
        return (f"SparseTensor(shape={self.shape}, nnz={self.nnz}, "
                f"dtype={self.dtype})")
