"""Sparse layers — the port of ``bigdl_tpu/nn/layers/sparse.py`` (ref:
S:dllib/nn/SparseLinear.scala, LookupTableSparse.scala,
SparseJoinTable.scala — the recsys embedding path).

Sparse inputs lower to a gather and an ``index_add`` (the JAX
``segment_sum``), or, for the padded id bags of ``LookupTableSparse``, a
gather and a sum over the bag; autograd gives the vjp. Weights keep the
JAX shapes and initialisers, drawn from the port's ``RNG``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.initialization import RandomNormal, Xavier, init_param
from bigdl_tpu_torch.nn.module import RNG, TensorModule
from bigdl_tpu_torch.tensor.sparse import SparseTensor
from bigdl_tpu_torch.utils.table import Table


class SparseLinear(TensorModule):
    """y = sparse_x @ W^T + b over a :class:`SparseTensor` input (B, F)
    (ref: SparseLinear.scala)."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True, name: Optional[str] = None):
        super().__init__(name)
        self.input_size, self.output_size = input_size, output_size
        self.with_bias = with_bias
        self.add_param("weight", init_param(
            Xavier(), RNG, (output_size, input_size),
            fan_in=input_size, fan_out=output_size))
        if with_bias:
            self.add_param("bias", torch.zeros(output_size))

    def forward(self, x):
        if not isinstance(x, SparseTensor):
            raise TypeError("SparseLinear expects a SparseTensor input")
        y = x.matmul_dense(self.weight.t())
        if self.with_bias:
            y = y + self.bias.to(y.dtype)
        return y


class LookupTableSparse(TensorModule):
    """Embedding bag: ids (B, L), 1-based with 0 as padding → pooled
    embeddings (B, dim); combiner ``sum`` / ``mean`` / ``sqrtn`` (ref:
    LookupTableSparse.scala; fixed-width padded ids are the JAX layer's
    static-shape form of its SparseTensor of ids)."""

    def __init__(self, n_index: int, n_output: int,
                 combiner: str = "sum", name: Optional[str] = None):
        super().__init__(name)
        if combiner not in ("sum", "mean", "sqrtn"):
            raise ValueError(f"unknown combiner {combiner!r}")
        self.n_index = n_index
        self.combiner = combiner
        self.add_param("weight", init_param(
            RandomNormal(0, 0.1), RNG, (n_index, n_output),
            fan_in=n_index, fan_out=n_output))

    def forward(self, x):
        ids = torch.as_tensor(x, device=self.weight.device).to(
            torch.int32)                                  # (B, L), 0 = padding
        valid = ids > 0
        emb = F.embedding(torch.clamp(ids.long() - 1, 0, self.n_index - 1),
                          self.weight)                   # 1-based ids
        emb = emb * valid[..., None].to(emb.dtype)
        total = torch.sum(emb, dim=1)
        if self.combiner == "sum":
            return total
        count = torch.clamp(valid.sum(1), min=1).to(total.dtype)
        if self.combiner == "mean":
            return total / count[:, None]
        return total / torch.sqrt(count)[:, None]        # sqrtn


class SparseJoinTable(TensorModule):
    """Concatenate SparseTensors along a dimension (ref:
    SparseJoinTable.scala). Returns a SparseTensor."""

    def __init__(self, dimension: int = 2, name: Optional[str] = None):
        super().__init__(name)
        self.dimension = dimension          # 1-based, reference style

    def forward(self, x):
        tensors = list(x.values()) if isinstance(x, Table) else list(x)
        axis = self.dimension - 1
        shape = list(tensors[0].shape)
        offset = 0
        idx_parts, val_parts = [], []
        for t in tensors:
            if not isinstance(t, SparseTensor):
                raise TypeError("SparseJoinTable expects SparseTensors")
            idx = t.indices.clone()
            idx[:, axis] += offset
            idx_parts.append(idx)
            val_parts.append(t.values)
            offset += t.shape[axis]
        shape[axis] = offset
        return SparseTensor(torch.cat(idx_parts), torch.cat(val_parts),
                            shape)


__all__ = ["LookupTableSparse", "SparseJoinTable", "SparseLinear"]
