"""Containers — the port of ``bigdl_tpu/nn/containers.py`` (ref:
.../nn/Sequential.scala, Concat.scala, ConcatTable.scala,
ParallelTable.scala, CAddTable.scala, JoinTable.scala, SplitTable.scala,
MapTable.scala, Bottle.scala, SelectTable.scala, FlattenTable.scala, ...).

Children sit under the keys ``"0"``, ``"1"``, … as in the JAX package,
so the trees match. Dimension arguments are 1-based where the reference's
are.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.table import T, Table


class Container(Module):
    """Base container (ref: nn/Container.scala)."""

    def add(self, module: Module):
        self._modules[str(len(self._modules))] = module
        return self

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, i) -> Module:
        return list(self._modules.values())[i]

    def _run_seq(self, x):
        for m in self._modules.values():
            x = m(x)
        return x


class Sequential(Container):
    """ref: nn/Sequential.scala."""

    def forward(self, x):
        return self._run_seq(x)


def _snapshot(module):
    """A block's buffers and generator states, as they are now."""
    return ([(m, k, b) for m in module.modules()
             for k, b in m._buffers.items()],
            [(m, m.generator.get_state()) for m in module.modules()
             if getattr(m, "generator", None) is not None])


def _load(module, snap):
    bufs, gens = snap
    for m, k, b in bufs:
        m._buffers[k] = b
    for m, s in gens:
        m.generator.set_state(s)


class Checkpoint(Container):
    """Rematerialization wrapper: the wrapped block's activations are not
    kept for backward but recomputed from its input
    (``torch.utils.checkpoint``, non-reentrant), trading FLOPs for
    activation memory. The recompute runs with the buffers and generator
    states the forward started from, and puts back those the forward
    left: a batch norm inside moves its running statistics once and
    computes the same output twice, and a dropout draws the same mask,
    as under ``jax.checkpoint`` in the JAX package."""

    def __init__(self, module: Optional[Module] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        if module is not None:
            self.add(module)

    def forward(self, x):
        if not (torch.is_grad_enabled() and isinstance(x, torch.Tensor)
                and (x.requires_grad or any(
                    p.requires_grad for p in self.parameters()))):
            return self._run_seq(x)
        start = []

        @contextlib.contextmanager
        def record():
            start.append(_snapshot(self))
            yield

        @contextlib.contextmanager
        def replay():
            now = _snapshot(self)
            _load(self, start[0])
            try:
                yield
            finally:
                _load(self, now)

        return checkpoint(self._run_seq, x, use_reentrant=False,
                          context_fn=lambda: (record(), replay()))


class Concat(Container):
    """Apply each child to the same input, concat outputs along dim
    (1-based; ref: nn/Concat.scala)."""

    def __init__(self, dimension: int = 2, name: Optional[str] = None):
        super().__init__(name)
        self.dimension = dimension

    def forward(self, x):
        return torch.cat([m(x) for m in self._modules.values()],
                         dim=self.dimension - 1)


class ConcatTable(Container):
    """Each child sees the same input; outputs collected in a Table
    (ref: nn/ConcatTable.scala)."""

    def forward(self, x):
        return T(*[m(x) for m in self._modules.values()])


def _items(x):
    return list(x) if isinstance(x, (Table, list, tuple)) else [x]


class ParallelTable(Container):
    """i-th child applied to i-th table element (ref: nn/ParallelTable.scala)."""

    def forward(self, x):
        return T(*[m(xi) for m, xi in zip(self._modules.values(),
                                           _items(x))])


class MapTable(Container):
    """Same child applied to every table element (ref: nn/MapTable.scala)."""

    def __init__(self, module: Optional[Module] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        if module is not None:
            self.add(module)

    def forward(self, x):
        return T(*[self._modules["0"](xi) for xi in list(x)])


class Bottle(Container):
    """Flatten leading dims, apply child, restore (ref: nn/Bottle.scala)."""

    def __init__(self, module: Module, n_input_dim: int = 2,
                 n_output_dim: Optional[int] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.add(module)
        self.n_input_dim = n_input_dim
        self.n_output_dim = n_output_dim or n_input_dim

    def forward(self, x):
        cut = x.dim() - self.n_input_dim + 1
        y = self._modules["0"](x.reshape((-1,) + tuple(x.shape[cut:])))
        return y.reshape(tuple(x.shape[:cut]) + tuple(y.shape[1:]))


# -- table arithmetic -------------------------------------------------------

class CAddTable(Module):
    """Elementwise sum of table elements (ref: nn/CAddTable.scala)."""

    def __init__(self, inplace: bool = False, name: Optional[str] = None):
        super().__init__(name)

    def forward(self, x):
        xs = list(x)
        out = xs[0]
        for xi in xs[1:]:
            out = out + xi
        return out


class CMulTable(Module):
    def forward(self, x):
        xs = list(x)
        out = xs[0]
        for xi in xs[1:]:
            out = out * xi
        return out


class CSubTable(Module):
    def forward(self, x):
        xs = list(x)
        return xs[0] - xs[1]


class CDivTable(Module):
    def forward(self, x):
        xs = list(x)
        return xs[0] / xs[1]


class CMaxTable(Module):
    def forward(self, x):
        xs = list(x)
        out = xs[0]
        for xi in xs[1:]:
            out = torch.maximum(out, xi)
        return out


class CMinTable(Module):
    def forward(self, x):
        xs = list(x)
        out = xs[0]
        for xi in xs[1:]:
            out = torch.minimum(out, xi)
        return out


class CAveTable(Module):
    def forward(self, x):
        xs = list(x)
        return sum(xs) / len(xs)


# -- table plumbing ---------------------------------------------------------

class SelectTable(Module):
    """1-based table index (ref: nn/SelectTable.scala)."""

    def __init__(self, index: int, name: Optional[str] = None):
        super().__init__(name)
        self.index = index

    def forward(self, x):
        xs = list(x)
        return xs[self.index - 1 if self.index > 0 else len(xs) + self.index]


class FlattenTable(Module):
    def forward(self, x):
        flat = []

        def rec(v):
            if isinstance(v, (Table, list, tuple)):
                for e in v:
                    rec(e)
            else:
                flat.append(v)

        rec(x)
        return T(*flat)


class JoinTable(Module):
    """Concat table elements along dim (1-based, n_input_dims for
    batch-dim adjust; ref: nn/JoinTable.scala)."""

    def __init__(self, dimension: int, n_input_dims: int = 0,
                 name: Optional[str] = None):
        super().__init__(name)
        self.dimension = dimension
        self.n_input_dims = n_input_dims

    def forward(self, x):
        xs = list(x)
        d = self.dimension - 1
        if self.n_input_dims and xs[0].dim() > self.n_input_dims:
            d += xs[0].dim() - self.n_input_dims
        return torch.cat(xs, dim=d)


class SplitTable(Module):
    """Split along dim into a Table (ref: nn/SplitTable.scala)."""

    def __init__(self, dimension: int, n_input_dims: int = 0,
                 name: Optional[str] = None):
        super().__init__(name)
        self.dimension = dimension
        self.n_input_dims = n_input_dims

    def forward(self, x):
        d = self.dimension - 1 if self.dimension > 0 \
            else x.dim() + self.dimension
        if self.n_input_dims and x.dim() > self.n_input_dims:
            d += x.dim() - self.n_input_dims
        return T(*torch.unbind(x, dim=d))


class Echo(Module):
    """Debug pass-through that prints shape (ref: nn/Echo.scala)."""

    def forward(self, x):
        print(f"[{self.name}] shape={getattr(x, 'shape', None)}")
        return x
