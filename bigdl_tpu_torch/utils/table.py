"""Table — heterogeneous activity container (the port of
``bigdl_tpu/utils/table.py``; ref: .../utils/Table.scala, T()).

BigDL models whose layers take or produce several tensors pass a
``Table`` (torch's ``table``): 1-based integer keys by default, arbitrary
keys allowed. A thin ordered mapping; the JAX package's pytree
registration has no counterpart here (eager PyTorch needs none).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator

import numpy as np
import torch


class Table:
    def __init__(self, *args, **kwargs):
        self._state: Dict[Any, Any] = {}
        for i, v in enumerate(args):
            self._state[i + 1] = v  # 1-based, matching the reference
        self._state.update(kwargs)

    # -- mapping protocol ---------------------------------------------------
    def __getitem__(self, key):
        return self._state[key]

    def __setitem__(self, key, value):
        self._state[key] = value

    def __contains__(self, key):
        return key in self._state

    def __len__(self):
        return len(self._state)

    def __iter__(self) -> Iterator:
        return iter(self._state.values())

    def keys(self):
        return self._state.keys()

    def values(self):
        return self._state.values()

    def items(self):
        return self._state.items()

    def get(self, key, default=None):
        return self._state.get(key, default)

    def insert(self, value):
        self._state[len(self._state) + 1] = value
        return self

    def to_list(self):
        return [self._state[k] for k in _sorted_keys(self._state)]

    def __repr__(self):
        inner = ", ".join(f"{k}: {v!r}" for k, v in self._state.items())
        return f"Table({{{inner}}})"

    def __eq__(self, other):
        if not isinstance(other, Table):
            return NotImplemented
        if set(self._state.keys()) != set(other._state.keys()):
            return False
        for k, v in self._state.items():
            w = other._state[k]
            if isinstance(v, Table) or isinstance(w, Table):
                if v != w:
                    return False
            elif not np.array_equal(_numpy(v), _numpy(w)):
                return False
        return True

    # mutable container: value-equal, identity-unhashable (like dict)
    __hash__ = None


def _numpy(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def T(*args, **kwargs) -> Table:
    """Constructor sugar matching the reference's ``T()``."""
    return Table(*args, **kwargs)


def _sorted_keys(state):
    """Numeric keys first in numeric order, then others lexicographically —
    keeps Tables with ≥10 positional entries in insertion order."""
    return sorted(state.keys(),
                  key=lambda k: (0, k, "") if isinstance(k, int)
                  else (1, 0, str(k)))
