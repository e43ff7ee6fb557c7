"""Search-space primitives — a copy of ``bigdl_tpu/orca/automl/hp.py``
(ref: P:orca/automl/hp.py — thin wrappers over Ray Tune sample spaces;
here self-contained samplers over ``random.Random``, so one seed gives
the JAX package's configs)."""

from __future__ import annotations

import random
from typing import Any, List, Sequence


class _Space:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class _Choice(_Space):
    def __init__(self, options: Sequence[Any]):
        self.options = list(options)

    def sample(self, rng):
        return rng.choice(self.options)


class _Uniform(_Space):
    def __init__(self, lo: float, hi: float):
        self.lo, self.hi = lo, hi

    def sample(self, rng):
        return rng.uniform(self.lo, self.hi)


class _LogUniform(_Space):
    def __init__(self, lo: float, hi: float):
        import math
        self.lo, self.hi = math.log(lo), math.log(hi)

    def sample(self, rng):
        import math
        return math.exp(rng.uniform(self.lo, self.hi))


class _RandInt(_Space):
    def __init__(self, lo: int, hi: int):
        self.lo, self.hi = lo, hi

    def sample(self, rng):
        return rng.randint(self.lo, self.hi - 1)


class hp:
    """ref API: hp.choice / hp.uniform / hp.loguniform / hp.randint /
    hp.grid_search."""

    @staticmethod
    def choice(options):
        return _Choice(options)

    @staticmethod
    def uniform(lo, hi):
        return _Uniform(lo, hi)

    @staticmethod
    def loguniform(lo, hi):
        return _LogUniform(lo, hi)

    @staticmethod
    def randint(lo, hi):
        return _RandInt(lo, hi)

    @staticmethod
    def grid_search(options):
        g = _Choice(options)
        g.grid = True
        return g


def sample_config(space: dict, rng: random.Random) -> dict:
    return {k: (v.sample(rng) if isinstance(v, _Space) else v)
            for k, v in space.items()}


def grid_axes(space: dict) -> List[str]:
    return [k for k, v in space.items() if getattr(v, "grid", False)]
