"""Mesh construction, batch sharding and placements — the port of
``bigdl_tpu/parallel/mesh.py``.

The JAX mesh is a ``jax.sharding.Mesh`` of devices; here it is a
:class:`torch.distributed.device_mesh.DeviceMesh` of ranks, one device a
rank, over the process group the Engine owns. Axis conventions (shared
with :class:`~bigdl_tpu_torch.utils.engine.Engine`): ``data``, ``model``,
``seq``, ``pipe``, ``expert``.

A JAX ``PartitionSpec`` names, for each tensor dimension, the mesh axis
it is split over (or ``None``); :class:`PartitionSpec` keeps that form.
A JAX ``NamedSharding`` places an array by one; :class:`NamedSharding`
holds the same pair and turns it into the DTensor placements of the
mesh (``Shard(dim)`` on a mesh dimension that splits tensor dimension
``dim``, ``Replicate()`` on every other), which ``place`` and
:func:`constrain` apply.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Union


def create_mesh(axes: Union[Dict[str, int], Sequence[str]]):
    """A mesh from ``{"data": 4, "model": 2}``-style axis sizes over the
    whole world (the Engine's process group, initialised if cold), on
    the group's devices (``cuda`` under NCCL, ``cpu`` under gloo). A
    size of ``-1`` (at most one axis) absorbs the remaining ranks; given
    just axis names, every rank goes to the first axis."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from bigdl_tpu_torch.utils.engine import Engine
    if not dist.is_initialized():
        Engine.init()
    n = dist.get_world_size()
    if not isinstance(axes, dict):
        axes = {name: (-1 if i == 0 else 1) for i, name in enumerate(axes)}
    names, sizes = list(axes), list(axes.values())
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if n % known:
            raise ValueError(f"{n} ranks not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    if math.prod(sizes) != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} does not cover a "
                         f"world of {n} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(sizes),
                            mesh_dim_names=tuple(names))


def default_mesh():
    """The Engine-owned mesh, initialising the Engine if it is cold."""
    from bigdl_tpu_torch.utils.engine import Engine
    return Engine.mesh()


def mesh_axis_size(mesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def shard_batch(tree, mesh, axis: str = "data"):
    """This rank's contiguous slice of a global batch tree (numpy arrays
    or tensors) along dim 0, by its coordinate on mesh ``axis`` — the
    rows the JAX ``shard_batch`` places on this device."""
    from bigdl_tpu_torch.utils.tree import tree_map
    n = mesh_axis_size(mesh, axis)
    if n == 1:
        return tree
    i = mesh.get_local_rank(axis)

    def cut(a):
        b = a.shape[0]
        if b % n:
            raise ValueError(f"batch of {b} does not split over {n} ranks "
                             f"of axis {axis!r}")
        k = b // n
        return a[i * k:(i + 1) * k]

    return tree_map(cut, tree)


class PartitionSpec(tuple):
    """For each tensor dimension, the mesh axis it is split over, or
    ``None`` (``jax.sharding.PartitionSpec``'s form)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


class NamedSharding:
    """``spec`` on ``mesh``: the port of ``jax.sharding.NamedSharding``."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    @property
    def placements(self):
        """One DTensor placement a mesh dimension."""
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for name in self.mesh.mesh_dim_names or ():
            dims = [d for d, ax in enumerate(self.spec) if ax == name]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def place(self, x):
        """``x`` (the global tensor, the same on every rank) as a DTensor
        with this sharding: each rank keeps its shard."""
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(x, self.mesh, self.placements)

    def __repr__(self):
        return f"NamedSharding(spec={self.spec!r})"


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_along(mesh, axis: str, dim: int = 0,
                ndim: Optional[int] = None) -> NamedSharding:
    """The sharding that splits tensor dimension ``dim`` over mesh
    ``axis``."""
    spec = [None] * (dim + 1 if ndim is None else ndim)
    spec[dim] = axis
    return NamedSharding(mesh, P(*spec))


def constrain(x, spec):
    """``x`` laid out by ``spec``, a :class:`PartitionSpec` (on a DTensor's
    own mesh, or the Engine's for a plain tensor) or a
    :class:`NamedSharding`: a DTensor is redistributed, a plain tensor
    (the global value) placed. The JAX function constrains inside a
    jitted program under the ambient mesh; eager PyTorch moves the data
    here."""
    from torch.distributed.tensor import DTensor
    if not isinstance(spec, NamedSharding):
        spec = NamedSharding(x.device_mesh if isinstance(x, DTensor)
                             else default_mesh(), spec)
    if isinstance(x, DTensor):
        return x.redistribute(spec.mesh, spec.placements)
    return spec.place(x)
