"""Mesh construction and batch sharding — the port of
``bigdl_tpu/parallel/mesh.py``'s data-parallel part.

The JAX mesh is a ``jax.sharding.Mesh`` of devices; here it is a
:class:`torch.distributed.device_mesh.DeviceMesh` of ranks, one device a
rank, over the process group the Engine owns. Axis conventions (shared
with :class:`~bigdl_tpu_torch.utils.engine.Engine`): ``data``, ``model``,
``seq``, ``pipe``, ``expert``. The tensor-parallel placements
(``replicated``, ``shard_along``, ``constrain``) are ROADMAP Queue 1
item 10 (rest).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Union


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
