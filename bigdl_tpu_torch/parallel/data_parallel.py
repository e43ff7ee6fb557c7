"""The data-parallel train step — the port of
``bigdl_tpu/parallel/data_parallel.py``'s ``dp_train_step``.

The JAX step is one jitted SPMD program over the mesh: the global batch
sharded on ``data``, the params replicated, XLA inserting the gradient
psum. Here every rank runs the step eagerly on its shard of the global
batch (:func:`~bigdl_tpu_torch.parallel.mesh.shard_batch`) and the
gradients are averaged over the mesh's ``data`` group before the
update, so every rank applies the same update. As in the SPMD program,
batch normalisation inside ``apply_fn`` takes the global batch's
statistics. ``tp_linear_spec`` and ``param_shardings`` give the
tensor-parallel layout of a parameter tree by the JAX rules.
"""

from __future__ import annotations

import re
from typing import Callable, Optional

import torch

from bigdl_tpu_torch.parallel.collectives import all_reduce, \
    global_batch_stats
from bigdl_tpu_torch.parallel.mesh import (NamedSharding, P,
                                           mesh_axis_size)
from bigdl_tpu_torch.utils.tree import tree_leaves, tree_unflatten


def tp_linear_spec(shape, axis: str = "model", dim: int = 0) -> P:
    """The spec sharding a weight matrix's ``dim`` over ``axis``."""
    spec = [None] * len(shape)
    spec[dim] = axis
    return P(*spec)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_shardings(params, mesh, rules: Optional[list] = None):
    """Map a parameter tree to :class:`NamedSharding` s by ``rules``, an
    ordered list of ``(path_regex, spec)``: the first rule whose regex
    matches the leaf's '/'-joined key path (e.g. ``"fc_1/weight"``; a
    list index as ``[i]``) wins, and a leaf no rule matches is
    replicated. A spec axis the leaf cannot take (a dimension the axis
    size does not divide, or one the leaf lacks) is dropped."""
    rules = rules or []
    rep = NamedSharding(mesh, P())

    def pick(path, leaf):
        keys = "/".join(path)
        for pat, spec in rules:
            if re.search(pat, keys):
                fixed = []
                for i, ax in enumerate(spec):
                    if ax is None or i >= leaf.ndim:
                        fixed.append(None)
                        continue
                    size = mesh_axis_size(mesh, ax) \
                        if isinstance(ax, str) else 1
                    fixed.append(ax if leaf.shape[i] % max(size, 1) == 0
                                 else None)
                return NamedSharding(mesh, P(*fixed[:leaf.ndim]))
        return rep

    return _map_with_path(pick, params)


def dp_train_step(apply_fn: Callable, loss_fn: Callable, optim, mesh,
                  data_axis: str = "data", donate: bool = True):
    """Build a data-parallel train step.

    ``apply_fn(params, states, x, rng) -> (y, new_states)``;
    ``loss_fn(y, t) -> scalar``; ``optim`` is an OptimMethod. Returns
    ``step(params, states, opt_state, x, t, lr, rng) -> (new_params,
    new_states, new_opt_state, loss)``, with ``x`` / ``t`` this rank's
    shard and ``loss`` the mean over the group. ``donate`` is accepted
    for the JAX signature; eager steps have no buffers to donate."""
    n = mesh_axis_size(mesh, data_axis)
    group = mesh.get_group(data_axis) if n > 1 else None

    def step(params, states, opt_state, x, t, lr, rng=None):
        leaves = [p.detach().requires_grad_(p.is_floating_point())
                  for p in tree_leaves(params)]
        with global_batch_stats(group):
            y, new_states = apply_fn(tree_unflatten(params, leaves), states,
                                     x, rng)
            loss = loss_fn(y, t)
        wanted = [p for p in leaves if p.requires_grad]
        got = dict(zip(map(id, wanted), torch.autograd.grad(
            loss, wanted, allow_unused=True)))
        grads = [got.get(id(p)) for p in leaves]
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        if n > 1:
            grads = all_reduce(grads, group, mean=True)
            loss = all_reduce(loss.detach(), group, mean=True)
        new_params, new_opt = optim.step(
            tree_unflatten(params, [p.detach() for p in leaves]),
            tree_unflatten(params, grads), opt_state, lr)
        return new_params, new_states, new_opt, loss.detach()

    return step
