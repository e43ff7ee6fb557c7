"""Pipeline parallelism over a ``pipe`` mesh axis — the port of
``bigdl_tpu/parallel/pipeline.py``: the GPipe schedule. Each rank along
the axis holds one stage's weights (a homogeneous stacked-stage tree,
leading dimension ``n_stages``, of which a rank keeps its own slice) and
microbatch activations flow to the next stage, one neighbour hop a tick.
``n_micro + n_stages - 1`` ticks drain the pipeline; the bubble is
``(n_stages - 1) / (n_micro + n_stages - 1)`` of them.

As in the JAX package the stages must be homogeneous: one apply function
and one parameter structure a stage, and activations of one shape
throughout.

The JAX schedule is a ``lax.scan`` of ``ppermute`` s that autodiff
transposes into the backward ring. Eager PyTorch has no such transform
across processes: :func:`make_pipeline_train_step` runs the forward
ticks keeping each microbatch's stage graph, then the ticks in reverse,
each stage back-propagating through its own graph and sending the
activation cotangent to the stage before it (the ring the other way).
Each stage's weight gradient accumulates over its microbatches, as in
the scan's transpose. A rank skips the ticks its stage has no
microbatch for (the JAX scan computes them and masks the result): the
sends still happen every tick, so the ranks stay in step.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from bigdl_tpu_torch.parallel.collectives import (group_size, ppermute_next,
                                                  resolve_group)
from bigdl_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


def _from_last(y: torch.Tensor, g, n: int) -> torch.Tensor:
    """The last stage's ``y`` on every rank of the group (the JAX body's
    psum of a buffer only the last stage filled)."""
    if n == 1:
        return y
    y = y.contiguous()
    dist.broadcast(y, dist.get_global_rank(g, n - 1), group=g)
    return y


def _run(stage_apply, stage_params, microbatches, g, keep: bool,
         remat: bool = False):
    """The forward ticks on this rank: ``(outputs (n_micro, ...) of the
    last stage on every rank, {m: (x, y)} of this stage)``; with ``keep``
    each ``(x, y)`` holds the microbatch's graph (``x`` a leaf that takes
    the cotangent on every stage but the first)."""
    n = group_size(g)
    idx = dist.get_rank(g)
    n_micro = microbatches.shape[0]
    state = torch.zeros_like(microbatches[0])
    saved, outs = {}, []
    for t in range(n_micro + n - 1):
        m = t - idx
        if 0 <= m < n_micro:
            x = microbatches[m] if idx == 0 else state
            if keep:
                x = x.detach().requires_grad_(idx > 0
                                              and x.is_floating_point())
                if remat:
                    from torch.utils.checkpoint import checkpoint
                    y = checkpoint(stage_apply, stage_params, x,
                                   use_reentrant=False)
                else:
                    y = stage_apply(stage_params, x)
            else:
                with torch.no_grad():
                    y = stage_apply(stage_params, x)
            saved[m] = (x, y)
            if idx == n - 1:
                outs.append(y.detach())
            send = y.detach()
        else:
            send = torch.zeros_like(state)
        state = ppermute_next(send, g) if n > 1 else send
    like = saved[0][1] if 0 in saved else next(iter(saved.values()))[1]
    out = torch.stack(outs) if idx == n - 1 else like.new_empty(
        (n_micro,) + tuple(like.shape))
    return _from_last(out.detach(), g, n), saved


def pipeline_stage_fn(stage_apply: Callable, axis_name="pipe"):
    """This rank's pipeline body. ``stage_apply(stage_params, x) -> y``
    maps one microbatch through one stage. Returns ``run(stage_params,
    microbatches)``: ``stage_params`` this rank's stage (no stage axis),
    ``microbatches`` (n_micro, mb, ...), the same on every rank (only
    stage 0 reads it); the result (n_micro, mb, ...) is the last stage's
    output, on every rank of ``axis_name`` (a group, or a dimension of
    the Engine's mesh)."""
    def run(stage_params, microbatches):
        return _run(stage_apply, stage_params,
                    torch.as_tensor(microbatches),
                    resolve_group(axis_name), keep=False)[0]
    return run


class PipelineModule:
    """Pipeline executor over stacked homogeneous stages.

    ``stage_apply(stage_params, x) -> y``; a stacked tree's leaves have a
    leading stage axis. ``remat`` recomputes each stage's activations in
    the backward ticks instead of keeping them
    (``torch.utils.checkpoint``, the port of ``jax.checkpoint``)."""

    def __init__(self, stage_apply: Callable, n_stages: int, mesh,
                 axis: str = "pipe", remat: bool = False):
        names = mesh.mesh_dim_names or ()
        if axis not in names:
            raise ValueError(f"mesh has no axis {axis!r}")
        size = mesh.size(names.index(axis))
        if size != n_stages:
            raise ValueError(
                f"mesh axis {axis}={size} != n_stages {n_stages}")
        self.mesh = mesh
        self.axis = axis
        self.n_stages = n_stages
        self.remat = remat
        self.group = mesh.get_group(axis)
        self.stage = mesh.get_local_rank(axis)
        self.stage_apply = stage_apply

    def local(self, stacked_params):
        """This rank's stage of a stacked tree (placed, leading dimension
        1, or whole, leading dimension ``n_stages``), stage axis dropped."""
        return tree_map(lambda l: l[0] if l.shape[0] == 1 else
                        l[self.stage], stacked_params)

    def __call__(self, stacked_params, microbatches):
        """microbatches (n_micro, mb, ...) -> the last stage's (n_micro,
        mb, ...), on every rank."""
        return _run(self.stage_apply, self.local(stacked_params),
                    torch.as_tensor(microbatches), self.group,
                    keep=False)[0]

    def place_params(self, stacked_params):
        """This rank's stage of the stacked tree, the stage axis kept (of
        size 1): the rows the JAX ``place_params`` puts on this device."""
        return tree_map(lambda l: torch.as_tensor(l)[
            self.stage:self.stage + 1].clone(), stacked_params)


def split_microbatches(batch, n_micro: int):
    """(B, ...) -> (n_micro, B/n_micro, ...), leaf by leaf."""
    def split(a):
        b = a.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} not divisible by {n_micro}")
        return a.reshape((n_micro, b // n_micro) + tuple(a.shape[1:]))
    return tree_map(split, batch)


def make_pipeline_train_step(pipe: PipelineModule, loss_fn: Callable,
                             optim, lr: float):
    """GPipe training with gradient accumulation (module docstring).

    ``loss_fn(outputs, targets) -> scalar`` sees the full ``(n_micro, mb,
    ...)`` stacks. Returns ``step(stacked_params, opt_state,
    microbatches, targets) -> (new_params, new_opt_state, loss)``: the
    params and state are this rank's stage (``pipe.place_params``), the
    loss the same on every rank, taken before the update."""
    g, n, idx = pipe.group, pipe.n_stages, pipe.stage

    def step(stacked_params, opt_state, microbatches, micro_targets):
        leaves = [p.detach().requires_grad_(p.is_floating_point())
                  for p in tree_leaves(stacked_params)]
        local = pipe.local(tree_unflatten(stacked_params, leaves))
        microbatches = torch.as_tensor(microbatches)
        outs, saved = _run(pipe.stage_apply, local, microbatches, g,
                           keep=True, remat=pipe.remat)
        targets = torch.as_tensor(micro_targets)
        if idx == n - 1:
            o = outs.detach().requires_grad_()
            loss = loss_fn(o, targets)
            g_out = torch.autograd.grad(loss, o)[0]
        else:
            with torch.no_grad():
                loss = loss_fn(outs, targets)
        wanted = [p for p in leaves if p.requires_grad]
        acc = [torch.zeros_like(p) for p in wanted]
        n_micro = microbatches.shape[0]
        recv = None
        for t in reversed(range(n_micro + n - 1)):
            m = t - idx
            send = None
            if 0 <= m < n_micro:
                x, y = saved.pop(m)
                gy = g_out[m] if idx == n - 1 else recv
                inputs = wanted + ([x] if x.requires_grad else [])
                got = torch.autograd.grad(y, inputs, gy, allow_unused=True)
                for a, gp in zip(acc, got[:len(wanted)]):
                    if gp is not None:
                        a.add_(gp)
                if x.requires_grad:
                    send = got[-1]
            if n > 1:
                recv = ppermute_next(
                    torch.zeros_like(microbatches[0]) if send is None
                    else send, g, shift=-1)
        by_id = dict(zip(map(id, wanted), acc))
        grads = [by_id.get(id(p), torch.zeros_like(p)) for p in leaves]
        new_params, new_opt = optim.step(
            tree_unflatten(stacked_params, [p.detach() for p in leaves]),
            tree_unflatten(stacked_params, grads), opt_state, lr)
        return new_params, new_opt, loss.detach()

    return step
