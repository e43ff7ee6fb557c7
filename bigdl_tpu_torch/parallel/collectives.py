"""Collective wrappers — the port of ``bigdl_tpu/parallel/collectives.py``
over ``torch.distributed`` (NCCL on the card, gloo on the CPU).

Reference comm (SURVEY.md §2.5): ``AllReduceParameter`` puts gradient
slices into the BlockManager, slice owners fetch and reduce, workers
re-fetch the weights, with FP16 wire compression. Here:

- put/fetch+reduce       → :func:`all_reduce` / :func:`reduce_scatter`
- weight re-fetch        → :func:`all_gather`
- FP16CompressedTensor   → :func:`compressed_all_reduce` (bf16 wire)
- beyond the reference   → :func:`quantized_all_reduce` (int8 blocks
  under a shared scale)

Each takes a process group, or the name of a dimension of the Engine's
mesh, where the JAX one takes ``axis_name``; ``None`` is the default
group. The JAX wrappers run inside ``shard_map``; these run eagerly on
every rank, which must call them in the same order. A tree (dict, list
or tuple of tensors) is reduced as one flat buffer a call: one
collective for the whole tree, not one a leaf. Results come back in the
structure and dtypes given.

Ranks that share one card run gloo, which sums and broadcasts CUDA
tensors itself but gathers, exchanges and sends only host tensors. For
a gloo group holding CUDA tensors, :func:`all_gather`,
:func:`reduce_scatter`, :func:`all_to_all` and :func:`ppermute_next`
copy their payload to the host and their result back, explicitly; the
compute stays on the card. Only that case stages (never NCCL, never a
host tensor), and every staged byte is counted:
:func:`staged_bytes` holds the tally (:func:`collective_tally` that
of every collective), and with observability on
``bigdl_collective_staged_bytes_total`` (label ``op``) too.

Telemetry: every wrapper bumps ``bigdl_collective_traced_bytes_total``
and ``bigdl_collective_calls_total`` (label ``op``) with its input
payload, at the JAX package's byte rates (the carrier dtype; 2 bytes an
element for the bf16 wire; 1 + 4 / block for int8). The JAX package
counts once a compiled call site, at trace time; the port counts every
executed call, so the series grow by one call a step.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Optional

import torch
import torch.distributed as dist

from bigdl_tpu_torch import observability as obs
from bigdl_tpu_torch.utils.tree import tree_leaves, tree_unflatten


def resolve_group(group=None):
    """A process group from ``group``: itself, the Engine mesh's group
    along a dimension name, or ``None`` (the default group)."""
    if isinstance(group, str):
        from bigdl_tpu_torch.utils.engine import Engine
        return Engine.mesh().get_group(group)
    return group


def group_size(group=None) -> int:
    return dist.get_world_size(resolve_group(group))


def _count_collective(op: str, tree: Any, bytes_per_element=None):
    total = 0
    for leaf in tree_leaves(tree):
        if bytes_per_element is not None:
            total += int(leaf.numel() * bytes_per_element)
        else:
            total += leaf.numel() * leaf.element_size()
    calls, nbytes = _TALLY.get(op, (0, 0))
    _TALLY[op] = (calls + 1, nbytes + total)
    if not obs.enabled():
        return
    obs.counter("bigdl_collective_traced_bytes_total",
                "Input payload bytes per collective call (the port counts "
                "every executed call; multiply by the op's wire "
                "amplification — e.g. ~(n-1) recv copies for all_gather, "
                "~2(n-1)/n for ring all_reduce — for actual traffic)",
                labelnames=("op",)).labels(op=op).inc(total)
    obs.counter("bigdl_collective_calls_total",
                "Collective calls executed", labelnames=("op",)
                ).labels(op=op).inc()


# this process's collectives: {op: (calls, input payload bytes)}, and
# the copies between the card and the host of the staged ones
_TALLY: dict = {}
_STAGED = {"calls": 0, "bytes": 0}


def collective_tally() -> dict:
    """``{op: {"calls", "bytes"}}``: the collectives this process ran and
    their input payload bytes (as the telemetry counts them), since the
    last :func:`reset_tallies`."""
    return {op: {"calls": c, "bytes": b} for op, (c, b) in _TALLY.items()}


def staged_bytes() -> dict:
    """``{"calls", "bytes"}``: the host copies of the staged collectives
    and the bytes they moved between the card and the host (both ways),
    since the last :func:`reset_tallies`."""
    return dict(_STAGED)


def reset_tallies():
    _TALLY.clear()
    _STAGED.update(calls=0, bytes=0)


def _stages(x: torch.Tensor, g) -> bool:
    """A gloo group holding a CUDA tensor: the data movers stage."""
    return x.is_cuda and dist.get_backend(g) == "gloo"


def _to_host(op: str, x: torch.Tensor) -> torch.Tensor:
    _count_staged(op, x)
    return x.cpu()


def _to_card(op: str, y: torch.Tensor, device) -> torch.Tensor:
    _count_staged(op, y)
    return y.to(device)


def _count_staged(op: str, x: torch.Tensor):
    n = x.numel() * x.element_size()
    _STAGED["calls"] += 1
    _STAGED["bytes"] += n
    if obs.enabled():
        obs.counter("bigdl_collective_staged_bytes_total",
                    "Bytes a gloo collective of CUDA tensors copied "
                    "between the card and the host (both ways)",
                    labelnames=("op",)).labels(op=op).inc(n)


def _div(x: torch.Tensor, d: int) -> torch.Tensor:
    """``x / d`` correctly rounded on every device (a CUDA tensor divided
    by a Python number is multiplied by its reciprocal), with the divisor
    filled on ``x``'s device: no host copy, so no stream sync."""
    return x / torch.full((), float(d), dtype=x.dtype, device=x.device)


def _flat(leaves, dtype, block: int = 1):
    """One flat ``dtype`` buffer of ``leaves``, each padded with zeros to
    a multiple of ``block``: (buffer, each leaf's padded length). One
    concatenation (the pads are views of one zero block) and at most one
    cast, whatever the number of leaves."""
    parts, lens, zero = [], [], None
    for x in leaves:
        v = x.reshape(-1)
        pad = (-v.numel()) % block
        parts.append(v)
        if pad:
            if zero is None:
                zero = v.new_zeros(block)
            parts.append(zero[:pad])
        lens.append(v.numel() + pad)
    flat = torch.cat(parts) if len(parts) > 1 else parts[0].clone()
    return flat.to(dtype), lens


def _unflat(tree, leaves, flat, lens):
    """The tree of views of ``flat`` (cast back once when every leaf has
    one dtype)."""
    dtypes = {x.dtype for x in leaves}
    if len(dtypes) == 1:
        flat = flat.to(dtypes.pop())
    out, off = [], 0
    for x, n in zip(leaves, lens):
        out.append(flat[off:off + x.numel()].view(x.shape).to(x.dtype))
        off += n
    return tree_unflatten(tree, out)


def all_reduce(tree: Any, group=None, mean: bool = False) -> Any:
    """Sum (or mean) a tree across the group (ref: the gradient aggregate
    in AllReduceParameter.putGradients/getGradients); per dtype, one
    collective."""
    _count_collective("all_reduce", tree)
    g = resolve_group(group)
    leaves = tree_leaves(tree)
    out = [None] * len(leaves)
    for dtype in dict.fromkeys(x.dtype for x in leaves):
        idx = [i for i, x in enumerate(leaves) if x.dtype == dtype]
        part = [leaves[i] for i in idx]
        flat, lens = _flat(part, dtype)
        dist.all_reduce(flat, group=g)
        if mean:
            flat = _div(flat, dist.get_world_size(g))
        for i, y in zip(idx, _unflat(part, part, flat, lens)):
            out[i] = y
    return tree_unflatten(tree, out)


def compressed_all_reduce(tree: Any, group=None, mean: bool = False,
                          wire_dtype=torch.bfloat16) -> Any:
    """All-reduce with a 16-bit wire dtype (ref: FP16CompressedTensor):
    the sum is taken in the wire dtype, the mean divides in it, and the
    result is cast back to each leaf's dtype."""
    _count_collective("compressed_all_reduce", tree,
                      bytes_per_element=torch.finfo(wire_dtype).bits // 8)
    g = resolve_group(group)
    leaves = tree_leaves(tree)
    flat, lens = _flat(leaves, wire_dtype)
    dist.all_reduce(flat, group=g)
    if mean:
        flat = _div(flat, dist.get_world_size(g))
    return _unflat(tree, leaves, flat, lens)


def quantized_all_reduce(tree: Any, group=None, mean: bool = False,
                         block: int = 256) -> Any:
    """INT8 block-quantized all-reduce under a shared scale, the JAX
    package's two-collective scheme: a MAX all-reduce of each block's
    absmax (each leaf padded to whole blocks of ``block``) gives the
    shared scale ``max / 127``; every rank rounds (half to even) and
    clips to ±127 against it; the int8 payloads are summed in int32; one
    dequant, then ``/ world`` for the mean. The only error is each
    rank's own rounding: at most ``world * scale / 2`` an element."""
    _count_collective("quantized_all_reduce", tree,
                      bytes_per_element=1.0 + 4.0 / block)
    g = resolve_group(group)
    n = dist.get_world_size(g)
    leaves = tree_leaves(tree)
    flat, lens = _flat(leaves, torch.float32, block)
    blocks = flat.view(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=g)
    scale = _div(scale, 127)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.round(blocks / safe).clamp_(-127, 127).to(torch.int8)
    q_sum = q.to(torch.int32)
    dist.all_reduce(q_sum, group=g)
    out = (q_sum.to(torch.float32) * scale).reshape(-1)
    if mean:
        out = _div(out, n)
    return _unflat(tree, leaves, out, lens)


def all_gather(x: torch.Tensor, group=None, axis: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """Gather every rank's ``x`` along ``axis``: concatenated when
    ``tiled``, else stacked on a new ``axis`` (ref:
    AllReduceParameter.getWeights)."""
    _count_collective("all_gather", x)
    g = resolve_group(group)
    n = dist.get_world_size(g)
    staged = _stages(x, g)
    src = _to_host("all_gather", x) if staged else x
    out = src.new_empty((n,) + tuple(x.shape))
    dist.all_gather_into_tensor(out, src.contiguous()[None], group=g)
    if staged:
        out = _to_card("all_gather", out, x.device)
    parts = out.unbind(0)
    return torch.cat(parts, dim=axis) if tiled else \
        torch.stack(parts, dim=axis)


def reduce_scatter(x: torch.Tensor, group=None, axis: int = 0
                   ) -> torch.Tensor:
    """Sum across the group and keep this rank's slice of dimension
    ``axis`` (the fused put-gradients + owner-reduce)."""
    _count_collective("reduce_scatter", x)
    g = resolve_group(group)
    n = dist.get_world_size(g)
    xm = x.movedim(axis, 0).contiguous()
    if xm.shape[0] % n:
        raise ValueError(f"dimension {axis} of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    staged = _stages(x, g)
    if staged:
        xm = _to_host("reduce_scatter", xm)
    out = xm.new_empty((xm.shape[0] // n,) + tuple(xm.shape[1:]))
    dist.reduce_scatter_tensor(out, xm, group=g)
    if staged:
        out = _to_card("reduce_scatter", out, x.device)
    return out.movedim(0, axis)


def all_to_all(x: torch.Tensor, group=None, split_axis: int = 0,
               concat_axis: int = 0, tiled: bool = True) -> torch.Tensor:
    """Rank ``i``'s ``j``-th piece of ``split_axis`` goes to rank ``j``,
    which joins what it receives along ``concat_axis`` (Ulysses sequence
    parallelism's transpose). Untiled, ``split_axis`` has the group's
    size and the pieces are stacked on a new ``concat_axis``."""
    _count_collective("all_to_all", x)
    g = resolve_group(group)
    n = dist.get_world_size(g)
    if tiled:
        pieces = [p.contiguous() for p in x.chunk(n, dim=split_axis)]
    else:
        pieces = [p.contiguous() for p in x.unbind(split_axis)]
    if len(pieces) != n or any(p.shape != pieces[0].shape for p in pieces):
        raise ValueError(f"dimension {split_axis} of {tuple(x.shape)} does "
                         f"not split over {n} ranks")
    # one buffer, piece j in row j: ``all_to_all_single`` (gloo has no
    # list all-to-all)
    send = torch.stack(pieces)
    staged = _stages(x, g)
    if staged:
        send = _to_host("all_to_all", send)
    got = torch.empty_like(send)
    dist.all_to_all_single(got, send, group=g)
    if staged:
        got = _to_card("all_to_all", got, x.device)
    got = got.unbind(0)
    return torch.cat(got, dim=concat_axis) if tiled else \
        torch.stack(got, dim=concat_axis)


def ppermute_next(x: torch.Tensor, group=None, shift: int = 1
                  ) -> torch.Tensor:
    """Circular shift: rank ``i``'s ``x`` lands on rank ``(i + shift) %
    n`` (ring attention's neighbour exchange)."""
    _count_collective("ppermute", x)
    g = resolve_group(group)
    n = dist.get_world_size(g)
    if n == 1 or shift % n == 0:
        return x.clone()
    r = dist.get_rank(g)
    peer = [dist.get_global_rank(g, i) if g is not None else i
            for i in ((r + shift) % n, (r - shift) % n)]
    staged = _stages(x, g)
    src = _to_host("ppermute", x) if staged else x.contiguous()
    out = torch.empty_like(src)
    for w in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, src, peer[0], g),
            dist.P2POp(dist.irecv, out, peer[1], g)]):
        w.wait()
    return _to_card("ppermute", out, x.device) if staged else out


def barrier_sum(group=None) -> torch.Tensor:
    """A synchronisation point that returns the group's size as an int32
    0-d tensor on the group's device (ref: ParameterSynchronizer
    barrier)."""
    g = resolve_group(group)
    device = "cuda" if dist.get_backend(g) == "nccl" else "cpu"
    one = torch.ones((), dtype=torch.int32, device=device)
    dist.all_reduce(one, group=g)
    return one


class _SumAcross(torch.autograd.Function):
    """``all_reduce`` SUM with autograd: the gradient of a sum every rank
    holds is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def differentiable_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``x`` over the group's ranks, differentiable (each
    rank's share of the gradient flows back to it)."""
    g = resolve_group(group)
    return _div(_SumAcross.apply(x, g), dist.get_world_size(g))


# The group over which batch normalisation takes its statistics while a
# data-parallel step runs in the JAX package's plain (SPMD) mode; None
# outside one: each process normalises over its own batch.
_BATCH_STATS_GROUP: contextvars.ContextVar = contextvars.ContextVar(
    "bigdl_batch_stats_group", default=None)


def batch_stats_group() -> Optional[Any]:
    return _BATCH_STATS_GROUP.get()


@contextlib.contextmanager
def global_batch_stats(group):
    """Within the block, batch normalisation reduces its moments over
    ``group``, so it normalises with the global batch's statistics."""
    token = _BATCH_STATS_GROUP.set(group)
    try:
        yield
    finally:
        _BATCH_STATS_GROUP.reset(token)
