"""Ulysses sequence parallelism — the port of
``bigdl_tpu/parallel/ulysses.py``: two all-to-alls re-cut the
sequence-split q/k/v by heads, each rank attends the whole sequence over
its slice of the heads, and the output is cut back by sequence. One
pair of collectives where the ring takes n neighbour steps: the better
trade for shorter sequences with many heads.

As with the ring, the JAX body runs inside ``shard_map``; here every
rank runs :func:`ulysses_self_attention` on its own chunk, and
:func:`ulysses_attention` cuts the global tensors and joins the result.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from bigdl_tpu_torch.parallel.collectives import (all_to_all, group_size,
                                                  resolve_group)
from bigdl_tpu_torch.parallel.ring_attention import split_over


def _sdpa(q, k, v, causal: bool, scale: float):
    """Full-sequence attention over local heads, q/k/v (B, S, h, D): the
    scores, softmax and V product in f32 (the JAX einsums'
    ``preferred_element_type=float32``), cast to q's dtype."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if causal:
        s_q, s_k = q.shape[1], k.shape[1]
        mask = (torch.arange(s_q, device=q.device)[:, None]
                >= torch.arange(s_k, device=q.device)[None, :])
        logits = logits.masked_fill(~mask[None, None], -1e30)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32))
    return out.to(q.dtype)


def ulysses_self_attention(q, k, v, axis_name="seq", causal: bool = False,
                           scale: Optional[float] = None,
                           attn_fn: Optional[Callable] = None):
    """This rank's body: q/k/v (B, S_local, H, D), H divisible by the
    size of ``axis_name`` (a group, or a dimension of the Engine's
    mesh). A custom ``attn_fn(q, k, v, causal=, scale=)`` must honour
    both."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    g = resolve_group(axis_name)
    n = group_size(g)
    if q.shape[2] % n != 0:
        raise ValueError(f"heads {q.shape[2]} not divisible by axis size {n}")

    def seq_to_head(t):   # (B, S/n, H, D) -> (B, S, H/n, D)
        return all_to_all(t, g, split_axis=2, concat_axis=1)

    def head_to_seq(t):   # (B, S, H/n, D) -> (B, S/n, H, D)
        return all_to_all(t, g, split_axis=1, concat_axis=2)

    q, k, v = seq_to_head(q), seq_to_head(k), seq_to_head(v)
    out = (attn_fn or _sdpa)(q, k, v, causal=causal, scale=scale)
    return head_to_seq(out)


def ulysses_attention(q, k, v, mesh, axis: str = "seq",
                      causal: bool = False, scale: Optional[float] = None,
                      batch_axis: Optional[str] = "data"):
    """The global entry, :func:`~bigdl_tpu_torch.parallel.ring_attention.
    ring_attention`'s signature: whole (B, S, H, D) tensors in, the
    whole output on every rank."""
    (q, k, v), join = split_over(mesh, (q, k, v), axis, batch_axis)
    return join(ulysses_self_attention(q, k, v, mesh.get_group(axis),
                                       causal=causal, scale=scale))
