"""Ring attention — the port of ``bigdl_tpu/parallel/ring_attention.py``:
sequence (context) parallelism for long sequences. The sequence axis is
split over a mesh axis; each rank attends its query chunk to every K/V
chunk in turn while the K/V chunks rotate one neighbour a step around
the ring (:func:`~bigdl_tpu_torch.parallel.collectives.ppermute_next`),
with the flash-style online softmax of :func:`online_block_update`
(shared with the blockwise cache-window path of ``llama._attention``),
so the full score matrix never exists.

The JAX body runs inside ``shard_map``; here every rank runs
:func:`ring_self_attention` on its own chunk, eagerly, and
:func:`ring_attention` cuts the global tensors and joins the result.

Layout convention: ``(batch, seq, heads, head_dim)``.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def online_block_update(qg, k, v, mask, acc, row_max, row_sum, *, scale):
    """One kv-block flash-style online-softmax update, GQA grouped layout.

    qg: (B, Tq, Hkv, G, D) — query heads grouped onto their kv head
        (q head ``h`` = group ``h % G`` of kv head ``h // G``);
        repeated K/V is never materialised.
    k, v: (B, Sk, Hkv, D); mask: (B, Tq, Sk) (or broadcastable), True
        where attending is allowed.
    acc: (B, Hkv, G, Tq, D) f32; row_max/row_sum: (B, Hkv, G, Tq) f32.
    Returns the updated ``(acc, row_max, row_sum)``.

    Scores and products are taken in f32 from f32 copies of q, K and V:
    the JAX einsums multiply bf16 inputs with ``preferred_element_type=
    float32``, which is the same arithmetic (a bf16 product is exact in
    f32), while a bf16 ``torch.einsum`` would round its sums to bf16.
    """
    logits = torch.einsum("bthgd,bshd->bhgts", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    masked = ~mask[:, None, None]
    logits = logits.masked_fill_(masked, NEG_INF)
    blk_max = logits.amax(dim=-1)                      # (B, Hkv, G, Tq)
    new_max = torch.maximum(row_max, blk_max)
    correction = torch.exp(row_max - new_max)
    # rows with no valid key in this block: exp(NEG_INF - max) underflows
    # to 0 except when the row max itself is NEG_INF — zero explicitly
    p = torch.exp(logits - new_max[..., None]).masked_fill_(masked, 0.0)
    acc = acc * correction[..., None] + torch.einsum(
        "bhgts,bshd->bhgtd", p, v.to(torch.float32))
    row_sum = row_sum * correction + p.sum(dim=-1)
    return acc, new_max, row_sum


def _block_attn(q, k, v, acc, row_max, row_sum, *, scale, q_pos, k_pos,
                causal):
    """One ring step over :func:`online_block_update`. q (B, Sq, Hq, D);
    k, v (B, Sk, Hkv, D); acc (B, Hkv, G, Sq, D); row_max / row_sum
    (B, Hkv, G, Sq)."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, d)
    if causal:
        mask = (q_pos[:, None] >= k_pos[None, :]).expand(b, sq, sk)
    else:
        mask = torch.ones((b, sq, sk), dtype=torch.bool, device=q.device)
    return online_block_update(qg, k, v, mask, acc, row_max, row_sum,
                               scale=scale)


def ring_self_attention(q, k, v, axis_name="seq", causal: bool = False,
                        scale: Optional[float] = None):
    """This rank's body: q/k/v (B, S_local, H, D), its chunk of a
    sequence split in rank order over ``axis_name`` (a group, or a
    dimension of the Engine's mesh). After ``i`` shifts the rank holds
    chunk ``(rank - i) mod n``; the K/V pair is shifted ``n - 1`` times
    (the JAX scan's last shift is never read). GQA is grouped, never
    repeated."""
    import torch.distributed as dist

    from bigdl_tpu_torch.parallel.collectives import (group_size,
                                                      ppermute_next,
                                                      resolve_group)
    g = resolve_group(axis_name)
    n = group_size(g)
    my = dist.get_rank(g)
    b, s_local, h, d = q.shape
    hkv = k.shape[2]
    grp = h // hkv
    scale = scale if scale is not None else d ** -0.5
    dev = q.device
    q_pos = my * s_local + torch.arange(s_local, device=dev)
    acc = torch.zeros((b, hkv, grp, s_local, d), dtype=torch.float32,
                      device=dev)
    row_max = torch.full((b, hkv, grp, s_local), NEG_INF,
                         dtype=torch.float32, device=dev)
    row_sum = torch.zeros((b, hkv, grp, s_local), dtype=torch.float32,
                          device=dev)
    for i in range(n):
        chunk = (my - i) % n
        k_pos = chunk * s_local + torch.arange(s_local, device=dev)
        acc, row_max, row_sum = _block_attn(
            q, k, v, acc, row_max, row_sum, scale=scale, q_pos=q_pos,
            k_pos=k_pos, causal=causal)
        if i < n - 1:
            k = ppermute_next(k, g)
            v = ppermute_next(v, g)
    out = acc / torch.clamp(row_sum, min=1e-30)[..., None]  # (B,Hkv,G,S,D)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s_local, h, d).to(q.dtype)


def split_over(mesh, tensors, axis: str, batch_axis: Optional[str]):
    """This rank's pieces of global (B, S, ...) tensors: the sequence cut
    over ``axis`` and, where the mesh has it, the batch over
    ``batch_axis``; returns ``(pieces, join)``, ``join(local)`` gathering
    a local (B/.., S/.., ...) result back into the global tensor on every
    rank."""
    from bigdl_tpu_torch.parallel.collectives import all_gather
    from bigdl_tpu_torch.parallel.mesh import mesh_axis_size
    names = mesh.mesh_dim_names or ()
    baxis = batch_axis if (batch_axis and batch_axis in names) else None
    cuts = [(1, axis)] + ([(0, baxis)] if baxis else [])

    def cut(t):
        for dim, ax in cuts:
            n = mesh_axis_size(mesh, ax)
            if t.shape[dim] % n:
                raise ValueError(f"dimension {dim} of {tuple(t.shape)} does "
                                 f"not split over {n} ranks of {ax!r}")
            t = t.chunk(n, dim=dim)[mesh.get_local_rank(ax)]
        return t

    def join(t):
        for dim, ax in reversed(cuts):
            if mesh_axis_size(mesh, ax) > 1:
                t = all_gather(t, mesh.get_group(ax), axis=dim)
        return t

    return [cut(t) for t in tensors], join


def ring_attention(q, k, v, mesh, axis: str = "seq", causal: bool = False,
                   scale: Optional[float] = None,
                   batch_axis: Optional[str] = "data"):
    """The global entry: q/k/v are the whole (B, S, H, D) tensors (the
    same on every rank); S is cut over ``axis`` (and B over
    ``batch_axis`` where the mesh has it), each rank runs
    :func:`ring_self_attention` on its cut, and the result is gathered
    back to (B, S, H, D) on every rank."""
    (q, k, v), join = split_over(mesh, (q, k, v), axis, batch_axis)
    return join(ring_self_attention(q, k, v, mesh.get_group(axis),
                                    causal=causal, scale=scale))
