"""The port's copy of ``bigdl_tpu/parallel/ring_attention.py``'s
:func:`online_block_update` — the one flash-style recurrence that the
JAX package shares between its ring kernel and the blockwise cache-window
path of ``llama._attention``. Only the block update is ported: the ring
over a device mesh is ROADMAP Queue 1 item 10 (rest).

Layout convention: ``(batch, seq, heads, head_dim)``.
"""

from __future__ import annotations

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
