"""Ragged in-place prefill helpers — the port of the ragged half of
``bigdl_tpu/llm/kvcache/prefill.py`` (``fork_tail_pages``,
``ragged_prefill_attend``, ``scatter_suffix_kv``). The dense staging
fallback (``make_partial_prefill``) and the mixed/spec step builders are
not ported yet (ROADMAP Queue 1 item 5).

The JAX package returns new pools from donated buffers; here the pools
are updated IN PLACE (PyTorch is eager and the pools are the engine's
own), and returned for the same call shape.
"""

from __future__ import annotations

from typing import Optional

import torch


def fork_tail_pages(k_pages, v_pages, fork_dst: int, fork_src: int):
    """COW tail fork: copy the adopted partial tail page ``fork_src``
    into the page the request owns, ``fork_dst``, in every layer, before
    the layers run. With no tail both ids are 0 (trash self-copy: a
    no-op, skipped)."""
    if int(fork_dst) != int(fork_src):
        k_pages[:, fork_dst] = k_pages[:, fork_src]
        v_pages[:, fork_dst] = v_pages[:, fork_src]
    return k_pages, v_pages


def ragged_prefill_attend(k_pages, v_pages, bt_row, offset: int,
                          seq_len: int, *, page: int,
                          sliding_window: Optional[int] = None):
    """Shared ragged-attention closure for a family's prefill. The pools
    ``(L, P, H, page, D)`` are viewed as one flat ``(L·P, ...)`` page
    array (a view, never a per-layer copy) and the block table is
    offset by ``l·P`` (layer ``l``'s trash page is ``l·P``); the kernel
    reads only prefix positions ``< offset`` from the pool. Returns
    ``attend(l, q, k, v) -> (1, Tq, Hq, D) f32``."""
    from bigdl_tpu_torch.llm.kernels.ragged_prefill import ragged_prefill
    L, P = k_pages.shape[0], k_pages.shape[1]
    kp_flat = k_pages.view((L * P,) + tuple(k_pages.shape[2:]))
    vp_flat = v_pages.view((L * P,) + tuple(v_pages.shape[2:]))
    dev = k_pages.device
    bt = bt_row.reshape(1, -1).to(device=dev, dtype=torch.int32)
    # filled on the device: an upload from pageable memory would wait for
    # the decode steps in flight
    offs = torch.full((1,), int(offset), dtype=torch.int32, device=dev)
    lens = torch.full((1,), int(seq_len), dtype=torch.int32, device=dev)

    def attend(l, q, k, v):
        return ragged_prefill(q, k, v, kp_flat, vp_flat, bt + l * P, offs,
                              lens, page_size=page,
                              sliding_window=sliding_window)

    return attend


def scatter_suffix_kv(k_pages, v_pages, phys, slots, k_new, v_new):
    """One scatter of every layer's suffix K/V into the pools, in place.
    ``k_new``/``v_new`` are ``(L, Tq, Hkv, D)``; token ``j`` lands in
    ``(phys[j], slots[j])`` (entries the request must not write route to
    trash page 0 — duplicate writes are harmless only there). The
    advanced indices on dims 1 and 3, with a slice between, put the
    broadcast (Tq,) dim first, as in numpy and JAX."""
    phys, slots = phys.long(), slots.long()
    k_pages[:, phys, :, slots] = k_new.transpose(0, 1).to(k_pages.dtype)
    v_pages[:, phys, :, slots] = v_new.transpose(0, 1).to(v_pages.dtype)
    return k_pages, v_pages
