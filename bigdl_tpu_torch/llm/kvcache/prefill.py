"""Partial prefill over a pre-populated block-table prefix — the port of
``bigdl_tpu/llm/kvcache/prefill.py``:

- the **ragged in-place path** (the default): shared closures
  (:func:`fork_tail_pages`, :func:`ragged_prefill_attend`,
  :func:`scatter_suffix_kv`) that a family's ``paged_prefill_ragged``
  composes with its layer math. The suffix attends the prefix pages
  where they sit through the ragged kernel, the COW tail fork is one
  page copy ahead of the layers, and one scatter after them writes the
  suffix K/V. Offsets, lengths and fork ids are device scalars, so the
  whole prefill can be captured in a CUDA graph;
- :func:`make_mixed_step`, the engine's unified prefill+decode step: one
  prefill chunk and every decode row in one step;
- :func:`make_spec_step`, the engine's speculative verify step: one
  row's drafts as a chunk with full logits and the greedy accept, beside
  every other decode row;
- :func:`make_partial_prefill`, the dense staging path behind
  ``ragged_prefill=False``: the family ``forward`` over the prefix
  gathered into a dense temp cache, at a position offset.

The JAX package returns new pools from donated buffers; here the pools
are updated IN PLACE (the pools are the engine's own, and a captured
graph holds their addresses), and returned for the same call shape.
"""

from __future__ import annotations

from typing import Optional

import torch


def device_i32(x, device) -> torch.Tensor:
    """``x`` as an int32 tensor on ``device``: a tensor is moved (a no-op
    on its own device, so capturable), a Python int is filled in on the
    device (no pageable upload waiting behind the steps in flight)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32)
    return torch.full((), int(x), dtype=torch.int32, device=device)


def fork_tail_pages(k_pages, v_pages, fork_dst, fork_src):
    """COW tail fork: copy the adopted partial tail page ``fork_src``
    into the page the request owns, ``fork_dst``, in every layer, before
    the layers run. Unconditional: with no tail both ids are 0, a
    trash-page self-copy (as in JAX), so no host branch reads the ids
    and the copy can be captured."""
    dev = k_pages.device
    dst = device_i32(fork_dst, dev).reshape(1).long()
    src = device_i32(fork_src, dev).reshape(1).long()
    k_pages.index_copy_(1, dst, k_pages.index_select(1, src))
    v_pages.index_copy_(1, dst, v_pages.index_select(1, src))
    return k_pages, v_pages


def ragged_prefill_attend(k_pages, v_pages, bt_row, offset, seq_len, *,
                          page: int,
                          sliding_window: Optional[int] = None):
    """Shared ragged-attention closure for a family's prefill. The pools
    ``(L, P, H, page, D)`` are viewed as one flat ``(L·P, ...)`` page
    array (a view, never a per-layer copy) and the block table is
    offset by ``l·P`` (layer ``l``'s trash page is ``l·P``); the kernel
    reads only prefix positions ``< offset`` from the pool. ``offset``
    and ``seq_len`` are device scalars (or ints). Returns
    ``attend(l, q, k, v) -> (1, Tq, Hq, D) f32``."""
    from bigdl_tpu_torch.llm.kernels.ragged_prefill import ragged_prefill
    L, P = k_pages.shape[0], k_pages.shape[1]
    kp_flat = k_pages.view((L * P,) + tuple(k_pages.shape[2:]))
    vp_flat = v_pages.view((L * P,) + tuple(v_pages.shape[2:]))
    dev = k_pages.device
    bt = bt_row.reshape(1, -1).to(device=dev, dtype=torch.int32)
    offs = device_i32(offset, dev).reshape(1)
    lens = device_i32(seq_len, dev).reshape(1)

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


def make_mixed_step(fam_step, fam_ragged):
    """Lift a family ``(paged_decode_step, paged_prefill_ragged)`` pair
    into the engine's unified mixed prefill+decode step: one prefill
    chunk and every active decode row in one step, so a long admission
    no longer stalls the decode rows for a whole prefill.

    - the **chunk leg** runs first: the family's ``paged_prefill_ragged``
      verbatim over the ``(1, bucket)`` chunk (COW fork, attention over
      the cached prefix and the earlier chunks where they sit, one
      scatter of the chunk's K/V into its own pages). Its page writes
      are disjoint from every decode row's, so the leg order changes no
      row's result;
    - the **decode leg** is the engine's sampled decode step verbatim;
      the chunking slot rides it masked inactive (a trash-page dummy
      write), like an empty slot.

    Returns ``(toks, logits, k_pages, v_pages, new_lens, clast)``:
    the decode leg's sampled ids, logits and lengths, and ``clast``, the
    chunk's last-token logits, which the engine puts into its ``last``
    row when the final chunk completes the prompt. The pools are
    updated in place; chunk offsets, lengths, tables and targets are
    device data, so the step is captured once per chunk bucket."""
    from bigdl_tpu_torch.llm.kernels.sampling import make_sampled_step
    sampled = make_sampled_step(fam_step)

    def mixed_step(params, cfg, k_pages, v_pages, bt, lens, last, active,
                   temperature, generator, ctoks, clen, coff, cbt_row,
                   cphys, cslots, fork_dst, fork_src, *, page: int,
                   do_sample: bool = False, top_k: int = 0):
        k_pages, v_pages, clast = fam_ragged(
            params, cfg, k_pages, v_pages, ctoks, clen, coff, cbt_row,
            cphys, cslots, fork_dst, fork_src, page=page)
        toks, logits, k_pages, v_pages, new_lens = sampled(
            params, cfg, k_pages, v_pages, bt, lens, last, active,
            temperature, generator, page=page, do_sample=do_sample,
            top_k=top_k)
        return toks, logits, k_pages, v_pages, new_lens, clast

    return mixed_step


def make_spec_step(fam_step, fam_ragged):
    """Lift a family ``(paged_decode_step, paged_prefill_ragged)`` pair
    into the engine's speculative verify step: the mixed step's chunk
    leg re-aimed at decode. The ``(1, W)`` chunk carries row ``srow``'s
    next greedy token and then the host's n-gram drafts, run at the
    row's length as offset; one pass gives the logits of every chunk
    position, and ``spec_accept`` keeps the prefix greedy decode would
    have produced anyway.

    - chunk token 0 is computed on the device, ``g0 = argmax(last
      [srow])``: the token the decode leg would have emitted. With every
      draft rejected the step is a plain decode step for the row (emit
      ``g0``, its K/V written at ``lens[srow]``, carry
      ``chunk_logits[0]``);
    - the chunk leg is the family's ``paged_prefill_ragged`` with
      ``full_logits=True`` over the row's own block table, with no fork
      (``fork_dst`` = ``fork_src`` = 0, the trash self-copy): a decode
      row's tail pages are its own. Padding past ``n_draft + 1`` goes
      to trash page 0 through the host's scatter targets;
    - the decode leg is the sampled decode step with the spec row
      masked inactive (a trash-page dummy write);
    - the spec row's length then advances by ``n_acc`` and
      ``chunk_logits[n_acc - 1]`` goes into its ``last``. K/V written
      at rejected positions is rolled back by the length alone:
      attention reads only positions ``< lens``, and later steps
      overwrite those slots.

    Returns ``(out, logits, k_pages, v_pages, new_lens)``: ``out``
    ``(B + 1 + W,)`` int32 holds the decode rows' sampled ids (the spec
    row's lane is unused), ``n_acc``, then the W chunk tokens (the host
    learns ``g0`` from it). ``srow``, ``n_draft``, the offset and the
    scatter targets are device data, so the step is captured once per
    chunk bucket W. The pools are updated in place."""
    from bigdl_tpu_torch.llm.kernels.sampling import (make_sampled_step,
                                                      spec_accept)
    sampled = make_sampled_step(fam_step)

    def spec_step(params, cfg, k_pages, v_pages, bt, lens, last, active,
                  temperature, generator, srow, ctoks, n_draft, cbt_row,
                  cphys, cslots, *, page: int, do_sample: bool = False,
                  top_k: int = 0):
        b = lens.shape[0]
        dev = lens.device
        srow = device_i32(srow, dev).reshape(1)
        n_draft = device_i32(n_draft, dev)
        onehot = torch.arange(b, device=dev) == srow
        g0 = torch.argmax(last.index_select(0, srow.long())[0]).to(
            torch.int32)
        ctoks = torch.cat([g0.reshape(1, 1),
                           ctoks[:, 1:].to(device=dev, dtype=torch.int32)],
                          1)
        coff = lens.index_select(0, srow.long())[0]
        k_pages, v_pages, chunk_logits = fam_ragged(
            params, cfg, k_pages, v_pages, ctoks, n_draft + 1, coff,
            cbt_row, cphys, cslots, 0, 0, page=page, full_logits=True)
        n_acc, new_slast = spec_accept(ctoks[0], chunk_logits, n_draft)
        toks, logits, k_pages, v_pages, new_lens = sampled(
            params, cfg, k_pages, v_pages, bt, lens, last,
            active & ~onehot, temperature, generator, page=page,
            do_sample=do_sample, top_k=top_k)
        new_lens = new_lens + torch.where(
            onehot, n_acc, torch.zeros_like(n_acc)).to(new_lens.dtype)
        logits = torch.where(onehot[:, None], new_slast[None, :], logits)
        out = torch.cat([toks[:b], n_acc.reshape(1), ctoks[0]])
        return out, logits, k_pages, v_pages, new_lens

    return spec_step


def make_partial_prefill(forward_fn, init_cache_fn):
    """Lift a family ``forward`` / ``init_cache`` pair into the dense
    staging prefill (``ragged_prefill=False``)::

        partial_prefill(params, cfg, k_pages, v_pages, toks, length,
                        offset, prefix_ids, phys, slots, *, page)
        -> (k_pages, v_pages, last_logits (V,) f32)

    ``toks`` (1, bucket) suffix tokens, zero-padded; ``length`` the true
    suffix length; ``offset`` the cached-prefix length, the position
    offset; ``prefix_ids`` (n_pp,) the pages holding positions
    ``0 .. offset`` in order (pad entries 0, the trash page); ``phys`` /
    ``slots`` (page + bucket,) the scatter targets of the page-aligned
    window from ``(offset // page) * page``, whose leading sub-page slots
    re-write an adopted tail into the fork page the request owns (the
    COW fork inside the write-back), padding routed to page 0.

    The prefix is gathered into a dense temp cache of ``n_pp·page + page
    + bucket`` positions, the suffix runs through ``forward`` at the
    offset (attending the gathered prefix and itself causally), and the
    window is scattered back into the pools in place. Garbage in pad
    pages or past the offset is overwritten by the suffix's own cache
    writes or masked by ``forward``'s validity bound."""

    def partial_prefill(params, cfg, k_pages, v_pages, toks, length,
                        offset, prefix_ids, phys, slots, *, page: int):
        L = k_pages.shape[0]
        dev = k_pages.device
        n_pp, bucket = prefix_ids.shape[0], toks.shape[1]
        offset, length = int(offset), int(length)
        cache = init_cache_fn(cfg, 1, n_pp * page + page + bucket,
                              dtype=k_pages.dtype, device=dev)
        pids = prefix_ids.to(device=dev).long()

        def gathered(pages):
            g = pages[:, pids].permute(0, 1, 3, 2, 4)   # (L,n_pp,page,H,D)
            return g.reshape((L, n_pp * page) + tuple(g.shape[3:]))

        cache["k"][:, 0, :n_pp * page] = gathered(k_pages)
        cache["v"][:, 0, :n_pp * page] = gathered(v_pages)
        cache["pos"] = offset
        positions = (offset + torch.arange(bucket, dtype=torch.int32,
                                           device=dev))[None]
        logits, cache = forward_fn(params, cfg, toks.to(dev), cache,
                                   positions)
        w0 = (offset // page) * page
        for pages, vals in ((k_pages, cache["k"]), (v_pages, cache["v"])):
            w = vals[:, 0, w0:w0 + page + bucket]          # (L, W, H, D)
            pages[:, phys.long(), :, slots.long()] = w.transpose(0, 1).to(
                pages.dtype)
        return k_pages, v_pages, logits[0, length - 1].to(torch.float32)

    return partial_prefill
