"""Ragged paged-PREFILL attention — the port of
``bigdl_tpu/llm/kernels/ragged_prefill.py``.

Suffix queries attend the cached prefix where it sits in the page pool
(by block table, positions ``< offset``) and the suffix's own K/V (not
yet written to the pool) causally, with one online softmax. ``offsets``
and ``seq_lens`` are per-row runtime data.

:func:`ragged_prefill_attention` launches the CUDA kernel
(``bigdl_tpu_torch/csrc/ragged_prefill.cu``) for CUDA tensors, or
raises; it takes :func:`ragged_prefill_reference`, the plain PyTorch
version, only for CPU tensors. The Mosaic kernel's padding of Tq to a
power of two and of D to 128 does not apply: the wrapper keeps the
``(B, Tq, Hq, D)`` f32 contract without them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from bigdl_tpu_torch.llm.kernels import _build
from bigdl_tpu_torch.llm.kernels.paged_attention import (_KV_ENTRY,
                                                         _gather,
                                                         _sliced_tables)


def ragged_prefill_reference(q, k_suf, v_suf, k_pages, v_pages,
                             block_tables, offsets, seq_lens,
                             sliding_window: Optional[int] = None):
    """Plain version of :func:`ragged_prefill_attention` (same
    contract): gather the live prefix pages, concatenate the suffix,
    masked softmax attention in f32. Padded query rows come out finite
    (they attend the valid suffix keys below them)."""
    b, tq, hq, d = q.shape
    _, hkv, page, _ = k_pages.shape
    g = hq // hkv
    block_tables = _sliced_tables(block_tables, offsets, page)
    k_pre = _gather(k_pages, block_tables)
    v_pre = _gather(v_pages, block_tables)
    s_pages = k_pre.shape[1]
    k_all = torch.cat([k_pre, k_suf.to(k_pre.dtype)], dim=1).float()
    v_all = torch.cat([v_pre, v_suf.to(v_pre.dtype)], dim=1).float()
    dev = q.device
    offs = offsets.to(torch.int64)[:, None]
    ar_p = torch.arange(s_pages, device=dev)[None, :]
    ar_t = torch.arange(tq, device=dev)[None, :]
    qpos = offs + ar_t                                         # (B, Tq)
    kvpos = torch.cat([ar_p.expand(b, s_pages), offs + ar_t], dim=1)
    valid = torch.cat([ar_p < offs,
                       ar_t < seq_lens.to(torch.int64)[:, None]], dim=1)
    mask = valid[:, None, :] & (kvpos[:, None, :] <= qpos[:, :, None])
    if sliding_window is not None:
        mask &= kvpos[:, None, :] > qpos[:, :, None] - sliding_window
    qg = q.reshape(b, tq, hkv, g, d).permute(0, 2, 3, 1, 4).float()
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bhgtd,bshd->bhgts", qg, k_all) * scale
    s = torch.where(mask[:, None, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgts,bshd->bhgtd", p, v_all)
    return out.permute(0, 3, 1, 2, 4).reshape(b, tq, hq, d).float()


def ragged_prefill_attention(q, k_suf, v_suf, k_pages, v_pages,
                             block_tables, offsets, seq_lens,
                             page_size: int = 16,
                             sliding_window: Optional[int] = None):
    """Ragged paged-prefill attention.

    q (B, Tq, Hq, D) — row (b, j) at absolute position
    ``offsets[b] + j``; k_suf/v_suf (B, Tq, Hkv, D) the suffix's own K/V
    in the pool dtype; pools (P, Hkv, page_size, D) bf16 or f32;
    block_tables (B, pages_max) int32 covering positions
    ``0 .. offsets[b]``; offsets/seq_lens (B,) int32. Returns
    (B, Tq, Hq, D) f32; rows ``j >= seq_lens[b]`` are finite padding
    (0 from the kernel) that callers slice off."""
    b, tq, hq, d = q.shape
    p_, hkv, page, d2 = k_pages.shape
    if page != page_size or d2 != d or tuple(v_pages.shape) != \
            tuple(k_pages.shape):
        raise ValueError(f"pools {tuple(k_pages.shape)} do not match q "
                         f"{tuple(q.shape)} / page_size {page_size}")
    if tuple(k_suf.shape) != (b, tq, hkv, d) or \
            tuple(v_suf.shape) != (b, tq, hkv, d):
        raise ValueError(f"k_suf/v_suf must be {(b, tq, hkv, d)}")
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if q.device.type == "cpu":
        return ragged_prefill_reference(
            q, k_suf, v_suf, k_pages, v_pages, block_tables, offsets,
            seq_lens, sliding_window=sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"ragged prefill: unsupported device {q.device}")
    dev = q.device
    if any(t.device != dev for t in (k_suf, v_suf, k_pages, v_pages,
                                     block_tables, offsets, seq_lens)):
        raise ValueError("ragged prefill: all tensors on one device")
    kvt = k_pages.dtype
    if kvt not in _KV_ENTRY or any(t.dtype != kvt for t in
                                   (v_pages, k_suf, v_suf)):
        raise ValueError("ragged prefill: pools and suffix K/V must share "
                         "one dtype, bf16 or f32")
    if any(t.dtype != torch.int32 for t in (block_tables, offsets,
                                            seq_lens)):
        raise ValueError("ragged prefill: tables, offsets and seq_lens "
                         "must be int32")
    if d > 128:
        raise ValueError(f"ragged prefill kernel takes D <= 128, got {d}")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("ragged prefill: pools must be contiguous")
    qf = q.to(torch.float32).contiguous()
    ks, vs = k_suf.contiguous(), v_suf.contiguous()
    bt = block_tables.contiguous()
    offs, lens = offsets.contiguous(), seq_lens.contiguous()
    out = torch.empty((b, tq, hq, d), dtype=torch.float32, device=dev)
    if b == 0 or tq == 0:
        return out
    P, I, F = _build.P, _build.I, _build.F
    fn = _build.bind("ragged_prefill", f"ragged_prefill_{_KV_ENTRY[kvt]}",
                     [P] * 9 + [I] * 8 + [F, P])
    rc = fn(qf.data_ptr(), ks.data_ptr(), vs.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), bt.data_ptr(),
            offs.data_ptr(), lens.data_ptr(), out.data_ptr(), b, tq, hq,
            hkv, page, d, bt.shape[1],
            -1 if sliding_window is None else int(sliding_window),
            1.0 / math.sqrt(d), torch.cuda.current_stream(dev).cuda_stream)
    ragged_prefill_attention.launches += 1
    _build.check(rc, "ragged_prefill_attention")
    return out


ragged_prefill_attention.launches = 0


# the JAX package's dispatch name; the wrapper already chooses by device
ragged_prefill = ragged_prefill_attention
