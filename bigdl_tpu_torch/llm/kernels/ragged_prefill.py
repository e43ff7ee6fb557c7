"""Ragged paged-PREFILL attention — the port of
``bigdl_tpu/llm/kernels/ragged_prefill.py``.

Suffix queries attend the cached prefix where it sits in the page pool
(by block table, positions ``< offset``) and the suffix's own K/V (not
yet written to the pool) causally, with one online softmax. ``offsets``
and ``seq_lens`` are per-row runtime data.

:func:`ragged_prefill_attention` launches a CUDA kernel for CUDA
tensors, or raises; it takes :func:`ragged_prefill_reference`, the plain
PyTorch version, only for CPU tensors. :func:`ragged_route` picks the
kernel from the inputs' types and shapes: bf16 q and pools with
``D % 16 == 0``, ``D <= 128`` and a page size that is a multiple of 8 go
to the tensor-core kernel (``bigdl_tpu_torch/csrc/ragged_prefill_tc.cu``:
bf16 products, f32 softmax, P rounded to bf16 as the TPU kernel's
DEFAULT-precision dots round it), everything else to the exact f32
CUDA-core kernel (``bigdl_tpu_torch/csrc/ragged_prefill.cu``).
:func:`ragged_tiles_reference` is the tensor-core kernel's algebra in
plain PyTorch. The Mosaic kernel's padding of Tq to a power of two and
of D to 128 does not apply: the wrapper keeps the ``(B, Tq, Hq, D)`` f32
contract without them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from bigdl_tpu_torch.llm.kernels import _build, _counts
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


def ragged_tiles_reference(q, k_suf, v_suf, k_pages, v_pages, block_tables,
                           offsets, seq_lens,
                           sliding_window: Optional[int] = None,
                           tile_q: int = 64, tile_k: int = 64,
                           p_dtype: torch.dtype = torch.bfloat16):
    """The tensor-core kernel's algebra in plain PyTorch (the contract of
    :func:`ragged_prefill_attention`): per (row b, kv head), query rows
    ``token * g + group`` in tiles of ``tile_q``; each tile walks key
    tiles of ``tile_k``, prefix tiles of absolute positions from the
    window's first key to the offset, then suffix tiles of local
    positions up to its last live token, with the kernel's masks and an
    f32 online softmax whose P is rounded to ``p_dtype`` for the P V
    product (f32 sums; ``l`` sums the f32 P). Rows past ``seq_lens`` are
    0, as the kernel writes them. With ``p_dtype=torch.float32`` it is
    :func:`ragged_prefill_reference` on the valid rows, to rounding."""
    b, tq, hq, d = q.shape
    _, hkv, page, _ = k_pages.shape
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    qg = (q.reshape(b, tq, hkv, g, d).permute(0, 2, 1, 3, 4)
          .reshape(b, hkv, tq * g, d).float())
    og = torch.zeros_like(qg)
    win = sliding_window
    for r in range(b):
        off, slen = int(offsets[r]), min(int(seq_lens[r]), tq)
        live = slen * g
        for r0 in range(0, live, tile_q):
            rows = torch.arange(r0, min(r0 + tile_q, live), device=dev)
            qpos = off + rows // g                              # (R,)
            j0, j1 = r0 // g, (min(r0 + tile_q, live) - 1) // g
            lo = max(0, off + j0 - win + 1) if win is not None else 0
            walk = [(t0, off) for t0 in range(lo // tile_k * tile_k, off,
                                              tile_k)]
            walk += [(off + s0, off + slen) for s0 in range(
                max(0, lo - off) // tile_k * tile_k, j1 + 1, tile_k)]
            m = torch.full((hkv, len(rows)), -1e30, device=dev)
            l = torch.zeros((hkv, len(rows)), device=dev)
            acc = torch.zeros((hkv, len(rows), d), device=dev)
            for p0, hi in walk:
                pos = p0 + torch.arange(tile_k, device=dev)
                live_k = pos < hi
                if p0 < off:                # a prefix tile, by block table
                    pc = pos.clamp(max=off - 1)
                    phys = block_tables[r].long()[pc // page]
                    k = k_pages[phys, :, pc % page].float()  # (T, Hkv, D)
                    v = v_pages[phys, :, pc % page].float()
                else:                       # a suffix tile, local positions
                    lc = (pos - off).clamp(max=tq - 1)
                    k, v = k_suf[r, lc].float(), v_suf[r, lc].float()
                k = torch.where(live_k[:, None, None], k, 0.0)
                v = torch.where(live_k[:, None, None], v, 0.0)
                valid = live_k[None] & (pos[None] <= qpos[:, None])
                if win is not None:
                    valid &= pos[None] > qpos[:, None] - win
                s = torch.einsum("hrd,thd->hrt", qg[r, :, rows], k) * scale
                s = torch.where(valid[None], s, float("-inf"))
                m_new = torch.maximum(m, s.amax(dim=-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                l = l * alpha + p.sum(dim=-1)
                acc = acc * alpha[..., None] + torch.einsum(
                    "hrt,thd->hrd", p.to(p_dtype).float(), v)
                m = m_new
            og[r, :, rows] = acc / l.clamp(min=1e-30)[..., None]
    return (og.reshape(b, hkv, tq, g, d).permute(0, 2, 1, 3, 4)
            .reshape(b, tq, hq, d))


def ragged_route(q, k_pages) -> str:
    """Which CUDA kernel :func:`ragged_prefill_attention` launches:
    ``"tc"`` (``csrc/ragged_prefill_tc.cu``, tensor cores) for bf16 q and
    pools with ``D % 16 == 0`` (a ``wgmma`` k16 step), ``D <= 128`` and a
    page size that is a multiple of 8 (a TMA box of whole swizzle rows),
    else ``"cuda_core"`` (``csrc/ragged_prefill.cu``, f32 math)."""
    d, page = q.shape[-1], k_pages.shape[2]
    bf16 = q.dtype == torch.bfloat16 and k_pages.dtype == torch.bfloat16
    return ("tc" if bf16 and d % 16 == 0 and d <= 128 and page % 8 == 0
            else "cuda_core")


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
    return _ragged_cuda(q, k_suf, v_suf, k_pages, v_pages, block_tables,
                        offsets, seq_lens, sliding_window,
                        ragged_route(q, k_pages))


def _ragged_cuda(q, k_suf, v_suf, k_pages, v_pages, block_tables, offsets,
                 seq_lens, sliding_window: Optional[int], route: str):
    """Launch the ``route`` kernel on checked CUDA tensors and count it.
    A route other than :func:`ragged_route`'s is for timing the CUDA-core
    kernel on the tensor cores' inputs only (the tensor-core kernel
    refuses inputs it cannot take)."""
    b, tq, hq, d = q.shape
    p_, hkv, page, _ = k_pages.shape
    dev, kvt = q.device, k_pages.dtype
    if route == "tc" and ragged_route(q, k_pages) != "tc":
        raise ValueError("ragged prefill: the tensor-core kernel takes bf16 "
                         "q and pools, D % 16 == 0, D <= 128 and page % 8 "
                         "== 0")
    # the tensor-core kernel reads q in bf16, the CUDA-core kernel in f32
    qc = (q if route == "tc" else q.to(torch.float32)).contiguous()
    ks, vs = k_suf.contiguous(), v_suf.contiguous()
    if route == "tc" and any(t.data_ptr() % 16 for t in
                             (qc, ks, vs, k_pages, v_pages)):
        raise ValueError("ragged prefill: q, pools and suffix K/V must be "
                         "16-byte aligned (TMA and 16-byte loads)")
    bt = block_tables.contiguous()
    offs, lens = offsets.contiguous(), seq_lens.contiguous()
    out = torch.empty((b, tq, hq, d), dtype=torch.float32, device=dev)
    if b == 0 or tq == 0:
        return out
    P, I, F = _build.P, _build.I, _build.F
    window = -1 if sliding_window is None else int(sliding_window)
    ptrs = [t.data_ptr() for t in (qc, ks, vs, k_pages, v_pages, bt, offs,
                                   lens, out)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    if route == "tc":
        fn = _build.bind("ragged_prefill_tc", "ragged_prefill_tc_bf16",
                         [P] * 9 + [I] * 9 + [F, P])
        rc = fn(*ptrs, b, tq, hq, hkv, page, d, bt.shape[1], p_, window,
                1.0 / math.sqrt(d), stream)
    else:
        fn = _build.bind("ragged_prefill",
                         f"ragged_prefill_{_KV_ENTRY[kvt]}",
                         [P] * 9 + [I] * 8 + [F, P])
        rc = fn(*ptrs, b, tq, hq, hkv, page, d, bt.shape[1], window,
                1.0 / math.sqrt(d), stream)
    _counts.launched(ragged_prefill_attention,
                     *(("tc_launches",) if route == "tc" else ()))
    _build.check(rc, f"ragged_prefill_attention ({route})")
    return out


# every launch, and those on the tensor-core route (ragged_route)
ragged_prefill_attention.launches = 0
ragged_prefill_attention.tc_launches = 0


# the JAX package's dispatch name; the wrapper already chooses by device
ragged_prefill = ragged_prefill_attention
