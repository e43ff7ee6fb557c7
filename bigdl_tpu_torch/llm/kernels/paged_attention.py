"""Paged KV-cache decode attention — the port of
``bigdl_tpu/llm/kernels/paged_attention.py``: the flash-state "stats"
variant the serving engine runs, the merge that folds the current token
in, and the normalised variant behind the ``paged_attention()``
dispatch.

The KV cache is a page pool ``(num_pages, H_kv, page_size, D)`` per
layer; a request owns the pages named by its block-table row. The
engine views the pools of all layers as one flat ``(L·P, ...)`` array
and offsets the table by ``l·P`` (serving.paged_attend), so the kernel
never sees a per-layer copy.

:func:`paged_attention_decode_stats` and :func:`paged_attention_decode`
launch the CUDA kernel (``bigdl_tpu_torch/csrc/paged_attention.cu``, one
body for both) for CUDA tensors, or raise; they take their plain PyTorch
versions (:func:`paged_attention_reference_stats`,
:func:`paged_attention_reference`) only for CPU tensors. The dispatch is
by the tensors' device, not by a global backend.

The kernel splits each row's live keys at the multiples of
:data:`SPLIT_KEYS` and combines the splits' flash states in split order,
and cuts a kv head's query heads into chunks of at most
:data:`HEAD_CHUNK`, one block each; :func:`split_stats_reference` is the
same split-and-combine, chunk by chunk, in plain PyTorch.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from bigdl_tpu_torch.llm.kernels import _build, _counts

LANE = 128   # the JAX package's block-table bucketing unit (kept for shapes)

# keys per split of the CUDA kernel (a multiple of the page size, at most
# 512): a row's live range [start, len) is cut at the multiples of it.
# Chosen from H100 timings of 128, 256 and 512 at the Mistral-7B B=1
# (4199 keys) and B=4 (512..575) and Llama-2-7B B=8 shapes (PERF.md).
SPLIT_KEYS = 128

# query heads a block of the CUDA kernel computes (MAXG in
# csrc/paged_attention.cu): a kv head's g = Hq / Hkv heads are cut into
# ceil(g / HEAD_CHUNK) chunks, one block each
HEAD_CHUNK = 8

_KV_ENTRY = {torch.bfloat16: "bf16", torch.float32: "f32"}


def _sliced_tables(block_tables: torch.Tensor, lengths: torch.Tensor,
                   page: int):
    """Slice the table columns to the live page span before the dense
    gather of the plain versions: tables are bucketed to the engine's
    worst case, and gathering every column would pad the gather with
    capacity nobody owns. Masking is untouched: every valid position is
    below the live span by construction."""
    pages_max = block_tables.shape[1]
    max_len = int(lengths.max()) if lengths.numel() else 0
    live = -(-max_len // page)
    return block_tables[:, :max(1, min(live, pages_max))]


def _gather(pages: torch.Tensor, block_tables: torch.Tensor):
    """(P, Hkv, page, D) pool + (B, n) table → (B, n·page, Hkv, D)."""
    b, n = block_tables.shape
    _, hkv, page, d = pages.shape
    return (pages[block_tables.long()].permute(0, 1, 3, 2, 4)
            .reshape(b, n * page, hkv, d))


def paged_attention_reference_stats(q, k_pages, v_pages, block_tables,
                                    lengths,
                                    sliding_window: Optional[int] = None):
    """Plain version of :func:`paged_attention_decode_stats` (same
    contract): a gather of the live pages and masked attention in f32."""
    b, hq, d = q.shape
    _, hkv, page, _ = k_pages.shape
    g = hq // hkv
    block_tables = _sliced_tables(block_tables, lengths, page)
    k_all = _gather(k_pages, block_tables).to(torch.float32)
    v_all = _gather(v_pages, block_tables).to(torch.float32)
    s_max = k_all.shape[1]
    qg = q.reshape(b, hkv, g, d).to(torch.float32)
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k_all) * scale
    pos = torch.arange(s_max, device=q.device)[None, :]
    lens = lengths.to(torch.int64)[:, None]
    mask = pos < lens                                          # (B, S)
    if sliding_window is not None:
        mask &= pos >= lens - sliding_window
    mask4 = mask[:, None, None, :]
    s = torch.where(mask4, s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1)                                         # (B,H,G)
    # p must be 0 (not exp(0)) on masked slots of all-masked rows,
    # where m == -1e30 would make s - m == 0
    p = torch.where(mask4, torch.exp(s - m[..., None]),
                    torch.zeros_like(s))
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgs,bshd->bhgd", p, v_all)
    any_valid = mask.any(dim=-1)[:, None, None]
    m = torch.where(any_valid, m, torch.full_like(m, -1e30))
    return acc.reshape(b, hq, d), m.reshape(b, hq), l.reshape(b, hq)


def _check_pools(q, k_pages, v_pages, page_size: int):
    b, hq, d = q.shape
    _, hkv, page, d2 = k_pages.shape
    if page != page_size or d2 != d or tuple(v_pages.shape) != \
            tuple(k_pages.shape):
        raise ValueError(f"pools {tuple(k_pages.shape)} do not match q "
                         f"{tuple(q.shape)} / page_size {page_size}")
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")


def _cuda_args(q, k_pages, v_pages, block_tables, lengths,
               sliding_window: Optional[int]):
    """The checks every CUDA entry makes. Returns the pointers the C
    entries take before their outputs (q f32, pools, table, lengths),
    the arguments after them (``B, Hq, Hkv, page, D, pages_max, window,
    scale, stream``), and the tensors behind the pointers, which the
    caller holds until the launch: a pointer does not keep a temporary
    (the f32 copy of q) alive, and its memory could go to the outputs."""
    if q.device.type != "cuda":
        raise ValueError(f"paged attention: unsupported device {q.device}")
    dev = q.device
    if any(t.device != dev for t in (k_pages, v_pages, block_tables,
                                     lengths)):
        raise ValueError("paged attention: all tensors on one device")
    if k_pages.dtype not in _KV_ENTRY or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"paged attention: pools must be bf16 or f32, "
                         f"got {k_pages.dtype}/{v_pages.dtype}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("paged attention: block_tables and lengths must "
                         "be int32")
    b, hq, d = q.shape
    _, hkv, page, _ = k_pages.shape
    # a lane reads 8 bf16 or 4 f32 of a row (8 f32 past 128), 32 lanes
    # at most a row
    if not (d % 8 == 0 and d <= 256 or k_pages.dtype == torch.float32
            and d % 4 == 0 and d <= 128):
        raise ValueError(
            f"paged attention kernel takes D a multiple of 8 up to 256 (f32 "
            f"pools: also a multiple of 4 up to 128), got D={d} (ROADMAP "
            f"Queue 3)")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("paged attention: pools must be contiguous")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged attention: pools must be 16-byte aligned "
                         "(the kernel reads 16-byte vectors)")
    qf = q.to(torch.float32).contiguous()
    bt = block_tables.contiguous()
    lens = lengths.contiguous()
    head = (qf, k_pages, v_pages, bt, lens)
    tail = (b, hq, hkv, page, d, bt.shape[1],
            -1 if sliding_window is None else int(sliding_window),
            1.0 / math.sqrt(d), torch.cuda.current_stream(dev).cuda_stream)
    return [t.data_ptr() for t in head], list(tail), head


def _scratch(q, k_pages, block_tables, split_keys: int):
    """The split states and arrival counters one launch needs, made
    here (the kernel allocates nothing): ``nsplit`` covers the longest
    row the table can hold, so it is known without reading the lengths
    back. One (row, kv head, head chunk) has ``nsplit`` states of ``gc =
    min(g, HEAD_CHUNK)`` heads and one counter. Returns ``(nsplit,
    part_acc, part_ml, arrivals)``."""
    b, hq, d = q.shape
    _, hkv, page, _ = k_pages.shape
    if split_keys % page or not 0 < split_keys <= 512:
        raise ValueError(f"paged attention: split_keys {split_keys} must be "
                         f"a multiple of the page size {page}, at most 512")
    nsplit = max(1, -(-block_tables.shape[1] * page // split_keys))
    g = hq // hkv
    blocks, gc = b * hkv * -(-g // HEAD_CHUNK), min(g, HEAD_CHUNK)
    dev = q.device
    part_acc = torch.empty((blocks, nsplit, gc, d), dtype=torch.float32,
                           device=dev)
    part_ml = torch.empty((blocks, nsplit, 2, gc), dtype=torch.float32,
                          device=dev)
    arrivals = torch.zeros((blocks,), dtype=torch.int32, device=dev)
    return nsplit, part_acc, part_ml, arrivals


def _decode_cuda(q, k_pages, v_pages, block_tables, lengths,
                 sliding_window: Optional[int], normalize: bool,
                 split_keys: int = SPLIT_KEYS):
    """Kernels 2 and 6 on CUDA tensors: ``(acc, m, l)``, or with
    ``normalize`` the normalised f32 output. Counts the launch on the
    entry point it serves. A ``split_keys`` other than
    :data:`SPLIT_KEYS` is for timing the split size only."""
    ptrs, tail, _keep = _cuda_args(q, k_pages, v_pages, block_tables,
                                   lengths, sliding_window)
    b, hq, d = q.shape
    outs = [torch.empty((b, hq, d), dtype=torch.float32, device=q.device)]
    if not normalize:
        outs += [torch.empty((b, hq), dtype=torch.float32, device=q.device)
                 for _ in range(2)]
    if b > 0:
        nsplit, *scratch = _scratch(q, k_pages, block_tables, split_keys)
        P, I, F = _build.P, _build.I, _build.F
        fn = _build.bind(
            "paged_attention", f"paged_decode_{'' if normalize else 'stats_'}"
            f"{_KV_ENTRY[k_pages.dtype]}",
            [P] * (len(ptrs) + len(outs) + 3) + [I] * 7 + [F, I, I, P])
        rc = fn(*ptrs, *(t.data_ptr() for t in outs),
                *(t.data_ptr() for t in scratch), *tail[:-1], split_keys,
                nsplit, tail[-1])
        entry = (paged_attention_decode if normalize
                 else paged_attention_decode_stats)
        _counts.launched(entry)
        _build.check(rc, entry.__name__)
    return outs[0] if normalize else tuple(outs)


def split_stats_reference(q, k_pages, v_pages, block_tables, lengths,
                          sliding_window: Optional[int] = None,
                          split_keys: int = SPLIT_KEYS):
    """The CUDA kernel's split-and-combine in plain PyTorch (same
    contract as :func:`paged_attention_reference_stats`): a kv head's
    query heads are taken :data:`HEAD_CHUNK` at a time, as the kernel's
    blocks take them; each row's live range ``[start, len)`` is cut at
    the multiples of ``split_keys``; each split's ``(acc, m, l)`` is
    computed alone, and the splits are combined in split order (``m`` the
    max of theirs, ``l`` and ``acc`` the sums of theirs times
    ``exp(m_j - m)``). Length-0 rows give the identity ``(0, -1e30, 0)``."""
    b, hq, d = q.shape
    _, hkv, page, _ = k_pages.shape
    g = hq // hkv
    k_all = _gather(k_pages, block_tables).to(torch.float32)
    v_all = _gather(v_pages, block_tables).to(torch.float32)
    qg = q.reshape(b, hkv, g, d).to(torch.float32)
    scale = 1.0 / math.sqrt(d)
    acc = torch.zeros((b, hkv, g, d), dtype=torch.float32)
    m = torch.full((b, hkv, g), -1e30, dtype=torch.float32)
    l = torch.zeros((b, hkv, g), dtype=torch.float32)
    for r in range(b):
        n = int(lengths[r])
        start = max(0, n - sliding_window) if sliding_window is not None \
            else 0
        for c0 in range(0, g, HEAD_CHUNK):
            heads = slice(c0, min(g, c0 + HEAD_CHUNK))
            states = []
            for j in range(start // split_keys, -(-n // split_keys)):
                lo = max(start, j * split_keys)
                hi = min(n, (j + 1) * split_keys)
                s = torch.einsum("hgd,shd->hgs", qg[r, :, heads],
                                 k_all[r, lo:hi]) * scale
                mj = s.amax(dim=-1)
                p = torch.exp(s - mj[..., None])
                states.append((torch.einsum("hgs,shd->hgd", p,
                                            v_all[r, lo:hi]),
                               mj, p.sum(dim=-1)))
            if not states:
                continue
            mx = torch.stack([st[1] for st in states]).amax(dim=0)
            for a_j, m_j, l_j in states:
                w = torch.exp(m_j - mx)
                acc[r, :, heads] += a_j * w[..., None]
                l[r, :, heads] += l_j * w
            m[r, :, heads] = mx
    return acc.reshape(b, hq, d), m.reshape(b, hq), l.reshape(b, hq)


def paged_attention_decode_stats(q, k_pages, v_pages, block_tables,
                                 lengths, page_size: int = 16,
                                 sliding_window: Optional[int] = None):
    """Decode-step attention over a paged KV cache, WITHOUT normalising:
    the flash-style partial state ``(acc (B, Hq, D) f32, m (B, Hq) f32,
    l (B, Hq) f32)`` over the first ``lengths[b]`` tokens (the current
    token excluded), so the caller can fold further tokens in with
    :func:`merge_attention_partial`. Rows with ``lengths == 0`` return
    ``(0, -1e30, 0)``.

    q (B, Hq, D); pools (P, Hkv, page_size, D) bf16 or f32;
    block_tables (B, pages_max) int32; lengths (B,) int32. Unlike the
    Mosaic kernel, ``pages_max`` need not be a multiple of
    ``LANE // page_size``."""
    _check_pools(q, k_pages, v_pages, page_size)
    if q.device.type == "cpu":
        return paged_attention_reference_stats(
            q, k_pages, v_pages, block_tables, lengths,
            sliding_window=sliding_window)
    return _decode_cuda(q, k_pages, v_pages, block_tables, lengths,
                        sliding_window, False)


paged_attention_decode_stats.launches = 0


# the JAX package's dispatch name; the wrapper already chooses by device
paged_attention_stats = paged_attention_decode_stats


def merge_attention_partial(acc, m, l, q, k_new, v_new):
    """Fold one extra key/value token into a flash-style partial state.

    ``(acc, m, l)`` from :func:`paged_attention_stats`; ``q`` (B, Hq, D)
    current queries; ``k_new``/``v_new`` (B, Hkv, D) the token being
    decoded (before its page write). Returns the NORMALISED attention
    output (B, Hq, D) f32 over the union — ``paged_attention`` after
    writing the token, with the pool untouched."""
    b, hq, d = q.shape
    g = hq // k_new.shape[1]
    scale = 1.0 / math.sqrt(d)
    kr = torch.repeat_interleave(k_new.to(torch.float32), g, dim=1)
    vr = torch.repeat_interleave(v_new.to(torch.float32), g, dim=1)
    s_self = (q.to(torch.float32) * kr).sum(dim=-1) * scale
    m_new = torch.maximum(m, s_self)
    alpha = torch.exp(m - m_new)                               # (B, Hq)
    beta = torch.exp(s_self - m_new)
    l_new = l * alpha + beta
    return ((acc * alpha[..., None] + vr * beta[..., None])
            / torch.clamp(l_new, min=1e-30)[..., None])


def paged_attention_reference(q, k_pages, v_pages, block_tables, lengths,
                              sliding_window: Optional[int] = None):
    """Plain version of :func:`paged_attention_decode` (same contract): a
    gather of the live pages and a masked softmax in f32, cast to
    ``q.dtype``. As in the JAX package's reference, a row with
    ``lengths == 0`` is a softmax over nothing but masked scores, which
    is uniform: it returns the mean of the gathered V rows (the kernel
    returns 0 there, as the Pallas kernel does)."""
    b, hq, d = q.shape
    _, hkv, page, _ = k_pages.shape
    g = hq // hkv
    block_tables = _sliced_tables(block_tables, lengths, page)
    k_all = _gather(k_pages, block_tables).to(torch.float32)
    v_all = _gather(v_pages, block_tables).to(torch.float32)
    s_max = k_all.shape[1]
    qg = q.reshape(b, hkv, g, d).to(torch.float32)
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k_all) * scale
    pos = torch.arange(s_max, device=q.device)[None, :]
    lens = lengths.to(torch.int64)[:, None]
    mask = pos < lens                                          # (B, S)
    if sliding_window is not None:
        mask &= pos >= lens - sliding_window
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v_all)
    return out.reshape(b, hq, d).to(q.dtype)


def paged_attention_decode(q, k_pages, v_pages, block_tables, lengths,
                           page_size: int = 16,
                           sliding_window: Optional[int] = None):
    """Decode-step attention over a paged KV cache, normalised.

    q (B, Hq, D) current-token queries; pools (P, Hkv, page_size, D)
    bf16 or f32; block_tables (B, pages_max) int32 physical page ids;
    lengths (B,) int32 context lengths INCLUDING the current token, whose
    K/V must already be in its page. Returns (B, Hq, D) in ``q.dtype``;
    a row with ``lengths == 0`` returns 0 on the card. Unlike the Mosaic
    kernel, ``pages_max`` need not be a multiple of ``LANE //
    page_size``, and D needs no padding to 128."""
    _check_pools(q, k_pages, v_pages, page_size)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, block_tables,
                                         lengths,
                                         sliding_window=sliding_window)
    return _decode_cuda(q, k_pages, v_pages, block_tables, lengths,
                        sliding_window, True).to(q.dtype)


paged_attention_decode.launches = 0

# the JAX package's dispatch name; the wrapper already chooses by device
paged_attention = paged_attention_decode
