"""Continuous-batching LLM serving over a paged KV cache — the port of
``bigdl_tpu/llm/serving.py``, slices (a)-(e) of ROADMAP Queue 1 item 6
and its slot-static engine (``paged=False``):

- the device functions of the paged decode step (``paged_attend``,
  ``scatter_new_kv``, ``paged_decode_step``, its sampled lift
  ``paged_decode_step_sampled``, and ``bind_decode_step``, that step
  over the engine's persistent buffers), ``bind_mixed_step``, the mixed
  prefill+decode step over them, and ``bind_spec_step``, the
  speculative verify step;
- ``slotted_decode_step`` and ``bind_slotted_step``, the slot-static
  engine's decode step over a dense ``(L, B, max_seq_len, Hkv, D)``
  cache with one write position a slot;
- the SLO classes (``PRIORITY_CLASSES``, ``normalize_priority``,
  ``CLASS_RETRY_WEIGHTS``) and the class-ordered admission heap;
- :class:`LLMServer` with paged decode, whole-prompt prefill (ragged in
  place, or dense staging), worst-case admission budgets, EOS /
  ``max_new_tokens`` finishing and page release; the JAX engine's
  pipelined dispatch (block tables and lengths resident on the device,
  up to ``pipeline_depth`` steps in flight, the decode step replayed as
  one captured CUDA graph, ``llm/graphs.py``, the port's ``jax.jit``);
  the radix prefix cache (``kvcache=``); the mixed prefill+decode
  dispatch with chunked admission (``mixed=``, ``chunk_tokens=``,
  ``chunk_wait=``), the mixed step one CUDA graph per chunk bucket;
  model-free self-speculative decoding (``spec=``, ``spec_k=``), the
  verify step one CUDA graph per draft bucket; and priority classes
  with lossless preemption (``priority=``, ``submit(priority=)``); the
  host KV tier (``kvtier=``, ``host_pages=``) with the chain handoff
  (``export_chain``, ``import_chain``) and a preempted chain's
  "exported" mode; the drain and abort surface (``begin_drain``,
  ``cancel_drain``, ``draining``, ``engine_idle``, ``warm_chains``,
  ``abort``); and the slot-static engine (``paged=False``: one
  ``max_seq_len`` window a slot, its prompt prefilled by the broadcast
  pass, its decode step one captured CUDA graph).

The engine's options default from the layered config (``bigdl.llm.*``
keys, ``bigdl_tpu_torch/utils/conf.py``) as the JAX engine's do, and it
carries the JAX engine's observability and reliability planes: every
``bigdl_llm_*`` / ``bigdl_kvcache_*`` / ``bigdl_kvtier_*`` series with
its labels, the ``llm/queue_wait`` / ``llm/prefill`` / ``llm/decode`` /
``llm/preempt`` spans stitched under ``Request.trace``, the flight
recorder's decision events, the SLO account (``slo=``), the step
watchdog (``watchdog_timeout=``) and the fault sites ``llm.submit``,
``llm.step``, ``worker.stall``, ``llm.chunk``, ``llm.spec``,
``llm.preempt``, ``kvcache.evict`` and ``kvtier.{spill,fetch}``. The
instruments read host values the engine already has at its drain
fence: they add no device read, no synchronize and no launch, and the
captured steps are the same graphs with them on or off.
"""

from __future__ import annotations

import heapq
import inspect
import queue
import threading
import time
import traceback
import uuid
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from bigdl_tpu_torch import observability as obs
from bigdl_tpu_torch import reliability
from bigdl_tpu_torch.device import resolve_device
from bigdl_tpu_torch.llm.graphs import CapturedStep
from bigdl_tpu_torch.llm.kernels.paged_attention import (
    LANE, merge_attention_partial, paged_attention_stats)
from bigdl_tpu_torch.llm.kernels.sampling import (make_sampled_step,
                                                  sample_tokens)
from bigdl_tpu_torch.llm.kvcache import Admission, KVCacheManager
from bigdl_tpu_torch.llm.kvtier import KVTier
from bigdl_tpu_torch.llm.kvtier.handoff import (HandoffError, dtype_name,
                                                deserialize_chain,
                                                serialize_chain)
from bigdl_tpu_torch.llm.models import llama
from bigdl_tpu_torch.llm.models._facade import CausalLMFacade
from bigdl_tpu_torch.llm.models.llama import (_attention, _embed, _head,
                                              decoder_layer, init_cache,
                                              layer_params)
from bigdl_tpu_torch.llm.spec import NGramProposer
from bigdl_tpu_torch.observability import flight
from bigdl_tpu_torch.observability import request_context as rc
from bigdl_tpu_torch.observability import utilization
from bigdl_tpu_torch.observability.slo import SLOAccount
from bigdl_tpu_torch.reliability.policies import _count
from bigdl_tpu_torch.utils.conf import conf

#: the server refuses a request for capacity (full queue, draining); the
#: worker and the gateway answer it with 503 / 429 + Retry-After
OverloadError = reliability.OverloadError


def _trace_of(req) -> Optional[str]:
    """The trace id riding a Request handle, if its submitter had one."""
    t = getattr(req, "trace", None)
    return t.get("trace_id") if t else None


def _llm_instruments():
    """The engine's series (declared only while observability records),
    the JAX engine's names, help texts and labels."""
    return {
        "prefill_tokens": obs.counter(
            "bigdl_llm_prefill_tokens_total",
            "Prompt tokens prefilled into the KV cache"),
        "prefill_seconds": obs.histogram(
            "bigdl_llm_prefill_seconds",
            "Host wall of one request prefill (compile excluded after "
            "first hit per length bucket). At pipeline_depth 1 this "
            "covers execution (the prefill barriers); at depth > 1 it "
            "is DISPATCH time — execution overlaps decode by design"),
        "decode_tokens": obs.counter(
            "bigdl_llm_decode_tokens_total",
            "Tokens decoded across all slots"),
        "decode_seconds": obs.histogram(
            "bigdl_llm_decode_step_seconds",
            "Host wall attributed to one decode step: scheduling + "
            "fence stall (under pipelining device compute overlaps the "
            "host, so this is NOT pure device time — see the host/stall "
            "split below and docs/PERFORMANCE.md)"),
        "decode_host": obs.histogram(
            "bigdl_llm_decode_host_seconds",
            "Host-side scheduling slice of one decode step (page "
            "allocation + dispatch; no device wait)",
            buckets=obs.FAST_BUCKETS),
        "decode_stall": obs.histogram(
            "bigdl_llm_decode_stall_seconds",
            "Host time blocked on the device fence when draining a "
            "decode step (the pipeline's residual stall)",
            buckets=obs.FAST_BUCKETS),
        "inflight": obs.gauge(
            "bigdl_llm_pipeline_inflight",
            "Decode steps dispatched but not yet drained (bounded by "
            "bigdl.llm.pipeline_depth)"),
        "requests": obs.counter(
            "bigdl_llm_requests_total",
            "Requests finished by the engine", labelnames=("reason",)),
        "active": obs.gauge(
            "bigdl_llm_active_slots", "Slots currently decoding"),
        "queue": obs.gauge(
            "bigdl_llm_queue_depth",
            "Requests accepted and waiting for an engine slot (the "
            "fleet autoscaler's primary pressure signal)"),
        "kv_pages": obs.gauge(
            "bigdl_llm_kv_pages_in_use",
            "Physical KV pages owned by live requests"),
        "kv_occupancy": obs.gauge(
            "bigdl_llm_kv_pool_occupancy",
            "Fraction of the KV page pool in use (0..1)"),
    }


def _priority_instruments():
    """The priority scheduler's series: declared only when the scheduler
    exists and observability records."""
    return {
        "preemptions": obs.counter(
            "bigdl_llm_preemptions_total",
            "In-flight decodes losslessly preempted for a higher "
            "SLO class, by the victim's class",
            labelnames=("class",)),
        "queue_class": obs.gauge(
            "bigdl_llm_queue_depth_class",
            "Scheduler backlog by SLO class (the fleet autoscaler's "
            "interactive-starvation signal)",
            labelnames=("class",)),
        "parked": obs.gauge(
            "bigdl_llm_preempt_parked",
            "Preempted requests parked for resume on this engine "
            "(scale-in must not drain the worker holding them)"),
    }


#: SLO classes in strictly descending scheduling priority; anything
#: unknown normalizes to "standard", so a misdeclared class degrades to
#: the default instead of failing
PRIORITY_CLASSES = ("interactive", "standard", "batch")
_PRIORITY_RANK = {c: r for r, c in enumerate(PRIORITY_CLASSES)}
#: Retry-After queue-depth weights a class: batch clients back off
#: harder than interactive ones under the same backlog
CLASS_RETRY_WEIGHTS = {"interactive": 0.5, "standard": 1.0, "batch": 2.0}


def normalize_priority(value) -> str:
    """A client's class value as a known SLO class ("standard" for None
    or anything unknown)."""
    if value is None:
        return "standard"
    v = str(value).strip().lower()
    return v if v in _PRIORITY_RANK else "standard"


class _PriorityScheduler:
    """Class-ordered admission backlog: a heap of ``(rank, seq, req)``,
    rank orders classes and the sequence keeps FIFO within a class (and
    makes entries totally ordered). Engine-thread only: the thread-safe
    boundary stays the intake queue, which ``_admit`` drains into the
    heap every pass. Made only with ``priority=True``."""

    def __init__(self):
        self._heap: List[tuple] = []
        self._seq = 0

    def push(self, req) -> None:
        self._seq += 1
        heapq.heappush(self._heap,
                       (_PRIORITY_RANK[req.priority], self._seq, req))

    def push_entry(self, ent: tuple) -> None:
        """Re-park a popped entry with its original sequence number: a
        budget-blocked head keeps its place in line."""
        heapq.heappush(self._heap, ent)

    def pop_entry(self) -> Optional[tuple]:
        return heapq.heappop(self._heap) if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def live(self) -> int:
        """Entries whose request still waits (done handles are dropped at
        the next pop)."""
        return sum(1 for _, _, r in self._heap if not r.done.is_set())

    def best_rank(self) -> Optional[int]:
        ranks = [e[0] for e in self._heap if not e[2].done.is_set()]
        return min(ranks) if ranks else None

    def requests(self) -> List["Request"]:
        """The parked handles, read without popping (the watchdog's
        sweep flags them from its own thread)."""
        return [r for _, _, r in list(self._heap)]

    def drain(self) -> List[tuple]:
        ents, self._heap = self._heap, []
        return ents

    def depths(self) -> Dict[str, int]:
        """Live backlog by class."""
        out = {c: 0 for c in PRIORITY_CLASSES}
        for _, _, r in self._heap:
            if not r.done.is_set():
                out[r.priority] += 1
        return out

    def parked(self) -> int:
        """Preempted requests waiting to resume."""
        return sum(1 for _, _, r in self._heap
                   if r.resume_ids is not None and not r.done.is_set())


def paged_attend(k_pages, v_pages, bt, lens, *, page: int,
                 sliding_window: Optional[int] = None):
    """Shared paged-attention closure of a family's decode step. The
    pools ``(L, P, H, page, D)`` are viewed as one flat ``(L·P, ...)``
    array (a view; a ``pool[l]`` copy per layer would move the pool
    through memory), block tables are offset by ``l·P`` (layer ``l``'s
    trash page is ``l·P``), the kernel sees lengths EXCLUDING the
    current token with the window shrunk by one, and the token's own K/V
    is folded in with the flash combine. Returns
    ``attend(l, q, k, v) -> (B, Hq, D) f32`` for ``(B, 1, H*, D)``
    current-token projections."""
    L, P = k_pages.shape[0], k_pages.shape[1]
    kp_flat = k_pages.view((L * P,) + tuple(k_pages.shape[2:]))
    vp_flat = v_pages.view((L * P,) + tuple(v_pages.shape[2:]))
    win_excl = (None if sliding_window is None
                else max(sliding_window - 1, 0))

    def attend(l, q, k, v):
        acc, m, lsum = paged_attention_stats(
            q[:, 0], kp_flat, vp_flat, bt + l * P, lens, page_size=page,
            sliding_window=win_excl)
        return merge_attention_partial(acc, m, lsum, q[:, 0], k[:, 0],
                                       v[:, 0])

    return attend


def scatter_new_kv(k_pages, v_pages, bt, lens, k_new, v_new, *,
                   page: int):
    """One scatter of every layer's new-token K/V into the pools, in
    place. ``k_new``/``v_new`` are ``(L, B, Hkv, D)``; row ``b`` lands at
    position ``lens[b]`` of its block table. The advanced indices on the
    page and slot dims, with a slice between, put the broadcast (B,) dim
    first, as in numpy and JAX."""
    b = lens.shape[0]
    lens = lens.long()
    phys = bt[torch.arange(b, device=bt.device), lens // page].long()
    slot = lens % page
    k_pages[:, phys, :, slot] = k_new.transpose(0, 1).to(k_pages.dtype)
    v_pages[:, phys, :, slot] = v_new.transpose(0, 1).to(v_pages.dtype)
    return k_pages, v_pages


def paged_decode(params, cfg, k_pages, v_pages, bt, lens, toks, *,
                 page: int, embed, layer, head):
    """:func:`paged_decode_step` of any family, from the three parts
    ``llama.dense_forward`` takes."""
    positions = lens[:, None].to(torch.int32)
    x = embed(params, cfg, toks.long()[:, None], positions)  # (B, 1, H)
    attend_l = paged_attend(k_pages, v_pages, bt, lens, page=page,
                            sliding_window=cfg.sliding_window)
    k_new, v_new = [], []
    for l in range(cfg.num_hidden_layers):
        x, k, v = layer(
            layer_params(params["layers"], l), x, positions, cfg,
            lambda q, k, v, l=l: attend_l(l, q, k, v)[:, None])
        k_new.append(k[:, 0])
        v_new.append(v[:, 0])
    logits = head(params, cfg, x)
    k_pages, v_pages = scatter_new_kv(k_pages, v_pages, bt, lens,
                                      torch.stack(k_new),
                                      torch.stack(v_new), page=page)
    return logits[:, 0].to(torch.float32), k_pages, v_pages


def paged_decode_step(params, cfg, k_pages, v_pages, bt, lens, toks, *,
                      page: int):
    """One paged-KV decode step: next-token logits for every row, and the
    pools with each row's new K/V written at position ``lens``.

    The pools stay read-only while the layers run: attention over the
    existing ``lens`` tokens comes from the stats kernel and the current
    token's own K/V is folded in by ``merge_attention_partial`` — the
    write-then-attend math without the write. After the layers, ONE
    scatter writes all layers' new K/V.

    ``bt`` (B, pages_max) int32; ``lens`` (B,) int32 EXCLUDING the token
    being decoded; ``toks`` (B,) int. Returns
    ``(logits (B, V) f32, k_pages, v_pages)``."""
    return paged_decode(params, cfg, k_pages, v_pages, bt, lens, toks,
                        page=page, embed=_embed, layer=decoder_layer,
                        head=_head)


# the engine's step shape for the llama family: sampling folded in,
# inactive rows routed to the trash page, their logits carried
paged_decode_step_sampled = make_sampled_step(paged_decode_step)


FAMILY_STEPS = ("forward", "sampled_step", "ragged_prefill",
                "partial_prefill", "mixed_step", "spec_step")


def family_steps(model, paged: bool = True) -> Dict[str, Callable]:
    """The engine's entry points for ``model`` (the keys of
    :data:`FAMILY_STEPS`), dispatched as the JAX engine does: a
    Llama-stack model (Mistral, Qwen2, GLM, MoE) runs the llama
    functions; a :class:`CausalLMFacade` family its own module's, the
    sampled decode step made with ``make_sampled_step`` where the module
    has none. A family without a paged decode step (Bloom: ALiBi has no
    paged-kernel hook) and the slot-static engine (``paged=False``) on
    any such family raise, in the JAX engine's words."""
    if not isinstance(model, CausalLMFacade):
        return dict(zip(FAMILY_STEPS, (
            llama.forward, paged_decode_step_sampled,
            llama.paged_prefill_ragged, llama.paged_prefill_partial,
            llama.paged_step_mixed, llama.paged_step_spec)))
    fam = inspect.getmodule(type(model)._forward)
    step = getattr(fam, "paged_decode_step", None)
    if paged and step is None:
        raise NotImplementedError(
            f"{type(model).__name__} has no paged decode step (ALiBi needs "
            "a kernel bias hook); use generate() or another family")
    if not paged:
        raise NotImplementedError(
            "the slot-static (paged=False) engine is Llama-stack only; "
            "non-llama families serve through the paged path")
    return dict(zip(FAMILY_STEPS, (
        fam.forward,
        getattr(fam, "paged_decode_step_sampled", None)
        or make_sampled_step(step),
        fam.paged_prefill_ragged, fam.paged_prefill_partial,
        fam.paged_step_mixed, fam.paged_step_spec)))


def step_costs(params, cfg, rows: int, kv_dtype,
               fixed_keys: int = 0) -> Dict[str, float]:
    """What one call of a captured step over ``rows`` rows costs, from
    its shapes (the capture records' ``costs``; see
    ``observability/compile_recorder.py``): ``bytes``, every linear's
    weight planes (packed codes and scales, or a dense matrix; the head
    too, the embedding when it is tied) read once; ``flops``, 2 x
    ``rows`` x their weight elements; per attended key ``kv_bytes``, its
    K and V in every layer (``kv_dtype``), and per (query, key) pair
    ``attn_flops``, 4 x query heads x head dim x layers. ``fixed_keys``
    keys attended by every call (the slot-static step's whole window)
    go into the fixed part."""
    nbytes = elems = 0

    def walk(t):
        nonlocal nbytes, elems
        if isinstance(t, dict):
            if "q" in t or "w" in t:
                w = t.get("q", t.get("w"))
                # packed 4-bit codes hold two weights a byte
                elems += w.numel() * (2 if w.dtype == torch.uint8 else 1)
                nbytes += sum(x.numel() * x.element_size()
                              for x in t.values()
                              if isinstance(x, torch.Tensor))
                return
            for v in t.values():
                walk(v)

    walk(params)
    if "lm_head" not in params and "embed_tokens" in params:
        e = params["embed_tokens"]
        elems += e.numel()
        nbytes += e.numel() * e.element_size()
    layers, hkv = cfg.num_hidden_layers, cfg.num_key_value_heads
    d = cfg.head_dim
    kv_bytes = 2.0 * layers * hkv * d * torch.empty(
        (), dtype=kv_dtype).element_size()
    attn_flops = 4.0 * cfg.num_attention_heads * d * layers
    return {"flops": 2.0 * rows * elems + attn_flops * fixed_keys,
            "bytes": float(nbytes) + kv_bytes * fixed_keys,
            "attn_flops": attn_flops, "kv_bytes": kv_bytes}


def bind_decode_step(params, cfg, k_pages, v_pages, bt, lens, last, active,
                     toks, *, page: int, temperature: float = 1.0,
                     generator=None, do_sample: bool = False,
                     top_k: int = 0, fam_step=None):
    """The engine's decode step as a function of no arguments over
    persistent buffers, what :class:`CapturedStep` captures: it reads
    ``bt`` (B, pages_cap) int32 and ``active`` (B,) bool, samples every
    row's next token from ``last`` (B, V) f32 into ``toks`` (B,) int32,
    and writes back in place the next logits into ``last``, the advanced
    lengths into ``lens`` (B,) int32 and every row's new K/V into the
    pools — so the next call reads what this one wrote. ``fam_step`` is
    the family's sampled step (:func:`paged_decode_step_sampled`, the
    llama family's, by default)."""
    fam_step = fam_step or paged_decode_step_sampled

    def step():
        t, logits, kp, vp, new_lens = fam_step(
            params, cfg, k_pages, v_pages, bt, lens, last, active,
            temperature, generator, page=page, do_sample=do_sample,
            top_k=top_k)
        if kp is not k_pages or vp is not v_pages:
            raise RuntimeError("the decode step must write the pools in "
                               "place: a graph holds their addresses")
        toks.copy_(t)
        last.copy_(logits)
        lens.copy_(new_lens)

    return step


def slotted_decode_step(params, cfg, cache_k, cache_v, pos, toks):
    """One decode step of the slot-static engine: next-token logits for
    every row of the dense cache ``(L, B, S, Hkv, D)``, each row's new
    K/V written IN PLACE at its own position ``pos[b]`` before the layer
    attends its whole window (``valid``: slots ``<= pos[b]``).

    The JAX step writes with a one-hot ``where`` over the whole cache;
    here one index write of B rows a layer gives the same values. A row
    at ``pos == S`` (a finished row whose slot is not yet released)
    writes nothing, as the one-hot matches no slot: its index is clamped
    and the old value written back. Attention is the blockwise
    :func:`_attention` over the full window with a per-row mask; nothing
    is read on the host, so the step runs inside a CUDA graph.

    ``pos`` (B,) int32, ``toks`` (B,) int. Returns ``(B, V)`` f32."""
    b, s_max = toks.shape[0], cache_k.shape[2]
    dev = toks.device
    x = params["embed_tokens"][toks.long()][:, None]         # (B, 1, H)
    positions = pos[:, None].to(torch.int32)
    valid = torch.arange(s_max, device=dev)[None, :] <= positions
    rows = torch.arange(b, device=dev)
    at = pos.long().clamp(max=s_max - 1)
    inside = (pos < s_max)[:, None, None]

    def attend(l, q, k, v):
        for cache, new in ((cache_k, k), (cache_v, v)):
            cache[l, rows, at] = torch.where(
                inside, new[:, 0].to(cache.dtype), cache[l, rows, at])
        return _attention(q, cache_k[l], cache_v[l], positions, valid, cfg)

    for l in range(cfg.num_hidden_layers):
        x, _, _ = decoder_layer(layer_params(params["layers"], l), x,
                                positions, cfg,
                                lambda q, k, v, l=l: attend(l, q, k, v))
    return _head(params, cfg, x)[:, 0].to(torch.float32)


def bind_slotted_step(params, cfg, cache_k, cache_v, pos, last, active,
                      toks, *, temperature: float = 1.0, generator=None,
                      do_sample: bool = False, top_k: int = 0):
    """The slot-static engine's decode step as a function of no
    arguments over persistent buffers, what :class:`CapturedStep`
    captures: it samples every row's next token from ``last`` (B, V) f32
    into ``toks`` (B,) int32, runs :func:`slotted_decode_step` at
    ``pos`` (B,) int32, writes every row's logits into ``last`` and
    advances ``pos`` by ``active`` (B,) bool, in place. Inactive rows
    run at their own position and their logits replace their ``last``,
    as in the JAX step."""

    def step():
        t = sample_tokens(last, generator, do_sample=do_sample,
                          temperature=temperature, top_k=top_k)
        logits = slotted_decode_step(params, cfg, cache_k, cache_v, pos, t)
        toks.copy_(t)
        last.copy_(logits)
        pos.add_(active.to(pos.dtype))

    return step


def chunk_operands(ops: torch.Tensor, bucket: int, pages_cap: int):
    """Views of one prefill's operands packed in one int32 vector (one
    host copy fills them all): ``toks (1, bucket)``, the device scalars
    ``length``, ``offset``, ``fork_dst``, ``fork_src``, then ``bt_row
    (pages_cap,)``, ``phys (bucket,)`` and ``slots (bucket,)`` — the
    arguments of a family's ``paged_prefill_ragged`` after the pools."""
    b0 = bucket + 4
    b1 = b0 + pages_cap
    return (ops[:bucket].view(1, bucket), ops[bucket], ops[bucket + 1],
            ops[b0:b1], ops[b1:b1 + bucket], ops[b1 + bucket:],
            ops[bucket + 2], ops[bucket + 3])


def prefill_operands(ids, off: int, end: int, bucket: int, row_pages, *,
                     page: int, pages_cap: int, fork_dst: int = 0,
                     fork_src: int = 0) -> np.ndarray:
    """The packed operands (:func:`chunk_operands`) of a ragged prefill of
    ``ids[off:end]`` at offset ``off`` over the block-table row
    ``row_pages``: token j lands in its own page and slot, positions
    past ``end`` (padding, or a later chunk's) in trash page 0."""
    ops = np.zeros(bucket * 3 + 4 + pages_cap, np.int32)
    ops[:end - off] = ids[off:end]
    ops[bucket:bucket + 4] = (end - off, off, fork_dst, fork_src)
    bt_row = ops[bucket + 4:bucket + 4 + pages_cap]
    bt_row[:len(row_pages)] = row_pages
    pos = off + np.arange(bucket)
    ops[bucket + 4 + pages_cap:2 * bucket + 4 + pages_cap] = np.where(
        pos < end, bt_row[np.minimum(pos // page, pages_cap - 1)], 0)
    ops[2 * bucket + 4 + pages_cap:] = pos % page
    return ops


def bind_mixed_step(params, cfg, k_pages, v_pages, bt, lens, last, active,
                    toks, ops, clast, *, bucket: int, page: int,
                    temperature: float = 1.0, generator=None,
                    do_sample: bool = False, top_k: int = 0, fam_step=None):
    """The engine's mixed prefill+decode step for one chunk bucket as a
    function of no arguments over persistent buffers, what
    :class:`CapturedStep` captures: the decode buffers of
    :func:`bind_decode_step` (written the same way) plus ``ops``, the
    chunk's operands packed as :func:`chunk_operands` reads them, and
    ``clast`` (V,) f32, into which the chunk's last-token logits go."""
    if fam_step is None:
        from bigdl_tpu_torch.llm.models.llama import paged_step_mixed
        fam_step = paged_step_mixed
    chunk = chunk_operands(ops, bucket, bt.shape[1])

    def step():
        t, logits, kp, vp, new_lens, cl = fam_step(
            params, cfg, k_pages, v_pages, bt, lens, last, active,
            temperature, generator, *chunk, page=page,
            do_sample=do_sample, top_k=top_k)
        if kp is not k_pages or vp is not v_pages:
            raise RuntimeError("the mixed step must write the pools in "
                               "place: a graph holds their addresses")
        toks.copy_(t)
        last.copy_(logits)
        lens.copy_(new_lens)
        clast.copy_(cl)

    return step


def spec_operands(ops: torch.Tensor, bucket: int, pages_cap: int):
    """Views of one verify pass's operands packed in one int32 vector
    (one host copy fills them all): the device scalars ``srow`` and
    ``n_draft``, ``ctoks (1, bucket)``, then ``bt_row (pages_cap,)``,
    ``phys (bucket,)`` and ``slots (bucket,)``, returned in the order of
    a family's ``paged_step_spec`` arguments after the generator."""
    b0 = 2 + bucket
    b1 = b0 + pages_cap
    return (ops[0], ops[2:b0].view(1, bucket), ops[1], ops[b0:b1],
            ops[b1:b1 + bucket], ops[b1 + bucket:])


def verify_operands(srow: int, drafts, pos0: int, bucket: int, bt_row, *,
                    page: int) -> np.ndarray:
    """The packed operands (:func:`spec_operands`) of a verify pass for
    row ``srow`` at length ``pos0``: chunk slot 0 is left for ``g0``
    (set on the device), the drafts follow, and the ``len(drafts) + 1``
    live positions land in their pages of the block-table row
    ``bt_row`` (which already holds the pages they need), padding in
    trash page 0."""
    pages_cap = len(bt_row)
    clen = len(drafts) + 1
    ops = np.zeros(2 + 3 * bucket + pages_cap, np.int32)
    ops[:2] = (srow, clen - 1)
    ops[3:2 + clen] = drafts
    b0 = 2 + bucket
    ops[b0:b0 + pages_cap] = bt_row
    pos = pos0 + np.arange(bucket)
    ops[b0 + pages_cap:b0 + pages_cap + bucket] = np.where(
        pos < pos0 + clen,
        np.asarray(bt_row)[np.minimum(pos // page, pages_cap - 1)], 0)
    ops[b0 + pages_cap + bucket:] = pos % page
    return ops


def bind_spec_step(params, cfg, k_pages, v_pages, bt, lens, last, active,
                   sout, ops, *, bucket: int, page: int,
                   temperature: float = 1.0, generator=None,
                   do_sample: bool = False, top_k: int = 0, fam_step=None):
    """The engine's speculative verify step for one draft bucket as a
    function of no arguments over persistent buffers, what
    :class:`CapturedStep` captures: the decode buffers of
    :func:`bind_decode_step` (``last``, ``lens`` and the pools written
    the same way), ``ops``, the verify chunk's operands packed as
    :func:`spec_operands` reads them, and ``sout`` (B + 1 + bucket,)
    int32, into which the step's ids, ``n_acc`` and chunk tokens go."""
    if fam_step is None:
        from bigdl_tpu_torch.llm.models.llama import paged_step_spec
        fam_step = paged_step_spec
    spec = spec_operands(ops, bucket, bt.shape[1])

    def step():
        out, logits, kp, vp, new_lens = fam_step(
            params, cfg, k_pages, v_pages, bt, lens, last, active,
            temperature, generator, *spec, page=page,
            do_sample=do_sample, top_k=top_k)
        if kp is not k_pages or vp is not v_pages:
            raise RuntimeError("the spec step must write the pools in "
                               "place: a graph holds their addresses")
        sout.copy_(out)
        last.copy_(logits)
        lens.copy_(new_lens)

    return step


class Request:
    """Handle returned by :meth:`LLMServer.submit`."""

    def __init__(self, prompt_ids, max_new_tokens: int,
                 priority: str = "standard"):
        self.id = str(uuid.uuid4())
        self.prompt_ids = np.asarray(prompt_ids, np.int32).ravel()
        self.max_new_tokens = max_new_tokens
        self.tokens: List[int] = []
        # the SLO class; plain metadata unless the server schedules by it
        self.priority = priority
        # lossless preemption: a preempted request re-queues as prompt +
        # generated so far (resume_ids) with its remaining budget, and
        # _hold_rec is the in-flight record that must drain before it
        # may take a slot again (re-admitted into its old slot earlier,
        # it would take that record's stale token at the drain)
        self.resume_ids: Optional[np.ndarray] = None
        self.preemptions = 0
        self._hold_rec: Optional[dict] = None
        # abort() sets it: the engine finishes the slot at its next drain
        # (or skips the request if it is still queued or fetch-parked)
        self.cancel_requested = False
        self.error: Optional[str] = None
        self.done = threading.Event()
        # the submitter's trace context rides the handle into the engine
        # thread (context variables do not cross threads); None when no
        # trace is active or observability is off
        self.trace = rc.to_wire(rc.current())
        self.submitted_at = time.time() if self.trace else 0.0
        self.decode_started_at = 0.0
        # TTFT accounting: submit stamp here, first-token stamp at drain;
        # t_tokens holds each token's drain time (one clock read a drain)
        self.t_submit = time.perf_counter()
        self.t_first_token = 0.0
        self.t_tokens: List[float] = []
        # the SLO account's per-request state: the last token's drain
        # stamp and the worst gap so far
        self.t_last_token = 0.0
        self.itl_max = -1.0

    def get(self, timeout: Optional[float] = None) -> List[int]:
        if not self.done.wait(timeout):
            raise TimeoutError(f"request {self.id} still running")
        if self.error is not None:
            raise RuntimeError(f"request {self.id} failed: {self.error}")
        return list(self.tokens)


def _pow2_bucket(n: int, page: int) -> int:
    """The prefill bucket of ``n`` tokens: a power of two, >= one page."""
    return max(page, 1 << (n - 1).bit_length())


class LLMServer:
    """Continuous-batching engine over a Llama-stack model, or a GPT-NeoX
    or StarCoder one (their modules' own steps, :func:`family_steps`,
    as the JAX engine dispatches them; Bloom and ``paged=False`` with a
    non-llama family raise), paged KV.

    KV lives in a page pool ``(L, num_pages, H_kv, page_size, D)`` on the
    model's device; each request owns ``ceil(tokens / page)`` pages named
    by its block-table row, taken as tokens land and given back when it
    finishes. Admission reserves the worst-case page budget of prompt +
    ``max_new_tokens``, so decode never deadlocks on an empty pool; page
    0 is the trash page that inactive rows and prefill padding write.

    Each engine pass admits into free slots and dispatches one step over
    all ``max_batch`` rows, inactive rows masked to the trash page — the
    batch shape never changes, so a request's tokens do not depend on
    what else is in the batch. A prompt is prefilled whole at admission
    (padded to a power-of-two bucket, at least one page) by the ragged
    in-place prefill, or with ``ragged_prefill=False`` by the dense
    staging prefill (``paged_prefill_partial``).

    **Prefix cache** (``kvcache=True``), as the JAX engine's: admission
    looks the prompt up in a radix index of page-size token chunks
    (``kvcache/radix.py``), adopts the cached full pages (refcounted and
    pinned, never written), charges only the uncached suffix, and the
    prefill runs the suffix alone at its offset, the adopted partial
    tail page forked (copy-on-write) into a page of its own. A request's
    full prompt pages are indexed at prefill, prompt + output at EOS;
    index-only pages are LRU-evicted when the pool runs short.

    **Mixed dispatch** (``mixed=True``): a prompt whose uncached suffix
    is longer than ``chunk_tokens`` (0 means 4 pages; rounded up to a
    page) is fed in page-aligned chunks, one a pass, each fused with
    every decoding row into one mixed step (``paged_step_mixed``), so an
    admission no longer stalls decode for a whole prefill. Chunked
    admission charges the ledger chunk by chunk; a chunk that cannot be
    charged for ``chunk_wait`` seconds (default 30) sheds its request
    with the partial chain rolled back. Chunking slots rotate round
    robin; a chunk with no decode row to fuse with runs alone, eagerly.

    **Self-speculative decoding** (``spec=True``, greedy only, on the
    ragged path): a pass may carry one decode row's n-gram drafts
    (``llm/spec.py``, at most ``spec_k - 1`` a pass) as a verify chunk
    (``paged_step_spec``) and emit up to ``spec_k`` tokens for it, the
    same tokens greedy decode gives. A pass carries a prefill chunk or
    a verify, never both; rows take turns round robin; a draft hit
    drains the in-flight window first (drafting needs the row's exact
    history), and the row sits out dispatch until its record drains,
    since how far it advanced is known only then.

    **Priority classes** (``priority=True``): requests carry an SLO
    class (``submit(priority=)``: "interactive", "standard", "batch")
    and are admitted in class order, FIFO within a class. A waiter that
    cannot be seated preempts the worst strictly lower-class decode
    (among equals the youngest), at most one a window of in-flight
    steps, losslessly: the victim's chain is indexed in the prefix
    cache (with ``kvcache=True``, else dropped), its slot and pages
    freed, and it re-queues as prompt + generated so far with the
    budget it has left, so its resumed tokens equal an unpreempted
    run's. It stays out of a slot until its last in-flight record has
    drained.

    **Host KV tier** (``kvtier=True``, with ``kvcache=True``), as the JAX
    engine's: radix-evicted full pages spill to a host-RAM arena of
    ``host_pages`` page slots (default 4 x ``num_pages``; page-locked on
    a card) instead of being dropped, copied out by a background
    migration worker on its own stream. An admission whose prefix
    continues in the arena pre-charges a pool page per host chunk and
    parks, holding its budget but no slot, while the worker uploads the
    chunks; the engine polls the upload at each pass, writes the pages
    into the pool in place and admits the request as a device prefix
    hit. A failed or timed-out fetch (``kvtier_fetch_timeout`` seconds,
    default 30) degrades to a plain miss. ``kvtier_sync=True`` runs the
    migrations inline (no thread: the deterministic tests).
    ``kvtier_sync`` and ``kvtier_fetch_timeout`` are the JAX engine's
    ``bigdl.llm.kvtier.sync`` and ``bigdl.llm.kvtier.fetch.timeout``
    settings. :meth:`export_chain` packs a chain's cached full pages (in
    the pool or the arena) into a handoff blob, :meth:`import_chain`
    lands one in the arena, and a preempted chain is also exported
    ("exported" mode, ``preempt_modes``) until its request resumes.

    **Drain and abort**: :meth:`begin_drain` sheds new submits while the
    accepted ones finish (:meth:`cancel_drain` undoes it),
    :meth:`engine_idle` says when none is left anywhere (fetch-parked
    ones included), :meth:`warm_chains` lists the maximal chains warm in
    either tier, and :meth:`abort` cancels one accepted request, whose
    slot and pages the engine releases at its next drain.

    **Pipelined dispatch**, as the JAX engine's. Block tables, lengths,
    the active mask and the last logits live on the device; a step reads
    them and advances lengths and logits in place, and the host changes
    them with small in-place writes in stream order. The numpy ``_bt``
    and ``_lens`` are the host's view at dispatch time. Up to
    ``pipeline_depth`` steps (default 2) are in flight before the oldest
    is drained: its sampled ids come back through a pinned host buffer
    of its own and an event, and EOS / max-token bookkeeping runs one
    step behind dispatch. ``pipeline_depth=1`` is the synchronous engine.
    Pages go back to the pool as soon as the host releases them (the
    JAX engine defers that to the newest step's fence): every later use
    of a page is enqueued behind the steps still reading it, on the
    one stream.

    The decode step is one CUDA graph (:class:`CapturedStep`, the port's
    ``jax.jit``) captured at its second call, and the mixed step one
    graph per chunk bucket and the verify step one per draft bucket,
    captured alike over the bucket's persistent operand buffer (filled
    by one host copy a pass); ``temperature``,
    ``top_k`` and sampling are fixed at construction, as in the JAX
    step's cache key. Whole-prompt prefills and solo chunks run eagerly.
    ``stop()`` frees the graphs.

    **Slot-static cache** (``paged=False``), as the JAX engine's: a dense
    ``(L, max_batch, max_seq_len, Hkv, D)`` cache, one window a slot
    (``max_seq_len`` is capped at the model's ``max_cache_len``), a
    request admitted into any free slot with no page budget. Its prompt
    is prefilled by a broadcast pass: the prompt as ``max_batch``
    identical rows through ``forward`` with only slot ``i``'s K/V kept
    (an MoE layer's capacity counts all of them, as in the JAX engine).
    The decode step (:func:`slotted_decode_step`) writes each row's K/V
    at its own position and is one CUDA graph, at any
    ``pipeline_depth``; ``_lens`` / ``_lens_dev`` hold the slots' write
    positions (the JAX engine's ``_pos``). A released slot restarts at
    position 0. The prefix cache does not apply, and ``mixed``, ``spec``,
    ``priority`` and the host tier refuse with the JAX engine's
    ``ValueError``; ``pages_in_use`` is -1.

    **Configuration**: an option left at ``None`` takes its ``bigdl.llm.*``
    key from the layered config (``bigdl_tpu_torch/utils/conf.py``: the
    ``BIGDL_TPU_*`` environment, a ``bigdl-tpu.conf`` file,
    ``conf.set``), with the JAX engine's keys and defaults:
    ``pipeline_depth`` (``bigdl.llm.pipeline_depth``), ``kvcache``,
    ``ragged_prefill`` (``bigdl.llm.prefill.ragged``; its "auto" is on
    in the port), ``mixed``, ``chunk_tokens``, ``chunk_wait``
    (``bigdl.llm.prefill.chunk.wait``), ``spec``, ``spec_k`` (and
    ``bigdl.llm.spec.min_match`` / ``.backoff``), ``priority``, the tier's
    ``kvtier``, ``host_pages``, ``kvtier_sync`` and
    ``kvtier_fetch_timeout`` (``bigdl.llm.kvtier.*``), ``slo``
    (``bigdl.slo.enabled``) and ``watchdog_timeout``
    (``bigdl.llm.watchdog.step_timeout``).

    **Observability**: with ``bigdl.observability.enabled`` (the default)
    the engine writes the JAX engine's series into the port's registry,
    declared at first use; ``slo=True`` adds the TTFT / ITL sketches and
    the ``bigdl_slo_*`` classification of each finished request; with
    ``bigdl.observability.flight.enabled`` its decisions (queue, admit,
    radix hit / miss, COW fork, park, fetch, chunk charge, rollback,
    draft, verify, preempt, finish, ...) land in the flight ring.

    **Watchdog** (``watchdog_timeout`` seconds > 0): a monitor thread
    watches the heartbeat the engine loop stamps at the top of every
    pass. A pass older than the timeout trips it: ``watchdog_tripped``
    (the worker's ``/healthz`` answers 503 "stalled"), one count on
    ``bigdl_llm_watchdog_trips_total``, and every pending request (queue,
    class heap, slots, fetch-parked) failed with a retriable error while
    the engine thread stays wedged; ``submit`` fails fast meanwhile. The
    sweep runs on the monitor thread while the engine thread may be
    inside a graph launch, so it touches only thread-safe host surfaces
    (the intake queue, request handles, fetch jobs' cancel flags), never
    the device. A fresh heartbeat clears the trip. A kernel's first
    build (``nvcc``) and each bucket's first graph capture look like a
    stalled pass from the host: warm every bucket before arming a short
    timeout, or set it above the longest build and capture.

    **Failing passes**: a pass that raises an
    :class:`~bigdl_tpu_torch.reliability.InjectedFault` (a fault site,
    each before any device work) is retried as the JAX engine retries
    every failing pass: ``bigdl_reliability_retries_total
    {component="llm_server"}`` counts it, the loop backs off under a
    :class:`~bigdl_tpu_torch.reliability.RetryPolicy` and the surviving
    slots keep decoding. Any other exception fails every request in
    flight and the engine goes on serving: a CUDA error is sticky, so
    retrying the pass would only hang its clients.

    ``device=None`` means the GPU (and raises without one); the model
    must live on the same device. ``page_size=None`` takes the model's;
    another value than the model's raises.
    """

    def __init__(self, model, max_batch: int = 4, max_seq_len: int = 256,
                 eos_token_id: Optional[int] = None, paged: bool = True,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 max_queue: int = 0,
                 pipeline_depth: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 sample_seed: int = 0,
                 ragged_prefill: Optional[bool] = None,
                 kvcache: Optional[bool] = None,
                 mixed: Optional[bool] = None,
                 chunk_tokens: Optional[int] = None,
                 chunk_wait: Optional[float] = None,
                 spec: Optional[bool] = None, spec_k: Optional[int] = None,
                 priority: Optional[bool] = None,
                 kvtier: Optional[bool] = None,
                 host_pages: Optional[int] = None,
                 kvtier_sync: Optional[bool] = None,
                 kvtier_fetch_timeout: Optional[float] = None,
                 slo: Optional[bool] = None,
                 watchdog_timeout: Optional[float] = None, device=None):
        if not paged:
            # the JAX engine's refusals, in its order
            if kvtier:
                raise ValueError("the host tier is page-pool only; "
                                 "the slot-static cache has no pages")
            if mixed:
                raise ValueError("unified mixed dispatch is page-pool "
                                 "only; the slot-static cache has no "
                                 "chunked prefill")
            if priority:
                raise ValueError("priority scheduling is page-pool "
                                 "only; lossless preemption needs the "
                                 "paged KV chain to park and resume")
            if spec:
                raise ValueError("self-speculative decoding is "
                                 "page-pool only; the verify chunk is "
                                 "a ragged chunk over pool pages")
        else:
            # the page-pool options the caller left open come from the
            # layered config, as in the JAX engine (the slot-static engine
            # reads none of them)
            def opt(value, getter, key, default):
                return value if value is not None else getter(key, default)

            kvcache = opt(kvcache, conf.get_bool,
                          "bigdl.llm.kvcache.enabled", False)
            if ragged_prefill is None:
                rag = str(conf.get("bigdl.llm.prefill.ragged", "auto"))
                ragged_prefill = (rag.lower() == "auto" or conf.get_bool(
                    "bigdl.llm.prefill.ragged"))
            mixed = opt(mixed, conf.get_bool, "bigdl.llm.mixed.enabled",
                        False)
            chunk_tokens = opt(chunk_tokens, conf.get_int,
                               "bigdl.llm.prefill.chunk_tokens", 0)
            chunk_wait = opt(chunk_wait, conf.get_float,
                             "bigdl.llm.prefill.chunk.wait", 30.0)
            spec = opt(spec, conf.get_bool, "bigdl.llm.spec.enabled", False)
            spec_k = opt(spec_k, conf.get_int, "bigdl.llm.spec.k", 4)
            priority = opt(priority, conf.get_bool,
                           "bigdl.llm.priority.enabled", False)
            kvtier = opt(kvtier, conf.get_bool, "bigdl.llm.kvtier.enabled",
                         False)
            host_pages = opt(host_pages, conf.get_int,
                             "bigdl.llm.kvtier.host_pages", 0)
            kvtier_sync = opt(kvtier_sync, conf.get_bool,
                              "bigdl.llm.kvtier.sync", False)
            kvtier_fetch_timeout = opt(
                kvtier_fetch_timeout, conf.get_float,
                "bigdl.llm.kvtier.fetch.timeout", 30.0)
        if pipeline_depth is None:
            pipeline_depth = conf.get_int("bigdl.llm.pipeline_depth", 2)
        self.paged = paged
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, server on "
                             f"{self.device}")
        self.model = model
        self.cfg = cfg = model.config
        fam = family_steps(model, paged)
        self._fam_forward, self._fam_sampled_step, \
            self._fam_ragged_prefill, self._fam_partial_prefill, \
            self._fam_mixed_step, self._fam_spec_step = (
                fam[n] for n in FAMILY_STEPS)
        self._ragged = ragged_prefill is not False
        self.max_batch = max_batch
        self.max_seq_len = (min(max_seq_len, cfg.max_position_embeddings)
                            if paged else
                            min(max_seq_len, model.max_cache_len))
        self.eos_token_id = eos_token_id
        self.max_queue = max_queue
        self._queue: "queue.Queue[Request]" = queue.Queue(maxsize=max_queue)
        self._pending_head: Optional[Request] = None
        self._draining = threading.Event()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._slots: List[Optional[Request]] = [None] * max_batch
        self._remaining = np.zeros(max_batch, np.int64)
        # the window of dispatched, undrained steps; each record keeps the
        # pinned host buffers its uploads read until its drain proves the
        # step (and every copy enqueued before it) retired
        self.pipeline_depth = max(1, int(pipeline_depth))
        self._inflight: deque = deque()
        self._pending_release: List[torch.Tensor] = []
        self.steps = 0
        self.host_seconds = 0.0      # dispatch-side host time of the steps
        self.stall_seconds = 0.0     # time the drains waited on the device
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self._do_sample = self.temperature > 0.0
        self._temp = self.temperature if self._do_sample else 1.0
        self._gen = torch.Generator(device=self.device).manual_seed(
            sample_seed)
        self.errors: List[str] = []
        # observability: the series are declared at first use (so
        # obs.enable() on a live server starts recording); the SLO account
        # exists only when asked for
        self._ins = None
        self._pri_ins = None
        self._mixed_ins = None
        self._spec_ins = None
        self._slo = SLOAccount.if_enabled("engine", enabled=slo)
        # the watchdog: the loop stamps _hb at the top of every pass
        wd = (watchdog_timeout if watchdog_timeout is not None else
              conf.get_float("bigdl.llm.watchdog.step_timeout", 0.0))
        self.watchdog_timeout = float(wd or 0.0)
        self.watchdog_enabled = self.watchdog_timeout > 0.0
        self.watchdog_tripped = False
        self.watchdog_trips = 0
        self._hb = time.monotonic()
        self._watchdog_stop = threading.Event()
        self._watchdog_thread: Optional[threading.Thread] = None

        if page_size is None:
            page_size = model.page_size
        elif page_size != model.page_size:
            raise ValueError(f"page_size {page_size} differs from the "
                             f"model's {model.page_size}")
        if page_size <= 0:
            raise ValueError(f"page_size {page_size} must be positive")
        self._page = page_size
        # mixed dispatch needs the ragged prefill (a chunk attends the
        # prefix and its own earlier chunks where they sit in the pool):
        # under ragged_prefill=False every admission prefills whole, as
        # in the JAX engine
        self._mixed = bool(mixed)
        ct = int(chunk_tokens or 0)
        if ct <= 0:
            ct = 4 * page_size
        self._chunk_tokens = max(page_size, -(-ct // page_size) * page_size)
        self._chunk_wait = 30.0 if chunk_wait is None else float(chunk_wait)
        self._mixed_active = self._mixed and self._ragged
        self._chunk_state: Optional[List[Optional[dict]]] = (
            [None] * max_batch if self._mixed_active else None)
        self._chunk_rr = 0
        self.prefill_chunks_total = 0
        self.prefill_tokens_total = 0
        self.mixed_passes = 0
        # self-speculative decoding: the verify chunk is a ragged chunk
        # and the accept rule is greedy exact match
        if spec and self._do_sample:
            raise ValueError("spec is greedy-only (temperature == 0): the "
                             "rejection-sampling verify for sampled decode "
                             "is not implemented, in the JAX engine either")
        self._spec_active = bool(spec) and self._ragged
        self._spec_k = max(1, int(4 if spec_k is None else spec_k))
        self._spec_min_match = max(1, conf.get_int(
            "bigdl.llm.spec.min_match", 2))
        self._spec_backoff = conf.get_float("bigdl.llm.spec.backoff", 0.5)
        self._spec_state: Optional[List[Optional[dict]]] = (
            [None] * max_batch if self._spec_active else None)
        # slots whose verify is in flight: how far the row advanced is
        # data on the device until its record drains, so it sits out
        self._spec_pending: set = set()
        self._spec_rr = 0
        self.spec_passes = 0
        self.spec_proposed_total = 0
        self.spec_accepted_total = 0
        self.spec_emitted_total = 0
        # the widest verify chunk: g0 and at most spec_k - 1 drafts
        self._spec_wmax = (max(2, 1 << (self._spec_k - 1).bit_length())
                           if self._spec_active else 0)
        # priority classes: the scheduler exists only when asked for
        self._sched = _PriorityScheduler() if priority else None
        # the newest in-flight record when the last preemption ran: at
        # most one preemption a window (its pages serve the waiter only
        # once it is admitted, and the victim waits for that record)
        self._preempt_rec: Optional[dict] = None
        self.preemptions_total = 0
        self.preempt_resumes_total = 0
        # how each preempted chain was parked (dropped / indexed /
        # exported), and the exported chains' blobs by request id until
        # their requests resume
        self.preempt_modes = {"dropped": 0, "indexed": 0, "exported": 0}
        self._parked: Optional[Dict[str, bytes]] = {} if priority else None
        dev = self.device
        self._kv: Optional[KVCacheManager] = None
        self._tier: Optional[KVTier] = None
        # host-tier admissions parked while their pages upload, and the
        # landed ones waiting for a slot (engine thread only)
        self._fetch_wait: List[dict] = []
        self._fetch_ready: List[tuple] = []
        # the fetches landed and degraded, and their summed wait from
        # parking to landing
        self.fetch_waits = 0
        self.fetch_wait_seconds = 0.0
        if paged:
            # block-table width: the JAX engine rounds it up to the Mosaic
            # block multiple (LANE // page); kept so tables compare like
            # with like — the CUDA kernels do not need it
            ppb = max(1, LANE // page_size)
            cap = -(-self.max_seq_len // page_size)
            self._pages_cap = -(-cap // ppb) * ppb
            self._num_pages = num_pages or (1 + max_batch * cap)
            shape = (cfg.num_hidden_layers, self._num_pages,
                     cfg.num_key_value_heads, page_size, cfg.head_dim)
            self._k_pages = torch.zeros(shape, dtype=model.cache_dtype,
                                        device=dev)
            self._v_pages = torch.zeros(shape, dtype=model.cache_dtype,
                                        device=dev)
            self._kv = KVCacheManager(self._num_pages, page_size,
                                      enabled=kvcache)
            if kvtier:
                if not kvcache:
                    raise ValueError(
                        "bigdl.llm.kvtier extends the prefix cache: "
                        "enable bigdl.llm.kvcache too")
                self._tier = KVTier(host_pages or 4 * self._num_pages,
                                    page_size, synchronous=kvtier_sync,
                                    fetch_timeout=kvtier_fetch_timeout,
                                    device=dev)
                self._kv.attach_tier(self._tier, reader=self._read_page_kv,
                                     writer=self._write_pages_kv)
            # host bookkeeping: the tables as of the latest dispatch
            self._bt = np.zeros((max_batch, self._pages_cap), np.int32)
            self._bt_dev = torch.zeros((max_batch, self._pages_cap),
                                       dtype=torch.int32, device=dev)
        else:
            self._cache = init_cache(cfg, max_batch, self.max_seq_len,
                                     dtype=model.cache_dtype, device=dev)
        # the rows' lengths (the slot-static engine's write positions)
        # as of the latest dispatch, and their device twin
        self._lens = np.zeros(max_batch, np.int32)
        self._active = np.zeros(max_batch, bool)
        self._slot_pages: List[List[int]] = [[] for _ in range(max_batch)]
        self._slot_adm: List[Optional[Admission]] = [None] * max_batch
        # the device twins and the step's other persistent buffers, made
        # once: the graph holds their addresses, so none is rebound
        self._lens_dev = torch.zeros(max_batch, dtype=torch.int32,
                                     device=dev)
        self._active_dev = torch.zeros(max_batch, dtype=torch.bool,
                                       device=dev)
        self._last = torch.zeros((max_batch, cfg.vocab_size),
                                 dtype=torch.float32, device=dev)
        self._toks_dev = torch.zeros(max_batch, dtype=torch.int32,
                                     device=dev)
        # one host buffer per in-flight step for its sampled ids: replay
        # N+1 overwrites _toks_dev before step N is drained
        self._toks_host = [torch.zeros(max_batch + (
            1 + self._spec_wmax if self._spec_active else 0),
            dtype=torch.int32, pin_memory=dev.type == "cuda")
            for _ in range(self.pipeline_depth)]
        self._gens = (self._gen,) if self._do_sample else ()
        sampling = dict(temperature=self._temp, generator=self._gen,
                        do_sample=self._do_sample, top_k=self.top_k)
        self._decode = CapturedStep(
            bind_decode_step(model.params, cfg, self._k_pages,
                             self._v_pages, self._bt_dev, self._lens_dev,
                             self._last, self._active_dev, self._toks_dev,
                             page=page_size, fam_step=self._fam_sampled_step,
                             **sampling) if paged else
            bind_slotted_step(model.params, cfg, self._cache["k"],
                              self._cache["v"], self._lens_dev, self._last,
                              self._active_dev, self._toks_dev,
                              **sampling),
            dev, generators=self._gens,
            name="llm/decode_paged" if paged else "llm/decode_slotted",
            signature=f"B={max_batch} S={self.max_seq_len}",
            costs=step_costs(model.params, cfg, max_batch,
                             model.cache_dtype, 0 if paged else
                             max_batch * self.max_seq_len))
        # chunk bucket -> (its mixed step, operand buffer, clast buffer)
        self._mixed_steps: Dict[int, tuple] = {}
        # draft bucket -> (its verify step, operand buffer, output buffer)
        self._spec_steps: Dict[int, tuple] = {}

    # -- views ---------------------------------------------------------------
    @property
    def pages_in_use(self) -> int:
        """Physical pages owned by live requests, chunked admissions
        still mid-prompt included; -1 for the slot-static cache."""
        if not self.paged:
            return -1
        n = sum(len(p) for p in self._slot_pages)
        if self._chunk_state is not None:
            n += sum(len(st["own"]) for st in self._chunk_state
                     if st is not None)
        return n

    @property
    def _free(self) -> List[int]:
        return self._kv.pool.free_ids()

    @property
    def _budget_avail(self) -> int:
        return self._kv.budget_avail

    @property
    def prefix_tokens_saved(self) -> int:
        """Prompt tokens served from the prefix cache instead of being
        prefilled (0 with the cache off)."""
        return (self._kv.prefix_tokens_reused if self._kv is not None
                else 0)

    # -- client API ----------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int = 32,
               priority: Optional[str] = None) -> Request:
        """Queue a request; ``priority`` is its SLO class (normalized by
        :func:`normalize_priority`; scheduled by only with
        ``priority=True``). A refusal for capacity raises
        :class:`OverloadError` (``draining=True`` on a draining server;
        ``pages_needed`` / ``pages_free`` when the queue is full). While
        the watchdog is tripped and the engine still wedged, the request
        comes back failed (retriably) at once."""
        reliability.inject("llm.submit")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        req = Request(prompt_ids, max_new_tokens,
                      priority=normalize_priority(priority))
        if len(req.prompt_ids) == 0:
            raise ValueError("empty prompt")
        if len(req.prompt_ids) + max_new_tokens > self.max_seq_len:
            raise ValueError("prompt + max_new_tokens exceeds max_seq_len")
        pages = None
        if self.paged:
            # the post-lookup suffix cost: feasibility and the shed
            # diagnostics are judged on what admission would charge
            pages = self._kv.peek(req.prompt_ids, max_new_tokens)
            if pages["pages_needed"] > self._num_pages - 1:
                raise ValueError(
                    f"request needs {pages['pages_needed']} pages "
                    f"(uncached suffix of prompt + max_new_tokens) but "
                    f"the pool holds {self._num_pages - 1}; it could "
                    "never be admitted")
        if self._draining.is_set():
            reliability.count_shed("llm_server", request_id=req.id,
                                   trace_id=_trace_of(req),
                                   reason="draining")
            err = OverloadError("server is draining: not accepting new "
                                "requests")
            err.draining = True
            raise err
        if self.watchdog_enabled and self.watchdog_tripped \
                and time.monotonic() - self._hb > self.watchdog_timeout:
            # wedged mid-pass right now (the flag and a stale heartbeat):
            # a queued request would only hang behind the stalled pass
            self._watchdog_fail(req, self._watchdog_msg())
            return req
        try:
            # the engine drains the intake into the scheduler's heap every
            # pass, so bound the intake and the backlog together
            if self._sched is not None and self.max_queue and \
                    self._queue.qsize() + len(self._sched) >= \
                    self.max_queue:
                raise queue.Full
            self._queue.put_nowait(req)
        except queue.Full:
            # the page accounting tells queue pressure from page pressure
            shed = dict(request_id=req.id, trace_id=_trace_of(req),
                        queue_depth=self._queue.qsize(),
                        pages_needed=pages["pages_needed"] if pages else None,
                        pages_free=pages["pages_free"] if pages else None)
            if pages is not None and \
                    pages["pages_needed"] > pages["pages_free"]:
                reliability.count_shed("llm_server_pages",
                                       reason="page_pressure", **shed)
            else:
                reliability.count_shed("llm_server", reason="queue_full",
                                       **shed)
            msg = (f"request queue full ({self.max_queue} waiting); "
                   "retry later")
            if pages is not None:
                msg += (f" [needs {pages['pages_needed']} pages for the "
                        f"uncached suffix, {pages['pages_free']} "
                        "budget-free]")
            err = OverloadError(msg)
            if pages is not None:
                err.pages_needed = pages["pages_needed"]
                err.pages_free = pages["pages_free"]
            raise err from None
        if flight.enabled:
            flight.record(
                "queue", request_id=req.id, trace_id=_trace_of(req),
                prompt_tokens=len(req.prompt_ids),
                max_new_tokens=req.max_new_tokens,
                queue_depth=self._queue.qsize(),
                pages_needed=pages["pages_needed"] if pages else None,
                pages_free=pages["pages_free"] if pages else None)
        return req

    def retry_depth(self, priority: Optional[str] = None) -> float:
        """Queue depth for a Retry-After: the intake depth, or with the
        scheduler the intake and its backlog weighted by the class
        (``CLASS_RETRY_WEIGHTS``)."""
        depth = self._queue.qsize()
        if self._sched is None:
            return depth
        return ((depth + len(self._sched))
                * CLASS_RETRY_WEIGHTS[normalize_priority(priority)])

    def class_depths(self) -> Optional[Dict[str, int]]:
        """Live backlog by SLO class; None without the scheduler."""
        return self._sched.depths() if self._sched is not None else None

    @property
    def preempt_parked(self) -> int:
        """Preempted requests waiting to resume (0 without the
        scheduler)."""
        return self._sched.parked() if self._sched is not None else 0

    # -- the chain handoff ---------------------------------------------------
    def export_chain(self, tokens) -> bytes:
        """Pack the cached FULL pages of ``tokens`` into a handoff blob:
        the pool's pages read under the engine lock (eviction cannot run
        meanwhile; the copy is behind every write enqueued before it),
        the arena's chunks that continue them read from the arena. Pages
        evicted from both tiers are absent: the importer prefills
        whatever is missing."""
        if self._tier is None:
            raise RuntimeError("KV handoff needs bigdl.llm.kvtier.enabled")
        with self._lock:
            return self._export_chain_locked(tokens)

    def _export_chain_locked(self, tokens) -> bytes:
        """The export, the caller holding ``self._lock`` (the preemption
        path runs it from the engine thread)."""
        dev, host = self._kv.chain_locations(tokens)
        k_pages, v_pages = [], []
        if dev:
            # one gather and one copy to the host a side, in stream order
            # behind every write of these pages (not a copy a page)
            idx = torch.tensor(dev, dtype=torch.long, device=self.device)
            k_pages, v_pages = (list(pool.index_select(1, idx).transpose(
                0, 1).contiguous().cpu()) for pool in (self._k_pages,
                                                       self._v_pages))
        for key, slot in host:
            # keyed copy: an import may LRU-re-key the slot between the
            # lookup and here, and then the export stops at that chunk
            pages = self._tier.arena.read_keyed(slot, key)
            if pages is None:
                break
            k_pages.append(pages[0])
            v_pages.append(pages[1])
        blob = serialize_chain(np.asarray(tokens, np.int64)[
            :len(k_pages) * self._page], k_pages, v_pages, self._page)
        self._tier.count_handoff("export", len(blob))
        return blob

    def import_chain(self, blob: bytes) -> int:
        """Land a handoff blob's pages in the HOST ARENA; no engine lock,
        no device write: the next admission of the prompt hits the host
        tier and the ordinary fetch uploads the pages. Returns the pages
        imported (fewer than the blob's when the arena is saturated)."""
        if self._tier is None:
            raise RuntimeError("KV handoff needs bigdl.llm.kvtier.enabled")
        toks, k_pages, v_pages, header = deserialize_chain(blob)
        if not k_pages:
            return 0
        cfg = self.cfg
        want_shape = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                      self._page, cfg.head_dim)
        want_dtype = dtype_name(self.model.cache_dtype)
        if int(header["page_size"]) != self._page or \
                tuple(header["shape"]) != want_shape or \
                header["dtype"] != want_dtype:
            raise HandoffError(
                f"handoff pages {header['shape']}/{header['dtype']}"
                f"/page={header['page_size']} do not fit this pool "
                f"{want_shape}/{want_dtype}/page={self._page}")
        arena = self._tier.arena
        n = 0
        for j in range(len(k_pages)):
            slot = arena.reserve(tuple(toks[:(j + 1) * self._page]))
            if slot is None:
                break              # arena saturated: a partial import
            arena.commit(slot, k_pages[j], v_pages[j])
            n += 1
        self._tier.count_handoff("import", len(blob))
        return n

    # -- drain and abort -------------------------------------------------------
    def begin_drain(self):
        """Shed new submits ("server is draining") while every accepted
        request decodes to its end; a fleet's drain waits for
        :meth:`engine_idle`, then migrates :meth:`warm_chains`."""
        self._draining.set()

    def cancel_drain(self):
        """Accept work again (a no-op on a server that was not
        draining)."""
        self._draining.clear()

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def engine_idle(self) -> bool:
        """True when no accepted request remains anywhere: the queue, the
        held head, the class heap, the fetch-parked lists or a slot
        (chunked admissions hold their slot)."""
        with self._lock:
            return self._no_requests()

    def _no_requests(self) -> bool:
        return (self._queue.empty() and self._pending_head is None
                and (self._sched is None or self._sched.live() == 0)
                and not self._fetch_wait and not self._fetch_ready
                and all(r is None for r in self._slots))

    def warm_chains(self) -> List[List[int]]:
        """The token chains warm in this engine's caches: the radix
        index's leaf paths cut to full pages (tails prefill again by the
        handoff's contract) and the arena's entries, only the maximal
        ones kept (exporting a chain ships each prefix page with it).
        Empty without the prefix cache."""
        if not self.paged or not self._kv.enabled:
            return []
        page = self._page
        chains: Dict[tuple, None] = {}
        with self._lock:
            for path in self._kv.index.leaf_paths():
                full = (len(path) // page) * page
                if full:
                    chains[tuple(path[:full])] = None
            if self._tier is not None:
                for key in self._tier.arena.keys():
                    chains[tuple(key)] = None
        keep: List[tuple] = []
        for c in sorted(chains, key=len, reverse=True):
            if not any(k[:len(c)] == c for k in keep):
                keep.append(c)
        return [list(c) for c in keep]

    def abort(self, req: Request, reason: str = "aborted by caller"):
        """Cancel an accepted request, from any thread (flag only): the
        engine finishes its slot (its pages released the usual way) at
        its next drain, and admission skips it if it is still queued or
        fetch-parked."""
        req.cancel_requested = True
        if not req.done.is_set():
            req.error = req.error or f"request aborted: {reason}"
            req.done.set()
        # no count here: the engine counts the reaped slot as
        # requests{reason="cancelled"} at its next drain

    # -- the watchdog ----------------------------------------------------------
    def _watchdog_loop(self):
        """The step-deadline monitor (see the class docstring): trip on a
        heartbeat older than the timeout, sweep every tick while the
        engine stays wedged (a request that raced past ``submit``'s gate
        into the queue must not hang), clear the trip when the heartbeat
        moves again."""
        interval = min(max(self.watchdog_timeout / 4.0, 0.01), 0.25)
        while not self._watchdog_stop.wait(interval):
            age = time.monotonic() - self._hb
            if age <= self.watchdog_timeout:
                if self.watchdog_tripped:
                    self.watchdog_tripped = False    # the engine recovered
                continue
            if self.watchdog_tripped:
                self._watchdog_sweep(self._watchdog_msg())
                continue
            self._watchdog_trip(age)

    def _watchdog_msg(self) -> str:
        return (f"engine stalled: step exceeded the "
                f"{self.watchdog_timeout:g}s watchdog timeout "
                "(retriable: resubmit to another backend)")

    def _watchdog_trip(self, age: float):
        self.watchdog_tripped = True
        self.watchdog_trips += 1
        failed = self._watchdog_sweep(self._watchdog_msg())
        if obs.enabled():
            obs.counter(
                "bigdl_llm_watchdog_trips_total",
                "Engine stalls detected by the step-deadline "
                "watchdog").inc()
            obs.add_complete("llm/watchdog_trip", time.time() - age, age,
                             stage="llm_server", failed_requests=failed,
                             timeout_s=self.watchdog_timeout)

    def _watchdog_sweep(self, msg: str) -> int:
        """Fail every pending request from the monitor thread. The engine
        thread is wedged, maybe holding the lock and maybe inside a graph
        launch, so only thread-safe host surfaces are touched: the intake
        queue, request handles and fetch jobs' cancel flags. Pages,
        budget and device state stay the engine thread's to clean up when
        it wakes."""
        failed = 0
        try:
            while True:
                failed += self._watchdog_fail(self._queue.get_nowait(), msg)
        except queue.Empty:
            pass
        head = self._pending_head
        if head is not None:
            failed += self._watchdog_fail(head, msg)
        if self._sched is not None:
            for req in self._sched.requests():
                failed += self._watchdog_fail(req, msg)
        for req in list(self._slots):
            if req is not None:
                failed += self._watchdog_fail(req, msg)
        for ent in list(self._fetch_wait):
            failed += self._watchdog_fail(ent["req"], msg)
            if self._tier is not None:
                self._tier.cancel_fetch(ent["adm"].fetch_job)
        for req, _adm in list(self._fetch_ready):
            failed += self._watchdog_fail(req, msg)
        return failed

    @staticmethod
    def _watchdog_fail(req: Request, msg: str) -> int:
        req.cancel_requested = True
        if req.done.is_set():
            return 0
        req.error = msg
        req.done.set()
        return 1

    def start(self) -> "LLMServer":
        self._thread = threading.Thread(target=self._loop,
                                        name="bigdl-torch-llm", daemon=True)
        self._thread.start()
        if self.watchdog_enabled:
            self._hb = time.monotonic()
            self._watchdog_thread = threading.Thread(
                target=self._watchdog_loop, name="bigdl-torch-llm-watchdog",
                daemon=True)
            self._watchdog_thread.start()
        # time-series plane: the engine's refcount on the sampler, so
        # store-backed SLO burn windows work in a process with no HTTP
        # surface. Builds nothing when the gate is off.
        from bigdl_tpu_torch.observability import timeseries
        self._timeseries = timeseries.acquire()
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0):
        """Graceful drain (default): refuse new submits, finish every
        accepted request, then stop the engine thread and free the
        steps' graphs. ``drain=False`` stops at once; accepted requests
        fail."""
        self._draining.set()
        if drain and self._thread is not None and self._thread.is_alive():
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                with self._lock:
                    if self._idle():
                        break
                time.sleep(0.005)
        self._stop.set()
        if self._watchdog_thread is not None:
            self._watchdog_stop.set()
            self._watchdog_thread.join(timeout=5)
        if getattr(self, "_timeseries", None) is not None:
            from bigdl_tpu_torch.observability import timeseries
            timeseries.release()
            self._timeseries = None
        if self._thread is not None:
            self._thread.join(timeout=60)
        if self._thread is not None and self._thread.is_alive():
            return     # wedged engine thread still owns the state
        with self._lock:
            self._fail_all("server stopped before the request finished")
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._decode.close()
            for step, _, _ in list(self._mixed_steps.values()) + list(
                    self._spec_steps.values()):
                step.close()
        if self._tier is not None:
            self._tier.close()

    def _idle(self) -> bool:
        return self._no_requests() and not self._inflight

    # -- engine --------------------------------------------------------------
    def _loop(self):
        backoff = reliability.RetryPolicy(max_attempts=1 << 30,
                                          base_delay=0.005, max_delay=0.5)
        delays = None
        with torch.inference_mode():
            while not self._stop.is_set():
                self._hb = time.monotonic()   # the watchdog's heartbeat
                try:
                    with self._lock:
                        self._admit()
                        busy = self._step()
                except reliability.InjectedFault:
                    # a fault site fired, before any device work: the JAX
                    # engine's retry (count, back off, keep the slots)
                    _count("bigdl_reliability_retries_total",
                           "Retries performed under a RetryPolicy",
                           component="llm_server")
                    if delays is None:
                        delays = backoff.delays()
                    time.sleep(next(delays, 0.5))
                    continue
                except Exception as e:  # noqa: BLE001 — engine boundary
                    # the engine thread survives a failing pass: the
                    # requests in flight fail with the error (a CUDA
                    # error is sticky, so retrying them would only hang
                    # their clients) and the server keeps serving
                    msg = f"{type(e).__name__}: {e}"
                    self.errors.append(traceback.format_exc())
                    with self._lock:
                        self._fail_all(msg)
                    continue
                delays = None    # a healthy pass resets the backoff
                if not busy:
                    time.sleep(0.002)


    def _fail_all(self, msg: str):
        self._inflight.clear()
        self._pending_release = []
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            req.error = msg
            try:
                if self._chunk_state is not None and \
                        self._chunk_state[i] is not None:
                    self._rollback_chunk(i, msg)
                else:
                    self._finish_slot(i, req)
            except RuntimeError:
                # a sticky CUDA error refuses the device rows' reset;
                # the host side of the slot is already released
                self.errors.append(traceback.format_exc())
        self._spec_pending.clear()
        # fetch-parked admissions hold budget but no slot: the grants go
        # back (the worker releases the arena pins of a cancelled job)
        for req, adm in [(e["req"], e["adm"]) for e in self._fetch_wait] + \
                self._fetch_ready:
            self._kv.cancel(adm)
            if not req.done.is_set():
                req.error = msg
                req.done.set()
        self._fetch_wait, self._fetch_ready = [], []
        pending = [self._pending_head] if self._pending_head else []
        self._pending_head = None
        if self._sched is not None:
            # heap entries hold no budget: failing their handles is all
            pending += [r for _, _, r in self._sched.drain()
                        if not r.done.is_set()]
        while True:
            try:
                pending.append(self._queue.get_nowait())
            except queue.Empty:
                break
        for req in pending:
            req.error = msg
            req.done.set()

    def _pinned(self, a: np.ndarray) -> torch.Tensor:
        """``a`` as a host tensor for a copy in stream order: pinned on a
        card and kept by the next dispatched record until its drain
        proves the copy retired."""
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            t = t.pin_memory()
            self._pending_release.append(t)
        return t

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """``a`` on the device, copied in stream order without a wait."""
        return self._pinned(a).to(self.device, non_blocking=True)

    def _prompt_of(self, req: Request) -> np.ndarray:
        """The ids admission must prefill: the prompt, or after a
        preemption prompt + generated so far (greedy decode over the
        longer prompt continues exactly as the unpreempted run)."""
        return (req.resume_ids if req.resume_ids is not None
                else req.prompt_ids)

    def _budget_of(self, req: Request) -> int:
        """The decode budget still owed: ``max_new_tokens`` less the
        tokens drained before a preemption."""
        return req.max_new_tokens - len(req.tokens)

    def _sched_pop(self) -> Optional[tuple]:
        """Pop the best live, unheld heap entry. Done handles are
        dropped; a preempted request whose hold record is still in
        flight is skipped and re-parked in its place."""
        held: List[tuple] = []
        out = None
        while True:
            ent = self._sched.pop_entry()
            if ent is None:
                break
            req = ent[2]
            if req.done.is_set():
                continue
            rec = req._hold_rec
            if rec is not None:
                if any(r is rec for r in self._inflight):
                    held.append(ent)
                    continue
                req._hold_rec = None
            out = ent
            break
        for h in held:
            self._sched.push_entry(h)
        return out

    def _admit(self):
        """Fill free slots from the queue. A request is admitted only
        when its worst-case page budget (its uncached suffix, with the
        prefix cache) is available; head-of-line: if the next request
        does not fit, no later one is admitted either. With priority
        classes the intake drains into the class heap first (head of
        line becomes head of class), and waiters left after the sweep
        may preempt a lower-class decode. Host-tier hits park while
        their pages upload (budget held, no slot); landed ones are
        seated first."""
        if self._fetch_wait:
            self._poll_fetches()
        if self._sched is not None:
            try:
                while True:
                    self._sched.push(self._queue.get_nowait())
            except queue.Empty:
                pass
        for i in range(self.max_batch):
            if self._slots[i] is not None:
                continue
            if not self._admit_into(i):
                break
        if self._sched is not None and self._sched.live():
            self._consider_preempt()

    def _admit_into(self, i: int) -> bool:
        """Admit one request into free slot ``i``: lookup, suffix-only
        charge and adoption (``KVCacheManager.admit``), then a whole
        prefill, or the start of a chunked admission; the slot-static
        cache takes the queue's head at once into the broadcast prefill
        (:meth:`_prefill_slot`). A landed host-tier fetch takes the slot
        before the queue does; a host-tier hit parks instead and the
        sweep goes on filling the slot. False stops the slot sweep: the
        queue is empty or its head is budget-blocked."""
        page = self._page
        while True:
            if self._fetch_ready:
                req, adm = self._fetch_ready[0]
                if req.done.is_set():
                    # aborted while fetch-parked: the grant goes back
                    self._fetch_ready.pop(0)
                    self._kv.cancel(adm)
                    continue
                # room for the pages the prefill will own, made here: the
                # entry ahead in this pass may have used what the poll saw
                own = -(-len(self._prompt_of(req)) // page) \
                    - adm.matched_len // page
                if own > 0:
                    self._kv.ensure_free(own)
                self._fetch_ready.pop(0)
                # a landed fetch is a device prefix hit; a still long
                # suffix chunks, its budget charged in full at admission
                self._prefill_admitted(
                    i, req, adm, chunked=self._mixed_active
                    and len(self._prompt_of(req)) - adm.matched_len
                    > self._chunk_tokens, prepaid=True)
                return True
            ent = None
            if self._sched is not None:
                ent = self._sched_pop()
                if ent is None:
                    return False
                req = ent[2]
            else:
                req = self._pending_head
                if req is None:
                    try:
                        req = self._queue.get_nowait()
                    except queue.Empty:
                        return False
                self._pending_head = None
                if req.done.is_set():
                    continue       # aborted while queued: nothing charged
            ids, budget = self._prompt_of(req), self._budget_of(req)
            if not self.paged:
                self._prefill_admitted(i, req, None)
                return True
            chunk_first = None
            t_lk = time.perf_counter()
            if self._mixed_active and len(ids) > self._chunk_tokens:
                # a long uncached suffix is fed in chunks, the first
                # charged now; a match the arena extends keeps the
                # unchunked fetch path. The pool-size guard keeps a
                # request that can never be admitted (its cached prefix
                # evicted since submit) on the unchunked path, where it
                # fails below
                pk = self._kv.peek(ids, budget)
                off0 = pk["matched_device"]
                if pk["matched_tokens"] == off0 and \
                        pk["pages_needed"] <= self._num_pages - 1 and \
                        len(ids) - off0 > self._chunk_tokens:
                    end0 = self._chunk_end(off0, len(ids))
                    chunk_first = -(-end0 // page) - off0 // page
            try:
                adm = self._kv.admit(ids, budget, chunk_pages=chunk_first)
            except BaseException:
                # an injected kvcache.evict: nothing was charged or
                # adopted; the head keeps its place for the pass's retry
                if ent is not None:
                    self._sched.push_entry(ent)
                else:
                    self._pending_head = req
                raise
            if adm is None:
                peek = self._kv.peek(ids, budget)
                if peek["pages_needed"] > self._num_pages - 1:
                    req.error = (
                        f"request needs {peek['pages_needed']} pages but "
                        f"the pool holds {self._num_pages - 1} (cached "
                        "prefix evicted since submit)")
                    req.done.set()
                    continue
                if ent is not None:
                    self._sched.push_entry(ent)     # keeps its place
                else:
                    self._pending_head = req        # retry next pass
                return False
            if self._kv.enabled:
                self._record_lookup(req, adm, len(ids), t_lk)
            if adm.fetch:
                # a host-tier hit: parked until its pages land; the sweep
                # goes on filling this slot
                if flight.enabled:
                    flight.record("park", request_id=req.id,
                                  trace_id=_trace_of(req),
                                  pages=len(adm.fetch))
                self._fetch_wait.append({"req": req, "adm": adm,
                                         "t0": time.perf_counter()})
                continue
            self._prefill_admitted(i, req, adm,
                                   chunked=chunk_first is not None)
            return True

    def _record_lookup(self, req: Request, adm: Admission, n_ids: int,
                       t0: float):
        """The prefix-cache lookup's span and flight events."""
        wall = time.perf_counter() - t0
        obs.add_complete("kvcache/lookup", time.time() - wall, wall,
                         request=req.id, matched_tokens=adm.matched_len,
                         prompt_tokens=n_ids)
        if flight.enabled:
            flight.record("radix_hit" if adm.matched_len else "radix_miss",
                          request_id=req.id, trace_id=_trace_of(req),
                          matched_tokens=adm.matched_len,
                          device_matched=adm.device_matched,
                          prompt_tokens=n_ids)
            if adm.tail_src is not None:
                flight.record("cow_fork", request_id=req.id,
                              trace_id=_trace_of(req), src_page=adm.tail_src,
                              tail_tokens=adm.tail_len)

    def _prefill_admitted(self, i: int, req: Request,
                          adm: Optional[Admission], chunked: bool = False,
                          prepaid: bool = False):
        """Seat a request whose cache grant is held (the shared tail of
        direct and fetch-parked admissions; ``adm`` None on the
        slot-static cache): a whole prefill, or the start of a chunked
        admission (``prepaid``: its whole budget was charged at
        admission)."""
        ctx = rc.from_wire(req.trace)
        if ctx is not None and req.submitted_at:
            # the engine-side admission wait, parented to the submitter
            args = {"parent_span": ctx.span_id} if ctx.span_id else {}
            obs.add_complete("llm/queue_wait", req.submitted_at,
                             time.time() - req.submitted_at,
                             trace=ctx.trace_id, stage="queue",
                             request=req.id, **args)
        ids = self._prompt_of(req)
        if flight.enabled:
            flight.record("admit", request_id=req.id, trace_id=_trace_of(req),
                          slot=i, chunked=chunked, prepaid=prepaid,
                          matched_tokens=adm.matched_len if adm else 0,
                          prompt_tokens=len(ids))
        self._slot_adm[i] = adm
        if self._sched is not None and req.resume_ids is not None:
            self.preempt_resumes_total += 1
            if self._parked is not None:
                self._parked.pop(req.id, None)
            if flight.enabled:
                flight.record("preempt_resume", request_id=req.id,
                              trace_id=_trace_of(req), slot=i,
                              priority=req.priority,
                              tokens_done=len(req.tokens),
                              remaining=self._budget_of(req))
        if chunked:
            self._begin_chunked(i, req, adm, prepaid)
            return
        t0 = time.perf_counter()
        try:
            with rc.activate(ctx), obs.span(
                    "llm/prefill", slot=i, tokens=len(ids),
                    stage="llm_server", request=req.id):
                if not self.paged:
                    self._prefill_slot(i, req)
                else:
                    (self._prefill_ragged if self._ragged
                     else self._prefill_dense)(i, req, adm)
        except Exception as e:  # noqa: BLE001 — fails this request
            # a failing prefill must not leak its budget or adoption
            # refs, nor leave the client blocked until its timeout; the
            # slot stays free for the next request. An injected fault
            # also fails the pass (the loop's retry), as in the JAX engine
            if adm is not None:
                self._kv.cancel(adm)
            self._slot_adm[i] = None
            self.errors.append(traceback.format_exc())
            req.error = f"{type(e).__name__}: {e}"
            req.done.set()
            if isinstance(e, reliability.InjectedFault):
                raise
            return
        req.decode_started_at = time.time()
        self._record_prefill(len(ids) - (adm.matched_len if adm else 0),
                             time.perf_counter() - t0)

    def _instruments(self):
        """The engine's series, or None while observability is off
        (declared at first use)."""
        if not obs.enabled():
            return None
        if self._ins is None:
            self._ins = _llm_instruments()
        return self._ins

    def _priority_instruments_get(self):
        """The scheduler's series: None without the scheduler or while
        observability is off."""
        if not (self._sched is not None and obs.enabled()):
            return None
        if self._pri_ins is None:
            self._pri_ins = _priority_instruments()
        return self._pri_ins

    def _record_kv_gauges(self, ins):
        backlog = len(self._sched) if self._sched is not None else 0
        ins["queue"].set(self._queue.qsize() + backlog)
        pri = self._priority_instruments_get()
        if pri is not None:
            for cls, depth in self._sched.depths().items():
                pri["queue_class"].labels(**{"class": cls}).set(depth)
            pri["parked"].set(self._sched.parked())
        if self.paged:
            ins["kv_pages"].set(self.pages_in_use)
            # page 0 is the trash page, never allocatable
            ins["kv_occupancy"].set(
                self.pages_in_use / max(self._num_pages - 1, 1))
            self._kv.record_gauges()

    def _record_prefill(self, n_tokens: int, seconds: float):
        self.prefill_tokens_total += n_tokens
        ins = self._instruments()
        if ins is not None:
            ins["prefill_tokens"].inc(n_tokens)
            ins["prefill_seconds"].observe(seconds)
            self._record_kv_gauges(ins)

    def _read_page_kv(self, pid: int):
        """The spill's copy of one page: ``(k, v, ready)``, standalone
        copies of ``pool[:, pid]`` enqueued on the engine's stream (ahead
        of any later reuse of the id) and the event behind them (None on
        the CPU). Engine thread only."""
        k = self._k_pages[:, pid].clone()
        v = self._v_pages[:, pid].clone()
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        return k, v, ready

    def _write_pages_kv(self, pids, k_devs, v_devs, ready=None):
        """The fetch's landing: write uploaded pages into the pools IN
        PLACE (the captured steps hold the pools' addresses), behind the
        uploads' event on the worker's stream."""
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for t in list(k_devs) + list(v_devs):
                # made on the worker's stream, read on this one
                t.record_stream(stream)
        for pid, k, v in zip(pids, k_devs, v_devs):
            self._k_pages[:, pid].copy_(k)
            self._v_pages[:, pid].copy_(v)

    def _poll_fetches(self):
        """Land the finished host-tier fetches: a completed upload is
        written into the pool (the admission then is a device prefix
        hit); a failed, cancelled or timed-out one degrades to a plain
        miss. Either way the admission waits in ``_fetch_ready`` for a
        slot."""
        timeout = self._tier.fetch_timeout
        k = 0
        while k < len(self._fetch_wait):
            ent = self._fetch_wait[k]
            req, adm = ent["req"], ent["adm"]
            job = adm.fetch_job
            done = job is None or job.done.is_set()
            if not done and time.perf_counter() - ent["t0"] <= timeout:
                k += 1
                continue
            landed = (done and job is not None and job.ok
                      and not job.cancelled)
            if landed:
                self._kv.materialize(adm, job.k_dev, job.v_dev, job.event)
            else:
                self._kv.degrade(adm)
            del self._fetch_wait[k]
            wait_s = time.perf_counter() - ent["t0"]
            self.fetch_waits += 1
            self.fetch_wait_seconds += wait_s
            if flight.enabled:
                flight.record("fetch", request_id=req.id,
                              trace_id=_trace_of(req),
                              pages=len(adm.shared_pages),
                              wait_ms=round(wait_s * 1000.0, 3),
                              status="landed" if landed else "degraded")
            if req.trace:
                obs.add_complete(
                    "kvtier/fetch_wait", time.time() - wait_s, wait_s,
                    trace=req.trace["trace_id"], request=req.id,
                    pages=len(adm.shared_pages),
                    degraded=adm.matched_len == adm.device_matched
                    and job is not None and not job.ok)
            self._fetch_ready.append((req, adm))

    def _prefill_ragged(self, i: int, req: Request, adm: Admission):
        """Prefill in place on the page pool: the uncached suffix runs at
        offset ``matched_len`` (0 with no cache hit) while attention
        reads the adopted prefix pages through the block table; an
        adopted partial tail is forked into the request's first own
        page. Then the slot takes the request (:meth:`_finish_prefill`)."""
        page = self._page
        ids = self._prompt_of(req)
        T, off = len(ids), adm.matched_len
        own = self._kv.alloc(-(-T // page) - off // page)
        try:
            row_pages = list(adm.shared_pages) + own
            tail = adm.tail_src is not None
            bucket = _pow2_bucket(T - off, page)
            ops = self._upload(prefill_operands(
                ids, off, T, bucket, row_pages, page=page,
                pages_cap=self._pages_cap, fork_dst=own[0] if tail else 0,
                fork_src=adm.tail_src if tail else 0))
            chunk = chunk_operands(ops, bucket, self._pages_cap)
            kp, vp, last = self._fam_ragged_prefill(
                self.model.params, self.cfg, self._k_pages, self._v_pages,
                *chunk, page=page)
            if kp is not self._k_pages or vp is not self._v_pages:
                raise RuntimeError("prefill must write the pools in place")
        except BaseException:
            self._kv.free_owned(own)     # physical pages must not leak
            raise
        self._finish_prefill(i, req, row_pages, own, last, chunk[3], adm)

    def _prefill_dense(self, i: int, req: Request, adm: Admission):
        """``ragged_prefill=False``: the suffix through the family's
        dense staging prefill (``paged_prefill_partial``) over the
        adopted prefix pages (one trash page when nothing matched),
        gathered into a temp cache; the write-back window re-writes an
        adopted tail's shared slots into the request's fork page."""
        page = self._page
        ids = self._prompt_of(req)
        T, off = len(ids), adm.matched_len
        koff = off // page
        own = self._kv.alloc(-(-T // page) - koff)
        try:
            row_pages = list(adm.shared_pages) + own
            gsrc = list(adm.shared_pages)
            if adm.tail_src is not None:
                gsrc.append(adm.tail_src)
            n_pp = 1 << max(len(gsrc) - 1, 0).bit_length()
            bucket = _pow2_bucket(T - off, page)
            toks = np.zeros((1, bucket), np.int32)
            toks[0, :T - off] = ids[off:]
            pids = np.zeros(n_pp, np.int32)
            pids[:len(gsrc)] = gsrc
            pos = koff * page + np.arange(page + bucket)
            rp = np.asarray(row_pages, np.int32)
            phys = np.where(pos < T, rp[np.minimum(pos // page,
                                                   len(rp) - 1)], 0)
            bt_row = np.zeros(self._pages_cap, np.int32)
            bt_row[:len(row_pages)] = row_pages
            kp, vp, last = self._fam_partial_prefill(
                self.model.params, self.cfg, self._k_pages, self._v_pages,
                self._upload(toks), T - off, off, self._upload(pids),
                self._upload(phys.astype(np.int32)),
                self._upload((pos % page).astype(np.int32)), page=page)
            if kp is not self._k_pages or vp is not self._v_pages:
                raise RuntimeError("prefill must write the pools in place")
        except BaseException:
            self._kv.free_owned(own)
            raise
        self._finish_prefill(i, req, row_pages, own, last,
                             self._upload(bt_row), adm)

    def _finish_prefill(self, i: int, req: Request, row_pages, own, last,
                        bt_row_dev, adm: Optional[Admission]):
        """Shared epilogue of every prefill path: row ``i`` of the device
        tables and ``_last`` take the request, in stream order behind
        the prefill; the admission's transient tail ref drops (the fork
        that read it is enqueued); the slot takes the request and its
        full prompt pages are indexed."""
        self._last[i] = last
        self._bt_dev[i] = bt_row_dev
        T = len(self._prompt_of(req))
        self._lens_dev[i] = T
        self._bt[i, :] = 0
        self._bt[i, :len(row_pages)] = row_pages
        self._lens[i] = T
        if adm is not None:
            self._kv.release_transient(adm)
        self._slot_pages[i] = own
        self._slots[i] = req
        self._remaining[i] = self._budget_of(req)
        self._index_prompt(i, req)

    def _index_prompt(self, i: int, req: Request):
        """Make the request's FULL prompt pages reusable at once (not at
        EOS): requests sharing the prompt adopt them while this one still
        decodes. The partly filled prompt tail stays private until EOS,
        and adopters fork it rather than race this row's decode writes."""
        prompt = self._prompt_of(req)
        nfull = len(prompt) // self._page
        if self._kv.enabled and nfull:
            self._kv.insert(prompt[:nfull * self._page], self._bt[i, :nfull])

    def _prefill_slot(self, i: int, req: Request):
        """The slot-static prefill, the JAX engine's broadcast pass: the
        prompt as ``(max_batch, T)`` identical rows through the family's
        ``forward`` from the slot's position, of which only row ``i``'s
        K/V is kept. ``forward`` writes every row's window ``[start,
        start + T)`` in place, so the other slots' rows of that window
        are saved before and put back after, also when the pass raises.
        The pass runs every row, so an MoE layer's capacity sees the
        batch the JAX pass gives it."""
        b, t = self.max_batch, len(req.prompt_ids)
        start = int(self._lens[i])
        toks = self._upload(np.ascontiguousarray(
            np.broadcast_to(req.prompt_ids, (b, t))))
        positions = (start + torch.arange(t, dtype=torch.int32,
                                          device=self.device)).expand(b, t)
        window = slice(start, start + t)
        saved = {n: self._cache[n][:, :, window].clone() for n in ("k", "v")}
        ok = False
        try:
            logits, _ = self._fam_forward(
                self.model.params, self.cfg, toks,
                {"k": self._cache["k"], "v": self._cache["v"], "pos": start},
                positions)
            ok = True
        finally:
            # a pass that raised part way may have written any layer:
            # every row goes back, row i too unless the pass completed
            for n, old in saved.items():
                if ok:
                    old[:, i] = self._cache[n][:, i, window]
                self._cache[n][:, :, window] = old
        self._last[i] = logits[i, -1]
        self._lens[i] = start + t
        self._lens_dev[i] = start + t
        self._slots[i] = req
        self._remaining[i] = req.max_new_tokens

    # -- mixed prefill+decode dispatch and chunked admission -----------------
    def _chunk_end(self, off: int, T: int) -> int:
        """Page-aligned end of the next chunk from ``off``: the largest
        page multiple within ``chunk_tokens`` of ``off``, so every chunk
        after the first starts on a page and only the final one (which
        runs to the prompt's end) may end mid-page."""
        end = ((off + self._chunk_tokens) // self._page) * self._page
        return T if end >= T else max(end, off + 1)

    def _begin_chunked(self, i: int, req: Request, adm: Admission,
                       prepaid: bool = False):
        """Admit a long-suffix request without prefilling it: later
        passes feed the prompt chunk by chunk. The slot is held (no later
        request overtakes it) but decodes only after the final chunk.
        ``prepaid`` admissions (landed host-tier fetches) charged their
        whole budget at admission; the others charge chunk by chunk."""
        self._chunk_state[i] = {
            "req": req, "adm": adm, "off": adm.matched_len,
            "row_pages": list(adm.shared_pages), "own": [],
            "prepaid": prepaid, "first": True,
            "t0": time.perf_counter(), "wait_t0": None}
        self._slots[i] = req
        self._remaining[i] = 0

    def _chunk_slot(self) -> Optional[int]:
        """Round-robin pick of the one chunking slot to advance this pass
        (a pass's prefill budget is one chunk); with priority classes the
        best class's chunker, the lowest slot among equals. A request
        that failed meanwhile is rolled back here."""
        if self._chunk_state is None:
            return None
        n = self.max_batch
        if self._sched is not None:
            best = None
            for i in range(n):
                st = self._chunk_state[i]
                if st is None:
                    continue
                if st["req"].cancel_requested or st["req"].done.is_set():
                    self._rollback_chunk(i, None)
                    continue
                key = (_PRIORITY_RANK[st["req"].priority], i)
                if best is None or key < best[0]:
                    best = (key, i)
            return best[1] if best is not None else None
        for k in range(n):
            i = (self._chunk_rr + k) % n
            st = self._chunk_state[i]
            if st is None:
                continue
            if st["req"].cancel_requested or st["req"].done.is_set():
                self._rollback_chunk(i, None)
                continue
            self._chunk_rr = (i + 1) % n
            return i
        return None

    def _prepare_chunk(self, i: int) -> Optional[dict]:
        """Ledger charge, pages and operands of slot ``i``'s next chunk.
        The first chunk was charged at admission; a later one charges its
        own pages, and the final one also the decode budget, so the sum
        equals the unchunked charge. None: the ledger cannot cover the
        chunk now (decode goes on; the chunk retries next pass, and past
        ``chunk_wait`` its request is shed with the chain rolled back)."""
        st = self._chunk_state[i]
        req, adm = st["req"], st["adm"]
        page, ids = self._page, self._prompt_of(req)
        T, off = len(ids), st["off"]
        if not st["first"]:
            # the fault site between chunks: a raise frees the partial
            # chain and fails the request retriably
            try:
                reliability.inject("llm.chunk")
            except Exception as e:  # noqa: BLE001 — any injected fault
                self._rollback_chunk(
                    i, f"chunked admission failed between chunks: "
                       f"{type(e).__name__}: {e} (retriable: partial "
                       "chain rolled back; resubmit)")
                return None
        end = self._chunk_end(off, T)
        n_new = -(-end // page) - len(st["row_pages"])
        final = end == T
        need = n_new
        if final and not st["prepaid"]:
            need += (-(-(T + self._budget_of(req)) // page)
                     - (-(-T // page)))
        charge_now = 0 if (st["prepaid"] or st["first"]) else need
        if charge_now and not self._kv.charge_chunk(adm, charge_now):
            now = time.perf_counter()
            if st["wait_t0"] is None:
                st["wait_t0"] = now
            elif now - st["wait_t0"] > self._chunk_wait:
                victim = i
                if self._sched is not None:
                    # a starved chunker sheds the worst strictly lower
                    # class chunker instead of itself, if there is one:
                    # freeing that chain is what unblocks the ledger
                    rank_i = _PRIORITY_RANK[req.priority]
                    worst = None
                    for j in range(self.max_batch):
                        sj = self._chunk_state[j]
                        if sj is None or j == i:
                            continue
                        rj = _PRIORITY_RANK[sj["req"].priority]
                        if rj > rank_i and (worst is None
                                            or (rj, j) > worst[0]):
                            worst = ((rj, j), j)
                    if worst is not None:
                        victim = worst[1]
                        st["wait_t0"] = now
                self._rollback_chunk(
                    victim, f"chunked admission starved: the ledger could "
                            f"not cover the next {charge_now} pages within "
                            f"{self._chunk_wait:g}s (retriable: partial "
                            "chain rolled back; resubmit)")
            return None
        st["wait_t0"] = None
        try:
            if n_new > 0:
                self._kv.ensure_free(n_new)
            new_pages = self._kv.alloc(n_new) if n_new > 0 else []
        except BaseException:
            self._kv.uncharge_chunk(adm, charge_now)
            raise
        tail = st["first"] and adm.tail_src is not None
        bucket = _pow2_bucket(end - off, page)
        ops = prefill_operands(ids, off, end, bucket,
                               st["row_pages"] + new_pages, page=page,
                               pages_cap=self._pages_cap,
                               fork_dst=new_pages[0] if tail else 0,
                               fork_src=adm.tail_src if tail else 0)
        if flight.enabled:
            flight.record("chunk_charge", request_id=req.id,
                          trace_id=_trace_of(req), chunk_tokens=end - off,
                          off=off, end=end, final=final,
                          charged_pages=charge_now,
                          new_pages=len(new_pages))
        return {"i": i, "c": end - off, "end": end, "final": final,
                "bucket": bucket, "new_pages": new_pages,
                "charged": charge_now, "ops": ops}

    def _chunk_dispatched(self, cargs: dict, clast, bt_row_dev):
        """After a chunk is enqueued: advance the chunk's cursor; at the
        first chunk drop the fork source's transient ref; at the final
        one run the whole prefill's epilogue, the slot turning into a
        decode row over the chain the chunks built."""
        i = cargs["i"]
        st = self._chunk_state[i]
        st["row_pages"].extend(cargs["new_pages"])
        st["own"].extend(cargs["new_pages"])
        st["off"] = cargs["end"]
        if st["first"]:
            st["first"] = False
            self._kv.release_transient(st["adm"])
        self.prefill_tokens_total += cargs["c"]
        self.prefill_chunks_total += 1
        ins = self._instruments()
        if ins is not None:
            ins["prefill_tokens"].inc(cargs["c"])
        if cargs["final"]:
            self._chunk_state[i] = None
            self._finish_prefill(i, st["req"], st["row_pages"], st["own"],
                                 clast, bt_row_dev, None)
            st["req"].decode_started_at = time.time()
            if ins is not None:
                # admission to prompt complete: decode passes interleave,
                # so this is the chunked prefill's latency
                ins["prefill_seconds"].observe(
                    time.perf_counter() - st["t0"])
                self._record_kv_gauges(ins)

    def _rollback_chunk(self, i: int, msg: Optional[str]):
        """Shed or abandon a chunked admission mid-prompt: the partial
        chain's pages, its adoption refs and every charge taken so far go
        back (at once: every later use of those pages is enqueued behind
        the steps still reading them), and the request fails retriably
        (``msg`` None: its handle is already done)."""
        st = self._chunk_state[i]
        req, adm = st["req"], st["adm"]
        released = len(st["own"]) + len(adm.shared_pages)
        self._kv.release_transient(adm)
        self._kv.release_slot(adm.charge + adm.fetch_reserved, st["own"],
                              adm.shared_pages)
        adm.charge = 0
        adm.fetch_reserved = 0
        adm.shared_pages = []
        self._chunk_state[i] = None
        self._slots[i] = None
        self._remaining[i] = 0
        self._slot_adm[i] = None
        if flight.enabled:
            flight.record("rollback", request_id=req.id,
                          trace_id=_trace_of(req),
                          reason="cancelled" if msg is None else "starved",
                          released_pages=released)
        if msg is not None and not req.done.is_set():
            req.error = msg
            req.done.set()
        ins = self._instruments()
        if ins is not None:
            ins["requests"].labels(
                reason="cancelled" if msg is None else "error").inc()

    def _restore_chunk_pass(self, cargs: dict):
        """A pass failed after :meth:`_prepare_chunk`: give the chunk's
        pages and charge back, so a retry starts from the same ledger."""
        self._kv.free_owned(cargs["new_pages"])
        self._kv.uncharge_chunk(self._chunk_state[cargs["i"]]["adm"],
                                cargs["charged"])

    def _mixed_instruments(self):
        """The mixed dispatch's series: None unless it is live and
        observability records."""
        if not (self._mixed_active and obs.enabled()):
            return None
        if self._mixed_ins is None:
            self._mixed_ins = {
                "pass_rows": obs.counter(
                    "bigdl_llm_pass_rows_total",
                    "Rows served by unified engine passes, by kind",
                    labelnames=("kind",)),
                "chunks": obs.counter(
                    "bigdl_llm_prefill_chunks_total",
                    "Prefill chunks dispatched by the unified engine"),
                "mix": obs.gauge(
                    "bigdl_llm_pass_mix",
                    "Decode-row fraction of the last unified pass "
                    "(1.0 = pure decode, 0.0 = chunk-only)"),
            }
        return self._mixed_ins

    def _record_mixed_pass(self, n_decode: int, cargs: dict,
                           t_step: float):
        """One chunk-carrying pass's batch mix and its span."""
        ins = self._mixed_instruments()
        if ins is None:
            return
        wall = time.perf_counter() - t_step
        ins["pass_rows"].labels(kind="prefill_chunk").inc()
        if n_decode:
            ins["pass_rows"].labels(kind="decode").inc(n_decode)
        ins["chunks"].inc()
        ins["mix"].set(n_decode / (n_decode + 1))
        obs.add_complete(
            "llm/mixed_step", time.time() - wall, wall,
            decode_rows=n_decode, chunk_tokens=cargs["c"],
            offset=cargs["end"] - cargs["c"], final=cargs["final"],
            slot=cargs["i"])

    def _dispatch_chunk_solo(self, cargs: dict, t_step: float):
        """A chunk with no decode row to fuse with: the family's ragged
        prefill alone, eagerly (the mixed step's chunk leg, the same
        math)."""
        try:
            ops = self._upload(cargs["ops"])
            chunk = chunk_operands(ops, cargs["bucket"], self._pages_cap)
            _, _, clast = self._fam_ragged_prefill(
                self.model.params, self.cfg, self._k_pages, self._v_pages,
                *chunk, page=self._page)
        except BaseException:
            self._restore_chunk_pass(cargs)
            raise
        self._chunk_dispatched(cargs, clast, chunk[3])
        self._record_mixed_pass(0, cargs, t_step)

    def _mixed_step(self, bucket: int) -> tuple:
        """The mixed step of chunk bucket ``bucket`` (made at its first
        use): a :class:`CapturedStep` over the decode buffers and the
        bucket's own operand and ``clast`` buffers."""
        ms = self._mixed_steps.get(bucket)
        if ms is None:
            dev = self.device
            ops = torch.zeros(bucket * 3 + 4 + self._pages_cap,
                              dtype=torch.int32, device=dev)
            clast = torch.zeros(self.cfg.vocab_size, dtype=torch.float32,
                                device=dev)
            step = CapturedStep(bind_mixed_step(
                self.model.params, self.cfg, self._k_pages, self._v_pages,
                self._bt_dev, self._lens_dev, self._last, self._active_dev,
                self._toks_dev, ops, clast, bucket=bucket, page=self._page,
                temperature=self._temp, generator=self._gen,
                do_sample=self._do_sample, top_k=self.top_k,
                fam_step=self._fam_mixed_step), dev, generators=self._gens,
                name="llm/step_mixed",
                signature=f"B={self.max_batch} chunk={bucket}",
                costs=step_costs(self.model.params, self.cfg,
                                 self.max_batch + bucket,
                                 self.model.cache_dtype))
            ms = self._mixed_steps[bucket] = (step, ops, clast)
        return ms

    def _dispatch_mixed(self, disp, cargs: dict, t_step: float) -> bool:
        """One mixed pass: every decode row plus one prefill chunk in one
        step (a replay of the bucket's graph from its second pass on).
        One host copy fills the bucket's operand buffer in stream order;
        the pass drains like a decode step (the chunk row emits no
        token)."""
        step, ops, clast = self._mixed_step(cargs["bucket"])
        try:
            ops.copy_(self._pinned(cargs["ops"]), non_blocking=True)
            step()
        except BaseException:
            self._restore_chunk_pass(cargs)
            raise
        rec = self._record(disp, fn=step.name,
                           chunk=(cargs["end"] - cargs["c"], cargs["c"]))
        # the final chunk's epilogue goes behind this pass's record: its
        # table writes pin into the next record's uploads
        self._chunk_dispatched(cargs, clast, chunk_operands(
            ops, cargs["bucket"], self._pages_cap)[3])
        self.mixed_passes += 1
        self._record_mixed_pass(len(disp), cargs, t_step)
        return self._after_dispatch(rec, t_step)

    # -- self-speculative decoding -------------------------------------------
    def _spec_proposer(self, i: int, req: Request):
        """Slot ``i``'s draft proposer, made anew for each request: the
        adaptive state is the request's own."""
        st = self._spec_state[i]
        if st is None or st["req"] is not req:
            st = self._spec_state[i] = {
                "req": req, "prop": NGramProposer(
                    k=self._spec_k, min_match=self._spec_min_match,
                    backoff=self._spec_backoff)}
        return st["prop"]

    def _spec_history(self, i: int):
        """Slot ``i``'s row, its proposer and its token history, or None
        when the row cannot verify now (spent, its verify in flight, or
        still chunking its prompt, or aborted)."""
        req = self._slots[i]
        if req is None or req.cancel_requested or i in self._spec_pending \
                or self._remaining[i] < 2:
            return None
        if self._chunk_state is not None and \
                self._chunk_state[i] is not None:
            return None
        ids = list(map(int, req.prompt_ids)) + list(map(int, req.tokens))
        return req, self._spec_proposer(i, req), ids

    def _prepare_spec(self) -> Optional[dict]:
        """Pick one decode row whose history predicts its future and
        draft for it; None runs the pass as plain decode.

        Two-phase, as the JAX engine's: drafting needs the row's exact
        history and length, which at depth > 1 are current only once the
        in-flight window drains, and draining gives up the overlap. So a
        proposal on the possibly stale history comes first, rows taken
        round robin, and only a hit drains the window and proposes again
        on the exact history."""
        cand = None
        start = self._spec_rr % self.max_batch
        for i in (list(range(start, self.max_batch))
                  + list(range(start))):
            row = self._spec_history(i)
            if row is not None and row[1].propose(
                    row[2], limit=int(self._remaining[i])):
                cand = i
                break
        if cand is None:
            return None
        # the fault site between drafting and dispatch: a raise drops the
        # drafts and the pass runs as plain decode, the same tokens
        try:
            reliability.inject("llm.spec")
        except Exception:  # noqa: BLE001 — any injected fault
            return None
        while self._inflight:
            self._drain_next()
        i = cand
        row = self._spec_history(i)
        if row is None:
            return None            # the drain finished the row
        req, prop, ids = row
        # the proposal's first token targets the position the step fills
        # with g0 on the device: the drafts are the rest
        drafts = prop.propose(ids, limit=int(self._remaining[i]))[1:]
        if not drafts:
            return None
        self._spec_rr = i + 1
        clen = len(drafts) + 1
        pos0, page = int(self._lens[i]), self._page
        p_have = -(-pos0 // page)
        return {"i": i, "req": req, "drafts": drafts, "clen": clen,
                "bucket": max(2, 1 << (clen - 1).bit_length()),
                "pos0": pos0, "p_have": p_have,
                "n_new": -(-(pos0 + clen) // page) - p_have,
                "match": prop.last_match}

    def _spec_step(self, bucket: int) -> tuple:
        """The verify step of draft bucket ``bucket`` (made at its first
        use): a :class:`CapturedStep` over the decode buffers and the
        bucket's own operand and output buffers."""
        ss = self._spec_steps.get(bucket)
        if ss is None:
            dev = self.device
            ops = torch.zeros(2 + 3 * bucket + self._pages_cap,
                              dtype=torch.int32, device=dev)
            sout = torch.zeros(self.max_batch + 1 + bucket,
                               dtype=torch.int32, device=dev)
            step = CapturedStep(bind_spec_step(
                self.model.params, self.cfg, self._k_pages, self._v_pages,
                self._bt_dev, self._lens_dev, self._last, self._active_dev,
                sout, ops, bucket=bucket, page=self._page,
                temperature=self._temp, generator=self._gen,
                do_sample=self._do_sample, top_k=self.top_k,
                fam_step=self._fam_spec_step), dev, generators=self._gens,
                name="llm/step_spec",
                signature=f"B={self.max_batch} drafts={bucket}",
                costs=step_costs(self.model.params, self.cfg,
                                 self.max_batch + bucket,
                                 self.model.cache_dtype))
            ss = self._spec_steps[bucket] = (step, ops, sout)
        return ss

    def _spec_instruments(self):
        """The speculation counters: None unless speculation is live and
        observability records."""
        if not (self._spec_active and obs.enabled()):
            return None
        if self._spec_ins is None:
            self._spec_ins = {
                "proposed": obs.counter(
                    "bigdl_llm_spec_proposed_tokens_total",
                    "Draft tokens dispatched to speculative verify"),
                "accepted": obs.counter(
                    "bigdl_llm_spec_accepted_tokens_total",
                    "Draft tokens accepted by speculative verify"),
                "passes": obs.counter(
                    "bigdl_llm_spec_passes_total",
                    "Engine passes carrying a speculative verify "
                    "chunk"),
            }
        return self._spec_ins

    def _dispatch_spec(self, disp, sargs: dict, t_step: float) -> bool:
        """One speculative pass: every other decode row advances one
        token while the chosen row's drafts run as a verify chunk (a
        replay of the bucket's graph from its second pass on). The row's
        host length advances at the drain, where ``n_acc`` is known."""
        i, bucket = sargs["i"], sargs["bucket"]
        step, ops, sout = self._spec_step(bucket)
        ops.copy_(self._pinned(verify_operands(
            i, sargs["drafts"], sargs["pos0"], bucket, self._bt[i],
            page=self._page)), non_blocking=True)
        step()
        rec = self._record(disp, sout, fn=step.name,
                           chunk=(sargs["pos0"], sargs["clen"]))
        n_draft = sargs["clen"] - 1
        rec["spec"] = {"i": i, "req": sargs["req"], "n_draft": n_draft,
                       "bucket": bucket}
        self._spec_pending.add(i)
        self.spec_proposed_total += n_draft
        self.spec_passes += 1
        ins = self._spec_instruments()
        if ins is not None:
            ins["proposed"].inc(n_draft)
            ins["passes"].inc()
        req = sargs["req"]
        if flight.enabled:
            flight.record("draft", request_id=req.id,
                          trace_id=_trace_of(req), slot=i, n_draft=n_draft,
                          match_len=sargs["match"], offset=sargs["pos0"])
        wall = time.perf_counter() - t_step
        obs.add_complete("llm/spec_step", time.time() - wall, wall,
                         decode_rows=len(disp), n_draft=n_draft, slot=i)
        return self._after_dispatch(rec, t_step)

    def _dispatchable(self) -> List[int]:
        """Slots that get a row in the next step: a live request with
        dispatches left. Capping dispatches at ``max_new_tokens`` keeps
        the steps dispatched past a data-dependent EOS inside the
        admission budget; a slot whose last step is in flight, that is
        still chunking its prompt, or whose verify is in flight sits
        out."""
        return [i for i, r in enumerate(self._slots)
                if r is not None and self._remaining[i] > 0
                and i not in self._spec_pending]

    def _step_paged(self) -> bool:
        """Dispatch one pass: a decode step for every dispatchable slot,
        fused with the next prefill chunk when a slot is chunking (or the
        chunk alone when nothing decodes), or drain the oldest step in
        flight when there is nothing to dispatch; False when there is
        nothing to do."""
        ci = self._chunk_slot()
        disp = self._dispatchable()
        cargs = self._prepare_chunk(ci) if ci is not None else None
        if not disp:
            if cargs is not None:
                self._dispatch_chunk_solo(cargs, time.perf_counter())
                return True
            if self._inflight:
                self._drain_next()
                return True
            return False
        t_step = time.perf_counter()
        sargs = None
        if ci is None and self._spec_active:
            # a pass carries a prefill chunk or one row's verify chunk,
            # never both (a chunking admission keeps the pass: TTFT
            # first). The draft hit may drain the whole window, and rows
            # may finish at those drains: the decode set is recomputed,
            # without the verify row (its advance is the chunk's)
            sargs = self._prepare_spec()
            si = sargs["i"] if sargs is not None else -1
            disp = [j for j in self._dispatchable() if j != si]
            if sargs is None and not disp:
                if self._inflight:
                    self._drain_next()
                return True
        page = self._page
        # the page for position lens[i] must exist before the step; the
        # grant is one scatter into the device table, not an upload of
        # it. With the prefix cache, warm chains may hold the free list:
        # evict for all grants BEFORE changing a table. A verify chunk
        # also takes every page of [pos0, pos0 + clen) the row lacks,
        # within its admission charge (clen <= remaining)
        try:
            need = sum(1 for i in disp if int(self._lens[i]) % page == 0)
            if sargs is not None:
                need += sargs["n_new"]
            if need:
                self._kv.ensure_free(need)
        except BaseException:
            if cargs is not None:
                self._restore_chunk_pass(cargs)
            raise
        grants = []
        for i in disp:
            pos = int(self._lens[i])
            if pos % page == 0:
                pid = self._kv.take_free()     # guaranteed by the budget
                self._bt[i, pos // page] = pid
                self._slot_pages[i].append(pid)
                grants.append((i * self._pages_cap + pos // page, pid))
        if sargs is not None:
            si = sargs["i"]
            for j in range(sargs["n_new"]):
                pid = self._kv.take_free()
                col = sargs["p_have"] + j
                self._bt[si, col] = pid
                self._slot_pages[si].append(pid)
                grants.append((si * self._pages_cap + col, pid))
        if grants:
            at, pid = self._upload(np.ascontiguousarray(
                np.asarray(grants, np.int64).T))
            self._bt_dev.view(-1).index_copy_(0, at, pid.to(torch.int32))
        self._set_active(disp)
        if sargs is not None:
            return self._dispatch_spec(disp, sargs, t_step)
        if cargs is not None:
            return self._dispatch_mixed(disp, cargs, t_step)
        mins = self._mixed_instruments()
        if mins is not None:
            # a pure decode pass of the mixed dispatch: the batch mix
            # still tells the whole story
            mins["pass_rows"].labels(kind="decode").inc(len(disp))
            mins["mix"].set(1.0)
        self._decode()
        return self._after_dispatch(self._record(disp), t_step)

    def _step_slotted(self) -> bool:
        """One pass of the slot-static engine: the decode step over every
        row, the dispatchable ones active (their positions advance on the
        device and in ``_lens``), or a drain when nothing dispatches;
        False when there is nothing to do."""
        disp = self._dispatchable()
        if not disp:
            if self._inflight:
                self._drain_next()
                return True
            return False
        t_step = time.perf_counter()
        self._set_active(disp)
        self._decode()
        return self._after_dispatch(self._record(disp), t_step)

    def _step(self) -> bool:
        """One engine pass after admission: the paged or the slot-static
        engine's. ``llm.step`` fires every pass; ``worker.stall`` (a
        ``delay`` there wedges the pass as a hung step would) only while
        a slot is live, so idle passes spend none of a plan's events."""
        reliability.inject("llm.step")
        if any(r is not None for r in self._slots):
            reliability.inject("worker.stall")
        return self._step_paged() if self.paged else self._step_slotted()

    def _set_active(self, disp: List[int]):
        """The device's active mask, rewritten in stream order when the
        dispatched rows changed."""
        mask = np.zeros(self.max_batch, bool)
        mask[disp] = True
        if not np.array_equal(mask, self._active):
            self._active_dev.copy_(self._upload(mask))
            self._active = mask

    def _record(self, disp, src: Optional[torch.Tensor] = None,
                fn: Optional[str] = None,
                chunk: Optional[tuple] = None) -> dict:
        """The in-flight record of the step just enqueued: its output
        (``src``, by default the sampled ids) copied to a host buffer of
        its own, an event behind it, the rows it decoded (their host
        lengths advanced), the pinned buffers its uploads read, and for
        the live roofline (flight recorder on) the step's program name
        ``fn`` (by default the decode step's) and the (keys, pairs) it
        attends: each decode row's keys, and a prefill ``chunk`` of
        ``(offset, n)`` tokens."""
        src = self._toks_dev if src is None else src
        out = self._toks_host[self.steps % self.pipeline_depth][
            :src.shape[0]]
        out.copy_(src, non_blocking=True)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        for i in disp:
            self._lens[i] += 1
            self._remaining[i] -= 1
        rec = {"out": out, "event": event,
               "pairs": [(i, self._slots[i]) for i in disp],
               "pinned": self._pending_release,
               "fn": fn or self._decode.name}
        self._pending_release = []
        if flight.enabled and self.paged:
            keys = int(self._lens[disp].sum()) if disp else 0
            pairs = keys
            if chunk is not None:
                off, n = chunk
                keys += off + n
                pairs += n * off + n * (n + 1) // 2
            rec["attn"] = (keys, pairs)
        return rec

    def _after_dispatch(self, rec: dict, t0: float) -> bool:
        """Account the dispatch's host time, push the record onto the
        in-flight window and drain down to the depth (depth 1 drains at
        once: the synchronous engine)."""
        rec["host_s"] = time.perf_counter() - t0
        self.host_seconds += rec["host_s"]
        self.steps += 1
        self._inflight.append(rec)
        ins = self._instruments()
        if ins is not None:
            ins["inflight"].set(len(self._inflight))
        while len(self._inflight) >= self.pipeline_depth:
            self._drain_next()
        return True

    def _drain_next(self):
        """Retire the oldest step in flight: wait for its event (the step
        and every write enqueued before it have retired), read its ids,
        then apply them one step behind dispatch. A slot whose request
        finished meanwhile discards its token."""
        rec = self._inflight.popleft()
        t0 = time.perf_counter()
        if rec["event"] is not None:
            rec["event"].synchronize()
        vals = rec["out"].tolist()
        now = time.perf_counter()
        stall = now - t0
        self.stall_seconds += stall
        rec["pinned"] = None
        # delivered tokens, finished and reaped requests of this drain
        tally = [0, 0, 0]
        for i, req in rec["pairs"]:
            if self._slots[i] is not req:
                continue           # a token for a finished request
            if req.cancel_requested:
                # aborted mid-decode: the slot and its pages go now, the
                # drained token is discarded like any speculative one
                self._finish_slot(i, req)
                tally[2] += 1
                continue
            tally[0] += 1
            tally[1] += self._apply_token(i, req, vals[i], now)
        sp = rec.get("spec")
        if sp is not None:
            self._drain_spec(sp, vals, now, tally)
        ins = self._instruments()
        if ins is not None:
            ins["inflight"].set(len(self._inflight))
        self._record_decode(ins, len(rec["pairs"]), tally,
                            rec.get("host_s", 0.0), stall, rec["fn"],
                            rec.get("attn"))

    def _record_decode(self, ins, n_active: int, tally: List[int],
                       host_s: float, stall_s: float, fn: str,
                       attn: Optional[tuple] = None):
        """One drained step's series: the tokens delivered (speculative
        tokens of finished requests excluded), its host and stall times
        (times the drain already measured: no device read), the finished
        and reaped requests, and the gauges; and the live roofline's
        sample of program ``fn`` (gated on the flight switch inside
        ``observe``)."""
        utilization.observe(fn, host_s + stall_s, attn)
        if ins is None:
            return
        applied, finished, cancelled = tally
        wall = host_s + stall_s
        ins["decode_tokens"].inc(applied)
        ins["decode_seconds"].observe(wall)
        ins["decode_host"].observe(host_s)
        ins["decode_stall"].observe(stall_s)
        obs.add_complete("llm/decode_step", time.time() - wall, wall,
                         active=n_active, step=self.steps,
                         host_s=round(host_s, 6), stall_s=round(stall_s, 6))
        # live occupancy: a record may carry pairs of requests an earlier
        # drain finished
        ins["active"].set(sum(r is not None for r in self._slots))
        if finished:
            ins["requests"].labels(reason="done").inc(finished)
        if cancelled:
            ins["requests"].labels(reason="cancelled").inc(cancelled)
        self._record_kv_gauges(ins)

    def _drain_spec(self, sp: dict, vals: List[int], now: float,
                    tally: List[int]):
        """A verify record's row: its output is ``[B ids][n_acc][W chunk
        tokens]``; ``g0`` and the accepted drafts go through
        :meth:`_apply_token` one by one, so EOS and ``max_new_tokens``
        stop inside the prefix. The host length advances by ``n_acc``
        (the device's did in the step) and the proposer observes."""
        i, req = sp["i"], sp["req"]
        self._spec_pending.discard(i)
        if self._slots[i] is not req:
            return                 # the slot changed hands: nothing to apply
        if req.cancel_requested:
            self._finish_slot(i, req)
            tally[2] += 1
            return
        b = self.max_batch
        n_acc = vals[b]
        self._lens[i] += n_acc
        self._remaining[i] -= n_acc
        st = self._spec_state[i]
        if st is not None:
            st["prop"].observe(sp["n_draft"], n_acc - 1)
        self.spec_accepted_total += n_acc - 1
        self.spec_emitted_total += n_acc
        ins = self._spec_instruments()
        if ins is not None:
            ins["accepted"].inc(n_acc - 1)
        if flight.enabled:
            flight.record("verify_accept" if n_acc - 1 == sp["n_draft"]
                          else "verify_reject", request_id=req.id,
                          trace_id=_trace_of(req), slot=i,
                          n_draft=sp["n_draft"], accepted=n_acc - 1,
                          emitted=n_acc)
        for tok in vals[b + 1:b + 1 + n_acc]:
            tally[0] += 1
            if self._apply_token(i, req, tok, now):
                tally[1] += 1
                break

    def _apply_token(self, i: int, req: Request, tok: int,
                     now: float) -> bool:
        """Append one drained token; True when it finished the request
        (EOS or its budget)."""
        req.tokens.append(tok)
        req.t_tokens.append(now)
        slo = self._slo
        if len(req.tokens) == 1:
            req.t_first_token = now                   # TTFT stamp
            if slo is not None:
                slo.observe_ttft(now - req.t_submit)
                req.t_last_token = now
        elif slo is not None:
            gap = now - req.t_last_token
            req.t_last_token = now
            req.itl_max = max(req.itl_max, gap)
            slo.observe_itl(gap)
        if (self.eos_token_id is not None and tok == self.eos_token_id) \
                or len(req.tokens) >= req.max_new_tokens:
            self._finish_slot(i, req)
            if slo is not None:
                slo.finish(req.t_first_token - req.t_submit,
                           req.itl_max if req.itl_max >= 0 else None)
            return True
        return False

    def _finish_slot(self, i: int, req: Request):
        """Retire a finished request: with the prefix cache, index its
        prompt + output first (indexed pages stay warm at refcount 1),
        then drop its refs, pins and charge."""
        self._emit_decode_span(req)
        if flight.enabled:
            flight.record(
                "finish", request_id=req.id, trace_id=_trace_of(req),
                tokens=len(req.tokens),
                cancelled=req.cancel_requested or None,
                ttft_ms=(round((req.t_first_token - req.t_submit) * 1000.0,
                               3) if req.t_first_token else None))
        req.done.set()
        if self._spec_state is not None:
            self._spec_state[i] = None   # the next occupant drafts afresh
        self._release_slot(i, req)

    def _emit_decode_span(self, req: Request):
        """One ``llm/decode`` span over a finished request's whole decode
        phase, stitched under its trace (decode steps are shared by every
        slot, so the per-request span is emitted per request)."""
        if not req.trace or not req.decode_started_at:
            return
        args = {"trace": req.trace["trace_id"], "stage": "llm_server",
                "request": req.id, "tokens": len(req.tokens)}
        if req.trace.get("parent_span"):
            args["parent_span"] = req.trace["parent_span"]
        obs.add_complete("llm/decode", req.decode_started_at,
                         time.time() - req.decode_started_at, **args)

    def _release_slot(self, i: int, req: Request):
        """Give slot ``i`` back: with the prefix cache, index prompt +
        output first (indexed pages stay warm at refcount 1), then drop
        the request's refs, pins and charge, and point the row at
        trash. A slot-static slot restarts at position 0: stale K/V past
        the next request's positions is masked and overwritten as it
        advances."""
        self._slots[i] = None
        self._remaining[i] = 0
        self._lens[i] = 0
        self._lens_dev[i] = 0
        if not self.paged:
            return
        adm = self._slot_adm[i]
        if self._kv.enabled:
            toks = np.concatenate([req.prompt_ids,
                                   np.asarray(req.tokens, np.int32)])
            self._kv.insert(toks, self._bt[i, :-(-len(toks) // self._page)])
        self._kv.release_slot(adm.charge if adm else 0, self._slot_pages[i],
                              adm.shared_pages if adm else ())
        self._slot_pages[i] = []
        self._slot_adm[i] = None
        # orphaned rows must point at trash: a stale id could alias a
        # reissued page and the inactive row's dummy write clobber it.
        # The device row is reset behind the steps in flight, which still
        # read the old one (their writes land before any reissue's).
        self._bt[i, :] = 0
        self._bt_dev[i] = 0

    # -- lossless preemption --------------------------------------------------
    def _consider_preempt(self):
        """A waiter the sweep could not seat: preempt the worst strictly
        lower-class decode, at most one a window of in-flight steps (the
        victim waits for that window's newest record, and a second
        victim before it drains could not seat the waiter either).
        Rows mid-chunk (rollback owns them), spent (they finish at the
        next drain) or waiting on a verify (their length is still data
        on the device) are not victims."""
        rec = self._preempt_rec
        if rec is not None and any(r is rec for r in self._inflight):
            return
        self._preempt_rec = None
        best = self._sched.best_rank()
        if best is None:
            return
        victim = None
        for i in range(self.max_batch):
            req = self._slots[i]
            if req is None or req.done.is_set() or req.cancel_requested:
                continue
            if self._chunk_state is not None and \
                    self._chunk_state[i] is not None:
                continue
            if self._remaining[i] <= 0 or i in self._spec_pending:
                continue
            rank = _PRIORITY_RANK[req.priority]
            if rank <= best:
                continue
            # worst class first; among equals the youngest decode (the
            # fewest tokens to prefill again at resume)
            key = (rank, -len(req.tokens), i)
            if victim is None or key > victim[0]:
                victim = (key, i)
        if victim is not None:
            self._preempt_slot(victim[1])

    def _preempt_slot(self, i: int):
        """Evict the decode in slot ``i`` losslessly: with the prefix
        cache its chain prompt + drained tokens is indexed ("indexed";
        the resume adopts it as an ordinary hit), and with the host tier
        also exported into ``_parked`` ("exported": the blob keeps the
        chain whatever the radix evicts, until the resume), else dropped;
        the slot and pages go back as at a finish, and the request
        re-queues as prompt + generated so far with the budget it has
        left. Its hold record, the newest in flight, keeps it out of a
        slot until that record drains: the drain's identity check would
        otherwise hand a stale token to it, re-admitted into its old
        slot. Steps still in flight write past the indexed length, and
        every later write of a freed page is enqueued behind them. The
        ``llm.preempt`` fault site fires before anything moves."""
        reliability.inject("llm.preempt")
        req = self._slots[i]
        t0 = time.perf_counter()
        with obs.span("llm/preempt", slot=i, stage="llm_server",
                      request=req.id, victim_class=req.priority,
                      tokens_done=len(req.tokens)):
            self._release_slot(i, req)
            toks = np.concatenate([req.prompt_ids,
                                   np.asarray(req.tokens, np.int32)])
            mode = "indexed" if self._kv.enabled else "dropped"
            if self._tier is not None:
                try:
                    self._parked[req.id] = self._export_chain_locked(toks)
                    mode = "exported"
                except Exception:  # noqa: BLE001 — the export is an
                    # optimisation: the resume prefills whatever is missing
                    self.errors.append(traceback.format_exc())
            self.preempt_modes[mode] += 1
            req.resume_ids = toks
            req.preemptions += 1
            req._hold_rec = self._inflight[-1] if self._inflight else None
            self._preempt_rec = req._hold_rec
            self.preemptions_total += 1
            self._sched.push(req)
        pri = self._priority_instruments_get()
        if pri is not None:
            pri["preemptions"].labels(**{"class": req.priority}).inc()
        if flight.enabled:
            flight.record(
                "preempt", request_id=req.id, trace_id=_trace_of(req),
                slot=i, priority=req.priority, mode=mode,
                tokens_done=len(req.tokens),
                remaining=self._budget_of(req),
                wall_ms=round((time.perf_counter() - t0) * 1000.0, 3))
