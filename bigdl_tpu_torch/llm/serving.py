"""Continuous-batching LLM serving over a paged KV cache — the port of
``bigdl_tpu/llm/serving.py``, slice (a) of ROADMAP Queue 1 item 6:

- the device functions of the paged decode step (``paged_attend``,
  ``scatter_new_kv``, ``paged_decode_step``, its sampled lift
  ``paged_decode_step_sampled``, and ``bind_decode_step``, that step
  over the engine's persistent buffers);
- :class:`LLMServer` with paged decode, whole-prompt ragged prefill,
  worst-case admission budgets, EOS / ``max_new_tokens`` finishing and
  page release, and the JAX engine's pipelined dispatch: block tables
  and lengths resident on the device, up to ``pipeline_depth`` decode
  steps in flight (default 2), and the decode step replayed as one
  captured CUDA graph (``llm/graphs.py``), the port's ``jax.jit``.

The engine's other options raise ``NotImplementedError`` naming their
ROADMAP item; none is silently ignored.
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
import uuid
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from bigdl_tpu_torch.device import resolve_device
from bigdl_tpu_torch.llm.graphs import CapturedStep
from bigdl_tpu_torch.llm.kernels.paged_attention import (
    LANE, merge_attention_partial, paged_attention_stats)
from bigdl_tpu_torch.llm.kernels.sampling import make_sampled_step
from bigdl_tpu_torch.llm.kvcache import Admission, KVCacheManager
from bigdl_tpu_torch.llm.models.llama import (decoder_layer, layer_params,
                                              lm_logits,
                                              paged_prefill_ragged,
                                              rms_norm)


class OverloadError(RuntimeError):
    """The server refuses a request for capacity (full queue, draining);
    the caller may retry later."""


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
    b = toks.shape[0]
    x = params["embed_tokens"][toks.long()][:, None]         # (B, 1, H)
    positions = lens[:, None].to(torch.int32)
    attend_l = paged_attend(k_pages, v_pages, bt, lens, page=page,
                            sliding_window=cfg.sliding_window)
    k_new, v_new = [], []
    for l in range(cfg.num_hidden_layers):
        x, k, v = decoder_layer(
            layer_params(params["layers"], l), x, positions, cfg,
            lambda q, k, v, l=l: attend_l(l, q, k, v)[:, None])
        k_new.append(k[:, 0])
        v_new.append(v[:, 0])
    x = rms_norm(x, params["norm"], cfg.rms_norm_eps)
    logits = lm_logits(params, x)
    k_pages, v_pages = scatter_new_kv(k_pages, v_pages, bt, lens,
                                      torch.stack(k_new),
                                      torch.stack(v_new), page=page)
    return logits[:, 0].to(torch.float32), k_pages, v_pages


# the engine's step shape for the llama family: sampling folded in,
# inactive rows routed to the trash page, their logits carried
paged_decode_step_sampled = make_sampled_step(paged_decode_step)


def bind_decode_step(params, cfg, k_pages, v_pages, bt, lens, last, active,
                     toks, *, page: int, temperature: float = 1.0,
                     generator=None, do_sample: bool = False,
                     top_k: int = 0):
    """The engine's decode step as a function of no arguments over
    persistent buffers, what :class:`CapturedStep` captures: it reads
    ``bt`` (B, pages_cap) int32 and ``active`` (B,) bool, samples every
    row's next token from ``last`` (B, V) f32 into ``toks`` (B,) int32,
    and writes back in place the next logits into ``last``, the advanced
    lengths into ``lens`` (B,) int32 and every row's new K/V into the
    pools — so the next call reads what this one wrote."""

    def step():
        t, logits, kp, vp, new_lens = paged_decode_step_sampled(
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


class Request:
    """Handle returned by :meth:`LLMServer.submit`."""

    def __init__(self, prompt_ids, max_new_tokens: int):
        self.id = str(uuid.uuid4())
        self.prompt_ids = np.asarray(prompt_ids, np.int32).ravel()
        self.max_new_tokens = max_new_tokens
        self.tokens: List[int] = []
        self.error: Optional[str] = None
        self.done = threading.Event()
        # TTFT accounting: submit stamp here, first-token stamp at drain
        self.t_submit = time.perf_counter()
        self.t_first_token = 0.0

    def get(self, timeout: Optional[float] = None) -> List[int]:
        if not self.done.wait(timeout):
            raise TimeoutError(f"request {self.id} still running")
        if self.error is not None:
            raise RuntimeError(f"request {self.id} failed: {self.error}")
        return list(self.tokens)


# options of the JAX engine that this slice does not implement, and the
# ROADMAP item that will (asking for one raises; none is ignored)
_NOT_PORTED = {
    "kvcache": "the radix prefix cache is ROADMAP Queue 1 item 6(b)",
    "kvtier": "the host KV tier is ROADMAP Queue 1 item 6(f)",
    "host_pages": "the host KV tier is ROADMAP Queue 1 item 6(f)",
    "mixed": "mixed prefill+decode dispatch is ROADMAP Queue 1 item 6(c)",
    "chunk_tokens": "chunked admission is ROADMAP Queue 1 item 6(c)",
    "chunk_wait": "chunked admission is ROADMAP Queue 1 item 6(c)",
    "spec": "self-speculative decoding is ROADMAP Queue 1 item 6(d)",
    "spec_k": "self-speculative decoding is ROADMAP Queue 1 item 6(d)",
    "priority": "priority classes and preemption are ROADMAP Queue 1 "
                "item 6(e)",
    "slo": "SLO accounting (observability) is ROADMAP Queue 1 item 8",
    "watchdog_timeout": "the engine watchdog (reliability) is ROADMAP "
                        "Queue 1 item 8",
}



class LLMServer:
    """Continuous-batching engine over a Llama-family model, paged KV.

    KV lives in a page pool ``(L, num_pages, H_kv, page_size, D)`` on the
    model's device; each request owns ``ceil(tokens / page)`` pages named
    by its block-table row, taken as tokens land and freed when it
    finishes. Admission reserves the worst-case page budget of prompt +
    ``max_new_tokens``, so decode never deadlocks on an empty pool; page
    0 is the trash page that inactive rows and prefill padding write.

    Each engine pass admits into free slots (one ragged prefill per
    admission, the prompt padded to a power-of-two bucket) and dispatches
    one decode step over all ``max_batch`` rows, inactive rows masked to
    the trash page — the batch shape never changes, so a request's
    tokens do not depend on what else is in the batch.

    **Pipelined dispatch**, as the JAX engine's. Block tables, lengths,
    the active mask and the last logits live on the device; the step
    reads them and advances lengths and logits in place, and the host
    changes them with small in-place writes in stream order (page
    grants, prefilled rows, the resets of freed rows). The numpy ``_bt``
    and ``_lens`` are the host's view at dispatch time. Up to
    ``pipeline_depth`` steps (default 2) are in flight before the oldest
    is drained: its sampled ids come back through a pinned host buffer
    of its own and an event, and EOS / max-token bookkeeping runs one
    step behind dispatch. Dispatches per request are capped at its
    ``max_new_tokens``; a token drained for a request that finished
    meanwhile is discarded. ``pipeline_depth=1`` is the synchronous
    engine: every step drains before the next dispatch.

    The decode step is one CUDA graph per server (:class:`CapturedStep`,
    the port's ``jax.jit``), captured at the second decode step over the
    server's pools, tables, ``_last`` and mask at ``max_batch``;
    ``temperature``, ``top_k`` and sampling are fixed at construction,
    as in the JAX step's cache key. Prefill runs eagerly. ``stop()``
    frees the graph.

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
                 ragged_prefill: Optional[bool] = None, device=None,
                 **options):
        for name, value in options.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"unexpected keyword argument {name!r}")
            if value not in (None, False, 0):
                raise NotImplementedError(f"{name}={value!r}: "
                                          f"{_NOT_PORTED[name]}")
        if not paged:
            raise NotImplementedError(
                "paged=False: the slot-static cache is not ported "
                "(ROADMAP Queue 1 item 6)")
        if ragged_prefill is False:
            raise NotImplementedError(
                "ragged_prefill=False: the dense staging prefill is "
                "ROADMAP Queue 1 item 5 (make_partial_prefill)")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, server on "
                             f"{self.device}")
        self.model = model
        self.cfg = cfg = model.config
        self.max_batch = max_batch
        self.max_seq_len = min(max_seq_len, cfg.max_position_embeddings)
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
        self.pipeline_depth = max(1, int(2 if pipeline_depth is None
                                         else pipeline_depth))
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

        if page_size is None:
            page_size = model.page_size
        elif page_size != model.page_size:
            raise ValueError(f"page_size {page_size} differs from the "
                             f"model's {model.page_size}")
        if page_size <= 0:
            raise ValueError(f"page_size {page_size} must be positive")
        self._page = page_size
        # block-table width: the JAX engine rounds it up to the Mosaic
        # block multiple (LANE // page); kept so tables compare like with
        # like — the CUDA kernels do not need it
        ppb = max(1, LANE // page_size)
        cap = -(-self.max_seq_len // page_size)
        self._pages_cap = -(-cap // ppb) * ppb
        self._num_pages = num_pages or (1 + max_batch * cap)
        shape = (cfg.num_hidden_layers, self._num_pages,
                 cfg.num_key_value_heads, page_size, cfg.head_dim)
        dev = self.device
        self._k_pages = torch.zeros(shape, dtype=model.cache_dtype,
                                    device=dev)
        self._v_pages = torch.zeros(shape, dtype=model.cache_dtype,
                                    device=dev)
        self._kv = KVCacheManager(self._num_pages, page_size)
        # host bookkeeping: the tables as of the latest dispatch
        self._bt = np.zeros((max_batch, self._pages_cap), np.int32)
        self._lens = np.zeros(max_batch, np.int32)
        self._active = np.zeros(max_batch, bool)
        self._slot_pages: List[List[int]] = [[] for _ in range(max_batch)]
        self._slot_adm: List[Optional[Admission]] = [None] * max_batch
        # their device twins and the step's other persistent buffers,
        # made once: the graph holds their addresses, so none is rebound
        self._bt_dev = torch.zeros((max_batch, self._pages_cap),
                                   dtype=torch.int32, device=dev)
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
        self._toks_host = [torch.zeros(max_batch, dtype=torch.int32,
                                       pin_memory=dev.type == "cuda")
                           for _ in range(self.pipeline_depth)]
        self._step = CapturedStep(
            bind_decode_step(model.params, cfg, self._k_pages,
                             self._v_pages, self._bt_dev, self._lens_dev,
                             self._last, self._active_dev, self._toks_dev,
                             page=page_size, temperature=self._temp,
                             generator=self._gen,
                             do_sample=self._do_sample, top_k=self.top_k),
            dev, generators=(self._gen,) if self._do_sample else ())

    # -- views ---------------------------------------------------------------
    @property
    def pages_in_use(self) -> int:
        """Physical pages owned by live requests."""
        return sum(len(p) for p in self._slot_pages)

    @property
    def _free(self) -> List[int]:
        return self._kv.pool.free_ids()

    @property
    def _budget_avail(self) -> int:
        return self._kv.budget_avail

    # -- client API ----------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int = 32) -> Request:
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        req = Request(prompt_ids, max_new_tokens)
        if len(req.prompt_ids) == 0:
            raise ValueError("empty prompt")
        if len(req.prompt_ids) + max_new_tokens > self.max_seq_len:
            raise ValueError("prompt + max_new_tokens exceeds max_seq_len")
        pages = self._kv.peek(req.prompt_ids, max_new_tokens)
        if pages["pages_needed"] > self._num_pages - 1:
            raise ValueError(
                f"request needs {pages['pages_needed']} pages but the "
                f"pool holds {self._num_pages - 1}; it could never be "
                "admitted")
        if self._draining.is_set():
            raise OverloadError("server is draining: not accepting new "
                                "requests")
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            raise OverloadError(
                f"request queue full ({self.max_queue} waiting); retry "
                f"later [needs {pages['pages_needed']} pages, "
                f"{pages['pages_free']} budget-free]") from None
        return req

    def start(self) -> "LLMServer":
        self._thread = threading.Thread(target=self._loop,
                                        name="bigdl-torch-llm", daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0):
        """Graceful drain (default): refuse new submits, finish every
        accepted request, then stop the engine thread and free the step's
        graph. ``drain=False`` stops at once; accepted requests fail."""
        self._draining.set()
        if drain and self._thread is not None and self._thread.is_alive():
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                with self._lock:
                    if self._idle():
                        break
                time.sleep(0.005)
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60)
        if self._thread is not None and self._thread.is_alive():
            return     # wedged engine thread still owns the state
        with self._lock:
            self._fail_all("server stopped before the request finished")
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._step.close()

    def _idle(self) -> bool:
        return (self._queue.empty() and self._pending_head is None
                and not self._inflight
                and all(r is None for r in self._slots))

    # -- engine --------------------------------------------------------------
    def _loop(self):
        with torch.inference_mode():
            while not self._stop.is_set():
                try:
                    with self._lock:
                        self._admit()
                        busy = self._step_paged()
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
                if not busy:
                    time.sleep(0.002)

    def _fail_all(self, msg: str):
        self._inflight.clear()
        self._pending_release = []
        for i, req in enumerate(self._slots):
            if req is not None:
                req.error = msg
                try:
                    self._finish_slot(i, req)
                except RuntimeError:
                    # a sticky CUDA error refuses the device rows' reset;
                    # the host side of the slot is already released
                    self.errors.append(traceback.format_exc())
        pending = [self._pending_head] if self._pending_head else []
        self._pending_head = None
        while True:
            try:
                pending.append(self._queue.get_nowait())
            except queue.Empty:
                break
        for req in pending:
            req.error = msg
            req.done.set()

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """``a`` on the device, copied in stream order without a wait:
        from pinned memory kept by the next dispatched record until its
        drain proves the copy retired."""
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            t = t.pin_memory()
            self._pending_release.append(t)
        return t.to(self.device, non_blocking=True)

    def _admit(self):
        """Fill free slots from the queue, one ragged prefill each. A
        request is admitted only when its worst-case page budget is
        available; head-of-line: if the next request does not fit, no
        later one is admitted either."""
        for i in range(self.max_batch):
            if self._slots[i] is not None:
                continue
            req = self._pending_head
            if req is None:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    return
            self._pending_head = None
            adm = self._kv.admit(req.prompt_ids, req.max_new_tokens)
            if adm is None:
                self._pending_head = req            # retry next pass
                return
            self._slot_adm[i] = adm
            try:
                self._prefill_ragged(i, req, adm)
            except Exception as e:  # noqa: BLE001 — fails this request
                # a failing prefill must not leak its budget, nor leave
                # the client blocked until its timeout; the slot stays
                # free for the next request
                self._kv.cancel(adm)
                self._slot_adm[i] = None
                self.errors.append(traceback.format_exc())
                req.error = f"{type(e).__name__}: {e}"
                req.done.set()

    def _prefill_ragged(self, i: int, req: Request, adm):
        """Whole-prompt prefill in place on the page pool: the prompt is
        padded to a power-of-two bucket (at least one page); token j
        lands in its own page and slot, padding in trash page 0. Then
        row i of the device tables and ``_last`` take the request, in
        stream order behind any step still in flight."""
        page = self._page
        prompt = req.prompt_ids
        T = len(prompt)
        own = self._kv.alloc(-(-T // page))
        try:
            bucket = max(page, 1 << (T - 1).bit_length())
            toks = np.zeros((1, bucket), np.int64)
            toks[0, :T] = prompt
            bt_row = np.zeros(self._pages_cap, np.int32)
            bt_row[:len(own)] = own
            pos = np.arange(bucket)
            phys = np.where(pos < T, bt_row[np.minimum(
                pos // page, self._pages_cap - 1)], 0).astype(np.int32)
            slots = (pos % page).astype(np.int32)
            bt_d = self._upload(bt_row)
            kp, vp, last = paged_prefill_ragged(
                self.model.params, self.cfg, self._k_pages, self._v_pages,
                self._upload(toks), T, 0, bt_d, self._upload(phys),
                self._upload(slots), 0, 0, page=page)
            if kp is not self._k_pages or vp is not self._v_pages:
                raise RuntimeError("prefill must write the pools in place")
        except BaseException:
            self._kv.free_owned(own)     # physical pages must not leak
            raise
        self._last[i] = last
        self._bt_dev[i] = bt_d
        self._lens_dev[i] = T
        self._bt[i, :] = bt_row
        self._lens[i] = T
        self._slot_pages[i] = own
        self._slots[i] = req
        self._remaining[i] = req.max_new_tokens

    def _dispatchable(self) -> List[int]:
        """Slots that get a row in the next step: a live request with
        dispatches left. Capping dispatches at ``max_new_tokens`` keeps
        the steps dispatched past a data-dependent EOS inside the
        admission budget, and a slot whose last step is in flight sits
        out."""
        return [i for i, r in enumerate(self._slots)
                if r is not None and self._remaining[i] > 0]

    def _step_paged(self) -> bool:
        """Dispatch one decode step for every dispatchable slot, or drain
        the oldest step in flight when there is none; False when there is
        nothing to do."""
        disp = self._dispatchable()
        if not disp:
            if self._inflight:
                self._drain_next()
                return True
            return False
        t_step = time.perf_counter()
        page = self._page
        # the page for position lens[i] must exist before the step; the
        # grant is one scatter into the device table, not an upload of it
        need = sum(1 for i in disp if int(self._lens[i]) % page == 0)
        if need:
            self._kv.ensure_free(need)
        grants = []
        for i in disp:
            pos = int(self._lens[i])
            if pos % page == 0:
                pid = self._kv.take_free()     # guaranteed by the budget
                self._bt[i, pos // page] = pid
                self._slot_pages[i].append(pid)
                grants.append((i * self._pages_cap + pos // page, pid))
        if grants:
            at, pid = self._upload(np.ascontiguousarray(
                np.asarray(grants, np.int64).T))
            self._bt_dev.view(-1).index_copy_(0, at, pid.to(torch.int32))
        mask = np.zeros(self.max_batch, bool)
        mask[disp] = True
        if not np.array_equal(mask, self._active):
            self._active_dev.copy_(self._upload(mask))
            self._active = mask
        self._step()
        out = self._toks_host[self.steps % self.pipeline_depth]
        out.copy_(self._toks_dev, non_blocking=True)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        for i in disp:
            self._lens[i] += 1
            self._remaining[i] -= 1
        rec = {"out": out, "event": event,
               "pairs": [(i, self._slots[i]) for i in disp],
               "pinned": self._pending_release}
        self._pending_release = []
        return self._after_dispatch(rec, t_step)

    def _after_dispatch(self, rec: dict, t0: float) -> bool:
        """Account the dispatch's host time, push the record onto the
        in-flight window and drain down to the depth (depth 1 drains at
        once: the synchronous engine)."""
        rec["host_s"] = time.perf_counter() - t0
        self.host_seconds += rec["host_s"]
        self.steps += 1
        self._inflight.append(rec)
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
        self.stall_seconds += time.perf_counter() - t0
        rec["pinned"] = None
        for i, req in rec["pairs"]:
            if self._slots[i] is req:
                self._apply_token(i, req, vals[i])

    def _apply_token(self, i: int, req: Request, tok: int):
        req.tokens.append(tok)
        if len(req.tokens) == 1:
            req.t_first_token = time.perf_counter()     # TTFT stamp
        if (self.eos_token_id is not None and tok == self.eos_token_id) \
                or len(req.tokens) >= req.max_new_tokens:
            self._finish_slot(i, req)

    def _finish_slot(self, i: int, req: Request):
        req.done.set()
        self._slots[i] = None
        self._remaining[i] = 0
        self._kv.release_slot(self._slot_adm[i].charge,
                              self._slot_pages[i])
        self._slot_pages[i] = []
        self._slot_adm[i] = None
        # orphaned rows must point at trash: a stale id could alias a
        # reissued page and the inactive row's dummy write clobber it.
        # The device row is reset behind the steps in flight, which still
        # read the old one (their writes land before any reissue's).
        self._bt[i, :] = 0
        self._lens[i] = 0
        self._bt_dev[i] = 0
        self._lens_dev[i] = 0
