"""Layered configuration — the port of ``bigdl_tpu/utils/conf.py``.

The same four layers, resolved lowest to highest, with the same key
names, environment names, file and defaults table as the JAX package,
so one deployment's configuration drives either package:

1. **defaults** — the table below (+ an optional ``bigdl-tpu.conf``
   properties file: ``key=value`` lines, ``#`` comments; path from
   ``BIGDL_TPU_CONF`` or ``./bigdl-tpu.conf``);
2. **environment** — ``BIGDL_TPU_<KEY>`` with dots mapped to
   underscores (``bigdl.llm.kvcache.enabled`` ←
   ``BIGDL_TPU_LLM_KVCACHE_ENABLED``);
3. **programmatic** — ``conf.set("bigdl.llm.kvcache.enabled", "true")``;
4. **call-site kwargs** — an explicit constructor argument wins
   outright.

The port keeps a store of its own (``conf.set`` on one package does not
reach the other; the environment and the file reach both). Keys that
configure parts of the JAX package the port does not have yet
(``bigdl.engine.type``, ``bigdl.mesh.*``, ``bigdl.elastic.*``, the
router's failover and hedging, the time-series and federation planes)
stay in the table, unread.

Typed getters (``get_int``/``get_bool``/``get_float``) validate at read
time.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional

_DEFAULTS: Dict[str, str] = {
    "bigdl.engine.type": "",            # "" = auto (JAX package only)
    "bigdl.mesh.axes": "data",          # comma-separated axis names
    "bigdl.mesh.shape": "",             # comma-separated ints; "" = auto
    "bigdl.coordinator.address": "",
    "bigdl.num.processes": "",
    "bigdl.process.id": "",
    "bigdl.optimizer.max.retry": "0",   # iteration-retry attempts
    "bigdl.observability.enabled": "true",    # metrics + trace spans
    "bigdl.observability.trace.capacity": "65536",  # span ring entries
    "bigdl.observability.exemplars": "8",     # slowest-N latency traces
    # quantile-sketch relative-error bound: every Sketch
    # series resolves percentiles to within this fraction, and only
    # same-alpha sketches merge across the fleet
    "bigdl.observability.sketch.alpha": "0.01",
    # fleet metric federation: router/supervisor-embedded
    # collectors scrape member /metrics/snapshot and serve the merged
    # view. false = no collector thread, endpoints 404
    "bigdl.observability.federation": "false",
    "bigdl.observability.federation.interval": "2.0",  # scrape cadence (s)
    # engine flight recorder + live roofline: typed
    # decision-event ring behind /debug/flight + /debug/explain/<id>,
    # and bigdl_device_* utilization gauges. false = no ring, no
    # series, endpoints 404
    "bigdl.observability.flight.enabled": "false",
    "bigdl.observability.flight.capacity": "4096",  # ring events
    # in-process time-series plane: bounded ring of periodic
    # registry snapshots with typed window queries (/metrics/query,
    # /fleet/timeline) + the declarative alert engine (/alerts).
    # false = no sampler thread, no ring, no bigdl_timeseries_* /
    # bigdl_alerts_* series, all three endpoints 404
    "bigdl.observability.timeseries.enabled": "false",
    "bigdl.observability.timeseries.interval": "5.0",   # sample cadence (s)
    "bigdl.observability.timeseries.retention": "600",  # history kept (s)
    # window backing the bigdl_slo_burn_rate gauges when the plane is
    # on (seconds of traffic instead of slo.py's last-N-requests deque)
    "bigdl.observability.timeseries.slo.window": "300",
    # JSON list of alert rules replacing the built-in multi-window SLO
    # burn set (see observability/alerts.py); "" = built-ins
    "bigdl.observability.alerts.rules": "",
    # per-platform peak specs for the roofline gauges; 0 = auto-detect
    # from the PJRT device_kind (see observability/utilization.py)
    "bigdl.device.peak.tflops": "0",          # dense bf16 TFLOP/s
    "bigdl.device.peak.gbps": "0",            # HBM GB/s
    # per-request SLO accounting: TTFT/ITL sketches +
    # threshold classification + rolling burn rate. false = no sketch
    # series, no bigdl_slo_* series
    "bigdl.slo.enabled": "false",
    "bigdl.slo.ttft_ms": "500",               # admission -> first token
    "bigdl.slo.itl_ms": "200",                # worst inter-token gap
    "bigdl.slo.window": "100",                # burn-rate request window
    # availability objective backing the alert engine's error budget:
    # burn = violation_ratio / (1 - objective)
    "bigdl.slo.objective": "0.99",
    "bigdl.reliability.enabled": "true",      # fault sites + policies
    "bigdl.reliability.retry.max.attempts": "3",   # tries, not retries
    "bigdl.reliability.retry.base.delay": "0.05",  # seconds
    "bigdl.reliability.retry.max.delay": "2.0",    # backoff cap
    "bigdl.checkpoint.keep": "0",             # retention; 0 = unlimited
    # async engine: decode steps dispatched ahead of the host
    # drain. 1 = fully synchronous (the pre-pipeline engine, exactly)
    "bigdl.llm.pipeline_depth": "2",
    # prefix-aware KV cache: radix-indexed page reuse with
    # refcounts + COW. false = the pre-kvcache engine exactly
    "bigdl.llm.kvcache.enabled": "false",
    # ragged in-place prefill: prefill attends cached prefix
    # pages where they sit (the ragged kernel) instead of staging the
    # context through a dense temp cache. auto = on in the port (its
    # CUDA kernel on a card, its plain twin on the CPU; the JAX package
    # takes it only where its Mosaic kernel runs); true/false force a
    # path. false = the dense-staging prefill paths exactly
    "bigdl.llm.prefill.ragged": "auto",
    # unified mixed prefill+decode dispatch: one compiled
    # engine step serves decode rows AND one page-aligned prefill
    # chunk, so a long admission never stalls in-flight decodes for a
    # whole pass. Requires the ragged in-place prefill (inert under
    # the dense escape hatch). false = the split engine exactly
    "bigdl.llm.mixed.enabled": "false",
    "bigdl.llm.prefill.chunk_tokens": "0",    # 0 = auto (4 pages)
    "bigdl.llm.prefill.chunk.wait": "30.0",   # budget-starved chunk ->
                                              # shed + clean rollback
    # model-free self-speculative decoding: n-gram drafts
    # from the request's own history verified by a fused chunk pass —
    # up to k+1 tokens per engine tick, greedy-only, bit-identical
    # output. false = structurally absent (no proposer state, no
    # bigdl_llm_spec_* series)
    "bigdl.llm.spec.enabled": "false",
    "bigdl.llm.spec.k": "4",           # draft ceiling per tick
    "bigdl.llm.spec.min_match": "2",   # shortest trusted suffix n-gram
    "bigdl.llm.spec.backoff": "0.5",   # acceptance EMA floor: below it
                                       # the live draft length halves
    # SLO-class priority scheduling: class-ordered admission
    # + lossless preemption of in-flight decodes (KV exported, request
    # re-queued as prompt+generated with its remaining budget). false =
    # FIFO, structurally absent (no scheduler objects, no class series)
    "bigdl.llm.priority.enabled": "false",
    # tiered KV cache: evicted chains spill to a pinned
    # host-RAM arena with async HBM<->host migration. Requires the
    # prefix cache; false = structurally absent
    "bigdl.llm.kvtier.enabled": "false",
    "bigdl.llm.kvtier.host_pages": "0",       # 0 = auto (4x device pool)
    "bigdl.llm.kvtier.fetch.timeout": "30.0", # stuck fetch -> plain miss
    "bigdl.llm.kvtier.sync": "false",         # inline migration (tests)
    # disaggregated serving: "" unified, "prefill" or
    # "decode" restricts an LLMWorker to one side of the KV handoff
    "bigdl.llm.role": "",
    # request-level failover: the router journals in-flight
    # requests and resumes prompt+generated on another backend after a
    # decode failure. false = the plain router (no journal,
    # no prober thread, blocking dispatch)
    "bigdl.llm.failover.enabled": "false",
    "bigdl.llm.failover.max.attempts": "3",   # dispatch tries/request
    # OpenAI-compatible gateway: /v1/completions,
    # /v1/chat/completions and /v1/models on workers and the router,
    # with stream=true relayed as SSE from the failover journal drain.
    # false = structurally absent (routes 404 naming this gate, no
    # bigdl_api_* series, the api package is never imported)
    "bigdl.llm.api.enabled": "false",
    "bigdl.llm.api.tokenizer": "",            # "" token-ids only; "byte"
    "bigdl.llm.api.chat_template": "plain",   # plain | llama | chatglm
    "bigdl.llm.prober.interval": "0.5",       # /healthz poll (seconds)
    # hedged dispatch: duplicate a slow prefill/decode call
    # to a second backend after a p95-based delay; first success wins
    "bigdl.llm.hedge.enabled": "false",
    "bigdl.llm.hedge.delay.ms": "0",          # 0 = p95-based (observed)
    "bigdl.llm.hedge.min.delay.ms": "50",     # floor under the p95 rule
    "bigdl.llm.hedge.budget": "0.1",          # hedges / requests cap
    # engine watchdog: a device step stalled past the timeout
    # flips /healthz to 503 and fails pending requests retriably.
    # 0 = off (no watchdog thread, no series)
    "bigdl.llm.watchdog.step_timeout": "0",
    # derived Retry-After: seconds = clamp(base +
    # per_queued * queue_depth, 1, max) stretched by up to `jitter`
    "bigdl.llm.retry_after.base": "1.0",
    "bigdl.llm.retry_after.per_queued": "0.25",
    "bigdl.llm.retry_after.max": "30",
    "bigdl.llm.retry_after.jitter": "0.2",
    "bigdl.train.prefetch": "true",           # stage batch N+1 during N
    "bigdl.train.prefetch.depth": "2",        # staged batches held ahead
    # elastic multi-host training: supervisor + peer
    # heartbeats + collective-hang watchdog + snapshot-based recovery.
    # false = the optimizer loop, Engine and metric registry are exactly
    # the pre-elastic objects (no agent thread, no ring, no series)
    "bigdl.elastic.enabled": "false",
    "bigdl.elastic.supervisor.address": "",   # host:port; "" = ring-only
    "bigdl.elastic.heartbeat.interval": "0.5",  # agent beat cadence (s)
    "bigdl.elastic.heartbeat.timeout": "5.0",   # peer presumed dead (s)
    # a worker wedged before its FIRST heartbeat never registers, so
    # peer expiry can't see it: fail the generation if the world has
    # not fully joined within this budget. 0 = no join deadline
    "bigdl.elastic.join.timeout": "300",
    # stalled-collective watchdog: a step heartbeat older than this
    # while the loop is live means a wedged shard_map step. 0 = off
    "bigdl.elastic.step.timeout": "0",
    "bigdl.elastic.snapshot.every": "10",     # steps per RAM snapshot
    "bigdl.elastic.snapshot.ring": "2",       # RAM ring capacity
    # committed snapshots per durable flush (process 0 writes the
    # atomic checkpoint tier); 0 = never flush mid-epoch
    "bigdl.elastic.snapshot.flush.every": "1",
    "bigdl.elastic.max.restarts": "3",        # restart budget (both tiers)
    "bigdl.elastic.generation": "0",          # set by the launcher env
    # static-analysis runtime witness: wrap threading.Lock/
    # RLock creation to record acquisition order and flag inversions
    # against the static lock graph during chaos runs. false = the
    # stock factories, no table, no series (structurally absent)
    "bigdl.analysis.lockwatch": "false",
}


def _env_key(key: str) -> str:
    return "BIGDL_TPU_" + key.replace("bigdl.", "", 1) \
        .replace(".", "_").upper()


class BigDLConf:
    """The layered store. One process-global instance lives at
    ``bigdl_tpu_torch.utils.conf.conf`` (the System-properties analog)."""

    def __init__(self, conf_file: Optional[str] = None):
        self._lock = threading.RLock()
        self._file_layer: Dict[str, str] = {}
        self._set_layer: Dict[str, str] = {}
        path = conf_file or os.environ.get("BIGDL_TPU_CONF",
                                           "bigdl-tpu.conf")
        if path and os.path.exists(path):
            self.load_file(path)

    # -- layers --------------------------------------------------------------
    def load_file(self, path: str) -> "BigDLConf":
        """Parse a ``key=value`` properties file (# comments)."""
        with self._lock, open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#") or "=" not in line:
                    continue
                k, v = line.split("=", 1)
                self._file_layer[k.strip()] = v.strip()
        return self

    def set(self, key: str, value: Any) -> "BigDLConf":
        with self._lock:
            self._set_layer[key] = str(value)
        self._apply_dynamic(key)
        return self

    def unset(self, key: str) -> "BigDLConf":
        with self._lock:
            self._set_layer.pop(key, None)
        self._apply_dynamic(key)
        return self

    def _apply_dynamic(self, key: str):
        """Keys consumed at import time by other modules get pushed to
        them on change, so programmatic set() works after import."""
        if key.startswith("bigdl.observability."):
            try:
                from bigdl_tpu_torch.observability import _state
                _state.refresh(key)
            except Exception:
                pass
        elif key.startswith("bigdl.reliability."):
            try:
                from bigdl_tpu_torch.reliability import _state
                _state.refresh(key)
            except Exception:
                pass

    # -- resolution ----------------------------------------------------------
    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        with self._lock:
            if key in self._set_layer:
                return self._set_layer[key]
            env = os.environ.get(_env_key(key))
            if env is not None:
                return env
            if key in self._file_layer:
                return self._file_layer[key]
            if key in _DEFAULTS:
                return _DEFAULTS[key] or default
            return default

    def get_int(self, key: str, default: Optional[int] = None
                ) -> Optional[int]:
        v = self.get(key)
        if v in (None, ""):
            return default
        try:
            return int(v)
        except ValueError:
            raise ValueError(f"config {key}={v!r} is not an int") from None

    def get_float(self, key: str, default: Optional[float] = None
                  ) -> Optional[float]:
        v = self.get(key)
        if v in (None, ""):
            return default
        try:
            return float(v)
        except ValueError:
            raise ValueError(f"config {key}={v!r} is not a float") from None

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self.get(key)
        if v in (None, ""):
            return default
        if v.lower() in ("true", "1", "yes", "on"):
            return True
        if v.lower() in ("false", "0", "no", "off"):
            return False
        raise ValueError(f"config {key}={v!r} is not a bool")

    def effective(self) -> Dict[str, str]:
        """Fully-resolved view of every known key (for logging/debug)."""
        keys = set(_DEFAULTS) | set(self._file_layer) | set(self._set_layer)
        return {k: self.get(k) for k in sorted(keys)}


conf = BigDLConf()
