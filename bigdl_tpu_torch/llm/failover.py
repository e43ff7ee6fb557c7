"""Request-level failover primitives — the part of
``bigdl_tpu/llm/failover.py`` the single-node worker and the OpenAI
gateway need: :class:`StreamAbort`.

The rest of the JAX module (``RequestJournal``, ``HealthProber``,
``LatencyTracker`` / ``HedgePolicy``, ``Canceller``, ``run_hedged``) is
the router's, and comes with ``LLMRouter`` (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations


class StreamAbort(Exception):
    """Raised *through* a decode stream to tear it down without a
    failover retry: the OpenAI gateway raises it when the SSE client
    hung up (``client_gone=True`` — the request is aborted, its slot and
    KV pages free) or when a ``stop`` sequence is satisfied mid-stream
    (the answer is complete; the rest of the token budget would be
    wasted work). Never a breaker failure and never a failover attempt
    — the backend did nothing wrong."""

    def __init__(self, reason: str, client_gone: bool = False):
        super().__init__(reason)
        self.client_gone = client_gone
