"""OpenAI-compatible serving gateway — the port of
``bigdl_tpu/llm/api``.

Gated by ``bigdl.llm.api.enabled`` (default off): the worker/router
construct :class:`~bigdl_tpu_torch.llm.api.gateway.OpenAIGateway` only when
the gate is on — off means ``/v1/*`` answers 404 naming the gate, no
``bigdl_api_*`` series exist, and nothing in this package runs.

Modules: :mod:`~bigdl_tpu_torch.llm.api.gateway` (translation + dispatch),
:mod:`~bigdl_tpu_torch.llm.api.sse` (SSE framing, both sides of the wire),
:mod:`~bigdl_tpu_torch.llm.api.templates` (tokenizer protocol + per-family
chat templates), :mod:`~bigdl_tpu_torch.llm.api.errors` (OpenAI error
objects). The wire contract is the JAX package's (``bigdl_tpu/llm/api``).
"""

from bigdl_tpu_torch.llm.api.errors import (ApiError, InvalidRequestError,
                                            RateLimitError, UpstreamError)
from bigdl_tpu_torch.llm.api.gateway import (EngineBackend, OpenAIGateway,
                                             StopMatcher)
from bigdl_tpu_torch.llm.api.sse import parse_sse, sse_done, sse_event
from bigdl_tpu_torch.llm.api.templates import (ByteTokenizer,
                                               apply_chat_template,
                                               build_tokenizer)

__all__ = [
    "ApiError", "InvalidRequestError", "RateLimitError",
    "UpstreamError", "EngineBackend", "OpenAIGateway", "StopMatcher",
    "parse_sse", "sse_done", "sse_event", "ByteTokenizer",
    "apply_chat_template", "build_tokenizer",
]
