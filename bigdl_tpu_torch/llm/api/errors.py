"""OpenAI-style error objects for the serving gateway — the port of
``bigdl_tpu/llm/api/errors.py``.

Every client-visible failure on the ``/v1/*`` surface is one JSON body
shaped exactly like the OpenAI API's::

    {"error": {"message": ..., "type": ..., "param": ..., "code": ...}}

The mapping is fixed by the tentpole contract:

- engine overload / backend shed (the 503 the native surface answers)
  → HTTP **429** with ``type=rate_limit_exceeded`` carrying the
  class-weighted ``Retry-After`` the native path already derives —
  OpenAI clients retry on 429, not 503, so the gateway translates the
  status while keeping the backoff signal byte-identical;
- any client-side schema problem (bad body, infeasible prompt, 422
  from the engine) → HTTP **400/422** with
  ``type=invalid_request_error`` and ``param`` naming the field;
- upstream failures the failover layer could not absorb → HTTP
  **502/504** with ``type=api_error``.

These are plain exceptions, not HTTP glue: the gateway raises them
from translation/dispatch and renders them once at the top of the
handler (or as a terminal SSE event when the stream already started).
"""

from __future__ import annotations

from typing import Optional


class ApiError(Exception):
    """A client-visible gateway failure carrying its OpenAI rendering."""

    #: OpenAI error ``type`` field.
    kind = "api_error"
    #: default HTTP status when not given explicitly
    status = 500

    def __init__(self, message: str, status: Optional[int] = None,
                 param: Optional[str] = None,
                 code: Optional[str] = None):
        super().__init__(message)
        if status is not None:
            self.status = int(status)
        self.param = param
        self.code = code

    def body(self) -> dict:
        err = {"message": str(self), "type": self.kind,
               "param": self.param, "code": self.code}
        return {"error": err}

    def headers(self):
        return ()


class InvalidRequestError(ApiError):
    """The request body is malformed or infeasible — the client's
    fault, never retried, never failed over (mirrors the native 400/422
    split; the gateway keeps the engine's status when it has one)."""

    kind = "invalid_request_error"
    status = 400


class RateLimitError(ApiError):
    """Overload shed translated for OpenAI clients: 429 +
    ``rate_limit_exceeded`` + the class-weighted Retry-After the native
    surface would have sent on its 503."""

    kind = "rate_limit_error"
    status = 429

    def __init__(self, message: str, retry_after: str = "1"):
        super().__init__(message, code="rate_limit_exceeded")
        self.retry_after = str(retry_after)

    def headers(self):
        return (("Retry-After", self.retry_after),)


class UpstreamError(ApiError):
    """The backend (engine or routed worker) failed in a way the
    failover layer could not absorb — 502, or 504 on deadline."""

    kind = "api_error"
    status = 502


def error_for_status(status: int, message: str,
                     retry_after: Optional[str] = None) -> ApiError:
    """Map a native-surface HTTP outcome onto the OpenAI vocabulary:
    503 shed → 429 ``rate_limit_exceeded`` (keeping the class-weighted
    Retry-After), other 4xx → ``invalid_request_error`` at the same
    status, 5xx → ``api_error``. The router's gateway backend uses
    this so the translation lives next to the error objects."""
    if status == 503:
        return RateLimitError(message, retry_after=retry_after or "1")
    if 400 <= status < 500:
        return InvalidRequestError(message, status=status)
    return UpstreamError(message, status=status)
