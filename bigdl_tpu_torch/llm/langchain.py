"""LangChain integration — the port of ``bigdl_tpu/llm/langchain.py``
(bigdl-llm's LLM + Embeddings wrappers).

langchain isn't a dependency; the classes duck-type the
``langchain_core`` interfaces (``invoke``/``_call``, ``embed_documents``/
``embed_query``) so they drop into chains when langchain is installed
and stay usable standalone when it isn't. Without a tokenizer, text goes
through the gateway's byte-level fallback
(:class:`~bigdl_tpu_torch.llm.api.templates.ByteTokenizer`): UTF-8
bytes are the token ids, as in the JAX package.

:class:`BigdlTpuOpenAI` is the remote sibling: the same duck-typed LLM
protocol over a live worker's or router's OpenAI gateway (``base_url``
style, like langchain's ``OpenAI(base_url=...)``) instead of an
in-process model — so a chain can point at a serving fleet by URL with
no langchain and no openai package installed. ``device=`` (default the
card) is the one argument the JAX wrappers lack.
"""

from __future__ import annotations

import json
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.llm.api.templates import ByteTokenizer


def _encode(tokenizer, text: str) -> np.ndarray:
    tok = tokenizer if tokenizer is not None else ByteTokenizer()
    return np.asarray([tok.encode(text)], np.int32)


class BigdlTpuLLM:
    """bigdl-llm's ``BigdlLLM`` / ``LlamaLLM`` — text in, text out over a
    converted model directory (``convert_model``), loaded on ``device``
    (``None`` = the GPU)."""

    def __init__(self, model_path: str, tokenizer=None,
                 max_new_tokens: int = 64, temperature: float = 0.0,
                 ctx_size: int = 512, device=None):
        from bigdl_tpu_torch.llm.convert_model import load_model

        self.model = load_model(model_path, max_cache_len=ctx_size,
                                device=device)
        self.tokenizer = tokenizer
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature

    @classmethod
    def from_model(cls, model, tokenizer=None, **kwargs) -> "BigdlTpuLLM":
        self = cls.__new__(cls)
        self.model = model
        self.tokenizer = tokenizer
        self.max_new_tokens = kwargs.get("max_new_tokens", 64)
        self.temperature = kwargs.get("temperature", 0.0)
        return self

    # langchain LLM protocol
    @property
    def _llm_type(self) -> str:
        return "bigdl_tpu"

    def _encode(self, text: str) -> np.ndarray:
        return _encode(self.tokenizer, text)

    def _decode(self, ids) -> str:
        if self.tokenizer is not None:
            return self.tokenizer.decode(list(ids),
                                         skip_special_tokens=True)
        return ByteTokenizer().decode(ids)

    def _call(self, prompt: str, stop: Optional[List[str]] = None,
              **kwargs: Any) -> str:
        ids = self._encode(prompt)
        out = self.model.generate(
            ids, max_new_tokens=self.max_new_tokens,
            do_sample=self.temperature > 0,
            temperature=max(self.temperature, 1e-6))
        text = self._decode(out[0, ids.shape[1]:])
        if stop:
            for s in stop:
                cut = text.find(s)
                if cut >= 0:
                    text = text[:cut]
        return text

    invoke = _call
    __call__ = _call


class BigdlTpuOpenAI:
    """Remote LLM over the OpenAI gateway: the langchain
    ``_call``/``invoke`` protocol backed by ``POST /v1/completions`` on
    a ``bigdl.llm.api.enabled`` worker or router. Prompts may be
    strings (the server needs a tokenizer configured) or token-id
    lists (native, tokenizer-free); ``stream()`` yields the SSE deltas
    as they arrive."""

    def __init__(self, base_url: str, model: str = "bigdl-tpu-llm",
                 max_tokens: int = 64, timeout: float = 120.0,
                 stop: Optional[List[str]] = None):
        self.base_url = base_url
        self.model = model
        self.max_tokens = max_tokens
        self.timeout = timeout
        self.stop = list(stop) if stop else None
        self._addr = self._parse(base_url)

    @staticmethod
    def _parse(base_url: str) -> Tuple[str, int]:
        """``http://host:port[/v1]`` (or bare ``host:port``) → addr."""
        url = base_url
        for prefix in ("http://", "https://"):
            if url.startswith(prefix):
                url = url[len(prefix):]
        url = url.split("/", 1)[0]
        host, _, port = url.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(
                f"base_url must carry host:port, got {base_url!r}")
        return host, int(port)

    @property
    def _llm_type(self) -> str:
        return "bigdl_tpu_openai"

    def _request(self, method: str, path: str, body=None):
        import http.client
        conn = http.client.HTTPConnection(*self._addr,
                                          timeout=self.timeout)
        conn.request(method, path,
                     None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        return conn, conn.getresponse()

    @staticmethod
    def _raise_api_error(status: int, parsed: dict):
        err = parsed.get("error")
        msg = err.get("message", "") if isinstance(err, dict) else err
        raise RuntimeError(f"gateway answered {status}: {msg}")

    def models(self) -> List[str]:
        """Served model ids from ``GET /v1/models``."""
        conn, resp = self._request("GET", "/v1/models")
        try:
            parsed = json.loads(resp.read().decode())
            if resp.status != 200:
                self._raise_api_error(resp.status, parsed)
            return [m["id"] for m in parsed.get("data", [])]
        finally:
            conn.close()

    def _body(self, prompt, stop, stream=False) -> dict:
        body = {"model": self.model, "prompt": prompt,
                "max_tokens": self.max_tokens}
        stops = stop if stop is not None else self.stop
        if stops:
            body["stop"] = stops
        if stream:
            body["stream"] = True
        return body

    def _call(self, prompt, stop: Optional[List[str]] = None,
              **kwargs: Any) -> str:
        conn, resp = self._request(
            "POST", "/v1/completions", self._body(prompt, stop))
        try:
            parsed = json.loads(resp.read().decode())
            if resp.status != 200:
                self._raise_api_error(resp.status, parsed)
            return parsed["choices"][0].get("text", "")
        finally:
            conn.close()

    invoke = _call
    __call__ = _call

    def stream(self, prompt,
               stop: Optional[List[str]] = None) -> Iterator[str]:
        """Yield text deltas from the SSE stream as they arrive."""
        from bigdl_tpu_torch.llm.api.sse import parse_sse
        conn, resp = self._request(
            "POST", "/v1/completions",
            self._body(prompt, stop, stream=True))
        try:
            if resp.status != 200:
                self._raise_api_error(resp.status,
                                      json.loads(resp.read().decode()))
            for obj in parse_sse(resp):
                if "error" in obj:
                    self._raise_api_error(resp.status, obj)
                for choice in obj.get("choices", ()):
                    if choice.get("text"):
                        yield choice["text"]
        finally:
            conn.close()

    def chat(self, messages: List[dict],
             stop: Optional[List[str]] = None) -> str:
        """One ``POST /v1/chat/completions`` turn → assistant text."""
        body = {"model": self.model, "messages": messages,
                "max_tokens": self.max_tokens}
        stops = stop if stop is not None else self.stop
        if stops:
            body["stop"] = stops
        conn, resp = self._request("POST", "/v1/chat/completions", body)
        try:
            parsed = json.loads(resp.read().decode())
            if resp.status != 200:
                self._raise_api_error(resp.status, parsed)
            msg = parsed["choices"][0].get("message", {})
            return msg.get("content", "")
        finally:
            conn.close()


class BigdlTpuEmbeddings:
    """bigdl-llm's embeddings wrapper: the mean over the sequence of the
    head's output (``lm_head`` dropped, so the embedding-tied logits
    h @ E^T), in f32, as the JAX package computes it."""

    def __init__(self, model, tokenizer=None):
        self.model = model
        self.tokenizer = tokenizer

    def _encode(self, text: str) -> np.ndarray:
        return _encode(self.tokenizer, text)

    def embed_query(self, text: str) -> List[float]:
        from bigdl_tpu_torch.llm.models.llama import (as_tokens, forward,
                                                      init_cache)

        dev = self.model.device
        ids = as_tokens(self._encode(text), dev)
        cfg = self.model.config
        cache = init_cache(cfg, 1, ids.shape[1], device=dev)
        pos = torch.arange(ids.shape[1], dtype=torch.int32,
                           device=dev)[None, :]
        # logits are a poor embedding; pool the pre-head hidden state by
        # re-running forward without lm_head
        params = dict(self.model.params)
        params.pop("lm_head", None)
        with torch.no_grad():
            logits, _ = forward(params, cfg, ids, cache, pos)
        # tied-embedding logits = h @ E^T; mean-pool over sequence
        emb = logits.to(torch.float32).mean(dim=1)[0].cpu().numpy()
        return [float(v) for v in emb]

    def embed_documents(self, texts: List[str]) -> List[List[float]]:
        return [self.embed_query(t) for t in texts]
