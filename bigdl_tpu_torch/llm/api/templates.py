"""Tokenizer protocol + per-family chat templates — the port of
``bigdl_tpu/llm/api/templates.py``.

The environment ships **no tokenizer assets** (``worker.py``: the
native surface is token-array in, token-array out, tokenization happens
client-side). The gateway therefore speaks token arrays natively —
``"prompt": [1, 2, 3]`` needs nothing — and treats *text* as an
optional capability behind a pluggable protocol:

- ``encode(text) -> List[int]`` and ``decode(ids) -> str``;
- any object with those two methods plugs in via the ``tokenizer=``
  ctor arg, or ``bigdl.llm.api.tokenizer=byte`` selects the
  deterministic :class:`ByteTokenizer` below (the test implementation:
  UTF-8 bytes as token ids, reversible, no assets).

Chat requests always go through a template: ``messages`` →
prompt text via the model family's conversation format, then the
tokenizer. The family formats mirror bigdl-llm's fastchat-style
per-family conversation templates (llama ``[INST]``, chatglm
``问/答``-free plain rounds, and a generic ``### Human/Assistant``
fallback) — deterministic string builders, not learned assets.
"""

from __future__ import annotations

from typing import List, Sequence

from bigdl_tpu_torch.llm.api.errors import InvalidRequestError


class ByteTokenizer:
    """Deterministic, asset-free tokenizer: UTF-8 bytes are the token
    ids (0..255) — the langchain integration's fallback encoder,
    reversible, so text responses and ``stop`` strings work end to end
    without tokenizer files."""

    vocab_size = 256

    def encode(self, text: str) -> List[int]:
        return [b for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(int(t) & 0xFF for t in ids).decode(
            "utf-8", errors="replace")


def build_tokenizer(name: str):
    """Resolve the ``bigdl.llm.api.tokenizer`` knob: ``""`` (default)
    means token-array-only — text prompts answer
    ``invalid_request_error`` — and ``"byte"`` is the deterministic
    test implementation. Anything else is a configuration error."""
    if not name:
        return None
    if name == "byte":
        return ByteTokenizer()
    raise ValueError(f"unknown bigdl.llm.api.tokenizer {name!r} "
                     "(expected '' or 'byte')")


#: role -> prefix line, per model family. Formats are intentionally
#: minimal and deterministic; the gateway's job is a faithful
#: ``messages`` -> prompt flattening, not prompt engineering.
CHAT_FAMILIES = ("plain", "llama", "chatglm")


def apply_chat_template(family: str, messages: List[dict]) -> str:
    """Flatten an OpenAI ``messages`` list into one prompt string using
    the family's conversation format. Validates shape: every message
    needs a known ``role`` and a string ``content``."""
    if family not in CHAT_FAMILIES:
        raise InvalidRequestError(
            f"unknown chat template family {family!r} "
            f"(expected one of {CHAT_FAMILIES})", param="model")
    if not isinstance(messages, list) or not messages:
        raise InvalidRequestError("messages must be a non-empty list",
                                  param="messages")
    system = []
    rounds = []   # (role, content) with role in user/assistant
    for i, msg in enumerate(messages):
        if not isinstance(msg, dict):
            raise InvalidRequestError(
                f"messages[{i}] must be an object", param="messages")
        role = msg.get("role")
        content = msg.get("content")
        if role not in ("system", "user", "assistant"):
            raise InvalidRequestError(
                f"messages[{i}].role must be system|user|assistant, "
                f"got {role!r}", param="messages")
        if not isinstance(content, str):
            raise InvalidRequestError(
                f"messages[{i}].content must be a string",
                param="messages")
        if role == "system":
            system.append(content)
        else:
            rounds.append((role, content))
    if not rounds or rounds[-1][0] != "user":
        raise InvalidRequestError(
            "the last non-system message must be from the user",
            param="messages")
    sys_text = "\n".join(system)
    if family == "llama":
        # [INST] <<SYS>> ... <</SYS>> user [/INST] answer ...
        parts = []
        first = True
        for role, content in rounds:
            if role == "user":
                block = content
                if first and sys_text:
                    block = f"<<SYS>>\n{sys_text}\n<</SYS>>\n\n{content}"
                parts.append(f"[INST] {block} [/INST]")
                first = False
            else:
                parts.append(f" {content} ")
        return "".join(parts)
    if family == "chatglm":
        parts = [sys_text] if sys_text else []
        turn = 0
        for role, content in rounds:
            if role == "user":
                parts.append(f"[Round {turn}]\n问：{content}")
                turn += 1
            else:
                parts.append(f"答：{content}")
        parts.append("答：")
        return "\n".join(parts)
    # plain: ### Human / ### Assistant rounds (the fastchat default)
    parts = [sys_text] if sys_text else []
    for role, content in rounds:
        tag = "### Human" if role == "user" else "### Assistant"
        parts.append(f"{tag}: {content}")
    parts.append("### Assistant:")
    return "\n".join(parts)
