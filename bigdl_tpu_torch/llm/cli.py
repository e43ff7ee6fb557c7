"""llm-cli / llm-chat — the port of ``bigdl_tpu/llm/cli.py`` (bigdl-llm's
main/chat wrappers, here around the port's ``generate``).

``python -m bigdl_tpu_torch.llm.cli -m <converted dir> -p "prompt" -n 32``
prints the completion on stdout and ``[N tokens in Xs — Y tok/s]`` on
stderr, in the JAX CLI's format. ``--device`` (default ``cuda``) is the
one flag the JAX CLI lacks: the port runs on the card unless asked for
the CPU. Without ``--tokenizer`` (a ``transformers`` tokenizer, loaded
lazily) the text goes through the byte-level fallback: UTF-8 bytes are
the token ids.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

from bigdl_tpu_torch.llm.api.templates import ByteTokenizer


def _load(args):
    from bigdl_tpu_torch.llm.convert_model import load_model

    model = load_model(args.model, max_cache_len=args.ctx_size,
                       device=args.device)
    tok = None
    if args.tokenizer:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(args.tokenizer)
    return model, tok


def _encode(tok, text: str):
    import numpy as np

    if tok is not None:
        return np.asarray([tok.encode(text)], np.int32)
    return np.asarray([ByteTokenizer().encode(text)], np.int32)


def _decode(tok, ids) -> str:
    if tok is not None:
        return tok.decode(list(ids), skip_special_tokens=True)
    return ByteTokenizer().decode(ids)


def _device_flag(ap):
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card)")


def main(argv: Optional[list] = None):
    """llm-cli -m <converted-model-dir> -p "prompt" -n 32"""
    ap = argparse.ArgumentParser("llm-cli")
    ap.add_argument("-m", "--model", required=True,
                    help="converted model dir (see convert_model)")
    ap.add_argument("-p", "--prompt", default="Once upon a time")
    ap.add_argument("-n", "--n_predict", type=int, default=32)
    ap.add_argument("-t", "--threads", type=int, default=0)  # parity no-op
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top_k", type=int, default=40)
    ap.add_argument("--ctx_size", type=int, default=512)
    ap.add_argument("--tokenizer", default=None)
    _device_flag(ap)
    args = ap.parse_args(argv)

    model, tok = _load(args)
    ids = _encode(tok, args.prompt)
    t0 = time.perf_counter()
    out = model.generate(ids, max_new_tokens=args.n_predict,
                         do_sample=args.temperature > 0,
                         temperature=max(args.temperature, 1e-6),
                         top_k=args.top_k)
    dt = time.perf_counter() - t0
    new = out[0, ids.shape[1]:]
    print(_decode(tok, new))
    print(f"[{len(new)} tokens in {dt:.2f}s — "
          f"{len(new) / dt:.2f} tok/s]", file=sys.stderr)
    return 0


def chat(argv: Optional[list] = None):
    """llm-chat: REPL over the same flags."""
    ap = argparse.ArgumentParser("llm-chat")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-n", "--n_predict", type=int, default=64)
    ap.add_argument("--ctx_size", type=int, default=512)
    ap.add_argument("--tokenizer", default=None)
    _device_flag(ap)
    args = ap.parse_args(argv)
    model, tok = _load(args)
    print("llm-chat ready — empty line exits")
    while True:
        try:
            line = input("> ")
        except EOFError:
            break
        if not line.strip():
            break
        ids = _encode(tok, line)
        out = model.generate(ids, max_new_tokens=args.n_predict)
        print(_decode(tok, out[0, ids.shape[1]:]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
