"""KV-chain handoff blobs — the port of ``bigdl_tpu/llm/kvtier/handoff.py``.

A worker that computed a prompt's KV ships the FULL pages of that chain
to another worker as one self-describing binary blob; the receiver lands
the pages in its host arena, and its next admission of the prompt
fetches them like any host-tier hit.

Wire format (version 1), byte for byte the JAX package's, so a blob
written by either package reads in the other::

    magic  b"BDKV1\\n"
    header u32 length (little endian) + UTF-8 JSON {tokens, page_size,
                                                   pages, shape, dtype}
    body   pages x (k_page ‖ v_page) raw bytes, C order

``dtype`` is the JAX package's name of the pool dtype (``"bfloat16"``,
``"float32"``, ``"float16"``): torch's own name without its ``torch.``
prefix. Pages are torch CPU tensors of the per-page layout ``(L, Hkv,
page, D)``, ``pool[:, pid]`` of an engine's ``(L, P, Hkv, page, D)``
pool; bf16 is read and written through torch, which needs no numpy
extension type.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, List, Tuple

import torch

MAGIC = b"BDKV1\n"


class HandoffError(ValueError):
    """Malformed or incompatible handoff blob."""


def dtype_name(dtype: torch.dtype) -> str:
    """The blob header's name of a torch dtype (numpy's and JAX's)."""
    return str(dtype).removeprefix("torch.")


def _resolve_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise HandoffError(f"unknown page dtype {name!r}")
    return dt


def serialize_chain(tokens, k_pages: List[torch.Tensor],
                    v_pages: List[torch.Tensor], page_size: int) -> bytes:
    """Pack ``len(k_pages)`` full pages covering ``tokens`` (page ``j``
    holds tokens ``[j*page, (j+1)*page)``) into a handoff blob.
    ``k_pages[j]`` / ``v_pages[j]`` are CPU tensors of one shape and
    dtype."""
    if len(k_pages) != len(v_pages):
        raise HandoffError("k/v page count mismatch")
    if len(tokens) < len(k_pages) * page_size:
        raise HandoffError("fewer tokens than the pages cover")
    header = {
        "tokens": [int(t) for t in tokens[:len(k_pages) * page_size]],
        "page_size": int(page_size),
        "pages": len(k_pages),
        "shape": [],
        "dtype": "",
    }
    body = []
    for k, v in zip(k_pages, v_pages):
        if not header["dtype"]:
            header["shape"] = list(k.shape)
            header["dtype"] = dtype_name(k.dtype)
        if list(k.shape) != header["shape"] or \
                list(v.shape) != header["shape"] or \
                dtype_name(k.dtype) != header["dtype"] or \
                dtype_name(v.dtype) != header["dtype"]:
            raise HandoffError("inconsistent page shapes in chain")
        body += [t.detach().cpu().contiguous().view(-1).view(
            torch.uint8).numpy() for t in (k, v)]
    hdr = json.dumps(header).encode()
    return b"".join([MAGIC, struct.pack("<I", len(hdr)), hdr] + body)


def deserialize_chain(blob: bytes) -> Tuple[List[int], List[torch.Tensor],
                                            List[torch.Tensor], Dict]:
    """Unpack a blob into ``(tokens, k_pages, v_pages, header)``; the pages
    are CPU tensors (views of one copy of the body). The importer checks
    ``page_size`` / ``shape`` / ``dtype`` against its own pool before
    landing anything."""
    if not blob.startswith(MAGIC):
        raise HandoffError("not a KV handoff blob (bad magic)")
    off = len(MAGIC)
    if len(blob) < off + 4:
        raise HandoffError("truncated handoff header")
    (hlen,) = struct.unpack_from("<I", blob, off)
    off += 4
    try:
        header = json.loads(blob[off:off + hlen].decode())
    except Exception as e:
        raise HandoffError(f"unreadable handoff header: {e}") from None
    off += hlen
    if not int(header["pages"]):
        # a fully evicted chain exports as an empty blob: the importer
        # has nothing to land and the receiver prefills again
        return list(map(int, header["tokens"])), [], [], header
    shape = tuple(header["shape"])
    dtype = _resolve_dtype(header["dtype"])
    itemsize = torch.empty((), dtype=dtype).element_size()
    per = itemsize
    for s in shape:
        per *= int(s)
    n = int(header["pages"])
    if len(blob) - off != 2 * per * n:
        raise HandoffError(
            f"handoff body holds {len(blob) - off} bytes, expected "
            f"{2 * per * n} for {n} pages of {shape} {header['dtype']}")
    body = torch.frombuffer(bytearray(memoryview(blob)[off:]),
                            dtype=torch.uint8)
    pages = body.view(dtype).view((n, 2) + shape)
    return (list(map(int, header["tokens"])), [pages[j, 0] for j in range(n)],
            [pages[j, 1] for j in range(n)], header)
