"""Safetensors checkpoint reader — the port of
``bigdl_tpu/llm/transformers/st_reader.py``, without the ``safetensors``
package (the card's machine has none).

The format: an 8-byte little-endian header length ``n``, ``n`` bytes of
JSON mapping each tensor name to ``{"dtype", "shape", "data_offsets":
[begin, end]}`` (plus an optional ``"__metadata__"``), then the raw
little-endian data, offsets counted from the end of the header. Each
file is mapped with ``numpy.memmap`` and a tensor is read by viewing its
byte range; BF16 is widened to f32 by shifting its 16 bits into the top
half of a 32-bit word, which is exact.

The reader maps tensor name → file for a single ``.safetensors`` file, a
glob, a directory of files or a sharded ``model.safetensors.index.json``,
tolerates an optional name prefix (``transformer.`` on bloom /
gpt_bigcode checkpoints) and returns f32 numpy arrays, as the JAX
package's reader does.
"""

from __future__ import annotations

import glob
import json
import os
import struct
from typing import Dict, Tuple

import numpy as np

_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8",
           "I32": "<i4", "I16": "<i2", "I8": "i1", "U64": "<u8",
           "U32": "<u4", "U16": "<u2", "U8": "u1", "BOOL": "?"}


def read_header(fname: str) -> Tuple[Dict[str, dict], int]:
    """``(tensor entries, offset of the data section)`` of one file."""
    with open(fname, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{fname}: not a safetensors file")
        (n,) = struct.unpack("<Q", head)
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def _files(path: str):
    if os.path.isfile(path):
        return [path]
    if os.path.isdir(path):
        return sorted(glob.glob(os.path.join(path, "*.safetensors")))
    return sorted(glob.glob(path))


class SafetensorsReader:
    def __init__(self, path: str, prefix_fallbacks: tuple = ("",
                                                             "transformer.")):
        self._path = path
        self._prefixes = prefix_fallbacks
        self._headers: Dict[str, Tuple[Dict[str, dict], int]] = {}
        self._maps: Dict[str, np.memmap] = {}
        index = os.path.join(path, "model.safetensors.index.json")
        if os.path.isdir(path) and os.path.exists(index):
            with open(index) as f:
                weight_map = json.load(f)["weight_map"]
            self.key_map = {k: os.path.join(path, v)
                            for k, v in weight_map.items()}
        else:
            self.key_map = {}
            for fname in _files(path):
                for k in self._header(fname)[0]:
                    self.key_map[k] = fname
        if not self.key_map:
            raise FileNotFoundError(f"no safetensors tensors under {path}")

    def _header(self, fname: str):
        if fname not in self._headers:
            self._headers[fname] = read_header(fname)
        return self._headers[fname]

    def resolve(self, name: str):
        for p in self._prefixes:
            if p + name in self.key_map:
                return p + name
        return None

    def __contains__(self, name: str) -> bool:
        return self.resolve(name) is not None

    def get(self, name: str) -> np.ndarray:
        """fp32 numpy tensor (an owned copy) by (possibly prefix-less) HF
        name."""
        resolved = self.resolve(name)
        if resolved is None:
            raise KeyError(name)
        fname = self.key_map[resolved]
        header, data = self._header(fname)
        info = header[resolved]
        begin, end = info["data_offsets"]
        if fname not in self._maps:
            self._maps[fname] = np.memmap(fname, dtype=np.uint8, mode="r")
        raw = self._maps[fname][data + begin:data + end]
        if info["dtype"] == "BF16":
            bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
            a = bits.view(np.float32)
        elif info["dtype"] in _DTYPES:
            a = np.frombuffer(raw, dtype=_DTYPES[info["dtype"]]).astype(
                np.float32)
        else:
            raise NotImplementedError(
                f"{resolved}: safetensors dtype {info['dtype']} is not read")
        return a.reshape(info["shape"])

    def close(self):
        self._maps.clear()

    def __enter__(self) -> "SafetensorsReader":
        return self

    def __exit__(self, *exc):
        self.close()
