"""The checkpoint format — the port of ``bigdl_tpu/utils/checkpoint.py``
(ref: ``S:dllib/utils/serializer/``), the same bytes on disk:

``<path>/``
  ``manifest.json``        format name + version + tree structure + user
                           metadata + each file's SHA-256 and size
  ``arrays.safetensors``   every array leaf under a flat key (the
                           ``_flatten`` keys: dotted tree paths)

The card's machine has no ``safetensors`` package, so
:func:`write_safetensors` writes the format itself: an 8-byte
little-endian header length, the JSON header (each tensor's ``dtype``,
``shape`` and ``data_offsets``, padded with spaces to a multiple of 8)
and the raw little-endian data, tensors back to back in key order.
:func:`read_safetensors` reads it back keeping each dtype (bf16
included). A checkpoint this module writes loads in the JAX package
(``safetensors.numpy``), and one the JAX package writes loads here.

Writes are atomic: everything lands in a ``<path>.tmp-*`` sibling, every
file is fsynced and one ``os.rename`` publishes the directory.
:func:`load_checkpoint` checks the per-file SHA-256 and raises
:class:`CheckpointCorruptError` on a mismatch; :func:`latest` skips (and
quarantines) incomplete or corrupt directories. Fault sites, through the
port's ``reliability``: ``checkpoint.write`` / ``.write.arrays``
(corrupt-capable) / ``.write.manifest`` / ``.commit`` /
``checkpoint.load``.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import struct
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from bigdl_tpu_torch import reliability

logger = logging.getLogger("bigdl_tpu_torch.checkpoint")

FORMAT_NAME = "bigdl_tpu.checkpoint"
FORMAT_VERSION = 1

_ARRAYS_FILE = "arrays.safetensors"
_MANIFEST_FILE = "manifest.json"
_TMP_MARK = ".tmp-"
_CORRUPT_MARK = ".corrupt-"

_ST_DTYPES = {torch.float64: "F64", torch.float32: "F32",
              torch.float16: "F16", torch.bfloat16: "BF16",
              torch.int64: "I64", torch.int32: "I32", torch.int16: "I16",
              torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL"}
_FROM_ST = {v: k for k, v in _ST_DTYPES.items()}


class CheckpointCorruptError(ValueError):
    """The checkpoint's bytes do not match its manifest checksums."""


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().contiguous()
    a = np.ascontiguousarray(np.asarray(leaf))
    if a.dtype.name == "bfloat16":      # ml_dtypes' bf16 (JAX trees)
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def write_safetensors(fname: str, tensors: Dict[str, Any]):
    """Write ``{name: tensor or numpy array}`` as one safetensors file."""
    header: Dict[str, Any] = {}
    blobs, offset = [], 0
    for name, leaf in tensors.items():
        t = _as_tensor(leaf)
        if t.dtype not in _ST_DTYPES:
            raise TypeError(f"{name}: dtype {t.dtype} is not written")
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() \
            if t.numel() else b""
        header[name] = {"dtype": _ST_DTYPES[t.dtype],
                        "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(fname, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def read_safetensors(fname: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one safetensors file, as CPU tensors in their
    stored dtype."""
    with open(fname, "rb") as f:
        data = f.read()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n])
    header.pop("__metadata__", None)
    base = 8 + n
    out = {}
    for name, info in header.items():
        begin, end = info["data_offsets"]
        dtype = _FROM_ST.get(info["dtype"])
        if dtype is None:
            raise NotImplementedError(
                f"{name}: safetensors dtype {info['dtype']} is not read")
        raw = bytearray(data[base + begin:base + end])
        t = torch.frombuffer(raw, dtype=torch.uint8) if raw else \
            torch.empty(0, dtype=torch.uint8)
        out[name] = t.view(dtype).reshape(info["shape"])
    return out


def _flatten(tree: Any, prefix: str, arrays: Dict[str, Any]) -> Any:
    """Tree -> JSON-able structure; array leaves move into ``arrays``."""
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return {"t": "py", "v": tree}
    if isinstance(tree, dict):
        return {"t": "dict",
                "items": {str(k): _flatten(v, f"{prefix}{k}.", arrays)
                          for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {"t": "list" if isinstance(tree, list) else "tuple",
                "items": [_flatten(v, f"{prefix}{i}.", arrays)
                          for i, v in enumerate(tree)]}
    key = prefix.rstrip(".") or "_root"
    if key in arrays:
        raise ValueError(f"duplicate checkpoint key {key!r}")
    arrays[key] = tree
    return {"t": "arr", "key": key}


def _unflatten(node: Any, arrays: Dict[str, torch.Tensor]) -> Any:
    t = node["t"]
    if t == "py":
        return node["v"]
    if t == "dict":
        return {k: _unflatten(v, arrays) for k, v in node["items"].items()}
    if t in ("list", "tuple"):
        seq = [_unflatten(v, arrays) for v in node["items"]]
        return seq if t == "list" else tuple(seq)
    if t == "arr":
        return arrays[node["key"]]
    raise ValueError(f"unknown node type {t!r} in checkpoint manifest")


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _fsync_file(path: str):
    with open(path, "rb") as f:
        os.fsync(f.fileno())


def _fsync_dir(path: str):
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _corrupt_file(path: str):
    """Flip one byte in the middle of ``path`` (the injected corruption:
    a torn write the checksums must catch)."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0xFF]) if b else b"\xff")


def save_checkpoint(path: str, tree: Any,
                    metadata: Optional[Dict[str, Any]] = None,
                    extra_files: Optional[Dict[str, bytes]] = None) -> str:
    """Persist a tree (dicts / lists / tuples / scalars / tensors / numpy
    arrays) to ``path``, atomically. Overwriting an existing directory
    moves it aside first, so the slot is only ever empty or whole."""
    reliability.inject("checkpoint.write")
    path = path.rstrip("/")
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = f"{path}{_TMP_MARK}{os.getpid()}-{uuid.uuid4().hex[:8]}"
    os.makedirs(tmp)
    try:
        arrays: Dict[str, Any] = {}
        structure = _flatten(tree, "", arrays)
        write_safetensors(os.path.join(tmp, _ARRAYS_FILE), arrays)
        # "corrupt" flips a byte after the checksums are taken (below)
        corrupt_arrays = \
            reliability.inject("checkpoint.write.arrays") == "corrupt"
        for name, blob in (extra_files or {}).items():
            with open(os.path.join(tmp, name), "wb") as f:
                f.write(blob)
        reliability.inject("checkpoint.write.manifest")
        files = {name: {"sha256": _sha256(os.path.join(tmp, name)),
                        "bytes": os.path.getsize(os.path.join(tmp, name))}
                 for name in os.listdir(tmp)}
        manifest = {"format": FORMAT_NAME, "version": FORMAT_VERSION,
                    "tree": structure, "metadata": metadata or {},
                    "files": files}
        with open(os.path.join(tmp, _MANIFEST_FILE), "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        for name in files:
            _fsync_file(os.path.join(tmp, name))
        _fsync_dir(tmp)
        if corrupt_arrays:
            _corrupt_file(os.path.join(tmp, _ARRAYS_FILE))
        reliability.inject("checkpoint.commit")
        if os.path.isdir(path):
            aside = f"{path}{_TMP_MARK}old-{uuid.uuid4().hex[:8]}"
            os.rename(path, aside)
            os.rename(tmp, path)
            shutil.rmtree(aside, ignore_errors=True)
        else:
            if os.path.isfile(path):
                os.remove(path)
            os.rename(tmp, path)
        _fsync_dir(parent)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def verify_checkpoint(path: str) -> bool:
    """True iff ``path`` is a complete checkpoint whose bytes match the
    manifest checksums (manifests without ``files`` verify on existence
    only)."""
    try:
        with open(os.path.join(path, _MANIFEST_FILE)) as f:
            manifest = json.load(f)
        if manifest.get("format") != FORMAT_NAME:
            return False
        if not os.path.exists(os.path.join(path, _ARRAYS_FILE)):
            return False
        for name, info in (manifest.get("files") or {}).items():
            fp = os.path.join(path, name)
            if not os.path.exists(fp):
                return False
            if info.get("sha256") and _sha256(fp) != info["sha256"]:
                return False
        return True
    except (OSError, ValueError):
        return False


def quarantine_checkpoint(path: str) -> Optional[str]:
    """Move a corrupt / incomplete checkpoint aside (``<path>.corrupt-N``)
    so no later scan picks it again; the new location, or None. A no-op
    while the reliability layer is disabled (``latest`` still skips the
    bad candidate)."""
    if not reliability.enabled():
        return None
    base = path.rstrip("/")
    for n in range(1000):
        target = f"{base}{_CORRUPT_MARK}{n}"
        if not os.path.exists(target):
            try:
                os.rename(base, target)
            except OSError:
                return None
            from bigdl_tpu_torch.reliability.policies import _count
            _count("bigdl_reliability_checkpoints_quarantined_total",
                   "Corrupt/incomplete checkpoints moved aside during "
                   "recovery scans")
            logger.warning("quarantined corrupt checkpoint %s -> %s",
                           base, target)
            return target
    return None


def _tag_sort_key(tag: str):
    try:
        return tuple(int(p) for p in tag.split("."))
    except ValueError:
        return (-1,)


def list_checkpoint_tags(root: str, prefix: str = "optim.") -> List[str]:
    """Tags of ``<prefix><tag>`` entries under ``root``, oldest first;
    ``.tmp-*`` orphans and ``.corrupt-*`` quarantine dirs are ignored."""
    if not os.path.isdir(root):
        return []
    tags = []
    for name in os.listdir(root):
        if not name.startswith(prefix) or _TMP_MARK in name \
                or _CORRUPT_MARK in name:
            continue
        tag = name[len(prefix):]
        if _tag_sort_key(tag) != (-1,):
            tags.append(tag)
    return sorted(tags, key=_tag_sort_key)


def latest(root: str, prefix: str = "optim.",
           paired_prefix: Optional[str] = None,
           quarantine: bool = True) -> Optional[str]:
    """Newest valid checkpoint tag under ``root``; incomplete or corrupt
    candidates are skipped (and quarantined). ``paired_prefix`` also
    requires a valid sibling (the optimizer's ``model.<tag>`` +
    ``optim.<tag>`` pair)."""
    for tag in reversed(list_checkpoint_tags(root, prefix)):
        members = [os.path.join(root, prefix + tag)]
        if paired_prefix is not None:
            members.append(os.path.join(root, paired_prefix + tag))
        bad = [m for m in members if not verify_checkpoint(m)]
        if not bad:
            return tag
        if quarantine:
            for m in bad:
                if os.path.isdir(m):
                    quarantine_checkpoint(m)
    return None


def prune_checkpoints(root: str, keep: int,
                      prefixes=("model.", "optim.")) -> List[str]:
    """Delete all but the newest ``keep`` tags (and ``.tmp-*`` orphans);
    ``keep <= 0`` keeps everything. Returns the pruned tags."""
    if keep <= 0:
        return []
    if os.path.isdir(root):
        for name in os.listdir(root):
            if _TMP_MARK in name:
                shutil.rmtree(os.path.join(root, name), ignore_errors=True)
    tags = sorted({t for p in prefixes
                   for t in list_checkpoint_tags(root, p)},
                  key=_tag_sort_key)
    doomed = tags[:-keep] if len(tags) > keep else []
    for tag in doomed:
        for p in prefixes:
            target = os.path.join(root, p + tag)
            if os.path.isdir(target):
                shutil.rmtree(target, ignore_errors=True)
    return doomed


def load_checkpoint(path: str, verify: bool = True
                    ) -> Tuple[Any, Dict[str, Any]]:
    """``(tree, metadata)`` saved by :func:`save_checkpoint` (either
    package's); array leaves are CPU tensors in their stored dtype.
    ``verify`` checks the manifest's SHA-256s first."""
    reliability.inject("checkpoint.load")
    with open(os.path.join(path, _MANIFEST_FILE)) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT_NAME:
        raise ValueError(f"{path} is not a {FORMAT_NAME} checkpoint")
    if manifest.get("version", 0) > FORMAT_VERSION:
        raise ValueError(
            f"checkpoint version {manifest['version']} is newer than this "
            f"build supports ({FORMAT_VERSION})")
    if verify:
        for name, info in (manifest.get("files") or {}).items():
            fp = os.path.join(path, name)
            if not os.path.exists(fp):
                raise CheckpointCorruptError(
                    f"{path}: manifest names {name} but it is missing")
            if info.get("sha256") and _sha256(fp) != info["sha256"]:
                raise CheckpointCorruptError(
                    f"{path}: {name} does not match its manifest sha256 "
                    "(torn or corrupted write)")
    arrays = read_safetensors(os.path.join(path, _ARRAYS_FILE))
    return _unflatten(manifest["tree"], arrays), manifest.get("metadata", {})
