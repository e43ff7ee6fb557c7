"""Legacy checkpoint importers — the port of ``bigdl_tpu/utils/importers.py``
(ref: ``S:dllib/utils/serializer``, ``S:dllib/utils/tf`` and
``CaffeLoader``: BigDL loads Caffe, TF and Torch checkpoints into its own
modules).

- :func:`load_torch_state_dict` — torch ``.pt`` / ``.pth`` state dicts
  (``weights_only=True``: no pickled code runs) into a module tree;
- :func:`load_tf_checkpoint` — TF2 checkpoint variables; ``tensorflow``
  is imported when called, and where it is absent the call raises an
  ``ImportError`` that names it;
- :class:`CaffeLoader` — ``.caffemodel`` layer blobs, read by this
  module's own protobuf **wire-format** parser (no caffe or protobuf
  schema): NetParameter's repeated LayerParameter (field 100; V1
  ``layers``, field 2, also), each with its name and BlobProto blobs
  (shape, legacy num..width, packed float data).

All three assign into the port's module tree as the JAX ``_assign``
does: an explicit ``mapping`` {our_param_path: their_name} wins (every
mapped name reserved first), the rest match positionally by shape in
the tree's order, and ``transpose_linear`` lets a 2-D array fit its
transpose (TF kernels are (in, out)).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# shared: assign a flat {name: array} set into a Module tree
# ---------------------------------------------------------------------------

def _flatten_params(tree, prefix=""):
    out = []
    if isinstance(tree, dict):
        for k in tree:
            out += _flatten_params(tree[k], f"{prefix}{k}.")
    else:
        out.append((prefix[:-1], tree))
    return out


def _assign(model, foreign: Dict[str, np.ndarray],
            mapping: Optional[Dict[str, str]] = None,
            transpose_linear: bool = False) -> int:
    """Write foreign arrays into ``model``'s params (each lands in its
    param's dtype, on its device). Returns how many were assigned."""
    params = model.parameters_dict()
    used = set(mapping.values()) if mapping else set()
    n = 0

    def fit(ours_shape, arr):
        if tuple(arr.shape) == tuple(ours_shape):
            return arr
        if transpose_linear and arr.ndim == 2 \
                and tuple(arr.T.shape) == tuple(ours_shape):
            return arr.T
        return None

    def write(path, leaf, src):
        node = params
        parts = path.split(".")
        for p in parts[:-1]:
            node = node[p]
        node[parts[-1]] = torch.from_numpy(
            np.array(src, dtype=np.float32)).to(leaf.dtype)

    for path, leaf in _flatten_params(params):
        src = None
        if mapping and path in mapping:
            cand = foreign.get(mapping[path])
            if cand is None:
                raise KeyError(f"mapping {path} -> {mapping[path]}: "
                               "no such tensor in the checkpoint")
            src = fit(leaf.shape, cand)
            if src is None:
                raise ValueError(
                    f"{mapping[path]} shape {cand.shape} does not fit "
                    f"{path} {tuple(leaf.shape)}")
        else:
            for name, arr in foreign.items():
                if name in used:
                    continue
                src = fit(leaf.shape, arr)
                if src is not None:
                    used.add(name)
                    break
        if src is not None:
            write(path, leaf, src)
            n += 1
    model.load_parameters_dict(params)
    return n


# ---------------------------------------------------------------------------
# torch / tf
# ---------------------------------------------------------------------------

def load_torch_state_dict(model, src,
                          mapping: Optional[Dict[str, str]] = None,
                          transpose_linear: bool = False) -> int:
    """Load a torch checkpoint path / state_dict into ``model``."""
    if isinstance(src, (str, bytes)):
        sd = torch.load(src, map_location="cpu", weights_only=True)
    else:
        sd = src
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    arrays = {k: (v.detach().cpu().float().numpy()
                  if isinstance(v, torch.Tensor) else np.asarray(v))
              for k, v in sd.items()}
    return _assign(model, arrays, mapping, transpose_linear)


def load_tf_checkpoint(model, path: str,
                       mapping: Optional[Dict[str, str]] = None,
                       transpose_linear: bool = True) -> int:
    """Load TF2 checkpoint variables into ``model`` (TF kernels are
    (in, out) — transposed into our (out, in) linears by default)."""
    try:
        import tensorflow as tf
    except ImportError as e:
        raise ImportError(
            "load_tf_checkpoint needs the 'tensorflow' package to read a "
            f"TF checkpoint, and it is not installed ({e})") from e
    reader = tf.train.load_checkpoint(path)
    arrays = {}
    for name in reader.get_variable_to_shape_map():
        if ".OPTIMIZER_SLOT" in name or name.startswith("_CHECKPOINT"):
            continue
        arrays[name] = np.asarray(reader.get_tensor(name))
    return _assign(model, arrays, mapping, transpose_linear)


# ---------------------------------------------------------------------------
# caffe (hand-rolled protobuf wire parser — no caffe dependency)
# ---------------------------------------------------------------------------

def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _fields(buf: memoryview):
    """Yield (field_number, wire_type, value) over one message."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:                       # varint
            val, pos = _read_varint(buf, pos)
        elif wt == 1:                     # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        elif wt == 2:                     # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:                     # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


def _parse_blob(buf: memoryview) -> np.ndarray:
    shape: List[int] = []
    legacy = {}
    data = b""
    for field, wt, val in _fields(buf):
        if field == 7 and wt == 2:        # BlobShape { repeated int64 dim }
            dims = []
            for f2, w2, v2 in _fields(val):
                if f2 == 1 and w2 == 0:
                    dims.append(v2)
                elif f2 == 1 and w2 == 2:  # packed
                    p = 0
                    while p < len(v2):
                        d, p = _read_varint(v2, p)
                        dims.append(d)
            shape = dims
        elif field == 5 and wt in (2, 5):  # packed / unpacked float data
            data += bytes(val)
        elif field in (1, 2, 3, 4) and wt == 0:   # legacy num/ch/h/w
            legacy[field] = val
    arr = np.frombuffer(data, np.float32).copy()
    if not shape and legacy:
        shape = [legacy.get(i, 1) for i in (1, 2, 3, 4)]
    if shape and int(np.prod(shape)) == arr.size:
        arr = arr.reshape(shape)
    return arr


class CaffeLoader:
    """Read ``.caffemodel`` layer blobs (ref: CaffeLoader.scala).

    ``load(path)`` → {layer_name: [blob arrays]} (blob 0 = weights,
    blob 1 = bias, Caffe convention); ``load_into(model, path, mapping)``
    assigns them into a module tree.
    """

    @staticmethod
    def load(path: str) -> Dict[str, List[np.ndarray]]:
        with open(path, "rb") as f:
            buf = memoryview(f.read())
        layers: Dict[str, List[np.ndarray]] = {}
        for field, wt, val in _fields(buf):
            # V2 LayerParameter (NetParameter field 100): name = 1, blobs
            # = 7 (field 6 is repeated ParamSpec); V1LayerParameter
            # (field 2): name = 4, blobs = 6
            if field in (100, 2) and wt == 2:
                blob_field = 7 if field == 100 else 6
                name_field = 1 if field == 100 else 4
                name = f"layer{len(layers)}"
                blobs: List[np.ndarray] = []
                for f2, w2, v2 in _fields(val):
                    if f2 == name_field and w2 == 2:
                        name = bytes(v2).decode("utf-8", "replace")
                    elif f2 == blob_field and w2 == 2:
                        try:
                            b = _parse_blob(v2)
                        except Exception:   # not a blob (e.g. top name)
                            continue
                        if b.size:
                            blobs.append(b)
                if blobs:
                    layers[name] = blobs
        return layers

    @staticmethod
    def load_into(model, path: str,
                  mapping: Optional[Dict[str, str]] = None) -> int:
        layers = CaffeLoader.load(path)
        arrays: Dict[str, np.ndarray] = {}
        for lname, blobs in layers.items():
            for i, b in enumerate(blobs):
                suffix = {0: "weight", 1: "bias"}.get(i, str(i))
                arrays[f"{lname}.{suffix}"] = b
        return _assign(model, arrays, mapping)


__all__ = ["CaffeLoader", "load_tf_checkpoint", "load_torch_state_dict"]
