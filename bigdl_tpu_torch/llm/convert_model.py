"""Checkpoint conversion — the port of ``bigdl_tpu/llm/convert_model.py``
(bigdl-llm's ``convert_model``: an HF checkpoint to a ready-to-load
directory on disk).

The on-disk format is the JAX package's, so a directory written by
either package loads in the other: ``<out>/config.json`` (the
``LlamaConfig`` fields) + ``<out>/weights.npz`` (uncompressed), one
array per leaf of ``model.params`` under its dotted key path — the
fused ``qkv_proj`` / ``gate_up_proj`` q4_0 planes and scales stacked
per layer exactly as the runtime consumes them, so a load is an npz
read and a copy to the device, with no requantization.

Its quirks are the JAX package's: bf16 leaves are widened to f32 on
save (npz has no bf16), and on load **every** f32 leaf is narrowed to
bf16 — lossless for the widened bf16 leaves, a round to bf16 for the
q4_0 scales (f32 on save). The port's kernels take f32 scales (the JAX
``int4_matmul`` casts them to f32 at the same point), so a quantized
linear's narrowed ``scale`` comes back as f32 holding the bf16 value:
the numbers the JAX package computes with, bit for bit.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict

import numpy as np
import torch

from bigdl_tpu_torch.device import resolve_device
from bigdl_tpu_torch.llm.convert import params_from_numpy


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        elif isinstance(v, torch.Tensor):
            if v.dtype == torch.bfloat16:
                # npz has no bf16; f32 widening is lossless and the
                # loader narrows back to bf16
                v = v.to(torch.float32)
            out[key] = v.detach().cpu().numpy()
        else:
            out[key] = np.asarray(v)       # a "qtype" string leaf
    return out


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        parts = key.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_model(model, out_dir: str):
    """Persist a (quantized or dense) ``LlamaForCausalLM`` to disk."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(model.config), f, indent=2)
    np.savez(os.path.join(out_dir, "weights.npz"),
             **_flatten(model.params))
    return out_dir


def as_stored(params: Dict[str, Any]) -> Dict[str, Any]:
    """``params`` as a save / load round trip gives them back: every f32
    tensor rounded to bf16 (the JAX loader's rule), a quantized linear's
    scales (a dict with ``q``) then widened to f32 again for the
    kernels. Other leaves are returned as they are."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = as_stored(v)
        elif isinstance(v, torch.Tensor) and v.dtype == torch.float32:
            n = v.to(torch.bfloat16)
            out[k] = n.to(torch.float32) if "q" in params else n
        else:
            out[k] = v
    return out


def load_model(model_dir: str, max_cache_len: int = 512, device=None):
    """Load a converted model directory onto ``device`` (``None`` = the
    GPU, raising without one)."""
    from bigdl_tpu_torch.llm.models.llama import LlamaConfig, LlamaForCausalLM

    dev = resolve_device(device)
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = LlamaConfig(**json.load(f))
    with np.load(os.path.join(model_dir, "weights.npz")) as z:
        flat = {k: z[k] for k in z.files}
    params = as_stored(params_from_numpy(_unflatten(flat), dev))
    return LlamaForCausalLM(cfg, params, max_cache_len=max_cache_len,
                            device=dev)


def convert_model(input_path, output_path: str,
                  model_family: str = "llama",
                  dtype: str = "int4",
                  max_cache_len: int = 512, device=None) -> str:
    """bigdl-llm's ``convert_model(input_path, output_path, model_family,
    dtype)``. ``input_path`` may be a directory of safetensors weights or
    a ``LlamaConfig`` (random weights, for tests); dtype ``int4`` →
    ``sym_int4``, ``int8`` → ``sym_int8``. The model is built on
    ``device`` (``None`` = the GPU)."""
    if model_family != "llama":
        raise NotImplementedError(
            f"model_family {model_family!r}: llama is the implemented "
            "family; gptneox/bloom/starcoder route through the same "
            "convert once their blocks land")
    from bigdl_tpu_torch.llm.transformers.model import AutoModelForCausalLM

    qtype = {"int4": "sym_int4", "int8": "sym_int8"}.get(dtype, dtype)
    model = AutoModelForCausalLM.from_pretrained(
        input_path, load_in_low_bit=qtype, max_cache_len=max_cache_len,
        device=device)
    return save_model(model, output_path)
