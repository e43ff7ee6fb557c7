"""Module surgery: replace ``nn.Linear`` with :class:`LowBitLinear` — the
port of ``bigdl_tpu/llm/transformers/convert.py`` (ref:
P:llm/transformers/convert.py — ``ggml_convert_low_bit`` +
``optimize_model``)."""

from __future__ import annotations

from typing import Optional, Sequence

from bigdl_tpu_torch.llm.ggml.quantize import CAST_QTYPES, QK
from bigdl_tpu_torch.llm.transformers.low_bit_linear import LowBitLinear
from bigdl_tpu_torch.nn.layers.linear import Linear
from bigdl_tpu_torch.nn.module import Module


def ggml_convert_low_bit(model: Module, qtype: str = "sym_int4",
                         modules_to_not_convert:
                         Optional[Sequence[str]] = None) -> Module:
    """Recursively swap every ``nn.Linear`` for a quantized LowBitLinear,
    in place; each weight is quantized on its own device.

    ``modules_to_not_convert``: keys or module names to skip (the
    reference skips ``lm_head`` for quality). For the block formats a
    Linear whose in_features is not a multiple of 32 stays float (the
    reference keeps such layers fp too); ``bf16`` and ``fp8`` have no
    block shape and convert every Linear."""
    skip = set(modules_to_not_convert or ())

    def walk(mod: Module):
        for key, child in list(mod._modules.items()):
            if isinstance(child, Linear):
                if child.name in skip or key in skip or (
                        qtype not in CAST_QTYPES
                        and child.input_size % QK != 0):
                    continue
                mod._modules[key] = LowBitLinear.from_linear(child, qtype)
            else:
                walk(child)

    walk(model)
    return model


def optimize_model(model: Module, low_bit: str = "sym_int4",
                   **kwargs) -> Module:
    """Public entry (ref: bigdl.llm.optimize_model) — quantize an
    arbitrary model built on the port's nn, on the model's device."""
    return ggml_convert_low_bit(model, low_bit, **kwargs)
