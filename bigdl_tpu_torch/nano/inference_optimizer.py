"""InferenceOptimizer — the port of ``quantize``, ``trace`` and the
``_CompiledModel`` wrapper in ``bigdl_tpu/nano/inference_optimizer.py``
(ref: P:nano/pytorch/inference/optimizer.py).

A pipeline holds its module on a device in eval mode and runs it under
``torch.inference_mode()``; ``forward`` takes numpy (or tensors, or a
tuple / Table of them) and returns numpy, as the JAX wrapper does. Every
entry takes ``device=None``, which means the GPU. ``optimize`` (the
trial table), ``save`` and ``load`` are still to port (ROADMAP Queue 1
item 11).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from bigdl_tpu_torch.device import resolve_device
from bigdl_tpu_torch.utils.table import Table

_FLOAT_DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16,
                 "float16": torch.float16}


def _to_device(x, device):
    if isinstance(x, Table):
        return Table(**{k: _to_device(v, device) for k, v in x.items()})
    if isinstance(x, (tuple, list)):
        return type(x)(_to_device(v, device) for v in x)
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device)


def _to_numpy(y):
    if isinstance(y, Table):
        return Table(**{k: _to_numpy(v) for k, v in y.items()})
    return y.float().cpu().numpy() if y.dtype == torch.bfloat16 \
        else y.cpu().numpy()


class _CompiledModel:
    """A module on ``device`` in eval mode, optionally with its float
    params cast to ``dtype``, behind the Module API bit users touch
    (``forward`` / ``__call__``)."""

    def __init__(self, model, device=None, dtype=None):
        self.device = resolve_device(device)
        self._model = model.to(self.device).eval()
        self._dtype = dtype
        if dtype is not None:
            for p in self._model.parameters():
                if p.dtype in (torch.float32, torch.float64):
                    p.data = p.data.to(dtype)

    def forward(self, x):
        with torch.inference_mode():
            return _to_numpy(self._model(_to_device(x, self.device)))

    __call__ = forward


class InferenceOptimizer:
    @staticmethod
    def quantize(model, precision: str = "bf16", calib_data=None,
                 device=None, **kwargs) -> _CompiledModel:
        """precision: bf16 | fp16 | int8 | int4 | any ggml qtype
        (sym_int4 / asym_int4 / sym_int5 / sym_int8 / nf4 / fp4 / fp8).
        The low-bit ones run the LowBitLinear surgery on a copy of the
        model moved to ``device`` (weights quantized there); bf16/fp16
        cast a copy's float params."""
        model = getattr(model, "module", model)   # keras-style wrappers
        if precision in _FLOAT_DTYPES:
            return _CompiledModel(copy.deepcopy(model), device,
                                  _FLOAT_DTYPES[precision])
        qtype = {"int8": "sym_int8", "int4": "sym_int4"}.get(
            precision, precision)
        from bigdl_tpu_torch.llm.transformers.convert import \
            ggml_convert_low_bit
        dev = resolve_device(device)
        qmodel = ggml_convert_low_bit(copy.deepcopy(model).to(dev), qtype)
        return _CompiledModel(qmodel, dev)

    @staticmethod
    def trace(model, accelerator: str = "jit", input_sample=None,
              device=None, **kwargs) -> _CompiledModel:
        """ref: trace(accelerator=jit/onnxruntime/openvino) — here the
        module itself, eager, moved to ``device``; ``input_sample`` runs
        one warm-up forward."""
        model = getattr(model, "module", model)
        compiled = _CompiledModel(model, device)
        if input_sample is not None:
            compiled.forward(input_sample)
        return compiled

    @staticmethod
    def _quantize_convs(model, device=None) -> _CompiledModel:
        """INT8 weight-only surgery (``nn.quantized.quantize_model``) on a
        copy of the model moved to ``device``."""
        from bigdl_tpu_torch.nn.quantized import quantize_model
        dev = resolve_device(device)
        return _CompiledModel(quantize_model(copy.deepcopy(model).to(dev)),
                              dev)
