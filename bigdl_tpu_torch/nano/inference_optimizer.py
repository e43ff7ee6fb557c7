"""InferenceOptimizer — the port of ``bigdl_tpu/nano/inference_optimizer.py``
(ref: P:nano/pytorch/inference/optimizer.py): ``quantize``, ``trace``,
``optimize`` (the trial table), ``save`` / ``load``, ``summary`` and
``get_best_model``.

A pipeline holds its module on a device in eval mode and runs it under
``torch.inference_mode()``; ``forward`` takes numpy (or tensors, or a
tuple / Table of them) and returns numpy, as the JAX wrapper does, so a
pipeline's latency in ``optimize`` includes the device's work (each
forward reads its result back). Every entry takes ``device=None``, which
means the GPU.

``save`` writes the module (``save_module``) and ``nano_meta.json``; the
JAX package also writes its compiled XLA executable. A CUDA graph or a
kernel build does not outlive its process, so the port writes no such
artifact and a loaded pipeline's ``_aot`` stays ``None``.
"""

from __future__ import annotations

import copy
import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from bigdl_tpu_torch.device import resolve_device
from bigdl_tpu_torch.utils.table import Table

_FLOAT_DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16,
                 "float16": torch.float16}
_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float16: "float16"}


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
        self._example_shape = None        # the last input's shape and
        self._example_dtype = np.float32  # dtype, which save() records
        self._aot = None                  # no compiled artifact: see above

    def forward(self, x):
        if isinstance(x, np.ndarray):
            self._example_shape = tuple(x.shape)
            self._example_dtype = x.dtype
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

    @staticmethod
    def optimize(model, x, latency_sample_num: int = 10,
                 validation_data=None, metric: Optional[Callable] = None,
                 device=None) -> Dict[str, dict]:
        """Try the pipelines, time them, return the trial table (ref:
        InferenceOptimizer.optimize: latency per pipeline, plus a metric
        column when ``validation_data=(x, y)`` and a ``metric(pred, y) ->
        float`` are given). A pipeline that cannot take the model is
        reported ``"failed: ..."``. Each trial's model also carries
        ``trial_launches``: the custom kernels' launches of its warm-up
        and timed forwards (empty on the CPU)."""
        from bigdl_tpu_torch.llm import kernels
        model = getattr(model, "module", model)
        dev = resolve_device(device)
        report = {}
        for name, builder in {
            "original(jit)": lambda: InferenceOptimizer.trace(
                model, device=dev),
            "bf16": lambda: InferenceOptimizer.quantize(model, "bf16",
                                                        device=dev),
            "int8": lambda: InferenceOptimizer.quantize(model, "int8",
                                                        device=dev),
            "int8-conv": lambda: InferenceOptimizer._quantize_convs(
                model, device=dev),
            "int4": lambda: InferenceOptimizer.quantize(model, "sym_int4",
                                                        device=dev),
        }.items():
            try:
                m = builder()
                before = kernels.launch_counts()
                m.forward(x)  # warm-up: first launches, kernel builds
                t0 = time.perf_counter()
                for _ in range(latency_sample_num):
                    m.forward(x)      # reads back: the device's work is in
                dt = (time.perf_counter() - t0) / latency_sample_num
                after = kernels.launch_counts()
                m.trial_launches = {k: v - before.get(k, 0)
                                    for k, v in after.items()
                                    if v != before.get(k, 0)}
                entry = {"latency_ms": dt * 1000, "model": m,
                         "status": "successful"}
                if validation_data is not None and metric is not None:
                    try:
                        vx, vy = validation_data
                        entry["metric"] = float(metric(m.forward(vx), vy))
                    except Exception as me:   # keep the timed pipeline
                        entry["metric_error"] = str(me)
                report[name] = entry
            except Exception as e:  # pipeline not applicable to model
                report[name] = {"status": f"failed: {e}"}
        return report

    @staticmethod
    def save(compiled: _CompiledModel, path: str):
        """Persist a pipeline (ref: P:nano InferenceOptimizer.save/load):
        the module (``save_module``: manifest + safetensors + its
        structure, quantized leaves included) and ``nano_meta.json`` (the
        cast dtype and the last input's shape and dtype)."""
        os.makedirs(path, exist_ok=True)
        compiled._model.save_module(os.path.join(path, "module"))
        meta = {"dtype": _DTYPE_NAMES.get(compiled._dtype),
                "example_shape": list(compiled._example_shape)
                if compiled._example_shape else None,
                "example_dtype": str(np.dtype(compiled._example_dtype))}
        with open(os.path.join(path, "nano_meta.json"), "w") as f:
            json.dump(meta, f)

    @staticmethod
    def load(path: str, device=None) -> _CompiledModel:
        """Reload a pipeline written by :meth:`save` onto ``device``."""
        from bigdl_tpu_torch.nn.module import Module
        model = Module.load_module(os.path.join(path, "module"),
                                   device=device)
        with open(os.path.join(path, "nano_meta.json")) as f:
            meta = json.load(f)
        dtype = getattr(torch, meta["dtype"]) if meta["dtype"] else None
        compiled = _CompiledModel(model, device, dtype)
        if meta.get("example_shape"):
            compiled._example_shape = tuple(meta["example_shape"])
            compiled._example_dtype = np.dtype(
                meta.get("example_dtype", "float32"))
        return compiled

    @staticmethod
    def summary(report: Dict[str, dict]) -> str:
        """The reference prints a trial table; same here."""
        lines = [f"{'pipeline':<16} {'latency(ms)':>12} {'metric':>10} "
                 f"status"]
        for name, e in report.items():
            lat = (f"{e['latency_ms']:.3f}"
                   if "latency_ms" in e else "-")
            met = (f"{e['metric']:.4f}" if "metric" in e else "-")
            lines.append(f"{name:<16} {lat:>12} {met:>10} {e['status']}")
        return "\n".join(lines)

    @staticmethod
    def get_best_model(report: Dict[str, dict]):
        ok = {k: v for k, v in report.items()
              if v.get("status") == "successful"}
        best = min(ok, key=lambda k: ok[k]["latency_ms"])
        return ok[best]["model"], best
