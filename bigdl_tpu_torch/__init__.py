"""bigdl_tpu_torch — the PyTorch/CUDA port of ``bigdl_tpu``.

The package mirrors the JAX package's module tree (``llm/models/llama.py``,
``llm/kernels/paged_attention.py``, ...). Plain tensor code is PyTorch;
every Pallas kernel on the ported path is a hand-written CUDA C++ kernel
for Hopper (``csrc/*.cu``), built with ``nvcc`` at first use
(``llm/kernels/_build.py``) and bound with ``ctypes``.

Rules the port keeps:

- it imports ``torch`` and never ``jax``, and nothing of ``bigdl_tpu``
  (importing any ``bigdl_tpu`` module runs the package ``__init__``,
  which pulls JAX in) — what it needs of the JAX package it copies;
- every public entry point runs on ``cuda`` unless the caller passes
  ``device="cpu"``; with no GPU and no explicit CPU request it raises
  (:func:`bigdl_tpu_torch.device.resolve_device`);
- each kernel wrapper launches its kernel for CUDA tensors (or raises)
  and takes the kernel's plain PyTorch version only for CPU tensors.
"""

from bigdl_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
