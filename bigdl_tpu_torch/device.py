"""Device resolution shared by every public entry point of the port.

Resolving to the GPU also gives the caching allocator its split limit
(``SPLIT_LIMIT``) when the process has not started CUDA yet and the
caller set none. Without it, a thread's or a stream's first cuBLAS call
can take its 32 MiB workspace from a large freed block still in the
allocator's cache (a served model's KV pool) and pin that block's whole
segment past ``empty_cache``: a long-lived process that frees a model
and starts new threads (``LLMRouter``, a fleet's ``LocalWorkerProvider``)
then finds tens of GiB reserved but unusable. Under the limit blocks of
512 MiB or more are never split. On an H100 it moved neither the 7B
graphed decode step nor the ResNet-50 train step (``PERF.md`` §7,
``alloc_split_probe.py --cost``).
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

SPLIT_LIMIT = "max_split_size_mb:512"
_ALLOC_VARS = ("PYTORCH_CUDA_ALLOC_CONF", "PYTORCH_ALLOC_CONF")


def set_split_limit() -> bool:
    """Add ``SPLIT_LIMIT`` to ``PYTORCH_CUDA_ALLOC_CONF`` if CUDA has not
    started in this process (the allocator reads its settings once, when
    it starts) and neither allocator variable names a split limit.
    Returns whether it did."""
    if torch.cuda.is_initialized() or any(
            "max_split_size_mb" in os.environ.get(v, "")
            for v in _ALLOC_VARS):
        return False
    conf = os.environ.get(_ALLOC_VARS[0], "")
    os.environ[_ALLOC_VARS[0]] = ",".join(c for c in (conf, SPLIT_LIMIT)
                                          if c)
    return True


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the GPU: ``cuda`` when one is present, otherwise a
    ``RuntimeError`` — the port never carries on quietly on the CPU. An
    explicit ``"cpu"`` (what the tests pass) or ``"cuda[:n]"`` is taken
    as given. A CUDA device sets the allocator's split limit first
    (:func:`set_split_limit`)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port's plain PyTorch path on the CPU")
        set_split_limit()
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        set_split_limit()
    return dev
