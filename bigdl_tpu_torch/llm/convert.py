"""Weight carry from the JAX package to the port.

:func:`params_from_numpy` turns a JAX-package parameter tree, given as
nested dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray,
params)`` on the JAX side), into the port's tensors with the same keys,
shapes, dtypes and layouts. The port never sees JAX: bf16 arrays arrive
as numpy arrays of the ``bfloat16`` extension dtype and are carried bit
for bit through their 16-bit pattern.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from bigdl_tpu_torch.device import resolve_device


def tensor_from_numpy(a: np.ndarray, device: torch.device):
    """One numpy array → an owned tensor on ``device``, bf16 and e4m3fn
    carried bit for bit; a string array (a ``"qtype"`` tag) stays a string."""
    if a.dtype.kind in "US":
        return str(a)                  # a "qtype" string leaf, as array
    a = np.array(a, order="C", copy=True)     # writable, owned
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    elif a.dtype.name == "float8_e4m3fn":
        t = torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_numpy(tree: Any, device=None) -> Any:
    """Nested dicts of numpy arrays → the same dicts of tensors on
    ``device`` (``None`` = the GPU, raising without one). String leaves
    (the ``"qtype"`` tags, plain or as 0-d arrays) stay strings."""
    dev = resolve_device(device)

    def carry(x):
        if isinstance(x, dict):
            return {k: carry(v) for k, v in x.items()}
        if isinstance(x, np.ndarray):
            return tensor_from_numpy(x, dev)
        return x

    return carry(tree)
