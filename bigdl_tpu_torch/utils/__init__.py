"""Utilities of the port (``bigdl_tpu/utils``): :class:`Table` so far."""

from bigdl_tpu_torch.utils.table import T, Table

__all__ = ["T", "Table"]
