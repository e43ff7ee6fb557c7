"""Utilities of the port (``bigdl_tpu/utils``): the :class:`Engine` and
:class:`Table` (and, imported by path, ``checkpoint``, ``conf``,
``tree`` and the legacy ``importers``)."""

from bigdl_tpu_torch.utils.engine import Engine, get_mesh, init_engine
from bigdl_tpu_torch.utils.table import T, Table

__all__ = ["Engine", "init_engine", "get_mesh", "Table", "T"]
