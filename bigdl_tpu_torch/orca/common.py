"""init_orca_context — the port of ``bigdl_tpu/orca/common.py`` (ref:
P:orca/common/__init__.py creates the SparkContext (+Ray) for
cluster_mode local/yarn/k8s; here: the Engine and its mesh)."""

from __future__ import annotations

import logging
from typing import Optional

logger = logging.getLogger("bigdl_tpu_torch.orca")

_context: Optional["OrcaContext"] = None


class OrcaContext:
    """The Engine this Orca job trains over: ``cluster_mode="local-cpu"``
    is gloo on the host, any other mode the GPU under NCCL (raising
    without one)."""

    def __init__(self, cluster_mode: str, cores: Optional[int],
                 num_nodes: int):
        from bigdl_tpu_torch.utils.engine import Engine

        self.cluster_mode = cluster_mode
        engine_type = "cpu" if cluster_mode == "local-cpu" else None
        Engine.init(engine_type=engine_type)
        self.mesh = Engine.mesh()
        self.num_devices = Engine.world_size()
        self.num_nodes = num_nodes
        self.cores = cores

    def __repr__(self):
        return (f"OrcaContext(mode={self.cluster_mode}, "
                f"devices={self.num_devices})")


def init_orca_context(cluster_mode: str = "local", cores: Optional[int]
                      = None, num_nodes: int = 1, memory: str = "2g",
                      init_ray_on_spark: bool = False,
                      **kwargs) -> OrcaContext:
    """ref signature kept; Spark/Ray-only kwargs accepted and ignored with
    a log line (memory, conda archives, extra python libs...)."""
    global _context
    if kwargs:
        logger.info("orca: ignoring Spark/Ray-specific kwargs %s",
                    sorted(kwargs))
    _context = OrcaContext(cluster_mode, cores, num_nodes)
    return _context


def get_orca_context() -> OrcaContext:
    if _context is None:
        raise RuntimeError("call init_orca_context() first")
    return _context


def stop_orca_context():
    """Forget the context and tear the Engine's process group down."""
    global _context
    if _context is not None:
        from bigdl_tpu_torch.utils.engine import Engine
        Engine.reset()
    _context = None
