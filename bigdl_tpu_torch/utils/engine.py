"""Runtime bootstrap — the port of ``bigdl_tpu/utils/engine.py`` (ref:
scala/dllib/.../utils/Engine.scala).

The JAX ``Engine`` initialises ``jax.distributed`` and builds a
``jax.sharding.Mesh``; here it initialises ``torch.distributed`` and
builds a :class:`torch.distributed.device_mesh.DeviceMesh` with the
configured axis names and shape. The rest of the port (``DistriOptimizer``,
Keras ``fit``, ``parallel``) trains over that mesh.

Engine types: ``"gpu"`` (``"cuda"``) runs NCCL, one CUDA device a
process; ``"cpu"`` runs gloo on the host (what the tests use, the
analog of the JAX package's virtual CPU mesh). The default is the GPU:
without one, :meth:`Engine.init` raises rather than carry on on gloo.

Where the world comes from, highest first:

- a process group that is already initialised (the caller ran
  ``torch.distributed.init_process_group``) is adopted;
- an explicit coordinator (the ``coordinator_address`` argument or the
  ``bigdl.coordinator.address`` key, with ``bigdl.num.processes`` and
  ``bigdl.process.id``) is joined over TCP; if that fails, ``init``
  raises and counts ``bigdl_engine_init_failures_total``;
- torch's launch variables (``MASTER_ADDR``, ``MASTER_PORT``,
  ``WORLD_SIZE``, ``RANK``, as ``torchrun`` sets them) are joined on a
  best-effort basis, as the JAX package treats
  ``JAX_COORDINATOR_ADDRESS``: a failure is warned and counted, and the
  process goes on alone;
- otherwise the process is a world of one (``jax.distributed`` stays
  single-process the same way), on an in-process store.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import math
import os
import threading
from typing import Optional, Sequence

import torch
import torch.distributed as dist

logger = logging.getLogger("bigdl_tpu_torch")

_LAUNCH_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
_TYPES = {"gpu": "nccl", "cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass
class EngineConfig:
    engine_type: str = "gpu"          # "gpu" (NCCL) | "cpu" (gloo)
    node_number: int = 1              # number of processes
    core_number: int = 1              # devices per process
    mesh_axes: tuple = ("data",)      # default mesh axis names
    mesh_shape: Optional[tuple] = None
    coordinator_address: Optional[str] = None
    process_id: int = 0


class Engine:
    """Global runtime singleton (ref: Engine.scala object Engine)."""

    _lock = threading.RLock()
    _initialized = False
    _config: EngineConfig = EngineConfig()
    _mesh = None
    _device: Optional[torch.device] = None

    DATA_AXIS = "data"
    MODEL_AXIS = "model"
    SEQ_AXIS = "seq"
    EXPERT_AXIS = "expert"
    PIPELINE_AXIS = "pipe"

    @classmethod
    def init(
        cls,
        engine_type: Optional[str] = None,
        mesh_shape: Optional[Sequence[int]] = None,
        mesh_axes: Optional[Sequence[str]] = None,
        coordinator_address: Optional[str] = None,
        num_processes: Optional[int] = None,
        process_id: Optional[int] = None,
        timeout_s: float = 300.0,
    ):
        """Initialise the process group and build the default mesh; returns
        the mesh. Every process of a multi-process job calls it (the analog
        of each Spark executor joining the cluster). ``timeout_s`` bounds
        joining a coordinator (``jax.distributed``'s default, 300 s)."""
        from bigdl_tpu_torch.utils.conf import conf

        with cls._lock:
            # layered config: call-site kwargs > conf.set > env > file
            coordinator_address = (coordinator_address
                                   or conf.get("bigdl.coordinator.address")
                                   or None)
            num_processes = (num_processes
                             or conf.get_int("bigdl.num.processes"))
            if process_id is None:
                process_id = conf.get_int("bigdl.process.id")
            kind = (engine_type or conf.get("bigdl.engine.type")
                    or "gpu").lower()
            if kind not in _TYPES:
                raise ValueError(f"unknown engine type {kind!r}: 'gpu' "
                                 "(NCCL) or 'cpu' (gloo)")
            backend = _TYPES[kind]
            if backend == "nccl" and not torch.cuda.is_available():
                raise RuntimeError(
                    "Engine.init: no CUDA device for the NCCL engine; pass "
                    "engine_type='cpu' to train over gloo on the host")
            timeout = datetime.timedelta(seconds=timeout_s)
            created = not dist.is_initialized()
            if not created:
                have = dist.get_backend()
                if backend not in str(have):
                    raise RuntimeError(
                        f"Engine.init({kind!r}) needs a {backend} process "
                        f"group; the live one is {have}")
            elif coordinator_address:
                # explicit configuration fails loudly: a job whose join
                # silently fell back to one process would train on 1/N of
                # the data and report success
                try:
                    dist.init_process_group(
                        backend, init_method=f"tcp://{coordinator_address}",
                        world_size=num_processes or 1,
                        rank=process_id or 0, timeout=timeout)
                except Exception as e:  # noqa: BLE001 — counted, re-raised
                    cls._count_init_failure()
                    raise RuntimeError(
                        "torch.distributed.init_process_group failed for the "
                        "explicitly configured coordinator "
                        f"{coordinator_address!r} (num_processes="
                        f"{num_processes}, process_id={process_id}): "
                        f"{e}") from e
            else:
                joined = False
                if all(os.environ.get(v) for v in _LAUNCH_VARS):
                    try:
                        dist.init_process_group(backend, init_method="env://",
                                                timeout=timeout)
                        joined = True
                    except Exception as e:  # noqa: BLE001 — best effort
                        cls._count_init_failure()
                        logger.warning(
                            "best-effort torch.distributed init from the "
                            "launch variables failed; continuing as a "
                            "world of one: %s", e)
                if not joined:
                    dist.init_process_group(backend, store=dist.HashStore(),
                                            world_size=1, rank=0,
                                            timeout=timeout)
            try:
                return cls._build(backend, mesh_shape, mesh_axes,
                                  coordinator_address)
            except BaseException:
                if created:      # leave no half-made world behind
                    dist.destroy_process_group()
                raise

    @classmethod
    def _build(cls, backend, mesh_shape, mesh_axes, coordinator_address):
        """This process's device and the mesh over the live group."""
        from bigdl_tpu_torch.utils.conf import conf
        world, rank = dist.get_world_size(), dist.get_rank()
        if backend == "nccl":
            local = int(os.environ.get(
                "LOCAL_RANK", rank % torch.cuda.device_count()))
            torch.cuda.set_device(local)
            cls._device = torch.device("cuda", local)
        else:
            cls._device = torch.device("cpu")
        axes = tuple(mesh_axes) if mesh_axes else tuple(
            conf.get_list("bigdl.mesh.axes", ["data"]))
        if mesh_shape:
            shape = tuple(int(v) for v in mesh_shape)
        else:
            cs = conf.get_list("bigdl.mesh.shape")
            shape = tuple(int(v) for v in cs) if cs else \
                (world,) + (1,) * (len(axes) - 1)
        if math.prod(shape) != world or len(shape) != len(axes):
            raise ValueError(f"mesh_shape {shape} over axes {axes} does "
                             f"not cover a world of {world}")
        from torch.distributed.device_mesh import init_device_mesh
        cls._mesh = init_device_mesh(cls._device.type, shape,
                                     mesh_dim_names=axes)
        cls._config = EngineConfig(
            engine_type="cpu" if backend == "gloo" else "gpu",
            node_number=world, core_number=1, mesh_axes=axes,
            mesh_shape=shape, coordinator_address=coordinator_address,
            process_id=rank)
        cls._initialized = True
        logger.info("Engine initialized: backend=%s world=%d rank=%d "
                    "mesh=%s%s", backend, world, rank, axes, shape)
        return cls._mesh

    @staticmethod
    def _count_init_failure():
        from bigdl_tpu_torch import observability as obs
        if obs.enabled():
            obs.counter(
                "bigdl_engine_init_failures_total",
                "torch.distributed.init_process_group failures during "
                "Engine.init").inc()

    @classmethod
    def reinit_distributed(cls, coordinator_address: str,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, **kwargs):
        """Rejoin a new world: tear down the live process group — the old
        coordinator's store died with the failed worker set — and
        :meth:`init` against the next coordinator. The teardown is best
        effort (a group wedged on a dead peer may refuse to close
        cleanly: the failure is logged and the rejoin goes on); the
        re-init follows the loud-failure contract, so a rejoin that
        cannot reach the new coordinator raises instead of limping on
        alone."""
        with cls._lock:
            try:
                if dist.is_initialized():
                    dist.destroy_process_group()
            except Exception as e:  # noqa: BLE001 — wedged group
                logger.warning(
                    "torch.distributed teardown during rejoin failed "
                    "(continuing to re-init): %s", e)
                # forget the wedged group, or init would adopt it
                from torch.distributed import distributed_c10d
                distributed_c10d._update_default_pg(None)
            cls._initialized = False
            cls._mesh = None
            cls._device = None
            cls._config = EngineConfig()
        return cls.init(coordinator_address=coordinator_address,
                        num_processes=num_processes,
                        process_id=process_id, **kwargs)

    @classmethod
    def mesh(cls):
        if not cls._initialized:
            cls.init()
        return cls._mesh

    @classmethod
    def device(cls) -> torch.device:
        """This process's device: its CUDA device under NCCL, the CPU
        under gloo."""
        if not cls._initialized:
            cls.init()
        return cls._device

    @classmethod
    def data_group(cls, axis: str = DATA_AXIS):
        """The process group along mesh ``axis`` (the whole world when
        the mesh lacks it)."""
        mesh = cls.mesh()
        if axis in (mesh.mesh_dim_names or ()):
            return mesh.get_group(axis)
        return dist.group.WORLD

    @classmethod
    def config(cls) -> EngineConfig:
        return cls._config

    @classmethod
    def node_number(cls) -> int:
        return cls._config.node_number

    @classmethod
    def core_number(cls) -> int:
        return cls._config.core_number

    @classmethod
    def world_size(cls) -> int:
        return dist.get_world_size() if cls._initialized else 1

    @classmethod
    def is_initialized(cls) -> bool:
        return cls._initialized

    @classmethod
    def reset(cls):
        """Destroy the process group (adopted or the Engine's own) and
        forget the mesh."""
        with cls._lock:
            if dist.is_initialized():
                dist.destroy_process_group()
            cls._initialized = False
            cls._mesh = None
            cls._device = None
            cls._config = EngineConfig()


def init_engine(**kwargs):
    """Python-API parity shim (ref: python dllib utils/engine.py)."""
    return Engine.init(**kwargs)


def get_mesh():
    return Engine.mesh()
