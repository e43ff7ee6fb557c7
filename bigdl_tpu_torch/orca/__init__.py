"""Orca's runtime and Estimators — the port of ``bigdl_tpu/orca`` (ref:
python/orca).

The reference's Orca turns a Spark/Ray cluster into a scale-out substrate
for foreign frameworks: ``init_orca_context`` builds the cluster,
``XShards`` partitions data across it, per-backend ``Estimator``s run
each framework's training loop on the workers. Here the substrate is
``torch.distributed``: ``init_orca_context`` runs ``Engine.init`` (NCCL
on the card, gloo on the host), XShards partitions are merged and fed to
the ``data`` mesh axis at fit time, and the Estimator backends are:

- ``bigdl`` — the port's nn / Keras models through ``LocalOptimizer`` or
  ``DistriOptimizer`` on the Engine's mesh;
- ``torch`` — a plain ``torch.nn.Module`` and ``torch.optim`` loop driven
  shard by shard on the device (TorchRunner's creator-function API);
- ``tf2`` — a tf.keras model trained on the host with a GradientTape
  loop (``tensorflow`` imported only when used).

``RayContext`` is the RayOnSpark role on spawned standard-library
processes; its tasks travel by ``pickle`` (see
:mod:`~bigdl_tpu_torch.orca.ray_pool`).
"""

from bigdl_tpu_torch.orca.common import (
    OrcaContext, init_orca_context, stop_orca_context)
from bigdl_tpu_torch.orca.data import XShards
from bigdl_tpu_torch.orca.ray_pool import (
    RayContext, RemoteError, init_ray_on_spark)

__all__ = ["init_orca_context", "stop_orca_context", "OrcaContext",
           "XShards", "RayContext", "RemoteError", "init_ray_on_spark"]
