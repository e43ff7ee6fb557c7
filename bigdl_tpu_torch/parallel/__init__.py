"""Parallelism of the port (``bigdl_tpu.parallel``) over
``torch.distributed``: the mesh and batch sharding, the collectives
(plain, bf16-compressed and int8-quantized all-reduce, all-gather,
reduce-scatter, all-to-all, the ring shift, a barrier), the
data-parallel train step, and the online-softmax block update that the
blockwise cache-window attention shares with ring attention. The
tensor-parallel placements, the ring itself, pipelines and Ulysses are
ROADMAP Queue 1 item 10 (rest)."""

from bigdl_tpu_torch.parallel.collectives import (
    all_gather, all_reduce, all_to_all, barrier_sum, compressed_all_reduce,
    ppermute_next, quantized_all_reduce, reduce_scatter)
from bigdl_tpu_torch.parallel.data_parallel import dp_train_step
from bigdl_tpu_torch.parallel.mesh import (create_mesh, default_mesh,
                                           mesh_axis_size, shard_batch)
from bigdl_tpu_torch.parallel.ring_attention import online_block_update

__all__ = [
    "create_mesh", "default_mesh", "mesh_axis_size", "shard_batch",
    "all_reduce", "all_gather", "reduce_scatter", "all_to_all",
    "ppermute_next", "barrier_sum", "compressed_all_reduce",
    "quantized_all_reduce", "dp_train_step", "online_block_update"]
