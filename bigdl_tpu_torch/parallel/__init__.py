"""Parallelism of the port (``bigdl_tpu.parallel``) over
``torch.distributed``: the mesh, placements and batch sharding, the
collectives (plain, bf16-compressed and int8-quantized all-reduce,
all-gather, reduce-scatter, all-to-all, the ring shift, a barrier), the
data-parallel train step and the tensor-parallel layout rules, ring and
Ulysses attention (sequence parallelism), and the GPipe pipeline.

The JAX package places arrays on a device mesh and lets XLA insert the
collectives. Here every rank is a process holding its own shard as a
plain tensor, and the collectives are explicit."""

from bigdl_tpu_torch.parallel.collectives import (
    all_gather, all_reduce, all_to_all, barrier_sum, compressed_all_reduce,
    ppermute_next, quantized_all_reduce, reduce_scatter)
from bigdl_tpu_torch.parallel.data_parallel import (dp_train_step,
                                                    param_shardings,
                                                    tp_linear_spec)
from bigdl_tpu_torch.parallel.mesh import (constrain, create_mesh,
                                           default_mesh, mesh_axis_size,
                                           replicated, shard_along,
                                           shard_batch)
from bigdl_tpu_torch.parallel.pipeline import (PipelineModule,
                                               make_pipeline_train_step,
                                               pipeline_stage_fn,
                                               split_microbatches)
from bigdl_tpu_torch.parallel.ring_attention import (online_block_update,
                                                     ring_attention,
                                                     ring_self_attention)
from bigdl_tpu_torch.parallel.ulysses import ulysses_attention

__all__ = [
    "create_mesh", "default_mesh", "mesh_axis_size", "replicated",
    "shard_along", "shard_batch", "constrain",
    "all_reduce", "all_gather", "reduce_scatter", "all_to_all",
    "ppermute_next", "barrier_sum", "compressed_all_reduce",
    "quantized_all_reduce",
    "ring_attention", "ring_self_attention", "ulysses_attention",
    "pipeline_stage_fn", "PipelineModule",
    "make_pipeline_train_step", "split_microbatches",
    "dp_train_step", "tp_linear_spec", "param_shardings",
    "online_block_update"]
