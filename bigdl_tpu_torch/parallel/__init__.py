"""Parallelism helpers of the port (``bigdl_tpu.parallel``): so far the
online-softmax block update that the blockwise cache-window attention
shares with ring attention. The ring itself, data/pipeline parallelism
and Ulysses are ROADMAP Queue 1 item 10."""

from bigdl_tpu_torch.parallel.ring_attention import online_block_update

__all__ = ["online_block_update"]
