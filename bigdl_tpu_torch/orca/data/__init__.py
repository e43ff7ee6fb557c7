from bigdl_tpu_torch.orca.data.shard import XShards, read_csv, read_parquet

__all__ = ["XShards", "read_csv", "read_parquet"]
