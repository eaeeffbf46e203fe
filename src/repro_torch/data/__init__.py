from .cache import CacheInvalid, ChunkStore, ColumnStats, StoreWriter
from .plane import (PartitionPlan, as_store, batched, bucket_for,
                    geom_bucket, pad_rows, plan_partitions, replan,
                    shape_buckets, shard_batches)
from .synth import make_blobs, make_higgs_like, make_kdd_like, make_susy_like

__all__ = ["CacheInvalid", "ChunkStore", "ColumnStats", "StoreWriter",
           "PartitionPlan", "as_store", "batched", "bucket_for",
           "geom_bucket", "pad_rows", "plan_partitions", "replan",
           "shape_buckets", "shard_batches",
           "make_blobs", "make_higgs_like", "make_kdd_like",
           "make_susy_like"]
