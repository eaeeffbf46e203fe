from .cache import CacheInvalid, ChunkStore, ColumnStats, StoreWriter
from .plane import (PartitionPlan, as_store, batched, bucket_for,
                    geom_bucket, pad_rows, plan_partitions, replan,
                    shape_buckets, shard_batches)
from .synth import (iris, make_blobs, make_higgs_like, make_kdd_like,
                    make_moving_blobs, make_susy_like, pima_like)
from .lm import synthetic_token_batches
from .loader import ShardedLoader, normalize, parse_records
from .stream import (iterator_source, out_of_order_source, replay_source,
                     socket_sim_source, stamp_source, stream_loader)

__all__ = ["CacheInvalid", "ChunkStore", "ColumnStats", "StoreWriter",
           "PartitionPlan", "as_store", "batched", "bucket_for",
           "geom_bucket", "pad_rows", "plan_partitions", "replan",
           "shape_buckets", "shard_batches",
           "iris", "make_blobs", "make_higgs_like", "make_kdd_like",
           "make_moving_blobs", "make_susy_like", "pima_like",
           "ShardedLoader", "normalize", "parse_records",
           "iterator_source", "out_of_order_source", "replay_source",
           "socket_sim_source", "stamp_source", "stream_loader",
           "synthetic_token_batches"]
