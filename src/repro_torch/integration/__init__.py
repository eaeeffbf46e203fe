"""BigFCM as a first-class framework feature — counterpart of
`repro.integration`.

Two integration points wire the paper's clustering into the LM runtime:

  * `router_init` — seed MoE router weights with FCM centroids of token
    embeddings (clustered tokens route coherently from step 0).
  * `curriculum`  — curriculum bucketing: BigFCM clusters sequence
    embeddings; buckets order/balance the data pipeline.
"""
from .curriculum import (CurriculumSampler, curriculum_buckets,
                         sequence_embeddings)
from .router_init import fcm_router_init

__all__ = ["fcm_router_init", "curriculum_buckets", "CurriculumSampler",
           "sequence_embeddings"]
