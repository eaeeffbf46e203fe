"""`repro_torch.baselines` — the per-iteration-job FKM baseline the
paper's speed claim is made against (counterpart of `repro.baselines`;
`mr_kmeans` comes with a later slice)."""
from .mr_fkm import mr_fuzzy_kmeans, mr_fuzzy_kmeans_store

__all__ = ["mr_fuzzy_kmeans", "mr_fuzzy_kmeans_store"]
