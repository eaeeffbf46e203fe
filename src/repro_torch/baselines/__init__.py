"""`repro_torch.baselines` — the per-iteration-job baselines the paper's
speed claim is made against (counterpart of `repro.baselines`): MR-FKM
and Mahout-KM."""
from .kmeans import mr_kmeans
from .mr_fkm import mr_fuzzy_kmeans, mr_fuzzy_kmeans_store

__all__ = ["mr_fuzzy_kmeans", "mr_fuzzy_kmeans_store", "mr_kmeans"]
