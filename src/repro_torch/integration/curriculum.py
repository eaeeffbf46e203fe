"""Curriculum bucketing via BigFCM — counterpart of
`repro.integration.curriculum`.

A production data pipeline wants semantically balanced (or staged)
batches.  Each sequence is embedded cheaply (mean of token embeddings),
the embeddings are clustered with BigFCM (on one card or over a mesh),
and the module exposes:

  * `curriculum_buckets(...)` — fuzzy memberships → hard bucket ids plus
    a per-sequence "ambiguity" score (entropy of the membership row; the
    paper's fuzziness put to work: ambiguous sequences can be scheduled
    later or upweighted).
  * `CurriculumSampler` — iterator that interleaves buckets according to
    a schedule ("easy" = most-cohesive cluster first, round-robin, ...).
"""
from __future__ import annotations

from typing import Iterator, Optional, Union

import numpy as np
import torch

from ..core.bigfcm import BigFCMConfig
from ..engine.backend import membership_terms, pairwise_sqdist
from .router_init import _fit

_GATHER_BYTES = 1 << 30     # one block's (rows, S, D) gather at most


def sequence_embeddings(embed_table: torch.Tensor,
                        tokens: torch.Tensor) -> torch.Tensor:
    """(B, S) int → (B, D) mean-pooled token embeddings (cheap probe), in
    the table's dtype.  Taken in row blocks so that the (B, S, D) gather
    never exists whole (at most ``_GATHER_BYTES`` a block); each row's
    mean is its own."""
    tokens = torch.as_tensor(tokens, device=embed_table.device)
    b, s = tokens.shape
    per_row = s * embed_table.shape[1] * embed_table.element_size()
    rows = max(1, _GATHER_BYTES // per_row)
    return torch.cat([torch.mean(embed_table[tokens[r:r + rows]], dim=1)
                      for r in range(0, b, rows)])


def curriculum_buckets(
    seq_embeds,
    n_buckets: int,
    *,
    mesh=None,
    fcm_cfg: Optional[BigFCMConfig] = None,
    sample_idx=None,
    seed_idx=None,
    device: Union[str, torch.device] = "cuda",
):
    """Cluster (N, D) sequence embeddings into fuzzy curriculum buckets.

    Returns (bucket_ids (N,), ambiguity (N,), result) where ambiguity is
    the normalized entropy of each row's fuzzy membership — 0 = clearly
    one bucket, 1 = uniform over buckets.  ``sample_idx`` / ``seed_idx``
    inject the fit's draws (`bigfcm_fit`).
    """
    fcm_cfg = fcm_cfg or BigFCMConfig(n_clusters=n_buckets,
                                      combiner_eps=1e-6, max_iter=300)
    res = _fit(seq_embeds, fcm_cfg, mesh, sample_idx, seed_idx, device)
    x = torch.as_tensor(seq_embeds, device=res.centers.device).float()
    # membership of every sequence vs the final centers (u_ik, not ^m)
    d2 = pairwise_sqdist(x, res.centers)
    um = membership_terms(x, res.centers, fcm_cfg.m)
    u = um / torch.sum(um, dim=1, keepdim=True)
    bucket = torch.argmin(d2, dim=1)
    ent = -torch.sum(u * torch.log(u + 1e-12), dim=1) / np.log(n_buckets)
    return bucket, ent, res


class CurriculumSampler:
    """Yield batch indices bucket-by-bucket (or interleaved).

    order="cohesion": buckets sorted by mean ambiguity ascending (the
    crispest cluster — the "easiest", most self-similar data — first).
    order="round_robin": interleave buckets for balanced coverage.
    """

    def __init__(self, bucket_ids: np.ndarray, ambiguity: np.ndarray,
                 batch: int, *, order: str = "cohesion", seed: int = 0):
        self.batch = batch
        self.rng = np.random.default_rng(seed)
        bucket_ids = np.asarray(bucket_ids)
        ambiguity = np.asarray(ambiguity)
        n_buckets = int(bucket_ids.max()) + 1
        self.buckets = [np.nonzero(bucket_ids == b)[0]
                        for b in range(n_buckets)]
        mean_amb = [float(ambiguity[ix].mean()) if len(ix) else np.inf
                    for ix in self.buckets]
        self.bucket_order = (np.argsort(mean_amb) if order == "cohesion"
                             else np.arange(n_buckets))
        self.order = order

    def __iter__(self) -> Iterator[np.ndarray]:
        if self.order == "round_robin":
            cursors = [0] * len(self.buckets)
            pools = [self.rng.permutation(ix) for ix in self.buckets]
            out = []
            alive = True
            while alive:
                alive = False
                for b, pool in enumerate(pools):
                    if cursors[b] < len(pool):
                        out.append(pool[cursors[b]])
                        cursors[b] += 1
                        alive = True
                    if len(out) == self.batch:
                        yield np.asarray(out)
                        out = []
            return
        for b in self.bucket_order:
            pool = self.rng.permutation(self.buckets[b])
            for i in range(0, len(pool) - self.batch + 1, self.batch):
                yield pool[i:i + self.batch]
