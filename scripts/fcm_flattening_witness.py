#!/usr/bin/env python3
"""FCM's flattening at m = 2 in high dimensions, fitted on the CPU by the
reference (`repro`, backend ``jnp``) and by the port (`repro_torch`,
backend ``torch`` in float64):

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/fcm_flattening_witness.py \
        [--rows 16384] [--seqs 8192] [--seed 0]

``router``: the first ``--rows`` rows of chip_smoke.py's ``router_fit``
array (`make_router_like` at 262,144 × 2048, C = 64, from ``--seed``: the
same rows), fitted with `router_config`'s settings (router_init.py:40-42:
m = 2, ε 1e-6 / 1e-8, 200 sweeps).  Printed: the centers' norms, their
largest distance from the rows' mean, the mean's norm, the component
means' norms, and the share of rows whose top-1 of x·(v/‖v‖) is their
nearest center (what the ``router_init`` record prints on the card).

``curriculum``: chip_smoke.py's curriculum recipe (16 topics of 64 token
ids, 256 tokens a sequence, from ``--seed`` + 1) over a table drawn as
`tree_init`'s embed rule draws it, N(0, 1/1536) at Qwen2-1.5B's
151,936 × 1536 (numpy, f32: the distribution of the card's table, not its
bits), ``--seqs`` sequences, through each package's `curriculum_buckets`
at the default m = 2 and at the phase's m = 1.2.  Printed: accuracy
against the topics, the ambiguity's min / mean / max, the centers' norms.

One JSON line per fit.  Like the parity tests, it imports both packages.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (numpy recipes and constants)

CUR_D, CUR_VOCAB = 1536, 151_936


def router_rows(rows, seed):
    """The first ``rows`` rows of `cs.make_router_like(ROUTER_N, ...)`:
    the same draws in the same order, the rest never drawn."""
    rng = np.random.default_rng(seed)
    means = rng.normal(0.0, cs.ROUTER_SEP,
                       size=(cs.ROUTER_C, cs.ROUTER_D)).astype(np.float32)
    p = np.arange(1, cs.ROUTER_C + 1) ** -0.8
    labels = rng.choice(cs.ROUTER_C, size=cs.ROUTER_N, p=p / p.sum())
    x = rng.standard_normal((rows, cs.ROUTER_D), dtype=np.float32)
    return x + means[labels[:rows]], means


def curriculum_embeds(seqs, seed):
    """(embeddings (seqs, 1536) f32, topics): each sequence the mean of
    its 256 tokens' rows; only the 1024 topic ids' rows are drawn."""
    rng = np.random.default_rng(seed)
    ids = rng.choice(CUR_VOCAB, cs.CUR_TOPICS * cs.CUR_TOPIC_TOKENS,
                     replace=False).reshape(cs.CUR_TOPICS, cs.CUR_TOPIC_TOKENS)
    topics = rng.integers(0, cs.CUR_TOPICS, seqs)
    picks = rng.integers(0, cs.CUR_TOPIC_TOKENS, (seqs, cs.CUR_LEN))
    rows = np.random.default_rng(seed + 100).normal(
        0.0, CUR_D ** -0.5, (ids.size, CUR_D)).astype(np.float32)
    local = {int(t): i for i, t in enumerate(ids.ravel())}
    index = np.vectorize(local.__getitem__)(ids[topics[:, None], picks])
    return rows[index].mean(axis=1, dtype=np.float32), topics


def summary(x, centers, seconds, **extra):
    x64 = x.astype(np.float64)
    v = np.asarray(centers, np.float64)
    mean = x64.mean(axis=0)
    d2 = ((x64 ** 2).sum(1)[:, None] + (v ** 2).sum(1)[None]
          - 2 * x64 @ v.T)
    unit = v / (np.linalg.norm(v, axis=1, keepdims=True) + 1e-8)
    agree = float(np.mean(np.argmax(x64 @ unit.T, 1) == np.argmin(d2, 1)))
    norms = np.linalg.norm(v, axis=1)
    return {**extra, "seconds": seconds,
            "center_norms": [float(norms.min()), float(norms.max())],
            "centers_from_mean_max": float(
                np.linalg.norm(v - mean, axis=1).max()),
            "data_mean_norm": float(np.linalg.norm(mean)),
            "top1_agreement": agree}


def fit_reference(x, cfg_kw, seed):
    import jax
    import jax.numpy as jnp
    from repro.core import BigFCMConfig, bigfcm_fit
    t0 = time.perf_counter()
    res = bigfcm_fit(jnp.asarray(x), BigFCMConfig(backend="jnp", **cfg_kw),
                     key=jax.random.PRNGKey(seed))
    return np.asarray(res.centers), time.perf_counter() - t0


def fit_port(x, cfg_kw):
    import torch
    from repro_torch.core import BigFCMConfig, bigfcm_fit
    with cs.float64():
        t0 = time.perf_counter()
        res = bigfcm_fit(torch.from_numpy(x).double(),
                         BigFCMConfig(backend="torch", **cfg_kw),
                         device="cpu")
        return res.centers.numpy(), time.perf_counter() - t0


def buckets_reference(emb, m, seed):
    import jax
    import jax.numpy as jnp
    from repro.core import BigFCMConfig
    from repro.integration import curriculum_buckets
    cfg = BigFCMConfig(n_clusters=cs.CUR_TOPICS, m=m, combiner_eps=1e-6,
                       max_iter=300, seed=seed, backend="jnp")
    t0 = time.perf_counter()
    b, amb, res = curriculum_buckets(jnp.asarray(emb), cs.CUR_TOPICS,
                                     fcm_cfg=cfg, key=jax.random.PRNGKey(seed))
    return (np.asarray(b), np.asarray(amb), np.asarray(res.centers),
            time.perf_counter() - t0)


def buckets_port(emb, m, seed):
    import torch
    from repro_torch.core import BigFCMConfig
    from repro_torch.integration import curriculum_buckets
    cfg = BigFCMConfig(n_clusters=cs.CUR_TOPICS, m=m, combiner_eps=1e-6,
                       max_iter=300, seed=seed, backend="torch")
    with cs.float64():
        t0 = time.perf_counter()
        b, amb, res = curriculum_buckets(torch.from_numpy(emb).double(),
                                         cs.CUR_TOPICS, fcm_cfg=cfg,
                                         device="cpu")
        return (b.numpy(), amb.numpy(), res.centers.numpy(),
                time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=16_384)
    ap.add_argument("--seqs", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    from repro_torch.core.metrics import clustering_accuracy

    x, means = router_rows(args.rows, args.seed)
    rc = cs.router_config(args.seed)
    cfg_kw = {f: getattr(rc, f) for f in ("n_clusters", "m", "combiner_eps",
                                          "reducer_eps", "max_iter", "seed")}
    base = {"run": "router", "rows": args.rows, "d": cs.ROUTER_D,
            "c": cs.ROUTER_C, "m": rc.m,
            "component_mean_norms": [
                float(np.linalg.norm(means, axis=1).min()),
                float(np.linalg.norm(means, axis=1).max())]}
    v, s = fit_reference(x, cfg_kw, args.seed)
    print(json.dumps(summary(x, v, s, package="reference", backend="jnp",
                             **base)), flush=True)
    v, s = fit_port(x, cfg_kw)
    print(json.dumps(summary(x, v, s, package="port",
                             backend="torch float64", **base)), flush=True)
    del x

    emb, topics = curriculum_embeds(args.seqs, args.seed + 1)
    for m in (cs.CUR_DEFAULT_M, cs.CUR_M):
        for package, fit in (("reference", buckets_reference),
                             ("port", buckets_port)):
            b, amb, v, s = fit(emb, m, args.seed)
            norms = np.linalg.norm(v, axis=1)
            print(json.dumps({
                "run": "curriculum", "package": package, "m": m,
                "sequences": args.seqs, "d": CUR_D, "c": cs.CUR_TOPICS,
                "seconds": s,
                "accuracy": clustering_accuracy(topics, b, cs.CUR_TOPICS),
                "ambiguity": [float(amb.min()), float(amb.mean()),
                              float(amb.max())],
                "center_norms": [float(norms.min()), float(norms.max())]}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
