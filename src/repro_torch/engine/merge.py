"""Merge plans — the weighted summary-reduce, and the convergence loop.

Counterpart of `repro.engine.merge`.  BigFCM's reducer, WFCMPB's
progression and the streaming window all run a weighted FCM over a
stack of (centers, masses) summaries, with a *topology* choice:

  ``flat``      — one WFCM over all S·C sketch points (the paper's
                  single reduce job; also each WFCMPB scan step).
  ``pairwise``  — balanced tree of 2-slot flat merges (log₂ S WFCM
                  rounds), each pair seeded with its heavier slot.
  ``windowed``  — ONE WFCM whose every iteration accumulates the raw
                  per-slot (v_num, w_i, q) sums through the backend's
                  ``accumulate`` entry, one call per slot in slot order
                  (K1 at C points per slot under ``hopper``), and
                  normalizes once.

`fcm_converge_batched` runs T independent fits at once, the tenant
plane's loop.

`_converge` and `fcm_converge_batched` are the reference's
``lax.while_loop`` programs as host loops with the same stopping rules.
Each reads its stopping test on the host once per iteration, one
device→host sync each.

**Mass is NOT conserved by WFCM** (Σ_i u_ik^m < 1 for m > 1): compare
merged centers and objectives, never total mass.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Union

import torch

from ..device import as_real, real_dtype, resolve_device
from .backend import BackendLike, normalize_accumulators, resolve_backend
from .summary import Summary, slot_masses
from .summary import concat as concat_summaries
from .summary import stack as stack_summaries

TOPOLOGIES = ("flat", "pairwise", "windowed")


@dataclasses.dataclass(frozen=True)
class MergePlan:
    """How (and how hard) to collapse a summary stack into one summary."""
    topology: str = "flat"     # one of TOPOLOGIES
    seed: str = "heaviest"     # "heaviest" | "first" — reducer WFCM seeds
    m: float = 2.0
    eps: float = 5e-11         # paper reducer ε
    max_iter: int = 200

    def __post_init__(self):
        if self.topology not in TOPOLOGIES:
            raise ValueError(f"unknown merge topology {self.topology!r}; "
                             f"one of {TOPOLOGIES}")
        if self.seed not in ("heaviest", "first"):
            raise ValueError(f"unknown seed rule {self.seed!r}")


class MergeResult(NamedTuple):
    summary: Summary          # merged (C, d) centers + (C,) masses
    n_iter: int               # WFCM sweeps run, summed over rounds
    objective: torch.Tensor   # () f32 — Eq. (2) of the final sweep


def _converge(sweep, v0: torch.Tensor, *, eps: float,
              max_iter: int) -> MergeResult:
    """The paper's stopping rule: iterate ``sweep: centers → (v_new, w_i,
    q)`` until max_i ‖ΔV_i‖² ≤ ε (the first sweep always runs; capped at
    ``max_iter``), then one more sweep for the final masses (Eq. 6)."""
    v = v0.to(real_dtype())
    n_iter = 0
    while n_iter < max_iter:
        v_new, _, _ = sweep(v)
        n_iter += 1
        delta = torch.max(torch.sum((v_new - v) ** 2, dim=-1))
        v = v_new
        if not bool(delta > eps):
            break
    _, w_final, q = sweep(v)
    return MergeResult(Summary(v, w_final), n_iter, q)


def fcm_converge(
    x,
    init_centers,
    *,
    m: float = 2.0,
    eps: float = 1e-6,
    max_iter: int = 1000,
    point_weights=None,
    backend: BackendLike = None,
    device: Union[str, torch.device] = "cuda",
) -> MergeResult:
    """Run (weighted) FCM over records to convergence through the
    resolved backend's sweep.  The core of `repro_torch.core.fcm`."""
    dev = resolve_device(device)
    be = resolve_backend(backend, device=dev)
    x = as_real(x, dev)
    w = (torch.ones((x.shape[0],), dtype=x.dtype, device=dev)
         if point_weights is None else as_real(point_weights, dev))
    return _converge(lambda v: be.sweep(x, w, v, m),
                     as_real(init_centers, dev), eps=eps, max_iter=max_iter)


def fcm_converge_batched(
    X,
    W,
    init_centers,
    *,
    m=2.0,
    eps: float = 1e-6,
    max_iter: int = 1000,
    backend: BackendLike = None,
    device: Union[str, torch.device] = "cuda",
):
    """Run T independent (weighted) FCM fits to convergence together —
    the tenant axis of `repro_torch.tenant`.

    ``X`` (T, N, d) phantom-padded record blocks, ``W`` (T, N) weights
    (0 on padding rows), ``init_centers`` (T, C, d), ``m`` scalar or a
    (T,) per-tenant array.  Returns ``(centers (T, C, d), masses
    (T, C), objective (T,), n_iter (T,))``.

    Every iteration runs one ``batched_sweep`` over all T tenants.  A
    per-tenant done-mask keeps each tenant on the trajectory
    `fcm_converge` would give it alone: tenant t is active while
    ``n_iter < max_iter`` and (``n_iter == 0`` or max_i ‖ΔV_i‖² > ε);
    only active tenants take the new centers, frozen ones keep
    (v, v_prev, n_iter).  The loop ends when no tenant is active, and
    one more batched sweep gives the masses and per-tenant objectives
    (Eq. 6).  Frozen tenants are swept along with the rest, as in the
    reference.  The reference's ``batched_trace_counts`` guards XLA
    retraces of its jitted program; this loop compiles nothing, so it
    has no counterpart."""
    dev = resolve_device(device)
    be = resolve_backend(backend, device=dev,
                         shape=(X.shape[1], init_centers.shape[1],
                                X.shape[2]))
    X = as_real(X, dev)
    W = as_real(W, dev)
    v = as_real(init_centers, dev)
    m = as_real(m, dev)
    if m.dim() == 0:
        # Materialized once per fit: the kernel reads a contiguous (T,).
        m = m.expand(X.shape[0]).contiguous()
    v_prev = v
    n_iter = torch.zeros((X.shape[0],), dtype=torch.int32, device=dev)
    while True:
        delta = torch.max(torch.sum((v - v_prev) ** 2, dim=-1), dim=-1).values
        act = (n_iter < max_iter) & ((n_iter == 0) | (delta > eps))
        if not bool(act.any()):
            break
        v_new, _, _ = be.batched_sweep(X, W, v, m)
        a3 = act[:, None, None]
        v, v_prev = torch.where(a3, v_new, v), torch.where(a3, v, v_prev)
        n_iter = torch.where(act, n_iter + 1, n_iter)
    _, w_final, q = be.batched_sweep(X, W, v, m)
    return v, w_final, q, n_iter


def _seed_centers(s: Summary, rule: str) -> torch.Tensor:
    if rule == "first":
        # Paper line 13: seed the reducer WFCM with V_1, the first
        # combiner's centers.
        return s.centers[0]
    return s.centers[torch.argmax(slot_masses(s))]


def _merge_flat(s: Summary, plan: MergePlan, be, init) -> MergeResult:
    pts = s.centers.reshape(-1, s.centers.shape[-1])
    wts = s.masses.reshape(-1)
    v0 = _seed_centers(s, plan.seed) if init is None else init
    return _converge(lambda v: be.sweep(pts, wts, v, plan.m), v0,
                     eps=plan.eps, max_iter=plan.max_iter)


def _merge_windowed(s: Summary, plan: MergePlan, be, init) -> MergeResult:
    n_slots = s.centers.shape[0]

    def sweep(v):
        v_num, w_i, q = be.accumulate(s.centers[0], s.masses[0], v, plan.m)
        for i in range(1, n_slots):    # one accumulate per slot, in order
            vn, wi, qi = be.accumulate(s.centers[i], s.masses[i], v, plan.m)
            v_num, w_i, q = v_num + vn, w_i + wi, q + qi
        return normalize_accumulators(v_num, w_i, q)

    v0 = _seed_centers(s, plan.seed) if init is None else init
    return _converge(sweep, v0, eps=plan.eps, max_iter=plan.max_iter)


def _merge_pairwise(s: Summary, plan: MergePlan, be) -> MergeResult:
    level = [Summary(s.centers[i], s.masses[i])
             for i in range(s.centers.shape[0])]
    n_iter = 0
    q = torch.zeros((), device=s.centers.device)
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level) - 1, 2):
            a, b = level[i], level[i + 1]
            # seed each pair with the heavier slot's centers
            v0 = torch.where(torch.sum(a.masses) >= torch.sum(b.masses),
                             a.centers, b.centers)
            res = _merge_flat(stack_summaries([a, b]), plan, be, v0)
            n_iter += res.n_iter
            q = res.objective
            nxt.append(res.summary)
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return MergeResult(level[0], n_iter, q)


def merge_summaries(
    summaries: Union[Summary, Sequence[Summary]],
    plan: Optional[MergePlan] = None,
    *,
    backend: BackendLike = None,
    init: Optional[torch.Tensor] = None,
) -> MergeResult:
    """Collapse a stack of (centers, masses) summaries into one, on the
    device the summaries lie on.

    ``summaries`` is a `Summary` with a leading slot axis — (S, C, d)
    centers, (S, C) masses — or a sequence of summaries, each a single
    (C, d) sketch or an (S_i, C, d) stack, concatenated along the slot
    axis.  ``init`` overrides the plan's seed rule with explicit reducer
    seed centers; it applies to the single-WFCM topologies only —
    ``pairwise`` seeds every pair with the heavier slot's centers, so
    passing ``init`` with it is an error rather than a silent no-op.
    Phantom (zero-mass) slots vanish by construction in every topology.

    Merged *masses* depend on the topology (WFCM does not conserve mass;
    see the module note).
    """
    if not isinstance(summaries, Summary):
        summaries = concat_summaries(list(summaries))
    if summaries.centers.dim() != 3:
        raise ValueError("merge_summaries expects stacked (S, C, d) "
                         f"summaries, got centers "
                         f"{tuple(summaries.centers.shape)}")
    plan = plan or MergePlan()
    be = resolve_backend(backend, device=summaries.centers.device)
    if summaries.centers.shape[0] == 1 and init is None:
        # A lone slot with no explicit seed merges to itself.  With
        # ``init`` given, the reducer WFCM still runs as a polish of the
        # single summary from the supplied seed.
        return MergeResult(Summary(summaries.centers[0],
                                   summaries.masses[0]), 0,
                           torch.zeros((), device=summaries.centers.device))
    if plan.topology == "flat":
        return _merge_flat(summaries, plan, be, init)
    if plan.topology == "windowed":
        return _merge_windowed(summaries, plan, be, init)
    if init is not None:
        raise ValueError("init= does not apply to the pairwise topology "
                         "(each pair seeds with its heavier slot); use a "
                         "flat/windowed plan for an explicit seed")
    return _merge_pairwise(summaries, plan, be)
