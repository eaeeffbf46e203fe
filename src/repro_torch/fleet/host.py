"""One fleet host — local combiners, summary exchange, elastic replan.

Counterpart of `repro.fleet.host`: BigFCM's mapper+combiner node as a
*peer in a mesh of hosts* instead of a loop index inside one process:

  plan      — every host derives the SAME `PartitionPlan` from
              (store chunking, n_shards) with zero coordination
              (`plan_partitions` is a pure function; its `fingerprint`
              is stamped on every exchanged frame so divergence fails
              loud instead of merging garbage);
  seeds     — every host derives the SAME driver seeds
              (`repro_torch.core.bigfcm.driver_seeds`, Flag pinned — the
              wall-clock race cannot cross hosts);
  local fit — each owned shard through the raw-accumulate engine entry
              (`ooc_fcm`, K1 per batch under the ``hopper`` backends),
              with the NEXT shard's chunks prefetched by a background
              thread while the current shard computes;
  exchange  — the (S, C, d) shard-summary stack, wire-encoded
              (optionally bf16-quantized), all-gathered through a
              transport, then put back on this host's device and merged
              by the ``pairwise`` plan (K2 under ``hopper``) — every
              host runs the identical merge over the identical gathered
              bytes, so the global summary is bit-identical fleet-wide
              with no designated reducer;
  elastic   — a `HostLost` during any gather triggers `replan` at the
              surviving host count (epoch := number of dead hosts, so
              hosts that observe deaths in different groupings still
              converge to the same terminal epoch) and a refit of the
              re-derived shard set — Hadoop's re-execution model with
              the plan as the job tracker.

Devices: the reference places work with ``jax.default_device``; here a
host takes an explicit ``device`` (default ``"cuda"``; the CPU only when
asked for) on which it merges and runs the objective pass, and
``devices``, the devices its shard fits rotate over (default: that one).
Each device gets one `StagingRing`, shared by every shard fit and the
objective pass on it.  Only summary bytes move between hosts (a few KB
per host per fit); results come back as float32 numpy arrays, as the
reference's do.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import obs
from ..core.bigfcm import BigFCMConfig, driver_seeds
from ..core.outofcore import (StagingRing, make_accumulator, ooc_accumulate,
                              ooc_fcm)
from ..data.cache import ChunkStore
from ..data.plane import (PartitionPlan, batched, plan_partitions, replan,
                          shard_batches)
from ..device import resolve_device
from ..engine import MergePlan, Summary, merge_summaries, resolve_backend
from ..engine import concat as concat_summaries
from .transport import Evicted, HostLost
from .wire import _host_f32, decode_summary, encode_summary

_OBJ_FMT = "<dq16s"     # (partial objective, rows, plan fingerprint)


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Fleet topology + exchange knobs (engine knobs stay in
    `BigFCMConfig`).  Env defaults: ``REPRO_FLEET_WIRE`` (``f32`` /
    ``bf16``) and ``REPRO_FLEET_TIMEOUT_S`` (gather backstop)."""
    n_hosts: int
    shards_per_host: int = 1
    batch_rows: Optional[int] = None     # default: the store's chunk size
    wire: str = dataclasses.field(
        default_factory=lambda: os.environ.get("REPRO_FLEET_WIRE", "f32"))
    gather_timeout_s: float = dataclasses.field(
        default_factory=lambda: float(
            os.environ.get("REPRO_FLEET_TIMEOUT_S", "60")))
    prefetch: bool = True
    prefetch_bytes: int = 64 * 2 ** 20   # per-shard pin budget
    straggler_factor: float = 4.0        # × median finished per-row rate
    straggler_min_s: float = 1.0
    # test/bench fault injection: host id → sleep seconds at fit start
    debug_delay_s: Mapping[int, float] = dataclasses.field(
        default_factory=dict)


@dataclasses.dataclass
class FleetResult:
    centers: np.ndarray          # (C, d) float32 — identical on survivors
    masses: np.ndarray           # (C,) float32
    objective: float             # global Eq. (2) over the full store
    n_rows: int
    host_id: int
    live: Tuple[int, ...]        # surviving host ids at completion
    moved_chunks: int            # chunks this host saw migrate in replans
    epoch: int                   # number of host losses survived
    shard_seconds: Dict[int, float]   # this host's per-shard fit times


class FleetHost:
    """One peer of the fleet (see module docstring)."""

    def __init__(self, host_id: int, store: ChunkStore, cfg: BigFCMConfig,
                 fleet: FleetConfig, transport, *,
                 device: Union[str, torch.device] = "cuda",
                 devices: Optional[Sequence[Union[str, torch.device]]] = None):
        if not 0 <= host_id < fleet.n_hosts:
            raise ValueError(f"host_id {host_id} not in "
                             f"[0, {fleet.n_hosts})")
        self.host_id = host_id
        self.store = store
        self.cfg = cfg
        self.fleet = fleet
        self.transport = transport
        self.device = resolve_device(device)
        self.devices = tuple(resolve_device(d) for d in devices) \
            if devices else (self.device,)
        self.live: Tuple[int, ...] = tuple(range(fleet.n_hosts))
        self.moved_chunks = 0
        self.shard_seconds: Dict[int, float] = {}
        self.batch_rows = int(fleet.batch_rows or store.chunk_rows)
        self.backend = resolve_backend(
            cfg.backend, device=self.device,
            shape=(store.n_rows, cfg.n_clusters, store.dim))
        self.acc = make_accumulator(self.backend, cfg.m)
        self.merge_plan = MergePlan("pairwise", m=cfg.m,
                                    eps=cfg.reducer_eps,
                                    max_iter=cfg.max_iter)
        self.plan: PartitionPlan = plan_partitions(store, self._n_shards())
        self._rings: Dict[torch.device, StagingRing] = {}

    # ---------------------------------------------------------- topology --

    @property
    def epoch(self) -> int:
        """Exchange epoch = number of KNOWN-dead hosts.  Hosts that
        learn of multiple deaths in different groupings pass through
        different intermediate epochs, but every survivor's gather at
        an epoch that still expects a tombstoned host fails fast — so
        all survivors converge to the same terminal epoch
        (``n_hosts - len(live)``) with the same live set."""
        return self.fleet.n_hosts - len(self.live)

    def _n_shards(self) -> int:
        # more shards than chunks would leave empty combiners — clamp
        # (same rule as bigfcm_fit_store)
        return min(len(self.live) * self.fleet.shards_per_host,
                   self.store.n_chunks)

    def my_shards(self) -> List[int]:
        """Shards owned by this host: round-robin over live ranks —
        pure function of (plan, live set), like everything else."""
        rank = self.live.index(self.host_id)
        return [s for s in range(self.plan.n_shards)
                if s % len(self.live) == rank]

    def my_rows(self) -> int:
        return sum(self.plan.shard_rows[s] for s in self.my_shards())

    def seeds(self) -> np.ndarray:
        """Deterministic driver seeds — identical on every host."""
        return driver_seeds(self.store, self.cfg, device=self.device)

    def _ring(self, dev: torch.device) -> Optional[StagingRing]:
        """This host's staging ring on ``dev`` (None on the CPU)."""
        if dev.type != "cuda":
            return None
        if dev not in self._rings:
            self._rings[dev] = StagingRing(dev)
        return self._rings[dev]

    # --------------------------------------------------------- local fit --

    def _load_shard(self, shard: int) -> Optional[List[np.ndarray]]:
        """Materialize one shard's chunks off the mmap (the prefetch
        body) — None when the shard exceeds the pin budget, in which
        case the fit streams it chunk-by-chunk instead."""
        chunks = self.plan.chunks_of(shard)
        nbytes = sum(self.store.rows[i] for i in chunks) * self.store.dim * 4
        if nbytes > self.fleet.prefetch_bytes:
            return None
        arrs = [np.ascontiguousarray(self.store.chunk(i)) for i in chunks]
        obs.counter("fleet.prefetch.bytes").add(nbytes)
        return arrs

    def local_fit(self, v_init) -> Summary:
        """Fit every owned shard locally → an (S_mine, C, d) summary
        stack on this host's device.  Shard s+1's chunks load on a
        background thread while shard s converges; each shard's compute
        lands on ``devices[j % len(devices)]``."""
        delay = self.fleet.debug_delay_s.get(self.host_id, 0.0)
        if delay:
            time.sleep(delay)
        shards = self.my_shards()
        cfg, rows = self.cfg, self.batch_rows
        if not shards:       # tiny store, more hosts than chunks
            return Summary(
                torch.zeros((0, cfg.n_clusters, self.store.dim),
                            device=self.device),
                torch.zeros((0, cfg.n_clusters), device=self.device))
        locals_: List[Summary] = []
        with obs.span("fleet.local_fit", host=self.host_id), \
                ThreadPoolExecutor(max_workers=1) as ex:
            pending = ex.submit(self._load_shard, shards[0]) \
                if self.fleet.prefetch else None
            for j, s in enumerate(shards):
                arrs = pending.result() if pending is not None else None
                if self.fleet.prefetch and j + 1 < len(shards):
                    pending = ex.submit(self._load_shard, shards[j + 1])
                else:
                    pending = None
                if arrs is not None:
                    factory = lambda arrs=arrs: batched(iter(arrs), rows)
                else:
                    factory = lambda s=s: shard_batches(
                        self.store, self.plan, s, rows)
                dev = self.devices[j % len(self.devices)]
                t0 = time.perf_counter()
                with obs.span("fleet.shard_fit", host=self.host_id,
                              shard=s):
                    loc = ooc_fcm(factory, v_init, m=cfg.m,
                                  eps=cfg.combiner_eps,
                                  max_iter=cfg.max_iter,
                                  backend=self.backend, acc=self.acc,
                                  ring=self._ring(dev), device=dev)
                self.shard_seconds[s] = time.perf_counter() - t0
                locals_.append(Summary(loc.centers.to(self.device),
                                       loc.center_weights.to(self.device)))
        return concat_summaries([Summary(s.centers[None], s.masses[None])
                                 for s in locals_])

    # ----------------------------------------------------------- exchange --

    def exchange(self, stack: Summary) -> Summary:
        """Post my shard-summary stack, gather every live peer's, merge
        pairwise on this host's device — the reduction every host runs
        identically over the identical gathered bytes.  Raises
        `HostLost` (elastic path) or RuntimeError on a partition-plan
        fingerprint mismatch."""
        fp = self.plan.fingerprint()
        frame = encode_summary(stack, wire=self.fleet.wire, fingerprint=fp)
        with obs.span("fleet.exchange", host=self.host_id,
                      epoch=self.epoch):
            self.transport.post(self.epoch, self.host_id, "sum", frame)
            frames = self.transport.gather(
                self.epoch, self.host_id, self.live, "sum",
                self.fleet.gather_timeout_s)
        stacks = []
        for h in sorted(frames):
            s, peer_fp = decode_summary(frames[h])
            if peer_fp != fp:
                raise RuntimeError(
                    f"fleet exchange: host {h} planned fingerprint "
                    f"{peer_fp} but host {self.host_id} planned {fp} — "
                    "hosts are not partitioning the same store")
            stacks.append(s)
        # decoded frames lie on the CPU: the merge runs where its inputs
        # lie, so the gathered stack goes to this host's device first
        gathered = concat_summaries(stacks)
        gathered = Summary(gathered.centers.to(self.device),
                           gathered.masses.to(self.device))
        merged = merge_summaries(gathered, self.merge_plan,
                                 backend=self.backend)
        return merged.summary

    def global_objective(self, centers) -> Tuple[float, int]:
        """Global Eq. (2) of the merged centers: one raw-accumulate pass
        over MY shards, then an all-gather-sum of the (q, rows)
        partials — the fleet version of the fit-store objective pass."""
        q_local, rows_local = 0.0, 0
        with obs.span("fleet.objective", host=self.host_id):
            for s in self.my_shards():
                _, _, q = ooc_accumulate(
                    shard_batches(self.store, self.plan, s,
                                  self.batch_rows),
                    centers, self.cfg.m, acc=self.acc,
                    ring=self._ring(self.device), device=self.device)
                q_local += float(q)
                rows_local += self.plan.shard_rows[s]
            payload = struct.pack(_OBJ_FMT, q_local, rows_local,
                                  self.plan.fingerprint().encode())
            self.transport.post(self.epoch, self.host_id, "obj", payload)
            parts = self.transport.gather(
                self.epoch, self.host_id, self.live, "obj",
                self.fleet.gather_timeout_s)
        q_total, rows_total = 0.0, 0
        fp = self.plan.fingerprint().encode()
        for h in sorted(parts):
            q_h, rows_h, fp_h = struct.unpack(_OBJ_FMT, parts[h])
            if fp_h != fp:
                raise RuntimeError(f"fleet objective: host {h} is on a "
                                   "different partition plan")
            q_total += q_h
            rows_total += rows_h
        return q_total, rows_total

    # ------------------------------------------------------------ elastic --

    def handle_loss(self, lost: Sequence[int]) -> int:
        """Drop dead hosts, replan at the surviving shard count, count
        moved chunks.  Every survivor computes the identical new plan
        (and, for a single loss event, the identical moved count)."""
        if self.host_id in lost:
            raise Evicted(self.host_id)
        self.live = tuple(h for h in self.live if h not in lost)
        if not self.live:
            raise RuntimeError("fleet: no live hosts left")
        self.plan, moved = replan(self.store, self.plan, self._n_shards())
        self.moved_chunks += moved
        obs.counter("fleet.replan.moved_chunks").add(moved)
        obs.event("fleet.replan", host=self.host_id,
                  lost=list(lost), live=list(self.live), moved=moved,
                  n_shards=self.plan.n_shards)
        return moved

    # ---------------------------------------------------------------- run --

    def run(self, v_init=None) -> FleetResult:
        """The whole per-host protocol: fit → exchange → objective, with
        `HostLost` at any gather looping back through `handle_loss`.
        A loss during the objective phase does NOT refit — the merged
        centers are already fleet-global — it only redistributes the
        objective pass over the new plan."""
        v = self.seeds() if v_init is None else v_init
        while True:
            stack = self.local_fit(v)
            try:
                merged = self.exchange(stack)
                break
            except HostLost as e:
                self.handle_loss(e.lost)
        while True:
            try:
                q, n_rows = self.global_objective(merged.centers)
                break
            except HostLost as e:
                self.handle_loss(e.lost)
        obs.event("fleet.fit.done", host=self.host_id, objective=q,
                  epoch=self.epoch, live=list(self.live))
        return FleetResult(centers=_host_f32(merged.centers),
                           masses=_host_f32(merged.masses),
                           objective=q, n_rows=n_rows,
                           host_id=self.host_id, live=self.live,
                           moved_chunks=self.moved_chunks,
                           epoch=self.epoch,
                           shard_seconds=dict(self.shard_seconds))
