"""StreamingBigFCM — the paper's one-job map-reduce generalized to time.

Counterpart of `repro.stream.streaming`.  The batch algorithm's shape
(combiners converge locally, a weighted-FCM reducer merges a few KB of
summaries) is already an online primitive; this module turns it into a
state machine over an unbounded stream:

  ingest(batch):
    1. **event-time gate** (``cfg.event_time``) — records carry event
       times; a watermark trails the max event time seen by
       ``allowed_lateness``.  Records behind the watermark are dropped
       and counted (``late_dropped``); the survivors' summary is routed
       to the ring slot of its event-time *bucket* (`window.assign_slot`)
       and *merges into* any summary already holding the bucket
       (`window.place_summary`: the ``windowed`` plan over two slots).
    2. **drift probe** — fuzzy objective of the current global centers on
       the incoming batch, per unit mass, plus the per-record residual
       (min squared distance) profile (`drift.DriftDetector`).  A bounded
       outlier mass fraction spawns one center from the batch's
       highest-residual records (*cluster birth*); objective drift with
       most of the batch outlying re-runs the paper's driver race
       (`core.bigfcm.run_driver`) to re-seed and zero the window.  A
       center whose merged window mass decays below ``death_mass_floor``
       × the mean center mass is retired (*cluster death*) once it has
       had a full window to accumulate.
    3. **combiner** — per-batch (weighted) FCM from the current centers
       (`core.fcm.fcm`: K2 at the batch shape under ``hopper``), or one
       sweep (``combiner_mode="sweep"``); on a device mesh each rank
       converges on its block and the flat plan merges the gathered
       per-rank summaries, seeded with the current centers (the paper's
       reducer = hierarchy level 1: across devices).
    4. **window** — the batch summary lands in a decayed sliding window
       (arrival cursor or event-time bucket) and the window collapses
       through the merge plan named by ``cfg.merge_plan`` (``windowed``
       by default: K1 at C points per slot per sweep under ``hopper``).

The sweep implementation everywhere is ``cfg.backend`` ("auto":
``hopper`` on a CUDA device, ``torch`` on the CPU).  Where the state
lives: the centers, their masses and the window ring on the model's
device; the counters, the per-slot bucket ids, the per-center ages, the
event clock and the key on the host (CPU tensors), because the state
machine branches on them and reading them there costs no device sync.
Every leaf keeps the reference's name, shape and dtype, so a stream
checkpoint written by either package restores in the other.  The device
leaves take `real_dtype` (float32; float64 only in a reference run that
raises torch's default, on the ``torch`` backend).

**Draws.**  The reference draws the re-seed sample and the driver's
seeds from `jax.random` under ``StreamState.key``.  The port draws both
from ``np.random.default_rng((cfg.seed, reseeds))`` (a documented
divergence; the sample is weighted by mass, so a zero-weight phantom row
is never drawn), unless ``draws=`` injects them:
``draws(x, w, reseeds) -> (sample_idx, seed_idx)``.  ``key`` keeps the
reference's form (``[0, seed]`` at the start) and is carried unchanged
across a re-seed: the port's draws do not read it.

Instrumentation (`repro_torch.obs`, the reference's names): each ingest
is a ``stream.ingest`` span feeding the ``stream.*`` counters (records,
late drops, births, deaths, reseeds) and the ``stream.n_centers`` gauge
from its report, and each window merge a ``stream.window_merge`` span.
The spans read the host clock only: an ingest ends on the host reads its
state machine makes, a merge on its last convergence test.

**On a device mesh** (``mesh=``, `repro_torch.mesh`; one model per
rank, every rank ingesting the same stream) ``ingest`` takes this rank's
``P(data_axes)`` block of each batch, as `stream_loader(mesh=)` yields
it, and every rank ends each ingest holding the same state.  The device
work is split — the probe's objective is added across ranks in rank
order, each rank's combiner runs on its block — while every decision is
taken on gathered values, so that no two ranks take different branches
(and deadlock at the next collective): the residuals, weights and event
times are gathered in row order (the medians, outlier fractions,
watermark and late drops are the global batch's), a birth's candidate
rows and a re-seed's sample rows are gathered (`mesh.gather_rows`), the
draws come from those global weights, and the driver race runs on rank 0
and its centers are broadcast.  ``draws`` then receives a meta tensor of
the global batch's shape in place of ``x``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import (Callable, Iterable, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from .. import obs
from ..core.bigfcm import BigFCMConfig, run_driver
from ..core.fcm import fcm
from ..core.metrics import fuzzy_objective
from ..device import copy_real, real_dtype, resolve_device
from ..engine import MergePlan, Summary, merge_summaries, resolve_backend
from ..engine.backend import pairwise_sqdist
from ..mesh import (agreed_backend, all_gather, block_index, broadcast_first,
                    gather_rows, is_first, mesh_size, psum, rank_device)
from .drift import DriftConfig, DriftDetector
from .window import (advance_window, assign_slot, init_slot_buckets,
                     init_window, place_summary, push_summary, window_mass,
                     window_summary)

Draws = Callable[[torch.Tensor, torch.Tensor, int],
                 Tuple[np.ndarray, np.ndarray]]


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    n_clusters: int
    m: float = 2.0
    combiner_eps: float = 1e-8
    reducer_eps: float = 5e-11
    max_iter: int = 300
    merge_max_iter: int = 200
    window: int = 8                  # sliding-window slots (mini-batches)
    decay: float = 0.9               # per-push exponential forgetting
    merge_plan: str = "windowed"     # window topology: windowed|pairwise|flat
    combiner_mode: str = "converge"  # "converge" | "sweep" (one-pass)
    backend: str = "auto"            # engine sweep backend (torch/hopper/...)
    driver_sample: int = 512         # sample size for (re)seed driver race
    drift: DriftConfig = DriftConfig()
    reseed_cooldown: int = 3         # min batches between structural events
    event_time: bool = False         # bucket slots by event time, not arrival
    slot_span: float = 1.0           # event-time units per window bucket
    allowed_lateness: float = 0.0    # watermark lag behind max event time
    birth_residual_quantile: float = 0.95  # residual quantile seeding a birth
    death_mass_floor: float = 0.0    # retire center below floor×mean mass (0=off)
    max_centers: Optional[int] = None  # birth capacity cap (None: 2×n_clusters)
    seed: int = 0

    def __post_init__(self):
        if self.event_time:
            if self.slot_span <= 0:
                raise ValueError("event_time needs slot_span > 0")
            if self.allowed_lateness < 0:
                raise ValueError("allowed_lateness must be >= 0")
            if self.allowed_lateness > (self.window - 1) * self.slot_span:
                raise ValueError(
                    f"allowed_lateness {self.allowed_lateness} exceeds the "
                    f"ring span ({self.window - 1} x slot_span "
                    f"{self.slot_span}): a slot that old has been recycled; "
                    f"grow `window` or shrink `allowed_lateness`")

    def window_plan(self) -> MergePlan:
        return MergePlan(self.merge_plan, m=self.m, eps=self.reducer_eps,
                         max_iter=self.merge_max_iter)

    def slot_plan(self) -> MergePlan:
        """Late/same-bucket slot merges always go through the engine's
        raw accumulate entry (the ``windowed`` topology)."""
        return MergePlan("windowed", m=self.m, eps=self.reducer_eps,
                         max_iter=self.merge_max_iter)

    def center_cap(self) -> int:
        return (2 * self.n_clusters if self.max_centers is None
                else self.max_centers)


class StreamState(NamedTuple):
    """Checkpointable state — everything a restart needs.  The first four
    leaves lie on the model's device, the rest on the host (CPU)."""
    centers: torch.Tensor       # (C, d) f32 global windowed centers
    weights: torch.Tensor       # (C,) f32 their decayed masses
    win_centers: torch.Tensor   # (W, C, d) f32 ring buffer of summaries
    win_weights: torch.Tensor   # (W, C) f32
    cursor: torch.Tensor        # () i32 next window slot (processing time)
    step: torch.Tensor          # () i32 batches ingested
    since_reseed: torch.Tensor  # () i32 batches since last structural event
    reseeds: torch.Tensor       # () i32 driver re-seed count
    key: torch.Tensor           # (2,) u32 the reference's PRNG key (carried)
    slot_buckets: torch.Tensor  # (W,) i32 event-time bucket of each slot
    ages: torch.Tensor          # (C,) i32 batches since each center was born
    max_event: torch.Tensor     # () f32 max event time seen (watermark anchor)
    late_dropped: torch.Tensor  # () i32 records dropped behind the watermark
    births: torch.Tensor        # () i32 centers spawned from residual mass
    deaths: torch.Tensor        # () i32 centers retired below the mass floor


_DEVICE_LEAVES = ("centers", "weights", "win_centers", "win_weights")
_LEAF_DTYPES = {"key": torch.uint32, "max_event": torch.float32}


class IngestReport(NamedTuple):
    step: int
    drifted: bool
    reseeded: bool
    reason: str               # "" | "objective" | "shift"
    objective_pre: float      # stale-center objective per unit mass
    objective_post: float     # merged-center objective per unit mass
    shift: float              # max per-center L2 move of the global model
    combiner_iters: np.ndarray
    mass: float               # decayed record mass in the window
    watermark: float = float("-inf")  # event-time watermark (−inf: no event time)
    late_dropped: int = 0     # records of THIS batch dropped as too late
    born: int = 0             # centers spawned this batch
    died: int = 0             # centers retired this batch
    n_centers: int = 0        # live center count after this batch


def _i32(v) -> torch.Tensor:
    return torch.tensor(int(v), dtype=torch.int32)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _q_norm(x, w, centers, *, m):
    """Fuzzy objective per unit record mass (the drift statistic)."""
    q = fuzzy_objective(x, centers, m, point_weights=w)
    return q / torch.clamp(torch.sum(w), min=1e-12)


def _residuals(x, centers):
    """Per-record min squared distance to the centers — the soft-assign
    residual profile the birth rule reads."""
    return torch.min(pairwise_sqdist(x, centers), dim=-1).values


class _Batch(NamedTuple):
    """One ingest's batch as this rank holds it: ``x`` (n_l, d) and ``w``
    (n_l,) on the device — the whole batch on one device, the rank's
    block on a mesh — and what the decisions read, for the global batch:
    the weights on the host, the global row of ``x``'s first row, and the
    global row count."""
    x: torch.Tensor
    w: torch.Tensor
    w_np: np.ndarray
    lo: int
    n: int


def _np_dtype(a) -> np.dtype:
    if isinstance(a, torch.Tensor):
        return torch.empty((), dtype=a.dtype).numpy().dtype
    return np.asarray(a).dtype


def split_item(item, *, event_time: bool):
    """One stream item as ``(x, w, ts)``: an ``x`` array alone, or a tuple
    — ``(x, ts)`` under ``event_time`` (timestamped sources), ``(x, w)``
    otherwise (weighted loaders such as `stream_loader`).  A second
    channel of the wrong kind raises: integer labels from a synth
    generator, or float64 event times into a processing-time model."""
    if not isinstance(item, tuple):
        return item, None, None
    x, second = item
    dtype = None if second is None else _np_dtype(second)
    if event_time:
        if dtype is not None and np.issubdtype(dtype, np.integer):
            raise ValueError(
                "run() got an (x, integer-array) tuple under "
                "event_time — that looks like (records, "
                "labels) from a synth generator, not "
                "(records, event times); stamp the stream "
                "(e.g. data.stamp_source) instead")
        return x, None, second
    if dtype == np.float64:
        raise ValueError(
            "run() got an (x, float64-array) tuple — "
            "that is the timestamped-source shape "
            "(records, event times), but this model has "
            "event_time=False; enable "
            "StreamConfig.event_time or pass float32 "
            "point weights")
    if dtype is not None and np.issubdtype(dtype, np.integer):
        raise ValueError(
            "run() got an (x, integer-array) tuple — that "
            "looks like (records, labels) from a synth "
            "generator, not (records, point weights); pass "
            "x alone or float weights")
    return x, second, None


class StreamingBigFCM:
    """Online/windowed BigFCM over an unbounded chunk stream, on one
    device (default ``"cuda"``) or on a device mesh (module note; the
    rank's device, ``device`` not read)."""

    def __init__(self, cfg: StreamConfig, *, mesh=None,
                 data_axes: Sequence[str] = ("data",),
                 draws: Optional[Draws] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.cfg = cfg
        self.mesh = mesh
        self.data_axes = tuple(data_axes)
        # the collectives run on a mesh of several ranks only
        self._mesh = mesh if mesh is not None and mesh_size(mesh) > 1 \
            else None
        self.device = (rank_device(mesh) if mesh is not None
                       else resolve_device(device))
        self.draws = draws
        self.state: Optional[StreamState] = None
        self.detector = DriftDetector(cfg.drift)
        self._snapshot_listeners: list = []
        self.backend = (
            agreed_backend(cfg.backend, self._mesh) if self._mesh is not None
            else resolve_backend(cfg.backend, device=self.device))
        # Driver config for (re)seeding: the paper's FCM-vs-WFCMPB race.
        self._bcfg = BigFCMConfig(
            n_clusters=cfg.n_clusters, m=cfg.m, driver_eps=cfg.reducer_eps,
            combiner_eps=cfg.combiner_eps, reducer_eps=cfg.reducer_eps,
            max_iter=cfg.max_iter, sample_size=cfg.driver_sample,
            backend=cfg.backend, seed=cfg.seed)
        self._plan = cfg.window_plan()

    # ------------------------------------------------------------- seed --
    def _rows(self, b: _Batch, idx) -> torch.Tensor:
        """Global rows ``idx`` of the batch, on the device (gathered from
        the ranks that hold them, on a mesh)."""
        if self._mesh is not None:
            return gather_rows(b.x, idx, self._mesh, self.data_axes)
        return b.x[torch.as_tensor(np.asarray(idx, np.int64),
                                   device=b.x.device)]

    def _driver_seed(self, b: _Batch, reseeds: int) -> torch.Tensor:
        """Run the paper's driver race on a sample of the batch → C seeds.

        The sample is drawn by mass, without replacement, so zero-weight
        phantom rows (loader tail padding) can never become seeds; its
        size is capped by the number of real rows.  On a mesh the race
        runs on rank 0 and its centers are broadcast."""
        n_real = int(np.count_nonzero(b.w_np > 0))
        if n_real == 0:
            raise ValueError("cannot seed StreamingBigFCM from a "
                             "zero-mass (all-phantom) batch")
        if self.draws is not None:
            x_arg, w_arg = b.x, b.w
            if self._mesh is not None:
                x_arg = torch.empty((b.n, b.x.shape[1]), device="meta")
                w_arg = torch.from_numpy(b.w_np)
            sample_idx, seed_idx = self.draws(x_arg, w_arg, reseeds)
        else:
            lam = min(self.cfg.driver_sample, n_real)
            rng = np.random.default_rng((self.cfg.seed, reseeds))
            p = b.w_np.astype(np.float64)
            sample_idx = rng.choice(b.n, lam, replace=False, p=p / p.sum())
            seed_idx = rng.choice(lam, self.cfg.n_clusters, replace=False)
        x_sample = self._rows(b, sample_idx)
        if self._mesh is None:
            return run_driver(x_sample, self._bcfg, seed_idx=seed_idx,
                              device=self.device)[0]
        v = x_sample.new_empty((self.cfg.n_clusters, x_sample.shape[1]))
        if is_first(self._mesh):
            v = run_driver(x_sample, self._bcfg, seed_idx=seed_idx,
                           device=self.device)[0].contiguous()
        return broadcast_first(v, self._mesh)

    def _fresh_state(self, b: _Batch, reseeds: int, step: int,
                     carry: Optional[StreamState] = None) -> StreamState:
        """(Re)seeded state.  ``carry`` preserves the monotone stream
        metrics (event clock, late/birth/death counters) and the key
        across a re-seed — the stale regime's *window* is forgotten,
        time is not."""
        centers = self._driver_seed(b, reseeds)
        c, d = centers.shape
        win_c, win_w = init_window(self.cfg.window, c, d,
                                   device=self.device)
        # jax.random.PRNGKey(seed)'s raw uint32 pair, then carried
        key = (torch.tensor([self.cfg.seed >> 32, self.cfg.seed & 0xFFFFFFFF],
                            dtype=torch.uint32)
               if carry is None else carry.key)
        return StreamState(
            centers=centers,
            weights=centers.new_zeros((c,)),
            win_centers=win_c, win_weights=win_w,
            cursor=_i32(0), step=_i32(step), since_reseed=_i32(0),
            reseeds=_i32(reseeds),
            key=key,
            slot_buckets=init_slot_buckets(self.cfg.window),
            ages=torch.zeros((c,), dtype=torch.int32),
            max_event=(torch.tensor(-math.inf, dtype=torch.float32)
                       if carry is None else carry.max_event),
            late_dropped=_i32(0) if carry is None else carry.late_dropped,
            births=_i32(0) if carry is None else carry.births,
            deaths=_i32(0) if carry is None else carry.deaths)

    # ------------------------------------------------------ birth/death --
    def _spawn_center(self, st: StreamState, b: _Batch, resid: np.ndarray
                      ) -> StreamState:
        """Cluster birth: one new center at the weighted centroid of the
        batch's highest-residual records (above
        ``birth_residual_quantile``); its window rows start phantom and
        fill as batches arrive."""
        real = b.w_np > 0
        k = float(np.quantile(resid[real], self.cfg.birth_residual_quantile))
        cand = np.flatnonzero((resid >= k) & real)
        x_cand = _host(self._rows(b, cand))
        new_c = torch.from_numpy(np.average(
            x_cand, axis=0, weights=b.w_np[cand]).astype(x_cand.dtype)).to(
                self.device)
        wnd = st.win_centers.shape[0]
        zero = new_c.new_zeros((1,))
        return st._replace(
            centers=torch.cat([st.centers, new_c[None]]),
            weights=torch.cat([st.weights, zero]),
            win_centers=torch.cat(
                [st.win_centers, new_c.expand(wnd, 1, -1)], dim=1),
            win_weights=torch.cat(
                [st.win_weights, zero.expand(wnd, 1)], dim=1),
            ages=torch.cat([st.ages, torch.zeros((1,), dtype=torch.int32)]),
            births=st.births + 1)

    # ------------------------------------------------------- event time --
    def _event_place(self, st_in: StreamState, sc, sw, t_batch: float,
                     wm: float, new_max: float):
        """Route one batch summary to its event-time slot.  Returns
        (win_c, win_w, slot_buckets, placed)."""
        cfg = self.cfg
        bucket, slot, late = assign_slot(t_batch, wm,
                                         slot_span=cfg.slot_span,
                                         window=cfg.window)
        win_c, win_w, sb = (st_in.win_centers, st_in.win_weights,
                            st_in.slot_buckets)
        old_max = float(st_in.max_event)
        head_new = int(math.floor(new_max / cfg.slot_span))
        head_old = (head_new if not math.isfinite(old_max)
                    else int(math.floor(old_max / cfg.slot_span)))
        if head_new > head_old:
            win_w = advance_window(win_w, sb, head_old, head_new,
                                   decay=cfg.decay)
        held = int(sb[slot])
        if late or held > bucket:
            # behind the watermark, or the ring position is already
            # owned by a NEWER bucket (recycled): drop it.  A slot
            # holding an OLDER bucket id is stale — `advance_window`
            # zeroed its mass when it fell out of the W-bucket span —
            # and is simply overwritten.
            return win_c, win_w, sb, False
        scale = float(cfg.decay) ** max(head_new - bucket, 0)
        win_c, win_w, sb = place_summary(
            win_c, win_w, sb, slot, bucket, sc, sw,
            plan=cfg.slot_plan(), backend=self.backend, scale=scale)
        return win_c, win_w, sb, True

    # ------------------------------------------------- the three stages --
    def _q(self, b: _Batch, centers) -> float:
        """The centers' objective per unit mass on the batch (the drift
        statistic); on a mesh the numerator and the mass are each added
        across ranks in rank order."""
        if self._mesh is None:
            return float(_q_norm(b.x, b.w, centers, m=self.cfg.m))
        parts = torch.stack([
            fuzzy_objective(b.x, centers, self.cfg.m, point_weights=b.w),
            torch.sum(b.w)])
        q, mass = psum(parts, self._mesh, self.data_axes)
        return float(q / torch.clamp(mass, min=1e-12))

    def _probe(self, b: _Batch, centers) -> Tuple[float, np.ndarray]:
        """The drift probe: the stale centers' objective per unit mass on
        the batch, and the per-record residual profile (on the host; the
        global batch's, in row order, on a mesh)."""
        resid = _residuals(b.x, centers)
        if self._mesh is not None:
            resid = all_gather(resid, self._mesh, self.data_axes).flatten()
        return self._q(b, centers), _host(resid)

    def _combine(self, b: _Batch, centers):
        """One batch summary: local FCM to convergence, or a single
        accumulate sweep (``combiner_mode="sweep"`` — the cheapest online
        mode, one pass per batch); on a mesh, each rank's summary of its
        block, gathered and merged by the flat plan seeded with
        ``centers``.  Returns (centers, masses, sweeps per combiner)."""
        if self.cfg.combiner_mode == "sweep":
            v, wi, _ = self.backend.sweep(b.x, b.w, centers, self.cfg.m)
            it = 1
        else:
            res = fcm(b.x, centers, m=self.cfg.m, eps=self.cfg.combiner_eps,
                      max_iter=self.cfg.max_iter, point_weights=b.w,
                      backend=self.backend, device=self.device)
            v, wi, it = res.centers, res.center_weights, res.n_iter
        if self._mesh is None:
            return v, wi, [it]
        mesh, axes = self._mesh, self.data_axes
        gathered = Summary(all_gather(v, mesh, axes),
                           all_gather(wi, mesh, axes))
        plan = MergePlan("flat", m=self.cfg.m, eps=self.cfg.reducer_eps,
                         max_iter=self.cfg.merge_max_iter)
        red = merge_summaries(gathered, plan, backend=self.backend,
                              init=centers)
        its = all_gather(torch.tensor(it, device=self.device), mesh, axes)
        return red.summary.centers, red.summary.masses, its.tolist()

    def _window_merge(self, win_c, win_w):
        """Collapse the window through ``cfg.merge_plan``."""
        res = merge_summaries(window_summary(win_c, win_w), self._plan,
                              backend=self.backend)
        return res.summary.centers, res.summary.masses

    # ----------------------------------------------------------- ingest --
    def _global(self, a: np.ndarray) -> np.ndarray:
        """The global batch's values of a per-row host array (this rank's
        rows on a mesh: gathered in row order)."""
        if self._mesh is None:
            return a
        return _host(all_gather(torch.from_numpy(np.ascontiguousarray(a)),
                                self._mesh, self.data_axes).flatten())

    def ingest(self, x, w=None, *, ts=None) -> IngestReport:
        """Fold one mini-batch into the windowed model.

        ``x`` (n, d) and ``w`` (n,) are arrays or tensors (a loader's
        device batch is used in place); ``ts`` ((n,) per-record event
        times) is consulted only under ``cfg.event_time``; without it
        each batch is stamped with its arrival step (event order ==
        arrival order).  Each call is a ``stream.ingest`` span, and the
        returned report feeds the ``stream.*`` counters; ``stream.records``
        counts the batch's records, its rows of nonzero weight (a
        loader's phantom padding is none)."""
        with obs.span("stream.ingest", rows=len(x)):
            rep, records = self._ingest(x, w, ts=ts)
        obs.counter("stream.records").add(records)
        if rep.late_dropped:
            obs.counter("stream.late_dropped").add(rep.late_dropped)
        if rep.born:
            obs.counter("stream.births").add(rep.born)
        if rep.died:
            obs.counter("stream.deaths").add(rep.died)
        if rep.reseeded:
            obs.counter("stream.reseeds").add(1)
        obs.gauge("stream.n_centers").set(rep.n_centers)
        if self._snapshot_listeners:
            self._publish_snapshot()
        return rep

    # ---------------------------------------------------- serve snapshots --
    def add_snapshot_listener(self, fn) -> None:
        """Register ``fn(version, centers, weights)`` to run after every
        ingest with a host copy of the freshest windowed model (numpy
        arrays).  ``version`` is the stream step, monotone across
        re-seeds; ``centers`` may grow/shrink between calls
        (birth/death)."""
        self._snapshot_listeners.append(fn)

    def _publish_snapshot(self) -> None:
        st = self.state
        version = int(st.step)
        centers = _host(st.centers)
        weights = _host(st.weights)
        for fn in self._snapshot_listeners:
            fn(version, centers, weights)

    def _ingest(self, x, w=None, *, ts=None):
        """One ingest; returns (report, the batch's rows of nonzero
        weight)."""
        x = copy_real(x, self.device)
        w = (x.new_ones((x.shape[0],)) if w is None
             else copy_real(w, self.device))
        lo = (0 if self._mesh is None else
              block_index(self._mesh, self.data_axes)[0] * x.shape[0])
        w_np = self._global(_host(w))
        b = _Batch(x, w, w_np, lo, w_np.shape[0])
        records = int(np.count_nonzero(w_np))
        if self.state is None:
            self.state = self._fresh_state(b, reseeds=0, step=0)
        st = self.state
        cfg = self.cfg

        # ---- event-time gate: watermark + late-record drops ----
        wm, wm_gate, n_late, t_batch = float("-inf"), float("-inf"), 0, None
        max_event = st.max_event
        if cfg.event_time:
            ts_np = (np.full((x.shape[0],), float(st.step), np.float64)
                     if ts is None
                     else np.asarray(ts, np.float64).reshape(-1))
            if ts_np.shape[0] != x.shape[0]:
                raise ValueError(f"ts length {ts_np.shape[0]} != batch "
                                 f"rows {x.shape[0]}")
            ts_np = self._global(ts_np)
            real = w_np > 0
            # gate against the watermark as of BEFORE this batch — a
            # record is late only if the clock had already passed it
            # when it arrived, never relative to its own batch-mates
            old_max = float(st.max_event)
            wm_gate = (float("-inf") if not math.isfinite(old_max)
                       else old_max - cfg.allowed_lateness)
            new_max = old_max
            if real.any():
                new_max = max(new_max, float(ts_np[real].max()))
            wm = new_max - cfg.allowed_lateness   # post-batch watermark
            late = (ts_np < wm_gate) & real
            n_late = int(late.sum())
            if n_late:
                mine = late[lo:lo + x.shape[0]]
                w = torch.where(torch.from_numpy(mine).to(self.device),
                                0.0, w)
                w_np = np.where(late, w_np.dtype.type(0), w_np)
                b = b._replace(w=w, w_np=w_np)
                real = real & ~late
            max_event = torch.tensor(new_max, dtype=torch.float32)
            if not real.any():
                # the whole batch is behind the watermark: count + skip
                self.state = st._replace(
                    step=st.step + 1, since_reseed=st.since_reseed + 1,
                    ages=st.ages + 1, max_event=max_event,
                    late_dropped=st.late_dropped + n_late)
                return IngestReport(
                    step=int(self.state.step), drifted=False,
                    reseeded=False, reason="",
                    objective_pre=float("nan"),
                    objective_post=float("nan"), shift=0.0,
                    combiner_iters=np.zeros((1,), np.int32),
                    mass=float(window_mass(st.win_weights)),
                    watermark=wm, late_dropped=n_late,
                    n_centers=int(st.centers.shape[0])), records
            t_batch = float(np.median(ts_np[real]))

        # ---- drift probe: objective + residual profile ----
        q_pre, resid = self._probe(b, st.centers)
        real = w_np > 0
        resid_med = float(np.median(resid[real]))
        thr = self.detector.outlier_threshold()
        out_frac = 0.0
        if thr is not None:
            w_tot = float(w_np[real].sum())
            out_frac = float(w_np[(resid > thr) & real].sum()
                             / max(w_tot, 1e-12))

        dcfg = self.detector.cfg
        can_event = int(st.since_reseed) >= cfg.reseed_cooldown
        drifted, reason, born, died = False, "", 0, 0
        if (can_event and self.detector.objective_drifted(q_pre)
                and (thr is None or out_frac > dcfg.reseed_frac)):
            # global regime change: the paper's driver re-seed
            drifted, reason = True, "objective"
            st = self._fresh_state(b, int(st.reseeds) + 1,
                                   int(st.step), carry=st)
            self.detector.reset()
        elif (can_event and thr is not None
                and out_frac >= dcfg.birth_min_frac
                and st.centers.shape[0] < cfg.center_cap()):
            # partial regime change: spawn a center, forget nothing
            born = 1
            st = self._spawn_center(st, b, resid)

        def fold(st_in):
            sc, sw, iters = self._combine(b, st_in.centers)
            if cfg.event_time:
                wc, ww, sb, placed = self._event_place(
                    st_in, sc, sw, t_batch, wm_gate, float(max_event))
                cur = st_in.cursor
            else:
                wc, ww, cur = push_summary(st_in.win_centers,
                                           st_in.win_weights, st_in.cursor,
                                           sc, sw, decay=cfg.decay)
                sb, placed = st_in.slot_buckets, True
            with obs.span("stream.window_merge"):
                mc, mw = self._window_merge(wc, ww)
            sh = float(torch.max(torch.linalg.vector_norm(
                mc - st_in.centers, dim=-1)))
            return wc, ww, cur, sb, mc, mw, sh, iters, placed

        (win_c, win_w, cursor, slot_b,
         merged_c, merged_w, shift, iters, placed) = fold(st)
        if (not drifted and not born and can_event
                and self.detector.shift_drifted(shift)):
            drifted, reason = True, "shift"
            st = self._fresh_state(b, int(st.reseeds) + 1,
                                   int(st.step), carry=st)
            self.detector.reset()
            (win_c, win_w, cursor, slot_b,
             merged_c, merged_w, shift, iters, placed) = fold(st)
        if not placed:
            # the summary's slot was recycled before it could land (a
            # batch straddling more than the ring span): its records
            # were discarded — count them with the late drops
            n_late += int(np.count_nonzero(w_np > 0))

        # ---- cluster death: retire one starved center per batch ----
        ages = st.ages + 1
        if (cfg.death_mass_floor > 0 and not drifted and not born
                and merged_c.shape[0] > 2):
            mw_np = _host(merged_w)
            ages_np = ages.numpy()
            floor = cfg.death_mass_floor * mw_np.sum() / mw_np.shape[0]
            starving = (mw_np < floor) & (ages_np >= cfg.window)
            if starving.any():
                idx = int(np.argmin(np.where(starving, mw_np, np.inf)))
                died = 1
                keep = torch.from_numpy(np.delete(np.arange(mw_np.shape[0]),
                                                  idx))
                keep_dev = keep.to(self.device)
                merged_c = merged_c[keep_dev]
                merged_w = merged_w[keep_dev]
                win_c = win_c[:, keep_dev]
                win_w = win_w[:, keep_dev]
                ages = ages[keep]

        q_post = self._q(b, merged_c)
        self.detector.observe(q_pre, shift, drifted or bool(born),
                              resid_med)
        self.state = StreamState(
            centers=merged_c, weights=merged_w,
            win_centers=win_c, win_weights=win_w, cursor=cursor,
            step=st.step + 1,
            since_reseed=(_i32(1) if (drifted or born or died)
                          else st.since_reseed + 1),
            reseeds=st.reseeds, key=st.key,
            slot_buckets=slot_b, ages=ages, max_event=max_event,
            late_dropped=st.late_dropped + n_late,
            births=st.births, deaths=st.deaths + died)
        return IngestReport(
            step=int(self.state.step), drifted=drifted, reseeded=drifted,
            reason=reason, objective_pre=q_pre, objective_post=q_post,
            shift=shift, combiner_iters=np.array(iters, np.int32),
            mass=float(window_mass(win_w)), watermark=wm,
            late_dropped=n_late, born=born, died=died,
            n_centers=int(merged_c.shape[0])), records

    def run(self, batches: Iterable, *, on_report=None):
        """Drive ingest over a loader/source.  Items are ``x`` arrays or
        tuples — ``(x, ts)`` under ``cfg.event_time`` (timestamped
        sources), ``(x, w)`` otherwise (weighted loaders); see
        `split_item`."""
        reports = []
        for item in batches:
            x, w, ts = split_item(item, event_time=self.cfg.event_time)
            rep = self.ingest(x, w, ts=ts)
            reports.append(rep)
            if on_report is not None:
                on_report(rep)
        return reports

    # ------------------------------------------------------------ serve --
    def assign(self, x, *, soft: bool = False) -> torch.Tensor:
        """Assignments of ``x`` against the live windowed centers, on the
        model's device: hard labels (n,) or soft memberships (n, C)."""
        if self.state is None:
            raise RuntimeError("StreamingBigFCM has ingested no data yet")
        x = copy_real(x, self.device)
        if soft:
            return self.backend.soft_assign(x, self.state.centers,
                                            self.cfg.m)
        return self.backend.hard_assign(x, self.state.centers)

    # ------------------------------------------------------- checkpoint --
    def state_dict(self) -> dict:
        """The reference's flat state tree: every `StreamState` leaf plus
        the detector's as ``drift_*``."""
        if self.state is None:
            raise RuntimeError("no state to checkpoint yet")
        tree = dict(self.state._asdict())
        for k, v in self.detector.state_arrays().items():
            tree[f"drift_{k}"] = v
        return tree

    def load_state_arrays(self, tree: dict) -> None:
        """Take the state and detector of a `state_dict` tree — this
        package's or the reference's (numpy, jax or torch leaves): device
        leaves are copied onto the model's device in `real_dtype`, the
        rest onto the host in the reference's dtype."""
        self.detector.load_state_arrays(
            {k[len("drift_"):]: v for k, v in tree.items()
             if k.startswith("drift_")})
        leaves = {}
        for f in StreamState._fields:
            v = tree[f]
            dev = self.device if f in _DEVICE_LEAVES else torch.device("cpu")
            dtype = (real_dtype() if f in _DEVICE_LEAVES
                     else _LEAF_DTYPES.get(f, torch.int32))
            if isinstance(v, torch.Tensor):
                leaves[f] = v.detach().to(dev, dtype, copy=True)
            else:
                leaves[f] = torch.tensor(np.asarray(v), dtype=dtype,
                                         device=dev)
        self.state = StreamState(**leaves)

    @classmethod
    def from_state_arrays(cls, cfg: StreamConfig, tree: dict, *, mesh=None,
                          data_axes: Sequence[str] = ("data",),
                          draws: Optional[Draws] = None,
                          device: Union[str, torch.device] = "cuda"
                          ) -> "StreamingBigFCM":
        """A model on ``device`` (or ``mesh``) holding the state of
        ``tree`` (a `state_dict`, e.g.
        `repro.stream.StreamingBigFCM.state_dict()` as numpy arrays) —
        how the parity tests start both packages from one state."""
        model = cls(cfg, mesh=mesh, data_axes=data_axes, draws=draws,
                    device=device)
        model.load_state_arrays(tree)
        return model

    def save(self, ckpt) -> None:
        """Persist into a `repro_torch.ft.CheckpointManager`."""
        if self.state is None:
            raise RuntimeError("no state to checkpoint yet")
        ckpt.save(int(self.state.step), self.state_dict())

    @classmethod
    def restore(cls, ckpt, cfg: StreamConfig, d: int, *, mesh=None,
                data_axes: Sequence[str] = ("data",),
                step: Optional[int] = None, draws: Optional[Draws] = None,
                device: Union[str, torch.device] = "cuda"
                ) -> "StreamingBigFCM":
        """Rebuild a live stream from a checkpoint (d = feature count) —
        one written by either package, onto one device or ``mesh`` (every
        rank restores the same replicated state).  The center count is
        read off the manifest (birth and death change it)."""
        tree = ckpt.restore_arrays(step)
        got = tuple(tree["centers"].shape)
        if len(got) != 2 or got[1] != d:
            raise ValueError(f"checkpoint centers have shape {got}, "
                             f"expected (C, {d})")
        return cls.from_state_arrays(cfg, tree, mesh=mesh,
                                     data_axes=data_axes, draws=draws,
                                     device=device)
