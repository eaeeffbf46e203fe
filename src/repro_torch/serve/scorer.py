"""Hot-swappable scorer replicas — the fan-out tier of the serving plane.

Counterpart of `repro.serve.scorer`.  The two-tier serving shape (one
streaming learner, N read-only scorers) needs the read side to follow
the learner's centers without ever blocking or tearing an in-flight
request:

  * `CenterSnapshot` — one immutable, self-describing published model:
    ``(version, centers, weights)`` as host (numpy) arrays.  The center
    count is free to grow and shrink between versions (stream
    birth/death).
  * `Scorer` — a read replica.  ``swap(snapshot)`` uploads the centers
    to the device first and only then makes one attribute store of an
    immutable record; every scoring call reads that reference exactly
    once, so a response is produced against exactly one snapshot version
    and a swap never waits for in-flight work.  Every call scores on the
    current CUDA stream, so work enqueued after a swap's upload sees it.
    ``traces`` counts the distinct (rows, C) input shapes scored — the
    number of programs the reference's jitted scorer compiles.
  * `SnapshotPublisher` — the learner → replicas bus:
    ``model.add_snapshot_listener(publisher.publish)`` pushes every
    ingest's snapshot to all attached scorers and (optionally) persists
    it through an `ft.CheckpointManager`, so replicas in other processes
    boot from the self-describing manifest (`snapshot_from_checkpoint`).
"""
from __future__ import annotations

import threading
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from .. import obs
from ..device import as_real, resolve_device
from ..engine import scoring_backend

__all__ = ["CenterSnapshot", "Scorer", "SnapshotPublisher",
           "snapshot_from_checkpoint"]


class CenterSnapshot(NamedTuple):
    """One published model version: immutable, self-describing."""
    version: int
    centers: np.ndarray               # (C, d) — C may differ per version
    weights: Optional[np.ndarray] = None   # (C,) decayed masses, if known


class _DeviceSnap(NamedTuple):
    """The scorer-internal form: version + device-resident centers.
    Immutable, so one attribute store publishes it atomically."""
    version: int
    centers: torch.Tensor


class Scorer:
    """A read-only scoring replica over a hot-swappable snapshot.

    ``replica`` is the obs label id (`span.serve.assign{replica=...}`);
    ``soft`` selects membership degrees over hard argmin labels;
    ``backend`` names the engine sweep backend whose ``hard_assign`` /
    ``soft_assign`` score (None/"auto" = the device's default,
    `scoring_backend`: no race); ``device`` is where the centers live
    and scoring runs."""

    def __init__(self, snapshot: CenterSnapshot, *, m: float = 2.0,
                 soft: bool = False, backend=None, replica: str = "r0",
                 device: Union[str, torch.device] = "cuda"):
        self.replica = str(replica)
        self.m = float(m)
        self.soft = bool(soft)
        self.device = resolve_device(device)
        self._be = scoring_backend(backend, device=self.device)
        self._lock = threading.Lock()
        self._shapes = set()
        self._snap: Optional[_DeviceSnap] = None
        self.swap(snapshot)

    # -- snapshot following ----------------------------------------------

    def swap(self, snapshot) -> int:
        """Hot-swap to a new snapshot; returns its version.

        Accepts a `CenterSnapshot` or the raw ``(version, centers,
        weights)`` listener signature.  The centers are on the device
        before the one attribute store that publishes them: in-flight
        requests keep the snapshot they already read; the next dispatch
        sees the new one."""
        if not isinstance(snapshot, CenterSnapshot):
            version, centers = snapshot[0], snapshot[1]
        else:
            version, centers = snapshot.version, snapshot.centers
        centers = as_real(np.asarray(centers, np.float32), self.device)
        if centers.dim() != 2:
            raise ValueError(f"centers must be (C, d), got "
                             f"{tuple(centers.shape)}")
        self._snap = _DeviceSnap(int(version), centers)
        return int(version)

    @property
    def version(self) -> int:
        return self._snap.version

    @property
    def dim(self) -> int:
        return int(self._snap.centers.shape[1])

    @property
    def traces(self) -> int:
        """How many distinct (rows, C) shapes this replica has scored —
        the reference's compile count (one program per (bucket rows,
        center count) shape); a regression guard against per-request
        shapes."""
        return len(self._shapes)

    # -- scoring ----------------------------------------------------------

    def read(self) -> _DeviceSnap:
        """The atomic snapshot read — callers that score a padded batch
        themselves (the service workers) take the reference once and use
        its ``centers``/``version`` for the whole batch."""
        return self._snap

    def score(self, x, snap: Optional[_DeviceSnap] = None) -> torch.Tensor:
        """Score ``x`` against ``snap`` (default: the current snapshot)
        on the device.  No padding/instrumentation — the service owns
        batch shaping; this is the raw device call."""
        snap = snap if snap is not None else self._snap
        x = as_real(np.asarray(x, np.float32) if not isinstance(
            x, torch.Tensor) else x, self.device)
        shape = (int(x.shape[0]), int(snap.centers.shape[0]))
        if shape not in self._shapes:
            with self._lock:
                self._shapes.add(shape)
        return (self._be.soft_assign(x, snap.centers, self.m) if self.soft
                else self._be.hard_assign(x, snap.centers))

    def assign(self, x):
        """Convenience single-shot scoring: ``(assignments, version)``
        against exactly one snapshot, as host arrays."""
        snap = self._snap
        n = int(np.shape(x)[0])
        with obs.span("serve.assign", labels={"replica": self.replica},
                      rows=n):
            out = self.score(x, snap).cpu().numpy()
        obs.counter("serve.records", replica=self.replica).add(n)
        return out, snap.version

    def __repr__(self):
        return (f"<Scorer {self.replica} v{self.version} "
                f"C={int(self._snap.centers.shape[0])} soft={self.soft}>")


class SnapshotPublisher:
    """Learner → replicas snapshot bus.

    ``publish(version, centers, weights=None)`` matches the
    `StreamingBigFCM.add_snapshot_listener` signature (also accepts a
    ready `CenterSnapshot` as its single argument); each publish
    hot-swaps every attached scorer and, when a ``ckpt``
    (`ft.CheckpointManager`) is given, persists the snapshot so
    replicas in other processes boot from the manifest."""

    def __init__(self, scorers: Sequence = (), *, ckpt=None):
        self._lock = threading.Lock()
        self._scorers = list(scorers)
        self._ckpt = ckpt
        self._latest: Optional[CenterSnapshot] = None

    def attach(self, scorer) -> None:
        """Add a replica (a `Scorer`, or anything with ``swap`` such as a
        `ScoringService`); it is swapped to the latest snapshot at once
        (a scorer booted from a stale checkpoint catches up here)."""
        with self._lock:
            self._scorers.append(scorer)
            latest = self._latest
        if latest is not None:
            scorer.swap(latest)

    def publish(self, version, centers=None, weights=None) -> CenterSnapshot:
        if isinstance(version, CenterSnapshot):
            snap = version
        else:
            snap = CenterSnapshot(int(version), np.asarray(centers),
                                  None if weights is None
                                  else np.asarray(weights))
        with self._lock:
            self._latest = snap
            scorers = list(self._scorers)
        for s in scorers:
            s.swap(snap)
        if self._ckpt is not None:
            tree = {"centers": snap.centers}
            if snap.weights is not None:
                tree["weights"] = snap.weights
            self._ckpt.save(snap.version, tree)
        obs.counter("serve.snapshots").add(1)
        obs.event("serve.snapshot", version=snap.version,
                  n_centers=int(snap.centers.shape[0]),
                  replicas=len(scorers))
        return snap

    def latest(self) -> Optional[CenterSnapshot]:
        with self._lock:
            return self._latest


def snapshot_from_checkpoint(ckpt, step: Optional[int] = None
                             ) -> CenterSnapshot:
    """Boot a replica snapshot from a persisted checkpoint: the manifest
    self-describes shapes, so a snapshot whose center count grew or
    shrank restores as-is (`CheckpointManager.restore_arrays`, no
    template).  Works against `SnapshotPublisher(ckpt=...)` snapshots
    and a full `StreamingBigFCM.save` state (the ``centers`` /
    ``weights`` leaves are read; the rest is ignored)."""
    step = step if step is not None else ckpt.latest_step()
    if step is None:
        raise FileNotFoundError(f"no snapshots in {ckpt.dir}")
    arrs = ckpt.restore_arrays(step)
    if "centers" not in arrs:
        raise KeyError(f"checkpoint step {step} has no 'centers' leaf "
                       f"(leaves: {sorted(arrs)})")
    return CenterSnapshot(int(step), np.asarray(arrs["centers"]),
                          np.asarray(arrs["weights"])
                          if "weights" in arrs else None)
