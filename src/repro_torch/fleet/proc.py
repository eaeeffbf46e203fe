"""Multi-process fleet — one OS process per host over a shared store.

Counterpart of `repro.fleet.proc`, an own copy.  The real-host article
of `repro_torch.fleet.sim`: each host is a **spawned** process (fresh
interpreter, its own CUDA context on ``device`` — nothing is shared but
the filesystem), opening the same on-disk `ChunkStore` read-only
and exchanging summary frames through a `DirTransport` mailbox
directory.  The parent is the job tracker's death-watch only: it never
touches data — it watches child exit codes and drops a tombstone for
any host that dies abnormally, which is what unblocks the survivors'
gathers into the elastic replan path.  Results are published
atomically per host (``result.h<id>.npz``), so the parent reads a
complete file or none.

A spawned host inherits the parent's environment: ``REPRO_CALIB_DIR``
(so it launches on the parent's tuned plans, and agrees bit for bit with
a threaded fleet of the same shape) and the kernel build directory,
whose libraries a host loads at its first launch (building one only if
the parent has not).

This is also the honest statement of the simulated-vs-real boundary:
`sim.fleet_fit` and `run_fleet` drive the IDENTICAL `FleetHost`
protocol; only the transport (condvar vs files) and the failure
injector (thread exception vs SIGKILL) differ.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import time
from typing import Dict, Optional

import numpy as np

from .. import obs
from ..core.bigfcm import BigFCMConfig
from ..data.cache import ChunkStore
from ..device import resolve_device
from .host import FleetConfig, FleetHost
from .transport import DirTransport, Evicted

MAIL_DIR = "mail"
_RESULT_FMT = "result.h{:04d}.npz"


def host_main(host_id: int, n_hosts: int, store_dir: str, fleet_dir: str,
              cfg_kw: dict, fleet_kw: dict, device: str = "cuda") -> None:
    """Entry point of one spawned host process (top-level, picklable).

    ``cfg_kw``/``fleet_kw`` are plain-dict kwargs for `BigFCMConfig` /
    `FleetConfig` — primitives only, so spawn never pickles live torch
    state across the process boundary; ``device`` is a device string."""
    store = ChunkStore.open(store_dir)
    cfg = BigFCMConfig(**cfg_kw)
    fleet = FleetConfig(n_hosts=n_hosts, **fleet_kw)
    transport = DirTransport(os.path.join(fleet_dir, MAIL_DIR))
    host = FleetHost(host_id, store, cfg, fleet, transport, device=device)
    try:
        res = host.run()
    except Evicted:
        return                       # speculative copy lost the race
    final = os.path.join(fleet_dir, _RESULT_FMT.format(host_id))
    tmp = final + ".tmp"
    np.savez(tmp, centers=res.centers, masses=res.masses,
             objective=np.float64(res.objective),
             n_rows=np.int64(res.n_rows),
             live=np.asarray(res.live, np.int64),
             moved_chunks=np.int64(res.moved_chunks),
             epoch=np.int64(res.epoch),
             obs_moved=np.float64(
                 obs.counter("fleet.replan.moved_chunks").value))
    os.replace(tmp + ".npz", final)


def spawn_fleet(n_hosts: int, store_dir: str, fleet_dir: str,
                cfg_kw: dict, fleet_kw: dict, *, device: str = "cuda"
                ) -> Dict[int, mp.Process]:
    """Start one spawned process per host, each on ``device`` (checked
    here first: asking for the card without one raises before anything
    is spawned); returns host id → Process."""
    device = str(resolve_device(device))
    ctx = mp.get_context("spawn")
    os.makedirs(os.path.join(fleet_dir, MAIL_DIR), exist_ok=True)
    procs = {}
    for h in range(n_hosts):
        p = ctx.Process(target=host_main,
                        args=(h, n_hosts, store_dir, fleet_dir,
                              cfg_kw, fleet_kw, device),
                        name=f"fleet-host-{h}")
        p.start()
        procs[h] = p
    return procs


def watch_fleet(procs: Dict[int, mp.Process], fleet_dir: str, *,
                timeout_s: float = 600.0, poll_s: float = 0.1) -> None:
    """The parent's death-watch: tombstone any host whose process exits
    abnormally (non-zero / signaled), so survivor gathers fail over to
    replan immediately instead of waiting out the backstop.  Returns
    when every process has exited."""
    transport = DirTransport(os.path.join(fleet_dir, MAIL_DIR))
    deadline = time.monotonic() + timeout_s
    tombstoned = set()
    while True:
        alive = False
        for h, p in procs.items():
            if p.is_alive():
                alive = True
            elif p.exitcode not in (0, None) and h not in tombstoned:
                transport.mark_dead(h)
                tombstoned.add(h)
        if not alive:
            return
        if time.monotonic() > deadline:
            raise TimeoutError(f"fleet processes still alive after "
                               f"{timeout_s}s")
        time.sleep(poll_s)


def collect_results(fleet_dir: str, n_hosts: int) -> Dict[int, dict]:
    """Read every atomically-published per-host result."""
    out = {}
    for h in range(n_hosts):
        path = os.path.join(fleet_dir, _RESULT_FMT.format(h))
        if os.path.exists(path):
            with np.load(path) as z:
                out[h] = {k: z[k] for k in z.files}
    return out


def run_fleet(n_hosts: int, store_dir: str, fleet_dir: str, *,
              cfg_kw: dict, fleet_kw: Optional[dict] = None,
              timeout_s: float = 600.0, device: str = "cuda") -> dict:
    """Spawn + watch + collect; returns the lowest surviving host's
    result dict (survivors agree bit-for-bit — see `sim.fleet_fit`)."""
    procs = spawn_fleet(n_hosts, store_dir, fleet_dir, cfg_kw,
                        fleet_kw or {}, device=device)
    try:
        watch_fleet(procs, fleet_dir, timeout_s=timeout_s)
    finally:
        for p in procs.values():
            if p.is_alive():
                p.terminate()
    results = collect_results(fleet_dir, n_hosts)
    if not results:
        raise RuntimeError("fleet: no host published a result")
    return results[min(results)]
