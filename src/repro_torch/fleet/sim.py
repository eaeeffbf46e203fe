"""Simulated fleet — N `FleetHost` peers as threads of one process.

Counterpart of `repro.fleet.sim`, an own copy.  On the card every host
thread enqueues on its current stream, the shared default stream, so
their kernels run in the order they were launched; the kernel wrappers'
launch counts are kept under a lock, so they stay exact across threads.

`fleet_fit` is the in-process harness every fast test and bench runs
through: real protocol, real transport (an in-memory mailbox), real
elastic behavior — only the process boundary is simulated.  The
multiprocess article is `repro_torch.fleet.proc`; the two share ALL host
code, so the seconds-scale simulated suite pins the same logic the
slow subprocess acceptance exercises.

The driver doubles as the straggler watcher (the job-tracker role):
it observes first-epoch summary posts through the transport, derives
its own copy of the partition plan (pure function — the watcher needs
no messages either) to normalize elapsed time by assigned ROWS, and
tombstones hosts whose per-row rate falls `straggler_factor`× behind
the median finished host — speculative-execution semantics: the
survivors replan and re-cover the straggler's shards; if the straggler
ever wakes, its next post raises `Evicted` and it unwinds.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from .. import obs
from ..core.bigfcm import BigFCMConfig
from ..data.cache import ChunkStore
from ..data.plane import plan_partitions
from ..device import resolve_device
from ..ft.elastic import detect_stragglers

from .host import FleetConfig, FleetHost, FleetResult
from .transport import Evicted, MailboxTransport


def _host_rows(store: ChunkStore, fleet: FleetConfig) -> Dict[int, int]:
    """Row load per host under the epoch-0 plan — the watcher's own
    zero-coordination derivation (round-robin ranks, like the hosts)."""
    n_shards = min(fleet.n_hosts * fleet.shards_per_host, store.n_chunks)
    plan = plan_partitions(store, n_shards)
    rows = {h: 0 for h in range(fleet.n_hosts)}
    for s in range(plan.n_shards):
        rows[s % fleet.n_hosts] += plan.shard_rows[s]
    return rows


def fleet_fit(
    store: ChunkStore,
    cfg: BigFCMConfig,
    fleet: FleetConfig,
    *,
    transport: Optional[MailboxTransport] = None,
    v_init=None,
    watch: bool = True,
    device: Union[str, torch.device] = "cuda",
) -> FleetResult:
    """Run a simulated fleet to completion; returns the lowest live
    host's result after asserting every survivor agreed bit-for-bit
    (the cross-host correctness invariant — any protocol divergence
    fails here, not in production).  Every host runs on ``device``."""
    dev = resolve_device(device)
    transport = transport or MailboxTransport()
    hosts = [FleetHost(h, store, cfg, fleet, transport, device=dev)
             for h in range(fleet.n_hosts)]
    results: Dict[int, FleetResult] = {}
    errors: Dict[int, BaseException] = {}
    evicted: set = set()

    def run_host(host: FleetHost):
        try:
            results[host.host_id] = host.run(v_init)
        except Evicted:
            evicted.add(host.host_id)
        except BaseException as e:          # noqa: BLE001 — recorded
            errors[host.host_id] = e
            # a crashed simulated host tombstones itself so the rest of
            # the fleet replans instead of waiting out the backstop
            transport.mark_dead(host.host_id)

    threads = {h.host_id: threading.Thread(target=run_host, args=(h,),
                                           daemon=True) for h in hosts}
    t0 = time.monotonic()
    for t in threads.values():
        t.start()

    rows = _host_rows(store, fleet)
    flagged: set = set()
    while True:
        live_threads = [h for h, t in threads.items()
                        if t.is_alive() and h not in flagged]
        if not live_threads:
            break
        if watch:
            posts = transport.post_times(0, "sum")
            finished = {h: (posts[h] - t0, rows[h]) for h in posts}
            inflight = {h: (time.monotonic() - t0, rows[h])
                        for h in live_threads
                        if h not in posts and h not in errors}
            for h in detect_stragglers(
                    inflight, finished, factor=fleet.straggler_factor,
                    min_s=fleet.straggler_min_s):
                flagged.add(h)
                transport.mark_dead(h)
                obs.counter("fleet.straggler.detected").add(1)
                obs.event("fleet.straggler", host=h,
                          elapsed=inflight[h][0], rows=rows[h])
        time.sleep(0.02)

    if not results:
        if errors:
            raise next(iter(errors.values()))
        raise RuntimeError("fleet: every host was evicted — nothing ran "
                           "to completion")
    winner = results[min(results)]
    for h, r in sorted(results.items()):
        if not (np.array_equal(r.centers, winner.centers)
                and r.live == winner.live):
            raise AssertionError(
                f"fleet protocol divergence: host {h} finished with "
                f"different centers/live set than host {winner.host_id}")
    return winner
