"""`repro_torch.fleet` — the multi-host elastic fleet over the data plane.

Counterpart of `repro.fleet`.  BigFCM's cluster as a mesh of peer hosts:

  * `host`      — `FleetHost`: plan-derive / local-fit / exchange /
                  elastic-replan protocol of ONE peer (+ `FleetConfig`);
  * `transport` — post/gather mailboxes with tombstone death
                  (`MailboxTransport` in-memory, `DirTransport` files);
  * `wire`      — the summary frame codec, f32 or quantized bf16
                  (`BF16_REL_BOUND` pins the quantization error), byte
                  for byte the reference's frames;
  * `sim`       — `fleet_fit`: N hosts as threads + the straggler
                  watcher;
  * `proc`      — `run_fleet`: N hosts as spawned processes, parent as
                  death-watch (the real-host article).

The reference's `mesh_exchange` (one ``shard_map`` all-gather) comes
with the multi-GPU slice.

Everything rides the zero-coordination invariant: plans, seeds, shard
ownership, and the merge are pure functions of (store chunking, live
host set), so hosts agree without a control plane — the only bytes
exchanged are the few-KB summary frames.

Observability (`repro_torch.obs`, the reference's names): counters
``fleet.exchange.bytes{wire=…}``, ``fleet.replan.moved_chunks``,
``fleet.straggler.detected``, ``fleet.prefetch.bytes``,
``fleet.tombstones``; spans ``fleet.local_fit`` / ``fleet.shard_fit`` /
``fleet.exchange`` / ``fleet.objective`` (each with a ``host=<id>``
field); events ``fleet.replan``, ``fleet.straggler``, ``fleet.fit.done``.

Entry points take ``device`` (default ``"cuda"``; the CPU only when
asked for).  Env knobs: ``REPRO_FLEET_WIRE`` (``f32``/``bf16`` frame
encoding), ``REPRO_FLEET_TIMEOUT_S`` (gather backstop when no watcher is
alive to tombstone).
"""
from .host import FleetConfig, FleetHost, FleetResult
from .proc import (collect_results, host_main, run_fleet, spawn_fleet,
                   watch_fleet)
from .sim import fleet_fit
from .transport import (DirTransport, Evicted, HostLost,
                        MailboxTransport)
from .wire import (BF16_REL_BOUND, WIRE_DTYPES, decode_summary,
                   encode_summary)

__all__ = [
    "FleetConfig", "FleetHost", "FleetResult",
    "collect_results", "host_main", "run_fleet", "spawn_fleet",
    "watch_fleet", "fleet_fit",
    "DirTransport", "Evicted", "HostLost", "MailboxTransport",
    "BF16_REL_BOUND", "WIRE_DTYPES", "decode_summary", "encode_summary",
]
