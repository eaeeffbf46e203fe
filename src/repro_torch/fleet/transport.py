"""Fleet transports — post/gather mailboxes with tombstone death.

Counterpart of `repro.fleet.transport`, an own copy (stdlib and
`repro_torch.obs` only).  `DirTransport` keeps the reference's file and
tombstone names, so one mailbox directory reads the same from both
packages.

The exchange protocol needs exactly three verbs:

  ``post(epoch, host, key, data)``    publish my bytes for a phase
  ``gather(epoch, hosts, key)``       block for everyone's bytes
  ``mark_dead(host)``                 tombstone a host, permanently

Death is decided by **tombstones, not timeouts**: the entity that
*knows* a host died (the multiprocess parent watching exit codes, the
sim driver catching a thread's exception, the straggler watcher
evicting) writes the tombstone, and every survivor's blocked `gather`
fails with the same `HostLost` the moment it lands.  Two survivors can
therefore never disagree about who died by racing a timeout boundary —
the deadline exists only as a last-resort backstop (`REPRO_FLEET
_TIMEOUT_S` / ``gather_timeout_s``) against a watcherless hang.

A tombstoned host that is actually still running (the straggler case —
speculative-execution semantics, its work is simply no longer wanted)
gets `Evicted` from its own next post/gather and unwinds cleanly.

Two implementations, one protocol: `MailboxTransport` (in-memory
dict + condvar) backs simulated in-process fleets; `DirTransport`
(atomic tmp+rename files in a shared directory) backs real
multi-process fleets — the filesystem analogue of the paper's HDFS
job directory.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional, Sequence

from .. import obs


class HostLost(RuntimeError):
    """Raised by `gather` when expected hosts are dead (or timed out)."""

    def __init__(self, lost):
        self.lost = tuple(sorted(lost))
        super().__init__(f"fleet hosts lost: {self.lost}")


class Evicted(RuntimeError):
    """Raised in a host's OWN post/gather once it has been tombstoned —
    the straggler learning its speculative copy won."""

    def __init__(self, host: int):
        self.host = host
        super().__init__(f"host {host} was evicted from the fleet")


def _resolve_lost(present: set, hosts: Sequence[int], dead: set,
                  deadline: float) -> Optional[tuple]:
    """Shared gather logic: which hosts to report as lost, if any."""
    missing = [h for h in hosts if h not in present]
    if not missing:
        return None                        # complete — nothing lost
    dead_missing = [h for h in missing if h in dead]
    if dead_missing:
        return tuple(dead_missing)         # authoritative tombstones
    if time.monotonic() > deadline:
        return tuple(missing)              # backstop only
    return ()                              # keep waiting


class MailboxTransport:
    """In-memory mailbox for simulated (threaded) fleet hosts."""

    def __init__(self):
        self._cond = threading.Condition()
        self._box: Dict[tuple, bytes] = {}
        self._post_t: Dict[tuple, float] = {}   # watcher introspection
        self._dead: set = set()

    def post(self, epoch: int, host: int, key: str, data: bytes) -> None:
        with self._cond:
            if host in self._dead:
                raise Evicted(host)
            self._box[(epoch, key, host)] = bytes(data)
            self._post_t[(epoch, key, host)] = time.monotonic()
            self._cond.notify_all()

    def gather(self, epoch: int, host: int, hosts: Sequence[int],
               key: str, timeout_s: float) -> Dict[int, bytes]:
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while True:
                if host in self._dead:
                    raise Evicted(host)
                present = {h for e, k, h in self._box
                           if e == epoch and k == key}
                lost = _resolve_lost(present, hosts, self._dead, deadline)
                if lost is None:
                    return {h: self._box[(epoch, key, h)] for h in hosts}
                if lost:
                    raise HostLost(lost)
                self._cond.wait(timeout=0.05)

    def mark_dead(self, host: int) -> None:
        with self._cond:
            self._dead.add(host)
            self._cond.notify_all()

    def post_times(self, epoch: int, key: str) -> Dict[int, float]:
        """host → monotonic post time for one phase (watcher's view)."""
        with self._cond:
            return {h: t for (e, k, h), t in self._post_t.items()
                    if e == epoch and k == key}


class DirTransport:
    """Filesystem mailbox for real multi-process fleet hosts.

    Posts are atomic (tmp + ``os.replace``) so a reader never sees a
    torn frame; tombstones are empty ``dead.h<id>`` marker files the
    parent (or any watcher) drops.  Polling at ``poll_s`` keeps the
    seconds-scale smoke honest without a notification dependency.
    """

    def __init__(self, root: str, *, poll_s: float = 0.05):
        self.root = root
        self.poll_s = float(poll_s)
        os.makedirs(root, exist_ok=True)

    def _path(self, epoch: int, host: int, key: str) -> str:
        return os.path.join(self.root, f"e{epoch:04d}.{key}.h{host:04d}.bin")

    def _tomb(self, host: int) -> str:
        return os.path.join(self.root, f"dead.h{host:04d}")

    def post(self, epoch: int, host: int, key: str, data: bytes) -> None:
        if os.path.exists(self._tomb(host)):
            raise Evicted(host)
        final = self._path(epoch, host, key)
        tmp = final + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)

    def _dead_set(self, hosts: Sequence[int]) -> set:
        return {h for h in hosts if os.path.exists(self._tomb(h))}

    def gather(self, epoch: int, host: int, hosts: Sequence[int],
               key: str, timeout_s: float) -> Dict[int, bytes]:
        deadline = time.monotonic() + timeout_s
        while True:
            if os.path.exists(self._tomb(host)):
                raise Evicted(host)
            present = {h for h in hosts
                       if os.path.exists(self._path(epoch, h, key))}
            lost = _resolve_lost(present, hosts, self._dead_set(hosts),
                                 deadline)
            if lost is None:
                out = {}
                for h in hosts:
                    with open(self._path(epoch, h, key), "rb") as f:
                        out[h] = f.read()
                return out
            if lost:
                raise HostLost(lost)
            time.sleep(self.poll_s)

    def mark_dead(self, host: int) -> None:
        tmp = self._tomb(host) + f".tmp{os.getpid()}"
        with open(tmp, "wb"):
            pass
        os.replace(tmp, self._tomb(host))
        obs.counter("fleet.tombstones").add(1)

    def post_times(self, epoch: int, key: str) -> Dict[int, float]:
        """host → post mtime for one phase (epoch-relative watcher view;
        mtimes share a clock only within one machine, which is the only
        place a DirTransport fleet runs)."""
        out = {}
        for name in os.listdir(self.root):
            if name.startswith(f"e{epoch:04d}.{key}.h") and \
                    name.endswith(".bin"):
                try:
                    out[int(name[:-4].rsplit(".h", 1)[1])] = \
                        os.path.getmtime(os.path.join(self.root, name))
                except (OSError, ValueError):
                    pass
        return out
