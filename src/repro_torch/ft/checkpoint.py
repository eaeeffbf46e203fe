"""Checkpoint/restart — the fault-tolerance backbone.

Counterpart of `repro.ft.checkpoint` (`CheckpointManager`), in the same
on-disk format, so a checkpoint written by either package restores in
the other:

  * **Atomic**: a checkpoint is written to ``step_XXXXXXXXXX.tmp`` and
    renamed only after every leaf and the manifest are written (the
    manifest fsynced) — a process dying mid-write never corrupts the
    latest good checkpoint, and a left-over ``.tmp`` directory is never
    listed.
  * **Async**: `save` snapshots the leaves to host memory (a device
    tensor is copied to the host there and then) and hands the file I/O
    to a background thread, one write in flight; work resumes at once.
  * **Self-describing**: ``manifest.json`` maps each leaf's path to its
    ``.npy`` file, shape and dtype; `restore_arrays` needs no template.
  * **Bounded**: keep-last-k garbage collection.

Leaf paths are the reference's: a tree is flattened as `jax.tree_util`
flattens it — dict keys in **sorted** order, namedtuple fields by name,
list and tuple items by index, ``None`` holding no leaf — and a leaf's
path is its keys joined by ``/`` (``{'b': NT(centers, weights), 'a': [x,
{'z': …, 'y': …}]}`` gives ``a/0``, ``a/1/y``, ``a/1/z``, ``b/centers``,
``b/weights``).  Restoring onto a device mesh (``shardings=``) serves the
LM trainer's sharded state and comes with it (M13); a replicated stream
state restores onto a `repro_torch.mesh` mesh through
`StreamingBigFCM.restore(mesh=)`.

Each write is an ``ft.checkpoint.save`` span (on the writer thread) and
one ``ft.checkpoint.saves``; each restore an ``ft.checkpoint.restore``
span and one ``ft.checkpoint.restores`` (`repro_torch.obs`, the
reference's names).
"""
from __future__ import annotations

import collections
import json
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from .. import obs


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _keys(tree: dict) -> list:
    """A dict's keys in `jax.tree_util` order: sorted, except an
    `OrderedDict`'s, which keep their order."""
    return list(tree) if isinstance(tree, collections.OrderedDict) \
        else sorted(tree)


def _children(tree) -> Optional[List[Tuple[str, Any]]]:
    """(path key, child) pairs of a container in `jax.tree_util` order, or
    None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in _keys(tree)]
    if _is_namedtuple(tree):
        return [(f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(tree)]
    return None


def _flatten_with_paths(tree, prefix: Tuple[str, ...] = ()
                        ) -> List[Tuple[str, Any]]:
    """[(path, leaf)] in `jax.tree_util.tree_flatten_with_path` order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [("/".join(prefix), tree)]
    out = []
    for key, child in kids:
        out += _flatten_with_paths(child, prefix + (key,))
    return out


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves`` (dicts come back with their keys in `_keys`
    order, as `jax.tree_util.tree_unflatten` gives them)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        kind = collections.OrderedDict \
            if isinstance(tree, collections.OrderedDict) else dict
        return kind((k, _rebuild(tree[k], leaves)) for k in _keys(tree))
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(c, leaves) for c in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(c, leaves) for c in tree)
    return next(leaves)


def _to_host(leaf) -> np.ndarray:
    """A host snapshot of one leaf: a tensor is copied (so the caller may
    mutate it while the write runs), anything else goes through
    `np.asarray`, as the reference does.  numpy has no bfloat16 (without
    ``ml_dtypes``, which the card's machine lacks): a bf16 tensor is
    written as its 16-bit pattern, an int16 array."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy()
    return np.asarray(leaf)


def _like(arr: np.ndarray, like):
    """``arr`` in the kind, dtype and device of the template leaf (an
    int16 array into a bf16 template: the bit pattern `_to_host`
    wrote)."""
    if isinstance(like, torch.Tensor):
        if like.dtype == torch.bfloat16 and arr.dtype == np.int16:
            return torch.from_numpy(np.ascontiguousarray(arr)).view(
                torch.bfloat16).to(like.device)
        return torch.as_tensor(arr, dtype=like.dtype, device=like.device)
    return np.asarray(arr, dtype=getattr(like, "dtype", None))


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._lock = threading.Lock()
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save --
    def save(self, step: int, tree: Any) -> None:
        # host snapshot happens NOW (so the caller can mutate its state)
        host = [(k, _to_host(v)) for k, v in _flatten_with_paths(tree)]
        self.wait()                     # backpressure: one in flight
        if self.async_save:
            t = threading.Thread(target=self._write_async, args=(step, host),
                                 daemon=True)
            t.start()
            self._pending = t
        else:
            self._write(step, host)

    def wait(self):
        """Drain the write in flight; re-raises the error it hit, if any."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write_async(self, step: int, host):
        try:
            self._write(step, host)
        except BaseException as e:      # handed to the next wait()/save()
            self._error = e

    def _write(self, step: int, host):
        # runs on the async save thread: span and counter are thread-safe
        with obs.span("ft.checkpoint.save", step=step):
            self._write_inner(step, host)
        obs.counter("ft.checkpoint.saves").add(1)

    def _write_inner(self, step: int, host):
        tmp = os.path.join(self.dir, f"step_{step:010d}.tmp")
        final = os.path.join(self.dir, f"step_{step:010d}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {}
        for key, arr in host:
            fname = key.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest[key] = {"file": fname, "shape": list(arr.shape),
                             "dtype": str(arr.dtype)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "leaves": manifest}, f)
            f.flush()
            os.fsync(f.fileno())
        with self._lock:
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)       # atomic publish
            self._gc()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore --
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step(self, step: Optional[int]) -> int:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return step

    def _manifest(self, step: int):
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            return d, json.load(f)["leaves"]

    def restore_arrays(self, step: Optional[int] = None,
                       keys: Optional[Any] = None) -> dict:
        """Template-free restore: every leaf as a host numpy array keyed
        by its flattened path, shapes and dtypes read straight off the
        manifest — for consumers that cannot know shapes ahead of time.
        ``keys`` restricts loading to the listed leaf paths (missing ones
        are simply absent from the result) — the tenant plane pulls its
        six stacked leaves out of a manifest that may also hold
        unrelated state."""
        step = self._step(step)
        with obs.span("ft.checkpoint.restore", step=step):
            d, manifest = self._manifest(step)
            if keys is not None:
                want = set(keys)
                manifest = {k: v for k, v in manifest.items() if k in want}
            out = {key: np.load(os.path.join(d, spec["file"]))
                   for key, spec in manifest.items()}
        obs.counter("ft.checkpoint.restores").add(1)
        return out

    def restore(self, tree_like: Any, step: Optional[int] = None,
                shardings: Any = None) -> Any:
        """Restore into the structure of ``tree_like``; each leaf takes
        its template leaf's kind and dtype (a tensor's device too)."""
        if shardings is not None:
            raise NotImplementedError(
                "restore(shardings=...) places the LM trainer's sharded "
                "leaves on a device mesh; it comes with the LM stack (M13)")
        step = self._step(step)
        with obs.span("ft.checkpoint.restore", step=step):
            d, manifest = self._manifest(step)
            out = [_like(np.load(os.path.join(d, manifest[key]["file"])),
                         like)
                   for key, like in _flatten_with_paths(tree_like)]
        # every restore is a restart in the fault-tolerance story
        obs.counter("ft.checkpoint.restores").add(1)
        return _rebuild(tree_like, iter(out))
