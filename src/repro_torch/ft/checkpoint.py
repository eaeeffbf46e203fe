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
``b/weights``).  A replicated stream state restores onto a
`repro_torch.mesh` mesh through `StreamingBigFCM.restore(mesh=)`.

Sharded (``shardings=(mesh, placements)``, the LM trainer's state on a
mesh: each rank's tree holds its blocks, the placement tree — e.g.
`launch.specs.train_state_pspecs` — says whose): the files are still
the global leaves, one ``.npy`` each, readable by either package and by
a mesh of another shape.  Rank 0 makes the ``.tmp`` directory and the
global files of the split leaves (``open_memmap``); each rank writes its
blocks into them, only the first rank holding a block writing it (a
whole leaf: np.save by that rank); after a barrier rank 0 writes the
manifest and renames.  Every rank must see the one directory (a shared
filesystem), and the sharded save is synchronous: its barriers are
collectives of the trainer's group.  `restore(shardings=)` reads each
rank's block of every leaf through ``mmap_mode="r"``
(`sharding.block_of`: a gated leaf's columns paired).

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

from .. import mesh as M
from .. import obs
from ..sharding.rules import block_of, is_spec, put_block, spec_axes


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


def flatten_specs(tree, prefix: Tuple[str, ...] = ()
                  ) -> List[Tuple[str, tuple]]:
    """[(path, placement)] of a placement tree in `_flatten_with_paths`'
    order, a placement (a plain tuple, ``()`` for a scalar) a leaf."""
    if tree is None:
        return []
    if is_spec(tree):
        return [("/".join(prefix), tree)]
    out = []
    for key, child in _children(tree):
        out += flatten_specs(child, prefix + (key,))
    return out


def _sharded(tree, shardings) -> List[Tuple[str, Any, tuple]]:
    """[(path, leaf, placement)] of a tree and its placement tree."""
    leaves = _flatten_with_paths(tree)
    specs = flatten_specs(shardings[1])
    if [k for k, _ in leaves] != [k for k, _ in specs]:
        raise ValueError("the placement tree does not match the tree: "
                         f"{[k for k, _ in leaves][:5]}… vs "
                         f"{[k for k, _ in specs][:5]}…")
    return [(k, leaf, spec) for (k, leaf), (_, spec) in zip(leaves, specs)]


def global_shape(local_shape, spec, mesh) -> Tuple[int, ...]:
    """The whole leaf's shape from a block's under ``spec``."""
    sizes = M.axis_sizes(mesh)
    spec = tuple(spec) + (None,) * (len(local_shape) - len(spec))
    return tuple(int(n) * int(np.prod([sizes[a] for a in spec_axes(e)]))
                 for n, e in zip(local_shape, spec))


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
    def save(self, step: int, tree: Any, shardings: Any = None) -> None:
        """Write ``tree`` as checkpoint ``step``: asynchronously, or with
        ``shardings`` = (mesh, placement tree), each rank's blocks into
        the global leaves, synchronously (see the module's
        docstring)."""
        if shardings is not None:
            self.wait()
            with obs.span("ft.checkpoint.save", step=step):
                self._save_sharded(step, tree, shardings)
            obs.counter("ft.checkpoint.saves").add(1)
            return
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

    def _save_sharded(self, step: int, tree, shardings):
        import torch.distributed as dist
        from ..sharding.spmd import first_holder
        mesh = shardings[0]
        rank = dist.get_rank()
        first = M.is_first(mesh)
        tmp = os.path.join(self.dir, f"step_{step:010d}.tmp")
        final = os.path.join(self.dir, f"step_{step:010d}")
        host = [(k, _to_host(v), spec) for k, v, spec
                in _sharded(tree, shardings)]
        manifest = {}
        for key, arr, spec in host:
            manifest[key] = {"file": key.replace("/", "__") + ".npy",
                             "shape": list(global_shape(arr.shape, spec,
                                                        mesh)),
                             "dtype": str(arr.dtype)}
        if first:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            for key, arr, spec in host:
                if any(spec_axes(e) for e in spec):
                    np.lib.format.open_memmap(
                        os.path.join(tmp, manifest[key]["file"]), "w+",
                        arr.dtype, tuple(manifest[key]["shape"])).flush()
        M.barrier(mesh)
        for key, arr, spec in host:
            if not first_holder(spec, mesh, rank):
                continue
            path = os.path.join(tmp, manifest[key]["file"])
            if any(spec_axes(e) for e in spec):
                out = np.load(path, mmap_mode="r+")
                put_block(out, arr, spec, mesh, rank)
                out.flush()
                del out
            else:
                np.save(path, arr)
        M.barrier(mesh)
        if first:
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump({"step": step, "leaves": manifest}, f)
                f.flush()
                os.fsync(f.fileno())
            with self._lock:
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                self._gc()
        M.barrier(mesh)                 # published before anyone reads

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
        its template leaf's kind and dtype (a tensor's device too).  With
        ``shardings`` = (mesh, placement tree), ``tree_like`` holds this
        rank's blocks and each leaf's block is read from the global file
        through ``mmap_mode="r"`` (a mesh of any shape)."""
        if shardings is not None:
            return self._restore_sharded(tree_like, step, shardings)
        step = self._step(step)
        with obs.span("ft.checkpoint.restore", step=step):
            d, manifest = self._manifest(step)
            out = [_like(np.load(os.path.join(d, manifest[key]["file"])),
                         like)
                   for key, like in _flatten_with_paths(tree_like)]
        # every restore is a restart in the fault-tolerance story
        obs.counter("ft.checkpoint.restores").add(1)
        return _rebuild(tree_like, iter(out))

    def _restore_sharded(self, tree_like, step, shardings):
        import torch.distributed as dist
        leaves = _sharded(tree_like, shardings)
        mesh, rank = shardings[0], dist.get_rank()
        step = self._step(step)
        with obs.span("ft.checkpoint.restore", step=step):
            d, manifest = self._manifest(step)
            out = []
            for key, like, spec in leaves:
                arr = np.load(os.path.join(d, manifest[key]["file"]),
                              mmap_mode="r")
                blk = np.array(block_of(arr, spec, mesh, rank), copy=True)
                if tuple(blk.shape) != tuple(like.shape):
                    raise ValueError(
                        f"{key}: the block of the saved "
                        f"{tuple(arr.shape)} under {spec} is "
                        f"{tuple(blk.shape)}, not the {tuple(like.shape)} "
                        "this rank holds")
                out.append(_like(blk, like))
                del arr
        obs.counter("ft.checkpoint.restores").add(1)
        return _rebuild(tree_like, iter(out))
