"""Roofline-term extraction for the LM dry run — counterpart of
`repro.launch.roofline`.

The program roofline (`Roofline` with its compute / memory / collective
terms under the card's rates, `analyze`, `collective_bytes`,
`compiled_cost`) lives in `repro_torch.perf.roofline` and is re-exported
here for the dry run, as the reference re-exports it.  This module keeps
the LM-specific half: `active_params` and `model_flops_for`
(6·N_active·D useful-FLOPs accounting), `counted_flops` (the FLOPs a
step really runs, by ``torch.utils.flop_counter.FlopCounterMode``: the
count `flops_model.step_flops` is held against) and `ProgramTrace`, what
the dry run records of a traced step: its c10d calls, the bytes its ops
touch, its FLOPs and its peak live bytes.
"""
from __future__ import annotations

import collections
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..models.params import PDecl
from ..perf.roofline import (  # noqa: F401 — dry-run re-exports
    HBM_BW, LINK_BW, PEAK_FLOPS, Roofline, analyze, collective_bytes,
    collective_kind, compiled_cost)
from .specs import model_decl


def _decl_leaves(tree, path=()):
    """(keys, PDecl) of the declaration tree, depth first."""
    if isinstance(tree, PDecl):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _decl_leaves(tree[k], path + (str(k),))
    else:
        for i, t in enumerate(tree):
            yield from _decl_leaves(t, path + (str(i),))


def active_params(cfg) -> int:
    """Active (per-token) parameter count — N_active for 6·N·D.
    Padding (vocab, Q-heads) is layout, not useful work: discounted."""
    total = 0
    head_frac = cfg.n_heads / max(cfg.n_heads_padded, 1)
    vocab_frac = cfg.vocab / max(cfg.vocab_padded, 1)
    for keys, d in _decl_leaves(model_decl(cfg)):
        n = math.prod(d.shape)
        if any("w_in" == k or "w_out" == k for k in keys) and \
                cfg.is_moe and len(d.shape) == 4:
            # stacked expert weights (L, E, ·, ·): only top_k/E active
            n = n * cfg.top_k // cfg.n_experts
        if any(k in ("wq", "wo", "bq") for k in keys):
            n = int(n * head_frac)
        if "embed" in keys or "lm_head" in keys:
            n = int(n * vocab_frac)
        total += n
    return total


def model_flops_for(cfg, cell) -> float:
    """6·N_active·D(tokens) per step (train) / per decode step."""
    n_act = active_params(cfg)
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
    elif cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n_act * tokens      # forward only
    else:
        tokens = cell.global_batch       # one token per sequence
        return 2.0 * n_act * tokens
    return 6.0 * n_act * tokens


def _bmm_flops(a_shape, b_shape, *_, out_shape=None, **__) -> int:
    """``bmm``'s formula, ``bmm.dtype``'s ``out_dtype`` argument taken
    for what it is (torch's own formula reads it as the output's shape
    and raises)."""
    b, m, k = a_shape
    return 2 * b * m * k * b_shape[-1]


class _GlobalOnly:
    """The counter's module tracker, filing every count under "Global"
    only.  ``FlopCounterMode``'s own (``ModuleTracker``: per-module
    backward hooks) keeps rematted blocks' recomputed activations alive
    to the end of the step, so a training step's peak memory about
    doubles under it (Qwen2-1.5B's full-width step runs out of an 80 GB
    card)."""
    parents = ("Global",)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _flop_counter():
    """``FlopCounterMode`` with one global table (`_GlobalOnly`) and
    `_bmm_flops` for ``bmm``'s ``out_dtype`` form."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False,
                              custom_mapping={torch.ops.aten.bmm: _bmm_flops})
    counter.mod_tracker = _GlobalOnly()
    return counter


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls[func.overloadpacket] += 1
        return func(*args, **(kwargs or {}))


def counted_flops(fn) -> dict:
    """``fn()`` under ``FlopCounterMode`` (its formulas; one global
    table, `_GlobalOnly`) → {"total": FLOPs, "by_op":
    {op: FLOPs}, "uncounted": {op: calls} for every op it ran that the
    counter has no formula for (elementwise ops, reductions, copies,
    gathers: work the analytic model does not count either), "result":
    fn's return}."""
    counter = _flop_counter()
    ops = _Ops()
    with counter, ops:
        result = fn()
    by_op = counter.get_flop_counts().get("Global", {})
    return {"total": int(sum(by_op.values())),
            "by_op": {str(k): int(v) for k, v in by_op.items()},
            "uncounted": {str(k): n for k, n in sorted(
                ops.calls.items(), key=lambda kv: str(kv[0]))
                if k not in counter.flop_registry},
            "result": result}


def _tensors(*trees) -> list:
    return [t for t in tree_leaves(trees) if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class _Recorder(TorchDispatchMode):
    """`ProgramTrace`'s dispatch mode: every op's operand and result
    bytes, each c10d call's kind and bytes, and the storages the ops
    allocate (a result whose storage is none of its operands'), held
    live until they are freed."""

    def __init__(self, trace: "ProgramTrace"):
        super().__init__()
        self.trace = trace

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        tr = self.trace
        if func.namespace == "c10d":
            kind = collective_kind(func.__name__.split(".")[0])
            if kind is not None:
                name, res, opd = kind
                tr.calls.append((name, _nbytes(_tensors(args[opd])),
                                 _nbytes(_tensors(args[res]))))
            return out
        ins = _tensors(args, kwargs)
        outs = _tensors(out)
        tr.bytes_accessed += _nbytes(ins) + _nbytes(outs)
        inputs = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            tr._allocated(t.untyped_storage(), inputs)
        return out


class ProgramTrace:
    """What the dry run records of one traced step (``with
    ProgramTrace() as tr: step(...)``), on ``FakeTensorMode`` tensors or
    real ones:

      * ``calls`` — each c10d collective as (kind, operand bytes, result
        bytes) (`perf.roofline.collective_bytes` sums them by kind);
      * ``bytes_accessed`` — the operand and result bytes of every other
        op dispatched;
      * ``flops`` — ``FlopCounterMode``'s count (`counted_flops`' table);
      * ``peak_bytes`` — the most bytes of storage the step's own ops held
        live at once (each storage counted once, from the op that
        allocated it until it is freed); what lived before the step is
        not counted.
    """

    def __init__(self):
        self.calls = []
        self.bytes_accessed = 0
        self.flops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._held = set()
        self._counter = None
        self._recorder = None

    def _allocated(self, storage, inputs) -> None:
        key = storage._cdata
        if key in inputs or key in self._held:
            return
        n = storage.nbytes()
        self._held.add(key)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(storage, self._freed, key, n)

    def _freed(self, key, n) -> None:
        self._held.discard(key)
        self.live_bytes -= n

    def __enter__(self):
        self._counter = _flop_counter()
        self._recorder = _Recorder(self)
        self._counter.__enter__()
        self._recorder.__enter__()
        return self

    def __exit__(self, *exc):
        self._recorder.__exit__(*exc)
        self._counter.__exit__(*exc)
        self.flops = int(sum(self._counter.get_flop_counts().get(
            "Global", {}).values()))
        return False
