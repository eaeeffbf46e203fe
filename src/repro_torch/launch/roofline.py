"""The LM half of the reference's roofline layer — counterpart of
`repro.launch.roofline`'s `active_params` and `model_flops_for`
(6·N_active·D useful-FLOPs accounting) — and `counted_flops`, the FLOPs
a step really runs, by ``torch.utils.flop_counter.FlopCounterMode``
(the count `flops_model.step_flops` is held against).

The HLO half the reference re-exports from `repro.perf.roofline`
(``Roofline``, ``analyze``, ``collective_bytes``, ``compiled_cost``)
comes with the dry run (ROADMAP Queue 1 item 3d ii), with this card's
peak and link rates, not the TPU's.
"""
from __future__ import annotations

import collections
import math

import torch

from ..models.params import PDecl
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


def counted_flops(fn) -> dict:
    """``fn()`` under ``FlopCounterMode`` (its formulas; one global
    table, `_GlobalOnly`) → {"total": FLOPs, "by_op":
    {op: FLOPs}, "uncounted": {op: calls} for every op it ran that the
    counter has no formula for (elementwise ops, reductions, copies,
    gathers: work the analytic model does not count either), "result":
    fn's return}."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import FlopCounterMode

    class _Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.calls[func.overloadpacket] += 1
            return func(*args, **(kwargs or {}))

    counter = FlopCounterMode(display=False,
                              custom_mapping={torch.ops.aten.bmm: _bmm_flops})
    counter.mod_tracker = _GlobalOnly()
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
