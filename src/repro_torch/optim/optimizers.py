"""Functional optimizers over tensors — counterpart of
`repro.optim.optimizers`.

An `Optimizer` is a pair of functions, as the reference's: ``init(params)
→ state`` and ``update(grads, state, params, lr) → (params, state)``.
``params`` maps each of the reference's leaves (its path, e.g.
``"stages/0/attn/wq"``) to a `Group`: the leaf's stacked shape and the
port's per-layer tensors that make it up (`models.params.param_groups`),
or to one plain tensor (a leaf of its own shape).  ``grads`` maps the
same paths to the matching tensors (a list per group).  ``update``
writes the parameters and the state's tensors in place, as the reference
donates them, and returns both.  ``lr`` is a 0-d f32 tensor (the
schedules' result) or a float.

The arithmetic is the reference's, op by op in f32: ``torch.optim``'s
classes round differently and none of them is this Adafactor.

* AdamW and SGD are elementwise: their state is one tensor per part.
* Adafactor factors the second moment of every leaf of ndim ≥ 2 *as the
  reference stacks it*: an (L, D) leaf of per-layer norm scales is
  factored (``vr`` (L,), ``vc`` (D,), ``vc`` averaged over the layers),
  and the update clip's RMS is one mean over the whole stacked leaf.
  Its state keeps the reference's stacked shapes (they are small).
  Leaves made of per-layer matrices are worked slice by slice, in two
  passes (the RMS, then the update), never stacked: OLMoE's expert leaf
  is 4.3 G elements.  Leaves of per-layer vectors (and scalars) are
  stacked, a few KB each.

A `Group` of a model sharded over a mesh carries its placement and the
mesh, its parts being this rank's blocks.  AdamW and SGD need nothing
more; `global_norm` counts each leaf once (each block's squares from the
first rank holding it, summed over the mesh in rank order), and
Adafactor's row and column means and its update RMS, which reduce over
whole leaves, add their blocks' sums over the axes that split the
reduced dims (`_sum_over`).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], tuple]  # (g, s, p, lr)


class Group(NamedTuple):
    """One reference leaf: its stacked ``shape`` and the ``parts`` that
    make it up, row-major over its leading stacked axes (one part of the
    full shape for a leaf that is not stacked).  Sharded: ``spec`` its
    placement on ``mesh``, ``shape`` and the parts this rank's block."""
    shape: tuple
    parts: tuple
    spec: Optional[tuple] = None
    mesh: Any = None

    @property
    def lead(self) -> tuple:
        """The stacked axes (those the parts do not have)."""
        return self.shape[:len(self.shape) - self.parts[0].dim()]


def groups(params) -> Dict[str, Group]:
    """``params`` with every plain tensor made a one-part `Group`."""
    return {k: (v if isinstance(v, Group)
                else Group(tuple(v.shape), (v,)))
            for k, v in params.items()}


def _parts(grads, path) -> Sequence[torch.Tensor]:
    g = grads[path]
    return (g,) if isinstance(g, torch.Tensor) else tuple(g)


def _scalar(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=F32)


def _axes_of(grp: Group, dims) -> tuple:
    """The mesh axes splitting the leaf's dims ``dims`` (negative
    indices into its stacked shape)."""
    from ..sharding.rules import spec_axes
    spec = tuple(grp.spec) + (None,) * (len(grp.shape) - len(grp.spec))
    return tuple(a for d in dims for a in spec_axes(spec[d]))


def _sum_over(t: torch.Tensor, grp: Group, dims) -> torch.Tensor:
    """``t``, partial sums over the leaf's dims ``dims``, summed over the
    ranks splitting them (rank order); a leaf that is not sharded:
    ``t``."""
    if grp.mesh is None:
        return t
    axes = _axes_of(grp, dims)
    if not axes:
        return t
    from ..mesh import psum
    return psum(t, grp.mesh, axes)


def _count(grp: Group, n: int, dims) -> int:
    """``n`` local elements over the leaf's dims ``dims`` as the global
    count."""
    if grp.mesh is None:
        return n
    from ..mesh import axis_sizes
    sizes = axis_sizes(grp.mesh)
    return n * math.prod(sizes[a] for a in _axes_of(grp, dims))


def global_norm(grads, params=None) -> torch.Tensor:
    """√(Σ g²) over every part of every leaf, in f32 (leaf by leaf in the
    reference's order; a stacked leaf's parts summed one by one).  With
    sharded ``params`` (`Group`s on a mesh), each leaf's squares come
    from the first rank holding each of its blocks, summed over the mesh
    in rank order: every rank gets the same bits."""
    gs = groups(params) if params is not None else {}
    mesh = next((g.mesh for g in gs.values() if g.mesh is not None), None)
    if mesh is None:
        total = None
        for path in grads:
            for g in _parts(grads, path):
                s = torch.sum(torch.square(g.to(F32)))
                total = s if total is None else total + s
        return torch.sqrt(total)
    import torch.distributed as dist
    from ..mesh import psum
    from ..sharding.spmd import first_holder
    rank = dist.get_rank()
    sums = []
    for path in grads:
        s = None
        for g in _parts(grads, path):
            q = torch.sum(torch.square(g.to(F32)))
            s = q if s is None else s + q
        if not first_holder(gs[path].spec, mesh, rank):
            s = torch.zeros_like(s)
        sums.append(s)
    total = None
    for s in psum(torch.stack(sums), mesh, mesh.mesh_dim_names):
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float, params=None):
    """Scale every gradient by min(1, max_norm / ‖g‖) in f32 and round it
    back to its dtype, in place → (grads, the norm before clipping);
    ``params`` as `global_norm`'s."""
    norm = global_norm(grads, params)
    scale = torch.clamp(_scalar(max_norm).to(norm.device)
                        / torch.clamp(norm, min=1e-12), max=1.0)
    with torch.no_grad():
        for path in grads:
            for g in _parts(grads, path):
                g.copy_(g.to(F32) * scale)
    return grads, norm


# ------------------------------------------------------------- AdamW -----

def adamw(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          state_dtype=torch.float32) -> Optimizer:
    def init(params):
        def zeros(g):
            return [torch.zeros(p.shape, dtype=state_dtype, device=p.device)
                    for p in g.parts]
        gs = groups(params)
        return {"mu": {k: zeros(g) for k, g in gs.items()},
                "nu": {k: zeros(g) for k, g in gs.items()},
                "count": torch.zeros((), dtype=torch.int32)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        count = state["count"] + 1
        c1 = 1.0 - _scalar(b1) ** count.to(F32)
        c2 = 1.0 - _scalar(b2) ** count.to(F32)
        lr = _scalar(lr)
        for path, grp in groups(params).items():
            for g, mu, nu, p in zip(_parts(grads, path), state["mu"][path],
                                    state["nu"][path], grp.parts):
                g = g.to(F32)
                mu_n = b1 * mu.to(F32) + (1 - b1) * g
                nu_n = b2 * nu.to(F32) + (1 - b2) * g * g
                step = (mu_n / c1) / (torch.sqrt(nu_n / c2) + eps)
                step = step + weight_decay * p.to(F32)
                p.copy_(p.to(F32) - lr * step)
                mu.copy_(mu_n)
                nu.copy_(nu_n)
        return params, {"mu": state["mu"], "nu": state["nu"],
                        "count": count}

    return Optimizer(init, update)


# --------------------------------------------------------- Adafactor -----

def adafactor(eps=1e-30, clip_threshold=1.0, decay=0.8,
              weight_decay=0.0) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern, 2018), on the
    reference's stacked leaves (see the module's docstring)."""

    def init(params):
        def one(g: Group):
            dev = g.parts[0].device
            if len(g.shape) >= 2:
                return {"vr": torch.zeros(g.shape[:-1], dtype=F32,
                                          device=dev),
                        "vc": torch.zeros(g.shape[:-2] + g.shape[-1:],
                                          dtype=F32, device=dev)}
            return {"v": torch.zeros(g.shape, dtype=F32, device=dev)}
        return {"m": {k: one(g) for k, g in groups(params).items()},
                "count": torch.zeros((), dtype=torch.int32)}

    def mean(t, grp, dim, leaf_dim=None):
        """``t.mean(dim)``, the leaf's dim ``leaf_dim`` (default ``dim``;
        negative) whole: on a sharded leaf the blocks' sums added over
        the ranks splitting it, over its global size."""
        if grp.mesh is None:
            return t.mean(dim)
        leaf_dim = dim if leaf_dim is None else leaf_dim
        return _sum_over(t.sum(dim), grp, (leaf_dim,)) / _count(
            grp, t.shape[dim], (leaf_dim,))

    def factored_step(g, vr, vc, grp):
        """The update direction of one matrix (or stack of them) from its
        f32 gradient and its new factored statistics."""
        row_mean = mean(vr, grp, -1, -2)[..., None]
        denom = (vr / torch.clamp(row_mean, min=eps))[..., None] \
            * vc[..., None, :]
        return g * torch.rsqrt(torch.clamp(denom, min=eps))

    def rms_of(total, n, grp):
        dims = tuple(range(-len(grp.shape), 0))
        return torch.sqrt(_sum_over(total, grp, dims)
                          / _count(grp, n, dims) + eps)

    def apply(p, step, rms, lr):
        step = step / torch.clamp(rms / clip_threshold, min=1.0)
        p.copy_(p.to(F32) - lr * (step + weight_decay * p.to(F32)))

    def whole(gs, s, ps, shape, beta, lr, grp):
        """The reference's formula on the stacked leaf (its parts stacked:
        vectors and scalars, or one part)."""
        g = torch.stack([t.to(F32) for t in gs]).reshape(shape)
        g2 = g * g + eps
        if len(shape) >= 2:
            vr = beta * s["vr"] + (1 - beta) * mean(g2, grp, -1)
            vc = beta * s["vc"] + (1 - beta) * mean(g2, grp, -2)
            step = factored_step(g, vr, vc, grp)
            s["vr"].copy_(vr)
            s["vc"].copy_(vc)
        else:
            v = beta * s["v"] + (1 - beta) * g2
            step = g * torch.rsqrt(torch.clamp(v, min=eps))
            s["v"].copy_(v)
        if grp.mesh is None:
            rms = torch.sqrt(torch.mean(step * step) + eps)
        else:
            rms = rms_of(torch.sum(step * step), step.numel(), grp)
        step = step.reshape((len(ps),) + tuple(ps[0].shape))
        for i, p in enumerate(ps):
            apply(p, step[i], rms, lr)

    def sliced(gs, s, ps, lead, beta, lr, grp):
        """Parts that are matrices (or stacks of them): statistics slice
        by slice into the stacked state; the RMS over the whole leaf in a
        first pass, the update in a second."""
        vr = s["vr"].reshape((-1,) + s["vr"].shape[len(lead):])
        vc = s["vc"].reshape((-1,) + s["vc"].shape[len(lead):])
        total, n = None, 0
        for i, g in enumerate(gs):
            g = g.to(F32)
            g2 = g * g + eps
            vr[i].copy_(beta * vr[i] + (1 - beta) * mean(g2, grp, -1))
            vc[i].copy_(beta * vc[i] + (1 - beta) * mean(g2, grp, -2))
            del g2
            step = factored_step(g, vr[i], vc[i], grp)
            sq = torch.sum(step * step)
            total = sq if total is None else total + sq
            n += step.numel()
        if grp.mesh is None:
            rms = torch.sqrt(total / n + eps)
        else:
            rms = rms_of(total, n, grp)
        for i, (g, p) in enumerate(zip(gs, ps)):
            apply(p, factored_step(g.to(F32), vr[i], vc[i], grp), rms, lr)

    @torch.no_grad()
    def update(grads, state, params, lr):
        count = state["count"] + 1
        beta = 1.0 - count.to(F32) ** -decay
        lr = _scalar(lr)
        for path, grp in groups(params).items():
            gs, s = _parts(grads, path), state["m"][path]
            if len(grp.shape) >= 2 and grp.parts[0].dim() >= 2:
                sliced(gs, s, grp.parts, grp.lead, beta, lr, grp)
            else:
                whole(gs, s, grp.parts, grp.shape, beta, lr, grp)
        return params, {"m": state["m"], "count": count}

    return Optimizer(init, update)


# --------------------------------------------------------------- SGD -----

def sgd(momentum: Optional[float] = None) -> Optimizer:
    def init(params):
        if momentum is None:
            return {}
        return {"mu": {k: [torch.zeros(p.shape, dtype=F32, device=p.device)
                           for p in g.parts]
                       for k, g in groups(params).items()}}

    @torch.no_grad()
    def update(grads, state, params, lr):
        lr = _scalar(lr)
        for path, grp in groups(params).items():
            for i, (g, p) in enumerate(zip(_parts(grads, path), grp.parts)):
                if momentum is None:
                    p.copy_(p.to(F32) - lr * g.to(F32))
                    continue
                mu = state["mu"][path][i]
                mu.copy_(momentum * mu + g.to(F32))
                p.copy_(p.to(F32) - lr * mu)
        return params, state

    return Optimizer(init, update)


def make(name: str, **kw) -> Optimizer:
    return {"adamw": adamw, "adafactor": adafactor, "sgd": sgd}[name](**kw)


# ------------------------------------------- the reference's state layout ---

def _stack(parts, shape):
    return torch.stack([t.detach().cpu() for t in parts]).reshape(shape)


def _tensor(arr) -> torch.Tensor:
    """A numpy array (read-only ones included: copied) or a tensor."""
    return arr if isinstance(arr, torch.Tensor) else torch.tensor(
        np.asarray(arr))


def _split(arr, grp: Group):
    t = _tensor(arr)
    ref = grp.parts[0]
    t = t.reshape((len(grp.parts),) + tuple(ref.shape))
    return [t[i].to(ref.device).clone() for i in range(len(grp.parts))]


def state_to_reference(state, params) -> Dict[str, Any]:
    """The optimizer state in the reference's layout, its leaves as CPU
    tensors keyed by the reference's paths: AdamW ``{"mu", "nu":
    {path: stacked}, "count"}``, Adafactor ``{"m": {path: {"vr", "vc"} |
    {"v"}}, "count"}``, SGD ``{"mu": {path: stacked}}`` or ``{}``
    (`models.params.nest` turns the path maps into the reference's
    trees)."""
    gs = groups(params)
    out: Dict[str, Any] = {}
    for key, val in state.items():
        if key == "count":
            out[key] = val.detach().cpu()
        elif key == "m":
            out[key] = {p: {k: t.detach().cpu() for k, t in s.items()}
                        for p, s in val.items()}
        else:
            out[key] = {p: _stack(parts, gs[p].shape)
                        for p, parts in val.items()}
    return out


def state_from_reference(ref, params) -> Dict[str, Any]:
    """`state_to_reference`'s inverse: ``ref`` (its path maps' leaves
    numpy arrays or tensors) as the port's state on the parameters'
    devices, elementwise moments split into the parts."""
    gs = groups(params)
    out: Dict[str, Any] = {}
    for key, val in ref.items():
        if key == "count":
            out[key] = torch.tensor(np.asarray(val), dtype=torch.int32)
        elif key == "m":
            out[key] = {p: {k: _tensor(t).to(gs[p].parts[0].device, F32)
                            .clone() for k, t in s.items()}
                        for p, s in val.items()}
        else:
            out[key] = {p: _split(arr, gs[p]) for p, arr in val.items()}
    return out
