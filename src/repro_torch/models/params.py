"""Declarative parameter trees — counterpart of `repro.models.params`.

Models declare a nested dict of ``PDecl`` (shape + logical axes + init);
from that single source of truth come the real initialized parameters
(`tree_init`, in the reference's stacked layout), the ``meta`` tensors
of the dry-run path (`tree_abstract`: a 1T-parameter model allocates
nothing), the placement tree (`tree_pspecs`, via `sharding.rules`), the
parameter count, and the modules' own parameters (`ParamTree`), whose
state-dict keys
follow the reference's paths with every stacked ``(L, …)`` leaf split
into per-layer parameters (`to_state`, `from_reference`).  Weights keep
the reference's ``(in, out)`` layout (``x @ w``), so carrying a
reference tree across is a copy.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..sharding.rules import Paired, block_of, is_spec, logical_to_spec


@dataclasses.dataclass(frozen=True)
class PDecl:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"        # normal | zeros | ones | embed
    scale: Optional[float] = None
    # the last dim is a gated MLP's [u | g]: placed `Paired` on a mesh
    gated: bool = False

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def _map(fn, tree):
    """``fn`` over the leaves of a nested dict/list/tuple tree, dict keys
    in sorted order (`jax.tree_util`'s flattening order)."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, t) for t in tree)
    return fn(tree)


def _leaves(tree) -> list:
    out = []
    _map(out.append, tree)
    return out


def tree_init(generator: torch.Generator, tree, dtype=torch.float32,
              device: Union[str, torch.device] = "cuda", cut=None):
    """Initialize a real param tree from the declaration tree, on
    ``device`` from ``generator`` (a `torch.Generator` on that device).

    The reference's rules: zeros, ones, ``embed`` = N(0, 1) × scale, and
    ``normal`` = N(0, 1) × scale (default 1/√fan_in, fan_in the
    second-to-last dim).  The distribution is the reference's; the bits
    are not (`jax.random` has no torch counterpart) — carry a reference
    tree across with `from_reference` for identical weights.

    ``cut(decl, tensor)``, if given, is applied to each leaf as soon as it
    is drawn (a rank keeping its block of it, the rest freed): the draws,
    and so the bits, are the whole tree's."""
    dev = resolve_device(device)

    def init_one(d: PDecl):
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dtype, device=dev)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dtype, device=dev)
        z = torch.randn(d.shape, generator=generator, dtype=dtype,
                        device=dev)
        if d.init == "embed":
            return z * (d.scale or 1.0)
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        scale = d.scale if d.scale is not None else 1.0 / math.sqrt(fan_in)
        return z * scale

    if cut is None:
        return _map(init_one, tree)
    return _map(lambda d: cut(d, init_one(d)), tree)


def tree_abstract(tree, dtype=torch.bfloat16):
    """The declaration tree's ``meta`` tensors (the reference's
    ShapeDtypeStructs): shapes and ``dtype``, no storage."""
    return _map(lambda d: torch.empty(d.shape, dtype=dtype, device="meta"),
                tree)


def tree_pspecs(tree, mesh=None):
    """The placement tree from the logical axes (divisibility-safe,
    `logical_to_spec` under the active profile); a gated leaf's placement
    is `Paired` (equal to the plain one)."""
    def one(d):
        spec = logical_to_spec(d.logical, mesh, dims=d.shape)
        return Paired(spec) if d.gated else spec
    return _map(one, tree)


def tree_paths(tree, prefix: str = "") -> Dict[str, object]:
    """``{path: leaf}`` of a nested dict/list tree, keys joined by ``/``
    (``"stages/0/attn/wq"``), in `jax.tree_util`'s order; a placement (a
    plain tuple) is a leaf."""
    out: Dict[str, object] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, list) or (isinstance(node, tuple)
                                        and not is_spec(node)):
            for i, t in enumerate(node):
                walk(t, path + (str(i),))
        else:
            out["/".join(path)] = node

    walk(tree, (prefix,) if prefix else ())
    return out


def n_params(tree) -> int:
    return sum(math.prod(d.shape) for d in _leaves(tree))


def stack_layers(decl_fn, n: int):
    """Add a leading scanned 'layers' axis to every decl in a subtree."""
    return _map(lambda d: PDecl((n,) + d.shape, ("layers",) + d.logical,
                                d.init, d.scale, d.gated), decl_fn())


# ------------------------------------------------- reference layout ↔ port ---

# Top-level lists whose entries hold ``(L, …)``-stacked leaves: the
# port's modules keep one parameter set per layer, at ``<key>.<i>.layers.<l>``.
STACKED = ("stages",)
# Top-level dicts of ``(L, …)``-stacked leaves (the encoder–decoder's
# blocks): one parameter set per layer at ``<key>.<l>``.
STACKED_BLOCKS = ("enc_blocks", "dec_blocks")
# Keys inside a stacked stage whose leaves carry a second stacked axis
# (the hybrid period's mamba blocks, (n_periods, attn_period, …)): one
# set per inner layer at ``…layers.<l>.<key>.<j>``.
INNER_STACKED = ("mambas",)


def to_state(tree, prefix: str = "") -> Dict[str, object]:
    """Flatten a reference-layout tree (nested dicts/lists of arrays or
    tensors) into ``{dotted path: leaf}``, each stacked leaf split along
    its layer axes: ``stages[0]["attn"]["wq"]`` of shape (L, d, h·hd)
    becomes ``stages.0.layers.<l>.attn.wq``; ``stages[0]["mambas"]["ln1"]
    ["scale"]`` of shape (P, A, d) becomes ``stages.0.layers.<p>.mambas.
    <a>.ln1.scale``; ``enc_blocks["mlp"]["w_in"]`` of shape (L, d, f)
    becomes ``enc_blocks.<l>.mlp.w_in``."""
    out: Dict[str, object] = {}

    def walk(node, head, rest):
        # ``head``: the path down to a stacked stage's "layers" (None
        # outside one); ``rest``: the path below it (or the whole path)
        if isinstance(node, dict):
            for k in sorted(node):
                if head is None and not rest and k in STACKED_BLOCKS:
                    walk(node[k], (str(k),), ())
                else:
                    walk(node[k], head, rest + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, t in enumerate(node):
                if head is None and len(rest) == 1 and rest[0] in STACKED:
                    walk(t, rest + (str(i), "layers"), ())
                else:
                    walk(t, head, rest + (str(i),))
        elif head is not None:
            for l in range(node.shape[0]):
                if rest and rest[0] in INNER_STACKED:
                    for j in range(node.shape[1]):
                        out[".".join(head + (str(l), rest[0], str(j))
                                     + rest[1:])] = node[l, j]
                else:
                    out[".".join(head + (str(l),) + rest)] = node[l]
        else:
            out[".".join(rest)] = node

    walk(tree, None, (prefix,) if prefix else ())
    return out


class _At:
    """A stand-in leaf for `to_state`: a reference path, its stacked shape
    and the index a split takes into it."""

    def __init__(self, path: str, shape: Tuple[int, ...], index=()):
        self.path, self.full, self.index = path, shape, index
        self.shape = shape[len(index):]

    def __getitem__(self, i):
        i = i if isinstance(i, tuple) else (i,)
        return _At(self.path, self.full, self.index + i)


def _stand_ins(tree, path=()):
    if isinstance(tree, dict):
        return {k: _stand_ins(tree[k], path + (str(k),)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_stand_ins(t, path + (str(i),))
                          for i, t in enumerate(tree))
    return _At("/".join(path), tuple(tree.shape))


def reference_layout(decl) -> Dict[str, Tuple[Tuple[int, ...], list]]:
    """Each reference leaf of the declaration tree ``decl``, in
    `jax.tree_util`'s order, by its path (keys joined by ``/``, as the
    checkpoint manager writes it: ``"stages/0/attn/wq"``) → (its stacked
    shape, the port's state-dict keys of its per-layer parts, row-major
    over the stacked axes) — `to_state`'s split, read back."""
    out: Dict[str, Tuple[Tuple[int, ...], list]] = {}
    for key, at in to_state(_stand_ins(decl)).items():
        out.setdefault(at.path, (at.full, []))[1].append(key)
    return out


def param_groups(model: nn.Module, decl) -> dict:
    """The model's parameters grouped by the reference's leaves: path →
    `optim.Group` (stacked shape, the per-layer parameters), in the
    reference's order — what the optimizers take.  A model sharded over
    a mesh (its ``mesh``) gives each group this rank's stacked block
    shape, its placement and the mesh."""
    from ..optim.optimizers import Group
    named = dict(model.named_parameters())
    mesh = getattr(model, "mesh", None)
    specs = tree_paths(tree_pspecs(decl, mesh)) if mesh is not None else {}
    out = {}
    for path, (shape, keys) in reference_layout(decl).items():
        parts = tuple(named[k] for k in keys)
        if mesh is not None:
            shape = shape[:len(shape) - parts[0].dim()] + tuple(
                parts[0].shape)
        out[path] = Group(shape, parts, specs.get(path), mesh)
    return out


def nest(flat: Dict[str, object]):
    """A ``{"a/b/0/c": leaf}`` map as the nested tree it flattens (a
    numeric key indexes a list: the reference's ``stages``)."""
    root: dict = {}
    for path, leaf in flat.items():
        keys = path.split("/")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(root)


def to_reference(model: nn.Module, decl):
    """`from_reference`'s inverse: the model's parameters as the
    reference's tree (stacked leaves, as CPU tensors)."""
    return nest({path: torch.stack([p.detach().cpu() for p in g.parts])
                 .reshape(g.shape)
                 for path, g in param_groups(model, decl).items()})


def from_reference(tree, device: Union[str, torch.device] = "cuda",
                   dtype: Optional[torch.dtype] = None, *, decl=None,
                   mesh=None, rank: Optional[int] = None
                   ) -> Dict[str, torch.Tensor]:
    """The reference's param tree (nested dicts/lists of numpy arrays, or
    anything ``np.asarray`` reads) as the port's state dict on
    ``device``: keys as `to_state`, values copied (cast to ``dtype`` if
    given).  Load it with ``model.load_state_dict(...)``.

    With ``mesh`` (and the tree's declaration ``decl``), each leaf is
    first cut to the block ``rank`` (default: this process's rank) holds
    under `tree_pspecs` (``decl``, ``mesh``) in the active profile
    (`sharding.block_of`: a gated leaf's columns paired); the layer axes
    are never split, so a stacked leaf's per-layer parts are blocks
    too."""
    dev = resolve_device(device)
    if mesh is not None:
        if decl is None:
            raise ValueError("from_reference: a mesh needs the tree's "
                             "declaration (decl=) to place its leaves")
        if rank is None:
            import torch.distributed as dist
            rank = dist.get_rank()
        specs = tree_paths(tree_pspecs(decl, mesh))
        tree = nest({p: block_of(np.asarray(v), specs[p], mesh, rank)
                     for p, v in tree_paths(tree).items()})
    return {k: torch.tensor(np.asarray(v), device=dev, dtype=dtype)
            for k, v in to_state(tree).items()}


def assign_state(module: nn.Module, state: Dict[str, torch.Tensor]
                 ) -> None:
    """Replace the module's parameters by the state dict's tensors, as
    they are (shapes included: a rank's blocks into a skeleton built at
    the global shapes), ``requires_grad`` off.  Every parameter must be
    given."""
    names = {k for k, _ in module.named_parameters()}
    if set(state) != names:
        raise KeyError(f"assign_state: missing {sorted(names - set(state))}"
                       f", unexpected {sorted(set(state) - names)}")
    for key, t in state.items():
        *path, leaf = key.split(".")
        owner = module.get_submodule(".".join(path))
        owner._parameters[leaf] = nn.Parameter(t, requires_grad=False)


class ParamTree(nn.Module):
    """Parameters and child modules named by a declaration tree's keys.
    ``p["name"]`` and ``"name" in p`` read them, so the plain functions
    of `layers` and `attention` take a module or a dict alike.  The
    parameters are zeros until loaded, with ``requires_grad`` off: the
    caller turns it on to train (``model.requires_grad_(True)``,
    `launch.train.build`) and serving leaves it off."""

    def __init__(self, decl: dict, *, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        for k in sorted(decl):
            d = decl[k]
            if isinstance(d, PDecl):
                self.register_parameter(k, nn.Parameter(
                    torch.zeros(d.shape, dtype=dtype, device=device),
                    requires_grad=False))
            else:
                self.add_module(k, ParamTree(d, dtype=dtype, device=device))

    def __getitem__(self, k: str):
        return getattr(self, k)

    def __contains__(self, k: str) -> bool:
        return k in self._parameters or k in self._modules
