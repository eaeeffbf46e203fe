"""`repro_torch.sharding` — counterpart of `repro.sharding`: the
logical-axis rules and profiles, the mesh and profile contexts,
`logical_to_spec`, `abstract_like` and `data_axes`, with placements as
plain tuples (`Paired` for a gated MLP's columns), `local_block` /
`block_of` for the block a rank holds, and `constrain`, which checks a
tensor is the block its logical axes give this rank.  `spmd` holds the
sharded LM's per-layer helpers.
"""
from .rules import (FSDP_RULES, LOGICAL_RULES, PROFILES, Paired,
                    abstract_like, block_of, constrain, data_axes, get_mesh,
                    get_profile, local_block, logical_to_spec, mesh_context,
                    profile_context, pspec, put_block, set_mesh,
                    set_profile)

__all__ = ["LOGICAL_RULES", "FSDP_RULES", "PROFILES", "logical_to_spec",
           "set_mesh", "get_mesh", "mesh_context", "set_profile",
           "get_profile", "profile_context", "data_axes", "abstract_like",
           "local_block", "pspec", "constrain", "Paired", "block_of",
           "put_block"]
