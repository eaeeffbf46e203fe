"""`repro_torch.sharding` — counterpart of `repro.sharding`: the
logical-axis rules and profiles, the mesh and profile contexts,
`logical_to_spec`, `abstract_like` and `data_axes`, with placements as
plain tuples and `local_block` for the block a rank holds.  ``constrain``
comes with tensor parallelism in the model code (ROADMAP Queue 1 item
3d iv); the port's model code omits the reference's calls until then.
"""
from .rules import (FSDP_RULES, LOGICAL_RULES, PROFILES, abstract_like,
                    data_axes, get_mesh, get_profile, local_block,
                    logical_to_spec, mesh_context, profile_context, pspec,
                    set_mesh, set_profile)

__all__ = ["LOGICAL_RULES", "FSDP_RULES", "PROFILES", "logical_to_spec",
           "set_mesh", "get_mesh", "mesh_context", "set_profile",
           "get_profile", "profile_context", "data_axes", "abstract_like",
           "local_block", "pspec"]
