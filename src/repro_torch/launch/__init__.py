"""`repro_torch.launch` — counterpart of `repro.launch`, its single-card
part: the host mesh (`mesh`), ``model_decl`` / ``batch_axes_for``
(`specs`) and the training driver (`train`, ``python -m
repro_torch.launch.train``).  The production mesh, the sharding specs,
the dry run and the FLOPs model are ROADMAP Queue 1 item 3d."""
