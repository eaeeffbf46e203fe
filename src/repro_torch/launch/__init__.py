"""`repro_torch.launch` — counterpart of `repro.launch`: the host mesh
(`mesh`), the meta-tensor stand-ins and placements of every (arch ×
shape) cell (`specs`), the analytic FLOPs and bytes model
(`flops_model`), the useful-FLOPs count (`roofline`) and the training
driver (`train`, ``python -m repro_torch.launch.train``), on one card or
sharded over a mesh (every family: ``build`` and its step take the
encoder–decoder's frames, ``train`` feeds tokens only, as the
reference's does); the dry run is ROADMAP Queue 1 item 3d ii."""
