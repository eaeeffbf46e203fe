"""`repro_torch.launch` — counterpart of `repro.launch`: the host mesh
(`mesh`), the meta-tensor stand-ins and placements of every (arch ×
shape) cell (`specs`), the analytic FLOPs and bytes model
(`flops_model`), the useful-FLOPs count (`roofline`) and the training
driver (`train`, ``python -m repro_torch.launch.train``), on one card or
sharded over a mesh (the dense and MoE families; Mamba2, the hybrid and
the encoder–decoder are ROADMAP Queue 1 item 3d v); the dry run is 3d
ii."""
