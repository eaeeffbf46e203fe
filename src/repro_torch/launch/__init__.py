"""`repro_torch.launch` — counterpart of `repro.launch`: the host mesh
(`mesh`), the meta-tensor stand-ins and placements of every (arch ×
shape) cell (`specs`), the analytic FLOPs and bytes model
(`flops_model`), the useful-FLOPs count (`roofline`) and the training
driver (`train`, ``python -m repro_torch.launch.train``).  The
production mesh and model-parallel training are ROADMAP Queue 1 item 3d
iv; the dry run is 3d ii."""
