"""The rank side of tests/test_torch_dp.py: what each spawned rank of a
4-rank gloo CPU mesh runs (`repro_torch.mesh.spawn_mesh` imports this
module in every rank, so it loads torch and `repro_torch` only, never
jax)."""
import torch

from repro_torch import obs
from repro_torch.configs import get_config, reduced
from repro_torch.models import DecoderLM
from repro_torch.models.params import from_reference
from repro_torch.optim import adamw
from repro_torch.train.dp import init_dp_state, make_dp_train_step
from repro_torch.train.step import param_groups

ARCH = "qwen2-1.5b"


def stacked(groups, parts_by_path):
    """{path: [parts]} as {path: the reference's stacked numpy array}."""
    return {p: torch.stack([t.detach() for t in parts_by_path[p]])
            .reshape(g.shape).numpy() for p, g in groups.items()}


def run_dp(mesh, params, batches, eps, lr):
    """`make_dp_train_step` on reduced qwen2 from the reference's
    ``params`` over the mesh's "data" axis, one step per global batch →
    losses, grad norms, the parameters and error-feedback residuals in
    the reference's layout, the bytes this rank gathered and the wire's
    element size."""
    torch.set_num_threads(1)
    cfg = reduced(get_config(ARCH))
    model = DecoderLM(cfg, device="cpu")
    model.load_state_dict(from_reference(params, device="cpu"))
    model.requires_grad_(True)
    opt = adamw(eps=eps)
    state = init_dp_state(model, opt)
    step = make_dp_train_step(cfg, opt, lambda s: lr, mesh)
    gathered = obs.counter("mesh.gathered_bytes")
    before = gathered.value
    losses, norms = [], []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    groups = param_groups(model)
    return {"losses": losses, "grad_norms": norms,
            "params": stacked(groups, {p: g.parts
                                       for p, g in groups.items()}),
            "error": stacked(groups, state.error),
            "gathered_bytes": gathered.value - before,
            "n_params": sum(p.numel() for p in model.parameters())}
