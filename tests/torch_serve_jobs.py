"""The rank side of tests/test_torch_serve_mp.py: what each spawned rank
of a gloo CPU mesh runs (`repro_torch.mesh.spawn_mesh` imports this
module in every rank, so it loads torch and `repro_torch` only, never
jax)."""
import torch

from repro_torch import obs
from repro_torch.configs import get_config, reduced
from repro_torch.launch.train import shard_model
from repro_torch.models import DecoderLM, EncDecLM
from repro_torch.models.params import from_reference
from repro_torch.serve.decode import (first_tokens, make_prefill,
                                      make_serve_step)
from repro_torch.sharding import profile_context

KINDS = ("param_gather_bytes", "reduce_scatter_bytes", "psum_bytes",
         "all_to_all_bytes", "gathered_bytes", "seq_gather_bytes")


def config(arch: str):
    return reduced(get_config(arch))


def whole_model(cfg, params):
    """The one-rank model of the reference's parameter tree."""
    cls = EncDecLM if cfg.family == "encdec" else DecoderLM
    model = cls(cfg, device="cpu")
    model.load_state_dict(from_reference(params, device="cpu"))
    return model


def serve(cfg, model, batch, max_len: int, steps: int) -> dict:
    """Prefill, its greedy token, then ``steps`` greedy decode steps →
    the prefill's logits (this rank's block on a sharded model) and the
    1 + ``steps`` tokens (the global batch's)."""
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    logits, caches = make_prefill(cfg, max_len)(model, batch)
    step = make_serve_step(cfg)
    toks = [first_tokens(cfg, model, logits, batch["tokens"].shape[0])]
    for _ in range(steps):
        tok, caches = step(model, caches, toks[-1])
        toks.append(tok)
    return {"logits": logits.float().numpy(),
            "tokens": torch.cat(toks, 1).numpy()}


def run_cases(mesh, cases) -> dict:
    """For each (name, arch, params, profile, batch, max_len, steps) of
    ``cases``: the reference's ``params`` cut for this rank under
    ``profile`` and served (`serve`), with the bytes its collectives
    moved by kind."""
    torch.set_num_threads(1)
    out = {}
    for name, arch, params, profile, batch, max_len, steps in cases:
        cfg = config(arch)
        counters = {k: obs.counter("mesh." + k) for k in KINDS}
        before = {k: c.value for k, c in counters.items()}
        with profile_context(profile):
            model = shard_model(whole_model(cfg, params), mesh,
                                torch.device("cpu"))
        got = serve(cfg, model, batch, max_len, steps)
        got["bytes"] = {k: c.value - before[k] for k, c in counters.items()}
        out[name] = got
    return out


def one_rank(cases) -> dict:
    """`serve` of each case on one rank (no mesh): the sharded runs'
    own yardstick."""
    torch.set_num_threads(1)
    return {name: serve(config(arch), whole_model(config(arch), params),
                        batch, max_len, steps)
            for name, arch, params, _, batch, max_len, steps in cases}
