"""BigFCM → MoE router initialization on the PyTorch/CUDA port
(`repro_torch.integration.router_init`).

Clusters the token-embedding table with BigFCM (one cluster per expert,
olmoe-family reduced config), seeds every router with the centroids, and
shows (1) the router routes coherently from step 0 — each token goes to
the expert owning its embedding cluster (vs ≈1/E agreement for random
init), and (2) a few train steps run normally on the seeded params.  On
a card the fit's "auto" backend runs the hand-written CUDA kernels; the
line "kernel launches" counts them by wrapper and plan path (none on the
CPU, where each wrapper takes its plain PyTorch version).

    PYTHONPATH=src python examples/torch_moe_router_init.py
    PYTHONPATH=src python examples/torch_moe_router_init.py --device cpu
"""
import argparse
import dataclasses
import json

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.bigfcm import BigFCMConfig
from repro_torch.core.fcm import hard_assign
from repro_torch.data.synth import make_blobs
from repro_torch.integration import fcm_router_init
from repro_torch.kernels.fcm_update import launches_by_path
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import build
from repro_torch.models import DecoderLM
from repro_torch.models.moe import router_load
from repro_torch.sharding.rules import mesh_context


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)

    cfg = dataclasses.replace(reduced(get_config("olmoe-1b-7b")),
                              n_experts=16, top_k=4)
    mesh = make_host_mesh(device_type=dev.type)

    with mesh_context(mesh):
        model = DecoderLM(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)

        # A trained model's token embeddings cluster semantically; emulate
        # that structure with a mixture so the demo mirrors the real
        # use-case (cluster a TRAINED embed table / probe hidden states).
        tab, _ = make_blobs(cfg.vocab_padded, cfg.d_model, cfg.n_experts,
                            spread=0.15, sep=1.0, seed=3)
        with torch.no_grad():
            model.embed.table.copy_(torch.as_tensor(
                tab * cfg.d_model ** -0.5, dtype=model.embed.table.dtype))
        router = model.stages[0].layers[0].moe.w_router
        random_router = router.detach().clone()     # layer 0, before seeding

        # token "corpus" = the embedding table itself (N=vocab vectors)
        embeds = model.embed.table.detach().float()
        fcm_cfg = BigFCMConfig(n_clusters=cfg.n_experts, combiner_eps=1e-6,
                               max_iter=200, sample_size=256)
        _, res = fcm_router_init(model, cfg, embeds, mesh=mesh,
                                 fcm_cfg=fcm_cfg, scale=4.0, device=dev)

        # routing coherence: does the router's top-1 expert agree with the
        # token's FCM cluster?  (Random init routes arbitrarily ≈ 1/E; the
        # seeded router routes each embedding cluster to "its" expert.)
        toks = torch.randint(0, cfg.vocab, (512,), device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(1))
        xt = model.embed.table.detach()[toks].float()
        cluster = hard_assign(xt, res.centers.to(xt.dtype))

        def agreement(w_router):
            logits = xt @ w_router.float()
            load = router_load(cfg, {"w_router": w_router}, xt[None])
            return float((logits.argmax(1) == cluster).float().mean()), load

        agr_rand, load_rand = agreement(random_router)
        agr_fcm, load_fcm = agreement(router.detach())
        print(f"router/cluster top-1 agreement  random: {agr_rand:.3f}   "
              f"FCM-seeded: {agr_fcm:.3f}  (chance = "
              f"{1 / cfg.n_experts:.3f})")
        print(f"random load: {load_rand.tolist()}")
        print(f"fcm    load: {load_fcm.tolist()}")
        print("kernel launches:", json.dumps(launches_by_path()))
        assert agr_fcm > 0.9 > agr_rand

        # the seeded params train normally
        state, step_fn = build(cfg, device=dev, params=model)
        tok = torch.randint(0, cfg.vocab, (8, 32), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(2))
        losses = []
        for i in range(5):
            state, metrics = step_fn(state, {"tokens": tok, "labels": tok})
            losses.append(float(metrics["loss"]))
        print(f"5 train steps on seeded params, loss: "
              f"{[round(l, 3) for l in losses]}")
        assert losses[-1] < losses[0]
        print("OK -- FCM-seeded router routes coherently "
              f"({agr_fcm:.0%} cluster agreement vs {agr_rand:.0%} random) "
              "and trains.")


if __name__ == "__main__":
    main()
