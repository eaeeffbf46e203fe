"""Batched serving on the PyTorch/CUDA port: prefill a batch of prompts,
then step the KV-cached decode loop — the `serve_step` the
decode_32k/long_500k dry-run cells trace, exercised end-to-end on a
reduced config.

    PYTHONPATH=src python examples/torch_serve_batch.py
    PYTHONPATH=src python examples/torch_serve_batch.py --device cpu
"""
import argparse
import time

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import synchronize
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import DecoderLM
from repro_torch.models import transformer as tf
from repro_torch.serve import greedy_generate
from repro_torch.sharding.rules import mesh_context

BATCH, PROMPT, NEW = 8, 24, 16


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)

    cfg = reduced(get_config("stablelm-12b"))
    mesh = make_host_mesh(device_type=dev.type)

    with mesh_context(mesh), torch.inference_mode():
        model = DecoderLM(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
        prompts = torch.randint(
            0, cfg.vocab, (BATCH, PROMPT), device=dev,
            generator=torch.Generator(device=dev).manual_seed(1))

        # decode path: prefill once, then one token per serve_step
        t0 = time.perf_counter()
        toks = greedy_generate(cfg, model, {"tokens": prompts},
                               max_new=NEW, max_len=PROMPT + NEW, device=dev)
        synchronize(dev)
        t_gen = time.perf_counter() - t0
        assert toks.shape == (BATCH, NEW)
        assert int(toks.max()) < cfg.vocab and int(toks.min()) >= 0

        # consistency: cached decode == uncached full forward (greedy)
        full = torch.cat([prompts, toks[:, :-1].to(prompts.dtype)], dim=1)
        hidden = model(full)
        logits = tf.logits_fn(cfg, model, hidden)
        uncached = torch.argmax(logits[:, PROMPT - 1:], dim=-1)
        agree = float((uncached == toks).float().mean())
        print(f"generated {BATCH}×{NEW} tokens in {t_gen:.2f}s "
              f"({BATCH * NEW / t_gen:.0f} tok/s on {dev.type})")
        print(f"cached-decode vs full-forward agreement: {agree:.3f}")
        assert agree > 0.99, agree
        print("OK -- batched KV-cached serving matches the uncached oracle.")


if __name__ == "__main__":
    main()
