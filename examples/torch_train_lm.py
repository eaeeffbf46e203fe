"""End-to-end LM training on the PyTorch/CUDA port: ~100M-param
qwen2-family model, a few hundred steps on synthetic bigram-structured
data, with atomic async checkpointing and crash-restart.

    PYTHONPATH=src python examples/torch_train_lm.py              # full run (~100M)
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --tiny

Restart demo: interrupt it and rerun with the same ``--ckpt-dir`` — it
resumes from the last checkpoint (`repro_torch.ft.checkpoint`, the same
manager the sharded launcher uses; state here is just smaller).
"""
import argparse
import dataclasses
import tempfile

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import train


def model_100m():
    """qwen2 family scaled to ≈100M params (12L × 768d, tied embeddings)."""
    return dataclasses.replace(
        get_config("qwen2-1.5b"),
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=2, d_ff=2048,
        vocab=50304, head_dim=64, tie_embeddings=True,
        compute_dtype="float32", param_dtype="float32",
        attn_chunk=0, loss_chunk=128, remat=False)


def model_tiny():
    return dataclasses.replace(
        model_100m(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=512, head_dim=16)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args()

    cfg = model_tiny() if args.tiny else model_100m()
    steps = args.steps or (60 if args.tiny else 300)
    batch = args.batch or (8 if args.tiny else 4)
    seq = args.seq or (64 if args.tiny else 256)
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_ckpt_")
    mesh = make_host_mesh(device_type=args.device)

    print(f"training {cfg.name}-derived model for {steps} steps "
          f"(batch={batch}, seq={seq}) on {args.device}; checkpoints -> "
          f"{ckpt}")
    _, history = train(cfg, mesh, steps=steps, batch=batch, seq=seq,
                       ckpt_dir=ckpt, ckpt_every=max(steps // 4, 10),
                       device=args.device)
    n = max(len(history) // 10, 1)
    first, last = (sum(history[:n]) / n, sum(history[-n:]) / n)
    print(f"loss: first-{n} avg {first:.4f} -> last-{n} avg {last:.4f}")
    assert last < first, "loss did not decrease"
    print("OK -- loss decreased; rerun the same command to test restart.")


if __name__ == "__main__":
    main()
