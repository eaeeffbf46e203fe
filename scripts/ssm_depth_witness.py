#!/usr/bin/env python3
"""The SSD's f32 gap between cached decode and one forward, by depth, in
the reference (`repro`) and in the port (`repro_torch`), on the CPU:

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/ssm_depth_witness.py \
        [--layers 16 64] [--d-model 64] [--chunk 256] [--seed 0]

A Mamba2 stack (family "ssm", state 32, head dim 16) of each depth, f32,
the reference's `tree_init` parameters from ``--seed`` carried across by
`from_reference`: a cached prefill of 2 chunks, then one chunk of tokens
one at a time (the decode step), against one forward over all of them
(whole chunks: the reference asserts S % chunk == 0), on the hidden
states of the decoded positions.  Printed per depth: each package's
largest |decode − forward|, the values past tests/test_models.py's bar
(rtol 5e-3, atol 5e-4), and the port's forward against the reference's.
At Mamba2's chunk of 256 (about 5 minutes) both packages keep the bar at
16 layers and miss it at 64.
chip_smoke.py's ``lm_ssm`` / ``lm_hybrid`` hold that bar on their first
layers and print the gap deeper in (32 / 39 layers).

One JSON line per depth.  Like the parity tests, it imports both packages.
"""
from __future__ import annotations

import argparse
import json

RTOL, ATOL = 5e-3, 5e-4


def gap(dec, full):
    import numpy as np
    dec, full = np.asarray(dec, np.float64), np.asarray(full, np.float64)
    diff = np.abs(dec - full)
    return float(diff.max()), int((diff > ATOL + RTOL * np.abs(full)).sum())


def run(layers, d_model, chunk, seed) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from repro.configs.base import ModelConfig as RefConfig
    from repro.models import transformer as rtf
    from repro.models.params import tree_init
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import DecoderLM
    from repro_torch.models import transformer as ttf
    from repro_torch.models.params import from_reference

    kw = dict(name="ssm", family="ssm", n_layers=layers, d_model=d_model,
              n_heads=1, n_kv_heads=1, d_ff=0, vocab=512, ssm_state=32,
              ssm_head_dim=16, ssm_chunk=chunk, compute_dtype="float32",
              param_dtype="float32")
    rcfg, tcfg = RefConfig(**kw), ModelConfig(**kw)
    params = tree_init(jax.random.PRNGKey(seed), rtf.decl(rcfg))
    model = DecoderLM(tcfg, device="cpu")
    model.load_state_dict(from_reference(
        jax.tree_util.tree_map(np.asarray, params), device="cpu"))
    p, n = 2 * chunk, chunk
    tok = np.random.default_rng(seed).integers(0, 512, (2, p + n)).astype(
        np.int32)

    with torch.inference_mode():
        full = model(torch.from_numpy(tok))[:, p - 1:]
        caches = ttf.init_caches(tcfg, 2, p + n, torch.float32, "cpu")
        h, caches = model(torch.from_numpy(tok[:, :p]), caches=caches)
        outs = [h[:, -1]]
        for t in range(n):
            h, caches = model(torch.from_numpy(tok[:, p + t:p + t + 1]),
                              caches=caches)
            outs.append(h[:, 0])
        dec = torch.stack(outs, 1)

    r_full = rtf.forward(rcfg, params, jnp.asarray(tok))[:, p - 1:]
    r_caches = rtf.init_caches(rcfg, 2, p + n, jnp.float32)
    h, r_caches = rtf.forward(rcfg, params, jnp.asarray(tok[:, :p]),
                              caches=r_caches)
    outs = [h[:, -1]]
    for t in range(n):
        h, r_caches = rtf.forward(rcfg, params,
                                  jnp.asarray(tok[:, p + t:p + t + 1]),
                                  caches=r_caches)
        outs.append(h[:, 0])
    r_dec = jnp.stack(outs, 1)

    port_err, port_past = gap(dec.numpy(), full.numpy())
    ref_err, ref_past = gap(r_dec, r_full)
    return {"layers": layers, "d_model": d_model, "chunk": chunk,
            "prefill": p, "steps": n, "rtol": RTOL, "atol": ATOL,
            "port_max_abs": port_err, "port_past_bar": port_past,
            "reference_max_abs": ref_err, "reference_past_bar": ref_past,
            "port_vs_reference_forward": gap(full.numpy(), r_full)[0],
            "hidden_scale": float(np.abs(np.asarray(r_full)).max())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[16, 64])
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    for layers in args.layers:
        print(json.dumps(run(layers, args.d_model, args.chunk, args.seed)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
