"""`repro_torch.launch.flops_model` and `repro_torch.launch.roofline`
against `repro.launch.flops_model` / `repro.launch.roofline`.

The analytic model is arithmetic on a config: the port gives the
reference's numbers (to 1e-12 relative) for every arch × shape cell.
The reference's own check (tests/test_flops_model.py), ported: the
FLOPs ``FlopCounterMode`` counts over the port's reduced Qwen2 train
step (4 layers, 4 × 128 tokens, remat off, f32) lie within 0.85–1.15 of
`step_flops`."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.launch.flops_model as RF
import repro.launch.roofline as RL
import repro_torch.configs as TC
import repro_torch.launch.flops_model as TF
import repro_torch.launch.roofline as TL
from repro_torch.launch.train import build

REL = 1e-12
CELLS = [c.name for c in TC.SHAPES]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("arch", list(TC.ARCHS))
def test_flops_and_bytes_match_reference(arch, cell):
    tcfg, rcfg = TC.get_config(arch), RC.get_config(arch)
    tcell, rcell = TC.shape_cell(cell), RC.base.shape_cell(cell)
    pairs = [(TF.step_flops(tcfg, tcell), RF.step_flops(rcfg, rcell)),
             (TF.param_bytes(tcfg), RF.param_bytes(rcfg)),
             (TL.active_params(tcfg), RL.active_params(rcfg)),
             (TL.model_flops_for(tcfg, tcell),
              RL.model_flops_for(rcfg, rcell))]
    for opt in ("adamw", "adafactor"):
        pairs.append((TF.step_hbm_bytes(tcfg, tcell, opt),
                      RF.step_hbm_bytes(rcfg, rcell, opt)))
    for got, want in pairs:
        assert want > 0
        assert abs(got - want) <= REL * abs(want), (got, want)
    assert isinstance(TL.active_params(tcfg), int)


@pytest.mark.parametrize("remat", [False, True])
def test_counted_step_flops_within_analytic_bar(remat):
    """One train step of reduced Qwen2 at 4 layers on 4 × 128 tokens,
    f32: the counted FLOPs within 0.85–1.15 of step_flops (remat adds a
    forward to both); every counted op is a product."""
    cfg = dataclasses.replace(TC.reduced(TC.get_config("qwen2-1.5b")),
                              n_layers=4, remat=remat)
    cell = TC.ShapeCell("tiny", 128, 4, "train")
    state, step = build(cfg, device="cpu", warmup=1, total_steps=2)
    tok = np.random.default_rng(0).integers(0, cfg.vocab, (4, 128))
    batch = {"tokens": tok.astype(np.int32),
             "labels": np.roll(tok, -1, 1).astype(np.int32)}
    got = TL.counted_flops(lambda: step(state, batch))
    ratio = TF.step_flops(cfg, cell) / got["total"]
    assert 0.85 < ratio < 1.15, (ratio, got["by_op"])
    assert set(got["by_op"]) <= {"aten.mm", "aten.addmm", "aten.bmm"}
    assert "aten.mul" in got["uncounted"]
    assert np.isfinite(float(got["result"][1]["loss"]))


def test_counted_flops_counts_bmm_with_out_dtype():
    """``bmm(out_dtype=)`` (`attention._BmmF32` on the card) counts as
    a bmm; on meta tensors, which every host has."""
    a = torch.empty(2, 3, 4, dtype=torch.bfloat16, device="meta")
    b = torch.empty(2, 4, 5, dtype=torch.bfloat16, device="meta")
    got = TL.counted_flops(lambda: torch.bmm(a, b, out_dtype=torch.float32))
    assert got["total"] == 2 * 2 * 3 * 4 * 5
    assert got["result"].dtype == torch.float32
