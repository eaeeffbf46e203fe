"""The dry run (`repro_torch.launch.dryrun`) against the reference's
(`repro.launch.dryrun`) and against real runs of the same steps.

(a) `Roofline` on the same inputs as the reference's: each time term
times its rate is the same work, the useful-FLOPs ratio and the
bottleneck (on inputs where one term leads under both rate tables) are
the reference's.  (b) Every (arch × shape × mesh × profile) cell's id,
skip status and reason, and every (arch × shape)'s ``model_flops_for``,
``step_flops`` and ``step_hbm_bytes``, equal to the reference's (its
``run_cell`` with ``lower_cell`` stubbed, so nothing is lowered).  (c)
Reduced Qwen2, OLMoE, Mamba2, Zamba2 and Whisper under small shape cells
(train, prefill, decode at batches of 8, 4 and 1) traced as rank 0 of
an 8-rank fake group on a (2, 4) mesh, and a dense and a MoE train cell
under "fsdp" at a batch of 4, whose sequence splits over "model":
``argument_size_in_bytes`` equal
to the byte to the reference's ``memory_analysis`` of its compiled
``lower_cell`` on 8 forced devices of a `jax.sharding.Mesh` (auto axes:
``run_cell``'s ``jax.make_mesh`` gives explicit axes, under which its
embedding raises), and the status the same.  Cells the reference
refuses on its own placements are left out (tests/test_torch_serve_mp.py
names them); the two split cells' FLOPs a rank within 0.85–1.15 of
``step_flops`` / 8.  (d) One reduced train cell a family kind (dense
under "tp", MoE under "fsdp", its all-to-all branch) and the two split
cells: the fake trace's bytes
by collective kind and its counted FLOPs equal, byte for byte, rank 0's
of the same step run on real zeros on 8 spawned gloo ranks, and its
count of c10d calls ``CommDebugMode``'s.  (e) The
full-size ``qwen2-1.5b`` ``decode_32k`` pod1 cell through the CLI
(``--device cpu``), rendered by ``benchmarks/roofline_table.py``.

The reference runs in a subprocess on 512 forced CPU devices, the fake
traces and the CLI in subprocesses of their own, side by side with the
gloo ranks."""
import json
import os
import pickle
import re
import subprocess
import sys
import tempfile
import textwrap

import pytest

from repro_torch import mesh as M
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.configs.base import SHAPES, shape_cell
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs as TS
from repro_torch.launch.flops_model import step_flops, step_hbm_bytes
from repro_torch.launch.roofline import model_flops_for
from repro_torch.perf import roofline as R
from repro_torch.sharding import profile_context

import torch_dryrun_jobs as J

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
DEADLINE_S = 420.0
V5E = {"flops": 197e12, "hbm": 819e9, "link": 50e9}   # the reference's
ROOFS = [(1e15, 1e9, 1e6, 3e17, 256),        # compute leads
         (1e9, 1e12, 1e6, 3e11, 256),        # memory leads
         (1e9, 1e6, 1e10, 3e11, 512)]        # collectives lead
# (name, arch, profile, kind, seq, batch)
CASES = []
for _arch in ("qwen2-1.5b", "olmoe-1b-7b", "mamba2-2.7b", "zamba2-7b",
              "whisper-medium"):
    # the reference refuses a batch of 1 in its MoE shard_map, and an SSM
    # conv cache at 8 under fsdp (tests/test_torch_serve_mp.py)
    _tp_dec = 8 if _arch == "olmoe-1b-7b" else 1
    _fsdp_dec = 1 if _arch in ("mamba2-2.7b", "zamba2-7b") else 8
    for _profile, _kind, _seq, _b in (("tp", "train", 16, 8),
                                      ("tp", "decode", 16, _tp_dec),
                                      ("fsdp", "prefill", 16, 4),
                                      ("fsdp", "decode", 16, _fsdp_dec)):
        CASES.append((f"{_arch}/{_profile}/{_kind}/b{_b}", _arch, _profile,
                      _kind, _seq, _b))
# train cells under "fsdp" whose batch of 4 leaves "model" out: their 16
# positions split over it (4 a rank)
SPLIT = [(f"{arch}/fsdp/train/b4", arch, "fsdp", "train", 16, 4)
         for arch in ("qwen2-1.5b", "olmoe-1b-7b")]
CASES += SPLIT
REAL = [("dense/tp/train", "qwen2-1.5b", "tp", "train", 16, 8),
        ("moe/fsdp/train", "olmoe-1b-7b", "fsdp", "train", 16, 8),
        ("dense/fsdp/train/b4", "qwen2-1.5b", "fsdp", "train", 16, 4),
        ("moe/fsdp/train/b4", "olmoe-1b-7b", "fsdp", "train", 16, 4)]
FLOPS_BAND = (0.85, 1.15)       # counted against step_flops (PERF.md §2)

_REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import pickle, sys
    sys.path.insert(0, {src!r})
    import jax, numpy as np
    from jax.sharding import Mesh
    import repro.launch.dryrun as RD
    from repro.configs import ARCHS, get_config, reduced
    from repro.configs.base import SHAPES, ShapeCell
    from repro.launch.flops_model import step_flops, step_hbm_bytes
    from repro.launch.roofline import Roofline, model_flops_for
    from repro.sharding.rules import mesh_context, profile_context

    args = pickle.load(open({inp!r}, "rb"))
    out = {{"roofline": []}}
    for flops, hbm, coll, mf, n in args["roofs"]:
        r = Roofline(flops, hbm, coll, {{}}, mf, n)
        out["roofline"].append(dict(
            t_compute=r.t_compute, t_memory=r.t_memory,
            t_collective=r.t_collective, bottleneck=r.bottleneck,
            useful=r.useful_flops_ratio))

    def not_lowered(*a, **k):
        raise RuntimeError("not lowered")
    lower_cell, RD.lower_cell = RD.lower_cell, not_lowered
    out["cells"] = {{}}
    for arch in ARCHS:
        for shape in SHAPES:
            for pod in (False, True):
                for profile in ("tp", "fsdp"):
                    rec = RD.run_cell(arch, shape.name, pod, None,
                                      verbose=False, profile=profile)
                    out["cells"][rec["cell"]] = {{
                        k: v for k, v in rec.items()
                        if k not in ("error", "traceback")}}
    RD.lower_cell = lower_cell
    out["flops"] = {{}}
    for arch in ARCHS:
        cfg = get_config(arch)
        for cell in SHAPES:
            out["flops"][arch, cell.name] = (
                model_flops_for(cfg, cell), step_flops(cfg, cell),
                step_hbm_bytes(cfg, cell, RD.optimizer_name(cfg)))

    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4),
                ("data", "model"))
    out["args"] = {{}}
    for name, arch, profile, kind, seq, b in args["cases"]:
        cfg = reduced(get_config(arch))
        cell = ShapeCell(f"{{kind}}_{{seq}}x{{b}}", seq, b, kind)
        try:
            with profile_context(profile), mesh_context(mesh), mesh:
                mem = RD.lower_cell(cfg, cell, mesh).compile() \\
                    .memory_analysis()
            out["args"][name] = {{"status": "ok", "argument_size_in_bytes":
                                  int(mem.argument_size_in_bytes)}}
        except Exception as e:
            out["args"][name] = {{"status": "error",
                                  "error": f"{{type(e).__name__}}: {{e}}"}}
    pickle.dump(out, open({out!r}, "wb"))
""")


def _wait(proc, deadline_s):
    try:
        out, err = proc.communicate(timeout=deadline_s)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, (out or "")[-2000:] + (err or "")[-3000:]
    return out


@pytest.fixture(scope="module")
def runs():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    with tempfile.TemporaryDirectory() as tmp:
        def path(name):
            return os.path.join(tmp, name)
        with open(path("ref_in.pkl"), "wb") as f:
            pickle.dump(dict(roofs=ROOFS, cases=CASES), f)
        with open(path("fake_in.pkl"), "wb") as f:
            pickle.dump((CASES, REAL), f)
        pipes = dict(stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                     text=True, env=env)
        ref = subprocess.Popen(
            [sys.executable, "-c", _REFERENCE.format(
                src=os.path.abspath(SRC), inp=path("ref_in.pkl"),
                out=path("ref_out.pkl"))], **pipes)
        fake = subprocess.Popen(
            [sys.executable, os.path.join(os.path.dirname(__file__),
                                          "torch_dryrun_jobs.py"),
             path("fake_in.pkl"), path("fake_out.pkl")], **pipes)
        cli = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun",
             "--arch", "qwen2-1.5b", "--shape", "decode_32k",
             "--device", "cpu", "--out-dir", path("cli")], **pipes)
        try:
            real = M.spawn_mesh(J.real_cells, J.SHAPE, J.NAMES,
                                backend="gloo", device_type="cpu",
                                timeout_s=DEADLINE_S, args=(REAL,))
        except BaseException:
            for p in (ref, fake, cli):
                p.kill()
            raise
        cli_out = _wait(cli, DEADLINE_S)
        _wait(fake, DEADLINE_S)
        _wait(ref, DEADLINE_S)
        table = subprocess.run(
            [sys.executable, "-m", "benchmarks.roofline_table", "--dir",
             path("cli")], capture_output=True, text=True, cwd=ROOT,
            timeout=60)
        with open(path("ref_out.pkl"), "rb") as f:
            want = pickle.load(f)
        with open(path("fake_out.pkl"), "rb") as f:
            got = pickle.load(f)
        with open(path("cli/qwen2-1.5b__decode_32k__pod1.json")) as f:
            record = json.load(f)
    return dict(want=want, got=got, real=real, cli=cli_out, record=record,
                table=table)


@pytest.mark.parametrize("i", range(len(ROOFS)))
def test_roofline_matches_reference(runs, i):
    flops, hbm, coll, mf, n = ROOFS[i]
    want = runs["want"]["roofline"][i]
    got = R.Roofline(flops, hbm, coll, {}, mf, n)
    assert got.t_compute * R.PEAK_FLOPS == pytest.approx(
        want["t_compute"] * V5E["flops"], rel=1e-12)
    assert got.t_memory * R.HBM_BW == pytest.approx(
        want["t_memory"] * V5E["hbm"], rel=1e-12)
    assert got.t_collective * R.LINK_BW == pytest.approx(
        want["t_collective"] * V5E["link"], rel=1e-12)
    assert got.bottleneck == want["bottleneck"]
    assert got.useful_flops_ratio == want["useful"]
    assert got.mfu_bound == pytest.approx(
        mf / (got.t_bound * n * R.PEAK_FLOPS), rel=1e-12)
    assert set(got.to_dict()) == {
        "flops_per_dev", "hbm_bytes_per_dev", "coll_bytes_per_dev",
        "coll_breakdown", "model_flops", "n_devices", "t_compute_s",
        "t_memory_s", "t_collective_s", "bottleneck", "useful_flops_ratio",
        "mfu_bound"}


def test_cells_match_reference(runs):
    """Every cell's id, skip status and reason; the cells the reference
    lowers (stubbed: its "error") are the ones the port traces."""
    want = runs["want"]["cells"]
    n = 0
    for arch in ARCHS:
        for shape in SHAPES:
            for pod in (False, True):
                for profile in ("tp", "fsdp"):
                    _, _, rec = D.cell_record(arch, shape.name, pod,
                                              profile)
                    ref = dict(want[rec["cell"]])
                    if ref["status"] == "error":
                        ref.pop("status")
                    assert rec == ref, rec["cell"]
                    n += 1
    assert n == len(want) == 160


def test_flops_models_match_reference(runs):
    for arch in ARCHS:
        cfg = get_config(arch)
        for cell in SHAPES:
            got = (model_flops_for(cfg, cell), step_flops(cfg, cell),
                   step_hbm_bytes(cfg, cell, TS.optimizer_name(cfg)))
            assert got == runs["want"]["flops"][arch, cell.name], \
                (arch, cell.name)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_argument_bytes_match_reference(runs, case):
    name = case[0]
    want = runs["want"]["args"][name]
    got = runs["got"][name]
    assert got["status"] == want["status"], (got.get("traceback"),
                                             want.get("error"))
    assert got["memory"]["argument_size_in_bytes"] == \
        want["argument_size_in_bytes"]


@pytest.mark.parametrize("case", REAL, ids=[c[0] for c in REAL])
def test_fake_trace_moves_what_a_real_run_moves(runs, case):
    name = case[0]
    fake, real = runs["got"][name], runs["real"][0][name]
    assert fake["status"] == real["status"] == "ok", (
        fake.get("traceback"), real.get("traceback"))
    assert fake["kinds"] == real["kinds"]
    assert fake["flops"] == real["flops"]
    assert fake["calls"] == real["calls"]
    # torch's own count of the c10d calls, the cross-check
    assert fake["comm_debug_calls"] == fake["calls"] == \
        real["comm_debug_calls"]
    assert sum(fake["kinds"].values()) > 0
    if case[2] == "fsdp" and "moe" in name:
        assert fake["kinds"]["all-to-all"] > 0
    # K/V (and the MoE layer's input) gathered where the sequence splits
    split = case[5] == 4
    assert (fake["seq_gather_bytes"] > 0) == split
    assert fake["seq_gather_bytes"] == real["seq_gather_bytes"]


@pytest.mark.parametrize("case", SPLIT, ids=[c[0] for c in SPLIT])
def test_split_cell_counts_a_ranks_share_of_the_flops(runs, case):
    """With the sequence split over "model" a rank runs its eighth of
    the step — not the whole rows' work, replicated over "model" — the
    trace's FLOPs within the band of ``step_flops`` / 8."""
    name, arch, _, kind, seq, b = case
    got = runs["got"][name]
    assert got["status"] == "ok", got.get("traceback")
    want = step_flops(reduced(get_config(arch)),
                      J.shape_cell(kind, seq, b)) / 8
    lo, hi = FLOPS_BAND
    assert lo <= got["flops"] / want <= hi, (got["flops"], want)
    assert got["seq_gather_bytes"] > 0


def test_full_size_cell_through_the_cli(runs):
    rec = runs["record"]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["cell"] == "qwen2-1.5b__decode_32k__pod1"
    assert rec["t_compile_s"] == 0.0 and rec["t_lower_s"] > 0
    mem = rec["memory_analysis"]
    cfg = get_config("qwen2-1.5b")
    cell = shape_cell("decode_32k")
    with profile_context("tp"):
        args = TS.block_bytes(TS.step_arguments(
            cfg, cell, M.AbstractMesh((16, 16), ("data", "model"))))
    assert mem["argument_size_in_bytes"] == args
    assert rec["peak_bytes_per_rank"] <= rec["card_memory_bytes"]
    roof = rec["roofline"]
    assert roof["n_devices"] == 256
    assert roof["coll_bytes_per_dev"] == sum(roof["coll_breakdown"].values())
    assert roof["coll_breakdown"]["all-gather"] > 0
    assert roof["model_flops"] == model_flops_for(cfg, cell)
    assert runs["table"].returncode == 0, runs["table"].stderr
    row = [l for l in runs["table"].stdout.splitlines()
           if l.startswith("| qwen2-1.5b | decode_32k |")]
    assert len(row) == 1 and roof["bottleneck"] in row[0]
    assert "roofline ==" in runs["cli"]


def test_no_tpu_constant_in_the_port():
    """The port's rates are the card's: no v5e figure appears in it."""
    pat = re.compile(r"197e12|819e9|\bICI")
    for base, _, files in os.walk(os.path.join(SRC, "repro_torch")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(base, f)) as fh:
                    assert not pat.search(fh.read()), f

