"""`repro_torch` stands alone: importing it and every submodule loads
neither `jax` nor anything of `repro`, and an entry point asked for the
card on a host without one raises instead of running on the CPU."""
import json
import os
import subprocess
import sys

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "jaxlib"))
                or m == "repro" or m.startswith("repro."))
print(json.dumps({"modules": names, "leaked": leaked}))
"""

_NO_CARD = """
import numpy as np
from repro_torch.core import BigFCMConfig, bigfcm_fit
x = np.zeros((16, 2), np.float32)
try:
    bigfcm_fit(x, BigFCMConfig(n_clusters=2))
except RuntimeError as e:
    print("raised:", e)
else:
    print("ran")
"""


_NO_CARD_TENANT = """
import numpy as np
from repro_torch.tenant import TenantFitConfig, fit_tenants
try:
    fit_tenants([np.zeros((8, 2), np.float32)], TenantFitConfig(n_clusters=2))
except RuntimeError as e:
    print("raised:", e)
else:
    print("ran")
"""


_NO_CARD_STORE = """
import numpy as np
from repro_torch.baselines import mr_fuzzy_kmeans_store
from repro_torch.core import BigFCMConfig, bigfcm_fit_store, ooc_fcm
from repro_torch.data import ChunkStore, batched
from repro_torch.serve import assign_store
x = np.zeros((16, 2), np.float32)
store = ChunkStore.ingest(x, chunk_rows=8)
calls = (lambda: bigfcm_fit_store(store, BigFCMConfig(n_clusters=2)),
         lambda: ooc_fcm(lambda: batched(store.iter_chunks(), 8), x[:2]),
         lambda: mr_fuzzy_kmeans_store(store, x[:2]),
         lambda: list(assign_store(store, x[:2])))
for call in calls:
    try:
        call()
    except RuntimeError as e:
        print("raised:", e)
    else:
        print("ran")
"""


_ALONE = """
import json, sys
import {module}
print(json.dumps(sorted(m for m in sys.modules
                        if m == "jax" or m.startswith(("jax.", "jaxlib"))
                        or m == "repro" or m.startswith("repro."))))
"""


_NO_CARD_STREAM = """
import numpy as np
from repro_torch.data import ShardedLoader, stream_loader
from repro_torch.stream import StreamConfig, StreamingBigFCM
x = np.zeros((16, 2), np.float32)
calls = (lambda: StreamingBigFCM(StreamConfig(n_clusters=2)),
         lambda: stream_loader(iter([x]), 8),
         lambda: ShardedLoader(x, 8))
for call in calls:
    try:
        call()
    except RuntimeError as e:
        print("raised:", e)
    else:
        print("ran")
"""


def _run(code, **env):
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, check=True,
        env={**os.environ, "PYTHONPATH": SRC, **env}).stdout


def test_import_loads_no_jax_and_no_reference_module():
    out = json.loads(_run(_IMPORT_ALL).strip().splitlines()[-1])
    assert {"repro_torch.engine.backend", "repro_torch.kernels.fcm_update",
            "repro_torch.kernels.build", "repro_torch.core.bigfcm",
            "repro_torch.data.synth", "repro_torch.data.plane",
            "repro_torch.tenant", "repro_torch.tenant.core",
            "repro_torch.tenant.fit", "repro_torch.serve",
            "repro_torch.serve.tenant", "repro_torch.data.cache",
            "repro_torch.core.outofcore", "repro_torch.serve.cluster",
            "repro_torch.baselines", "repro_torch.baselines.mr_fkm",
            "repro_torch.ft", "repro_torch.ft.checkpoint",
            "repro_torch.stream", "repro_torch.stream.streaming",
            "repro_torch.stream.window", "repro_torch.stream.drift",
            "repro_torch.data.stream", "repro_torch.data.loader",
            "repro_torch.obs", "repro_torch.obs.metrics",
            "repro_torch.obs.trace", "repro_torch.obs.report",
            "repro_torch.serve.scorer", "repro_torch.serve.service",
            "repro_torch.perf", "repro_torch.perf.microbench",
            "repro_torch.perf.roofline", "repro_torch.perf.calibrate",
            "repro_torch.perf.autotune", "repro_torch.fleet",
            "repro_torch.fleet.host", "repro_torch.fleet.wire",
            "repro_torch.fleet.transport", "repro_torch.fleet.sim",
            "repro_torch.fleet.proc", "repro_torch.ft.elastic",
            "repro_torch.baselines.kmeans", "repro_torch.mesh",
            "repro_torch.fleet.spmd", "repro_torch.core.metrics",
            "repro_torch.sharding", "repro_torch.sharding.rules",
            "repro_torch.sharding.spmd",
            "repro_torch.integration", "repro_torch.integration.router_init",
            "repro_torch.integration.curriculum", "repro_torch.configs",
            "repro_torch.configs.base", "repro_torch.configs.qwen2_1_5b",
            "repro_torch.models", "repro_torch.models.params",
            "repro_torch.models.layers", "repro_torch.models.attention",
            "repro_torch.models.transformer", "repro_torch.models.moe",
            "repro_torch.models.mamba", "repro_torch.models.encdec",
            "repro_torch.serve.decode", "repro_torch.optim",
            "repro_torch.optim.optimizers", "repro_torch.optim.schedule",
            "repro_torch.train", "repro_torch.train.step",
            "repro_torch.train.dp", "repro_torch.data.lm",
            "repro_torch.launch", "repro_torch.launch.mesh",
            "repro_torch.launch.specs", "repro_torch.launch.train",
            "repro_torch.launch.flops_model", "repro_torch.launch.roofline"} \
        <= set(out["modules"])
    assert out["leaked"] == []


def test_entry_point_raises_without_a_card():
    out = _run(_NO_CARD, CUDA_VISIBLE_DEVICES="")
    assert out.startswith("raised:") and "device='cpu'" in out


def test_store_entry_points_raise_without_a_card():
    out = _run(_NO_CARD_STORE, CUDA_VISIBLE_DEVICES="").splitlines()
    assert len(out) == 4
    assert all(ln.startswith("raised:") and "device='cpu'" in ln
               for ln in out)


def test_tenant_fit_raises_without_a_card():
    out = _run(_NO_CARD_TENANT, CUDA_VISIBLE_DEVICES="")
    assert out.startswith("raised:") and "device='cpu'" in out


def test_stream_modules_alone_load_no_jax_and_no_reference_module():
    for module in ("repro_torch.stream", "repro_torch.data.stream",
                   "repro_torch.data.loader"):
        out = _run(_ALONE.format(module=module)).strip().splitlines()[-1]
        assert json.loads(out) == [], module


def test_obs_alone_loads_no_jax_and_no_reference_module():
    """The obs plane is an own copy: it and its report entry point load
    nothing of `repro` (nor jax), and ``python -m`` runs the report."""
    for module in ("repro_torch.obs", "repro_torch.obs.report"):
        out = _run(_ALONE.format(module=module)).strip().splitlines()[-1]
        assert json.loads(out) == [], module
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report"],
        capture_output=True, text=True, timeout=300, check=True,
        env={**{k: v for k, v in os.environ.items()
                if k != "REPRO_OBS_DIR"}, "PYTHONPATH": SRC}).stdout
    assert "phase breakdown" in out


def test_stream_entry_points_raise_without_a_card():
    out = _run(_NO_CARD_STREAM, CUDA_VISIBLE_DEVICES="").splitlines()
    assert len(out) == 3
    assert all(ln.startswith("raised:") and "device='cpu'" in ln
               for ln in out)


def test_serve_and_perf_alone_load_no_jax_and_no_reference_module():
    """The serving front end (`ScoringService` is an own copy of the
    reference's numpy-and-threads module) and the perf plane load
    nothing of `repro` (nor jax)."""
    for module in ("repro_torch.serve", "repro_torch.serve.service",
                   "repro_torch.perf"):
        out = _run(_ALONE.format(module=module)).strip().splitlines()[-1]
        assert json.loads(out) == [], module


_NO_CARD_SERVE = """
import numpy as np
from repro_torch.perf import probe_peaks, tune_sweep_blocks
from repro_torch.serve import CenterSnapshot, Scorer
calls = (lambda: Scorer(CenterSnapshot(0, np.zeros((2, 3), np.float32)),
                        backend="torch"),
         lambda: probe_peaks(),
         lambda: tune_sweep_blocks((256, 2, 3)))
for call in calls:
    try:
        call()
    except RuntimeError as e:
        print("raised:", e)
    else:
        print("ran")
"""


def test_serve_and_perf_entry_points_raise_without_a_card():
    out = _run(_NO_CARD_SERVE, CUDA_VISIBLE_DEVICES="").splitlines()
    assert len(out) == 3
    assert all(ln.startswith("raised:") and "device='cpu'" in ln
               for ln in out)


_ALONE_NO_ML_DTYPES = """
import json, sys
import {module}
print(json.dumps(sorted(m for m in sys.modules
                        if m == "jax" or m.startswith(("jax.", "jaxlib"))
                        or m == "ml_dtypes" or m.startswith("ml_dtypes.")
                        or m == "repro" or m.startswith("repro."))))
"""


def test_fleet_ft_and_baselines_alone_load_no_jax_ml_dtypes_or_reference():
    """The fleet (its wire codec rounds to bf16 itself), the straggler
    helpers and the baselines load no jax, no ``ml_dtypes`` (the card's
    machine has none) and nothing of `repro`."""
    for module in ("repro_torch.fleet", "repro_torch.fleet.wire",
                   "repro_torch.fleet.proc", "repro_torch.ft",
                   "repro_torch.ft.elastic", "repro_torch.baselines",
                   "repro_torch.baselines.kmeans", "repro_torch.mesh",
                   "repro_torch.fleet.spmd"):
        out = _run(_ALONE_NO_ML_DTYPES.format(module=module))
        assert json.loads(out.strip().splitlines()[-1]) == [], module


_NO_CARD_FLEET = """
import tempfile
import numpy as np
from repro_torch.baselines import mr_kmeans
from repro_torch.core import BigFCMConfig
from repro_torch.data import ChunkStore
from repro_torch.fleet import (FleetConfig, FleetHost, MailboxTransport,
                               fleet_fit, run_fleet)
x = np.zeros((16, 2), np.float32)
root = tempfile.mkdtemp()
store = ChunkStore.ingest(x, chunk_rows=8, cache_dir=root + "/store")
cfg = BigFCMConfig(n_clusters=2, backend="torch")
fleet = FleetConfig(n_hosts=2)
calls = (lambda: fleet_fit(store, cfg, fleet),
         lambda: FleetHost(0, store, cfg, fleet, MailboxTransport()),
         lambda: run_fleet(2, root + "/store", root + "/run",
                           cfg_kw=dict(n_clusters=2, backend="torch")),
         lambda: mr_kmeans(x, x[:2]))
for call in calls:
    try:
        call()
    except RuntimeError as e:
        print("raised:", e)
    else:
        print("ran")
host = FleetHost(0, store, cfg, fleet, MailboxTransport(), device="cpu")
print("cpu:", host.device, mr_kmeans(x, x[:2], device="cpu")[3])
"""


def test_fleet_and_kmeans_entry_points_raise_without_a_card():
    out = _run(_NO_CARD_FLEET, CUDA_VISIBLE_DEVICES="").splitlines()
    assert len(out) == 5
    assert all(ln.startswith("raised:") and "device='cpu'" in ln
               for ln in out[:4])
    assert out[4] == "cpu: cpu 1"


def test_mesh_on_cuda_raises_without_a_card():
    """A CUDA mesh (the default) whose card is missing raises, and so
    does spawning CUDA ranks — nothing is spawned; a CPU mesh is asked
    for by name.  The LM trainer's elastic restart mesh likewise:
    `make_mesh_for` raises on CUDA without a card, and gives the
    reference's (1, 1) on the CPU."""
    code = """
import tempfile
import torch.distributed as dist
from repro_torch import mesh as M
from repro_torch.ft import elastic_remesh, make_mesh_for
dist.init_process_group("gloo", init_method="file://" + tempfile.mkdtemp()
                        + "/rdv", rank=0, world_size=1)
for call in (lambda: M.make_mesh((1,), ("data",)),
             lambda: M.spawn_mesh(print, (2,), ("data",), backend="gloo")):
    try:
        call()
    except RuntimeError as e:
        print("raised:", e)
    else:
        print("ran")
print("cpu:", M.rank_device(M.make_mesh((1,), ("data",), device_type="cpu")))
try:
    make_mesh_for([0], model_parallel=2)
except RuntimeError as e:
    print("raised:", e)
else:
    print("ran")
m = make_mesh_for([0], model_parallel=2, device_type="cpu")
print("for:", tuple(m.mesh.shape), m.mesh_dim_names,
      elastic_remesh({}, (m, {}), m))
dist.destroy_process_group()
"""
    out = _run(code, CUDA_VISIBLE_DEVICES="").splitlines()
    assert len(out) == 5, out
    assert all(ln.startswith("raised:") and "device='cpu'" in ln
               for ln in out[:2] + out[3:4]), out
    assert out[2] == "cpu: cpu"
    assert out[4] == "for: (1, 1) ('data', 'model') {}"


def test_lm_modules_alone_load_no_jax_and_no_reference_module():
    """The LM slice (models, configs, integration, decode) loads nothing
    of `repro` (nor jax), each module on its own, every config too."""
    for module in ("repro_torch.models", "repro_torch.integration",
                   "repro_torch.configs", "repro_torch.serve.decode",
                   "repro_torch.sharding", "repro_torch.core.metrics",
                   "repro_torch.models.transformer"):
        out = _run(_ALONE.format(module=module)).strip().splitlines()[-1]
        assert json.loads(out) == [], module
    every_config = "repro_torch.configs as C; [C.get_config(a) for a in C.ARCHS]"
    out = _run(_ALONE.format(module=every_config)).strip().splitlines()[-1]
    assert json.loads(out) == []


_NO_CARD_LM = """
import numpy as np
import torch
from repro_torch.configs import get_config, reduced
from repro_torch.integration import curriculum_buckets, fcm_router_init
from repro_torch.models import DecoderLM
from repro_torch.models.params import tree_init
from repro_torch.models.transformer import decl, init_caches
from repro_torch.serve import greedy_generate
cfg = reduced(get_config("qwen2-1.5b"))
model = DecoderLM(cfg, torch.Generator().manual_seed(0), device="cpu")
batch = {"tokens": np.zeros((1, 4), np.int32)}
x = np.zeros((16, 2), np.float32)
moe = reduced(get_config("olmoe-1b-7b"))
calls = (lambda: DecoderLM(cfg),
         lambda: DecoderLM(cfg, torch.Generator().manual_seed(0)),
         lambda: greedy_generate(cfg, model, batch, max_new=2, max_len=8),
         lambda: init_caches(cfg, 1, 8),
         lambda: tree_init(torch.Generator(), decl(cfg)),
         lambda: curriculum_buckets(x, 2),
         lambda: fcm_router_init({"w_router": torch.zeros(2, 8)}, moe, x))
for call in calls:
    try:
        call()
    except RuntimeError as e:
        print("raised:", e)
    else:
        print("ran")
print("cpu:", greedy_generate(cfg, model, batch, max_new=2, max_len=8,
                              device="cpu").shape)
"""


def test_lm_entry_points_raise_without_a_card():
    """`DecoderLM`, `greedy_generate` and the rest of the LM slice on
    their default device raise on a host without a card; the CPU runs
    when asked for by name."""
    out = _run(_NO_CARD_LM, CUDA_VISIBLE_DEVICES="").splitlines()
    assert len(out) == 8, out
    assert all(ln.startswith("raised:") and "device='cpu'" in ln
               for ln in out[:7]), out
    assert out[7] == "cpu: torch.Size([1, 2])"


def test_training_modules_alone_load_no_jax_and_no_reference_module():
    """The training slice (optim, train, data.lm, launch) and the
    sharded LM's rules, FLOPs model, expert parallelism, explicit SPMD and
    elastic restart load nothing of `repro` (nor jax), each module on its
    own."""
    for module in ("repro_torch.optim", "repro_torch.train",
                   "repro_torch.train.dp", "repro_torch.data.lm",
                   "repro_torch.launch.mesh", "repro_torch.launch.specs",
                   "repro_torch.launch.train",
                   "repro_torch.launch.flops_model",
                   "repro_torch.launch.roofline",
                   "repro_torch.sharding.rules", "repro_torch.models.moe",
                   "repro_torch.sharding.spmd", "repro_torch.ft.elastic",
                   "repro_torch.ft.checkpoint"):
        out = _run(_ALONE.format(module=module)).strip().splitlines()[-1]
        assert json.loads(out) == [], module


_NO_CARD_TRAIN = """
from repro_torch.configs import get_config, reduced
from repro_torch.launch.train import build, train
cfg = reduced(get_config("qwen2-1.5b"))
calls = (lambda: build(cfg),
         lambda: train(cfg, steps=1, batch=1, seq=4, log_fn=lambda s: None))
for call in calls:
    try:
        call()
    except RuntimeError as e:
        print("raised:", e)
    else:
        print("ran")
state, _ = build(cfg, device="cpu")
print("cpu:", next(state.params.parameters()).device)
"""


def test_trainer_raises_without_a_card():
    """The trainer on its default device raises on a host without a card;
    the CPU runs when asked for by name."""
    out = _run(_NO_CARD_TRAIN, CUDA_VISIBLE_DEVICES="").splitlines()
    assert len(out) == 3, out
    assert all(ln.startswith("raised:") and "device='cpu'" in ln
               for ln in out[:2]), out
    assert out[2] == "cpu: cpu"


_ALL = """
import json, sys
for m in {modules!r}:
    __import__(m)
print(json.dumps(sorted(m for m in sys.modules
                        if m == "jax" or m.startswith(("jax.", "jaxlib"))
                        or m == "repro" or m.startswith("repro."))))
"""


def test_dryrun_and_sharded_serving_load_no_jax_and_no_reference_module():
    """The dry run and every module it runs (the roofline layer, the mesh
    under a fake group, the sharded serving path, the batch rule) load
    nothing of `repro` (nor jax)."""
    modules = ("repro_torch.launch.dryrun", "repro_torch.launch.roofline",
               "repro_torch.perf.roofline", "repro_torch.launch.specs",
               "repro_torch.launch.mesh", "repro_torch.launch.train",
               "repro_torch.mesh", "repro_torch.serve.decode",
               "repro_torch.sharding.spmd", "repro_torch.sharding.rules",
               "repro_torch.train.step", "repro_torch.models.attention",
               "repro_torch.models.mamba", "repro_torch.models.moe",
               "repro_torch.models.transformer",
               "repro_torch.models.encdec", "repro_torch.device")
    out = _run(_ALL.format(modules=modules)).strip().splitlines()[-1]
    assert json.loads(out) == []
