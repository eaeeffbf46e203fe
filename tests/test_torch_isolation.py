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
            "repro_torch.baselines.kmeans"} \
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
                   "repro_torch.baselines.kmeans"):
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
