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
            "repro_torch.serve.tenant"} <= set(out["modules"])
    assert out["leaked"] == []


def test_entry_point_raises_without_a_card():
    out = _run(_NO_CARD, CUDA_VISIBLE_DEVICES="")
    assert out.startswith("raised:") and "device='cpu'" in out


def test_tenant_fit_raises_without_a_card():
    out = _run(_NO_CARD_TENANT, CUDA_VISIBLE_DEVICES="")
    assert out.startswith("raised:") and "device='cpu'" in out
