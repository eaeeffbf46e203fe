"""The port's examples (`examples/torch_*.py`) run end to end on the CPU.

Each runs with ``--device cpu`` at its smallest flags in a child
process of its own, all six side by side (two torch threads each): the
child runs the script through `runpy` as ``__main__``, then lists every
`jax` or `repro` module it loaded.  Each must exit 0, print the final
"OK" line of the reference example it ports (`examples/*.py`, whose
text holds the same line), and load nothing of jax or of the reference.
The children write their checkpoints and calibration under the test's
temporary directory."""
import json
import os
import subprocess
import sys
import time

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
EXAMPLES = os.path.join(ROOT, "examples")
DEADLINE_S = 400.0
# port example → (its smallest flags, the reference's final "OK" line)
CASES = {
    "torch_quickstart.py": (["--tiny"],
                            "OK -- BigFCM recovered the mixture centers"),
    "torch_stream_clustering.py": (
        [], "OK -- bounded-skew disorder is absorbed by the event-time "
            "window."),
    "torch_cluster_service.py": (
        ["--tiny"], "OK -- restart restores the clustering state "
                    "bit-exactly."),
    "torch_serve_batch.py": (
        [], "OK -- batched KV-cached serving matches the uncached oracle."),
    "torch_moe_router_init.py": (
        [], "OK -- FCM-seeded router routes coherently"),
    "torch_train_lm.py": (
        ["--tiny"], "OK -- loss decreased; rerun the same command to test "
                    "restart."),
}

_CHILD = """
import json, runpy, sys
sys.argv = [{path!r}] + {args!r}
try:
    runpy.run_path({path!r}, run_name="__main__")
finally:
    print("LOADED " + json.dumps(sorted(
        m for m in sys.modules
        if m == "jax" or m.startswith(("jax.", "jaxlib"))
        or m == "repro" or m.startswith("repro."))))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("examples")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(os.path.join(
        ROOT, "src")), OMP_NUM_THREADS="2", TMPDIR=str(tmp),
        REPRO_CALIB_DIR=str(tmp / "calib"))
    env.pop("JAX_PLATFORMS", None)
    procs = {}
    for name, (flags, _) in CASES.items():
        code = _CHILD.format(path=os.path.join(EXAMPLES, name),
                             args=flags + ["--device", "cpu"])
        procs[name] = subprocess.Popen(
            [sys.executable, "-c", code], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env, cwd=str(tmp))
    deadline = time.monotonic() + DEADLINE_S
    out = {}
    try:
        for name, p in procs.items():
            stdout, stderr = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            out[name] = (p.returncode, stdout, stderr)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs_on_the_cpu(runs, name):
    code, stdout, stderr = runs[name]
    assert code == 0, stderr[-3000:]
    lines = stdout.splitlines()
    ok = [ln for ln in lines if ln.startswith("OK")]
    want = CASES[name][1]
    assert ok and ok[-1].startswith(want), stdout[-2000:]
    loaded = [ln for ln in lines if ln.startswith("LOADED ")]
    assert json.loads(loaded[-1][len("LOADED "):]) == []
    # the line is the reference example's own
    with open(os.path.join(EXAMPLES, name[len("torch_"):])) as f:
        assert want in f.read()
