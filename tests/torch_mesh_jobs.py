"""The rank side of tests/test_torch_mesh.py: what each spawned rank of a
4-rank gloo CPU mesh runs (`repro_torch.mesh.spawn_mesh` imports this
module in every rank, so it loads torch and `repro_torch` only, never
jax).  `run_all` runs every case once and returns plain numpy results;
the test module holds them against the reference."""
import contextlib
import tempfile

import numpy as np
import torch
import torch.distributed as dist

import repro_torch.baselines as TB
import repro_torch.core as TC
import repro_torch.core.bigfcm as TCB
import repro_torch.data as TD
import repro_torch.stream as TS
import repro_torch.stream.streaming as TSS
from repro_torch import mesh as M
from repro_torch import obs
from repro_torch.fleet import mesh_exchange
from repro_torch.engine import Summary

CPU = dict(device_type="cpu")
_DRIVER = TCB.run_driver
MESHES = {"flat": ((4,), ("data",)), "pod": ((2, 2), ("pod", "data"))}
# (mesh, gather axes) cases of the collective order
GATHER_CASES = (("flat", ("data",)), ("pod", ("pod", "data")),
                ("pod", ("data", "pod")), ("pod", ("data",)))


@contextlib.contextmanager
def one_rank_mesh():
    """A 1-rank gloo group in this process and its ("data",) CPU mesh —
    the reference's 1-device mesh — torn down on exit."""
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv",
                                rank=0, world_size=1)
        try:
            yield M.make_mesh((1,), ("data",), **CPU)
        finally:
            dist.destroy_process_group()


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _mesh(name):
    shape, names = MESHES[name]
    return M.make_mesh(shape, names, **CPU)


def order_cases(n_rows):
    """Each case's gathered stack of tagged row blocks and this rank's
    ``shard_rows`` block of ``arange(n_rows)``."""
    out = {}
    x = np.arange(n_rows, dtype=np.float32)
    for name, axes in GATHER_CASES:
        mesh = _mesh(name)
        block = M.shard_rows(x, mesh, axes)
        out[name, axes] = dict(
            block=block.copy(),
            gathered=_np(M.all_gather(torch.from_numpy(block.copy()), mesh,
                                      axes)))
    mesh = _mesh("flat")
    out["psum"] = float(M.psum(torch.tensor(float(dist.get_rank()) + 0.5),
                               mesh))
    out["first"] = M.broadcast_first({"rank": dist.get_rank()}, mesh)
    try:
        M.shard_rows(np.zeros(n_rows + 2), mesh, ("data",))
        out["odd_rows"] = "accepted"
    except ValueError as e:
        out["odd_rows"] = str(e)
    return out


def _pin_wfcmpb(x_sample, cfg, *, seed_idx, device):
    """The driver race pinned to its WFCMPB branch (Flag = 0)."""
    seeds = x_sample[torch.as_tensor(np.asarray(seed_idx, np.int64))]
    res = TC.wfcmpb(x_sample, seeds, m=cfg.m, eps=cfg.driver_eps,
                    max_iter=cfg.max_iter, block_size=cfg.block_size,
                    backend=cfg.backend, device=device)
    return res.centers, False, 0.0, 0.0


def _pin_fcm(x_sample, cfg, *, seed_idx, device):
    """The driver race pinned to its FCM branch (Flag = 1)."""
    seeds = x_sample[torch.as_tensor(np.asarray(seed_idx, np.int64))]
    res = TC.fcm(x_sample, seeds, m=cfg.m, eps=cfg.driver_eps,
                 max_iter=cfg.max_iter, backend=cfg.backend, device=device)
    return res.centers, True, 0.0, 0.0


def fit_cases(x, w, fits):
    """`bigfcm_fit` on each mesh for each case of ``fits``: name →
    (mesh name, config kwargs, driver pin or None, sample_idx,
    seed_idx)."""
    out = {}
    for key, (mesh_name, cfg_kw, pin, sample_idx, seed_idx) in fits.items():
        mesh = _mesh(mesh_name)
        TCB.run_driver = {"wfcmpb": _pin_wfcmpb, None: _DRIVER,
                          "fcm": _pin_fcm}[pin]
        obs.reset_all()
        res = TC.bigfcm_fit(x, TC.BigFCMConfig(backend="torch", **cfg_kw),
                            mesh=mesh, data_axes=MESHES[mesh_name][1],
                            point_weights=w, sample_idx=sample_idx,
                            seed_idx=seed_idx)
        done = [e for e in obs.ring_events()
                if e.get("name") == "engine.fit.done"]
        out[key] = dict(centers=_np(res.centers),
                        masses=_np(res.center_weights),
                        q=float(res.objective),
                        flag=res.diagnostics.flag,
                        combiner_iters=res.diagnostics.combiner_iters,
                        reducer_iters=res.diagnostics.reducer_iters,
                        path=[e["path"] for e in done])
    return out


def baseline_cases(x, init, kw):
    mesh = _mesh("flat")
    fkm, jobs, _ = TB.mr_fuzzy_kmeans(x, init, mesh=mesh, backend="torch",
                                      **kw)
    c, n, inertia, km_jobs, _ = TB.mr_kmeans(x, init, mesh=mesh,
                                             max_iter=kw["max_iter"])
    return dict(fkm_centers=_np(fkm.centers), fkm_jobs=jobs,
                fkm_n_iter=fkm.n_iter, km_centers=_np(c), km_counts=_np(n),
                km_inertia=float(inertia), km_jobs=km_jobs)


def loader_cases(x, batch_rows):
    """Epoch 1 on the flat mesh (a reshard to the pod mesh mid-epoch),
    epoch 2 on the pod mesh, then `stream_loader` on the pod mesh."""
    flat, pod = _mesh("flat"), _mesh("pod")
    loader = TD.ShardedLoader(x, batch_rows, mesh=flat, device="cpu")
    e1 = []
    for i, (bx, bw) in enumerate(loader):
        if i == 1:
            loader.reshard(pod, ("pod", "data"))
        e1.append((_np(bx).copy(), _np(bw).copy()))
    resident = loader.resident
    e2 = [(_np(bx).copy(), _np(bw).copy()) for bx, bw in loader]
    stream = [(_np(bx).copy(), _np(bw).copy()) for bx, bw in
              TD.stream_loader(TD.replay_source(x, 33), batch_rows,
                               mesh=pod, data_axes=("pod", "data"))]
    return dict(e1=e1, e2=e2, stream=stream, resident_after_reshard=resident)


def exchange_cases(centers, masses):
    mesh = _mesh("flat")
    stacked = Summary(torch.from_numpy(centers), torch.from_numpy(masses))
    return {wire: _np(mesh_exchange(stacked, mesh, backend="torch",
                                    wire_dtype=wire).centers)
            for wire in ("f32", "bf16")}


def stream_cases(cfg_kw, steps, mesh_name):
    """Each step: the model restored from the reference's pre-ingest
    state (or fresh at step 0) ingests this rank's block; returns each
    step's report and state."""
    TSS.run_driver = _pin_fcm
    mesh, axes = _mesh(mesh_name), MESHES[mesh_name][1]
    cfg = TS.StreamConfig(backend="torch", **cfg_kw)
    out = []
    for state, x, draws in steps:
        draw = (lambda xa, wa, r, d=draws: d)
        model = (TS.StreamingBigFCM(cfg, mesh=mesh, data_axes=axes,
                                    draws=draw) if state is None else
                 TS.StreamingBigFCM.from_state_arrays(
                     cfg, state, mesh=mesh, data_axes=axes, draws=draw))
        rep = model.ingest(M.shard_rows(x, mesh, axes))
        out.append(dict(report=rep._asdict(),
                        state={k: _np(v) for k, v in
                               model.state_dict().items()}))
    return out


def run_all(mesh, cases):
    """Every case, on the 4-rank world ``mesh`` was built in (one torch
    thread per rank: the 4 ranks share the host's cores)."""
    torch.set_num_threads(1)
    return dict(
        order=order_cases(cases["order_rows"]),
        fits=fit_cases(*cases["fit_data"], cases["fits"]),
        baselines=baseline_cases(*cases["baselines"]),
        loader=loader_cases(*cases["loader"]),
        exchange=exchange_cases(*cases["exchange"]),
        streams={k: stream_cases(*v) for k, v in cases["streams"].items()})


def fail_on_rank_one(mesh):
    """Rank 0 waits in a gather; rank 1 raises."""
    if dist.get_rank() == 1:
        raise ValueError("rank one fails on purpose")
    M.all_gather(torch.zeros(1), mesh)


def stall_on_rank_one(mesh):
    """Rank 0 waits in a gather that rank 1 never joins."""
    if dist.get_rank() == 1:
        import time
        time.sleep(3600)
    M.all_gather(torch.zeros(1), mesh)
