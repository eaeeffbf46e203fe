"""`repro_torch`'s device mesh against the reference's: the collectives'
order and the row split, `bigfcm_fit` flat and hierarchical (the FCM and
the WFCMPB combiner), MR-FKM and Mahout-KM, the sharded loader and its
reshard, `mesh_exchange` and the mesh stream.

The reference runs once in a subprocess on 4 forced CPU devices
(``XLA_FLAGS`` must be set before jax loads), as tests/test_system.py
runs it; the port runs once on 4 spawned gloo ranks on the CPU
(`repro_torch.mesh.spawn_mesh`, each rank running
tests/torch_mesh_jobs.py's `run_all`), each spawn under its own
deadline.  Both get the same numpy inputs made from seeds, the
reference's `jax.random` draws injected into the port, and, for the
WFCMPB cases, both drivers pinned to that branch in their own process.

Bounds: fit centers at rtol 2e-3 / atol 2e-4 (tests/test_torch_core.py),
the global objective at rtol 1e-5, combiner and reducer sweeps equal;
MR-FKM and Mahout-KM centers at atol 1e-4 with equal job counts, against
the reference's single-device baselines (its ``mesh=`` versions raise
`ShardingTypeError` on jax 0.9.0: the sweep's matmul contracts the
sharded rows, as tests/test_torch_plane.py holds them); the
loader's blocks, concatenated in rank order, equal to the reference's
global batches; `mesh_exchange` at 1e-5 (f32) and within
``16·BF16_REL_BOUND`` of the scale (bf16), as
tests/test_fleet_elastic.py holds the reference.

The stream is step-locked against the reference's own functions composed
per shard — `repro.stream.streaming._combine_local` on each block, then
`merge_summaries` (flat, seeded with the current centers) — on ``jnp``,
both drivers pinned to FCM, the reference's draws injected: the
reference's mesh stream raises `ShardingTypeError` on jax 0.9.0
(`streaming.py:262`), so it cannot be the oracle."""
import os
import pickle
import subprocess
import sys
import tempfile
import textwrap
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.core as RC
import repro.data as RD
import repro.engine as RE
import repro.stream as RS
import repro.stream.streaming as RSS
import repro_torch.baselines as TB
import repro_torch.core as TC
import repro_torch.data as TD
from repro_torch import mesh as M
from repro_torch.engine import Summary
from repro_torch.fleet import BF16_REL_BOUND, mesh_exchange

import torch_mesh_jobs as J

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
DEADLINE_S = 300.0
N_FIT, D_FIT, C_FIT = 4096, 6, 4
FITS = {  # case → (mesh, hierarchical, driver pin)
    "flat_fcm": ("flat", False, None),
    "pod_fcm": ("pod", True, None),
    "flat_wfcmpb": ("flat", False, "wfcmpb"),
    "pod_wfcmpb": ("pod", True, "wfcmpb"),
}
# tests/test_torch_stream.py's global-drift stream (one re-seed) and its
# split stream (a birth, then a death): (config, make_moving_blobs
# arguments, mesh, bars).  The bars are that file's — centers within 1e-5
# of the batch's RMS, masses within 1e-5 of the largest, equal sweeps —
# except on the split stream, whose per-shard combiners (300 rows each)
# are not fixed by their data at f32 around the birth and the death: a
# 1 + 2⁻²² nudge of the data moves the reference's own sweeps by one
# (152 → 153, 89 → 88 at the death) and its centers by 5.6e-6 of the
# RMS.  There centers are held at 3e-5 of the RMS, sweeps to ±1 and
# masses (per center and the window's) at 1e-3 (the birth's blob split,
# as that file says).
STREAMS = {
    "global": (dict(n_clusters=4, window=3, decay=0.8, max_iter=300,
                    driver_sample=384),
               ((8, 1500, 6, 4), dict(drift_at=4, shift=10.0, seed=5)),
               "flat", dict(center_rtol=1e-5, mass_rtol=1e-5, iter_slack=0)),
    "split": (dict(n_clusters=4, window=3, decay=0.6, max_iter=200,
                   driver_sample=384, death_mass_floor=0.25,
                   reseed_cooldown=2),
              ((10, 1200, 6, 4), dict(drift_at=4, shift=12.0, seed=7,
                                      drift_clusters=(0,))),
              "pod", dict(center_rtol=3e-5, mass_rtol=1e-3, iter_slack=1)),
}


def _fit_data():
    x, _ = RD.make_blobs(N_FIT, D_FIT, C_FIT, seed=0)
    w = np.random.default_rng(1).uniform(0.5, 2.0, N_FIT).astype(np.float32)
    return x, w


def _fit_cfg(hier, pin):
    return dict(n_clusters=C_FIT, sample_size=512, block_size=256,
                hierarchical=hier, use_driver=pin is not None)


def _reference_draws(cfg_kw, n):
    """The reference fit's sample and seed indices (`bigfcm.py:_fit_array`
    and `_initial_centers` / the driver's seed choice)."""
    k_sample, k_seed = jax.random.split(jax.random.PRNGKey(0))
    lam = min(cfg_kw["sample_size"], n)
    sample_idx = np.asarray(jax.random.choice(k_sample, n, (lam,),
                                              replace=False))
    seed_idx = np.asarray(jax.random.choice(k_seed, lam,
                                            (cfg_kw["n_clusters"],),
                                            replace=False))
    return sample_idx, seed_idx


def _exchange_stack():
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=5.0, size=(4, 5, 6)).astype(np.float32)
    masses = np.abs(rng.normal(size=(4, 5))).astype(np.float32) + 0.5
    return centers, masses


# ------------------------------------------------- the reference's side --

_REFERENCE = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, {src!r})
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    import repro.core as RC
    import repro.core.bigfcm as RCB
    from repro.baselines import mr_fuzzy_kmeans, mr_kmeans
    from repro.compat import shard_map
    from repro.engine import Summary
    from repro.fleet import mesh_exchange

    args = pickle.load(open({inp!r}, "rb"))
    meshes = {{"flat": jax.make_mesh((4,), ("data",)),
               "pod": jax.make_mesh((2, 2), ("pod", "data"))}}
    out = {{"order": {{}}, "fits": {{}}}}
    for name, axes in args["gather_cases"]:
        mesh = meshes[name]
        xs = jax.device_put(jnp.arange(float(args["order_rows"])),
                            NamedSharding(mesh, P(axes)))
        f = shard_map(lambda b: jax.lax.all_gather(b, axes)[None],
                      mesh=mesh, in_specs=(P(axes),),
                      out_specs=P(mesh.axis_names), check_vma=False)
        per_dev = np.asarray(jax.jit(f)(xs))
        shards = {{s.device.id: np.asarray(s.data)
                   for s in xs.addressable_shards}}
        order = [d.id for d in mesh.devices.flatten()]
        out["order"][name, axes] = dict(
            blocks=[shards[i] for i in order],
            gathered=[per_dev[r] for r in range(len(order))])

    real_driver = RCB.run_driver

    def pinned_wfcmpb(x_sample, cfg, key):
        idx = jax.random.choice(key, x_sample.shape[0], (cfg.n_clusters,),
                                replace=False)
        res = RC.wfcmpb(x_sample, jnp.take(x_sample, idx, axis=0), m=cfg.m,
                        eps=cfg.driver_eps, max_iter=cfg.max_iter,
                        block_size=cfg.block_size, backend=cfg.backend)
        return res.centers, False, 0.0, 0.0

    x, w = args["fit_data"]
    for key, (mesh_name, cfg_kw, pin) in args["fits"].items():
        RCB.run_driver = pinned_wfcmpb if pin == "wfcmpb" else real_driver
        mesh = meshes[mesh_name]
        res = RC.bigfcm_fit(jnp.asarray(x),
                            RC.BigFCMConfig(backend="jnp", **cfg_kw),
                            mesh=mesh, data_axes=mesh.axis_names,
                            point_weights=jnp.asarray(w))
        out["fits"][key] = dict(
            centers=np.asarray(res.centers),
            shards=[np.asarray(s.data)
                    for s in res.centers.addressable_shards],
            masses=np.asarray(res.center_weights),
            q=float(res.objective), flag=bool(res.diagnostics.flag),
            combiner_iters=np.asarray(res.diagnostics.combiner_iters),
            reducer_iters=int(res.diagnostics.reducer_iters))

    # the reference's mesh= MR-FKM / Mahout-KM raise ShardingTypeError on
    # jax 0.9.0 (a matmul contracting the sharded rows): held single-device
    bx, init, kw = args["baselines"]
    fkm, jobs, _ = mr_fuzzy_kmeans(jnp.asarray(bx), jnp.asarray(init),
                                   backend="jnp", **kw)
    c, n, inertia, km_jobs, _ = mr_kmeans(jnp.asarray(bx), jnp.asarray(init),
                                          max_iter=kw["max_iter"])
    out["baselines"] = dict(fkm_centers=np.asarray(fkm.centers),
                            fkm_jobs=jobs, km_centers=np.asarray(c),
                            km_counts=np.asarray(n),
                            km_inertia=float(inertia), km_jobs=km_jobs)

    centers, masses = args["exchange"]
    stacked = Summary(jnp.asarray(centers), jnp.asarray(masses))
    out["exchange"] = {{
        wire: np.asarray(mesh_exchange(stacked, meshes["flat"], backend="jnp",
                                       wire_dtype=dt).centers)
        for wire, dt in (("f32", None), ("bf16", jnp.bfloat16))}}
    pickle.dump(out, open({out!r}, "wb"))
""")


def _run_reference(args, tmp):
    inp, out = os.path.join(tmp, "ref_in.pkl"), os.path.join(tmp, "ref.pkl")
    with open(inp, "wb") as f:
        pickle.dump(args, f)
    code = _REFERENCE.format(src=os.path.abspath(SRC), inp=inp, out=out)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=DEADLINE_S)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def _pin_ref_fcm(x_sample, cfg, key):
    idx = jax.random.choice(key, x_sample.shape[0], (cfg.n_clusters,),
                            replace=False)
    res = RC.fcm(x_sample, jnp.take(x_sample, idx, axis=0), m=cfg.m,
                 eps=cfg.driver_eps, max_iter=cfg.max_iter,
                 backend=cfg.backend)
    return res.centers, True, 0.0, 0.0


def _ref_draws(ref, n, w):
    """The reference's (re)seed draws from the key it holds before an
    ingest (`streaming.py` `_driver_seed` and the driver's seed choice)."""
    cfg = ref.cfg
    key = (jax.random.PRNGKey(cfg.seed) if ref.state is None
           else ref.state.key)
    k_sample, k_seed = jax.random.split(key)
    wj = jnp.asarray(w)
    lam = min(cfg.driver_sample, int(jnp.sum(wj > 0)))
    idx = jax.random.choice(k_sample, n, (lam,), replace=False,
                            p=wj / jnp.maximum(jnp.sum(wj), 1e-12))
    seed_idx = jax.random.choice(k_seed, lam, (cfg.n_clusters,),
                                 replace=False)
    return np.asarray(idx), np.asarray(seed_idx)


def _reference_stream(cfg_kw, chunks, n_blocks=4):
    """The reference stream with its combiner composed per shard; returns
    (the port's steps: pre-ingest state, batch, draws) and (the
    reference's report and post-ingest state per step)."""
    ref = RS.StreamingBigFCM(RS.StreamConfig(backend="jnp", **cfg_kw))
    cfg, be = ref.cfg, ref.backend
    plan = RE.MergePlan("flat", m=cfg.m, eps=cfg.reducer_eps,
                        max_iter=cfg.merge_max_iter)

    def composed(x, w, v):
        parts = [RSS._combine_local(a, b, v, cfg=cfg, be=be)
                 for a, b in zip(jnp.split(x, n_blocks),
                                 jnp.split(w, n_blocks))]
        red = RE.merge_summaries(
            RE.Summary(jnp.stack([p[0] for p in parts]),
                       jnp.stack([p[1] for p in parts])),
            plan, backend=be, init=v)
        return (red.summary.centers, red.summary.masses,
                jnp.stack([jnp.asarray(p[2], jnp.int32) for p in parts]))

    ref._jcomb = jax.jit(composed)
    steps, want = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(RSS, "run_driver", _pin_ref_fcm)
        for x in chunks:
            state = (None if ref.state is None else
                     {k: np.asarray(v) for k, v in ref.state_dict().items()})
            steps.append((state, x, _ref_draws(ref, x.shape[0],
                                               np.ones(x.shape[0],
                                                       np.float32))))
            rep = ref.ingest(x)
            want.append(dict(report=rep._asdict(), state={
                k: np.asarray(v) for k, v in ref.state_dict().items()},
                scale=float(np.sqrt(np.mean(x * x)))))
    return steps, want


@pytest.fixture(scope="module")
def runs():
    """Both sides, each run once: the reference's subprocess and the
    port's 4 ranks."""
    x, w = _fit_data()
    bx, _ = RD.make_blobs(2000, 5, 3, seed=3)
    fits_ref, fits_port = {}, {}
    for key, (mesh_name, hier, pin) in FITS.items():
        cfg_kw = _fit_cfg(hier, pin)
        fits_ref[key] = (mesh_name, cfg_kw, pin)
        sample_idx, seed_idx = _reference_draws(cfg_kw, N_FIT)
        fits_port[key] = (mesh_name, cfg_kw, pin, sample_idx, seed_idx)
    stacked = _exchange_stack()
    baselines = (bx, bx[:3], dict(m=2.0, eps=1e-6, max_iter=60))
    order_rows = 16
    streams_port, streams_want = {}, {}
    for name, (cfg_kw, (blob_args, blob_kw), mesh_name, _) in \
            STREAMS.items():
        chunks = [c for c, _ in RD.make_moving_blobs(*blob_args, **blob_kw)]
        steps, streams_want[name] = _reference_stream(cfg_kw, chunks)
        streams_port[name] = (cfg_kw, steps, mesh_name)
    loader_x = np.random.default_rng(4).normal(size=(250, 3)).astype(
        np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        ref = _run_reference(dict(
            gather_cases=J.GATHER_CASES, order_rows=order_rows,
            fit_data=(x, w), fits=fits_ref, baselines=baselines,
            exchange=stacked), tmp)
    port = M.spawn_mesh(J.run_all, (4,), ("data",), backend="gloo",
                        device_type="cpu", timeout_s=DEADLINE_S,
                        args=(dict(order_rows=order_rows, fit_data=(x, w),
                                   fits=fits_port, baselines=baselines,
                                   loader=(loader_x, 32),
                                   exchange=stacked,
                                   streams=streams_port),))
    return dict(ref=ref, port=port, x=x, w=w, loader_x=loader_x,
                stacked=stacked, streams=streams_want)


# ------------------------------------------------------ the collectives --

@pytest.mark.parametrize("case", J.GATHER_CASES,
                         ids=["_".join((m,) + a) for m, a in J.GATHER_CASES])
def test_gather_order_and_row_split_match_reference(runs, case):
    want = runs["ref"]["order"][case]
    for rank, got in enumerate(runs["port"]):
        np.testing.assert_array_equal(got["order"][case]["block"],
                                      want["blocks"][rank])
        np.testing.assert_array_equal(got["order"][case]["gathered"],
                                      want["gathered"][rank])


def test_psum_broadcast_and_uneven_rows(runs):
    for got in runs["port"]:
        assert got["order"]["psum"] == 0.5 + 1.5 + 2.5 + 3.5
        assert got["order"]["first"] == {"rank": 0}
        assert "do not split into 4 equal blocks" in got["order"]["odd_rows"]


# ------------------------------------------------------------ the fits --

@pytest.mark.parametrize("case", list(FITS))
def test_bigfcm_mesh_fit_matches_reference(runs, case):
    want = runs["ref"]["fits"][case]
    got = runs["port"][0]["fits"][case]
    np.testing.assert_allclose(got["centers"], want["centers"], rtol=2e-3,
                               atol=2e-4)
    np.testing.assert_allclose(got["masses"], want["masses"], rtol=2e-3)
    np.testing.assert_allclose(got["q"], want["q"], rtol=1e-5)
    assert got["flag"] == want["flag"] == (FITS[case][2] is None)
    assert got["combiner_iters"] == tuple(want["combiner_iters"].tolist())
    assert got["reducer_iters"] == want["reducer_iters"]
    assert got["path"] == ["mesh"]
    # the reference hands back its first device's centers
    np.testing.assert_array_equal(want["centers"], want["shards"][0])


def test_every_rank_returns_the_same_fit(runs):
    """Hierarchical ranks reach different mid-level merges (each inner
    merge is seeded with the rank's own centers); rank 0's answer is
    broadcast, so every rank holds the same bits."""
    first = runs["port"][0]["fits"]
    for other in runs["port"][1:]:
        for case in FITS:
            for k in ("centers", "masses"):
                np.testing.assert_array_equal(other["fits"][case][k],
                                              first[case][k])
            assert other["fits"][case]["q"] == first[case]["q"]
            assert other["fits"][case]["reducer_iters"] == \
                first[case]["reducer_iters"]


# -------------------------------------------------------- the baselines --

def test_mr_fkm_and_mahout_km_on_mesh_match_reference(runs):
    want = runs["ref"]["baselines"]
    for got in runs["port"]:
        b = got["baselines"]
        assert b["fkm_jobs"] == want["fkm_jobs"] == b["fkm_n_iter"]
        np.testing.assert_allclose(b["fkm_centers"], want["fkm_centers"],
                                   atol=1e-4)
        assert b["km_jobs"] == want["km_jobs"]
        np.testing.assert_allclose(b["km_centers"], want["km_centers"],
                                   atol=1e-4)
        np.testing.assert_array_equal(b["km_counts"], want["km_counts"])
        np.testing.assert_allclose(b["km_inertia"], want["km_inertia"],
                                   rtol=1e-5)


# ----------------------------------------------------------- the loader --

def _concat(port, key, i):
    blocks = [r["loader"][key][i] for r in port]
    return (np.concatenate([b[0] for b in blocks]),
            np.concatenate([b[1] for b in blocks]))


def test_sharded_loader_blocks_concatenate_to_reference_batches(runs):
    """Epoch 1 reshards from the (4,) to the (2, 2) mesh after its second
    batch; its remaining batches, epoch 2 and `stream_loader` are split
    over ("pod", "data").  Every batch's rank blocks, in rank order, are
    the reference's global batch and weights, phantom rows included."""
    x, port = runs["loader_x"], runs["port"]
    want = [(np.asarray(bx), np.asarray(bw))
            for bx, bw in RD.ShardedLoader(x, 32)]
    stream = [(np.asarray(bx), np.asarray(bw)) for bx, bw in
              RD.stream_loader(RD.replay_source(x, 33), 32)]
    for key, ref in (("e1", want), ("e2", want), ("stream", stream)):
        assert len(port[0]["loader"][key]) == len(ref) == -(-250 // 32)
        for i, (bx, bw) in enumerate(ref):
            gx, gw = _concat(port, key, i)
            np.testing.assert_array_equal(gx, bx)
            np.testing.assert_array_equal(gw, bw)
    assert not port[0]["loader"]["resident_after_reshard"]


# ------------------------------------------------------ the fleet's spmd --

def test_mesh_exchange_matches_reference(runs):
    """f32 and bf16 wire, against the reference's forced-4-device
    exchange and the pairwise merge of the stack."""
    centers, masses = runs["stacked"]
    merged = RE.merge_summaries(RE.Summary(jnp.asarray(centers),
                                           jnp.asarray(masses)),
                                RE.MergePlan("pairwise"), backend="jnp")
    want = np.asarray(merged.summary.centers)
    scale = np.max(np.abs(want))
    for got in runs["port"]:
        ex = got["exchange"]
        np.testing.assert_allclose(ex["f32"], want, atol=1e-5)
        np.testing.assert_allclose(ex["f32"], runs["ref"]["exchange"]["f32"],
                                   atol=1e-5)
        assert np.max(np.abs(ex["bf16"] - want)) <= \
            16 * BF16_REL_BOUND * scale
        np.testing.assert_array_equal(ex["bf16"],
                                      runs["port"][0]["exchange"]["bf16"])


# ----------------------------------------------------------- the stream --

def _hold_step(got, want, scale, center_rtol, mass_rtol, iter_slack):
    pr, rr = got["report"], want["report"]
    for f in ("step", "drifted", "reseeded", "reason", "late_dropped",
              "born", "died", "n_centers"):
        assert pr[f] == rr[f], (f, pr[f], rr[f])
    for f in ("objective_pre", "objective_post"):
        assert pr[f] == pytest.approx(rr[f], rel=1e-5), (f, pr[f], rr[f])
    assert pr["mass"] == pytest.approx(rr["mass"], rel=mass_rtol)
    assert np.all(np.abs(np.asarray(pr["combiner_iters"])
                         - np.asarray(rr["combiner_iters"])) <= iter_slack), \
        (pr["combiner_iters"], rr["combiner_iters"])
    ps, rs = got["state"], want["state"]
    assert set(ps) == set(rs)
    for f in ("cursor", "step", "since_reseed", "reseeds", "slot_buckets",
              "ages", "late_dropped", "births", "deaths"):
        np.testing.assert_array_equal(ps[f], rs[f], err_msg=f)
    for f in ("centers", "win_centers"):
        np.testing.assert_allclose(ps[f], rs[f], rtol=0,
                                   atol=center_rtol * scale, err_msg=f)
    for f in ("weights", "win_weights"):
        np.testing.assert_allclose(
            ps[f], rs[f], rtol=mass_rtol,
            atol=mass_rtol * float(np.abs(rs[f]).max(initial=0.0)),
            err_msg=f)


@pytest.mark.parametrize("name", list(STREAMS))
def test_mesh_stream_step_locked(runs, name):
    """Every rank's report and state after each ingest against the
    reference composed per shard (module note), at the bars of
    ``STREAMS``: ``global`` re-seeds once on the (4,) mesh; ``split`` has
    a birth and a death on the (2, 2) mesh."""
    want = runs["streams"][name]
    bars = STREAMS[name][3]
    reports = [w["report"] for w in want]
    if name == "global":
        assert [r["reason"] for r in reports].count("objective") == 1
    else:
        assert sum(r["born"] for r in reports) >= 1
    for rank in runs["port"]:
        for got, w in zip(rank["streams"][name], want):
            _hold_step(got, w, w["scale"], **bars)
            assert len(got["report"]["combiner_iters"]) == 4


# ------------------------------------------------ one rank, in process --

@pytest.fixture(scope="module")
def world1():
    """A 1-rank gloo group in this process (the reference's 1-device
    mesh cases), torn down after the module."""
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv",
                                rank=0, world_size=1)
        try:
            yield M.make_mesh((1,), ("data",), device_type="cpu")
        finally:
            dist.destroy_process_group()


def test_one_rank_mesh_takes_the_single_device_branch(world1):
    x, w = _fit_data()
    cfg = TC.BigFCMConfig(n_clusters=C_FIT, sample_size=512,
                          backend="torch", use_driver=False)
    got = TC.bigfcm_fit(x, cfg, mesh=world1, point_weights=w)
    want = TC.bigfcm_fit(x, cfg, point_weights=w, device="cpu")
    assert torch.equal(got.centers, want.centers)
    assert got.diagnostics == want.diagnostics
    fkm, jobs, _ = TB.mr_fuzzy_kmeans(x, x[:4], mesh=world1,
                                            backend="torch", max_iter=20)
    fkm1, jobs1, _ = TB.mr_fuzzy_kmeans(x, x[:4], backend="torch",
                                              max_iter=20, device="cpu")
    assert jobs == jobs1 and torch.equal(fkm.centers, fkm1.centers)


def test_mesh_exchange_degenerate_single_rank(world1):
    """tests/test_fleet.py's 1-device case: a 1-slot stack merges to
    itself, quantized or not."""
    c_ref = np.random.default_rng(2).normal(size=(5, 6)).astype(np.float32)
    stacked = Summary(torch.from_numpy(c_ref)[None], torch.ones((1, 5)))
    out = mesh_exchange(stacked, world1)
    np.testing.assert_allclose(out.centers.numpy(), c_ref, atol=1e-6)
    quant = mesh_exchange(stacked, world1, wire_dtype="bf16")
    assert np.all(np.abs(quant.centers.numpy() - c_ref)
                  <= BF16_REL_BOUND * np.abs(c_ref) + 1e-30)


def test_reshard_mid_resident_replay_replaces_remaining_batches(world1):
    """tests/test_loader.py's case: a reshard landing mid device-resident
    replay serves the rest from the store, for the new mesh."""
    x = np.arange(512 * 3, dtype=np.float32).reshape(512, 3)
    loader = TD.ShardedLoader(TD.ChunkStore.ingest(x, chunk_rows=64),
                              batch_rows=64, mesh=world1)
    assert sum(float(w.sum()) for _, w in loader) == 512.0
    assert loader.resident
    total, got = 0.0, []
    for i, (bx, bw) in enumerate(loader):
        if i == 2:
            loader.reshard(world1, ("data",))
        total += float(bw.sum())
        got.append(bx.numpy().copy())
    assert total == 512.0
    np.testing.assert_array_equal(np.concatenate(got), x)


def test_reshard_mid_epoch_keeps_row_counts_exact(world1):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(500, 3)).astype(np.float32)
    loader = TD.ShardedLoader(TD.ChunkStore.ingest(x, chunk_rows=64),
                              batch_rows=64, mesh=world1)
    total, n_batches = 0.0, 0
    for i, (bx, bw) in enumerate(loader):
        if i == 3:
            loader.reshard(world1, ("data",))
        total += float(bw.sum())
        n_batches += 1
    assert total == 500.0
    assert n_batches == -(-500 // 64)
    assert not loader.resident                  # cache dropped on reshard
    assert sum(float(w.sum()) for _, w in loader) == 500.0


def test_poisoned_source_during_reshard_raises_in_consumer(world1):
    def poisoned():
        yield np.ones((64, 3), np.float32)
        yield np.ones((64, 3), np.float32)
        raise RuntimeError("upstream parse failure")

    loader = TD.ShardedLoader(poisoned(), batch_rows=32, mesh=world1)
    it = iter(loader)
    next(it)
    loader.reshard(world1, ("data",))
    with pytest.raises(RuntimeError, match="upstream parse failure"):
        list(it)

    loader = TD.ShardedLoader(poisoned(), batch_rows=32, mesh=world1,
                              prefetch=1)
    it = iter(loader)
    next(it)
    t = threading.Thread(target=lambda: loader.reshard(world1, ("data",)))
    t.start()
    with pytest.raises(RuntimeError, match="upstream parse failure"):
        list(it)
    t.join()


# ----------------------------------------------------- spawn's failures --

def test_spawned_rank_failure_raises_with_its_traceback():
    with pytest.raises(M.RankError, match="rank 1 raised"):
        M.spawn_mesh(J.fail_on_rank_one, (2,), ("data",), backend="gloo",
                     device_type="cpu", timeout_s=60.0)


def test_stalled_collective_fails_at_its_deadline():
    with pytest.raises((TimeoutError, M.RankError)):
        M.spawn_mesh(J.stall_on_rank_one, (2,), ("data",), backend="gloo",
                     device_type="cpu", timeout_s=8.0)

