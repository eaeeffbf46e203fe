#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of BigFCM (`src/repro_torch`) on one NVIDIA
card and check it.  Run from the root of a checkout:

    python3 chip_smoke.py [--seed N]

Phases, each printed as JSON lines (``at_s``: seconds since the start);
any failure raises and exits non-zero:

1. device  — the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions, and the ``nvcc`` build of every kernel source in the
   checkout (one ``nvcc`` each, all started together), timed.
2. kernels — the Hopper FCM kernel against its plain PyTorch version on
   the card: every shape of tests/test_kernels.py for m in
   {1.05, 1.2, 2.0, 3.0} at that file's tolerances, chunk additivity,
   and bitwise determinism of two launches.  Then the inputs the driver
   race gives it at each run's d, C and m: the 3184-row sample, WFCMPB's
   last 2048-row block with zero-weight phantom rows, and WFCMPB's first
   2·C-point merge, whose running half has zero mass.
   Then it holds the tenant-stacked kernel (K3) against its plain version:
   T ∈ {1, 5, 64} ragged tenants plus two all-zero phantom tenants, d ∈ {4,
   41}, C ∈ {3, 23}, per-tenant m from {1.05, 1.2, 2.0, 3.0} and a scalar
   m, with bit-identical reruns, exact zeros on the phantoms, and one
   tenant against K1/K2; both sides of its tile / C-tiled boundary (d =
   128 / 129 at C = 64, and C = 129 at d = 8); and at (64 + 2, 300, 41,
   23), on the tile kernel's tenant axis, timed beside the C-tiled kernel
   forced there, the plain version and the bound.  Then the C-tiled kernel
   (``csrc/fcm_ctiled.cu``, where V does not fit shared memory) against its
   plain version computed in row chunks: K1/K2 at (N, d, C) = (4096, 900,
   64), (4096, 2048, 64), (1024, 7168, 384), m = 2 and 1.2, with phantom
   rows and with records on centers; K3 at (3, 1000, 2048, 64) with one
   all-phantom tenant; and with its scratch cut so that its sums add over
   tenant groups and row chunks.  Then the wide kernel (``fcm_wide_kernel``
   in ``csrc/fcm_accumulate.cu``: d split across a cluster of CTAs, where
   C·d is past the tile kernel and V and one record still fit shared
   memory) against its plain version in row chunks: K1/K2 at the
   curriculum's shapes (65,536 / 32,604 / 2048 / 32 / 16 × 1536, C = 16),
   at d = 1024, 2048, 3072 (C = 16), (4096, 100, 128) and (3000, 887, 64),
   m = 1.2 and 2, with phantom rows and with records on centers, reruns bit
   for bit, and zero-weight records giving exact zeros.
   Then the perf plane (``calibrate``), in a calibration sandbox (a fresh
   ``build/chip_smoke_calib_*/`` as ``REPRO_CALIB_DIR``, deleted at the
   end, so no earlier run's winners or tuned plans change a plan): the
   card's probed peaks beside the datasheet's; at the default bucket and
   each run's driver-sample bucket the backend race ("auto"'s winner,
   each backend's µs and parity; the winner must be ``hopper`` or
   ``hopper_accumulate``, both in parity with ``torch``); and at those
   buckets and the tenant cohorts' the launch-plan search (a host-bound
   bucket keeps its untuned plan; elsewhere a choice must beat the
   untuned plan's card time by more than 5 %), every plan of the grid
   held against the plain version.  Every later
   phase runs on the plans it chose.
3. main path — `bigfcm_fit` on backend ``hopper`` at the paper's dataset
   sizes (HIGGS-like 11,000,000 × 28, C=2, m=2; KDD99-like
   4,898,431 × 41, C=23, m=1.2; ε=5e-7 as in benchmarks/t6_datasets.py),
   data made from ``--seed`` on the host while the kernels build (as is
   ``router_fit``'s).  Launch counts are zeroed right before the
   fit and read right after the global objective pass.  Then the fit
   with injected seeds through ``hopper`` is held against the ``torch``
   backend on the card, and each kernel entry against its plain version
   at the full shape, and timed.  The driver race's two branches (FCM
   and WFCMPB on the full-size sample) run through ``hopper``, every
   sweep over records held against the plain version on the same
   inputs, and their centers against the ``torch`` backend's.
   Then ``router_fit``: `fcm_router_init` over OLMoE-1B-7B's routers in
   the reference's layout (``stages[0]["moe"]["w_router"]``, (16, 2048,
   64) bf16), its `bigfcm_fit` with src/repro/integration/
   router_init.py:40-42's config (C = 64, m = 2, ε 1e-6 / 1e-8, 200
   sweeps) at OLMoE-1B-7B's d_model (262,144 × 2048 token-embedding-like
   rows from 64 Gaussian components of unequal mass), every launch on
   the C-tiled path, held against the ``torch`` backend from the same
   draws (`hold_router_fits`); the ``router_init`` record holds every
   layer's router equal to (v/‖v‖)ᵀ of the fit and prints x·w's top-1
   agreement with `hard_assign` (m = 2 flattens the centers at d =
   2048; the agreement is held on the embedding table that ``lm_moe``
   seeds its routers from); each shape held and timed, the
   contraction's ``torch.matmul`` timed as its yardstick.  The HIGGS- and
   KDD99-like records print `kernel_roofline` of ``hopper`` at full size,
   its `sweep_bytes` held equal to `bound_bytes`.
4. tenant path — `fit_tenants` on backend ``hopper`` at three cohorts
   made from ``--seed``: ``tenants_t16``, benchmarks/t16_tenant.py's own
   (1024 tenants of 8–30 rows, d=4, C=3, m=2, ε=1e-3, 12 sweeps at
   most), ``tenants_65k`` (65,536 tenants of 64–512 rows, per-tenant
   m ~ U(1.5, 3), ε=1e-6, 300 sweeps at most), both on the rows kernel,
   and ``tenants_kdd99`` (4096 tenants of 64–512 consecutive rows of one
   `make_kdd_like` array, the paper's KDD99 d=41, C=23, m=1.2, ε=1e-6,
   300 sweeps at most) on the tile kernel's tenant axis.  The K3 launch
   count is zeroed right before each fit and read right after.  Each fit
   is held tenant by tenant against the same fit through the ``torch``
   backend (`hold_tenant_fits`), ``tenants_kdd99``'s step by step along
   the ``torch`` fit's trajectory (`hold_step_locked`), ``tenants_t16``'s
   first 16 tenants also against `fit_tenants_looped`; a burst of 4 rows per tenant goes
   through `TenantScorer` on the card and on the CPU; and K3 is held
   against its plain version at the packed shape, and timed.  At
   ``tenants_65k`` a `TenantScoringService` serves requests of 8–64 rows
   from 4096 random tenants and one firehose tenant (half the rows,
   ``max_group_rows`` 512), swapping to the ``torch`` refit mid-traffic:
   each response's version and labels are one fleet's.
5. store path — the two arrays ingested into on-disk
   `ChunkStore`s of 1,048,576-row chunks: `bigfcm_fit_store` with
   counted launches and peak device memory, held against the in-memory
   fits; a pass's time split; at KDD99 size the 4-shard fit,
   `wfcmpb_store`, MR-FKM and `assign_store`.  The KDD99-like fit also
   prints `repro_torch.obs`'s phase breakdown, its ``data.cache``
   counters held to the chunks the fit reads.
   Then ``fleet`` (`run_fleet_path`) over the HIGGS-like store, from
   `driver_seeds` at the main path's draws: (a) `fleet_fit`, 4 host
   threads x 2 shards on ``hopper``, counts zeroed just before it: no
   host lost, K1 launches at the batch shape equal to the obs plane's
   ``engine.sweep`` spans, K2 launches at the 2·C-point merge shape
   equal to the hosts' pairwise merge recomputed over the gathered
   frames, held against the ``torch`` backend's fleet and the 1-shard
   store fit's global q (1e-5); (b) the bf16 wire (every frame element
   within ``BF16_REL_BOUND``); (c) a straggler evicted and replanned; (d)
   `spawn_fleet`, 3 host processes on the card, host 1 stopped after
   the others posted, the survivors bit-equal to a fleet born at 2
   hosts; (e) `mr_kmeans` on the KDD99-like array, its inertia held to
   a float64 recompute.  K1 and K2 are held and timed at the fleet's own
   inputs; their launches join the entries of the same shape.
   Then ``mesh`` (`run_mesh_path`, after ``fleet``): `bigfcm_fit` on a
   `repro_torch.mesh` device mesh of spawned ranks (spawned after
   ``fleet``, so that their start overlaps the KDD99-like store phase),
   the arrays saved once under a temporary ``build/chip_smoke_mesh_*/``
   and memory-mapped by the ranks: (i) the HIGGS-like fit on a (4,) ("data",) mesh of 4
   gloo ranks sharing the card (2,750,000 rows each), (ii) the
   KDD99-like fit padded with one zero-weight phantom row to 4,898,432
   rows on a (2, 2) ("pod", "data") mesh with the hierarchical reducer;
   each bit-identical to the same fit composed here on one card from the
   port's single-device functions (one combiner per block from the
   broadcast seeds, the stacked summaries through `merge_summaries`, q
   summed in rank order), every rank holding the same answer, and held
   against the same mesh fit through the ``torch`` backend (from the
   race's centers and branch) at the main path's bars; each rank prints
   its wall, sweeps, K1/K2 launches by shape, host seconds in
   collectives, bytes gathered and peak device memory; (iii) MR-FKM and
   Mahout-KM over (i)'s mesh (20 jobs at most) against the single-card
   baselines at atol 1e-4 with equal job counts; (iv) `mesh_exchange`
   at 4 ranks, f32 and bf16, against the pairwise merge of the stack;
   (v) NCCL at `torch.cuda.device_count()` ranks: the exchange, MR-FKM
   and the sharded loader, and the HIGGS-like fit (at 1 rank the
   single-device branch, bit-equal to `bigfcm_fit` without a mesh from
   the same race; at 2 or more, at up to 4 ranks, bit-equal to the
   composition).  The mesh runs' launches join the kernels line.
   Then ``serve``: `ScoringService` over `Scorer` replicas at the
   KDD99-like fit's centers with benchmarks/t14_serve.py's traffic
   (1200 requests over 40 sizes in 16–1024 rows, 4096-row batches on a
   64-base bucket ladder): closed-loop runs at 1, 4 and 16 clients with
   1 then 2 replicas (p50/p99 of ``span.serve.assign`` per bucket and of
   ``serve.request``, records/s, each replica's shape count equal to the
   buckets it used), the ``coalesce=False`` ablation and the shed policy
   (every rejection typed, the queue-rows gauge within 4096); every
   response held against `make_assigner` (`label_ties`).
6. stream path — `StreamingBigFCM` on backend ``hopper``, launch counts
   zeroed before each run and read after it:
   ``kdd99_stream``, the KDD99-like array replayed through
   `assign_stream(model, stream_loader(replay_source(x, 262144),
   262144))` (C = 23, m = 1.2, `StreamConfig` defaults otherwise; 19
   ingests, the last batch phantom-padded), its last labels held against
   `make_assigner`, the model checkpointed and restored at step
   STREAM_CKPT_STEP and both fed the next batch (bit-identical); and
   the live path (`run_live_serve`): a second ``kdd99_stream`` model
   publishing each ingest through `SnapshotPublisher` to a
   `ScoringService` that scores each batch while the next one ingests;
   ``drift_streams`` at d = 28, C = 8, m = 2 from `make_moving_blobs`:
   (a) global drift, re-seeding once within the cooldown and ending
   within 5 % of a fresh `bigfcm_fit` of its last window; (b) one
   component splitting off, one birth and no re-seed (unless a step up
   to it is shown not fixed at f32 against float64); (c) (a)'s
   stationary prefix in event time, in order and out of order within a
   skew below the lateness: no drops, a monotone watermark, objectives
   within 5 % both ways.  Every ingest of ``kdd99_stream``, (a) and (b)
   is step-locked against ``torch``-backend twins in float32 and float64
   started from the pre-ingest state (`StreamRun.hold_step`; the driver
   race pinned to the branch the model kept, `DriverPin`); each ingest's
   wall time is split into drift probe, combiner, window merge and
   driver.  K1 and K2 at every shape the streams launched them at are
   held against their plain versions and timed.  ``kdd99_stream`` also
   prints the obs phase breakdown, its counters held against the run
   (records, births, deaths, re-seeds, labels), and obs's cost share of
   a steady ingest from a host microbenchmark, held to 5 %.  Obs stays
   on for the whole script (checks beside the main path record
   nothing).
7. LM path — ``lm_serve``: Qwen2-1.5B at its full published config
   (28 layers, d_model 1536, 12 Q heads padded to 16 with the 4 padded
   masked dead, 2 KV heads, d_ff 8960, vocab 151,936, tied, θ = 1e6),
   weights from `tree_init` on the card from ``--seed``, in bf16:
   `greedy_generate` for 8 prompts of 2048 tokens, 32 new tokens, a
   4096-slot cache (KV blocks of 1024: the online softmax in prefill
   and decode); the same loop timed call by call (prefill ms, decode ms
   per token, tokens/s, peak device memory, the decode step's bytes
   bound — weights plus the whole cache over the probed HBM peak — and
   its share).  Held: the same weights in f32 with TF32 off, decode with
   the cache against one forward over the 2048 + 32 tokens (rtol 5e-3,
   atol 5e-4, tests/test_models.py:47), the card's forward against
   the CPU's for a reduced qwen2 (f32: 1e-4 / 1e-5; bf16: 2⁻⁴ of the
   largest value), and attention's f32-accumulating bf16 product
   (`_bmm_f32`) against its CPU branch at the path's shapes (1e-5 of the
   largest); printed only: the bf16 logits' gap to f32 and their greedy
   agreement.  Then ``curriculum``:
   `curriculum_buckets` on backend ``hopper`` over `sequence_embeddings`
   of that model's table (65,536 sequences of 256 tokens, each drawn
   from one of 16 topics of 64 token ids: 65,536 × 1536 f32), launch
   counts zeroed before it; its launch plan printed; held: accuracy
   against the topics above 0.95, the ambiguity in [0, 1 + 1e-6], the
   buckets against a ``torch`` fit from the same injected draws except
   at ties, full `CurriculumSampler` batches; printed only: the same
   fit at `curriculum_buckets`' default m = 2 (the phase runs m = 1.2);
   K1/K2 at each of its shapes held against their plain versions and
   timed.  Then ``lm_train``: Qwen2-1.5B at its published config trained
   through `launch.train.build` (bf16 weights from ``--seed``, AdamW with
   f32 moments, the cosine schedule at peak 3e-4 with warmup 2, clip 1.0,
   remat, the chunked `lm_loss`) on 8 × 2048 batches from
   `synthetic_token_batches`: 2 warm-up and 8 timed steps (step ms, p10–p90,
   tokens/s, peak device memory, the model-FLOPs share of the bf16 peak,
   one more step under `torch.profiler`); held: finite losses, the first
   within 0.5 of ln(vocab) (tests/test_archs_smoke.py:44), the last three's
   mean below it; a checkpoint written after step 2 and restored into a
   fresh state (other weights) takes step 3 as the uninterrupted run did
   (bit for bit, else within 1e-4 and a bf16 ulp); an f32 twin (full
   width, 2 layers, TF32 off) takes one step on the card and on the CPU:
   the loss within 1e-5, every gradient within 1e-4 of its leaf's
   largest, the card's update against the CPU's optimizer on the card's
   gradients within 2 ulps plus 1e-5 of the update; one more, untimed
   step under `launch.roofline.counted_flops` (FlopCounterMode): its
   FLOPs within 0.85–1.15 of `launch.flops_model.step_flops` at the
   8 × 2048 cell (tests/test_flops_model.py:46's bar; remat on), printed
   beside `model_flops_for`, `train_flops`, the per-op table and the ops
   the counter has no formula for.  Then
   ``lm_train_dp``: `train.dp.make_dp_train_step` on 2 gloo ranks sharing
   the card (full width, 2 layers, bf16 wire with error feedback, 2 steps
   of 4 × 2048), held bit for bit (else within a bf16 ulp) against the
   same steps composed in this process; printed: bytes gathered (half an
   f32 wire) and seconds in collectives.  Then ``lm_moe_ep``: OLMoE-1B-7B's
   MoE layer at its published widths (d 2048, 64 experts, top-8, d_ff
   1024; weights from ``--seed``) expert-parallel over a (1, 4) ("data",
   "model") mesh of 4 gloo ranks sharing the card, 16 experts a rank:
   `models.moe.moe` under the "tp" profile (tokens replicated, the partial
   outputs summed over "model") and under "fsdp" (a2a: tokens split, two
   `mesh.all_to_all` exchanges each way).  Held: in f32 at cf 8 (no pair
   dropped; 4 × 1024 tokens), each branch's y and gradients (x, the
   rank's expert slices, the router's parts summed over the ranks)
   against the single-rank layer on the card within 1e-4 of each
   tensor's largest value (plus 1e-4 relative).  Timed in bf16 at cf 1.25
   on 8 × 2048 tokens: ms a layer forward and forward + backward for a2a,
   tp (each rep from a barrier; the slowest rank's) and one rank alone;
   printed: each rank's all-to-all and gathered bytes and collective
   seconds of one call, the share of pairs each branch drops (tp's held
   equal to one rank's: one data rank, the same capacity).  Then
   ``lm_train_mp``: the sharded trainer (`sharding.spmd`: FSDP over
   "data", tensor parallelism over "model"; `launch.train.build` and its
   step on a mesh) on a (2, 2) ("data", "model") mesh of 4 gloo ranks
   sharing the card.  Held in f32 (TF32 off), one AdamW step at lr 1e-3
   on 4 × 64 tokens against the one-rank step on the card from the same
   draws: Qwen2-1.5B at its published widths cut to 2 layers under "tp"
   and "fsdp", OLMoE-1B-7B cut to 1 MoE layer at cf 8 under "tp", both
   under "fsdp" at 2 × 64 tokens too (rows over "data" only: each rank
   holds 32 positions, K/V and the MoE layer's input gathered over
   "model"), Mamba2-2.7B cut to 2 layers under "tp", Zamba2-7B cut to 7
   layers (one period of 5 Mamba2 layers and the shared attention
   block, one tail layer) under "tp" and "fsdp", Whisper-medium cut to
   2 + 2 layers under "tp" on 4 × 1500 N(0, 1) frames — the loss and grad
   norm within 1e-5, each rank's block of every updated leaf within
   2.02 · lr of the one-rank leaf's block and all but 0.1 % of its
   elements within 1e-5 of the weight plus 0.01 · lr; printed per case:
   the slowest rank's step ms and the bytes a rank moves by kind.  The
   ranks of ``lm_train_dp``, ``lm_moe_ep`` and ``lm_train_mp`` are
   spawned before ``lm_train`` and wait for their phase, so that their
   start overlaps the phases before it.  Timed:
   Qwen2-1.5B (2 layers, bf16, "tp"), 1 + 3 steps of 4 × 2048 tokens:
   the slowest rank's step ms, tokens/s, peak GB a rank, the bytes a rank
   moves a step by kind (parameter gathers, reduce-scatters, psums) and
   its seconds in collectives, beside ``lm_train_dp``'s step.  After step
   2 a sharded checkpoint; 2 fresh ranks restore it on `make_mesh_for`'s
   (1, 2) mesh (every restored block bit for bit against its block of
   the saved global leaf) and take steps 3–4: the first resumed loss
   below the first loss + 0.5, printed beside the 4-rank run's.
   ``lm_serve_mp``, run by the same 4 ranks after their training: sharded
   prefill and greedy decode (`serve.decode` on a sharded model, caches
   in each rank's blocks).  Held in f32 (TF32 off) against the one-rank
   path on the card from the same draws, 4 × 64-token prompts and 2
   tokens generated (the prefill's and one decode step's): Qwen2-1.5B
   (2 layers) under "tp" and "fsdp", a batch of 1 under "tp" (replicated
   over every batch axis) and of 2 under "fsdp" (split over "data" only:
   the prompt's positions split over "model", the last position's
   logits from the rank holding it), OLMoE-1B-7B (1 MoE layer, cf 8)
   under "tp" and "fsdp" and at a batch of 2 under "fsdp", Mamba2-2.7B
   (2 layers) under "tp": each rank's block of the prefill's last logits
   within 1e-5 of the one-rank logits' largest magnitude, the tokens
   equal on every rank.  Timed: Qwen2-1.5B (2 layers, bf16) under "tp"
   and "fsdp", a prefill of 4 × 2048 tokens, and under "fsdp" of 2 ×
   4096 (the sequence split), each then 8 greedy decode steps: per rank
   the prefill ms, the decode ms a token, the bytes by kind (the
   sequence's K/V gathers among them) and the collective seconds.
   ``dryrun``: ``python -m repro_torch.launch.dryrun`` in a subprocess
   started before the build, on one torch thread (it does no card work:
   fake tensors), collected before the kernels line — Qwen2-1.5B
   ``train_4k`` pod1 "tp" and "fsdp", OLMoE-1B-7B ``train_4k`` pod2
   "fsdp", Zamba2-7B ``decode_32k`` pod1, Mamba2-2.7B ``long_500k`` pod1
   and Kimi-K2 ``decode_32k`` pod1, each traced as rank 0 of the
   production mesh; printed per cell: the status, a rank's argument and
   peak GB, the FLOPs, the collective bytes by kind, the three roofline
   terms and the bottleneck under the card's rates (OLMoE's, whose rows
   leave "model", traced with its sequence split, beside its counted
   FLOPs and peak with the sequence whole); a cell that errs fails the
   phase.
8. LM families — four published configs at full width and depth, bf16
   weights from `tree_init` on the card from ``--seed``, each served
   through `greedy_generate` and its loop timed call by call (prefill
   ms, decode ms per token, tokens/s, peak device memory, the decode
   step's bytes bound over the probed HBM peak and its share, one more
   step under `torch.profiler`: card time, kernels, top ops), each model
   freed before the next; every one also holds its `reduced()` config's
   card forward against the CPU's (f32 and bf16).
   ``lm_moe``: OLMoE-1B-7B (16 layers, d 2048, 64 experts top-8, cf
   1.25, 6.92 B parameters), its embedding table the blob table of
   tests/test_integration.py:23 (50,304 × 2048, spread 0.1, sep 2.0),
   its routers seeded by `fcm_router_init` on the module from that
   table's fit on backend ``hopper`` (every launch C-tiled, counts zeroed
   just before; its launches join the kernels line), held: every router
   (v/‖v‖)ᵀ of the fit, layer 0's top-1 agreement with `hard_assign`
   above 0.9; 8 prompts × 2048 tokens, 32 new, a 4096-slot cache;
   printed from a tapped prefill and decode: pairs dropped per layer and
   the router load with the seeded and the unseeded routers, the distinct
   experts a step routes to (the bound counts those experts' weights,
   attention, head, B embedding rows and the whole cache); held: in f32
   (TF32 off) at cf = E/k (no drops) decode with the cache against one
   forward over the 2048 + 32 tokens at rtol 5e-3 / atol 5e-4, tokens
   near a routing tie exempt and counted; card vs CPU with identical
   expert choices and drops in f32.  ``lm_train_moe`` then trains that
   model, seeded routers and all (`build`'s ``params=``; no second init
   or fit), with Adafactor on 8 × 2048 batches: 2 warm-up and 3 timed
   steps, printed as ``lm_train``'s, with the pairs dropped and the router
   load of the first batch before and after; held: finite losses, the
   first within the smoke bar, and the f32 twin of its first layer at
   cf = E/k (no drops), routing identical on the card and the CPU.  ``lm_ssm`` / ``lm_hybrid``:
   Mamba2-2.7B (64 layers, d 2560, 80 heads of 64, state 128, chunk 256,
   vocab 50,280 padded to 50,304) and Zamba2-7B (13 × (5 mamba + shared
   attention) + 3, d 3584); the same prompts; held: the padded vocabulary
   columns at −1e30, `ssd_chunked` at a full-width layer's shapes
   against the float64 recurrence (2e-4), in f32 decode (1792-token
   prefill, then 256 steps) against one forward over 2048 tokens on the
   first SSM_HOLD_LAYERS layers, the
   hybrid's shared attention one parameter set called by all 13 periods.
   ``lm_encdec``: Whisper-medium (24 + 24 layers, d 1024) over 8 × 1500
   stub frame embeddings from ``--seed``, 4 prompt tokens, 32 new, a
   448-slot cache, the encoder timed apart; held: in f32 decode against
   one decoder forward over the 68 tokens.
   ``examples``: the port's six examples (examples/torch_*.py) at their
   default sizes with ``--device cuda``, each in a process of its own,
   all started together after ``lm_families``; held: exit 0 and the reference
   example's final "OK" line, and for the BigFCM ones (quickstart,
   stream, cluster service, router init) the printed launches of the
   hand-written kernels by wrapper and path — all on a kernel's path,
   the fits on K1 or K2 (whichever kernel backend "auto"'s race picked),
   the cluster service's tenant fit on a tenant-stacked kernel.
9. the kernels line (one entry per kernel), the ``nvidia-smi`` line,
   and the final ``{"ok": true, ...}`` line.

Launches are priced at their own shapes.  Each wrapper counts its
launches per (path, N, C) (K3: per (path, T, N)); each main-path record
prints that split (``launches_by_shape``) and fails unless every launch
took the path the launch plan gives that run (``EXPECTED_PATH``).  Every
shape a run launches at (the full size, the driver's 3184-row sample and
2048-row blocks, the 2·C-point merges, any other size as "n=N"; K3's
packed cohort) is held against the plain version and timed two
ways: ``ms``, CUDA events around a run of back-to-back launches divided
by their count, the run captured in a CUDA graph and replayed so that the
host's enqueue drops out (the card's time), and ``ms_per_call``, the
median of events around single launches (which also counts the host's
enqueue at small shapes, as PR 11/12's times did).

Bounds use an H100 SXM's published peaks at 700 W: 3.35 TB/s of device
memory and 67 TFLOP/s of f32 outside the tensor cores.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
SOURCES = ("fcm_accumulate", "fcm_batched", "fcm_ctiled")  # csrc/<name>.cu
CSRC = "src/repro_torch/kernels/csrc"
# The source of each launch plan path: the rows kernel (which the
# single-model sweep runs at T = 1) is the tenant-stacked source's.
PATH_SOURCE = {("fcm_sweep", "rows"): "fcm_batched",
               ("fcm_accumulate", "rows"): "fcm_batched",
               ("fcm_sweep", "tile"): "fcm_accumulate",
               ("fcm_accumulate", "tile"): "fcm_accumulate",
               ("fcm_sweep", "wide"): "fcm_accumulate",
               ("fcm_accumulate", "wide"): "fcm_accumulate",
               ("fcm_sweep_batched", "rows"): "fcm_batched",
               ("fcm_sweep_batched", "tile"): "fcm_accumulate",
               ("fcm_sweep", "ctiled"): "fcm_ctiled",
               ("fcm_accumulate", "ctiled"): "fcm_ctiled",
               ("fcm_sweep_batched", "ctiled"): "fcm_ctiled"}
REPLACES = {"fcm_sweep": "src/repro/kernels/fcm_update.py:154",
            "fcm_accumulate": "src/repro/kernels/fcm_update.py:40",
            "fcm_sweep_batched": "src/repro/engine/backend.py:216"}

# tests/test_kernels.py: SHAPES (sweep atol 3e-5) and OFF_LANE_SHAPES
# (atol 3e-4); the raw accumulators at atol 3e-3; rtol 3e-4 throughout.
SHAPES = [(64, 2, 2), (100, 130, 7), (257, 4, 3), (1000, 18, 10),
          (2048, 28, 50), (31, 41, 23), (512, 8, 129)]
OFF_LANE_SHAPES = [(300, 130, 131), (200, 129, 140), (96, 257, 129),
                   (513, 131, 200)]
M_SWEEP = (1.05, 1.2, 2.0, 3.0)
RTOL, SWEEP_ATOL, OFF_LANE_ATOL, ACC_ATOL = 3e-4, 3e-5, 3e-4, 3e-3
SAMPLE_SIZE, BLOCK_SIZE = 3184, 2048    # the driver's λ; WFCMPB's block
DRIVER_LABEL = {"sample": "sample", "last_block": "block",
                "first_merge": "merge"}
# The path the launch plan (repro_torch.kernels.fcm_update.plan_sweep /
# plan_batched) gives each run's d and C on an H100; every main-path
# launch must take it.
EXPECTED_PATH = {"higgs_like": "rows", "kdd99_like": "tile",
                 "tenants_t16": "rows", "tenants_65k": "rows",
                 "tenants_kdd99": "tile",
                 "kdd99_stream": "tile", "drift_global": "tile",
                 "drift_split": "tile", "drift_event": "tile",
                 "router_fit": "ctiled", "curriculum": "wide",
                 "lm_moe": "ctiled"}


@dataclasses.dataclass(frozen=True)
class Run:
    name: str
    maker: str        # generator in repro_torch.data.synth
    n: int
    d: int
    c: int
    m: float
    eps: float


RUNS = (Run("higgs_like", "make_higgs_like", 11_000_000, 28, 2, 2.0, 5e-7),
        Run("kdd99_like", "make_kdd_like", 4_898_431, 41, 23, 1.2, 5e-7))


@dataclasses.dataclass(frozen=True)
class TenantRun:
    name: str
    tenants: int
    rows: tuple        # [lo, hi) records per tenant
    m: tuple           # per-tenant m ~ U(lo, hi), or () for the scalar 2.0
    eps: float
    max_iter: int
    row_base: int
    obj_rtol: float    # float64 objective bar against the exact trajectory
    d: int = 4
    c: int = 3
    m0: float = 2.0    # the config's m where ``m`` is ()
    maker: str = ""    # generator in repro_torch.data.synth ("": blobs)
    # Held step by step along the torch backend's trajectory
    # (`hold_step_locked`), the free-running comparison printed
    step_locked: bool = False


# benchmarks/t16_tenant.py:47-53,66-70 (d = 4, C = 3, blobs at 4.0·(i % 5)),
# at its cohort and at the per-user scale the tenant plane is built for;
# and a cohort at the paper's KDD99 width (Table 6: d = 41, C = 23,
# m = 1.2; benchmarks/t6_datasets.py:22): per-host connection logs, each
# tenant U[64, 513) consecutive records of one `make_kdd_like` array,
# with TenantFitConfig's defaults (ε = 1e-6, 300 sweeps, row base 64).
# There, with near-coincident centers at m = 1.2, two f32 fits part by
# whole centers where an ulp of d² hands a record to one or the other,
# and the 1 ± 2⁻²² nudge does not find every such tenant (PERF.md,
# section 6), so its fit is held step-locked, as the CPU test's KDD99
# case is.
# tests/test_tenant.py holds converged fits' objectives to 1e-5; t16's
# fits stop after at most 12 sweeps at ε = 1e-3, far from convergence,
# where the objective moves to first order with the centers, so there it
# gets the 1e-4 bar that file gives fits one sweep apart.
TENANT_RUNS = (TenantRun("tenants_t16", 1024, (8, 30), (), 1e-3, 12, 16,
                         1e-4),
               TenantRun("tenants_65k", 65_536, (64, 513), (1.5, 3.0), 1e-6,
                         300, 64, 1e-5),
               TenantRun("tenants_kdd99", 4096, (64, 513), (), 1e-6, 300, 64,
                         1e-5, d=41, c=23, m0=1.2, maker="make_kdd_like",
                         step_locked=True))


def emit(obj) -> None:
    """One JSON line; a phase's line also gets ``at_s``, the seconds
    since this module was imported."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def max_err(got, want, rtol, atol, what):
    """Largest |got − want| over the outputs; raises past rtol/atol
    (``atol`` one number, or one per output)."""
    import torch
    worst = 0.0
    atols = atol if isinstance(atol, tuple) else (atol,) * len(want)
    for i, (g, e, atol) in enumerate(zip(got, want, atols)):
        if g.shape != e.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what}: output {i} has shape "
                                 f"{tuple(g.shape)} or non-finite values")
        diff = (g - e).abs()
        over = diff - (atol + rtol * e.abs())
        if bool((over > 0).any()):
            raise AssertionError(
                f"{what}: output {i} off by {float(diff.max()):.3e} "
                f"(rtol {rtol}, atol {atol})")
        worst = max(worst, float(diff.max()))
    return worst


def time_ms(fn, reps: int) -> float:
    """Median milliseconds per call, CUDA events around each call after
    two warm-up calls (at small shapes this counts the host's enqueue)."""
    import torch
    for _ in range(2):
        fn()
    events = []
    for _ in range(reps):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in events)
    return times[len(times) // 2]


@functools.cache
def graph_stream():
    """The one side stream every CUDA graph here is captured on: a library
    call keeps a workspace per stream it ran on (cuBLAS's is tens of MB),
    so a fresh stream per timing would leave a new one behind each time."""
    import torch
    return torch.cuda.Stream()


def time_loop_ms(fn, reps: int) -> float:
    """Milliseconds per launch on the card: ``reps`` back-to-back calls
    captured in one CUDA graph (after two warm-up calls on its stream),
    one pair of CUDA events around its replay, divided by ``reps``.  The
    replay takes the host's per-call enqueue out, so at small shapes this
    is the card's time: the kernels and the gaps between them."""
    import torch
    stream = graph_stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    graph.replay()
    e.record()
    torch.cuda.synchronize()
    del graph
    return s.elapsed_time(e) / reps


def shape_counts(fn) -> dict:
    """A wrapper's launches per shape, as {"path NxC" or "path TxN":
    count}."""
    return {" ".join([k[0], "x".join(map(str, k[1:]))]): v
            for k, v in sorted(fn.shapes.items(), key=str)}


def check_paths(run: str, *fns) -> None:
    """Every launch of ``fns`` took ``EXPECTED_PATH[run]``."""
    other = {k: v for fn in fns for k, v in fn.shapes.items()
             if k[0] != EXPECTED_PATH[run]}
    if other:
        raise AssertionError(f"{run}: launches off the expected "
                             f"{EXPECTED_PATH[run]!r} path: {other}")


def bound_bytes(n: int, d: int, c: int) -> int:
    """Bytes one sweep must move: x, w and V read once, v_num, w_i and q
    written once."""
    return 4 * (n * (d + 1) + c * d + c * d + c + 1)


def bound(n: int, d: int, c: int):
    """(ms, what sets it): each input read once, each output written
    once (`bound_bytes`), against 4·N·C·d f32 flops (the two
    contractions)."""
    nbytes = bound_bytes(n, d, c)
    flops = 4 * n * c * d
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _inputs(n, d, c, seed, device):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(a).to(device) for a in (
        rng.normal(size=(n, d)).astype(np.float32),
        rng.uniform(0.1, 3.0, size=(n,)).astype(np.float32),
        rng.normal(size=(c, d)).astype(np.float32))]


def q_rounding_bound(x, w, v) -> float:
    """How far the kernel's q may sit from the plain version's when
    records lie on centers.  The kernel forms d² = ‖x‖² + ‖v‖² − 2x·v,
    as the TPU kernel does (src/repro/kernels/fcm_update.py:56-61); the
    plain version forms ‖x − v‖² directly.  In f32 the two differ by up
    to 2·γ_{d+2}·(‖x‖² + ‖v‖²) per entry (γ_k = k·2⁻²⁴, the dot-product
    rounding bound), which is all of d² for a record on a center, and
    Σ_i u_ik^m ≤ 1."""
    gamma = (x.shape[1] + 2) * 2.0 ** -24
    return 2 * gamma * float(
        (w * ((x * x).sum(1) + (v * v).sum(1).max())).sum())


def driver_cases(run: Run, seed: int, device):
    """The kernel's inputs on the driver race at ``run``'s d, C and m, with
    records drawn from N(0, 1): (label, x, w, centers, atol of q).

    * ``sample``: FCM on the λ-row sample, unit weights, seeded with C of
      its rows;
    * ``last_block``: WFCMPB's last block, the rows past the sample's end
      zero-weight phantoms of zeros;
    * ``first_merge``: WFCMPB's first merge, the zero-mass running summary
      beside the block's C centers with their masses, seeded with those
      centers (so C records lie on centers: q is held to
      `q_rounding_bound`)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    lam, d, c = min(SAMPLE_SIZE, run.n), run.d, run.c

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    x = rng.normal(size=(lam, d))
    yield "sample", t(x), t(np.ones(lam)), t(x[:c]), 0.0
    real = lam - (-(-lam // BLOCK_SIZE) - 1) * BLOCK_SIZE
    xb, wb = np.zeros((BLOCK_SIZE, d)), np.zeros(BLOCK_SIZE)
    xb[:real], wb[:real] = x[lam - real:], 1.0
    yield "last_block", t(xb), t(wb), t(rng.normal(size=(c, d))), 0.0
    vb = rng.normal(size=(c, d))
    pts = t(np.concatenate([x[:c], vb]))
    masses = t(np.concatenate([np.zeros(c), rng.uniform(1.0, BLOCK_SIZE, c)]))
    yield ("first_merge", pts, masses, t(vb),
           q_rounding_bound(pts, masses, t(vb)))


def check_kernels(device) -> dict:
    """Phase 2: kernel vs plain at the test shapes, chunk additivity,
    determinism, and at the driver race's inputs."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.fcm_update import (fcm_accumulate_cuda,
                                                fcm_accumulate_ref,
                                                fcm_sweep_cuda, fcm_sweep_ref)
    worst = {"fcm_sweep": 0.0, "fcm_accumulate": 0.0}
    cases = 0
    for shape in SHAPES + OFF_LANE_SHAPES:
        n, d, c = shape
        x, w, v = _inputs(n, d, c, n + d + c, device)
        atol = SWEEP_ATOL if shape in SHAPES else OFF_LANE_ATOL
        for m in M_SWEEP:
            what = f"shape {shape} m={m}"
            got = fcm_sweep_cuda(x, w, v, m)
            worst["fcm_sweep"] = max(worst["fcm_sweep"], max_err(
                got, fcm_sweep_ref(x, w, v, m), RTOL, atol, "sweep " + what))
            acc = fcm_accumulate_cuda(x, w, v, m)
            worst["fcm_accumulate"] = max(worst["fcm_accumulate"], max_err(
                acc, fcm_accumulate_ref(x, w, v, m), RTOL, ACC_ATOL,
                "accumulate " + what))
            if not all(torch.equal(a, b) for a, b in zip(
                    acc, fcm_accumulate_cuda(x, w, v, m))):
                raise AssertionError(f"two launches differ at {what}")
            cases += 1
    x, w, v = _inputs(900, 11, 5, 17, device)
    cuts = [0, 250, 600, 900]
    chunked = ops.accumulate_chunks([x[a:b] for a, b in zip(cuts, cuts[1:])],
                                    [w[a:b] for a, b in zip(cuts, cuts[1:])],
                                    v, 2.0)
    max_err(chunked, fcm_sweep_cuda(x, w, v, 2.0), 1e-5, 1e-5,
            "chunk additivity")
    driver = {}
    for run in RUNS:
        for label, x, w, v, q_atol in driver_cases(run, 7, device):
            what = f"{label} of {run.name} {tuple(x.shape)} C={run.c}"
            got = fcm_sweep_cuda(x, w, v, run.m)
            acc = fcm_accumulate_cuda(x, w, v, run.m)
            driver[f"{run.name}/{label}"] = max(
                max_err(got, fcm_sweep_ref(x, w, v, run.m), RTOL,
                        (SWEEP_ATOL, SWEEP_ATOL, SWEEP_ATOL + q_atol),
                        "sweep at " + what),
                max_err(acc, fcm_accumulate_ref(x, w, v, run.m), RTOL,
                        (ACC_ATOL, ACC_ATOL, ACC_ATOL + q_atol),
                        "accumulate at " + what))
            if not all(torch.equal(a, b) for a, b in zip(
                    acc, fcm_accumulate_cuda(x, w, v, run.m))):
                raise AssertionError(f"two launches differ at {what}")
    return {"phase": "kernels", "cases": cases, "m": list(M_SWEEP),
            "max_abs_err": worst, "chunk_additivity": "ok",
            "driver_cases_max_abs_err": driver,
            "bitwise_deterministic": True}


def checked_hopper():
    """The ``hopper`` backend with every sweep over records (the driver's
    sample, WFCMPB's blocks and its final objective pass) held against
    the plain version on the same inputs, at the sweep tolerances.
    Merges (at most 2·C points) are counted, not held: their records sit
    on or next to centers, where the kernel's d² expansion and the plain
    version's direct ‖x − v‖² part by rounding (see `q_rounding_bound`);
    phase 2's ``first_merge`` holds the kernel at their shape."""
    from repro_torch.engine import SweepBackend
    from repro_torch.kernels.fcm_update import (fcm_accumulate_cuda,
                                                fcm_accumulate_ref,
                                                fcm_sweep_cuda, fcm_sweep_ref)

    class CheckedHopper(SweepBackend):
        name = "hopper_checked"
        compared = merges = 0
        worst = 0.0

        def _hold(self, kern, plain, atol, x, w, v, m):
            got = kern(x, w, v, m)
            if x.shape[0] <= 2 * v.shape[0]:
                self.merges += 1
                return got
            self.worst = max(self.worst, max_err(
                got, plain(x, w, v, m), RTOL, atol,
                f"{kern.__name__} on the driver race, x {tuple(x.shape)}"))
            self.compared += 1
            return got

        def accumulate(self, x, w, v, m):
            return self._hold(fcm_accumulate_cuda, fcm_accumulate_ref,
                              ACC_ATOL, x, w, v, m)

        def sweep(self, x, w, v, m):
            return self._hold(fcm_sweep_cuda, fcm_sweep_ref, SWEEP_ATOL,
                              x, w, v, m)

    return CheckedHopper()


def check_driver(x, sample_idx, seed_idx, cfg, device) -> dict:
    """The driver race's two branches on the full-size sample, as
    `run_driver` runs them: through `checked_hopper`, and through the
    ``torch`` backend.  A branch whose ``torch`` centers move by more
    than 1e-4 of the sample's RMS when the sample is scaled by 1 + 2⁻²²
    is not fixed by its data at f32 precision: its hopper-vs-torch gap
    is printed, not held.  Iteration counts are printed, not held: the
    driver's ε = 5e-11 on max ‖ΔV‖² lies near the rounding floor of one
    f32 sweep, so when the loop stops is set by summation order."""
    import torch
    from repro_torch.core import fcm, wfcmpb
    xs = x[torch.as_tensor(sample_idx, device=x.device)]
    seeds = xs[torch.as_tensor(seed_idx, device=x.device)]
    scale = float(torch.sqrt(torch.mean(xs * xs)))
    common = dict(m=cfg.m, eps=cfg.driver_eps, max_iter=cfg.max_iter,
                  device=device)
    branches = (
        ("fcm", lambda a, be: fcm(a, seeds, backend=be, **common)),
        ("wfcmpb", lambda a, be: wfcmpb(a, seeds, block_size=cfg.block_size,
                                        backend=be, **common)))
    out = {}
    for name, fit in branches:
        checked = checked_hopper()
        hop, tor = fit(xs, checked), fit(xs, "torch")
        nudged = fit(xs * (1 + 2.0 ** -22), "torch")
        rec = {"center_gap_rel_rms": float(
                   (hop.centers - tor.centers).abs().max()) / scale,
               "q_rel": abs(float(hop.objective) - float(tor.objective))
               / abs(float(tor.objective)),
               "iters_hopper": hop.n_iter, "iters_torch": tor.n_iter,
               "iters_torch_nudged": nudged.n_iter,
               "torch_nudged_rel_rms": float(
                   (nudged.centers - tor.centers).abs().max()) / scale,
               "sweeps_held": checked.compared,
               "merges_counted": checked.merges,
               "sweep_max_abs_err": checked.worst}
        rec["held"] = rec["torch_nudged_rel_rms"] <= 1e-4
        out[name] = rec
        if checked.compared == 0 or rec["held"] and (
                rec["center_gap_rel_rms"] > 1e-3 or rec["q_rel"] > 1e-4):
            raise AssertionError(f"driver {name} hopper vs torch: {rec}")
    return out


def shape_entries(run_name, cases, by_shape, d, m, device, reps,
                  full="full") -> list:
    """Each kernel entry against its plain version, and timed, at every
    case of ``cases`` ({label: (x, w, centers, extra)}, ``extra`` the
    atol added to q's, or one per output)) whose (N, C)
    the run launched it at (``by_shape``: each wrapper's {(path, N, C):
    launches}); the ``full`` case always.  Two launches must agree bit
    for bit.  Returns one kernel-line entry per (kernel, case)."""
    import torch
    from repro_torch.kernels.fcm_update import (fcm_accumulate_cuda,
                                                fcm_accumulate_ref,
                                                fcm_sweep_cuda, fcm_sweep_ref,
                                                launch_plan)
    entries = []
    for kname, kern, plain_fn, atol in (
            ("fcm_sweep", fcm_sweep_cuda, fcm_sweep_ref, SWEEP_ATOL),
            ("fcm_accumulate", fcm_accumulate_cuda, fcm_accumulate_ref,
             ACC_ATOL)):
        for label, (xs, ws, vs, extra) in cases.items():
            ns, c = xs.shape[0], vs.shape[0]
            if not isinstance(extra, tuple):
                extra = (0.0, 0.0, extra)
            count = sum(v for k, v in by_shape[kname].items()
                        if k[1:] == (ns, c))
            if label != full and count == 0:
                continue
            path = launch_plan(device, ns, d, c).path
            plain = plain_fn
            if path == "ctiled":    # its broadcast takes N·C·d floats
                plain = plain_in_rows(fcm_accumulate_ref,
                                      kname == "fcm_sweep")
            got = kern(xs, ws, vs, m)
            if not all(torch.equal(a, b) for a, b in zip(
                    got, kern(xs, ws, vs, m))):
                raise AssertionError(f"{kname}: two launches differ at "
                                     f"{run_name}/{label}")
            want = plain(xs, ws, vs, m)
            err = max_err(got, want, RTOL, tuple(atol + e for e in extra),
                          f"{kname} at {run_name}/{label}")
            del want
            n_rep = reps if label == full else 500
            ms = time_loop_ms(lambda: kern(xs, ws, vs, m), n_rep)
            per_call = time_ms(lambda: kern(xs, ws, vs, m), n_rep)
            plain_ms = time_ms(lambda: plain(xs, ws, vs, m),
                               3 if label == full else 50)
            torch.cuda.empty_cache()
            b_ms, b_by = bound(ns, d, c)
            entries.append({
                "name": kname, "run": f"{run_name}/{label}",
                "launches": count, "max_abs_err": err, "ms": ms,
                "ms_per_call": per_call, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
                "shape": [ns, d, c], "path": path})
            if path == "wide":
                plan = launch_plan(device, ns, d, c)
                entries[-1].update(
                    dsplits=plan.dsplits, rows=plan.rows,
                    member_library_ms=membership_library_ms(xs, vs, n_rep),
                    contraction_library_ms=contraction_library_ms(xs, c,
                                                                  n_rep))
            if path == "ctiled":
                plan = launch_plan(device, ns, d, c)
                entries[-1]["launch_ms"] = ctiled_launch_ms(
                    kern, (xs, ws, vs, m), n_rep, plan.dsplits > 1)
                entries[-1]["dsplits"] = plan.dsplits
                entries[-1]["member_library_ms"] = membership_library_ms(
                    xs, vs, n_rep)
                entries[-1]["contraction_library_ms"] = (
                    contraction_library_ms(xs, c, n_rep))
                if label == full:
                    entries[-1]["library_ms"] = entries[-1][
                        "contraction_library_ms"]
    return entries


def contraction_library_ms(x, c, reps) -> float:
    """The C-tiled kernel's contraction half, v_num = wumᵀx, is one matrix
    product: ``torch.matmul`` of an (N, C) f32 block with x (IEEE f32, no
    TF32), timed as the kernel is.  A yardstick only: the port never
    calls it."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    wum = torch.rand((x.shape[0], c), dtype=torch.float32, device=x.device)
    return time_loop_ms(lambda: torch.matmul(wum.T, x), reps)


def membership_library_ms(x, v, reps) -> float:
    """The membership half's product x·vᵀ, the (N, C) block the C-tiled
    kernel forms d² from: ``torch.matmul`` in IEEE f32, timed as the
    kernel is.  A yardstick only: the port never calls it."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    return time_loop_ms(lambda: torch.matmul(x, v.T), reps)


# One chunk's launches: the membership (with d-splits, their partials and
# then their sum), the contraction, the finish.
CTILED_STAGES = ("member", "member_finish", "contract", "finish")


class _StageLib:
    """A kernel library with one call cut to one launch: ``attr(*args)``
    (by default the C-tiled chunk call) runs ``stage_fn(stage, *args)``."""

    def __init__(self, lib, stage_fn, stage, attr="fcm_ctiled_chunk"):
        self._lib, self._stage_fn, self._stage = lib, stage_fn, stage
        self._attr = attr

    def __getattr__(self, name):
        if name == self._attr:
            return lambda *args: self._stage_fn(self._stage, *args)
        return getattr(self._lib, name)


def ctiled_launch_ms(kern, args, reps, dsplit, stage_fn=None) -> dict:
    """The C-tiled sweep's launches timed apart: ``kern(*args)`` with each
    row chunk cut to one of its launches (CTILED_STAGES), each timed as
    `time_loop_ms` times the whole; "member_finish" is 0.0 unless
    ``dsplit`` (the plan splits d, so that it launches).  ``stage_fn``
    (stage, *chunk args) launches one of them; by default the library's
    own ``fcm_ctiled_stage``.  Alone, a launch reads scratch that the one
    before it did not write: its time, not its values, is what this
    measures."""
    from repro_torch.kernels import fcm_update as fu
    real = fu._ctiled_lib
    lib = real()
    stage_fn = stage_fn or lib.fcm_ctiled_stage
    out = {}
    try:
        for stage, name in enumerate(CTILED_STAGES):
            if name == "member_finish" and not dsplit:
                out[name] = 0.0
                continue
            fu._ctiled_lib = lambda s=stage: _StageLib(lib, stage_fn, s)
            out[name] = time_loop_ms(lambda: kern(*args), reps)
    finally:
        fu._ctiled_lib = real
    return out


def main_path_arrays(seed: int) -> dict:
    """The arrays of phase 3, made with numpy from ``seed``: each run's of
    RUNS by its maker, and ``router_fit``'s (`make_router_like`)."""
    from repro_torch.data import synth
    out = {run.name: getattr(synth, run.maker)(run.n, seed=seed)[0]
           for run in RUNS}
    out["router_fit"] = make_router_like(ROUTER_N, ROUTER_D, ROUTER_C, seed)
    return out


def run_main_path(run: Run, x_np, seed: int, device, reps: int):
    """Phase 3 for one dataset (``x_np``, from `main_path_arrays`): the
    main path with counted launches, the hopper-vs-torch comparison at
    full size, and the per-kernel checks and times.  Returns (phase
    record, kernel entries)."""
    import numpy as np
    import torch
    from repro_torch.core import BigFCMConfig, bigfcm_fit
    from repro_torch.device import synchronize
    from repro_torch.engine import get_backend
    from repro_torch.kernels.fcm_update import (fcm_accumulate_cuda,
                                                fcm_sweep_cuda, reset_counts)

    t0 = time.perf_counter()
    x = torch.from_numpy(x_np).to(device)
    n, d = x.shape
    if d != run.d:
        raise AssertionError(f"{run.maker} gave d={d}, expected {run.d}")
    ones = torch.ones((n,), dtype=torch.float32, device=device)
    synchronize(device)
    setup_s = time.perf_counter() - t0
    cfg = BigFCMConfig(n_clusters=run.c, m=run.m, combiner_eps=run.eps,
                       reducer_eps=run.eps, max_iter=1000,
                       sample_size=min(SAMPLE_SIZE, n),
                       block_size=BLOCK_SIZE, seed=seed, backend="hopper")
    backend = cfg.backend

    # -- the main path, with launch counts zeroed just before it
    reset_counts()
    synchronize(device)
    t0 = time.perf_counter()
    res = bigfcm_fit(x, cfg, device=device)
    _, _, q = get_backend("hopper_accumulate").accumulate(
        x, ones, res.centers, run.m)
    synchronize(device)
    wall = time.perf_counter() - t0
    launches = {"fcm_sweep": fcm_sweep_cuda.launches,
                "fcm_accumulate": fcm_accumulate_cuda.launches}
    by_shape = {"fcm_sweep": dict(fcm_sweep_cuda.shapes),
                "fcm_accumulate": dict(fcm_accumulate_cuda.shapes)}
    if device.type == "cuda" and min(launches.values()) == 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    check_paths(run.name, fcm_sweep_cuda, fcm_accumulate_cuda)
    if res.centers.shape != (run.c, d) or not (
            bool(torch.isfinite(res.centers).all()) and math.isfinite(float(q))):
        raise AssertionError("main path gave non-finite or mis-shaped output")
    diag = res.diagnostics
    roof = roofline_record(n, run.c, d, x, ones, res.centers, run.m, device)
    record = {"phase": "main_path", "run": run.name, "n": n, "d": d,
              "c": run.c, "m": run.m, "eps": run.eps, "backend": backend,
              "setup_s": setup_s, "wall_s": wall, "flag": diag.flag,
              "t_fcm_driver_s": diag.t_fcm_driver,
              "t_wfcmpb_driver_s": diag.t_wfcmpb_driver,
              "combiner_iters": list(diag.combiner_iters),
              "reducer_iters": diag.reducer_iters, "global_q": float(q),
              "launches": launches,
              "launches_by_shape": {
                  "fcm_sweep": shape_counts(fcm_sweep_cuda),
                  "fcm_accumulate": shape_counts(fcm_accumulate_cuda)},
              "roofline": roof}

    # -- hopper vs the torch backend, same injected seeds, full size
    rng = np.random.default_rng(seed)
    sample_idx = rng.choice(n, cfg.sample_size, replace=False)
    seed_idx = rng.choice(cfg.sample_size, run.c, replace=False)
    fits, qs = {}, {}
    for name, acc_backend in (("hopper", "hopper_accumulate"),
                              ("torch", "torch")):
        fits[name] = bigfcm_fit(
            x, dataclasses.replace(cfg, use_driver=False, backend=name),
            sample_idx=sample_idx, seed_idx=seed_idx, device=device)
        qs[name] = float(get_backend(acc_backend).accumulate(
            x, ones, fits[name].centers, run.m)[2])
    scale = float(torch.sqrt(torch.mean(x * x)))
    center_err = float((fits["hopper"].centers - fits["torch"].centers)
                       .abs().max()) / scale
    q_rel = abs(qs["hopper"] - qs["torch"]) / abs(qs["torch"])
    it = {k: (f.diagnostics.combiner_iters[0], f.diagnostics.reducer_iters)
          for k, f in fits.items()}
    # What the store phase holds its fits against: the in-memory fits of
    # the same array from the same injected draws.
    held = {"x": x_np, "cfg": cfg, "sample_idx": sample_idx,
            "seed_idx": seed_idx, "q": qs, "iters": it,
            "centers": {k: f.centers.cpu() for k, f in fits.items()}}
    record["vs_torch"] = {"center_err_rel_rms": center_err, "q_rel": q_rel,
                          "iters_hopper": it["hopper"],
                          "iters_torch": it["torch"]}
    # f32 summation order over 10^7 rows differs, and ε bounds only ΔV².
    if center_err > 1e-3 or q_rel > 1e-4 or any(
            abs(a - b) > 2 for a, b in zip(it["hopper"], it["torch"])):
        raise AssertionError(f"hopper vs torch at {run.name}: "
                             f"{record['vs_torch']}")
    record["driver_vs_torch"] = check_driver(x, sample_idx, seed_idx, cfg,
                                             device)
    emit(record)

    # -- each kernel entry vs its plain version at every shape the main
    #    path launched it at, and timed there
    cases = {"full": (x, ones, res.centers, 0.0)}
    for label, xs, ws, vs, q_atol in driver_cases(run, 7, device):
        cases[DRIVER_LABEL[label]] = (xs, ws, vs, q_atol)
    # Any other size the main path launched at (C-point merges, the
    # objective over a run of blocks): its first records, unit weights.
    for ns in sorted({k[1] for shapes in by_shape.values() for k in shapes}
                     - {xs.shape[0] for xs, *_ in cases.values()}):
        xs = x[:ns]
        cases[f"n={ns}"] = (xs, ones[:ns], res.centers,
                            q_rounding_bound(xs, ones[:ns], res.centers))
    entries = shape_entries(run.name, cases, by_shape, d, run.m, device,
                            reps)
    return entries, held


# router_fit: the fit src/repro/integration/router_init.py:40-47 runs
# through bigfcm_fit, at OLMoE-1B-7B's d_model x n_experts
# (src/repro/configs/olmoe_1b_7b.py:6,8), with router_init.py:40-42's own
# config; the driver's sample is Parker-Hall's (521,663 rows at C = 64:
# every row).
ROUTER_N, ROUTER_D, ROUTER_C, ROUTER_M = 262_144, 2048, 64, 2.0
ROUTER_SEP = 2.0        # spread of the component means, per dim


def make_router_like(n, d, c, seed):
    """Token-embedding-like rows: c Gaussian components of unequal mass
    (p_k ∝ (k + 1)^-0.8, as token frequencies fall off), means N(0,
    ROUTER_SEP²) per dim, unit spread; f32, made with numpy from
    ``seed``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    means = rng.normal(0.0, ROUTER_SEP, size=(c, d)).astype(np.float32)
    p = (np.arange(1, c + 1) ** -0.8)
    labels = rng.choice(c, size=n, p=p / p.sum())
    x = rng.standard_normal((n, d), dtype=np.float32)
    for r0 in range(0, n, 1 << 15):
        x[r0:r0 + (1 << 15)] += means[labels[r0:r0 + (1 << 15)]]
    return x


def router_config(seed):
    from repro_torch.core import BigFCMConfig
    return BigFCMConfig(n_clusters=ROUTER_C, m=ROUTER_M, combiner_eps=1e-6,
                        reducer_eps=1e-8, max_iter=200, seed=seed,
                        backend="hopper")


def hold_router_fits(x, ones, cfg, draws, device) -> dict:
    """``hold_fit``'s gates on the fit through ``hopper`` against the
    ``torch`` backend from the same injected draws (driver off, as
    `run_main_path` holds its fits).  What a ``torch`` fit of the data
    scaled by 1 + 2⁻²² moves is not fixed by the data at f32: a sweep
    count that misses its ±2 must move so there (the reducer polishes C
    points on their own centers, where the d² expansion is rounding
    noise, and can wander to ``max_iter``); centers or q that miss their
    bars must have moved by more than 1e-4 of the RMS there, and are
    then held against a float64 ``torch`` twin as PR 15's steps are: the
    hopper fit as near it as the ``torch`` one (2×)."""
    import torch
    from repro_torch.core import bigfcm_fit
    from repro_torch.engine import get_backend

    def fit(xs, backend):
        f = bigfcm_fit(xs, dataclasses.replace(cfg, use_driver=False,
                                               backend=backend),
                       sample_idx=draws[0], seed_idx=draws[1], device=device)
        acc = "hopper_accumulate" if backend == "hopper" else "torch"
        q = float(get_backend(acc).accumulate(
            xs, ones.to(xs.dtype), f.centers, cfg.m)[2])
        return f.centers, q, fit_iters(f)

    scale = float(torch.sqrt(torch.mean(x * x)))
    hop, tor = fit(x, "hopper"), fit(x, "torch")
    rec = {"center_err_rel_rms": float((hop[0] - tor[0]).abs().max())
           / scale, "q_rel": abs(hop[1] - tor[1]) / abs(tor[1]),
           "iters": [hop[2], tor[2]]}
    bars = rec["center_err_rel_rms"] <= 1e-3 and rec["q_rel"] <= 1e-4
    if bars and all(abs(a - b) <= 2 for a, b in zip(hop[2], tor[2])):
        return rec
    nudged = fit(x * (1 + 2.0 ** -22), "torch")
    rec["torch_nudged_iters"] = nudged[2]
    rec["torch_nudged_rel_rms"] = float(
        (nudged[0] - tor[0]).abs().max()) / scale
    if bars:
        if all(abs(a - b) <= 2 or abs(u - b) > 2
               for a, b, u in zip(hop[2], tor[2], nudged[2])):
            return rec
        raise AssertionError(f"router_fit sweeps: {rec}")
    with float64():
        exact = fit(x.double(), "torch")

    def gap(a):
        return (float((a[0].double() - exact[0]).abs().max()) / scale,
                abs(a[1] - exact[1]) / abs(exact[1]))
    rec.update(hopper_vs_float64=gap(hop), torch_vs_float64=gap(tor),
               float64_iters=exact[2])
    if rec["torch_nudged_rel_rms"] <= 1e-4 or any(
            h > 2 * t for h, t in zip(rec["hopper_vs_float64"],
                                      rec["torch_vs_float64"])):
        raise AssertionError(f"router_fit: {rec}")
    return rec


def run_router_fit(x_np, seed: int, device, reps: int):
    """Phase 3b: `fcm_router_init` over OLMoE's router tree, its
    `bigfcm_fit` on backend ``hopper`` at router_fit's full width (the
    C-tiled kernel's main path), launch counts zeroed just before it and
    read after the global objective pass; the fit held against the
    ``torch`` backend (`hold_router_fits`); the routers held
    (`hold_router_init`); each kernel entry against its
    plain version (in row chunks) at every shape the fit launched it at,
    and timed.  Returns (phase record, kernel entries)."""
    import numpy as np
    import torch
    from repro_torch.device import synchronize
    from repro_torch.engine import get_backend
    from repro_torch.integration import fcm_router_init
    from repro_torch.kernels.fcm_update import (fcm_accumulate_cuda,
                                                fcm_sweep_cuda, reset_counts)

    t0 = time.perf_counter()
    x = torch.from_numpy(x_np).to(device)
    del x_np
    ones = torch.ones((ROUTER_N,), dtype=torch.float32, device=device)
    moe_cfg, tree = olmoe_router_tree(seed, device)
    synchronize(device)
    setup_s = time.perf_counter() - t0
    cfg = router_config(seed)
    backend = cfg.backend

    reset_counts()
    synchronize(device)
    t0 = time.perf_counter()
    seeded, res = fcm_router_init(tree, moe_cfg, x, fcm_cfg=cfg,
                                  device=device)
    _, _, q = get_backend("hopper_accumulate").accumulate(
        x, ones, res.centers, cfg.m)
    synchronize(device)
    wall = time.perf_counter() - t0
    launches = {"fcm_sweep": fcm_sweep_cuda.launches,
                "fcm_accumulate": fcm_accumulate_cuda.launches}
    by_shape = {"fcm_sweep": dict(fcm_sweep_cuda.shapes),
                "fcm_accumulate": dict(fcm_accumulate_cuda.shapes)}
    if min(launches.values()) == 0:
        raise AssertionError(f"router_fit: a kernel was not launched: "
                             f"{launches}")
    check_paths("router_fit", fcm_sweep_cuda, fcm_accumulate_cuda)
    if res.centers.shape != (ROUTER_C, ROUTER_D) or not (
            bool(torch.isfinite(res.centers).all())
            and math.isfinite(float(q))):
        raise AssertionError("router_fit gave non-finite or mis-shaped "
                             "output")
    diag = res.diagnostics
    record = {"phase": "main_path", "run": "router_fit", "n": ROUTER_N,
              "d": ROUTER_D, "c": ROUTER_C, "m": cfg.m,
              "combiner_eps": cfg.combiner_eps,
              "reducer_eps": cfg.reducer_eps, "max_iter": cfg.max_iter,
              "sample_size": diag.sample_size, "backend": backend,
              "setup_s": setup_s, "wall_s": wall, "flag": diag.flag,
              "t_fcm_driver_s": diag.t_fcm_driver,
              "t_wfcmpb_driver_s": diag.t_wfcmpb_driver,
              "combiner_iters": list(diag.combiner_iters),
              "reducer_iters": diag.reducer_iters, "global_q": float(q),
              "launches": launches,
              "launches_by_shape": {
                  "fcm_sweep": shape_counts(fcm_sweep_cuda),
                  "fcm_accumulate": shape_counts(fcm_accumulate_cuda)}}
    record["ctiled_plans"] = router_plans(by_shape, device)
    rng = np.random.default_rng(seed)
    lam = diag.sample_size
    draws = (rng.choice(ROUTER_N, lam, replace=False),
             rng.choice(lam, ROUTER_C, replace=False))
    record["hold"] = hold_router_fits(x, ones, cfg, draws, device)
    emit(record)
    emit({"phase": "router_init", "arch": "olmoe-1b-7b",
          "router_fit": hold_router_init(tree, seeded, res.centers, x),
          "embed_table": "fit and held in lm_moe, on the served model"})
    del tree, seeded
    entries = fit_entries("router_fit", x, ones, res.centers, by_shape,
                          cfg.m, device, reps)
    del x
    torch.cuda.empty_cache()
    return entries


def fit_entries(run_name, x, ones, centers, by_shape, m, device, reps):
    """`shape_entries` of a fit over all of x: the full shape, and every
    other N the fit launched a kernel at (x's first N rows; past x's own
    N, x with WFCMPB's zero-weight phantom rows of zeros)."""
    import torch
    cases = {"full": (x, ones, centers, 0.0)}
    for ns in sorted({k[1] for shapes in by_shape.values() for k in shapes}
                     - {x.shape[0]}):
        pad = max(0, ns - x.shape[0])
        xs = torch.cat([x[:ns], x.new_zeros((pad, x.shape[1]))])
        ws = torch.cat([ones[:ns], ones.new_zeros((pad,))])
        cases[f"n={ns}"] = (xs, ws, centers, q_rounding_bound(xs, ws,
                                                              centers))
    return shape_entries(run_name, cases, by_shape, x.shape[1], m, device,
                         reps)


ROUTER_DSPLIT_N = (2 * ROUTER_C, BLOCK_SIZE)   # WFCMPB's merges and blocks
ROUTER_AGREE = 0.9      # top-1 routing vs hard_assign (tests/test_integration.py:44)
# On router_fit's rows the m = 2 fit's centers at d = 2048 sit near the
# data's mean (FCM's high-dimensional flattening), so routing by the
# unit centers and hard assignment to them part ways: that agreement is
# printed.  It is held where tests/test_integration.py:23 holds it, on
# that test's embedding table (make_blobs(vocab_padded, d_model,
# n_experts, spread 0.1, sep 2.0)) made at OLMoE's full width: lm_moe
# serves with it as the embedding table and its fit's routers.
ROUTER_TABLE_SPREAD, ROUTER_TABLE_SEP = 0.1, 2.0


def olmoe_router_tree(seed, device):
    """OLMoE-1B-7B's routers in the reference's layout: a tree holding
    ``stages[0]["moe"]["w_router"]``, (n_layers − first_dense, d_model,
    n_experts) = (16, 2048, 64) stacked as src/repro/models/moe.py:36
    declares it, in the config's bf16, random from ``seed`` (the
    experts' FFN weights play no part and are left out)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.moe import moe_decl
    from repro_torch.models.params import stack_layers, tree_init
    from repro_torch.models.transformer import torch_dtype
    cfg = get_config("olmoe-1b-7b")
    if (cfg.d_model, cfg.n_experts) != (ROUTER_D, ROUTER_C):
        raise AssertionError(f"olmoe-1b-7b is {cfg.d_model} x "
                             f"{cfg.n_experts}, router_fit {ROUTER_D} x "
                             f"{ROUTER_C}")
    decl = {"stages": [stack_layers(
        lambda: {"moe": {"w_router": moe_decl(cfg)["w_router"]}},
        cfg.n_layers - cfg.first_dense)]}
    gen = torch.Generator(device=device).manual_seed(seed)
    return cfg, tree_init(gen, decl, torch_dtype(cfg.param_dtype), device)


def hold_router_init(tree, seeded, centers, x) -> dict:
    """Every layer's router of `fcm_router_init`'s tree equals (v/‖v‖)ᵀ of
    the fit in the leaf's own dtype, shape and device, the input tree
    untouched; and the share of rows where the top-1 choice of x·w is
    `hard_assign`'s, printed (`lm_moe` holds it on its table)."""
    import torch
    from repro_torch.core import hard_assign
    before = tree["stages"][0]["moe"]["w_router"]
    w = seeded["stages"][0]["moe"]["w_router"]
    v = centers / (torch.linalg.norm(centers, dim=-1, keepdim=True) + 1e-8)
    want = v.T.to(before.dtype)
    if w.shape != before.shape or w.dtype != before.dtype or \
            w.device != before.device or w is before:
        raise AssertionError(f"router_init: w_router {tuple(w.shape)} "
                             f"{w.dtype} on {w.device}")
    if not all(torch.equal(w[l], want) for l in range(w.shape[0])):
        raise AssertionError("router_init: a layer's router is not "
                             "(v/|v|)^T of the fit")
    agree = 0
    for r0 in range(0, x.shape[0], 1 << 16):
        xs = x[r0:r0 + (1 << 16)]
        agree += int(((xs @ w[0].float()).argmax(1)
                      == hard_assign(xs, centers)).sum())
    agree /= x.shape[0]
    norms = torch.linalg.norm(centers, dim=-1)
    return {"w_router": list(w.shape), "dtype": str(w.dtype).split(".")[-1],
            "layers_equal_unit_centers": w.shape[0],
            "top1_agreement": agree,
            "center_norms": [float(norms.min()), float(norms.max())]}


def router_plans(by_shape, device) -> dict:
    """The C-tiled plan of every (N, C) router_fit launched at, with its
    launches (`_ctiled_launch` runs the plan's d-splits at every
    launch); fails unless the 2·C-point merges and the 2048-row blocks
    were launched with d split across CTAs."""
    from repro_torch.kernels.fcm_update import launch_plan
    launched = collections.Counter()
    for shapes in by_shape.values():
        for (_, ns, c), count in shapes.items():
            launched[ns, c] += count
    plans = {}
    for (ns, c), count in sorted(launched.items()):
        plan = launch_plan(device, ns, ROUTER_D, c)
        plans[f"{ns}x{c}"] = {"launches": count, "tile": plan.tile,
                              "dsplits": plan.dsplits,
                              "member_ctas": plan.grid,
                              "contract_splits": plan.splits}
    for ns in ROUTER_DSPLIT_N:
        got = plans.get(f"{ns}x{ROUTER_C}")
        if got is None or got["dsplits"] < 2:
            raise AssertionError(f"router_fit: no d-split launch at N = {ns}: "
                                 f"{plans}")
    return plans


def tenant_stack(t, n, d, c, seed, device, phantoms=2):
    """K3's inputs: t tenants of ragged rows (at least n/3 of the n-row
    bucket, the rest zero-weight phantom rows), then ``phantoms``
    all-zero phantom tenants, and per-tenant m drawn from M_SWEEP."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    x = np.zeros((t + phantoms, n, d), np.float32)
    w = np.zeros((t + phantoms, n), np.float32)
    v = np.zeros((t + phantoms, c, d), np.float32)
    for i in range(t):
        rows = int(rng.integers(max(1, n // 3), n + 1))
        x[i, :rows] = rng.normal(size=(rows, d))
        w[i, :rows] = rng.uniform(0.1, 3.0, size=rows)
        v[i] = rng.normal(size=(c, d))
    m = rng.choice(M_SWEEP, size=t + phantoms).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (x, w, v, m)]


# The first tenant-stacked version's time at phase 2b's (66, 300, 41, 23)
# on an H100 80GB HBM3 at 700 W, the last this script measured before the
# tile kernel's tenant axis replaced it (PERF.md section 6).
FIRST_K3_MS = 0.0468
# K3's paths past the rows kernel (T, N, d, C, path): the tile / C-tiled
# boundary at C = 64 (d = 128 is the last d the tile kernel's micro-tiles
# hold) and at d = 8 (C = 128 the last C).
K3_BOUNDARY = ((3, 300, 128, 64, "tile"), (3, 300, 129, 64, "ctiled"),
               (3, 300, 8, 129, "ctiled"))


def forced_ctiled(F, n, d, c, normalize, tenants=None):
    """The C-tiled kernel at (n, d, c) (``tenants`` models stacked, or one)
    whatever path the plan takes there: ``plan_ctiled`` launched through
    the wrappers' own `_ctiled_launch` of module ``F``
    (repro_torch.kernels.fcm_update of some checkout); returns (launcher
    (x, w, v, m) → outputs, its plan).  m: a number, or one per tenant."""
    import torch
    sms, smem = F._card(0)
    t = tenants or 1
    plan = F.plan_ctiled(t, n, d, c, sms=sms, smem_limit=smem)

    def run(x, w, v, m):
        f32 = dict(dtype=torch.float32, device=x.device)
        lead = () if tenants is None else (t,)
        out = (torch.empty(lead + (c, d), **f32),
               torch.empty(lead + (c,), **f32), torch.empty(lead, **f32))
        scalar = isinstance(m, (int, float))
        mt = None if scalar else m.float().contiguous()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        F._check(F._ctiled_launch(
            plan, x, w, v, None if scalar else mt.data_ptr(),
            float(m) if scalar else 0.0, t, n, d, c, normalize, x.device,
            stream, out), "launch", "fcm_ctiled")
        return out
    run.__name__ = "forced_ctiled"
    return run, plan


def hold_k3(x, w, v, m, t, what, path=None) -> tuple:
    """K3's sweep and raw entries at (x, w, v, m) against their plain
    versions (the test_kernels tolerances), each rerun bit for bit, the
    tenants past the first ``t`` (all-zero phantoms) exactly 0, every
    launch on ``path`` where given; returns the two worst errors."""
    import torch
    from repro_torch.kernels.fcm_update import (
        fcm_accumulate_batched_cuda, fcm_accumulate_batched_ref,
        fcm_sweep_batched_cuda, fcm_sweep_batched_ref)
    errs = []
    for kern, plain, atol in ((fcm_sweep_batched_cuda, fcm_sweep_batched_ref,
                               SWEEP_ATOL),
                              (fcm_accumulate_batched_cuda,
                               fcm_accumulate_batched_ref, ACC_ATOL)):
        before = kern.shapes.copy()
        got = kern(x, w, v, m)
        if path is not None and launched_path(kern, before) != path:
            raise AssertionError(f"{kern.__name__} {what}: not on {path}")
        errs.append(max_err(got, plain(x, w, v, m), RTOL, atol,
                            f"{kern.__name__} {what}"))
        if not all(torch.equal(a, b) for a, b in zip(got, kern(x, w, v, m))):
            raise AssertionError(f"two K3 launches differ: {what}")
        if any(bool(o[t:].abs().any()) for o in got):
            raise AssertionError(f"phantom tenants not 0: {what}")
    return tuple(errs)


def check_tenant_kernels(device) -> dict:
    """Phase 2b: the tenant-stacked kernel (K3) against its plain version
    at the test_kernels tolerances, per-tenant and scalar m, two
    phantom tenants; bit-identical reruns, exact zeros on phantoms, and
    one tenant against the single-model kernel (K1/K2); both sides of
    the tile / C-tiled boundary (``K3_BOUNDARY``).  K3 at (64 + 2, 300,
    41, 23), on the tile kernel's tenant axis, is timed beside the first
    tenant-stacked version's recorded time, the C-tiled kernel forced at
    that shape, its plain version and its bound (``tile_tenants``)."""
    from repro_torch.kernels import fcm_update as F
    from repro_torch.kernels.fcm_update import (
        fcm_accumulate_cuda, fcm_sweep_batched_cuda, fcm_sweep_batched_ref,
        fcm_sweep_cuda, launch_plan)
    worst = {"fcm_sweep_batched": 0.0, "fcm_accumulate_batched": 0.0}

    def hold(x, w, v, m, t, what, path=None):
        for key, err in zip(worst, hold_k3(x, w, v, m, t, what, path)):
            worst[key] = max(worst[key], err)

    cases = 0
    for t in (1, 5, 64):
        for d in (4, 41):
            for c in (3, 23):
                x, w, v, m_t = tenant_stack(t, 300, d, c, t + d + c, device)
                for m in (m_t, 1.2):
                    hold(x, w, v, m, t, f"T={t}+2 phantoms N=300 d={d} C={c} "
                         f"m={'per-tenant' if m is m_t else m}")
                    cases += 1
    boundary = {}
    for t, n, d, c, path in K3_BOUNDARY:
        x, w, v, m_t = tenant_stack(t, n, d, c, d + c, device)
        for m in (m_t, 1.2):
            hold(x, w, v, m, t, f"T={t}+2 phantoms N={n} d={d} C={c} "
                 f"m={'per-tenant' if m is m_t else m}", path)
            cases += 1
        boundary[f"{t}x{n}x{d}x{c}"] = path
    one = {}
    for d, c, m in ((4, 3, 2.0), (41, 23, 1.2)):
        x, w, v = _inputs(20_000, d, c, d + c, device)
        for kb, k1, atol in ((fcm_sweep_batched_cuda, fcm_sweep_cuda,
                              SWEEP_ATOL),
                             (F.fcm_accumulate_batched_cuda,
                              fcm_accumulate_cuda, ACC_ATOL)):
            got = [o[0] for o in kb(x[None], w[None], v[None], m)]
            one[f"{kb.__name__}/d{d}c{c}"] = max_err(
                got, k1(x, w, v, m), RTOL, atol,
                f"{kb.__name__} T=1 vs {k1.__name__} d={d} C={c}")
    x, w, v, m_t = tenant_stack(64, 300, 41, 23, 64 + 41 + 23, device)
    ct, _ = forced_ctiled(F, 300, 41, 23, True, tenants=66)
    max_err(ct(x, w, v, m_t), fcm_sweep_batched_ref(x, w, v, m_t), RTOL,
            SWEEP_ATOL, "forced C-tiled K3 at (66, 300, 41, 23)")
    b_ms, b_by = bound_batched(66, 300, 41, 23)
    ms = time_loop_ms(lambda: fcm_sweep_batched_cuda(x, w, v, m_t), 200)
    tile = {"shape": [66, 300, 41, 23],
            "path": launch_plan(device, 300, 41, 23, tenants=66).path,
            "ms": ms, "first_version_ms_recorded": FIRST_K3_MS,
            "ctiled_ms": time_loop_ms(lambda: ct(x, w, v, m_t), 200),
            "plain_ms": time_ms(
                lambda: fcm_sweep_batched_ref(x, w, v, m_t), 20),
            "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms}
    if tile["path"] != "tile":
        raise AssertionError(f"K3 at (66, 300, 41, 23): {tile['path']}")
    return {"phase": "tenant_kernels", "cases": cases,
            "max_abs_err": worst, "one_tenant_vs_k1_max_abs_err": one,
            "boundary_paths": boundary, "tile_tenants": tile,
            "bitwise_deterministic": True, "phantom_tenants_exact_zero": True}


# The C-tiled kernel's checks (phase 2c): K1/K2 at router-fit widths
# (d = 900; OLMoE's 2048 × 64; Kimi-K2's 7168 × 384), K3 at 2048 × 64.
CTILED_SHAPES = ((4096, 900, 64), (4096, 2048, 64), (1024, 7168, 384))
CTILED_TENANTS = (3, 1000, 2048, 64)     # T with one all-phantom tenant
CTILED_CHUNKED_BUDGET = 1_200_000        # bytes: 2 tenant groups x 4 chunks
PLAIN_CHUNK_BYTES = 1 << 30


def plain_in_rows(acc_ref, normalize: bool):
    """A plain version over row chunks whose (rows, C, d) broadcast takes
    at most about PLAIN_CHUNK_BYTES (it takes N·C·d floats in one call:
    11 GB at (1024, 7168, 384)), raw sums added in row order, then the
    sweep's normalization: one call when one chunk holds every row.
    ``acc_ref`` is fcm_accumulate_ref or fcm_accumulate_batched_ref."""
    def plain(x, w, v, m):
        import torch
        axis = x.dim() - 2
        n = x.shape[axis]
        lead = x.shape[0] if x.dim() == 3 else 1
        rows = max(1, PLAIN_CHUNK_BYTES // (4 * lead * v.shape[-2]
                                            * x.shape[-1]))
        out = None
        for r0 in range(0, n, rows):
            part = acc_ref(x.narrow(axis, r0, min(rows, n - r0)),
                           w.narrow(axis, r0, min(rows, n - r0)), v, m)
            out = part if out is None else tuple(
                a + b for a, b in zip(out, part))
        if normalize:
            v_num, w_i, q = out
            out = (v_num / torch.clamp(w_i, min=1e-12)[..., None], w_i, q)
        return out
    return plain


def launched_path(fn, before) -> str:
    """The one path ``fn`` launched since its ``shapes`` were ``before``."""
    new = fn.shapes - before
    if len(new) != 1:
        raise AssertionError(f"{fn.__name__}: launched {dict(new)}")
    return next(iter(new))[0]


def hold_launch(kern, plain, args, atols, what, path="ctiled") -> float:
    """One launch against its plain version (``atols`` per output) and a
    bit-identical rerun: through a wrapper, counted on ``path``; or
    (``path`` None) a launcher that counts nothing (`fcm_sweep_wide`)."""
    import torch
    before = None if path is None else kern.shapes.copy()
    got = kern(*args)
    if path is not None and launched_path(kern, before) != path:
        raise AssertionError(f"{what}: not on the {path} path")
    err = max_err(got, plain(*args), RTOL, atols, what)
    if not all(torch.equal(a, b) for a, b in zip(got, kern(*args))):
        raise AssertionError(f"{what}: two launches differ")
    return err


def check_ctiled_kernels(device) -> dict:
    """Phase 2c: the C-tiled kernel (csrc/fcm_ctiled.cu) against its plain
    version (computed in row chunks) at test_kernels.py's tolerances:
    K1/K2 at CTILED_SHAPES for m = 2 and 1.2, with zero-weight phantom
    rows, and with C records on the centers (q held to the expansion's
    rounding bound); K3 at CTILED_TENANTS with per-tenant and scalar m,
    the phantom tenant exactly 0; and K3/K1 with the scratch cut to
    CTILED_CHUNKED_BUDGET, so that raw sums add over tenant groups and
    row chunks.  Every launch is counted on path "ctiled"; each shape's
    kernel and plain times are printed."""
    import torch
    from repro_torch.kernels import fcm_update as fu
    sweep = plain_in_rows(fu.fcm_accumulate_ref, True)
    acc = plain_in_rows(fu.fcm_accumulate_ref, False)
    bsweep = plain_in_rows(fu.fcm_accumulate_batched_ref, True)
    bacc = plain_in_rows(fu.fcm_accumulate_batched_ref, False)
    errs, times = {}, {}
    for n, d, c in CTILED_SHAPES:
        x, w, v = _inputs(n, d, c, n + d + c, device)
        phantom_w = w.clone()
        phantom_w[n // 2:] = 0.0
        on_centers = x[:c]
        cases = [("m=2", (x, w, v, 2.0), 0.0), ("m=1.2", (x, w, v, 1.2), 0.0),
                 ("phantom rows", (x, phantom_w, v, 2.0), 0.0),
                 ("records on centers", (x, w, on_centers, 1.2),
                  q_rounding_bound(x, w, on_centers))]
        for label, args, q_atol in cases:
            what = f"ctiled ({n}, {d}, {c}) {label}"
            errs[what] = max(
                hold_launch(fu.fcm_sweep_cuda, sweep, args,
                            (SWEEP_ATOL, SWEEP_ATOL, SWEEP_ATOL + q_atol),
                            "sweep " + what),
                hold_launch(fu.fcm_accumulate_cuda, acc, args,
                            (ACC_ATOL, ACC_ATOL, ACC_ATOL + q_atol),
                            "accumulate " + what))
        times[f"{n}x{d}x{c}"] = {
            "sweep_ms": time_loop_ms(lambda: fu.fcm_sweep_cuda(x, w, v, 2.0),
                                     10),
            "launch_ms": ctiled_launch_ms(
                fu.fcm_sweep_cuda, (x, w, v, 2.0), 10,
                fu._plan(device.index, n, d, c).dsplits > 1),
            "plain_ms": time_ms(lambda: sweep(x, w, v, 2.0), 3),
            "bound_ms": bound(n, d, c)[0]}
        del x, w, v, phantom_w
        torch.cuda.empty_cache()
    t, n, d, c = CTILED_TENANTS
    x, w, v, m_t = tenant_stack(t - 1, n, d, c, t + n + d + c, device,
                                phantoms=1)
    for label, m in (("per-tenant m", m_t), ("m=1.2", 1.2)):
        what = f"ctiled K3 {CTILED_TENANTS} {label}"
        for kern, plain, atol in ((fu.fcm_sweep_batched_cuda, bsweep,
                                   SWEEP_ATOL),
                                  (fu.fcm_accumulate_batched_cuda, bacc,
                                   ACC_ATOL)):
            errs[f"{kern.__name__} {what}"] = hold_launch(
                kern, plain, (x, w, v, m), atol, what)
            if any(bool(o[t - 1:].abs().any()) for o in kern(x, w, v, m)):
                raise AssertionError(f"{what}: phantom tenant not 0")
    times["K3 " + "x".join(map(str, CTILED_TENANTS))] = {
        "sweep_ms": time_loop_ms(
            lambda: fu.fcm_sweep_batched_cuda(x, w, v, m_t), 10),
        "launch_ms": ctiled_launch_ms(
            fu.fcm_sweep_batched_cuda, (x, w, v, m_t), 10,
            fu._batched_plan(device.index, t, n, d, c).dsplits > 1),
        "plain_ms": time_ms(lambda: bsweep(x, w, v, m_t), 3),
        "bound_ms": bound_batched(t, n, d, c)[0]}
    # The scratch cut: several tenant groups and row chunks per launch.
    old = fu.CTILED_SCRATCH_BYTES
    fu.CTILED_SCRATCH_BYTES = CTILED_CHUNKED_BUDGET
    fu._plan.cache_clear()
    fu._batched_plan.cache_clear()
    try:
        plan = fu._batched_plan(device.index, t, n, d, c)
        chunks = len(fu.ctiled_chunks(plan, t, n))
        for kern, plain, atol in ((fu.fcm_sweep_batched_cuda, bsweep,
                                   SWEEP_ATOL),
                                  (fu.fcm_accumulate_batched_cuda, bacc,
                                   ACC_ATOL)):
            errs[f"{kern.__name__} chunked"] = hold_launch(
                kern, plain, (x, w, v, m_t), atol,
                f"{kern.__name__} in {chunks} chunks")
        errs["fcm_sweep_cuda chunked"] = hold_launch(
            fu.fcm_sweep_cuda, sweep, (x[0], w[0], v[0], float(m_t[0])),
            SWEEP_ATOL, "fcm_sweep_cuda in chunks")
    finally:
        fu.CTILED_SCRATCH_BYTES = old
        fu._plan.cache_clear()
        fu._batched_plan.cache_clear()
    if chunks < 3 or plan.scratch > CTILED_CHUNKED_BUDGET:
        raise AssertionError(f"chunked case: {chunks} chunks, scratch "
                             f"{plan.scratch}")
    return {"phase": "ctiled_kernels", "max_abs_err": errs,
            "chunked": {"chunks": chunks, "group": plan.group,
                        "rows": plan.rows, "scratch": plan.scratch},
            "times": times, "bitwise_deterministic": True,
            "phantom_tenant_exact_zero": True}


# The wide kernel's checks (phase 2d): K1/K2 at the curriculum's shapes
# (d = 1536, C = 16: the full sweep, the driver's sample, WFCMPB's block,
# the 32- and 16-point merges), the other LM configs' d_model at C = 16
# (Whisper-medium 1024, OLMoE 2048, Gemma-7B 3072), and the plan's
# boundary checks (C = 128 at d = 100; d = 887: 4-byte copies, at C = 16
# and at C = 64, the last d of the domain, where the plan takes the
# C-tiled kernel and the wide one is held forced).
WIDE_SHAPES = tuple((n, 1536, 16) for n in (65_536, 32_604, 2048, 32, 16)) \
    + ((8192, 1024, 16), (8192, 2048, 16), (8192, 3072, 16),
       (4096, 100, 128), (3000, 887, 16), (3000, 887, 64))


def check_wide_kernels(device) -> dict:
    """Phase 2d: the wide kernel (csrc/fcm_accumulate.cu,
    fcm_wide_kernel) against its plain version (in row chunks) at
    test_kernels.py's tolerances, at WIDE_SHAPES: m = 1.2 and 2, half the
    rows zero-weight phantoms, and C records on the centers (q held to
    the expansion's rounding bound); every launch rerun bit for bit;
    records all of zero weight give exact zeros.  Where the plan takes
    the wide path, through the wrappers, counted on it; where it takes
    the C-tiled one (measured faster there), that path is held too and
    the wide kernel forced.  Each shape's kernel, plain and bound times
    are printed."""
    import torch
    from repro_torch.kernels import fcm_update as fu
    sweep = plain_in_rows(fu.fcm_accumulate_ref, True)
    acc = plain_in_rows(fu.fcm_accumulate_ref, False)
    errs, times = {}, {}
    for n, d, c in WIDE_SHAPES:
        path = fu._plan(device.index, n, d, c).path
        kerns = [(fu.fcm_sweep_cuda, fu.fcm_accumulate_cuda, path)]
        if path != "wide":
            kerns.append((functools.partial(fu.fcm_sweep_wide, normalize=True),
                          functools.partial(fu.fcm_sweep_wide,
                                            normalize=False), None))
        x, w, v = _inputs(n, d, c, n + d + c, device)
        half = w.clone()
        half[n // 2:] = 0.0
        on_centers = x[:c].clone()
        cases = [("m=1.2", (x, w, v, 1.2), 0.0), ("m=2", (x, w, v, 2.0), 0.0),
                 ("phantom rows", (x, half, v, 1.2), 0.0),
                 ("records on centers", (x, w, on_centers, 1.2),
                  q_rounding_bound(x, w, on_centers))]
        for k2, k1, on in kerns:
            for label, args, q_atol in cases:
                what = f"{on or 'forced wide'} ({n}, {d}, {c}) {label}"
                errs[what] = max(
                    hold_launch(k2, sweep, args,
                                (SWEEP_ATOL, SWEEP_ATOL, SWEEP_ATOL + q_atol),
                                "sweep " + what, on),
                    hold_launch(k1, acc, args,
                                (ACC_ATOL, ACC_ATOL, ACC_ATOL + q_atol),
                                "accumulate " + what, on))
            zero = torch.zeros_like(w)
            for kern in (k2, k1):
                if any(bool(o.abs().any()) for o in kern(x, zero, v, 1.2)):
                    raise AssertionError(
                        f"{on or 'forced wide'} ({n}, {d}, {c}): records of "
                        "zero weight do not give exact zeros")
        wide = fu.wide_plan(device, n, d, c)
        reps = 20 if n * d > 1 << 24 else 200
        k2 = kerns[-1][0]
        times[f"{n}x{d}x{c}"] = {
            "path": path,
            "wide_ms": time_loop_ms(lambda: k2(x, w, v, 1.2), reps),
            "sweep_ms": time_loop_ms(lambda: fu.fcm_sweep_cuda(x, w, v, 1.2),
                                     reps),
            "plain_ms": time_ms(lambda: sweep(x, w, v, 1.2), 3),
            "bound_ms": bound(n, d, c)[0], "rows": wide.rows,
            "dsplits": wide.dsplits, "grid": wide.grid}
        del x, w, v, half, on_centers, zero
        torch.cuda.empty_cache()
    return {"phase": "wide_kernels", "max_abs_err": errs, "times": times,
            "bitwise_deterministic": True, "zero_weight_exact_zero": True}


def tenant_cohort(run: TenantRun, seed: int):
    """``run``'s cohort, as benchmarks/t16_tenant.py makes it: tenant i
    holds U[lo, hi) records of N(0, 1) in d dims around 4.0·(i % 5); or,
    with a ``maker``, U[lo, hi) consecutive records of one array from it;
    and its per-tenant fuzzifiers (None: the config's scalar m)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    if run.maker:
        from repro_torch.data import synth
        sizes = rng.integers(*run.rows, size=run.tenants)
        x = getattr(synth, run.maker)(int(sizes.sum()), seed=seed)[0]
        data = np.split(x, np.cumsum(sizes)[:-1])
    else:
        data = [(rng.normal(size=(int(rng.integers(*run.rows)), run.d))
                 + 4.0 * (i % 5)).astype(np.float32)
                for i in range(run.tenants)]
    m_t = (rng.uniform(*run.m, size=run.tenants).astype(np.float32)
           if run.m else None)
    return data, m_t


def direct_d2(x, v):
    """‖x − v‖² (T, N, C) of x (T, N, d) and v (T, C, d) by the direct
    difference, summed one coordinate at a time: no (T, N, C, d) block
    and no expansion's cancellation.  (`torch.cdist`'s direct form gives
    the same to rounding, but the card runs it as one thread block per
    distance: 12.6 M blocks a sweep at tenants_65k's shape.)"""
    import torch
    d2 = torch.zeros(x.shape[:2] + v.shape[1:2], dtype=x.dtype,
                     device=x.device)
    for k in range(x.shape[2]):
        diff = x[:, :, None, k] - v[:, None, :, k]
        d2.addcmul_(diff, diff)
    return d2


def sweep64(X, W, V, m):
    """One tenant-stacked sweep in float64 with the direct ‖x − v‖²
    (`direct_d2`): (new centers, each tenant's Eq.-(2) objective at V,
    masses w_i)."""
    import torch
    x, mm = X.double(), m.double()[:, None, None]
    v = V.double()
    d2 = direct_d2(x, v).clamp_min(1e-12)
    lg = d2.log()
    r = torch.exp(-(lg - lg.min(-1, keepdim=True).values) / (mm - 1.0))
    wum = (r / r.sum(-1, keepdim=True)) ** mm * W.double()[..., None]
    w_i = wum.sum(1)
    v_new = (wum.transpose(1, 2) @ x) / w_i.clamp_min(1e-12)[..., None]
    return v_new, (wum * d2).sum((1, 2)), w_i


def exact_trajectory(X, W, V0, m, count_sets, chunk=8192):
    """The exact trajectory, run once for every array of sweep counts in
    ``count_sets`` (one run of sweeps to the largest count): for each
    array, each tenant's float64 centers after ``counts[t]`` sweeps from
    its seeds V0, and max_i ‖ΔV_i‖² of its sweeps number counts[t] and
    counts[t] − 1 → [[centers, last, prev] for each array]."""
    import torch
    out = [([], [], []) for _ in count_sets]
    for s in range(0, X.shape[0], chunk):
        sl = slice(s, s + chunk)
        v = V0[sl].double()
        cs = [torch.as_tensor(c[sl], device=X.device) for c in count_sets]
        zero = torch.zeros(v.shape[0], dtype=torch.float64, device=X.device)
        held = [[v.clone(), zero.clone(), zero.clone()] for _ in cs]
        for k in range(1, max(int(c.max()) for c in cs) + 1):
            v_new = sweep64(X[sl], W[sl], v, m[sl])[0]
            dv2 = ((v_new - v) ** 2).sum(-1).amax(-1)
            v = v_new
            for c, h in zip(cs, held):
                h[0] = torch.where((c == k)[:, None, None], v, h[0])
                h[1] = torch.where(c == k, dv2, h[1])
                h[2] = torch.where(c == k + 1, dv2, h[2])
        for o, h in zip(out, held):
            for part, a in zip(o, h):
                part.append(a)
    return [[torch.cat(part) for part in o] for o in out]


def exact_sweep(X, W, V, m, chunk=8192):
    """`sweep64` over all tenants, a chunk at a time."""
    import torch
    parts = [sweep64(X[s:s + chunk], W[s:s + chunk], V[s:s + chunk],
                     m[s:s + chunk]) for s in range(0, X.shape[0], chunk)]
    return [torch.cat(p) for p in zip(*parts)]


def objective64(X, W, V, m):
    """Each tenant's float64 objective at centers V."""
    return exact_sweep(X, W, V, m)[1]


def q_bound(X, W, V):
    """How far two f32 evaluations of a tenant's q through the d²
    expansion may part: each within 2·γ_{d+2}·Σ_k w_k (‖x_k‖² +
    max_i ‖v_i‖²) of the exact value."""
    gamma = (X.shape[2] + 2) * 2.0 ** -24
    x2 = (X.double() ** 2).sum(-1)
    v2 = (V.double() ** 2).sum(-1).max(-1).values[:, None]
    return 4 * gamma * (W.double() * (x2 + v2)).sum(1)


def exactness(fit, X, W, V0, m, exact=None):
    """How far fit's tenants lie from the exact trajectory at their own
    sweep counts: per tenant, the excess of |v − v_exact| over
    1e-4 + 1e-4·|v_exact| (≤ 0 passes, as `np.allclose` at rtol = atol
    = 1e-4, tests/test_tenant.py's center bar), the float64 objective's
    relative gap, and the exact trajectory's ΔV² at the fit's last two
    sweeps.  ``exact``: `exact_trajectory`'s entry for fit's counts,
    where a run shared with another fit's made it."""
    import numpy as np
    import torch
    t = fit.n_tenants
    X, W, V0, m = X[:t], W[:t], V0[:t], m[:t]
    if exact is None:
        exact = exact_trajectory(X, W, V0, m, [fit.n_iter])[0]
    exact, last, prev = exact
    v = torch.from_numpy(fit.centers).to(X.device).double()
    excess = ((v - exact).abs() - 1e-4 - 1e-4 * exact.abs()).amax((1, 2))
    ja, je = objective64(X, W, v, m), objective64(X, W, exact, m)
    rel = (ja - je).abs() / je.abs().clamp_min(1e-12)
    return (excess.cpu().numpy(), rel.cpu().numpy().astype(np.float64),
            last.cpu().numpy(), prev.cpu().numpy())


def hold_tenant_fits(a, b, X, W, V0, m, fixed, allowed_gap, obj_rtol,
                     what, held=True, exact=None) -> dict:
    """Fit ``a`` (through a kernel) against fit ``b`` (the plain ``torch``
    backend) and against the exact float64 trajectory, tenant by tenant.

    Held on the tenants ``fixed`` at f32 precision (`fixed_at_f32`):
    ``a`` lies on the exact trajectory at its own sweep count within
    tests/test_tenant.py's bars (centers 1e-4, float64 objective
    ``obj_rtol`` relative); its sweep count is within ``allowed_gap`` of
    ``b``'s; where the counts are equal, the f32 q each reports is within
    the expansion's rounding bound (`q_bound`) plus 1e-5 relative.  The
    direct comparison with ``b`` (centers, objective) is printed, not
    held: where the sweeps amplify rounding (few records, far from
    convergence) or ε is crossed slowly, two f32 fits part by more than
    those bars while both follow the exact trajectory (PERF.md, section 6).
    With ``held`` false the record is only returned (`hold_step_locked`
    holds such a run).  ``exact``: as `exactness` takes it, for ``a``."""
    import numpy as np
    import torch
    t = a.n_tenants
    fixed, allowed_gap = fixed[:t], allowed_gap[:t]
    exc, rel, _, _ = exactness(a, X, W, V0, m, exact)
    gap = np.abs(a.n_iter.astype(np.int64) - b.n_iter)
    same = (gap == 0) & fixed
    va, vb = (torch.from_numpy(s.centers).to(X.device) for s in (a, b))
    ja = objective64(X[:t], W[:t], va, m[:t])
    jb = objective64(X[:t], W[:t], vb, m[:t])
    rel_ab = ((ja - jb).abs() / jb.abs().clamp_min(1e-12)).cpu().numpy()
    qdiff = np.abs(a.objective.astype(np.float64) - b.objective)
    qlim = (1e-5 * np.abs(b.objective)
            + q_bound(X[:t], W[:t], vb).cpu().numpy())
    cab = np.abs(a.centers - b.centers).max(axis=(1, 2))
    rec = {"tenants": t, "fixed_at_f32": int(fixed.sum()),
           "n_iter_differ": int((gap > 0).sum()),
           "n_iter_differ_by_2_or_more": int((gap > 1).sum()),
           "max_n_iter_gap_fixed": int(gap[fixed].max(initial=0)),
           "max_n_iter_gap_not_fixed": int(gap[~fixed].max(initial=0)),
           "gap_over_allowed_fixed": int((gap > allowed_gap)[fixed].sum()),
           "off_exact_fixed": int(((exc > 0) | (rel > obj_rtol))[fixed].sum()),
           "vs_exact_center_excess_max_fixed": float(
               exc[fixed].max(initial=-1)),
           "vs_exact_obj64_rel_max_fixed": float(rel[fixed].max(initial=0)),
           "vs_exact_failing_not_fixed": int(
               ((exc > 0) | (rel > obj_rtol))[~fixed].sum()),
           "vs_b_center_err_max_equal_iters": float(
               cab[gap == 0].max(initial=0)),
           "vs_b_obj64_rel_max_equal_iters": float(
               rel_ab[gap == 0].max(initial=0)),
           "vs_b_obj64_rel_max": float(rel_ab.max()),
           "vs_b_q_rel_max": float((qdiff / np.abs(b.objective)).max()),
           "vs_b_q_over_bound_max_fixed_equal_iters": float(
               (qdiff / qlim)[same].max(initial=0))}
    if held and (2 * fixed.sum() < t or rec["gap_over_allowed_fixed"]
            or rec["vs_exact_center_excess_max_fixed"] > 0
            or rec["vs_exact_obj64_rel_max_fixed"] > obj_rtol
            or rec["vs_b_q_over_bound_max_fixed_equal_iters"] > 1):
        raise AssertionError(f"{what}: {rec}")
    return rec


def fixed_at_f32(ref, nudged, X, W, V0, m, obj_rtol, exact=None):
    """(fixed, allowed_gap) per tenant, from the plain ``torch`` backend's
    fit ``ref``.  A tenant is fixed at f32 precision where ``ref`` lies
    on the exact float64 trajectory within tests/test_tenant.py's bars
    (`exactness`) and its fits of the records scaled by 1 ± 2⁻²²
    (``nudged``) stop at the same sweep with centers within 1e-4.

    ``allowed_gap`` is how far another f32 fit's stop may lie from
    ``ref``'s: a rounding error of less than a factor 2 in ΔV² moves the
    crossing of ε by at most ⌈ln 2 / ln(1/ρ²)⌉ sweeps, where ρ² is the
    exact trajectory's ΔV² ratio over ``ref``'s last sweep (at least 1;
    unbounded where ΔV² does not fall there).  ``exact``: as
    `exactness` takes it, for ``ref``."""
    import numpy as np
    exc, rel, last, prev = exactness(ref, X, W, V0, m, exact)
    fixed = (exc <= 0) & (rel <= obj_rtol)
    for n in nudged:
        fixed &= n.n_iter == ref.n_iter
        fixed &= np.all(np.abs(n.centers - ref.centers)
                        <= 1e-4 + 1e-4 * np.abs(ref.centers), axis=(1, 2))
    with np.errstate(divide="ignore", invalid="ignore"):
        rho2 = np.where(prev > 0, last / prev, 0.0)
        allowed = np.where(rho2 < 1, np.ceil(np.log(2) / -np.log(rho2)),
                           np.inf)
    return fixed, np.maximum(allowed, 1)


# The step-locked hold's bars (`hold_step_locked`): three times
# tests/test_tenant.py's (centers 1e-4, objective 1e-5), as the CPU test's
# KDD99 case sets them, since one sweep at m = 1.2 moves a membership by
# 1/(m − 1) = 5 times the relative rounding of its d².
STEP_CENTER_TOL, STEP_OBJ_RTOL = 3e-4, 3e-5


def hold_step_locked(X, W, V0, m, counts, what) -> dict:
    """K3 held step by step along the plain ``torch`` backend's own
    trajectory, every tenant at each of its ``counts[t]`` sweeps (its
    torch fit's count): at each sweep K3 and the exact float64 sweep run
    from the torch backend's centers of the sweep before (the seeds V0 at
    the first).  A tenant's step is held where f32 fixes it, that is
    where the sweeps of the records scaled by 1 ± 2⁻²², through the torch
    backend (tests/test_torch_tenant.py's KDD99 case) and through K3,
    land within 1e-4 of the exact step (at least two thirds of all tenant
    steps): K3's centers that hold at least one record's weight in the
    exact step within STEP_CENTER_TOL of the exact step's (absolute and
    relative), the float64 objective at K3's centers no more than
    STEP_OBJ_RTOL above the objective at the exact step's, its f32 q
    within the expansion's rounding bound (`q_bound`) plus 1e-5 relative
    of the exact q.  A center holding less than one record's weight is
    placed by the tails of memberships, which records lying on other
    centers give it, and f32 rounds their d² to noise: two f32 sweeps
    move such a center by whole units while the objective moves by
    1e-5 (PERF.md, section 6), and the 1 ± 2⁻²² nudge, two draws of that
    noise, does not always see it.  Its error, and the torch backend's
    distance from the exact step, are printed.  Only the active tenants
    run at each sweep."""
    import numpy as np
    import torch
    from repro_torch.engine import get_backend
    from repro_torch.kernels.fcm_update import fcm_sweep_batched_cuda
    torch_be = get_backend("torch")
    t = len(counts)
    c_dev = torch.as_tensor(np.asarray(counts), device=X.device)
    v = V0[:t].clone()
    held = np.zeros(t, np.int64)
    rec = {"tenants": t, "tenant_steps": int(np.sum(counts)),
           "steps_held": 0, "min_step_share_held": 1.0,
           "center_err_max_held": 0.0, "obj64_excess_max_held": 0.0,
           "obj64_rel_max_held": 0.0, "q_over_bound_max_held": 0.0,
           "light_center_err_max_held": 0.0, "center_err_max_not_held": 0.0,
           "torch_center_err_max_held": 0.0}
    for k in range(1, int(c_dev.max()) + 1):
        idx = torch.nonzero(c_dev >= k).squeeze(1)
        x, w, va, ma = X[idx], W[idx], v[idx], m[idx]
        want = torch_be.batched_sweep(x, w, va, ma)
        got = fcm_sweep_batched_cuda(x, w, va, ma)
        v64, q64, w64 = exact_sweep(x, w, va, ma)
        tol = 1e-4 + 1e-4 * v64.abs()
        fixed = torch.ones(idx.numel(), dtype=torch.bool, device=X.device)
        for sign in (1, -1):
            xn = x * (1 + sign * 2.0 ** -22)
            for sweep in (torch_be.batched_sweep, fcm_sweep_batched_cuda):
                nudged = sweep(xn, w, va, ma)[0]
                fixed &= ((nudged - v64).abs() <= tol).all(-1).all(-1)
        per_c = ((got[0] - v64).abs() / (1 + v64.abs())).amax(-1)
        heavy = w64 >= 1.0
        cerr = torch.where(heavy, per_c, 0.0).amax(-1)
        lerr = torch.where(heavy, 0.0, per_c).amax(-1)
        terr = ((want[0] - v64).abs() / (1 + v64.abs())).amax((1, 2))
        jg = exact_sweep(x, w, got[0], ma)[1]
        je = exact_sweep(x, w, v64, ma)[1]
        jexc = (jg - je) / je.abs().clamp_min(1e-12)
        qr = (got[2].double() - q64).abs() / (1e-5 * q64.abs()
                                             + q_bound(x, w, va))
        n_fixed = int(fixed.sum())
        rec["steps_held"] += n_fixed
        rec["min_step_share_held"] = min(rec["min_step_share_held"],
                                         n_fixed / idx.numel())
        held[idx[fixed].cpu().numpy()] += 1
        for key, val in (("center_err_max_held", cerr[fixed]),
                         ("obj64_excess_max_held", jexc[fixed]),
                         ("obj64_rel_max_held", jexc[fixed].abs()),
                         ("q_over_bound_max_held", qr[fixed]),
                         ("light_center_err_max_held", lerr[fixed]),
                         ("center_err_max_not_held", cerr[~fixed]),
                         ("torch_center_err_max_held", terr[fixed])):
            rec[key] = max(rec[key], float(val.max()) if val.numel() else 0.0)
        if (rec["center_err_max_held"] > STEP_CENTER_TOL
                or rec["obj64_excess_max_held"] > STEP_OBJ_RTOL
                or rec["q_over_bound_max_held"] > 1):
            raise AssertionError(f"{what}, sweep {k}: {rec}")
        v[idx] = want[0]
        del x, w, va, ma, want, got, v64, q64, w64
    rec["tenants_never_held"] = int((held == 0).sum())
    if 3 * rec["steps_held"] < 2 * rec["tenant_steps"]:
        raise AssertionError(f"{what}: {rec}")
    return rec


def check_scorer(ts, run: TenantRun, seed: int, device) -> dict:
    """A burst of 4 rows per tenant through `TenantScorer` on the card,
    hard and soft, against the same scorer on the CPU: equal
    assignments (a differing row must be a tie within f32 rounding),
    soft memberships within rtol 1e-5."""
    import numpy as np
    import torch
    from repro_torch.serve import TenantScorer
    rng = np.random.default_rng(seed + 1)
    tidx = np.repeat(np.arange(ts.n_tenants), 4)
    x = (rng.normal(size=(tidx.size, run.d))
         + 4.0 * (tidx % 5)[:, None]).astype(np.float32)
    rec = {"rows": int(tidx.size)}
    for soft in (False, True):
        t0 = time.perf_counter()
        gpu = TenantScorer(ts, soft=soft, device=device).score(x, tidx)
        torch.cuda.synchronize(device)
        rec[f"{'soft' if soft else 'hard'}_s"] = time.perf_counter() - t0
        cpu = TenantScorer(ts, soft=soft, device="cpu").score(x, tidx)
        gpu = gpu.cpu()
        if soft:
            rec["soft_max_abs_err"] = max_err([gpu], [cpu], 1e-5, 0.0,
                                              f"soft scorer at {run.name}")
            continue
        bad = np.flatnonzero((gpu != cpu).numpy())
        d2 = ((x[bad, None, :] - ts.centers[tidx[bad]]) ** 2).sum(-1)
        rows = np.arange(bad.size)
        ga, ca = d2[rows, gpu.numpy()[bad]], d2[rows, cpu.numpy()[bad]]
        if np.any(np.abs(ga - ca) > 1e-6 * np.maximum(ga, ca)):
            raise AssertionError(f"hard scorer at {run.name}: {bad.size} "
                                 "rows differ beyond a tie")
        rec["hard_ties_differing"] = int(bad.size)
    return rec


def run_tenant_path(run: TenantRun, seed: int, device, reps: int):
    """Phase 4 for one cohort: `fit_tenants` on ``hopper`` with the K3 launch
    count zeroed just before it and read just after; the same fit on the
    ``torch`` backend, held tenant by tenant; the looped fit of 16
    tenants (``tenants_t16``); the scorer; and K3 against its plain
    version at the cohort's packed shape, timed.  Returns (phase record,
    kernel entry)."""
    import numpy as np
    import torch
    from repro_torch.device import synchronize
    from repro_torch.engine import get_backend
    from repro_torch.kernels.fcm_update import (fcm_sweep_batched_cuda,
                                                fcm_sweep_batched_ref,
                                                launch_plan, reset_counts)
    from repro_torch.tenant import (TenantFitConfig, fit_tenants,
                                    fit_tenants_looped, pack_tenants,
                                    seed_centers)
    from repro_torch.tenant.fit import _per_tenant_m

    t0 = time.perf_counter()
    data, m_t = tenant_cohort(run, seed)
    setup_s = time.perf_counter() - t0
    cfg = TenantFitConfig(n_clusters=run.c, m=run.m0, eps=run.eps,
                          max_iter=run.max_iter, seed=seed,
                          row_base=run.row_base, backend="hopper")
    backend = cfg.backend

    # -- the main path, with the K3 launch count zeroed just before it
    reset_counts()
    synchronize(device)
    t0 = time.perf_counter()
    ts = fit_tenants(data, cfg, m_t=m_t, device=device)
    synchronize(device)
    wall = time.perf_counter() - t0
    launches = fcm_sweep_batched_cuda.launches
    by_shape = shape_counts(fcm_sweep_batched_cuda)
    if launches == 0:
        raise AssertionError(f"K3 was not launched at {run.name}")
    check_paths(run.name, fcm_sweep_batched_cuda)
    if not (np.isfinite(ts.centers).all() and np.isfinite(ts.objective).all()
            and ts.centers.shape == (run.tenants, run.c, run.d)):
        raise AssertionError(f"{run.name}: non-finite or mis-shaped fit")

    # -- the host's share of the fit: packing and seeding alone
    t0 = time.perf_counter()
    X, W = pack_tenants(data, cfg)
    seeds = seed_centers(data, cfg)
    host_s = time.perf_counter() - t0
    V0 = np.zeros((X.shape[0], run.c, run.d), np.float32)
    V0[:run.tenants] = seeds
    m_all = _per_tenant_m(cfg, m_t, X.shape[0], run.tenants)
    X, W, V0, m_dev = (torch.from_numpy(a).to(device)
                       for a in (X, W, V0, m_all))
    record = {"phase": "tenant_path", "run": run.name,
              "tenants": run.tenants, "bucket": list(X.shape),
              "d": run.d, "c": run.c, "m": list(run.m) or run.m0,
              "eps": run.eps,
              "max_iter": run.max_iter, "backend": backend,
              "setup_s": setup_s, "wall_s": wall, "host_pack_seed_s": host_s,
              "batched_sweeps": launches, "launches_by_shape": by_shape,
              "real_row_share": float((W > 0).float().mean()),
              "n_iter_max": int(ts.n_iter.max()),
              "n_iter_mean": float(ts.n_iter.mean()),
              "at_max_iter": int((ts.n_iter == run.max_iter).sum())}

    # -- K3 against its plain version at the packed shape, at the seeds
    #    (the fit's first launch) and at the fitted centers (its last).
    #    v_new, and q to its rounding bound, are held at the sweep
    #    tolerances.  Off the origin the d² expansion that K3 shares with
    #    the TPU kernel and the torch backend rounds by up to
    #    2·γ_{d+2}·(‖x‖² + ‖v‖²), which moves the memberships of records
    #    near a center, and so w_i, by more than rtol 3e-4 (the blobs
    #    here sit up to 16 from the origin).  So every output is also held
    #    no farther from the exact float64 sweep than twice the torch
    #    backend's own distance from it on the same inputs.
    V = torch.zeros((X.shape[0], run.c, run.d), device=device)
    V[:run.tenants] = torch.from_numpy(ts.centers).to(device)
    torch_be = get_backend("torch")
    held = {}
    for label, centers in (("seeds", V0), ("fitted", V)):
        got = fcm_sweep_batched_cuda(X, W, centers, m_dev)
        if not all(torch.equal(a, b) for a, b in zip(
                got, fcm_sweep_batched_cuda(X, W, centers, m_dev))):
            raise AssertionError(f"two K3 launches differ at {run.name}")
        want = fcm_sweep_batched_ref(X, W, centers, m_dev)
        what = f"fcm_sweep_batched at {run.name}, {label} centers"
        held[label] = max_err(
            (got[0], got[2]), (want[0], want[2]), RTOL,
            (SWEEP_ATOL, SWEEP_ATOL + q_bound(X, W, centers).float()), what)
        held[label + "_w_i_vs_plain"] = float((got[1] - want[1]).abs().max())
        del want
        v64, q64, w64 = exact_sweep(X, W, centers, m_dev)
        tor = torch_be.batched_sweep(X, W, centers, m_dev)
        for name, k3, tb, ex in zip(("v_new", "w_i", "q"), got, tor,
                                    (v64, w64, q64)):
            ek = float((k3.double() - ex).abs().max())
            et = float((tb.double() - ex).abs().max())
            held[f"{label}_{name}_vs_exact"] = [ek, et]
            if ek > 2 * et + SWEEP_ATOL:
                raise AssertionError(f"{what}: {name} {ek:.3e} from the "
                                     f"exact sweep, torch backend {et:.3e}")
        del got, tor, v64, q64, w64
    record["k3_vs_plain"] = held

    # -- the same fit through the torch backend, same seeds, and with
    #    the records scaled by 1 ± 2⁻²² to find the tenants it fixes
    torch_cfg = dataclasses.replace(cfg, backend="torch")
    t0 = time.perf_counter()
    tor = fit_tenants(data, torch_cfg, m_t=m_t, device=device)
    synchronize(device)
    record["torch_wall_s"] = time.perf_counter() - t0
    # one float64 trajectory for both fits' sweep counts
    t = ts.n_tenants
    exact_tor, exact_ts = exact_trajectory(
        X[:t], W[:t], V0[:t], m_dev[:t], [tor.n_iter, ts.n_iter])
    fixed, allowed = fixed_at_f32(tor, [
        fit_tenants([x * np.float32(1 + sign * 2.0 ** -22) for x in data],
                    torch_cfg, m_t=m_t, device=device) for sign in (1, -1)],
        X, W, V0, m_dev, run.obj_rtol, exact_tor)
    record["vs_torch"] = hold_tenant_fits(
        ts, tor, X, W, V0, m_dev, fixed, allowed, run.obj_rtol,
        f"hopper vs torch at {run.name}", held=not run.step_locked,
        exact=exact_ts)
    del exact_tor, exact_ts
    if run.step_locked:
        record["step_locked"] = hold_step_locked(
            X, W, V0, m_dev, tor.n_iter, f"step-locked K3 at {run.name}")
    if run.name == "tenants_t16":
        looped = fit_tenants_looped(
            data[:16], cfg, m_t=None if m_t is None else m_t[:16],
            device=device)
        record["looped_vs_batched"] = hold_tenant_fits(
            looped, ts.select(ts.ids[:16]), X, W, V0, m_dev, fixed,
            allowed, run.obj_rtol, f"looped vs batched at {run.name}")
    if run.name == "tenants_65k":
        record["service"] = run_tenant_service(ts, tor, seed, device)
    del tor
    record["scorer"] = check_scorer(ts, run, seed, device)

    emit(record)
    err = max(held["seeds"], held["fitted"])
    tb, n, d = X.shape
    n_rep = reps if tb * n > 1 << 20 else 500
    ms = time_loop_ms(lambda: fcm_sweep_batched_cuda(X, W, V, m_dev), n_rep)
    per_call = time_ms(lambda: fcm_sweep_batched_cuda(X, W, V, m_dev), n_rep)
    plain_ms = time_ms(lambda: fcm_sweep_batched_ref(X, W, V, m_dev), 3)
    torch.cuda.empty_cache()
    b_ms, b_by = bound_batched(tb, n, d, run.c)
    return {"name": "fcm_sweep_batched", "run": run.name,
            "launches": launches, "max_abs_err": err, "ms": ms,
            "ms_per_call": per_call, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "shape": [tb, n, d, run.c],
            "real_row_share": record["real_row_share"],
            "path": launch_plan(device, n, d, run.c, tb).path}


# The store phase: 1,048,576-row chunks (117 MB at d = 28, 172 MB at
# d = 41, near Hadoop 2's 128 MB block), one batch per chunk; peak device
# memory of a store fit held to PEAK_BATCHES batches of x and w.
STORE_CHUNK_ROWS = 1 << 20
STORE_SHARDS = 4
PEAK_BATCHES = 4


def pinned_h2d_bytes_per_s(rows: int, cols: int, device, reps: int = 9):
    """Host→device rate of one plain pinned copy of a (rows, cols) f32
    batch: the median of ``reps`` copies, each between CUDA events."""
    import torch
    host = torch.ones((rows, cols), dtype=torch.float32).pin_memory()
    dev = torch.empty((rows, cols), dtype=torch.float32, device=device)
    times = []
    for _ in range(reps + 1):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        dev.copy_(host, non_blocking=True)
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / 1e3)
    return host.numel() * 4 / sorted(times[1:])[reps // 2]


def timed_store_pass(store, centers, m, device):
    """One out-of-core pass (`ooc_accumulate` through ``hopper_accumulate``)
    at ``centers``, through its own `StagingRing` with copy timing on:
    (accumulators, where the pass's time went)."""
    import torch
    from repro_torch.core import StagingRing, ooc_accumulate
    from repro_torch.data import batched
    ring = StagingRing(device, timing=True)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = ooc_accumulate(batched(store.iter_chunks(), store.chunk_rows),
                         centers, m, backend="hopper_accumulate", ring=ring,
                         device=device)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    return out, {"wall_s": wall, "batches": ring.batches,
                 "host_batch_iter_s": ring.iter_s,
                 "host_read_stage_s": ring.host_s, "slot_wait_s": ring.wait_s,
                 "h2d_s": ring.h2d_seconds(), "h2d_bytes": ring.h2d_bytes}


def fit_iters(fit) -> tuple:
    """(combiner sweeps summed over shards, reducer sweeps) of a fit."""
    return (sum(fit.diagnostics.combiner_iters), fit.diagnostics.reducer_iters)


def hold_fit(a, b, scale, what) -> dict:
    """The main path's bars for two fits, each (centers, global q, sweep
    counts): centers within 1e-3 of the data's RMS, q within 1e-4
    relative, combiner and reducer sweep counts within ±2 (summation
    order differs, and ε bounds only ΔV²)."""
    (va, qa, ia), (vb, qb, ib) = a, b
    rec = {"center_err_rel_rms": float((va.cpu() - vb.cpu()).abs().max())
           / scale, "q_rel": abs(qa - qb) / abs(qb), "iters": [ia, ib]}
    if rec["center_err_rel_rms"] > 1e-3 or rec["q_rel"] > 1e-4 or any(
            abs(u - v) > 2 for u, v in zip(ia, ib)):
        raise AssertionError(f"{what}: {rec}")
    return rec


def run_store_path(run: Run, held: dict, store_dir: Path, device) -> dict:
    """Phase 5 for one dataset: the array the main path fit, ingested into
    an on-disk `ChunkStore` under ``store_dir``; `bigfcm_fit_store` on
    backend ``hopper`` with launch counts zeroed just before it and read just
    after, and its peak device memory; the store fits from the main
    path's injected draws through ``hopper`` and ``torch``, held against
    the in-memory fit and each other; where a pass's time goes; one pass
    against one K1 launch over the whole array; K1 at the batch shape
    (and the padded tail batch) against its plain version, timed; and at
    ``kdd99_like`` `store_extras`.  Returns K1's kernel entry at the
    batch shape."""
    import numpy as np
    import torch
    from repro_torch.core import bigfcm_fit_store
    from repro_torch.data import ChunkStore, batched
    from repro_torch.engine import get_backend
    from repro_torch.kernels.fcm_update import (fcm_accumulate_cuda,
                                                fcm_accumulate_ref,
                                                fcm_sweep_cuda, launch_plan,
                                                reset_counts)

    from repro_torch import obs
    x_np, cfg = held["x"], held["cfg"]
    n, d = x_np.shape
    rows = STORE_CHUNK_ROWS
    batch_bytes = 4 * rows * (d + 1)
    free = shutil.disk_usage(store_dir).free
    if free < x_np.nbytes + (256 << 20):
        raise AssertionError(f"{run.name}: {free} bytes free under "
                             f"{store_dir}, the store needs {x_np.nbytes}")
    t0 = time.perf_counter()
    store = ChunkStore.ingest(x_np, chunk_rows=rows,
                              cache_dir=str(store_dir / run.name))
    setup_s = time.perf_counter() - t0
    per_pass = -(-n // rows)
    if store.n_rows != n or store.n_chunks != per_pass:
        raise AssertionError(f"{run.name}: store {store!r}")

    # -- the store path, the main path's config, launch counts (and the
    #    obs registry) zeroed just before it and peak device memory
    #    measured over it
    obs.reset_all()
    reset_counts()
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    res = bigfcm_fit_store(store, cfg, device=device)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    launches = {"fcm_sweep": fcm_sweep_cuda.launches,
                "fcm_accumulate": fcm_accumulate_cuda.launches}
    if min(launches.values()) == 0:
        raise AssertionError(f"store path {run.name}: a kernel was not "
                             f"launched: {launches}")
    check_paths(run.name, fcm_sweep_cuda, fcm_accumulate_cuda)
    k1_batch = fcm_accumulate_cuda.shapes[EXPECTED_PATH[run.name], rows,
                                          run.c]
    if k1_batch == 0 or k1_batch % per_pass:
        raise AssertionError(f"store path {run.name}: {k1_batch} K1 launches "
                             f"at {rows} rows, {per_pass} batches a pass")
    if res.centers.shape != (run.c, d) or not bool(
            torch.isfinite(res.centers).all()):
        raise AssertionError(f"store path {run.name}: bad centers")
    if peak > PEAK_BATCHES * batch_bytes:
        raise AssertionError(f"store path {run.name}: peak device memory "
                             f"{peak} B > {PEAK_BATCHES} batches "
                             f"({PEAK_BATCHES * batch_bytes} B)")
    diag = res.diagnostics
    record = {"phase": "store_path", "run": run.name, "n": n, "d": d,
              "c": run.c, "m": run.m, "chunk_rows": rows,
              "chunks": store.n_chunks, "batches_per_pass": per_pass,
              "store_bytes": store.nbytes, "setup_s": setup_s,
              "wall_s": wall, "flag": diag.flag,
              "passes": k1_batch // per_pass,
              "combiner_iters": list(diag.combiner_iters),
              "reducer_iters": diag.reducer_iters, "launches": launches,
              "launches_by_shape": {
                  "fcm_sweep": shape_counts(fcm_sweep_cuda),
                  "fcm_accumulate": shape_counts(fcm_accumulate_cuda)},
              "peak_device_bytes": peak, "batch_bytes": batch_bytes,
              "peak_bound_bytes": PEAK_BATCHES * batch_bytes}
    if run.name == "kdd99_like":
        record["obs"] = store_obs(store, cfg, k1_batch // per_pass, per_pass)

    # -- the store fit from the main path's injected draws, through
    #    hopper and torch
    inject = dataclasses.replace(cfg, use_driver=False)
    fits = {name: bigfcm_fit_store(
                store, dataclasses.replace(inject, backend=name),
                sample_idx=held["sample_idx"], seed_idx=held["seed_idx"],
                device=device) for name in ("hopper", "torch")}

    # -- where a pass's time goes: two passes at the fitted centers (the
    #    second timed), a pinned copy's rate, K1 at the batch shape
    one, _ = timed_store_pass(store, res.centers, run.m, device)
    again, split = timed_store_pass(store, res.centers, run.m, device)
    if not all(torch.equal(a, b) for a, b in zip(one, again)):
        raise AssertionError(f"{run.name}: two store passes differ")
    rate = pinned_h2d_bytes_per_s(rows, d + 1, device)
    xb = torch.from_numpy(np.array(store.chunk(0))).to(device)
    wb = torch.ones((rows,), dtype=torch.float32, device=device)
    for tail in batched(store.iter_chunks(), rows):
        pass
    tx, tw = (torch.from_numpy(np.array(a)).to(device) for a in tail)
    k1_ms = time_loop_ms(lambda: fcm_accumulate_cuda(xb, wb, res.centers,
                                                     run.m), 20)
    split.update({"pinned_h2d_bytes_per_s": rate,
                  "h2d_bound_s": split["h2d_bytes"] / rate,
                  "k1_card_s": k1_ms * per_pass / 1e3})
    record["per_pass"] = split

    # -- the gates that need the whole array on the card
    xd = torch.from_numpy(x_np).to(device)
    ones = torch.ones((n,), dtype=torch.float32, device=device)
    scale = float(torch.sqrt(torch.mean(xd * xd)))
    acc = get_backend("hopper_accumulate").accumulate
    qs = {k: float(acc(xd, ones, f.centers, run.m)[2])
          for k, f in fits.items()}
    ours = {k: (f.centers, qs[k], fit_iters(f)) for k, f in fits.items()}
    record["vs_memory"] = hold_fit(
        ours["hopper"], (held["centers"]["hopper"], held["q"]["hopper"],
                         held["iters"]["hopper"]), scale,
        f"store vs in-memory fit at {run.name}")
    record["vs_torch"] = hold_fit(ours["hopper"], ours["torch"], scale,
                                  f"store fit hopper vs torch at {run.name}")
    # what the fleet phase holds its objective against
    held["store_q"], held["scale"] = qs["hopper"], scale
    # One pass sums 11 or 5 launches' accumulators where one launch sums
    # its CTAs' partials: f32 summation order, 1e-5 of each output's scale
    # (v_num's: max w_i times the data's RMS).
    whole = fcm_accumulate_cuda(xd, ones, res.centers, run.m)
    w_max = float(whole[1].max())
    record["pass_vs_one_launch"] = max_err(
        one, whole, 1e-5, (1e-5 * w_max * scale, 1e-5 * w_max, 0.0),
        f"one store pass vs one K1 launch at {run.name}")
    err = 0.0
    for label, (bx, bw) in (("batch", (xb, wb)), ("tail", (tx, tw))):
        err = max(err, max_err(
            fcm_accumulate_cuda(bx, bw, res.centers, run.m),
            fcm_accumulate_ref(bx, bw, res.centers, run.m), RTOL, ACC_ATOL,
            f"K1 at the {label} batch of {run.name}"))
    plain_ms = time_ms(lambda: fcm_accumulate_ref(xb, wb, res.centers,
                                                  run.m), 3)
    per_call = time_ms(lambda: fcm_accumulate_cuda(xb, wb, res.centers,
                                                   run.m), 20)
    del tx, tw, whole
    if run.name == "kdd99_like":
        record.update(store_extras(run, store, x_np, xd, held, qs["hopper"],
                                   fits["hopper"].centers, scale, device))
    emit(record)
    b_ms, b_by = bound(rows, d, run.c)
    return {"name": "fcm_accumulate", "run": f"{run.name}/store_batch",
            "launches": k1_batch, "max_abs_err": err, "ms": k1_ms,
            "ms_per_call": per_call, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "shape": [rows, d, run.c],
            "path": launch_plan(device, rows, d, run.c).path}


def store_obs(store, cfg, passes, per_pass) -> dict:
    """The obs record of one store fit (the registry reset just before
    it): its phase breakdown and counters, ``data.cache.chunk_reads``
    held to what the fit reads — the chunks the driver's sample touches
    (`ChunkStore.take`) and each pass's batches."""
    import numpy as np
    from repro_torch import obs
    from repro_torch.core.bigfcm import _draws
    _, sample_idx, _ = _draws(cfg, store.n_rows, None, None)
    sample_chunks = np.unique(np.searchsorted(
        store.offsets, sample_idx, side="right") - 1).size
    counters = obs.metrics_snapshot()["counters"]
    want = sample_chunks + passes * per_pass
    if counters.get("data.cache.chunk_reads") != want:
        raise AssertionError(f"store fit: {counters} for {sample_chunks} "
                             f"sample chunks + {passes} passes x "
                             f"{per_pass} batches")
    return {"phase_breakdown": obs.phase_breakdown(), "counters": counters,
            "sample_chunk_reads": int(sample_chunks), "passes": passes,
            "batches_per_pass": per_pass}


def soft_exact_gap(u, x, v, m, chunk=1 << 18) -> float:
    """max |u − u_exact|: ``u`` (N, C) memberships of ``x`` against ``v``,
    the exact ones in float64 with the direct ‖x − v‖², a chunk of rows
    at a time."""
    import torch
    worst = 0.0
    v64 = v.double()
    for s in range(0, x.shape[0], chunk):
        d2 = ((x[s:s + chunk, None, :].double() - v64[None]) ** 2).sum(-1)
        lg = d2.clamp_min(1e-12).log()
        r = torch.exp(-(lg - lg.min(-1, keepdim=True).values) / (m - 1.0))
        exact = r / r.sum(-1, keepdim=True)
        worst = max(worst, float((u[s:s + chunk].to(x.device).double()
                                  - exact).abs().max()))
    return worst


def hold_wfcmpb_store(run: Run, store, centers, cfg, scale, device) -> dict:
    """`wfcmpb_store` over shard 0 of a 4-shard plan (its chunks are the
    blocks), from ``centers``.  Through ``hopper`` it must equal the
    in-memory `wfcmpb` of the same rows with one block per chunk (the same
    blocks, the tail padded alike: equal sweeps, centers within 1e-6 of
    the data's RMS, q within 1e-5).  Against the ``torch`` backend it is
    held to the main path's bars only where the ``torch`` progression is
    fixed by its data at f32 precision — its centers move by at most 1e-4
    of the RMS when the records are scaled by 1 + 2⁻²² (`check_driver`'s
    rule); otherwise the gap is printed, not held."""
    import numpy as np
    import torch
    from repro_torch.core import wfcmpb, wfcmpb_batches, wfcmpb_store
    from repro_torch.data import plan_partitions, shard_batches
    rows = store.chunk_rows
    plan = plan_partitions(store, STORE_SHARDS)
    kw = dict(m=run.m, eps=cfg.combiner_eps, max_iter=cfg.max_iter,
              device=device)
    fits = {name: wfcmpb_store(store, centers, backend=name, plan=plan,
                               shard=0, **kw) for name in ("hopper", "torch")}
    nudge = float(1 + 2.0 ** -22)
    fits["torch_nudged"] = wfcmpb_batches(
        lambda: ((bx * nudge, bw)
                 for bx, bw in shard_batches(store, plan, 0, rows)),
        centers, backend="torch", **kw)
    x0 = torch.cat([torch.from_numpy(np.array(store.chunk(i))).to(device)
                    for i in plan.chunks_of(0)])
    mem = wfcmpb(x0, centers, block_size=rows, backend="hopper", **kw)
    del x0

    def gap(a, b):
        return float((a.centers - b.centers).abs().max()) / scale

    def q_rel(a, b):
        return abs(float(a.objective) - float(b.objective)) / abs(
            float(b.objective))

    hop, tor = fits["hopper"], fits["torch"]
    blocks = len(plan.chunks_of(0))
    rec = {"blocks": blocks,
           "vs_memory": {"center_err_rel_rms": gap(hop, mem),
                         "q_rel": q_rel(hop, mem),
                         "iters": [hop.n_iter, mem.n_iter]},
           "vs_torch": {"center_err_rel_rms": gap(hop, tor),
                        "q_rel": q_rel(hop, tor),
                        "iters": [hop.n_iter, tor.n_iter],
                        "torch_nudged_rel_rms": gap(fits["torch_nudged"],
                                                    tor)}}
    rec["vs_torch"]["held"] = rec["vs_torch"]["torch_nudged_rel_rms"] <= 1e-4
    vm, vt = rec["vs_memory"], rec["vs_torch"]
    if (hop.n_iter != mem.n_iter or vm["center_err_rel_rms"] > 1e-6
            or vm["q_rel"] > 1e-5 or not bool(torch.isfinite(
                hop.centers).all())):
        raise AssertionError(f"wfcmpb_store vs in-memory wfcmpb: {rec}")
    if vt["held"] and (vt["center_err_rel_rms"] > 1e-3 or vt["q_rel"] > 1e-4
                       or abs(hop.n_iter - tor.n_iter) > 2 * blocks):
        raise AssertionError(f"wfcmpb_store hopper vs torch: {rec}")
    return rec


def store_extras(run: Run, store, x_np, xd, held, q_one, centers, scale,
                 device) -> dict:
    """``kdd99_like`` only: the multi-shard store fit (global q within
    tests/test_plane.py's 5 % of the one-shard fit's ``q_one``, its
    returned objective the global one), `hold_wfcmpb_store`, the MR-FKM
    baseline over the store against the in-memory
    baseline from the same seeds (equal jobs, both converged, centers
    within 1e-4 of the data's RMS), and `assign_store` against scoring
    the whole array at once (hard labels equal but for ties within f32
    rounding; soft memberships no farther from the exact float64 ones
    than twice the whole-array scoring's distance, plus 1e-6)."""
    import numpy as np
    import torch
    from repro_torch.baselines import mr_fuzzy_kmeans, mr_fuzzy_kmeans_store
    from repro_torch.core import bigfcm_fit_store
    from repro_torch.engine import get_backend
    from repro_torch.serve import assign_store, make_assigner
    cfg = dataclasses.replace(held["cfg"], use_driver=False)
    ones = torch.ones((xd.shape[0],), dtype=torch.float32, device=device)
    out = {}

    t0 = time.perf_counter()
    multi = bigfcm_fit_store(store, cfg, n_shards=STORE_SHARDS,
                             sample_idx=held["sample_idx"],
                             seed_idx=held["seed_idx"], device=device)
    wall = time.perf_counter() - t0
    q = float(get_backend("hopper_accumulate").accumulate(
        xd, ones, multi.centers, run.m)[2])
    rec = out["multi_shard"] = {
        "shards": STORE_SHARDS, "wall_s": wall,
        "combiner_iters": list(multi.diagnostics.combiner_iters),
        "reducer_iters": multi.diagnostics.reducer_iters, "q": q,
        "objective": float(multi.objective),
        "q_rel_vs_one_shard": abs(q - q_one) / q_one}
    if rec["q_rel_vs_one_shard"] > 0.05 or abs(rec["objective"] - q) > \
            1e-4 * q:
        raise AssertionError(f"multi-shard store fit: {rec}")

    out["wfcmpb_store_shard0"] = hold_wfcmpb_store(run, store, centers,
                                                   cfg, scale, device)

    v0 = x_np[held["sample_idx"][held["seed_idx"]]]
    kw = dict(m=run.m, eps=run.eps, max_iter=cfg.max_iter, backend="hopper",
              device=device)
    ooc, jobs_ooc, t_ooc = mr_fuzzy_kmeans_store(store, v0, **kw)
    mem, jobs_mem, t_mem = mr_fuzzy_kmeans(xd, v0, **kw)
    rec = out["mr_fkm"] = {
        "jobs": [jobs_ooc, jobs_mem], "elapsed_s": [t_ooc, t_mem],
        "center_err_rel_rms": float((ooc.centers - mem.centers).abs().max())
        / scale}
    if jobs_ooc != jobs_mem or jobs_ooc >= cfg.max_iter or \
            rec["center_err_rel_rms"] > 1e-4:
        raise AssertionError(f"mr_fuzzy_kmeans_store vs in memory: {rec}")

    rec = out["assign_store"] = {}
    for soft in (False, True):
        t0 = time.perf_counter()
        got = torch.from_numpy(np.concatenate(list(assign_store(
            store, centers, m=run.m, soft=soft, backend="hopper",
            device=device))))
        rec["soft_s" if soft else "hard_s"] = time.perf_counter() - t0
        want = make_assigner(centers, m=run.m, soft=soft, backend="hopper",
                             device=device)(xd).cpu()
        if soft:
            # Chunk and whole-array GEMMs round the d² expansion's cross
            # term apart (its f32 cancellation; the data lie far from the
            # origin), so both are held to the exact memberships.
            rec["soft_max_abs_err"] = float((got - want).abs().max())
            rec["soft_vs_exact"] = [soft_exact_gap(got, xd, centers, run.m),
                                    soft_exact_gap(want, xd, centers, run.m)]
            if rec["soft_vs_exact"][0] > 2 * rec["soft_vs_exact"][1] + 1e-6:
                raise AssertionError(f"soft assign_store: {rec}")
            continue
        rec["hard_ties_differing"] = label_ties(got.numpy(), want.numpy(),
                                                xd, centers)
    return out


# The fleet phase: benchmarks/t15_fleet.py's protocol (H simulated hosts,
# each fitting its shards of one on-disk store, exchanging summary frames
# and merging them identically, no reducer) at the HIGGS-like store of the
# store phase, on the main path's config (C = 2, m = 2, hopper).
FLEET_RUN = "higgs_like"
FLEET_HOSTS, FLEET_SHARDS = 4, 2        # hosts x shards per host: 8 shards
# per-shard pin budget: two 1,048,576 x 28 chunks, so every shard's chunks
# load on the prefetch thread while the previous shard fits
FLEET_PREFETCH_BYTES = 2 * STORE_CHUNK_ROWS * 28 * 4
FLEET_STRAGGLER_FACTOR = 2.0            # tests/test_fleet.py's straggler
FLEET_DELAY_S = 4000.0                  # a delayed host outsleeps the script


def fleet_frames(transport, live) -> dict:
    """The summary frames the ``live`` hosts posted at epoch 0."""
    return transport.gather(0, live[0], live, "sum", 1.0)


def fleet_shard_seconds() -> dict:
    """Each host's per-shard fit seconds, from the ring's
    ``fleet.shard_fit`` spans: {host: {shard: seconds}}."""
    from repro_torch import obs
    out = {}
    for ev in obs.ring_events():
        if ev.get("kind") == "span" and ev["name"] == "fleet.shard_fit":
            out.setdefault(str(ev["host"]), {})[str(ev["shard"])] = \
                ev["dur_s"]
    return out


def fleet_p50_ms() -> dict:
    """p50 (ms) of the fleet's spans, from the ring's events."""
    from repro_torch import obs
    return {r["phase"]: r["p50_ms"]
            for r in obs.phase_breakdown(obs.ring_events())
            if r["phase"] in ("fleet.local_fit", "fleet.exchange",
                              "fleet.objective", "fleet.shard_fit")}


def hold_fleet_result(res, live, epoch, n, what) -> None:
    import numpy as np
    if res.live != live or res.epoch != epoch or res.n_rows != n or not (
            np.isfinite(res.centers).all() and math.isfinite(res.objective)):
        raise AssertionError(f"{what}: live {res.live}, epoch {res.epoch}, "
                             f"rows {res.n_rows}, objective {res.objective}")


def rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def sweep_expansion_atol(x, w, v, m) -> tuple:
    """`expansion_atol` carried through K2's normalization v_new = v_num /
    w_i: |v_num/w − (v_num + a)/(w + b)| ≤ (a + |v_num/w|·b) / (w − b)."""
    from repro_torch.kernels.fcm_update import fcm_accumulate_ref
    t_vn, t_w, t_q = expansion_atol(x, w, v, m)
    vn, wi, _ = fcm_accumulate_ref(x, w, v, m)
    v_new = vn / wi.clamp_min(1e-12)[:, None]
    lo = (wi - t_w).clamp_min(1e-12)[:, None]
    return (t_vn + v_new.abs() * t_w[:, None]) / lo, t_w, t_q


def run_fleet_path(run: Run, held: dict, kdd: dict, store_dir: Path,
                   entries: list, device) -> list:
    """The fleet phase over ``run``'s store (phase 5's, still on disk):

    (a) `fleet_fit`, FLEET_HOSTS threads x FLEET_SHARDS shards on the
        card, f32 wire, launch counts and the obs registry zeroed just
        before it: no host lost, K1 launches at the batch shape equal to
        the obs plane's ``engine.sweep`` spans, K2 launches at the merge
        shape equal to the hosts' pairwise merge recomputed over the
        gathered frames, every launch on the plan's path; held against
        the same fleet on the ``torch`` backend (centers 1e-3 of the RMS,
        q 1e-4) and against the 1-shard store fit's global q (1e-5);
    (b) the same fleet with the bf16 wire: every frame element within
        ``BF16_REL_BOUND`` of (a)'s, the objective within 1e-3 of (a)'s;
    (c) a straggler: 3 hosts x 2 shards, host 1 delayed, evicted and its
        shards replanned onto the survivors;
    (d) kill one host: `spawn_fleet` with 3 processes on the card over
        the store's directory, host 1 stopped once hosts 0 and 2 have
        posted their epoch-0 summaries; the survivors agree bit for bit
        with each other and with a threaded fleet born at 2 hosts;
    (e) `mr_kmeans` on the KDD99-like array from its main path's seeds.

    Seeds are `driver_seeds` at the main path's injected draws.  Returns
    the kernel entries of shapes no earlier entry has; the fleet's
    launches at an earlier entry's shape are added to that entry."""
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.baselines import mr_kmeans
    from repro_torch.core import driver_seeds
    from repro_torch.data import ChunkStore, plan_partitions, replan
    from repro_torch.engine import (MergePlan, Summary, concat,
                                    merge_summaries)
    from repro_torch.fleet import (BF16_REL_BOUND, FleetConfig,
                                   MailboxTransport, collect_results,
                                   decode_summary, fleet_fit, spawn_fleet,
                                   watch_fleet)
    from repro_torch.fleet.proc import MAIL_DIR
    from repro_torch.kernels.fcm_update import (fcm_accumulate_cuda,
                                                fcm_sweep_cuda, reset_counts)

    cfg = held["cfg"]
    store_path = store_dir / run.name
    store = ChunkStore.open(str(store_path))
    n, d, rows = store.n_rows, store.dim, store.chunk_rows
    path = EXPECTED_PATH[run.name]
    v_init = driver_seeds(store, cfg, sample_idx=held["sample_idx"],
                          seed_idx=held["seed_idx"], device=device)
    # The main path drew from default_rng(seed) as `driver_seeds` does, so
    # a host given only the config (a spawned one) derives these seeds.
    if not np.array_equal(driver_seeds(store, cfg, device=device), v_init):
        raise AssertionError("fleet: default seeds differ from the main "
                             "path's injected draws")
    fleet = FleetConfig(n_hosts=FLEET_HOSTS, shards_per_host=FLEET_SHARDS,
                        prefetch_bytes=FLEET_PREFETCH_BYTES)
    rec = {"phase": "fleet", "run": run.name, "n": n, "d": d, "c": run.c,
           "m": run.m, "chunks": store.n_chunks, "chunk_rows": rows,
           "backend": cfg.backend, "reduced": []}

    # -- (a): the main path of this phase, counts and obs zeroed before it
    obs.reset_all()
    obs.set_ring_size(1 << 16)
    reset_counts()
    tr = MailboxTransport()
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    res = fleet_fit(store, cfg, fleet, transport=tr, v_init=v_init,
                    device=device)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    k1 = dict(fcm_accumulate_cuda.shapes)
    k2 = dict(fcm_sweep_cuda.shapes)
    by_shape = {"fcm_sweep": k2, "fcm_accumulate": k1}
    sweeps = obs.metrics_snapshot()["histograms"]["span.engine.sweep"][
        "count"]
    counters = obs.metrics_snapshot()["counters"]
    shard_s, p50 = fleet_shard_seconds(), fleet_p50_ms()
    obs.reset_all()
    obs.set_ring_size(obs.trace._ring_size())
    hold_fleet_result(res, tuple(range(FLEET_HOSTS)), 0, n, "fleet (a)")
    check_paths(run.name, fcm_sweep_cuda, fcm_accumulate_cuda)
    batch_key = (path, rows, run.c)
    if set(k1) != {batch_key} or k1[batch_key] != sweeps:
        raise AssertionError(f"fleet (a): K1 launches {k1}, {sweeps} "
                             "engine.sweep spans")
    frames = fleet_frames(tr, res.live)
    gathered = concat([decode_summary(frames[h])[0] for h in sorted(frames)])
    gathered = Summary(gathered.centers.to(device),
                       gathered.masses.to(device))
    with uncounted():
        again = merge_summaries(gathered, MergePlan(
            "pairwise", m=cfg.m, eps=cfg.reducer_eps,
            max_iter=cfg.max_iter), backend=cfg.backend)
    if not np.array_equal(again.summary.centers.cpu().numpy(), res.centers):
        raise AssertionError("fleet (a): the merge recomputed over the "
                             "gathered frames differs from the fleet's")
    merge_key = (path, 2 * run.c, run.c)
    slots = gathered.centers.shape[0]
    want_k2 = FLEET_HOSTS * (again.n_iter + slots - 1)
    if set(k2) != {merge_key} or k2[merge_key] != want_k2:
        raise AssertionError(f"fleet (a): K2 launches {k2}, expected "
                             f"{want_k2} at {merge_key}")
    rec["a_threads"] = {"hosts": FLEET_HOSTS, "shards_per_host": FLEET_SHARDS,
                "wall_s": wall, "objective": res.objective,
                "shard_seconds": shard_s, "p50_ms": p50,
                "merge_sweeps_per_host": again.n_iter + slots - 1,
                "exchange_bytes": sum(map(len, frames.values())),
                "obs_exchange_bytes": counters.get(
                    "fleet.exchange.bytes{wire=f32}"),
                "prefetch_bytes": counters.get("fleet.prefetch.bytes", 0),
                "peak_device_bytes": peak,
                "launches": {"fcm_sweep": fcm_sweep_cuda.launches,
                             "fcm_accumulate": fcm_accumulate_cuda.launches},
                "launches_by_shape": {
                    "fcm_sweep": shape_counts(fcm_sweep_cuda),
                    "fcm_accumulate": shape_counts(fcm_accumulate_cuda)}}
    if not rec["a_threads"]["prefetch_bytes"]:
        raise AssertionError("fleet (a): no shard was prefetched")

    # the same fleet on the torch backend, and the 1-shard store fit
    twin = fleet_fit(store, dataclasses.replace(cfg, backend="torch"), fleet,
                     v_init=v_init, device=device)
    hold_fleet_result(twin, res.live, 0, n, "fleet (a) on torch")
    rec["a_threads"]["vs_torch"] = {
        "center_err_rel_rms": float(np.abs(res.centers - twin.centers).max())
        / held["scale"], "q_rel": rel(res.objective, twin.objective)}
    rec["a_threads"]["vs_store_fit"] = {"store_q": held["store_q"],
                                "q_rel": rel(res.objective, held["store_q"])}
    if rec["a_threads"]["vs_torch"]["center_err_rel_rms"] > 1e-3 or \
            rec["a_threads"]["vs_torch"]["q_rel"] > 1e-4 or \
            rec["a_threads"]["vs_store_fit"]["q_rel"] > 1e-5:
        raise AssertionError(f"fleet (a): {rec['a_threads']}")

    # -- (b): the bf16 wire
    tr_b = MailboxTransport()
    t0 = time.perf_counter()
    res_b = fleet_fit(store, cfg, dataclasses.replace(fleet, wire="bf16"),
                      transport=tr_b, v_init=v_init, device=device)
    wall_b = time.perf_counter() - t0
    hold_fleet_result(res_b, res.live, 0, n, "fleet (b)")
    frames_b = fleet_frames(tr_b, res_b.live)
    worst = 0.0
    for h in sorted(frames):
        exact, _ = decode_summary(frames[h])
        quant, _ = decode_summary(frames_b[h])
        for e, q in zip(exact, quant):
            gap = (q - e).abs()
            if bool((gap > BF16_REL_BOUND * e.abs()).any()):
                raise AssertionError(f"fleet (b): host {h}'s bf16 frame "
                                     "is off its f32 frame past the bound")
            worst = max(worst, float((gap / e.abs().clamp_min(1e-30))
                                     .max()))
    rec["b_bf16"] = {"wall_s": wall_b, "objective": res_b.objective,
                "q_rel_vs_a": rel(res_b.objective, res.objective),
                "exchange_bytes": sum(map(len, frames_b.values())),
                "frame_rel_err_max": worst,
                "center_err_rel_rms": float(np.abs(
                    res_b.centers - res.centers).max()) / held["scale"]}
    if rec["b_bf16"]["q_rel_vs_a"] > 1e-3:
        raise AssertionError(f"fleet (b): {rec['b_bf16']}")

    # -- (c): a straggler evicted, its shards replanned onto the others
    fleet_c = FleetConfig(n_hosts=3, shards_per_host=FLEET_SHARDS,
                          prefetch_bytes=FLEET_PREFETCH_BYTES,
                          debug_delay_s={1: FLEET_DELAY_S},
                          straggler_factor=FLEET_STRAGGLER_FACTOR,
                          straggler_min_s=0.4)
    _, moved = replan(store, plan_partitions(store, 3 * FLEET_SHARDS),
                      2 * FLEET_SHARDS)
    obs.reset_all()
    t0 = time.perf_counter()
    res_c = fleet_fit(store, cfg, fleet_c, v_init=v_init, device=device)
    wall_c = time.perf_counter() - t0
    detected = obs.counter("fleet.straggler.detected").value
    obs.reset_all()
    hold_fleet_result(res_c, (0, 2), 1, n, "fleet (c)")
    rec["c_straggler"] = {"wall_s": wall_c, "objective": res_c.objective,
                "q_rel_vs_a": rel(res_c.objective, res.objective),
                "moved_chunks": res_c.moved_chunks, "replan_moved": moved,
                "straggler_detected": detected,
                "shard_seconds": res_c.shard_seconds}
    if res_c.moved_chunks != moved or moved == 0 or detected != 1 or \
            rec["c_straggler"]["q_rel_vs_a"] > 1e-5:
        raise AssertionError(f"fleet (c): {rec['c_straggler']}")

    # -- (d): kill one host of a 3-process fleet; against a threaded fleet
    #    born at 2 hosts (both derive their seeds from the config)
    fleet_kw = dict(shards_per_host=FLEET_SHARDS,
                    prefetch_bytes=FLEET_PREFETCH_BYTES,
                    debug_delay_s={1: FLEET_DELAY_S}, gather_timeout_s=600.0)
    born2 = fleet_fit(store, cfg, FleetConfig(
        n_hosts=2, shards_per_host=FLEET_SHARDS,
        prefetch_bytes=FLEET_PREFETCH_BYTES), device=device)
    fleet_dir = store_dir / "fleet_kill"
    mail = fleet_dir / MAIL_DIR
    t0 = time.perf_counter()
    procs = spawn_fleet(3, str(store_path), str(fleet_dir),
                        dataclasses.asdict(cfg), fleet_kw,
                        device=str(device))
    try:
        deadline = time.monotonic() + 600
        while not all((mail / f"e0000.sum.h{h:04d}.bin").exists()
                      for h in (0, 2)):
            if time.monotonic() > deadline or not (
                    procs[0].is_alive() and procs[2].is_alive()):
                raise AssertionError(
                    "fleet (d): hosts 0 and 2 never posted (exit codes "
                    f"{[p.exitcode for p in procs.values()]})")
            time.sleep(0.1)
        posted_s = time.perf_counter() - t0
        procs[1].terminate()
        watch_fleet(procs, str(fleet_dir), timeout_s=600)
    finally:
        for p in procs.values():
            if p.is_alive():
                p.terminate()
            p.join(timeout=60)
    wall_d = time.perf_counter() - t0
    codes = {h: p.exitcode for h, p in procs.items()}
    results = collect_results(str(fleet_dir), 3)
    if codes[0] != 0 or codes[2] != 0 or sorted(results) != [0, 2]:
        raise AssertionError(f"fleet (d): exit codes {codes}, results from "
                             f"{sorted(results)}")
    r0, r2 = results[0], results[2]
    rec["d_kill"] = {"wall_s": wall_d, "posted_s": posted_s, "exit_codes": codes,
                "objective": float(r0["objective"]),
                "moved_chunks": int(r0["moved_chunks"]),
                "obs_moved": [float(r0["obs_moved"]), float(r2["obs_moved"])],
                "born2_objective": born2.objective,
                "center_err_vs_born2": float(np.abs(
                    r0["centers"] - born2.centers).max()),
                "q_rel_vs_born2": rel(float(r0["objective"]),
                                      born2.objective),
                "bit_equal_born2": bool(
                    np.array_equal(r0["centers"], born2.centers)
                    and float(r0["objective"]) == born2.objective)}
    if not (list(r0["live"]) == list(r2["live"]) == [0, 2]
            and int(r0["epoch"]) == 1 and int(r0["n_rows"]) == n
            and int(r0["moved_chunks"]) == moved
            and rec["d_kill"]["obs_moved"] == [moved, moved]
            and np.array_equal(r0["centers"], r2["centers"])
            and float(r0["objective"]) == float(r2["objective"])
            and rec["d_kill"]["center_err_vs_born2"] <= 1e-5
            and rec["d_kill"]["q_rel_vs_born2"] < 1e-5
            and rec["d_kill"]["bit_equal_born2"]):
        raise AssertionError(f"fleet (d): {rec['d_kill']}")

    # -- (e): Mahout-KM on the KDD99-like array from its main path's seeds
    xk = torch.from_numpy(kdd["x"]).to(device)
    seeds = kdd["x"][kdd["sample_idx"]][kdd["seed_idx"]]
    v_k, counts, inertia, n_jobs, elapsed = mr_kmeans(xk, seeds,
                                                      device=device)
    exact = 0.0
    vk64 = v_k.double()
    for i in range(0, xk.shape[0], 1 << 16):
        xb = xk[i:i + (1 << 16)].double()
        exact += float(((xb[:, None] - vk64[None]) ** 2).sum(-1)
                       .min(-1).values.sum())
    rec["e_kmeans"] = {"n": int(xk.shape[0]), "c": int(v_k.shape[0]),
                "n_jobs": n_jobs, "elapsed_s": elapsed,
                "inertia": float(inertia), "inertia_float64": exact,
                "inertia_rel": rel(float(inertia), exact),
                "counts_sum": float(counts.sum())}
    if rec["e_kmeans"]["counts_sum"] != xk.shape[0] or rec["e_kmeans"]["inertia_rel"] > 1e-4:
        raise AssertionError(f"fleet (e): {rec['e_kmeans']}")
    del xk

    # -- K1 at the batch shape and K2 at the merge shape against their
    #    plain versions, on the fleet's own inputs: the store's first
    #    batch at the fleet's centers, the first pair a host merges
    centers = torch.from_numpy(res.centers).to(device)
    xb = torch.from_numpy(np.array(store.chunk(0))).to(device)
    pts = gathered.centers[:2].reshape(-1, d).contiguous()
    wts = gathered.masses[:2].reshape(-1).contiguous()
    heavier = bool(gathered.masses[0].sum() >= gathered.masses[1].sum())
    v_pair = gathered.centers[0 if heavier else 1].contiguous()
    cases = {"fleet_batch": (xb, torch.ones((rows,), dtype=torch.float32,
                                            device=device), centers, 0.0),
             "fleet_merge": (pts, wts, v_pair,
                             sweep_expansion_atol(pts, wts, v_pair, run.m))}
    new = []
    with uncounted():
        got = shape_entries(run.name, cases, by_shape, d, run.m, device,
                            20, full=None)
    for e in got:
        twin = next((o for o in entries if o["name"] == e["name"]
                     and o["shape"] == e["shape"]), None)
        if twin is None:
            new.append(e)
            continue
        twin["fleet_launches"] = e["launches"]
        twin["launches"] += e["launches"]
        twin["max_abs_err"] = max(twin["max_abs_err"], e["max_abs_err"])
    rec["kernel_holds"] = [{k: e[k] for k in (
        "name", "run", "shape", "launches", "max_abs_err", "ms", "plain_ms")}
        for e in got]
    obs.reset_all()
    emit(rec)
    return new


# The stream phase.  Micro-batches of 262,144 rows (43 MB at d = 41);
# drift streams at HIGGS width with C = 8, m = 2.
STREAM_ROWS = 1 << 18
DRIFT_D, DRIFT_C = 28, 8
STREAM_CKPT_STEP = 10        # kdd99_stream: checkpoint round trip here


@dataclasses.dataclass(frozen=True)
class DriftRun:
    name: str
    n_chunks: int
    drift_at: int
    shift: float
    drift_clusters: tuple     # () = every component moves
    cfg: tuple                # StreamConfig overrides, as (key, value)s


# (a) tests/test_stream.py:35-57's acceptance stream and config (window 3,
# decay 0.8, driver sample 384); (b) its birth/death stream and config
# (:60-89).  A record's residual is about d (unit spread), and the birth
# rule's outlier bar 8·d: the test's moved records (shift 12 at d = 6)
# sit at 12² + 6 ≈ 3.1 × 8·6; at d = 28 the same ratio takes a shift of
# 26.  There the starving center's death is a knife edge (PERF.md): it
# dies a step late in one f32 arithmetic and migrates onto the split-off
# component, tripping the shift test.  At 30 (3.9 × the bar) every
# arithmetic, float64 included, retires it at the first step it may.
DRIFT_RUNS = (
    DriftRun("drift_global", 12, 6, 10.0, (),
             (("window", 3), ("decay", 0.8), ("driver_sample", 384))),
    DriftRun("drift_split", 10, 4, 30.0, (0,),
             (("window", 3), ("decay", 0.6), ("driver_sample", 384),
              ("death_mass_floor", 0.25), ("reseed_cooldown", 2))))
# (c) tests/test_event_time.py:18-24's config; two 262,144-row chunks
# per 10-unit bucket, skew 5 below the lateness 20.
EVENT_CFG = (("window", 8), ("decay", 0.9), ("driver_sample", 256),
             ("event_time", True), ("slot_span", 10.0),
             ("allowed_lateness", 20.0))
EVENT_SKEW = 5.0


class DriverPin:
    """Wraps `repro_torch.stream.streaming.run_driver`: in ``record`` mode
    the race runs and its flag is kept; in ``replay`` mode (the twins,
    the restored model) the branch the race kept runs alone, from the
    same sample and seeds — the race is decided by the wall clock, so
    without it a twin could keep the other branch's centers."""

    def __init__(self):
        from repro_torch.stream import streaming
        self.module, self.real = streaming, streaming.run_driver
        self.mode, self.flag, self.races = "record", True, 0
        streaming.run_driver = self

    def __call__(self, x_sample, cfg, *, seed_idx, device):
        from repro_torch.core import fcm, wfcmpb
        if self.mode == "record":
            out = self.real(x_sample, cfg, seed_idx=seed_idx, device=device)
            self.flag, self.races = bool(out[1]), self.races + 1
            return out
        seeds = x_sample[torch_index(seed_idx, x_sample.device)]
        kw = dict(m=cfg.m, eps=cfg.driver_eps, max_iter=cfg.max_iter,
                  backend=cfg.backend, device=device)
        res = (fcm(x_sample, seeds, **kw) if self.flag else
               wfcmpb(x_sample, seeds, block_size=cfg.block_size, **kw))
        return res.centers, self.flag, 0.0, 0.0

    def close(self):
        self.module.run_driver = self.real


def torch_index(idx, device):
    import numpy as np
    import torch
    return torch.as_tensor(np.asarray(idx, np.int64), device=device)


@contextlib.contextmanager
def float64():
    """torch's default float type set to float64 inside the block: the
    port's plain path (`repro_torch.device.real_dtype`) computes in it."""
    import torch
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(old)


class uncounted:
    """Launches inside the block leave every wrapper's counts as they
    were, and `repro_torch.obs` records nothing there (checks beside the
    main path are not the main path)."""

    def __enter__(self):
        from repro_torch import obs
        from repro_torch.kernels.fcm_update import WRAPPERS
        self.saved = [(fn, fn.launches, fn.shapes.copy()) for fn in WRAPPERS]
        self.obs_on = obs.enabled()
        obs.set_enabled(False)

    def __exit__(self, *exc):
        from repro_torch import obs
        for fn, launches, shapes in self.saved:
            fn.launches, fn.shapes = launches, shapes
        obs.set_enabled(self.obs_on)


class ObsCalls:
    """Counts the calls the port's modules make into `repro_torch.obs`
    (its package-level ``span``, ``counter``, ``gauge``, ``histogram``
    and ``event``, through which every instrumented module goes) while
    obs is enabled, inside the block."""

    NAMES = ("span", "counter", "gauge", "histogram", "event")

    def __enter__(self):
        from repro_torch import obs
        self.calls, self.saved = 0, {n: getattr(obs, n) for n in self.NAMES}
        for name, fn in self.saved.items():
            setattr(obs, name, self._counted(fn))
        return self

    def _counted(self, fn):
        from repro_torch import obs

        def counted(*args, **kw):
            if obs.enabled():
                self.calls += 1
            return fn(*args, **kw)
        return counted

    def __exit__(self, *exc):
        from repro_torch import obs
        for name, fn in self.saved.items():
            setattr(obs, name, fn)


OBS_BUDGET = 0.05    # the reference's ingest overhead budget (test_obs.py)


def obs_call_costs(n: int = 20_000, reps: int = 9) -> dict:
    """Seconds per call of one `obs.span` (enter and exit) and of one
    ``obs.counter(name).add``, each the minimum over ``reps`` runs of
    ``n`` calls (the host's clock; the minimum is robust to a loaded
    host where an on-vs-off race of whole ingests is not)."""
    from repro_torch import obs

    def span():
        with obs.span("chip_smoke.bench"):
            pass

    def add():
        obs.counter("chip_smoke.bench").add(1)
    out = {}
    for name, fn in (("span", span), ("counter_add", add)):
        best = math.inf
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            best = min(best, (time.perf_counter() - t0) / n)
        out[name] = best
    return out


class StreamRun:
    """Drives one `StreamingBigFCM` on the card: times each ingest (host
    clock between `torch.cuda.synchronize()` calls) split into the drift
    probe, the combiner, the window merge and the driver, and — when
    ``twin`` — holds every ingest against twins started from the model's
    pre-ingest state (`hold_step`)."""

    STAGES = {"_probe": "probe_s", "_combine": "combiner_s",
              "_window_merge": "merge_s", "_driver_seed": "driver_s"}

    def __init__(self, name, model, pin, *, twin, scale, ckpt_dir=None):
        self.name, self.model, self.pin = name, model, pin
        self.twin, self.scale, self.ckpt_dir = twin, scale, ckpt_dir
        self.steps, self.not_fixed, self.ckpt = [], [], None
        self._ingest = model.ingest
        model.ingest = self.ingest
        for meth, key in self.STAGES.items():
            setattr(model, meth, self._timed(key, getattr(model, meth)))

    def _timed(self, key, fn):
        import torch

        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.cur[key] += time.perf_counter() - t0
            if key == "merge_s":
                self.merge_io = (args, out[0])
            return out
        return call

    def _fork(self, pre):
        """A ``torch``-backend model with the main one's config and its
        pre-ingest state, in `real_dtype`."""
        from repro_torch.stream import StreamingBigFCM
        cfg = dataclasses.replace(self.model.cfg, backend="torch")
        twin = StreamingBigFCM(cfg, device=self.model.device)
        if pre is not None:
            twin.load_state_arrays(pre)
        return twin

    def ingest(self, x, w=None, *, ts=None):
        import torch
        model = self.model
        pre = None if model.state is None else model.state_dict()
        step = 0 if pre is None else int(pre["step"])
        restored = None
        if self.ckpt_dir is not None and step == STREAM_CKPT_STEP:
            from repro_torch.ft import CheckpointManager
            from repro_torch.stream import StreamingBigFCM
            ckpt = CheckpointManager(str(self.ckpt_dir), async_save=False)
            model.save(ckpt)
            restored = StreamingBigFCM.restore(
                ckpt, model.cfg, int(pre["centers"].shape[1]),
                device=model.device)
        self.cur = dict.fromkeys(self.STAGES.values(), 0.0)
        self.pin.mode = "record"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = self._ingest(x, w, ts=ts)
        torch.cuda.synchronize()
        rec = {"step": rep.step, "wall_s": time.perf_counter() - t0,
               **self.cur, "combiner_iters": int(rep.combiner_iters[0]),
               "drifted": rep.drifted, "reason": rep.reason,
               "born": rep.born, "died": rep.died,
               "n_centers": rep.n_centers,
               "objective_post": rep.objective_post}
        self.pin.mode = "replay"
        with uncounted():
            if self.twin:
                rec["held"] = self.hold_step(pre, x, w, ts, rep)
            if restored is not None:
                self.ckpt = hold_restored(restored, model, x, w, ts, rep)
        self.steps.append(rec)
        return rep

    def hold_step(self, pre, x, w, ts, rep) -> dict:
        """The step against two ``torch``-backend twins from the same
        pre-ingest state, fed the same batch (and, on a re-seed, the same
        draws and driver branch): one in float32, one in float64 (the
        exact answer, to within the step's conditioning).

        Each quantity must meet its bar against the float32 twin (the
        same decisions — drifted, reason, born, died, n_centers —;
        merged centers within 1e-3 of the data's RMS, as sets;
        objective_post within 1e-4 relative; combiner sweeps ±2), or lie
        no farther from the float64 twin than that bar or twice the
        float32 twin's own distance (decisions: equal to the float64
        twin's), so that it is as near the exact answer as the plain
        version.

        Centers and objective that miss both are released only where the
        window merge is shown not fixed at f32 against float64
        (`merge_conditioning`): the model's window (its combiner's
        output) lies as near the float64 twin's as the float32 twin's
        does, and the model's merge of that window lies no farther from
        its float64 merge than the bar or twice as far as the plain f32
        merges of the same window do.  Such a step is printed and
        counted; any other miss raises."""
        twin = self._fork(pre)
        tmerge = capture(twin, "_window_merge")
        trep = twin.ingest(x, w, ts=ts)
        with float64():
            exact = self._fork(pre)
            emerge = capture(exact, "_window_merge")
            erep = exact.ingest(x, w, ts=ts)
        h = (rep, self.model.state.centers)
        t = (trep, twin.state.centers)
        e = (erep, exact.state.centers)
        got = {"vs_torch": step_gap(h, t, self.scale),
               "vs_float64": step_gap(h, e, self.scale),
               "torch_vs_float64": step_gap(t, e, self.scale)}
        missed = missed_bars(got)
        if missed:
            cond = self.merge_conditioning(self.merge_io, tmerge[0],
                                           emerge[0])
            got.update({"missed": sorted(missed), "merge_conditioning": cond})
            if missed - {"centers", "objective"} or not cond["not_fixed"]:
                raise AssertionError(f"{self.name} step {rep.step}: hopper "
                                     f"vs torch and float64: {got}")
            self.not_fixed.append(rep.step)
        return got

    def merge_conditioning(self, hop, tor, ex) -> dict:
        """Is the step's window merge fixed at f32?  ``hop``, ``tor``,
        ``ex``: each run's last (window, merged centers).  The model's
        window is merged again through the model's backend (bit-identical
        to its merge), through ``torch`` in float32 plainly and
        translated by its mean (two f32 computations of one problem), and
        in float64; every f32 result's distance from the float64 merge."""
        import torch
        from repro_torch.engine import Summary, merge_summaries
        (wh, mh), (wt, _), (we, me) = hop, tor, ex
        plan = self.model.cfg.window_plan()

        def merge(c, w, backend, shift=None):
            res = merge_summaries(Summary(c if shift is None else c - shift,
                                          w), plan, backend=backend)
            v = res.summary.centers
            return (v if shift is None else v + shift), res.n_iter
        wc, ww = wh
        mu = wc[ww > 0].mean(0)
        again, n_h = merge(wc, ww, self.model.backend)
        p1, n_p1 = merge(wc, ww, "torch")
        p2, n_p2 = merge(wc, ww, "torch", mu)
        with float64():
            e64, n_e = merge(wc.double(), ww.double(), "torch")
        rec = {"merge_again_bit_identical": bool(torch.equal(again, mh)),
               "merge_sweeps": {"model": n_h, "torch": n_p1,
                                "torch_translated": n_p2, "float64": n_e},
               "window_vs_float64": window_gap(wh, we, self.scale),
               "torch_window_vs_float64": window_gap(wt, we, self.scale),
               "merge_vs_float64_merge": center_gap(mh, e64, self.scale),
               "torch_merge_vs_float64_merge": center_gap(p1, e64,
                                                          self.scale),
               "torch_translated_merge_vs_float64_merge": center_gap(
                   p2, e64, self.scale),
               "float64_merge_vs_float64_twin": center_gap(e64, me,
                                                           self.scale)}
        spread = max(rec["torch_merge_vs_float64_merge"],
                     rec["torch_translated_merge_vs_float64_merge"])
        rec["not_fixed"] = (rec["merge_again_bit_identical"]
                            and rec["window_vs_float64"] <= max(
                                1e-5, 2 * rec["torch_window_vs_float64"])
                            and rec["merge_vs_float64_merge"] <= max(
                                STEP_BARS["centers"], 2 * spread))
        return rec

    def close(self):
        self.model.ingest = self._ingest
        for meth in self.STAGES:
            delattr(self.model, meth)


def capture(model, meth) -> list:
    """Keeps the last (arguments, first output) of ``model.meth`` in the
    returned list's one slot."""
    box, fn = [None], getattr(model, meth)

    def call(*args):
        out = fn(*args)
        box[0] = (args, out[0])
        return out
    setattr(model, meth, call)
    return box


def window_gap(a, b, scale) -> float:
    """How far two windows ((W, C, d) centers, (W, C) masses) lie apart:
    the larger of the live rows' center gap over ``scale`` and the
    masses' gap over the largest mass."""
    (ca, wa), (cb, wb) = a, b
    if ca.shape != cb.shape:
        return math.inf
    live = (wa > 0) | (wb > 0)
    dc = (ca.double() - cb.double()).abs().amax(-1)[live].max()
    dw = (wa.double() - wb.double()).abs().max() / wb.double().abs().max()
    return max(float(dc) / scale, float(dw))


# `StreamRun.hold_step`'s bars (decisions: equal).
STEP_BARS = {"centers": 1e-3, "objective": 1e-4, "sweeps": 2}


def within_bar(k, v) -> bool:
    return v if k == "decisions" else v <= STEP_BARS[k]


def missed_bars(got) -> set:
    """The quantities of a step that meet their bar neither against the
    float32 twin nor, as near the exact answer as it, against the
    float64 one."""
    vt, vf, tf = (got[k] for k in ("vs_torch", "vs_float64",
                                   "torch_vs_float64"))
    missed = set()
    for k in vt:
        if within_bar(k, vt[k]):
            continue
        if k == "decisions" and vf[k] or k != "decisions" and (
                vf[k] <= max(STEP_BARS[k], 2 * tf[k])):
            continue
        missed.add(k)
    return missed


def center_gap(a, b, scale) -> float:
    """How far two center sets lie apart, over ``scale``: the largest
    max-norm distance from a center of either set to the nearest center
    of the other (inf when their counts differ).  Birth and death leave
    the order of co-located centers to rounding, so order is not held."""
    if a.shape != b.shape:
        return math.inf
    d = (a.double()[:, None] - b.double()[None]).abs().amax(-1)
    return max(float(d.min(1).values.max()),
               float(d.min(0).values.max())) / scale


def step_gap(a, b, scale) -> dict:
    """How far one ingest lies from another, each as (report, centers):
    equal decisions, center gap (`center_gap`), objective_post's relative
    gap, combiner sweeps apart."""
    (ra, va), (rb, vb) = a, b
    fields = ("drifted", "reason", "born", "died", "n_centers")
    return {"decisions": all(getattr(ra, f) == getattr(rb, f)
                             for f in fields),
            "centers": center_gap(va, vb, scale),
            "objective": abs(ra.objective_post - rb.objective_post)
            / abs(rb.objective_post),
            "sweeps": abs(int(ra.combiner_iters[0])
                          - int(rb.combiner_iters[0]))}


def hold_restored(restored, model, x, w, ts, rep) -> dict:
    """The model restored from its own mid-stream checkpoint ingests the
    same batch: report and state bit-identical to the live model's."""
    import numpy as np
    import torch
    again = restored.ingest(x, w, ts=ts)
    for f in rep._fields:
        a, b = getattr(again, f), getattr(rep, f)
        if not (np.array_equal(a, b) if isinstance(a, np.ndarray)
                else a == b or (a != a and b != b)):
            raise AssertionError(f"restored stream: report {f} {a} != {b}")
    for f, a in restored.state._asdict().items():
        if not torch.equal(a.cpu(), getattr(model.state, f).cpu()):
            raise AssertionError(f"restored stream: state {f} differs")
    return {"step": rep.step, "bit_identical": True}


def stream_launches(name, run_name):
    """The main path's launch record of a stream run: per wrapper, total
    and per shape, every launch on the plan's path."""
    from repro_torch.kernels.fcm_update import (fcm_accumulate_cuda,
                                                fcm_sweep_cuda)
    launches = {"fcm_sweep": fcm_sweep_cuda.launches,
                "fcm_accumulate": fcm_accumulate_cuda.launches}
    if min(launches.values()) == 0:
        raise AssertionError(f"{name}: a kernel was not launched: "
                             f"{launches}")
    check_paths(run_name, fcm_sweep_cuda, fcm_accumulate_cuda)
    by_shape = {"fcm_sweep": dict(fcm_sweep_cuda.shapes),
                "fcm_accumulate": dict(fcm_accumulate_cuda.shapes)}
    return launches, by_shape, {
        "fcm_sweep": shape_counts(fcm_sweep_cuda),
        "fcm_accumulate": shape_counts(fcm_accumulate_cuda)}


def expansion_atol(x, w, v, m) -> tuple:
    """Per-entry atols of K1's (v_num, w_i, q) at records ``x`` (masses
    ``w``) that lie on or between centers ``v``.  The kernel forms d² =
    ‖x‖² + ‖v‖² − 2x·v, each entry within δ = 2·γ_{d+2}·(‖x‖² + ‖v‖²)
    of the exact d² (`q_rounding_bound`); where δ is not small beside
    d², the memberships are rounding's.  In float64, each u_ik^m is
    bounded over d²_ik ± δ with the other centers' d² moved the other
    way (Δ_ik), and the atols are Σ_k w_k·(Δ_ik + RTOL·u_ik^m)·|x_k|,
    Σ_k w_k·Δ_ik and Σ_k w_k·Σ_i (Δ_ik·(d²_ik + δ_ik) + u_ik^m·δ_ik)."""
    import torch
    x, w, v = x.double(), w.double(), v.double()
    gamma = (x.shape[1] + 2) * 2.0 ** -24
    d2 = ((x[:, None] - v[None]) ** 2).sum(-1).clamp_min(1e-12)
    delta = 2 * gamma * ((x * x).sum(1)[:, None] + (v * v).sum(1)[None])
    eye = torch.eye(v.shape[0], dtype=torch.bool, device=x.device)

    def um(own, others):
        """u_ik^m with d²_ik = own and every other center's = others."""
        e = (own.log()[:, :, None] - others.log()[:, None, :]) / (m - 1.0)
        lse = e.masked_fill(eye, -math.inf).logsumexp(-1)
        return torch.sigmoid(-lse) ** m
    u = um(d2, d2)
    lo, hi = (d2 - delta).clamp_min(1e-12), d2 + delta
    dev = torch.maximum(um(lo, hi) - u, u - um(hi, lo)) * w[:, None]
    terms = dev + RTOL * u * w[:, None]
    return tuple(a.float() for a in (
        terms.T @ x.abs(), dev.sum(0),
        (dev * (d2 + delta) + u * w[:, None] * delta).sum()))


def stream_cases(name, x_rows, model, by_shape):
    """The kernels' inputs at every (N, C) a stream run launched them at.
    C centers are the first C of the final ones, topped up with records
    where the run had more.  ``slot``, K1 at the final C points: the pair
    the windowed merge launches — the heaviest window slot's centers and
    masses against the merged centers.  Its points lie on or between
    centers, where the kernel's d² expansion leaves memberships to
    rounding, so its atols are `expansion_atol`'s; there the kernel is
    also held to them against a float64 accumulate, and both versions'
    distance from it printed.  ``batch C=c``, the first STREAM_ROWS
    records at unit weights; any other (N, C) as the first N records."""
    import torch
    from repro_torch.engine.backend import fcm_accumulate
    from repro_torch.kernels.fcm_update import (fcm_accumulate_cuda,
                                                fcm_accumulate_ref)
    v_fin, m = model.state.centers, model.cfg.m
    slot = int(torch.argmax(model.state.win_weights.sum(1)))
    cases = {}
    for n, c in sorted({k[1:] for shapes in by_shape.values()
                        for k in shapes}):
        v = torch.cat([v_fin, x_rows[:c]])[:c].contiguous()
        if n == c == v_fin.shape[0]:
            pts = model.state.win_centers[slot].contiguous()
            masses = model.state.win_weights[slot].contiguous()
            tol = expansion_atol(pts, masses, v, m)
            with float64():
                exact = [a.float() for a in fcm_accumulate(
                    pts.double(), masses.double(), v.double(), m)]
            with uncounted():
                got = fcm_accumulate_cuda(pts, masses, v, m)
            plain = fcm_accumulate_ref(pts, masses, v, m)
            atols = tuple(ACC_ATOL + e for e in tol)
            emit({"phase": "stream", "run": name, "slot_case": {
                "shape": list(pts.shape) + [c],
                "atol_max": [float(a.max()) for a in atols],
                "kernel_vs_float64": max_err(
                    got, exact, RTOL, atols, f"{name} slot K1 vs float64"),
                "plain_vs_float64": [float((a - b).abs().max())
                                     for a, b in zip(plain, exact)],
                "kernel_vs_plain": [float((a - b).abs().max())
                                    for a, b in zip(got, plain)]}})
            cases["slot"] = (pts, masses, v, tol)
            continue
        xs = x_rows[:n]
        w = torch.ones((n,), dtype=torch.float32, device=xs.device)
        label = f"batch C={c}" if n == STREAM_ROWS else f"n={n} C={c}"
        cases[label] = (xs, w, v,
                        0.0 if n == STREAM_ROWS else q_rounding_bound(xs, w, v))
    return cases


def run_kdd99_stream(x_np, seed, device, ckpt_dir, pin):
    """``kdd99_stream``: the KDD99-like array replayed through
    `assign_stream(model, stream_loader(replay_source(x, 262144),
    262144))` on backend ``hopper``, C = 23, m = 1.2 (the paper's), the
    `StreamConfig` defaults otherwise; launch counts zeroed just before
    the loop and read just after.  Every ingest is step-locked against a
    ``torch`` twin, the model is checkpointed and restored at step
    STREAM_CKPT_STEP, and the last batch's labels are held against
    `make_assigner` of the final centers.  Returns the kernel entries."""
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.data import replay_source, stream_loader
    from repro_torch.kernels.fcm_update import reset_counts
    from repro_torch.serve import assign_stream, make_assigner
    from repro_torch.stream import StreamConfig, StreamingBigFCM
    n, d = x_np.shape
    cfg = StreamConfig(n_clusters=23, m=1.2, seed=seed, backend="hopper")
    model = StreamingBigFCM(cfg, device=device)
    scale = float(np.sqrt(np.mean(np.square(x_np[:STREAM_ROWS],
                                            dtype=np.float64))))
    run = StreamRun("kdd99_stream", model, pin, twin=True, scale=scale,
                    ckpt_dir=ckpt_dir)
    obs.reset_all()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ObsCalls() as calls:
        for labels, rep in assign_stream(model, stream_loader(
                replay_source(x_np, STREAM_ROWS), STREAM_ROWS,
                device=device)):
            pass
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches, by_shape, printed = stream_launches("kdd99_stream",
                                                  "kdd99_stream")
    run.close()
    last = n - (n - 1) // STREAM_ROWS * STREAM_ROWS
    x_last = torch.from_numpy(x_np[n - last:]).to(device)
    want = make_assigner(model.state.centers, m=cfg.m, backend="hopper",
                         device=device)(x_last).cpu().numpy()
    ties = label_ties(labels, want, x_last, model.state.centers)
    if run.ckpt is None or len(run.steps) != -(-n // STREAM_ROWS):
        raise AssertionError(f"kdd99_stream: {len(run.steps)} ingests, "
                             f"checkpoint {run.ckpt}")
    record = stream_record("kdd99_stream", run, cfg, n, d, loop_s, launches,
                           printed)
    record.update({"last_batch_rows": last, "assign_ties_differing": ties,
                   "checkpoint": run.ckpt,
                   "obs": stream_obs(run, n, calls.calls)})
    emit(record)
    xd = torch.from_numpy(x_np[:STREAM_ROWS]).to(device)
    return shape_entries("kdd99_stream",
                         stream_cases("kdd99_stream", xd, model, by_shape),
                         by_shape, d, cfg.m, device, 20, full=None)


def stream_obs(run, n, calls) -> dict:
    """The obs record of ``kdd99_stream``: its phase breakdown, the
    counters held against what the run did (``stream.records`` against
    the array's rows, births, deaths and re-seeds against the ingest
    reports, ``serve.records`` against the labels), and obs's cost share
    of a steady ingest: ``calls`` (every obs call of the run, `ObsCalls`)
    per ingest times the dearer of one span and one counter add
    (`obs_call_costs`), over the median ingest wall past the first;
    held to OBS_BUDGET."""
    from repro_torch import obs
    snap = obs.metrics_snapshot()
    counters = snap["counters"]
    steps = run.steps
    want = {"stream.records": n, "serve.records": n,
            "stream.births": sum(s["born"] for s in steps),
            "stream.deaths": sum(s["died"] for s in steps),
            "stream.reseeds": sum(s["drifted"] for s in steps)}
    got = {k: counters.get(k, 0.0) for k in want}
    if got != want:
        raise AssertionError(f"kdd99_stream obs counters {got}, the run "
                             f"did {want}")
    spans = {k: h["count"] for k, h in snap["histograms"].items()
             if k.startswith("span.")}
    if spans.get("span.stream.ingest") != len(steps):
        raise AssertionError(f"kdd99_stream: {spans} for {len(steps)} "
                             "ingests")
    breakdown = obs.phase_breakdown()
    costs = obs_call_costs()
    walls = sorted(s["wall_s"] for s in steps[1:])
    steady = walls[len(walls) // 2]
    per_ingest = calls / len(steps)
    share = per_ingest * max(costs.values()) / steady
    if share > OBS_BUDGET:
        raise AssertionError(f"obs costs {share:.2%} of a steady ingest")
    obs.reset_all()
    return {"phase_breakdown": breakdown, "counters": counters,
            "gauges": snap["gauges"], "spans": spans, "calls": calls,
            "calls_per_ingest": per_ingest, "call_cost_s": costs,
            "steady_ingest_wall_s": steady, "cost_share": share,
            "budget": OBS_BUDGET}


def label_ties(got, want, x, centers) -> int:
    """Rows whose hard labels differ must be ties within f32 rounding;
    returns their count."""
    import numpy as np
    bad = np.flatnonzero(got != want)
    if bad.size:
        xs = x[torch_index(bad, x.device)]
        d2 = ((xs[:, None, :] - centers[None]) ** 2).sum(-1).cpu().numpy()
        rows = np.arange(bad.size)
        ga, wa = d2[rows, got[bad]], d2[rows, want[bad]]
        if np.any(np.abs(ga - wa) > 1e-6 * np.maximum(ga, wa)):
            raise AssertionError(f"{bad.size} labels differ beyond a tie")
    return int(bad.size)


def stream_record(name, run, cfg, n, d, loop_s, launches, printed) -> dict:
    """A stream run's phase record: sizes, ingest walls and their split,
    launches, and the step-lock results."""
    steps = run.steps
    tot = {k: sum(s[k] for s in steps) for k in
           ("wall_s", "probe_s", "combiner_s", "merge_s", "driver_s")}
    return {"phase": "stream", "run": name, "n": n, "d": d,
            "c": cfg.n_clusters, "m": cfg.m, "window": cfg.window,
            "batch_rows": STREAM_ROWS, "ingests": len(steps),
            "loop_s": loop_s, "ingest_totals_s": tot,
            "combiner_sweeps": sum(s["combiner_iters"] for s in steps),
            "launches": launches, "launches_by_shape": printed,
            "driver_races": run.pin.races,
            "not_fixed_at_f32_steps": run.not_fixed, "steps": steps}


def drift_chunks(run: DriftRun, seed):
    from repro_torch.data import make_moving_blobs
    return [x for x, _ in make_moving_blobs(
        run.n_chunks, STREAM_ROWS, DRIFT_D, DRIFT_C, drift_at=run.drift_at,
        shift=run.shift, seed=seed,
        drift_clusters=run.drift_clusters or None)]


def run_drift_stream(run: DriftRun, chunks, seed, device, pin):
    """(a) global drift or (b) a component splitting off, at d = 28,
    C = 8, m = 2, every ingest held against its twins
    (`StreamRun.hold_step`); (a) re-seeds exactly once, within the
    cooldown of the drift, and ends within 5 % of a fresh `bigfcm_fit`
    of its last window; (b) births one center and never re-seeds —
    unless a step up to the re-seed was shown not fixed at f32 against
    float64 — and its deaths are printed (the reference's death
    count is not a stable oracle).  Returns the kernel entries."""
    import numpy as np
    import torch
    from repro_torch.core import BigFCMConfig, bigfcm_fit
    from repro_torch.core.metrics import fuzzy_objective
    from repro_torch.kernels.fcm_update import reset_counts
    from repro_torch.stream import StreamConfig, StreamingBigFCM
    cfg = StreamConfig(n_clusters=DRIFT_C, m=2.0, seed=seed, backend="hopper",
                       **dict(run.cfg))
    model = StreamingBigFCM(cfg, device=device)
    scale = float(np.sqrt(np.mean(np.square(chunks[0], dtype=np.float64))))
    srun = StreamRun(run.name, model, pin, twin=True, scale=scale)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = model.run(chunks)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches, by_shape, printed = stream_launches(run.name, run.name)
    srun.close()
    st = model.state
    record = stream_record(run.name, srun, cfg, len(chunks) * STREAM_ROWS,
                           DRIFT_D, loop_s, launches, printed)
    record.update({"reseeds": int(st.reseeds), "births": int(st.births),
                   "deaths": int(st.deaths),
                   "reseed_steps": [i for i, r in enumerate(reps)
                                    if r.reseeded]})
    if run.drift_clusters:
        # A re-seed is held to 0 unless a step up to it was shown not
        # fixed at f32 against float64: then which attractor
        # the merge reached there (the old center starving, or migrating
        # onto the split-off component and tripping the shift test) is
        # rounding's choice, as the reference's death count is.
        first = (record["reseed_steps"] or [math.inf])[0] + 1
        loose = any(s <= first for s in srun.not_fixed)
        record["reseeds_held"] = not loose
        if int(st.births) != 1 or int(st.reseeds) != 0 and not loose:
            raise AssertionError(f"{run.name}: {record}")
    else:
        lo, hi = run.drift_at, run.drift_at + cfg.reseed_cooldown
        if int(st.reseeds) != 1 or not lo <= record["reseed_steps"][0] <= hi:
            raise AssertionError(f"{run.name}: {record}")
        x_win = torch.from_numpy(np.concatenate(
            chunks[-cfg.window:])).to(device)
        batch = bigfcm_fit(x_win, BigFCMConfig(
            n_clusters=DRIFT_C, sample_size=cfg.driver_sample, seed=1,
            backend="hopper"), device=device)
        q_stream = float(fuzzy_objective(x_win, st.centers, cfg.m))
        q_batch = float(fuzzy_objective(x_win, batch.centers, cfg.m))
        record["q_last_window"] = {"stream": q_stream, "batch": q_batch}
        if q_stream > 1.05 * q_batch:
            raise AssertionError(f"{run.name}: {record['q_last_window']}")
        del x_win
    emit(record)
    xd = torch.from_numpy(chunks[-1]).to(device)
    return shape_entries(run.name,
                         stream_cases(run.name, xd, model, by_shape),
                         by_shape, DRIFT_D, cfg.m, device, 20, full=None)


def run_event_stream(chunks, seed, device, pin):
    """(c) the stationary prefix of (a), stamped (`stamp_source`, two
    chunks per bucket) and fed in order and through
    `out_of_order_source` with a skew below the allowed lateness: no
    record dropped, the watermark monotone, each run's objective on the
    prefix within 5 % of the other's.  Returns the kernel entries."""
    import numpy as np
    import torch
    from repro_torch.core.metrics import fuzzy_objective
    from repro_torch.data import out_of_order_source, stamp_source
    from repro_torch.kernels.fcm_update import reset_counts
    from repro_torch.stream import StreamConfig, StreamingBigFCM
    cfg = StreamConfig(n_clusters=DRIFT_C, m=2.0, seed=seed,
                       backend="hopper", **dict(EVENT_CFG))
    dt = cfg.slot_span / 2 / STREAM_ROWS
    record, q, entries = {"phase": "stream", "run": "drift_event"}, {}, []
    for order in ("in_order", "out_of_order"):
        src = stamp_source(iter(chunks), dt=dt)
        if order == "out_of_order":
            src = out_of_order_source(src, skew=EVENT_SKEW, seed=seed)
        model = StreamingBigFCM(cfg, device=device)
        srun = StreamRun("drift_event", model, pin, twin=False, scale=1.0)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reps = model.run(src)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        launches, by_shape, printed = stream_launches(
            f"drift_event/{order}", "drift_event")
        srun.close()
        wms = [r.watermark for r in reps]
        rec = stream_record(f"drift_event/{order}", srun, cfg,
                            len(chunks) * STREAM_ROWS, DRIFT_D, loop_s,
                            launches, printed)
        rec.pop("phase")
        rec.update({"late_dropped": int(model.state.late_dropped),
                    "watermark_monotone": all(
                        b >= a for a, b in zip(wms, wms[1:]))})
        record[order] = rec
        if rec["late_dropped"] or not rec["watermark_monotone"]:
            raise AssertionError(f"drift_event {order}: {rec}")
        xd = torch.from_numpy(np.concatenate(chunks)).to(device)
        q[order] = float(fuzzy_objective(xd, model.state.centers, cfg.m))
        del xd
        if order == "out_of_order":
            xb = torch.from_numpy(chunks[0]).to(device)
            entries = shape_entries(
                "drift_event",
                stream_cases("drift_event", xb, model, by_shape), by_shape,
                DRIFT_D, cfg.m, device, 20, full=None)
    record["q"] = q
    if not (q["out_of_order"] <= 1.05 * q["in_order"]
            and q["in_order"] <= 1.05 * q["out_of_order"]):
        raise AssertionError(f"drift_event: {record}")
    emit(record)
    return entries


def run_stream_path(kdd_x, seed, device, ckpt_dir) -> list:
    """The stream phase (module note, phase 6).  Returns kernel entries."""
    pin = DriverPin()
    try:
        entries = run_kdd99_stream(kdd_x, seed, device, ckpt_dir, pin)
        import torch
        torch.cuda.empty_cache()
        emit(run_live_serve(kdd_x, seed, device))
        torch.cuda.empty_cache()
        for run in DRIFT_RUNS:
            chunks = drift_chunks(run, seed)
            entries += run_drift_stream(run, chunks, seed, device, pin)
            if not run.drift_clusters:
                prefix = chunks[:run.drift_at]
            torch.cuda.empty_cache()
        entries += run_event_stream(prefix, seed, device, pin)
    finally:
        pin.close()
    return entries


# The calibrate phase: the perf plane on the card (module note, phase
# 2d).  Probe ladders big enough to reach an H100's roofs.
CALIB_STREAM_FLOATS = (1 << 24, 1 << 26)
CALIB_MATMUL_NS = (4096, 8192)
HOPPER_BACKENDS = ("hopper", "hopper_accumulate")


def calibrate_buckets() -> dict:
    """The (n, C, d) shapes whose buckets the main path resolves: the
    default bucket and each run's driver sample (router_fit's Parker–Hall
    sample is every row), single-model; the tenant cohorts' packed
    (T, N, C, d), tenant-stacked."""
    from repro_torch.core.sampling import parker_hall_sample_size
    from repro_torch.perf.calibrate import DEFAULT_SHAPE
    rc = router_config(0)
    router_n = min(ROUTER_N, parker_hall_sample_size(rc.n_clusters, rc.r,
                                                     rc.alpha))
    shapes = {"default": (DEFAULT_SHAPE, None)}
    for run in RUNS:
        shapes[f"{run.name} driver"] = ((min(SAMPLE_SIZE, run.n), run.c,
                                         run.d), None)
    shapes["router_fit driver"] = ((router_n, ROUTER_C, ROUTER_D), None)
    for run in TENANT_RUNS:
        shapes[run.name] = ((run.rows[1] - 1, run.c, run.d),
                            run.tenants)
    return shapes


def hold_tuned(cfg, shape, tenants, device) -> float:
    """Every plan of the search's grid at its tuned shape, launched and
    held against the plain version (rows in 1 GB chunks) at the sweep
    tolerances, whether it was timed or won or not; the chosen one rerun
    bit for bit."""
    import torch
    from repro_torch.kernels import fcm_update as fu
    from repro_torch.kernels.fcm_update import PlanChoice
    from repro_torch.perf import autotune
    tshape = tuple(cfg["tuned_shape"])
    x, w, v = autotune._tune_data(tshape, device, seed=1)
    if tenants is None:
        launch, plain = fu._launch, plain_in_rows(fu.fcm_accumulate_ref, True)
    else:
        launch = fu._launch_batched
        plain = plain_in_rows(fu.fcm_accumulate_batched_ref, True)
    want = plain(x, w, v, 2.0)
    err = 0.0
    for choice in autotune.choice_grid(cfg["plan"]["path"]):
        what = f"plan {choice} at {tshape}"
        got = launch(x, w, v, 2.0, True, choice)[0]
        err = max(err, max_err(got, want, RTOL, SWEEP_ATOL, what))
    choice = PlanChoice(**cfg["choice"])
    got = launch(x, w, v, 2.0, True, choice)[0]
    if not all(torch.equal(a, b) for a, b in zip(
            got, launch(x, w, v, 2.0, True, choice)[0])):
        raise AssertionError(f"tuned plan {choice}: two launches differ")
    del x, w, v, got, want
    torch.cuda.empty_cache()
    return err


def run_calibrate(device) -> dict:
    """Phase 2d: the perf plane on the card, in the calibration sandbox
    (``REPRO_CALIB_DIR``): the probed peaks beside the datasheet's; at
    each bucket of `calibrate_buckets` the backend race ("auto"'s
    winner, a kernel backend, each backend's µs and parity) and the
    launch-plan search (the untuned plan's card and synchronized-launch
    times, the chosen plan against it, every plan of the grid held
    against the plain version).
    The main path runs after it, on the chosen plans."""
    import os
    from repro_torch.perf import autotune, calibrate
    t0 = time.perf_counter()
    peaks = calibrate.cached_peaks(device=device,
                                   stream_floats=CALIB_STREAM_FLOATS,
                                   matmul_ns=CALIB_MATMUL_NS, iters=5)
    rec = {"phase": "calibrate", "dir": os.environ.get(calibrate.ENV_DIR),
           "peaks": peaks,
           "datasheet": {"stream_bytes_per_s": PEAK_BYTES_PER_S,
                         "matmul_f32_flops_per_s": PEAK_F32_FLOP_PER_S},
           "probed_over_datasheet": {
               "bytes": peaks["stream_bytes_per_s"] / PEAK_BYTES_PER_S,
               "f32": peaks["matmul_f32_flops_per_s"]
               / PEAK_F32_FLOP_PER_S},
           "probe_s": time.perf_counter() - t0, "races": {}, "tuned": {}}
    for label, (shape, tenants) in calibrate_buckets().items():
        if tenants is None:
            winner = calibrate.calibrated_backend_name(shape, device=device)
            key = calibrate.bucket_key(calibrate.shape_bucket(*shape))
            entry = calibrate.load_calibration(device=device)["winners"][key]
            # On the card "auto" must land on a hand-written kernel that
            # agrees with the oracle, at every bucket.
            if entry["errors"] or winner not in HOPPER_BACKENDS or not all(
                    entry["parity"][k] for k in HOPPER_BACKENDS + ("torch",)):
                raise AssertionError(f"race at {label}: {entry}")
            rec["races"][label] = {"shape": list(shape), "bucket": key,
                                   "winner": winner, **entry}
        t1 = time.perf_counter()
        cfg = autotune.tune_sweep_blocks(shape, tenants=tenants,
                                         device=device)
        rec["tuned"][label] = {
            "shape": list(shape), "tenants": tenants,
            "key": autotune.tile_key(shape, tenants), **cfg,
            "search_s": time.perf_counter() - t1,
            "max_abs_err": hold_tuned(cfg, shape, tenants, device)}
    rec["wall_s"] = time.perf_counter() - t0
    return rec


def roofline_record(n, c, d, x, w, v, m, device) -> dict:
    """`kernel_roofline` of ``hopper`` at a run's full shape on its own
    records (the probed peaks of the calibrate phase), with the analytic
    model held to `bound`: `sweep_bytes` is the same count of bytes;
    `sweep_flops` adds 2·N·d + 2·C·d + 14·N·C (norms, d² assembly,
    membership, reductions) to the bound's 4·N·C·d contractions."""
    from repro_torch.perf import calibrate, roofline
    row = roofline.kernel_roofline(
        "hopper", (n, c, d), peaks=calibrate.cached_peaks(device=device),
        m=m, iters=5, device=device, data=(x, w, v))
    model_bytes = roofline.sweep_bytes(n, c, d)
    if model_bytes != bound_bytes(n, d, c):
        raise AssertionError(f"sweep_bytes {model_bytes} != bound's "
                             f"{bound_bytes(n, d, c)}")
    flops = roofline.sweep_flops(n, c, d)
    return {**row, "sweep_bytes": model_bytes,
            "bound_bytes": bound_bytes(n, d, c), "sweep_flops": flops,
            "bound_flops": 4 * n * c * d,
            "flops_over_bound": flops / (4 * n * c * d),
            "flops_difference": "2Nd + 2Cd + 14NC: norms, d² assembly, "
                                "membership and reductions, which the "
                                "bound leaves out"}


# The serve phase: benchmarks/t14_serve.py's traffic (its request pool,
# :59-67: 40 distinct sizes, lognormal over 16-1024 rows; 1200 requests;
# 4096-row batches on a 64-base bucket ladder) at the KDD99-like fit's
# width (C = 23, d = 41, m = 1.2), its rows drawn from that array.
SERVE_SIZES, SERVE_REQS, SERVE_PER_REQ = 40, 1200, 240
SERVE_CLIENTS = (1, 4, 16)
SERVE_MAX_BATCH, SERVE_BASE = 4096, 64
SHED_QUEUE_ROWS, SHED_BURST, SHED_ROWS, SHED_CLIENTS = 4096, 8, 256, 32


def serve_pool(x_np, k, seed):
    """t14_serve.py's `_request_pool` sizes (k requests over 40 distinct
    row counts in [16, 1024], lognormal-ish), rows taken from ``x_np`` at
    random offsets."""
    import numpy as np
    rng = np.random.default_rng(seed)
    sizes = np.unique(np.clip(np.round(np.exp(rng.uniform(
        np.log(16), np.log(1024), SERVE_SIZES))), 16, 1024).astype(int))
    picks = rng.choice(sizes, size=k)
    starts = rng.integers(0, x_np.shape[0] - 1024, size=k)
    return [np.ascontiguousarray(x_np[s:s + int(n)])
            for s, n in zip(starts, picks)]


def quantiles_ms(values) -> dict:
    import numpy as np
    v = np.asarray(values, np.float64) * 1e3
    return {"n": int(v.size), "p50_ms": float(np.percentile(v, 50)),
            "p99_ms": float(np.percentile(v, 99))}


def span_buckets(name) -> dict:
    """p50/p99 of the ring's ``name`` spans per ``bucket`` field."""
    from repro_torch import obs
    by = collections.defaultdict(list)
    for ev in obs.ring_events():
        if ev.get("kind") == "span" and ev.get("name") == name:
            by[int(ev.get("bucket", ev.get("rows", 0)))].append(ev["dur_s"])
    return {str(b): quantiles_ms(v) for b, v in sorted(by.items())}


def replica_buckets(name) -> dict:
    from repro_torch import obs
    by = collections.defaultdict(set)
    for ev in obs.ring_events():
        if ev.get("kind") == "span" and ev.get("name") == name:
            by[ev.get("replica")].add(int(ev.get("bucket", ev["rows"])))
    return by


def closed_loop(svc, reqs, clients, score=None):
    """``clients`` threads each submitting and waiting for their slice of
    ``reqs`` in turn; returns (wall s, {index: result}, per-request e2e
    seconds, errors)."""
    import threading
    score = score or (lambda i: svc.score(reqs[i], timeout=300))
    results, e2e, errors = {}, {}, []

    def client(k):
        for i in range(k, len(reqs), clients):
            t0 = time.perf_counter()
            try:
                results[i] = score(i)
            except Exception as e:      # counted and raised below
                errors.append(e)
            e2e[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return time.perf_counter() - t0, results, list(e2e.values()), errors


def run_serve(x_np, centers, m, seed, device) -> dict:
    """Phase 5b: `ScoringService` over `Scorer` replicas on the card,
    at the KDD99-like fit's centers: closed-loop runs at 1, 4 and 16
    clients with 1 then 2 replicas (p50/p99 of ``span.serve.assign`` per
    bucket, of ``serve.request`` and of the clients' own submit-to-result
    times; records/s; each replica's shape count equal to the buckets it
    used), the ``coalesce=False`` ablation (240 requests at 16 clients),
    and the shed policy under bursts; every response held against
    `make_assigner` at its version (`label_ties`)."""
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.serve import (CenterSnapshot, Rejected, Scorer,
                                   ScoringService, ServiceConfig,
                                   make_assigner)
    reqs = serve_pool(x_np, SERVE_REQS, seed + 14)
    ref = make_assigner(centers, m=m, backend="hopper", device=device)
    cdev = torch.as_tensor(centers, device=device)
    want = [ref(r).cpu().numpy() for r in reqs]

    def fresh(n_rep, **kw):
        cfg = dict(max_batch_rows=SERVE_MAX_BATCH, bucket_base=SERVE_BASE)
        cfg.update(kw)
        return ScoringService(
            [Scorer(CenterSnapshot(0, centers), m=m, backend="hopper",
                    replica=f"r{i}", device=device) for i in range(n_rep)],
            ServiceConfig(**cfg))

    def hold(results, idx, what):
        ties = 0
        for i in idx:
            res = results[i]
            if res.version != 0:
                raise AssertionError(f"{what}: version {res.version}")
            ties += label_ties(res.assignments, want[i],
                               torch.from_numpy(reqs[i]).to(device), cdev)
        return ties

    obs.set_ring_size(1 << 16)
    rec = {"phase": "serve", "run": "kdd99_like", "c": int(centers.shape[0]),
           "d": int(centers.shape[1]), "m": m, "requests": SERVE_REQS,
           "sizes": sorted({int(r.shape[0]) for r in reqs}),
           "max_batch_rows": SERVE_MAX_BATCH, "bucket_base": SERVE_BASE,
           "runs": []}
    with fresh(1) as warm:                 # every bucket once
        for b in warm.buckets:
            warm.score(np.asarray(x_np[:b]), timeout=300)
    for n_rep in (1, 2):
        for clients in SERVE_CLIENTS:
            svc = fresh(n_rep)
            obs.reset_all()
            wall, results, e2e, errors = closed_loop(svc, reqs, clients)
            svc.close()
            if errors or len(results) != len(reqs):
                raise AssertionError(f"serve: {errors[:3]}")
            snap = obs.metrics_snapshot()
            req_h = snap["histograms"]["serve.request"]
            used = replica_buckets("serve.assign")
            counts = svc.compile_counts()
            if any(counts[r] != len(used.get(r, ())) for r in counts):
                raise AssertionError(f"serve: shapes {counts} for buckets "
                                     f"{dict(used)}")
            rows = sum(int(r.shape[0]) for r in reqs)
            rec["runs"].append({
                "replicas": n_rep, "clients": clients, "wall_s": wall,
                "records_per_s": rows / wall,
                "requests_per_s": len(reqs) / wall,
                "assign_by_bucket": span_buckets("serve.assign"),
                "serve_request": {"p50_ms": req_h["p50"] * 1e3,
                                  "p99_ms": req_h["p99"] * 1e3,
                                  "count": req_h["count"]},
                "client_e2e": quantiles_ms(e2e),
                "dispatches": int(sum(
                    v for k, v in snap["counters"].items()
                    if k.startswith("serve.batches"))),
                "shape_counts": counts,
                "buckets_used": {k: sorted(v) for k, v in used.items()},
                "ties_differing": hold(results, range(len(reqs)),
                                       f"{n_rep} replicas, {clients} "
                                       "clients")})
    # -- the coalesce=False ablation: one request, one dispatch
    svc = fresh(1, coalesce=False)
    obs.reset_all()
    sub = list(range(SERVE_PER_REQ))
    wall, results, e2e, errors = closed_loop(
        svc, reqs[:SERVE_PER_REQ], SERVE_CLIENTS[-1])
    svc.close()
    if errors:
        raise AssertionError(f"serve ablation: {errors[:3]}")
    rows = sum(int(reqs[i].shape[0]) for i in sub)
    rec["per_request"] = {
        "requests": SERVE_PER_REQ, "clients": SERVE_CLIENTS[-1],
        "wall_s": wall, "records_per_s": rows / wall,
        "assign_by_rows": span_buckets("serve.assign"),
        "client_e2e": quantiles_ms(e2e),
        "shape_counts": svc.compile_counts(),
        "ties_differing": hold(results, sub, "coalesce=False")}
    same = [r for r in rec["runs"] if r["replicas"] == 1
            and r["clients"] == SERVE_CLIENTS[-1]][0]
    rec["coalesced_over_per_request"] = (same["records_per_s"]
                                         / rec["per_request"]["records_per_s"])
    # -- the shed policy: bursts of 8 x 256 rows from 32 clients against
    #    a 4096-row queue; every rejection typed, the queue bounded
    svc = fresh(1, queue_rows=SHED_QUEUE_ROWS, policy="shed")
    obs.reset_all()
    burst = np.ascontiguousarray(x_np[:SHED_ROWS])
    outcomes = collections.Counter()

    def burst_client(i):
        futs = []
        for _ in range(SHED_BURST):
            try:
                futs.append(svc.submit(burst))
            except Rejected as e:
                if e.limit_rows != SHED_QUEUE_ROWS:
                    raise
                outcomes["shed"] += 1
        for f in futs:
            f.result(300)
            outcomes["served"] += 1
        return len(futs)

    wall, _, _, errors = closed_loop(svc, list(range(SHED_CLIENTS * 4)),
                                     SHED_CLIENTS, score=burst_client)
    svc.close()
    if errors:
        raise AssertionError(f"shed: untyped failures {errors[:3]}")
    q_max = obs.gauge("serve.queue_rows").max
    if q_max > SHED_QUEUE_ROWS or obs.counter("serve.shed").value != \
            outcomes["shed"]:
        raise AssertionError(f"shed: queue rows reached {q_max}, "
                             f"{dict(outcomes)}")
    rec["shed"] = {"queue_rows": SHED_QUEUE_ROWS, "burst": SHED_BURST,
                   "rows": SHED_ROWS, "clients": SHED_CLIENTS,
                   "submitted": SHED_CLIENTS * 4 * SHED_BURST,
                   **dict(outcomes), "queue_rows_max": q_max,
                   "wall_s": wall,
                   "assign_by_bucket": span_buckets("serve.assign")}
    obs.reset_all()
    obs.set_ring_size(obs.trace._ring_size())
    return rec


def run_live_serve(x_np, seed, device) -> dict:
    """The live path of the stream phase: a fresh ``kdd99_stream`` model
    (`StreamConfig` as `run_kdd99_stream`'s) wired through
    ``add_snapshot_listener(publisher.publish)`` to a `SnapshotPublisher`
    whose replicas serve a `ScoringService` (two replicas).  Each batch
    is submitted in 4096-row requests, then the next batch is ingested
    while they are scored (a publish mid-traffic); every response's
    version must be a published one and its labels that version's
    `make_assigner` labels, up to ties."""
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.data import replay_source
    from repro_torch.serve import (CenterSnapshot, Scorer, ScoringService,
                                   ServiceConfig, SnapshotPublisher,
                                   make_assigner)
    from repro_torch.stream import StreamConfig, StreamingBigFCM
    n, d = x_np.shape
    cfg = StreamConfig(n_clusters=23, m=1.2, seed=seed, backend="hopper")
    model = StreamingBigFCM(cfg, device=device)
    svc = ScoringService(
        [Scorer(CenterSnapshot(-1, np.zeros((1, d), np.float32)), m=cfg.m,
                backend="hopper", replica=f"live{i}", device=device)
         for i in range(2)],
        ServiceConfig(max_batch_rows=SERVE_MAX_BATCH, bucket_base=SERVE_BASE))
    published = {}
    model.add_snapshot_listener(
        lambda v, c, w: published.__setitem__(int(v), c.copy()))
    pub = SnapshotPublisher(svc.scorers)
    model.add_snapshot_listener(pub.publish)
    obs.reset_all()
    obs.set_ring_size(1 << 16)
    pending, versions, ties, rows = [], collections.Counter(), 0, 0
    t0 = time.perf_counter()

    def drain(batch):
        nonlocal ties, rows
        for x, fut in batch:
            res = fut.result(300)
            if res.version not in published:
                raise AssertionError(f"live: version {res.version} was "
                                     "never published")
            versions[res.version] += 1
            c = torch.as_tensor(published[res.version], device=device)
            want = make_assigner(c, m=cfg.m, backend="hopper",
                                 device=device)(x).cpu().numpy()
            ties += label_ties(res.assignments, want,
                               torch.from_numpy(x).to(device), c)
            rows += x.shape[0]

    for chunk in replay_source(x_np, STREAM_ROWS):
        model.ingest(chunk)                # publishes while `pending` runs
        drain(pending)
        pending = [(r, svc.submit(r)) for r in
                   (np.ascontiguousarray(chunk[i:i + SERVE_MAX_BATCH])
                    for i in range(0, chunk.shape[0], SERVE_MAX_BATCH))]
    drain(pending)
    wall = time.perf_counter() - t0
    svc.close()
    steps = int(model.state.step)
    if rows != n or len(published) != steps:
        raise AssertionError(f"live: {rows} rows scored, {len(published)} "
                             f"versions for {steps} ingests")
    rec = {"phase": "stream", "run": "kdd99_live", "ingests": steps,
           "rows_scored": rows, "wall_s": wall,
           "versions_answered": len(versions),
           "responses_on_older_version": sum(
               v for k, v in versions.items() if k < max(versions)),
           "ties_differing": ties,
           "assign_by_bucket": span_buckets("serve.assign"),
           "snapshots": obs.counter("serve.snapshots").value}
    obs.reset_all()
    obs.set_ring_size(obs.trace._ring_size())
    return rec


# The tenant service: benchmarks/t16_tenant.py's widths over
# tenants_65k's fitted fleet; requests of 8-64 rows from 4096 random
# tenants, one firehose tenant sending half of all rows.
TENANT_SVC_TENANTS, TENANT_SVC_ROWS, TENANT_SVC_CAP = 4096, (8, 65), 512
TENANT_SVC_CLIENTS, TENANT_FIREHOSE_ROWS = 16, 64


class FirehoseCounter:
    """Wraps a `TenantScorer`'s ``score`` to count, per dispatch, the
    real rows (phantom padding rows are exact zeros) and the firehose
    tenant's."""

    def __init__(self, scorer, fire_row):
        self.fire_row, self.shares = fire_row, []
        inner = scorer.score

        def score(x, tidx, snap=None):
            import numpy as np
            real = np.asarray(x).any(1)
            self.shares.append((int(real.sum()),
                                int((real & (np.asarray(tidx)
                                             == fire_row)).sum())))
            return inner(x, tidx, snap)
        scorer.score = score


def run_tenant_service(ts, refit, seed, device) -> dict:
    """`TenantScoringService` over the fitted fleet (version 1) with a
    swap to the refit fleet (version 2) when half the requests are
    answered: each response's version must be its tenant's in one of the
    two fleets and its labels that fleet's, up to ties; p50/p99 of
    ``span.tenant.assign`` per bucket, and the firehose tenant's rows
    per dispatch (capped at ``max_group_rows``)."""
    import threading
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.serve import (ServiceConfig, TenantScorer,
                                   TenantScoringService, tenant_snapshot)
    rng = np.random.default_rng(seed + 16)
    fleets = {1: ts._replace(versions=np.full(ts.n_tenants, 1, np.int64)),
              2: refit._replace(versions=np.full(ts.n_tenants, 2, np.int64))}
    snaps = {v: tenant_snapshot(f, device) for v, f in fleets.items()}
    quiet = rng.choice(np.arange(1, ts.n_tenants), TENANT_SVC_TENANTS,
                       replace=False)
    fire = int(rng.integers(1, ts.n_tenants))
    reqs = [(int(t), int(rng.integers(*TENANT_SVC_ROWS))) for t in quiet]
    quiet_rows = sum(k for _, k in reqs)
    reqs += [(fire, TENANT_FIREHOSE_ROWS)] * (quiet_rows
                                              // TENANT_FIREHOSE_ROWS)
    order = rng.permutation(len(reqs))
    reqs = [reqs[i] for i in order]
    d = ts.centers.shape[2]
    xs = [(rng.normal(size=(k, d)) + 4.0 * (t % 5)).astype(np.float32)
          for t, k in reqs]
    tidx = np.concatenate([np.full(k, t) for t, k in reqs])
    x_all = torch.from_numpy(np.concatenate(xs)).to(device)
    want = {v: TenantScorer(s, device=device).score(x_all, tidx).cpu().numpy()
            for v, s in snaps.items()}
    offs = np.concatenate([[0], np.cumsum([k for _, k in reqs])])
    scorer = TenantScorer(snaps[1], device=device)
    counter = FirehoseCounter(scorer, fire)
    svc = TenantScoringService(scorer, ServiceConfig(
        max_batch_rows=SERVE_MAX_BATCH, bucket_base=SERVE_BASE,
        max_group_rows=TENANT_SVC_CAP))
    obs.reset_all()
    obs.set_ring_size(1 << 16)
    answered, half = [0], threading.Event()

    def score(i):
        res = svc.score(str(fleets[1].ids[reqs[i][0]]), xs[i], timeout=300)
        answered[0] += 1
        if answered[0] >= len(reqs) // 2:
            half.set()
        return res

    def swapper():
        half.wait(300)
        svc.swap(snaps[2])

    th = threading.Thread(target=swapper)
    th.start()
    wall, results, e2e, errors = closed_loop(svc, reqs, TENANT_SVC_CLIENTS,
                                             score=score)
    th.join()
    svc.close()
    if errors or len(results) != len(reqs):
        raise AssertionError(f"tenant service: {errors[:3]}")
    versions, ties = collections.Counter(), 0
    for i, res in results.items():
        if res.version not in want:
            raise AssertionError(f"tenant service: version {res.version}")
        versions[res.version] += 1
        sl = slice(offs[i], offs[i + 1])
        got, exp = res.assignments, want[res.version][sl]
        bad = np.flatnonzero(got != exp)
        if bad.size:
            c = fleets[res.version].centers[reqs[i][0]]
            d2 = ((xs[i][bad, None, :] - c[None]) ** 2).sum(-1)
            r = np.arange(bad.size)
            ga, wa = d2[r, got[bad]], d2[r, exp[bad]]
            if np.any(np.abs(ga - wa) > 1e-6 * np.maximum(ga, wa)):
                raise AssertionError("tenant service: labels differ beyond "
                                     "a tie")
            ties += int(bad.size)
    shares = [(r, f) for r, f in counter.shares if r]
    fire_rows = [f for _, f in shares]
    if max(fire_rows) > TENANT_SVC_CAP or versions[2] == 0:
        raise AssertionError(f"tenant service: firehose rows {max(fire_rows)}"
                             f" in a dispatch, versions {dict(versions)}")
    frac = [f / r for r, f in shares]
    rec = {"tenants": ts.n_tenants, "quiet_tenants": TENANT_SVC_TENANTS,
           "requests": len(reqs), "rows": int(offs[-1]),
           "firehose_rows": int(sum(k for t, k in reqs if t == fire)),
           "max_group_rows": TENANT_SVC_CAP, "clients": TENANT_SVC_CLIENTS,
           "wall_s": wall, "records_per_s": int(offs[-1]) / wall,
           "responses_by_version": dict(versions),
           "labels_differing_between_fleets": int(
               (want[1] != want[2]).sum()),
           "ties_differing": ties, "dispatches": len(shares),
           "firehose_share_per_dispatch": {
               "min": float(min(frac)), "p50": float(np.median(frac)),
               "max": float(max(frac)), "max_rows": int(max(fire_rows))},
           "assign_by_bucket": span_buckets("tenant.assign"),
           "client_e2e": quantiles_ms(e2e),
           "shape_count": scorer.traces}
    obs.reset_all()
    obs.set_ring_size(obs.trace._ring_size())
    return rec


# --------------------------------------------------------------- mesh ---

# The mesh phase: `bigfcm_fit` on a `repro_torch.mesh` device mesh of
# spawned ranks.  (i) the HIGGS-like fit on a flat (4,) ("data",) mesh,
# (ii) the KDD99-like fit, padded with one zero-weight phantom row to
# 4,898,432 rows, on a (2, 2) ("pod", "data") mesh with the hierarchical
# reducer: 4 gloo ranks sharing the card (NCCL refuses two ranks on one
# GPU).  Then NCCL at `torch.cuda.device_count()` ranks.
MESH_RUNS = {"higgs_like": ((4,), ("data",), False),
             "kdd99_like": ((2, 2), ("pod", "data"), True)}
MESH_JOBS = 20                     # MR-FKM / Mahout-KM job cap
MESH_DEADLINE_S = 600.0
MESH_LOADER_ROWS, MESH_LOADER_BATCH = 100_000, 32_768
EXPECTED_PATH.update({"mesh_higgs_like": "rows", "mesh_kdd99_like": "tile"})


class DriverTap:
    """Wraps `repro_torch.core.bigfcm.run_driver`: the race runs (on the
    mesh's rank 0) and its centers and flag are kept; `pin` then hands a
    later fit those centers and that flag without a race."""

    def __init__(self):
        from repro_torch.core import bigfcm
        self.module, self.real = bigfcm, bigfcm.run_driver
        self.out = None
        bigfcm.run_driver = self

    def __call__(self, x_sample, cfg, *, seed_idx, device):
        if self.out is not None:
            return self.out
        out = self.real(x_sample, cfg, seed_idx=seed_idx, device=device)
        self.out = (out[0].clone(), bool(out[1]), 0.0, 0.0)
        return out

    def close(self):
        self.module.run_driver = self.real


def mesh_fit(x, w, cfg, mesh, axes, device):
    """One mesh fit on this rank, launch counts and the obs counters
    zeroed just before it and read just after: its result and what this
    rank spent."""
    import torch
    from repro_torch import obs
    from repro_torch.core import bigfcm_fit
    from repro_torch.device import synchronize
    from repro_torch.kernels.fcm_update import (fcm_accumulate_cuda,
                                                fcm_sweep_cuda, reset_counts)
    obs.reset_metrics()
    reset_counts()
    torch.cuda.reset_peak_memory_stats(device)
    synchronize(device)
    t0 = time.perf_counter()
    res = bigfcm_fit(x, cfg, mesh=mesh, data_axes=axes, point_weights=w)
    q = float(res.objective)
    synchronize(device)
    wall = time.perf_counter() - t0
    return res, {
        "wall_s": wall, "q": q, "flag": res.diagnostics.flag,
        "combiner_iters": list(res.diagnostics.combiner_iters),
        "reducer_iters": res.diagnostics.reducer_iters,
        "launches": {"fcm_sweep": fcm_sweep_cuda.launches,
                     "fcm_accumulate": fcm_accumulate_cuda.launches},
        "shapes": {"fcm_sweep": dict(fcm_sweep_cuda.shapes),
                   "fcm_accumulate": dict(fcm_accumulate_cuda.shapes)},
        "collective_s": obs.counter("mesh.collective_s").value,
        "gathered_bytes": obs.counter("mesh.gathered_bytes").value,
        "peak_bytes": torch.cuda.max_memory_allocated(device)}


def mesh_load(paths):
    """A run's saved array and weights, memory-mapped."""
    import numpy as np
    x_path, w_path = paths
    return (np.load(x_path, mmap_mode="r"),
            None if w_path is None else np.load(w_path, mmap_mode="r"))


def mesh_rank_job(mesh, arrays, cfgs, stack):
    """Phase (i)–(iv) on one of the 4 gloo ranks (module-level: spawned
    ranks import it)."""
    import dataclasses as dc
    import torch
    from repro_torch.baselines import mr_fuzzy_kmeans, mr_kmeans
    from repro_torch.core import bigfcm_fit
    from repro_torch.engine import Summary
    from repro_torch.fleet import mesh_exchange
    from repro_torch.mesh import make_mesh, rank_device
    dev = rank_device(mesh)
    out = {"runs": {}}
    for name, (shape, names, hier) in MESH_RUNS.items():
        x, w = mesh_load(arrays[name])
        m = mesh if shape == (4,) else make_mesh(shape, names)
        cfg = dc.replace(cfgs[name], hierarchical=hier)
        # a warm-up fit (the process's first launches, library loads),
        # as the main path's fits run in a warm process
        bigfcm_fit(x, cfg, mesh=m, data_axes=names, point_weights=w)
        tap = DriverTap()
        try:
            res, rec = mesh_fit(x, w, cfg, m, names, dev)
            # the same mesh fit through the torch backend, from the
            # centers and branch the race kept (rank 0 ran it)
            t_res, t_rec = mesh_fit(x, w, dc.replace(cfg, backend="torch"),
                                    m, names, dev)
        finally:
            tap.close()
        rec.update(centers=res.centers.cpu(), masses=res.center_weights.cpu(),
                   v_init=None if tap.out is None else tap.out[0].cpu(),
                   torch={"centers": t_res.centers.cpu(), "q": t_rec["q"],
                          "combiner_iters": t_rec["combiner_iters"],
                          "reducer_iters": t_rec["reducer_iters"],
                          "wall_s": t_rec["wall_s"]})
        out["runs"][name] = rec
        del res, t_res
        torch.cuda.empty_cache()
    # (iii) the per-iteration-job baselines over (i)'s mesh
    x, _ = mesh_load(arrays["higgs_like"])
    init = torch.from_numpy(x[:cfgs["higgs_like"].n_clusters].copy())
    fkm, jobs, fkm_s = mr_fuzzy_kmeans(x, init, m=cfgs["higgs_like"].m,
                                       eps=cfgs["higgs_like"].combiner_eps,
                                       max_iter=MESH_JOBS, mesh=mesh,
                                       backend="hopper")
    km = mr_kmeans(x, init, max_iter=MESH_JOBS, mesh=mesh)
    out["fkm"] = {"centers": fkm.centers.cpu(), "jobs": jobs, "s": fkm_s}
    out["km"] = {"centers": km[0].cpu(), "counts": km[1].cpu(),
                 "jobs": km[3], "s": km[4]}
    # (iv) the stack through the exchange, each rank casting its own slot
    stacked = Summary(*(torch.from_numpy(a) for a in stack))
    out["exchange"] = {wire: mesh_exchange(stacked, mesh, backend="hopper",
                                           wire_dtype=wire).centers.cpu()
                       for wire in ("f32", "bf16")}
    return out


def mesh_nccl_job(mesh, arrays, cfgs, stack, fit_only):
    """Phase (v) on one NCCL rank: the exchange, MR-FKM and the loader
    over NCCL, and the HIGGS-like fit on the (P,) mesh."""
    import torch
    from repro_torch.baselines import mr_fuzzy_kmeans
    from repro_torch.data import ShardedLoader
    from repro_torch.engine import Summary
    from repro_torch.fleet import mesh_exchange
    from repro_torch.mesh import mesh_size, rank_device
    dev = rank_device(mesh)
    x, w = mesh_load(arrays["higgs_like"])
    cfg = cfgs["higgs_like"]
    tap = DriverTap()
    try:
        res, rec = mesh_fit(x, w, cfg, mesh, ("data",), dev)
    finally:
        tap.close()
    rec.update(centers=res.centers.cpu(), masses=res.center_weights.cpu(),
               v_init=None if tap.out is None else tap.out[0].cpu())
    out = {"fit": rec}
    if fit_only:
        return out
    p = mesh_size(mesh)
    stacked = Summary(*(torch.from_numpy(a[:p]) for a in stack))
    out["exchange"] = mesh_exchange(stacked, mesh,
                                    backend="hopper").centers.cpu()
    init = torch.from_numpy(x[:cfg.n_clusters].copy())
    fkm, jobs, _ = mr_fuzzy_kmeans(x, init, m=cfg.m, eps=cfg.combiner_eps,
                                   max_iter=MESH_JOBS, mesh=mesh,
                                   backend="hopper")
    out["fkm"] = {"centers": fkm.centers.cpu(), "jobs": jobs}
    rows = MESH_LOADER_ROWS - MESH_LOADER_ROWS % p
    out["loader"] = [(bx.cpu(), bw.cpu()) for bx, bw in ShardedLoader(
        x[:rows], MESH_LOADER_BATCH, mesh=mesh, cache=False)]
    return out


def mesh_blocks(x, w, p, device) -> list:
    """The ``P(("data",))`` row blocks of a host array (and its weights)
    on the card, in rank order."""
    import numpy as np
    import torch
    per = x.shape[0] // p
    out = []
    for r in range(p):
        xb = torch.tensor(np.asarray(x[r * per:(r + 1) * per]),
                          device=device)
        wb = (torch.ones((per,), dtype=xb.dtype, device=device) if w is None
              else torch.tensor(np.asarray(w[r * per:(r + 1) * per]),
                                device=device))
        out.append((xb, wb))
    return out


def combine_blocks(blocks, v_init, flag, cfg, backend, device) -> list:
    """One combiner per block from the broadcast seeds (FCM if the race
    kept FCM, else WFCMPB), through ``backend``."""
    from repro_torch.core import fcm, wfcmpb
    kw = dict(m=cfg.m, eps=cfg.combiner_eps, max_iter=cfg.max_iter,
              backend=backend, device=device)
    return [fcm(xb, v_init, point_weights=wb, **kw) if flag else
            wfcmpb(xb, v_init, block_size=cfg.block_size, point_weights=wb,
                   **kw) for xb, wb in blocks]


def reduce_blocks(sums, cfg, shape, names, backend):
    """The reducer plan over the combiners' summaries as rank 0 runs it:
    once over the stack, or per hierarchy level (its pod's merge seeded
    with its own centers, each pod's data-0 rank likewise, then across
    pods seeded with its own mid-level centers)."""
    import torch
    from repro_torch.engine import Summary, merge_summaries
    plan = cfg.reducer_plan()

    def merge(part, init):
        return merge_summaries(
            Summary(torch.stack([s.centers for s in part]),
                    torch.stack([s.masses for s in part])),
            plan, backend=backend, init=init)

    if not (cfg.hierarchical and "pod" in names):
        return merge(sums, None)
    n_data = shape[names.index("data")]
    mids = [merge(sums[pd * n_data:(pd + 1) * n_data],
                  sums[pd * n_data].centers).summary
            for pd in range(shape[names.index("pod")])]
    return merge(mids, mids[0].centers)


def global_q(blocks, centers, m, backend) -> float:
    """K1's q of ``centers`` on each block, added in rank order."""
    from repro_torch.engine import get_backend
    from repro_torch.mesh import sum_in_order
    be = get_backend(backend)
    return float(sum_in_order([be.accumulate(xb, wb, centers, m)[2]
                               for xb, wb in blocks]))


def summaries(fits) -> list:
    from repro_torch.engine import Summary
    return [Summary(f.centers, f.center_weights) for f in fits]


def compose_fit(blocks, cfg, shape, names, v_init, flag, device):
    """The mesh fit composed in this process on one card from the port's
    single-device functions on the same blocks, from the broadcast seeds:
    one combiner per block, the stacked summaries through
    `merge_summaries` (per hierarchy level as rank 0 runs them), q summed
    in rank order.  Returns ((centers, masses, q, combiner sweeps,
    reducer sweeps), the combiners)."""
    locs = combine_blocks(blocks, v_init, flag, cfg, cfg.backend, device)
    red = reduce_blocks(summaries(locs), cfg, shape, names, cfg.backend)
    centers = red.summary.centers
    return ((centers, red.summary.masses,
             global_q(blocks, centers, cfg.m, cfg.backend),
             [lo.n_iter for lo in locs], red.n_iter), locs)


def hold_stages(blocks, locs, want, cfg, shape, names, v_init, flag, scale,
                device) -> dict:
    """The mesh fit against the ``torch`` backend stage by stage, each
    stage from the same inputs: the combiners from the broadcast seeds,
    the reducer over the kernel combiners' summaries, the global q of the
    kernel fit's centers; at the main path's bars (centers 1e-3 of the
    data's RMS, q 1e-4, sweeps ±2).  The reducer is held only where it is
    fixed at f32: where the same reducer over the summaries scaled by
    1 + 2⁻²² (K2 again) lands within those bars of the unscaled one;
    otherwise its gap to ``torch`` is printed beside the nudge's."""
    centers, _, q, iters, r_it = want
    t_locs = combine_blocks(blocks, v_init, flag, cfg, "torch", device)
    comb = {"center_err_rel_rms": max(
        float((a.centers - b.centers).abs().max())
        for a, b in zip(locs, t_locs)) / scale,
        "iters": [iters, [lo.n_iter for lo in t_locs]]}
    sums = summaries(locs)
    t_red = reduce_blocks(sums, cfg, shape, names, "torch")
    nudge = 1 + 2.0 ** -22
    n_red = reduce_blocks([s._replace(centers=s.centers * nudge)
                           for s in sums], cfg, shape, names, cfg.backend)
    red = {"center_err_rel_rms": float(
        (t_red.summary.centers - centers).abs().max()) / scale,
        "iters": [r_it, t_red.n_iter],
        "nudged_center_err_rel_rms": float(
            (n_red.summary.centers / nudge - centers).abs().max()) / scale,
        "nudged_iters": n_red.n_iter}
    red["fixed_at_f32"] = (red["nudged_center_err_rel_rms"] <= 1e-3
                           and abs(n_red.n_iter - r_it) <= 2)
    q_t = global_q(blocks, centers, cfg.m, "torch")
    rec = {"combiners": comb, "reducer": red, "q_rel": abs(q - q_t) / abs(q_t)}
    if (comb["center_err_rel_rms"] > 1e-3 or any(
            abs(a - b) > 2 for a, b in zip(*comb["iters"]))
            or rec["q_rel"] > 1e-4 or (red["fixed_at_f32"] and (
                red["center_err_rel_rms"] > 1e-3
                or abs(t_red.n_iter - r_it) > 2))):
        raise AssertionError(f"mesh stages vs torch: {rec}")
    return rec


def hold_bits(got, want, what) -> None:
    """A mesh fit's result equal bit for bit to the composition's."""
    import torch
    centers, masses, q, iters, r_it = want
    same = {"centers": torch.equal(got["centers"], centers.cpu()),
            "masses": torch.equal(got["masses"], masses.cpu()),
            "q": got["q"] == q, "combiner_iters": got["combiner_iters"] == iters,
            "reducer_iters": got["reducer_iters"] == r_it}
    if not all(same.values()):
        raise AssertionError(f"{what}: not bit-identical to the composition "
                             f"in one process: {same}")


def mesh_rank_lines(phase, ranks, key) -> list:
    """What each rank spent on one run (one printed line each)."""
    return [{"phase": phase, "rank": rank, "run": key,
             **{k: r[k] for k in ("wall_s", "combiner_iters", "launches",
                                  "collective_s", "gathered_bytes",
                                  "peak_bytes")},
             "launches_by_shape": {k: {" ".join([s[0], "x".join(
                 map(str, s[1:]))]): v for s, v in sorted(
                     shapes.items(), key=str)}
                 for k, shapes in r["shapes"].items()}}
            for rank, r in enumerate(ranks)]


def mesh_entries(run, name, x, w, centers, ranks, device) -> list:
    """The mesh run's kernel entries: launches summed over the ranks (each
    checked against the run's expected path), each kernel held against
    its plain version and timed at the block shape and at every other
    size the ranks launched it at (their first records)."""
    import numpy as np
    import torch
    by_shape = {k: collections.Counter() for k in ("fcm_sweep",
                                                   "fcm_accumulate")}
    for r in ranks:
        for k, shapes in r["shapes"].items():
            by_shape[k].update(shapes)
    off = {k: v for shapes in by_shape.values() for k, v in shapes.items()
           if k[0] != EXPECTED_PATH[name]}
    if off:
        raise AssertionError(f"{name}: launches off the expected "
                             f"{EXPECTED_PATH[name]!r} path: {off}")
    per = x.shape[0] // len(ranks)
    xb = torch.tensor(np.asarray(x[:per]), device=device)
    wb = (torch.ones((per,), device=device) if w is None
          else torch.tensor(np.asarray(w[:per]), device=device))
    v = centers.to(device)
    cases = {"full": (xb, wb, v, 0.0)}
    for ns in sorted({k[1] for shapes in by_shape.values() for k in shapes}
                     - {per}):
        cases[f"n={ns}"] = (xb[:ns], wb[:ns], v,
                            q_rounding_bound(xb[:ns], wb[:ns], v))
    return shape_entries(name, cases, by_shape, x.shape[1], run.m, device,
                         reps=10)


def start_mesh_path(held_x: dict, cfgs: dict, seed: int, mesh_dir: Path):
    """The mesh phase's arrays saved under ``mesh_dir`` and its ranks
    spawned ahead (`spawn_ahead`): the 4 gloo ranks and each NCCL world,
    held until `run_mesh_path` → its handle."""
    import numpy as np
    import torch
    t0 = time.perf_counter()
    arrays = {}
    for name, x in held_x.items():
        w = None
        if x.shape[0] % 4:              # pad with zero-weight phantom rows
            pad = 4 - x.shape[0] % 4
            x = np.concatenate([x, np.zeros((pad, x.shape[1]), x.dtype)])
            w = np.ones((x.shape[0],), np.float32)
            w[-pad:] = 0.0
            np.save(mesh_dir / f"{name}_w.npy", w)
        np.save(mesh_dir / f"{name}.npy", x)
        arrays[name] = (str(mesh_dir / f"{name}.npy"),
                        None if w is None else str(mesh_dir / f"{name}_w.npy"))
    rng = np.random.default_rng(seed)
    stack = (rng.normal(scale=5.0, size=(4, 23, 41)).astype(np.float32),
             rng.uniform(0.5, 2.0, size=(4, 23)).astype(np.float32))
    setup_s = time.perf_counter() - t0
    # NCCL at the card count (with 2-4 cards its HIGGS-like fit is (i)
    # again over NCCL; past 4 cards, (i) runs again at 4 ranks)
    count = torch.cuda.device_count()
    worlds = [(count, False)] + ([(4, True)] if count > 4 else [])
    return {"arrays": arrays, "stack": stack, "setup_s": setup_s,
            "gloo": spawn_ahead(str(mesh_dir / "go_gloo"), mesh_rank_job,
                                (4,), ("data",), MESH_DEADLINE_S,
                                args=(arrays, cfgs, stack), backend="gloo"),
            "nccl": [(p, fit_only, spawn_ahead(
                str(mesh_dir / f"go_nccl_{p}"), mesh_nccl_job, (p,),
                ("data",), MESH_DEADLINE_S,
                args=(arrays, cfgs, stack, fit_only), backend="nccl"))
                for p, fit_only in worlds]}


def run_mesh_path(started: dict, cfgs: dict, device) -> list:
    """The mesh phase (module note, 7) on the ranks `start_mesh_path`
    spawned (``started``): returns its kernel entries."""
    import dataclasses as dc
    import numpy as np
    import torch
    from repro_torch.baselines import mr_fuzzy_kmeans, mr_kmeans
    from repro_torch.core import bigfcm_fit
    from repro_torch.data.plane import batched
    from repro_torch.engine import MergePlan, Summary, merge_summaries
    from repro_torch.fleet import BF16_REL_BOUND
    t_phase = time.perf_counter()
    arrays, stack = started["arrays"], started["stack"]
    ranks, gloo_s, gloo_ahead_s = join_spawn(started["gloo"])
    entries, records = [], []
    for name, (shape, names, hier) in MESH_RUNS.items():
        x, w = mesh_load(arrays[name])
        got = [r["runs"][name] for r in ranks]
        cfg = dc.replace(cfgs[name], hierarchical=hier)
        for r in got[1:]:
            for k in ("centers", "masses"):
                if not torch.equal(r[k], got[0][k]):
                    raise AssertionError(f"mesh {name}: ranks differ ({k})")
        v_init, flag = got[0]["v_init"].to(device), got[0]["flag"]
        blocks = mesh_blocks(x, w, 4, device)
        want, locs = compose_fit(blocks, cfg, shape, names, v_init, flag,
                                 device)
        hold_bits(got[0], want, f"mesh {name}")
        scale = float(np.sqrt(np.mean(np.square(
            x[:1_000_000].astype(np.float64)))))
        stages = hold_stages(blocks, locs, want, cfg, shape, names, v_init,
                             flag, scale, device)
        del blocks, locs
        # the whole mesh fit through `torch` (the ranks' second fit, from
        # the race's centers and branch): held where the reducer is fixed
        # at f32, printed where a 1 + 2^-22 nudge moves it past the bars
        t = got[0]["torch"]
        free = ((got[0]["centers"], got[0]["q"],
                 (*got[0]["combiner_iters"], got[0]["reducer_iters"])),
                (t["centers"], t["q"], (*t["combiner_iters"],
                                        t["reducer_iters"])))
        if stages["reducer"]["fixed_at_f32"]:
            vs_torch = hold_fit(*free, scale, f"mesh {name} hopper vs torch")
        else:
            (va, qa, ia), (vb, qb, ib) = free
            vs_torch = {"center_err_rel_rms": float((va - vb).abs().max())
                        / scale, "q_rel": abs(qa - qb) / abs(qb),
                        "iters": [ia, ib], "held": False}
        if not (bool(torch.isfinite(got[0]["centers"]).all())
                and math.isfinite(got[0]["q"])):
            raise AssertionError(f"mesh {name}: non-finite output")
        run = next(r for r in RUNS if r.name == name)
        records.append({
            "phase": "mesh", "run": name, "mesh": list(shape),
            "axes": list(names), "hierarchical": hier, "backend": "gloo",
            "rows": int(x.shape[0]), "rows_per_rank": int(x.shape[0]) // 4,
            "flag": got[0]["flag"], "q": got[0]["q"],
            "combiner_iters": got[0]["combiner_iters"],
            "reducer_iters": got[0]["reducer_iters"],
            "wall_s": [r["wall_s"] for r in got],
            "bit_identical_to_composition": True, "stages_vs_torch": stages,
            "vs_torch": vs_torch,
            "torch_wall_s": t["wall_s"]})
        records += mesh_rank_lines("mesh_rank", got, name)
        entries += mesh_entries(run, f"mesh_{name}", x, w, got[0]["centers"],
                                got, device)
        torch.cuda.empty_cache()

    # (iii) against the single-device baselines on the card
    x, _ = mesh_load(arrays["higgs_like"])
    hcfg = cfgs["higgs_like"]
    xd = torch.from_numpy(np.asarray(x)).to(device)
    init = xd[:hcfg.n_clusters].clone()
    fkm1, fkm1_jobs, _ = mr_fuzzy_kmeans(xd, init, m=hcfg.m,
                                         eps=hcfg.combiner_eps,
                                         max_iter=MESH_JOBS,
                                         backend="hopper", device=device)
    km1 = mr_kmeans(xd, init, max_iter=MESH_JOBS, device=device)
    del xd
    torch.cuda.empty_cache()
    fkm1_c = fkm1.centers.cpu()
    base = {"fkm_jobs": [r["fkm"]["jobs"] for r in ranks] + [fkm1_jobs],
            "km_jobs": [r["km"]["jobs"] for r in ranks] + [km1[3]],
            "fkm_err": max(float((r["fkm"]["centers"] - fkm1_c).abs().max())
                           for r in ranks),
            "km_err": max(float((r["km"]["centers"] - km1[0].cpu())
                                .abs().max()) for r in ranks),
            "fkm_s": [r["fkm"]["s"] for r in ranks],
            "km_s": [r["km"]["s"] for r in ranks]}
    if (len(set(base["fkm_jobs"])) != 1 or len(set(base["km_jobs"])) != 1
            or base["fkm_err"] > 1e-4 or base["km_err"] > 1e-4):
        raise AssertionError(f"mesh baselines vs one card: {base}")
    # (iv) the exchange against the pairwise merge of the stack here
    def pairwise(p):
        return merge_summaries(
            Summary(torch.from_numpy(stack[0][:p]).to(device),
                    torch.from_numpy(stack[1][:p]).to(device)),
            MergePlan("pairwise"), backend="hopper").summary.centers.cpu()
    merged = pairwise(4)
    ex_scale = float(merged.abs().max())
    exchange = {w: max(float((r["exchange"][w] - merged).abs().max())
                       for r in ranks) for w in ("f32", "bf16")}
    exchange["f32_bit_identical"] = all(
        torch.equal(r["exchange"]["f32"], merged) for r in ranks)
    if exchange["f32"] > 1e-5 * ex_scale or \
            exchange["bf16"] > 16 * BF16_REL_BOUND * ex_scale:
        raise AssertionError(f"mesh_exchange vs the pairwise merge: "
                             f"{exchange}")
    records.append({"phase": "mesh_baselines", "gloo_ranks": 4, **base,
                    "exchange_max_abs_err": exchange,
                    "exchange_scale": ex_scale})

    # (v) NCCL at the card count (`start_mesh_path`)
    t0 = time.perf_counter()
    for p, fit_only, handle in started["nccl"]:
        nccl = join_spawn(handle)[0]
        got = nccl[0]["fit"]
        if p == 1:
            # the single-device branch: bigfcm_fit without a mesh, from
            # the race's own centers and branch
            tap = DriverTap()
            tap.out = (got["v_init"].to(device), got["flag"], 0.0, 0.0)
            try:
                one = bigfcm_fit(x, hcfg, device=device)
            finally:
                tap.close()
            want = (one.centers, one.center_weights, float(one.objective),
                    list(one.diagnostics.combiner_iters),
                    one.diagnostics.reducer_iters)
        else:
            want, _ = compose_fit(mesh_blocks(x, None, p, device), hcfg,
                                  (p,), ("data",), got["v_init"].to(device),
                                  got["flag"], device)
        hold_bits(got, want, f"nccl mesh fit at {p} ranks")
        rec = {"phase": "mesh_nccl", "ranks": p, "flag": got["flag"],
               "q": got["q"], "combiner_iters": got["combiner_iters"],
               "wall_s": [r["fit"]["wall_s"] for r in nccl],
               "bit_identical": True}
        if not fit_only:
            rows = MESH_LOADER_ROWS - MESH_LOADER_ROWS % p
            host = list(batched(iter([np.asarray(x[:rows])]),
                                MESH_LOADER_BATCH))
            loader_ok = all(len(r["loader"]) == len(host) for r in nccl) \
                and all(
                    torch.equal(torch.cat([r["loader"][i][0] for r in nccl]),
                                torch.from_numpy(bx))
                    and torch.equal(torch.cat([r["loader"][i][1]
                                               for r in nccl]),
                                    torch.from_numpy(bw))
                    for i, (bx, bw) in enumerate(host))
            rec.update(
                exchange_max_abs_err=max(float((r["exchange"] - pairwise(p))
                                               .abs().max()) for r in nccl),
                fkm_jobs=[r["fkm"]["jobs"] for r in nccl],
                fkm_err=max(float((r["fkm"]["centers"] - fkm1_c).abs().max())
                            for r in nccl),
                loader_batches=len(host), loader_ok=loader_ok)
            if (not loader_ok or rec["exchange_max_abs_err"] > 1e-5 * ex_scale
                    or set(rec["fkm_jobs"]) != {fkm1_jobs}
                    or rec["fkm_err"] > 1e-4):
                raise AssertionError(f"nccl mesh at {p} ranks: {rec}")
        records.append(rec)
    nccl_s = time.perf_counter() - t0
    records.append({"phase": "mesh_done", "setup_s": started["setup_s"],
                    "gloo_ranks_s": gloo_s,
                    "gloo_spawned_before_phase_s": gloo_ahead_s,
                    "nccl_s": nccl_s,
                    "seconds": time.perf_counter() - t_phase})
    for rec in records:
        emit(rec)
    return entries


# lm_serve: Qwen2-1.5B at its published config (src/repro_torch/configs/
# qwen2_1_5b.py), random weights from --seed, greedy serving in bf16.
LM_ARCH = "qwen2-1.5b"
LM_BATCH, LM_PROMPT, LM_NEW, LM_MAX_LEN = 8, 2048, 32, 4096
LM_RTOL, LM_ATOL = 5e-3, 5e-4       # decode vs forward, tests/test_models.py:47
LM_CPU_RTOL, LM_CPU_ATOL = 1e-4, 1e-5   # card vs CPU forward, f32
# card vs CPU forward in bf16: of the largest |h|, as tests/
# test_torch_models.py holds the port against the compiled reference (one-
# ulp flips where the GEMMs' f32 sums run in another order, carried on)
LM_CPU_BF16_REL = 2.0 ** -4
# `_bmm_f32` on bf16 operands, card vs CPU: f32 sums in two orders, of the
# largest |result|; a result rounded to bf16 parts by 2^-9 of each value
LM_BMM_REL = 1e-5
HBM_PEAK_BYTES_PER_S = (2.80e12, 2.93e12)   # `calibrate`'s probe, H100 80GB HBM3
LM_PUBLISHED = dict(n_layers=28, d_model=1536, n_heads=12, n_heads_padded=16,
                    n_kv_heads=2, d_ff=8960, vocab=151936, qkv_bias=True,
                    tie_embeddings=True, rope_theta=1e6)


def lm_step_bytes(model, cfg) -> int:
    """Bytes one decode step must move at least: every weight once, and
    the whole KV cache, which the step reads over all ``max_len`` slots
    (the reference's decode does)."""
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    cache = (2 * cfg.n_layers * LM_BATCH * LM_MAX_LEN * cfg.n_kv_heads
             * cfg.hd * 2)
    return weights + cache


def timed_generate(cfg, model, batch, device, max_len=LM_MAX_LEN,
                   new=LM_NEW):
    """`greedy_generate`'s loop with each call timed to a synchronize:
    (tokens, prefill logits, prefill ms, per-step ms, the last caches)."""
    import torch
    from repro_torch.serve import make_prefill, make_serve_step
    prefill, step = make_prefill(cfg, max_len), make_serve_step(cfg)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    logits, caches = prefill(model, batch)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    torch.cuda.synchronize(device)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    out, steps = [tok], []
    for _ in range(new - 1):
        t0 = time.perf_counter()
        tok, caches = step(model, caches, tok)
        torch.cuda.synchronize(device)
        steps.append((time.perf_counter() - t0) * 1e3)
        out.append(tok)
    return torch.cat(out, dim=1), logits, prefill_ms, steps, caches


def hold_lm_f32(model, cfg, prompt, toks, lg_bf16, device) -> dict:
    """The same weights cast to f32, IEEE f32 products (TF32 off): decode
    with the cache (prefill of the prompt, then the bf16 run's 32 tokens
    one at a time) against one forward over all 2048 + 32 tokens, on the
    hidden states of positions 2047–2111 at LM_RTOL / LM_ATOL.  Printed,
    not held: the f32 prefill logits against the bf16 ones, and the f32
    greedy choice at each of the 64 steps against the bf16 run's."""
    import torch
    from repro_torch.models.transformer import init_caches, logits_fn
    cfg32, m32 = f32_twin(model, cfg, device)
    t0 = time.perf_counter()
    with torch.inference_mode():
        h_full = m32(torch.cat([prompt, toks], dim=1))[:, LM_PROMPT - 1:]
        caches = init_caches(cfg32, LM_BATCH, LM_MAX_LEN, torch.float32,
                             device)
        h_pre, caches = m32(prompt, caches=caches)
        outs = [h_pre[:, -1]]
        lg_pre = logits_fn(cfg32, m32, h_pre[:, -1:])
        choice = [torch.argmax(lg_pre, dim=-1)]
        for t in range(LM_NEW):
            h_t, caches = m32(toks[:, t:t + 1], caches=caches)
            outs.append(h_t[:, 0])
            if t < LM_NEW - 1:
                choice.append(torch.argmax(logits_fn(cfg32, m32, h_t), -1))
        h_dec = torch.stack(outs, dim=1)
    torch.cuda.synchronize(device)
    err = max_err((h_dec,), (h_full,), LM_RTOL, LM_ATOL,
                  "lm_serve: f32 decode vs forward")
    agree = float((torch.cat(choice, dim=1) == toks).float().mean())
    gap = float((lg_pre - lg_bf16.float()).abs().max())
    rec = {"decode_vs_forward_max_abs_err": err, "rtol": LM_RTOL,
           "atol": LM_ATOL, "positions": [LM_PROMPT - 1,
                                          LM_PROMPT + LM_NEW - 1],
           "hidden_scale": float(h_full.abs().max()),
           "bf16_vs_f32_prefill_logits_max_abs": gap,
           "f32_logits_scale": float(lg_pre.abs().max()),
           "greedy_agreement_bf16_vs_f32": agree,
           "seconds": time.perf_counter() - t0}
    del m32, caches, h_full, h_dec
    torch.cuda.empty_cache()
    return rec


def hold_lm_cpu(seed, device) -> dict:
    """`hold_family_cpu` for a `reduced()` qwen2 with full attention and
    with KV blocks of 16 (the online softmax; in bf16 `_bmm_f32` takes
    its ``out_dtype`` branch on the card and its upcast on the CPU), then
    `hold_bmm_f32`."""
    rec = {f"attn_chunk={c}": hold_family_cpu(LM_ARCH, seed, device,
                                              attn_chunk=c) for c in (0, 16)}
    return {**rec, "bmm_f32": hold_bmm_f32(seed, device)}


def hold_bmm_f32(seed, device) -> dict:
    """`attention._bmm_f32` on bf16 operands at lm_serve's shapes, on the
    card (one bf16 product accumulating and returning f32) against its
    CPU branch (the operands upcast: exact products, f32 sums): decode's
    scores (B·KV, rep, hd) × (B·KV, hd, max_len) and P·V (B·KV, rep,
    max_len) × (B·KV, max_len, hd), and one prefill KV block (rep · 256
    queries a group, 1024 keys).  f32 results within LM_BMM_REL of the
    largest, and not all of them bf16 values."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.attention import _bmm_f32
    cfg = get_config(LM_ARCH)
    g, rep = LM_BATCH * cfg.n_kv_heads, cfg.n_heads_padded // cfg.n_kv_heads
    hd, gen = cfg.hd, torch.Generator().manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen).to(torch.bfloat16)

    cases = {"decode_scores": (normal(g, rep, hd), normal(g, hd, LM_MAX_LEN)),
             "decode_pv": (torch.rand((g, rep, LM_MAX_LEN), generator=gen)
                           .to(torch.bfloat16), normal(g, LM_MAX_LEN, hd)),
             "prefill_block_scores": (normal(g, rep * 256, hd),
                                      normal(g, hd, cfg.attn_chunk))}
    rec = {}
    for name, (a, b) in cases.items():
        want = _bmm_f32(a, b)
        got = _bmm_f32(a.to(device), b.to(device))
        if got.dtype != torch.float32 or want.dtype != torch.float32:
            raise AssertionError(f"lm_serve: _bmm_f32 {name} gave "
                                 f"{got.dtype} on the card")
        got = got.cpu()
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        rounded = bool((got.to(torch.bfloat16).float() == got).all())
        rec[name] = {"shape": [list(a.shape), list(b.shape)],
                     "max_abs_err": err, "scale": scale}
        if rounded or not err <= LM_BMM_REL * scale:
            raise AssertionError(f"lm_serve: _bmm_f32 {name}, card vs CPU: "
                                 f"{rec[name]}, all bf16 values: {rounded}")
    return {**rec, "rel_bar": LM_BMM_REL}


def run_lm_serve(seed: int, device):
    """Phase ``lm_serve``: Qwen2-1.5B at its full published width and
    depth (the 4 padded Q heads masked dead), weights from `tree_init`
    on the card, served in bf16 by `serve_family` (LM_BATCH prompts of
    LM_PROMPT tokens, LM_NEW new tokens, a LM_MAX_LEN cache); the f32
    decode-vs-forward hold (`hold_lm_f32`) and the card-vs-CPU hold
    (`hold_lm_cpu`).  Emits the record; returns (model, config):
    `run_curriculum` embeds with its table."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import DecoderLM

    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH)
    got = {k: getattr(cfg, k) for k in LM_PUBLISHED}
    if got != LM_PUBLISHED:
        raise AssertionError(f"{LM_ARCH}: {got} is not the published "
                             f"{LM_PUBLISHED}")
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    model = DecoderLM(cfg, torch.Generator(device=device).manual_seed(seed),
                      device=device)
    torch.cuda.synchronize(device)
    init_s = time.perf_counter() - t0
    prompt = fam_prompt(cfg, seed).to(device)
    rec, toks, lg_bf16, steps, caches = serve_family(
        "lm_serve", cfg, model, {"tokens": prompt}, LM_MAX_LEN, LM_NEW,
        device)
    del caches
    rec.update(bound_fields(lm_step_bytes(model, cfg),
                            rec["decode_ms_per_token"]))
    rec = {"phase": "lm_serve", "arch": LM_ARCH, "dtype": "bfloat16",
           "n_params": sum(p.numel() for p in model.parameters()),
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "heads": [cfg.n_heads, cfg.n_heads_padded],
           "kv_heads": cfg.n_kv_heads, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
           "attn_chunk": cfg.attn_chunk, "init_s": init_s, **rec}
    rec["f32"] = hold_lm_f32(model, cfg, prompt, toks, lg_bf16, device)
    rec["cpu"] = hold_lm_cpu(seed, device)
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    return model, cfg


# curriculum: curriculum_buckets over sequence_embeddings of lm_serve's own
# table: CUR_SEQS sequences of CUR_LEN tokens, each drawn from one of
# CUR_TOPICS topics of CUR_TOPIC_TOKENS token ids (made with numpy).
CUR_SEQS, CUR_LEN, CUR_TOPICS, CUR_TOPIC_TOKENS = 65536, 256, 16, 64
CUR_ACCURACY = 0.95     # tests/test_integration.py:58
CUR_BATCH = 256         # CurriculumSampler's batch
# The fuzzifier: the paper's KDD99 m.  At `curriculum_buckets`' default
# m = 2 the memberships of 1536-wide embeddings flatten (FCM's high-
# dimensional collapse: ambiguity ≈ 1, accuracy ≈ 1/16), the reference's
# fit as much as the port's (scripts/fcm_flattening_witness.py, on the
# CPU); the phase prints the default's fit on the card beside the held one.
CUR_M, CUR_DEFAULT_M = 1.2, 2.0


def curriculum_tokens(vocab, seed):
    """(tokens (CUR_SEQS, CUR_LEN) int64, topic of each sequence)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ids = rng.choice(vocab, CUR_TOPICS * CUR_TOPIC_TOKENS,
                     replace=False).reshape(CUR_TOPICS, CUR_TOPIC_TOKENS)
    topics = rng.integers(0, CUR_TOPICS, CUR_SEQS)
    picks = rng.integers(0, CUR_TOPIC_TOKENS, (CUR_SEQS, CUR_LEN))
    return ids[topics[:, None], picks], topics


def bucket_ties(got, want, x, centers) -> tuple:
    """(rows whose buckets differ, those of them whose two smallest d²
    against ``centers`` lie farther apart than the d² expansion's f32
    rounding, 2·γ_{d+2}·(‖x‖² + max‖v‖²) — not ties)."""
    import torch
    from repro_torch.engine.backend import pairwise_sqdist
    diff = torch.nonzero(got != want).flatten()
    if diff.numel() == 0:
        return 0, 0
    xs = x[diff].double()
    two = torch.topk(pairwise_sqdist(xs, centers.double(), torch.float64),
                     2, dim=1, largest=False).values
    gamma = (x.shape[1] + 2) * 2.0 ** -24
    slack = 2 * gamma * ((xs ** 2).sum(1)
                         + (centers.double() ** 2).sum(1).max())
    return int(diff.numel()), int(((two[:, 1] - two[:, 0]) > slack).sum())


def run_curriculum(model, lm_cfg, seed: int, device, reps: int) -> list:
    """Phase ``curriculum``: `curriculum_buckets` on backend ``hopper`` over
    `sequence_embeddings` of the lm_serve model's table, launch counts
    zeroed just before it and read after it; the buckets' accuracy
    against the topics, the ambiguity's range, the buckets against a
    ``torch``-backend fit from the same injected draws (and the hopper
    fit from those draws), `CurriculumSampler` batches; each kernel entry
    against its plain version at every shape the fit launched it at, and
    timed.  Returns kernel entries."""
    import numpy as np
    import torch
    from repro_torch.core import BigFCMConfig
    from repro_torch.core.metrics import clustering_accuracy
    from repro_torch.integration import (CurriculumSampler,
                                         curriculum_buckets,
                                         sequence_embeddings)
    from repro_torch.kernels.fcm_update import (fcm_accumulate_cuda,
                                                fcm_sweep_cuda, launch_plan,
                                                reset_counts)

    t_phase = time.perf_counter()
    tokens, topics = curriculum_tokens(lm_cfg.vocab, seed + 1)
    tok = torch.from_numpy(tokens).to(device)
    table = model.embed.table
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    emb = sequence_embeddings(table, tok)
    torch.cuda.synchronize(device)
    embed_s = time.perf_counter() - t0
    del tok
    n, d = emb.shape
    cfg = BigFCMConfig(n_clusters=CUR_TOPICS, m=CUR_M, combiner_eps=1e-6,
                       max_iter=300, seed=seed, backend="hopper")
    plan = launch_plan(device, n, d, CUR_TOPICS)

    reset_counts()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    bucket, amb, res = curriculum_buckets(emb, CUR_TOPICS, fcm_cfg=cfg,
                                          device=device)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = {"fcm_sweep": fcm_sweep_cuda.launches,
                "fcm_accumulate": fcm_accumulate_cuda.launches}
    by_shape = {"fcm_sweep": dict(fcm_sweep_cuda.shapes),
                "fcm_accumulate": dict(fcm_accumulate_cuda.shapes)}
    if launches["fcm_sweep"] == 0:
        raise AssertionError(f"curriculum: K2 was not launched: {launches}")
    check_paths("curriculum", fcm_sweep_cuda, fcm_accumulate_cuda)
    bucket_np, amb_np = bucket.cpu().numpy(), amb.cpu().numpy()
    acc = clustering_accuracy(topics, bucket_np, CUR_TOPICS)
    if bucket.shape != (n,) or amb.shape != (n,) or not bool(
            torch.isfinite(amb).all()):
        raise AssertionError("curriculum: mis-shaped or non-finite output")
    if not (0.0 <= float(amb.min()) and float(amb.max()) <= 1.0 + 1e-6):
        raise AssertionError(f"curriculum: ambiguity outside [0, 1]: "
                             f"{float(amb.min())}, {float(amb.max())}")
    if acc <= CUR_ACCURACY:
        raise AssertionError(f"curriculum: accuracy {acc} <= {CUR_ACCURACY}")
    diag = res.diagnostics
    record = {"phase": "curriculum", "sequences": n, "seq_len": CUR_LEN,
              "d": d, "c": CUR_TOPICS, "m": cfg.m,
              "topic_tokens": CUR_TOPIC_TOKENS, "table": LM_ARCH,
              "embed_dtype": str(emb.dtype).split(".")[-1],
              "embed_s": embed_s, "wall_s": wall, "backend": cfg.backend,
              "plan": {"path": plan.path, "grid": plan.grid,
                       "rows": plan.rows, "smem": plan.smem,
                       "dsplits": plan.dsplits, "kper": plan.kper},
              "flag": diag.flag, "sample_size": diag.sample_size,
              "combiner_iters": list(diag.combiner_iters),
              "reducer_iters": diag.reducer_iters, "accuracy": acc,
              "accuracy_bar": CUR_ACCURACY,
              "ambiguity": [float(amb.min()), float(amb.mean()),
                            float(amb.max())],
              "launches": launches,
              "launches_by_shape": {
                  "fcm_sweep": shape_counts(fcm_sweep_cuda),
                  "fcm_accumulate": shape_counts(fcm_accumulate_cuda)}}

    # printed, not held: the same fit at the default m
    t0 = time.perf_counter()
    b2, a2, r2 = curriculum_buckets(
        emb, CUR_TOPICS, fcm_cfg=dataclasses.replace(cfg, m=CUR_DEFAULT_M),
        device=device)
    torch.cuda.synchronize(device)
    norms = torch.linalg.norm(r2.centers, dim=1)
    record["default_m"] = {
        "m": CUR_DEFAULT_M, "wall_s": time.perf_counter() - t0,
        "accuracy": clustering_accuracy(topics, b2.cpu().numpy(),
                                        CUR_TOPICS),
        "ambiguity": [float(a2.min()), float(a2.mean()), float(a2.max())],
        "center_norms": [float(norms.min()), float(norms.max())],
        "center_spread": float(torch.cdist(r2.centers, r2.centers).max()),
        "flag": r2.diagnostics.flag,
        "iters": [*r2.diagnostics.combiner_iters,
                  r2.diagnostics.reducer_iters]}
    del b2, a2, r2

    # hopper and torch from the same injected draws (driver off)
    rng = np.random.default_rng(seed)
    draws = dict(sample_idx=rng.choice(n, diag.sample_size, replace=False),
                 seed_idx=rng.choice(diag.sample_size, CUR_TOPICS,
                                     replace=False))
    x = emb.float()
    fits = {b: curriculum_buckets(
        emb, CUR_TOPICS, fcm_cfg=dataclasses.replace(
            cfg, use_driver=False, backend=b), device=device, **draws)
        for b in ("hopper", "torch")}
    (hb, ha, hres), (tb, ta, tres) = fits["hopper"], fits["torch"]
    scale = float(torch.sqrt(torch.mean(x * x)))
    ties = bucket_ties(hb, tb, x, tres.centers)
    if ties[1]:
        raise AssertionError(f"curriculum: hopper and torch buckets differ "
                             f"beyond a tie at {ties[1]} of {n} rows")
    record["vs_torch"] = {
        "buckets_differ_ties": ties,
        "center_err_rel_rms": float((hres.centers - tres.centers).abs()
                                    .max()) / scale,
        "ambiguity_max_abs_err": float((ha - ta).abs().max()),
        "iters": [[*hres.diagnostics.combiner_iters,
                   hres.diagnostics.reducer_iters],
                  [*tres.diagnostics.combiner_iters,
                   tres.diagnostics.reducer_iters]],
        # printed: the main path ran the driver race, these fits did not
        "main_path_vs_torch_differ": bucket_ties(bucket, tb, x,
                                                 tres.centers)}
    sampler = {}
    for order in ("cohesion", "round_robin"):
        batches = list(CurriculumSampler(bucket_np, amb_np,
                                         batch=CUR_BATCH, order=order,
                                         seed=seed))
        if not batches or any(len(b) != CUR_BATCH for b in batches):
            raise AssertionError(f"curriculum: {order} batches not full")
        if order == "cohesion" and any(len(np.unique(bucket_np[b])) != 1
                                       for b in batches):
            raise AssertionError("curriculum: a cohesion batch spans "
                                 "buckets")
        sampler[order] = len(batches)
    record["sampler_batches"] = sampler
    record["seconds"] = time.perf_counter() - t_phase
    emit(record)

    ones = torch.ones((n,), dtype=torch.float32, device=device)
    cases = {"full": (x, ones, res.centers, 0.0)}
    for ns in sorted({k[1] for shapes in by_shape.values() for k in shapes}
                     - {n}):
        xs = x[:ns]
        cases[f"n={ns}"] = (xs, ones[:ns], res.centers,
                            q_rounding_bound(xs, ones[:ns], res.centers))
    entries = shape_entries("curriculum", cases, by_shape, d, cfg.m, device,
                            reps)
    del x, emb, fits
    torch.cuda.empty_cache()
    return entries


# lm_moe / lm_ssm / lm_hybrid / lm_encdec: the other LM families at their
# published configs (src/repro_torch/configs/), random bf16 weights from
# `tree_init` on the card from --seed, greedy serving through
# `greedy_generate`.  Each phase frees its model before the next.
FAM_PUBLISHED = {
    "olmoe-1b-7b": dict(n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
                        d_ff=1024, vocab=50304, n_experts=64, top_k=8,
                        capacity_factor=1.25, tie_embeddings=False),
    "mamba2-2.7b": dict(n_layers=64, d_model=2560, ssm_expand=2,
                        ssm_head_dim=64, ssm_state=128, ssm_chunk=256,
                        vocab=50280, vocab_padded=50304),
    "zamba2-7b": dict(n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
                      d_ff=14336, attn_period=5, ssm_state=64,
                      ssm_head_dim=64, vocab=32000),
    "whisper-medium": dict(n_layers=24, n_enc_layers=24, d_model=1024,
                           n_heads=16, d_ff=4096, act="gelu",
                           norm="layernorm", pos="learned",
                           tie_embeddings=True, n_frames=1500,
                           max_target_positions=448, vocab=51865),
}
FAM_N_PARAMS = {"olmoe-1b-7b": 6_919_096_320, "mamba2-2.7b": 2_831_418_880,
                "zamba2-7b": 5_737_416_000, "whisper-medium": 760_102_912}
# SSM holds: decode against one forward over whole SSD chunks (the
# reference asserts S % 256 == 0 past one chunk): a 1792-token prefill,
# then the prompt's next 256 tokens one at a time.
SSM_HOLD_PROMPT, SSM_HOLD_STEPS = 1792, 256
SSD_TOL = 2e-4                  # tests/test_mamba.py
ENC_PROMPT, ENC_MAX_LEN = 4, 448    # whisper: 4 prompt tokens, 448 slots
# A token whose k-th and (k+1)-th router probabilities lie within this
# (relative) of each other, but are not equal, routes by rounding:
# exempt, and counted.  Equal ones (duplicate router columns) go to the
# lower expert on every path.
MOE_TIE_REL = 1e-6
# The SSM holds' depth: decode against forward in f32 at LM_RTOL /
# LM_ATOL on the served model's first layers (full width).  The SSD's f32
# gap between its chunked and recurrent forms grows with depth in both
# packages (scripts/ssm_depth_witness.py, on the CPU at chunk 256: the
# reference's own keeps the bar at 16 layers and misses it at 64).
SSM_HOLD_LAYERS = {"mamba2-2.7b": 16, "zamba2-7b": 15}   # zamba2: 2 × 6 + 3


def fam_model(arch, seed, device):
    """(config, model) of ``arch``'s published config, bf16 weights from
    `tree_init` on the card; fails unless the shapes and the parameter
    count are the published ones."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import DecoderLM, EncDecLM
    cfg = get_config(arch)
    got = {k: getattr(cfg, k) for k in FAM_PUBLISHED[arch]}
    if got != FAM_PUBLISHED[arch]:
        raise AssertionError(f"{arch}: {got} is not the published "
                             f"{FAM_PUBLISHED[arch]}")
    cls = EncDecLM if cfg.family == "encdec" else DecoderLM
    model = cls(cfg, torch.Generator(device=device).manual_seed(seed),
                device=device)
    n = sum(p.numel() for p in model.parameters())
    if n != FAM_N_PARAMS[arch]:
        raise AssertionError(f"{arch}: {n} parameters, not "
                             f"{FAM_N_PARAMS[arch]}")
    return cfg, model


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def fam_prompt(cfg, seed, batch=None, length=None):
    """(batch, length) int32 token ids from ``seed``, LM_BATCH ×
    LM_PROMPT by default."""
    import numpy as np
    import torch
    shape = (batch or LM_BATCH, length or LM_PROMPT)
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, shape).astype(np.int32))


def serve_family(name, cfg, model, batch, max_len, new, device) -> tuple:
    """`greedy_generate` once (cold; peak device memory around it), then
    `timed_generate`'s loop held token for token against it, then one
    more step profiled (`profile_step`).  Returns (record fields,
    tokens, prefill logits, per-step ms, caches)."""
    import numpy as np
    import torch
    from repro_torch.serve import greedy_generate, make_serve_step
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    t0 = time.perf_counter()
    toks = greedy_generate(cfg, model, batch, max_new=new, max_len=max_len,
                           device=device)
    torch.cuda.synchronize(device)
    first_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    b = batch["tokens"].shape[0]
    if toks.shape != (b, new) or toks.dtype != torch.int32 or \
            not bool(((toks >= 0) & (toks < cfg.vocab)).all()):
        raise AssertionError(f"{name}: tokens {tuple(toks.shape)} "
                             f"{toks.dtype} outside [0, {cfg.vocab})")
    timed, lg, prefill_ms, steps, caches = timed_generate(
        cfg, model, batch, device, max_len=max_len, new=new)
    if not torch.equal(timed, toks):
        raise AssertionError(f"{name}: the timed loop's tokens differ "
                             f"from greedy_generate's")
    live = lg[..., :cfg.vocab].float()
    if not bool(torch.isfinite(live).all()):
        raise AssertionError(f"{name}: non-finite prefill logits")
    if cfg.vocab_padded != cfg.vocab and not bool(
            (lg[..., cfg.vocab:] == torch.tensor(-1e30, dtype=lg.dtype))
            .all()):
        raise AssertionError(f"{name}: padded vocabulary columns are not "
                             f"-1e30")
    step_ms = float(np.median(steps))
    loop_s = (prefill_ms + sum(steps)) / 1e3
    step = make_serve_step(cfg)
    prof = profile_step(lambda: step(model, caches, toks[:, -1:]), device)
    return ({"batch": b, "prompt": int(batch["tokens"].shape[1]),
             "new_tokens": new, "max_len": max_len,
             "first_generate_s": first_s, "prefill_ms": prefill_ms,
             "decode_ms_per_token": step_ms,
             "decode_ms_p10_p90": [float(np.percentile(steps, 10)),
                                   float(np.percentile(steps, 90))],
             "tokens_per_s": b * new / loop_s,
             "decode_tokens_per_s": b / (step_ms / 1e3),
             "peak_device_bytes": peak, "resident_bytes_before": base,
             "vocab_pad_masked": cfg.vocab_padded != cfg.vocab,
             "decode_step_profile": prof,
             "tokens_head": toks[0, :8].tolist()}, toks, lg, steps, caches)


def profile_step(step, device) -> dict:
    """One decode step under `torch.profiler` (host and card): its wall
    to a synchronize, the card's kernel time summed, the kernels
    launched, and the six ops with the most card time.  The profiler
    adds host time, so the idle share is an upper bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()                                  # warm: the profiler's own set-up
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in kernels) / 1e3 if kernels else 0.0
    top = sorted(prof.key_averages(), key=dev_us, reverse=True)[:6]
    if not kernels:
        return {"wall_ms": wall_ms, "device_ms": "not measured"}
    return {"wall_ms": wall_ms, "device_ms": busy_ms,
            "idle_share_at_most": 1 - busy_ms / wall_ms,
            "kernels": len(kernels),
            "top_ops_device_ms": [[e.key, dev_us(e) / 1e3, e.count]
                                  for e in top]}


def bound_fields(step_bytes, step_ms) -> dict:
    """The decode step's bytes bound over the probed HBM peaks, and its
    share of the measured step."""
    bound_ms = [step_bytes / r * 1e3 for r in HBM_PEAK_BYTES_PER_S]
    return {"decode_step_bytes": step_bytes, "decode_bound_ms": bound_ms,
            "decode_bound_share": [b / step_ms for b in bound_ms]}


def f32_twin(model, cfg, device, **changes):
    """The same weights cast to f32 in a model of the f32 config (with
    ``changes``); IEEE f32 products (TF32 off)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32", **changes)
    m32 = type(model)(cfg32, device=device)
    m32.load_state_dict({k: v.float() for k, v in model.state_dict().items()},
                        assign=True)
    return cfg32, m32


def hold_decode_vs_forward(name, cfg32, m32, prompt, cont, device,
                           exempt=None) -> dict:
    """A decoder in f32: cached prefill of ``prompt`` (B, P), then
    ``cont`` (B, n) one token at a time, against one forward over all P
    + n tokens, on the hidden states of positions P − 1 … P + n − 1 at
    LM_RTOL / LM_ATOL.  ``exempt`` (B, P + n) bool, if given, leaves
    positions out (near-tied routing)."""
    import torch
    from repro_torch.models.transformer import init_caches
    b, p = prompt.shape
    n = cont.shape[1]
    t0 = time.perf_counter()
    with torch.inference_mode():
        h_full = m32(torch.cat([prompt, cont], dim=1))[:, p - 1:]
        caches = init_caches(cfg32, b, p + n, torch.float32, device)
        h_pre, caches = m32(prompt, caches=caches)
        outs = [h_pre[:, -1]]
        for t in range(n):
            h_t, caches = m32(cont[:, t:t + 1], caches=caches)
            outs.append(h_t[:, 0])
        h_dec = torch.stack(outs, dim=1)
    torch.cuda.synchronize(device)
    held = None
    if exempt is not None:
        keep = ~exempt[:, p - 1:].to(device)
        held = int(keep.sum())
        h_dec, h_full = h_dec[keep], h_full[keep]
    rec = {"layers": cfg32.n_layers,
           "decode_vs_forward_max_abs_err": max_err(
               (h_dec,), (h_full,), LM_RTOL, LM_ATOL,
               f"{name}: f32 decode vs forward, {cfg32.n_layers} layers"),
           "rtol": LM_RTOL,
           "atol": LM_ATOL, "positions": [p - 1, p + n - 1],
           "hidden_scale": float(h_full.abs().max()),
           "seconds": time.perf_counter() - t0}
    if held is not None:
        rec["positions_held"] = held
        rec["positions_exempt_near_tie"] = int(exempt[:, p - 1:].sum())
    return rec


class MoeTaps:
    """Forward hooks on every MoE layer of a `DecoderLM`.  At prefill
    (S > 1): the (token, expert) pairs dropped past capacity, and the
    router load of the layer's own input through its routers and through
    ``unseeded`` (the routers before seeding); at decode: the distinct
    experts the step routes to."""

    def __init__(self, model, cfg, unseeded):
        self.cfg, self.unseeded = cfg, unseeded
        mods = [blk.moe for stage in model.stages for blk in stage.layers
                if "moe" in blk._modules]
        self.dropped, self.seeded_load, self.unseeded_load = {}, {}, {}
        self.unseeded_dropped = {}
        self.distinct = collections.defaultdict(list)
        self.handles = [m.register_forward_hook(self._hook(i))
                        for i, m in enumerate(mods)]

    def _hook(self, i):
        def hook(mod, args, out):
            import torch
            from repro_torch.models import moe
            x = args[0]
            cfg = self.cfg
            if x.shape[1] > 1:
                old = {"w_router": self.unseeded[i]}
                self.dropped[i] = moe.dropped_pairs(cfg, mod, x)
                self.seeded_load[i] = moe.router_load(cfg, mod, x)
                self.unseeded_load[i] = moe.router_load(cfg, old, x)
                self.unseeded_dropped[i] = moe.dropped_pairs(cfg, old, x)
            else:
                _, eidx = moe.route(cfg, mod.w_router,
                                    x.reshape(-1, x.shape[-1]))
                self.distinct[i].append(int(torch.unique(eidx).numel()))
        return hook

    def remove(self):
        for h in self.handles:
            h.remove()


def load_summary(load) -> dict:
    """A layer's router load (E,): its largest share over the even share
    (E·max/Σ), and how many experts it leaves idle."""
    lf = load.double()
    return {"max_over_mean": float(lf.max() * lf.numel() / lf.sum()),
            "idle_experts": int((load == 0).sum())}


def hold_moe_routers(model, res, tab) -> dict:
    """Every layer's router equal to (v/‖v‖)ᵀ of the fit in bf16, and
    layer 0's top-1 choice over the table rows against `hard_assign`,
    held above ROUTER_AGREE."""
    import torch
    from repro_torch.core import hard_assign
    v = res.centers / (torch.linalg.norm(res.centers, dim=-1, keepdim=True)
                       + 1e-8)
    layers = [blk.moe.w_router for blk in model.stages[0].layers]
    want = v.T.to(layers[0].dtype)
    if not all(torch.equal(w, want) for w in layers):
        raise AssertionError("lm_moe: a layer's router is not (v/|v|)^T "
                             "of the fit")
    agree = 0
    for r0 in range(0, tab.shape[0], 1 << 15):
        xs = tab[r0:r0 + (1 << 15)]
        agree += int(((xs @ layers[0].float()).argmax(1)
                      == hard_assign(xs, res.centers)).sum())
    agree /= tab.shape[0]
    if agree <= ROUTER_AGREE:
        raise AssertionError(f"lm_moe: top-1 agreement {agree} <= "
                             f"{ROUTER_AGREE}")
    gaps = torch.cdist(res.centers, res.centers)
    gaps.fill_diagonal_(torch.inf)
    return {"layers_equal_unit_centers": len(layers),
            "top1_agreement": agree, "agreement_bar": ROUTER_AGREE,
            "distinct_router_columns": int(torch.unique(want.T, dim=0)
                                           .shape[0]),
            "center_min_gap": float(gaps.min()),
            "center_norms": [float(x) for x in torch.aminmax(
                torch.linalg.norm(res.centers, dim=-1))]}


def seed_moe_routers(model, cfg, seed, device, reps) -> tuple:
    """The router_init phase's blob table (tests/test_integration.py:23
    at OLMoE's width) becomes the embedding table; `fcm_router_init`
    seeds every router from its fit on backend ``hopper`` (the C-tiled
    path), launch counts zeroed just before and read after; each kernel
    entry held and timed at the fit's shapes.  Returns (record, kernel
    entries, table)."""
    import torch
    from repro_torch.data.synth import make_blobs
    from repro_torch.device import synchronize
    from repro_torch.integration import fcm_router_init
    from repro_torch.kernels.fcm_update import (fcm_accumulate_cuda,
                                                fcm_sweep_cuda, reset_counts)
    tab, _ = make_blobs(cfg.vocab_padded, cfg.d_model, cfg.n_experts,
                        spread=ROUTER_TABLE_SPREAD, sep=ROUTER_TABLE_SEP,
                        seed=seed + 3)
    tab = torch.from_numpy(tab).to(device)
    with torch.no_grad():
        model.embed.table.copy_(tab)
    fcm_cfg = router_config(seed)
    reset_counts()
    synchronize(device)
    t0 = time.perf_counter()
    _, res = fcm_router_init(model, cfg, tab, fcm_cfg=fcm_cfg, device=device)
    synchronize(device)
    fit_s = time.perf_counter() - t0
    launches = {"fcm_sweep": fcm_sweep_cuda.launches,
                "fcm_accumulate": fcm_accumulate_cuda.launches}
    by_shape = {"fcm_sweep": dict(fcm_sweep_cuda.shapes),
                "fcm_accumulate": dict(fcm_accumulate_cuda.shapes)}
    if launches["fcm_sweep"] == 0:
        raise AssertionError(f"lm_moe: the fit launched no sweep: "
                             f"{launches}")
    check_paths("lm_moe", fcm_sweep_cuda, fcm_accumulate_cuda)
    diag = res.diagnostics
    rec = {"rows": int(tab.shape[0]), "spread": ROUTER_TABLE_SPREAD,
           "sep": ROUTER_TABLE_SEP, "backend": fcm_cfg.backend,
           "fit_s": fit_s, "flag": diag.flag,
           "iters": list(diag.combiner_iters) + [diag.reducer_iters],
           "launches": launches,
           "launches_by_shape": {
               "fcm_sweep": shape_counts(fcm_sweep_cuda),
               "fcm_accumulate": shape_counts(fcm_accumulate_cuda)},
           **hold_moe_routers(model, res, tab)}
    ones = torch.ones((tab.shape[0],), dtype=torch.float32, device=device)
    entries = fit_entries("lm_moe", tab, ones, res.centers, by_shape,
                          fcm_cfg.m, device, reps)
    return rec, entries, tab


def moe_step_bytes(model, cfg, distinct) -> int:
    """Bytes a decode step must move: every weight but the experts' and
    the embedding table (B rows looked up), the experts the step routes
    to (mean distinct experts a layer), and the whole KV cache (the step
    reads all max_len slots)."""
    layers = [blk for stage in model.stages for blk in stage.layers]
    experts = sum(nbytes(b.moe.w_in, b.moe.w_out) for b in layers
                  if "moe" in b._modules)
    one = nbytes(layers[-1].moe.w_in[0], layers[-1].moe.w_out[0])
    rows = LM_BATCH * cfg.d_model * model.embed.table.element_size()
    cache = 2 * cfg.n_layers * LM_BATCH * LM_MAX_LEN * cfg.n_kv_heads \
        * cfg.hd * 2
    rest = nbytes(*model.parameters()) - experts - nbytes(model.embed.table)
    routed = sum(sum(v) / len(v) for v in distinct.values()) * one
    return int(rest + rows + routed + cache)


def run_lm_moe(seed, device, reps):
    """Phase ``lm_moe``: OLMoE-1B-7B, routers seeded by BigFCM on the
    card (`seed_moe_routers`), served in bf16; route statistics from a
    tapped prefill and decode; the f32 decode-vs-forward hold at cf =
    E/k (no drops), tokens near a routing tie exempt; the reduced config
    on the card against the CPU; then ``lm_train_moe`` trains the same
    model (`run_lm_train_moe`).  Returns the fit's kernel entries."""
    import torch
    from repro_torch.serve import make_prefill, make_serve_step
    t_phase = time.perf_counter()
    arch = "olmoe-1b-7b"
    cfg, model = fam_model(arch, seed, device)
    unseeded = [blk.moe.w_router.detach().clone()
                for blk in model.stages[0].layers]
    seed_rec, entries, tab = seed_moe_routers(model, cfg, seed, device, reps)
    del tab
    prompt = fam_prompt(cfg, seed).to(device)
    batch = {"tokens": prompt}
    rec, toks, lg, steps, caches = serve_family(
        "lm_moe", cfg, model, batch, LM_MAX_LEN, LM_NEW, device)
    del caches
    # the same prefill and steps again, tapped (not timed)
    taps = MoeTaps(model, cfg, unseeded)
    with torch.inference_mode():
        _, c = make_prefill(cfg, LM_MAX_LEN)(model, batch)
        step = make_serve_step(cfg)
        for t in range(LM_NEW - 1):
            _, c = step(model, c, toks[:, t:t + 1])
    taps.remove()
    del c
    step_ms = rec["decode_ms_per_token"]
    rec.update(bound_fields(moe_step_bytes(model, cfg, taps.distinct),
                            step_ms))
    n = len(taps.dropped)
    rec["route"] = {
        "capacity_prefill": max(8, int(LM_BATCH * LM_PROMPT * cfg.top_k
                                       * cfg.capacity_factor)
                                // cfg.n_experts),
        "pairs_prefill": LM_BATCH * LM_PROMPT * cfg.top_k,
        "dropped_pairs_prefill": [taps.dropped[i] for i in range(n)],
        "dropped_pairs_prefill_unseeded": [taps.unseeded_dropped[i]
                                           for i in range(n)],
        "load_seeded": [load_summary(taps.seeded_load[i]) for i in range(n)],
        "load_unseeded": [load_summary(taps.unseeded_load[i])
                          for i in range(n)],
        "decode_distinct_experts_mean": [
            sum(taps.distinct[i]) / len(taps.distinct[i]) for i in range(n)]}
    rec["router_init"] = seed_rec
    # f32, TF32 off, cf = E/k: nothing drops in the forward or the steps;
    # the bf16 model stays for lm_train_moe
    cfg32, m32 = f32_twin(model, cfg, device,
                          capacity_factor=cfg.n_experts / cfg.top_k)
    torch.cuda.empty_cache()
    ties = RouteTaps(m32, cfg32)
    with torch.inference_mode():
        m32(torch.cat([prompt, toks], dim=1))
    ties.remove()
    exempt = torch.zeros((LM_BATCH, LM_PROMPT + LM_NEW), dtype=torch.bool)
    for _, _, gap in ties.calls:
        exempt |= ((gap > 0) & (gap <= MOE_TIE_REL)).reshape(exempt.shape)
    rec["f32"] = hold_decode_vs_forward("lm_moe", cfg32, m32, prompt, toks,
                                        device, exempt=exempt)
    del m32, ties
    torch.cuda.empty_cache()
    rec["cpu"] = hold_family_cpu(arch, seed, device)
    rec["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "lm_moe", "arch": arch, "dtype": "bfloat16",
          "n_params": FAM_N_PARAMS[arch], "layers": cfg.n_layers,
          "d_model": cfg.d_model, "experts": [cfg.n_experts, cfg.top_k],
          "d_ff": cfg.d_ff, "vocab": cfg.vocab,
          "capacity_factor": cfg.capacity_factor,
          "attn_chunk": cfg.attn_chunk, **rec})
    run_lm_train_moe(model, cfg, unseeded, seed_rec, seed, device)
    del model
    torch.cuda.empty_cache()
    return entries


class RouteTaps:
    """Forward hooks on every MoE layer of a `DecoderLM` recording, call
    by call, each token's experts (T, k), the kept pairs (T·k,) in the
    flat (token, k) order, and its relative gap between the k-th and
    (k+1)-th probabilities (T,), all on the CPU."""

    def __init__(self, model, cfg):
        self.cfg, self.calls = cfg, []
        mods = [blk.moe for stage in model.stages for blk in stage.layers
                if "moe" in blk._modules]
        self.handles = [m.register_forward_hook(self._hook) for m in mods]

    def _hook(self, mod, args, out):
        import torch
        from repro_torch.models import moe
        cfg = self.cfg
        xt = args[0].reshape(-1, args[0].shape[-1])
        _, eidx = moe.route(cfg, mod.w_router, xt)
        dp = moe.dispatch(cfg, eidx)
        kept = torch.zeros(eidx.numel(), dtype=torch.bool, device=xt.device)
        kept[dp.order] = dp.valid
        top = torch.sort(moe.softmax((xt @ mod.w_router.to(xt.dtype))
                                     .float()), dim=-1,
                         descending=True).values
        k = cfg.top_k
        gap = (top[:, k - 1] - top[:, k]) / top[:, k - 1]
        self.calls.append((eidx.cpu(), kept.cpu(), gap.cpu()))

    def remove(self):
        for h in self.handles:
            h.remove()


def routing_diff(cpu_taps, card_taps, shape) -> dict:
    """Tokens whose experts differ between the two runs (at any layer),
    tokens near a tie on the CPU (MOE_TIE_REL), and pairs whose kept /
    dropped state differs (a token routed elsewhere moves the ranks of
    later tokens, in any row, in its experts); ``first`` (B, S) bool
    marks each row's positions from its first token that differs either
    way on (attention carries it on along the row)."""
    import torch
    differ = torch.zeros(shape, dtype=torch.bool)
    kept = torch.zeros(shape, dtype=torch.bool)
    near = torch.zeros(shape, dtype=torch.bool)
    for (e0, k0, g0), (e1, k1, g1) in zip(cpu_taps.calls, card_taps.calls):
        differ |= (e0 != e1).any(-1).reshape(shape)
        kept |= (k0 != k1).reshape(e0.shape).any(-1).reshape(shape)
        near |= ((g0 > 0) & (g0 <= MOE_TIE_REL)).reshape(shape)
    first = torch.cumsum((differ | kept).int(), dim=1) > 0
    return {"tokens_routed_differently": int(differ.sum()),
            "tokens_near_tie": int(near.sum()),
            "unexplained": int((differ & ~near).sum()),
            "tokens_kept_differently": int(kept.sum()), "first": first}


def hold_family_cpu(arch, seed, device, **changes) -> dict:
    """The port's card forward against its CPU forward for ``arch``'s
    `reduced()` config (with ``changes``) with the same parameters,
    hidden states and logits: in f32 at LM_CPU_RTOL / LM_CPU_ATOL (the
    SSM families at SSD_TOL); in bf16 within
    LM_CPU_BF16_REL of the largest value.  MoE: in f32 every token's
    experts and every kept / dropped pair (at the config's cf 1.25)
    identical, tokens near a tie excepted (none expected); in bf16 a
    token whose experts part (an ulp of a bf16 logit at a near tie)
    leaves its row's later positions out, counted, at most half."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import DecoderLM, EncDecLM
    from repro_torch.models import encdec as encdec_lib
    from repro_torch.models.transformer import logits_fn
    out = {}
    # the SSD's exp of chunk cumsums and its f32 products differ from the
    # CPU's by ulps: held at tests/test_mamba.py's bar
    f32_bar = ((SSD_TOL, SSD_TOL) if get_config(arch).family in
               ("ssm", "hybrid") else (LM_CPU_RTOL, LM_CPU_ATOL))
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(reduced(get_config(arch)),
                                  param_dtype=dtype, compute_dtype=dtype,
                                  **changes)
        enc = cfg.family == "encdec"
        cls = EncDecLM if enc else DecoderLM
        head = encdec_lib.logits_fn if enc else logits_fn
        cpu = cls(cfg, torch.Generator().manual_seed(seed), device="cpu")
        card = cls(cfg, device=device)
        card.load_state_dict(cpu.state_dict())
        rng = np.random.default_rng(seed)
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 64)))
        taps = [RouteTaps(m, cfg) for m in (cpu, card)] if cfg.is_moe \
            else None
        with torch.inference_mode():
            if enc:
                frames = torch.from_numpy(rng.normal(
                    size=(4, cfg.n_frames, cfg.d_model)).astype(np.float32))
                h_cpu = cpu(tok, cpu.encode(frames))
                h_card = card(tok.to(device), card.encode(frames.to(device)))
            else:
                h_cpu, h_card = cpu(tok), card(tok.to(device))
            got = (h_card, head(cfg, card, h_card))
            want = (h_cpu.to(device), head(cfg, cpu, h_cpu).to(device))
        what = f"card vs CPU, reduced {arch}, {dtype}"
        rec = {}
        keep = None
        if taps is not None:
            for t in taps:
                t.remove()
            diff = routing_diff(taps[0], taps[1], tuple(tok.shape))
            first = diff.pop("first")
            rec["routing"] = diff
            if dtype == "float32" and (diff["unexplained"]
                                       or (diff["tokens_kept_differently"]
                                           and not diff["tokens_near_tie"])):
                raise AssertionError(f"{what}: routing parts: {diff}")
            if dtype == "bfloat16":
                keep = ~first.to(device)
                rec["positions_left_out"] = int(first.sum())
                if int(first.sum()) > first.numel() // 2:
                    raise AssertionError(f"{what}: {diff}")
        if dtype == "float32":
            rec["max_abs_err"] = max_err(got, want, *f32_bar, what)
        else:
            for name, g, w in zip(("hidden", "logits"), got, want):
                if g.dtype != torch.bfloat16:
                    raise AssertionError(f"{what}: {name} is {g.dtype}")
                g, w = g.float(), w.float()
                if keep is not None:
                    g, w = g[keep], w[keep]
                live = w > -1e29
                err = float((g - w).abs().max())
                scale = float(w[live].abs().max())
                rec[name] = {"max_abs_err": err, "scale": scale,
                             "bit_equal": float((g == w).float().mean())}
                if not err <= LM_CPU_BF16_REL * scale:
                    raise AssertionError(f"{what}: {name} {rec}")
        out[dtype] = rec
    return {**out, "rtol": f32_bar[0], "atol": f32_bar[1],
            "bf16_rel_bar": LM_CPU_BF16_REL}


def hold_ssd_full(cfg, seed, device) -> dict:
    """`ssd_chunked` at one full-width layer's shapes (LM_BATCH × LM_PROMPT
    tokens, the config's heads, head dim, state and chunk) against the
    sequential recurrence in float64 on the card (tests/test_mamba.py's
    inputs and 2e-4), and timed."""
    import numpy as np
    import torch
    from repro_torch.models.mamba import mamba_dims, ssd_chunked
    _, h, _, n = mamba_dims(cfg)
    b, s, p = LM_BATCH, LM_PROMPT, cfg.ssm_head_dim
    gen = torch.Generator(device=device).manual_seed(seed)

    def u(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device=device)
    x = torch.randn((b, s, h, p), generator=gen, device=device)
    dt = u((b, s, h), 0.01, 0.5)
    a_log = u((h,), -1.0, 1.0)
    bm = torch.randn((b, s, h, n), generator=gen, device=device)
    cm = torch.randn((b, s, h, n), generator=gen, device=device)
    d_skip = torch.randn((h,), generator=gen, device=device)
    with torch.inference_mode():
        y, final = ssd_chunked(x, dt, a_log, bm, cm, d_skip,
                               chunk=cfg.ssm_chunk)
        ms = time_ms(lambda: ssd_chunked(x, dt, a_log, bm, cm, d_skip,
                                         chunk=cfg.ssm_chunk), 5)
        a = -torch.exp(a_log.double())
        state = torch.zeros((b, h, n, p), dtype=torch.float64, device=device)
        ys = torch.empty((b, s, h, p), dtype=torch.float64, device=device)
        for t in range(s):
            dtt = dt[:, t].double()
            xd = x[:, t].double() * dtt[..., None]
            state = torch.exp(a * dtt)[..., None, None] * state + \
                bm[:, t].double()[..., None] * xd[:, :, None, :]
            ys[:, t] = torch.einsum("bhn,bhnp->bhp", cm[:, t].double(),
                                    state) + d_skip.double()[None, :, None] \
                * x[:, t].double()
    err = max_err((y.double(), final.double()), (ys, state), SSD_TOL,
                  SSD_TOL, "ssd_chunked vs sequential float64")
    return {"shape": [b, s, h, p, n], "chunk": cfg.ssm_chunk,
            "max_abs_err": err, "tol": SSD_TOL,
            "y_scale": float(ys.abs().max()), "ms": ms}


def ssm_step_bytes(model, cfg, caches) -> int:
    """Bytes a decode step must move: every weight but the embedding
    table (B rows looked up), the SSM and conv states read and written,
    and the whole KV cache of each attention (read over all its slots)."""
    from repro_torch.models.attention import KVCache
    rows = LM_BATCH * cfg.d_model * model.embed.table.element_size()
    total = nbytes(*model.parameters()) - nbytes(model.embed.table) + rows
    for c in caches:
        if isinstance(c, dict):
            total += nbytes(c["attn"].k, c["attn"].v)
            c = c["mambas"]
        if isinstance(c, KVCache):
            total += nbytes(c.k, c.v)
        else:
            total += 2 * nbytes(c.conv, c.ssm)
    return int(total)


def hold_shared_attention(model, cfg, device) -> dict:
    """zamba2: one shared attention parameter set, the model's
    ``shared_attn``, called by every period of a forward with the same
    storage; no period holds attention of its own."""
    import torch
    from repro_torch.models.transformer import stage_plan
    ptrs = []
    hook = model.shared_attn.register_forward_hook(
        lambda mod, args, out: ptrs.append(mod.attn.wq.data_ptr()))
    with torch.inference_mode():
        model(fam_prompt(cfg, 1, 1, cfg.ssm_chunk).to(device))
    hook.remove()
    periods = stage_plan(cfg)[0][1]
    own = [k for k in model.state_dict() if k.startswith("stages.")
           and (".attn." in k or ".mlp." in k)]
    if ptrs != [model.shared_attn.attn.wq.data_ptr()] * periods or own:
        raise AssertionError(f"lm_hybrid: shared attention called {ptrs} "
                             f"over {periods} periods; own: {own[:4]}")
    return {"periods": periods, "calls": len(ptrs),
            "one_storage": len(set(ptrs)) == 1,
            "shared_params": sum(p.numel()
                                 for p in model.shared_attn.parameters())}


def run_lm_ssm(phase, arch, seed, device):
    """Phases ``lm_ssm`` (Mamba2-2.7B) and ``lm_hybrid`` (Zamba2-7B):
    served in bf16; the f32 decode-vs-forward hold over whole SSD chunks
    (SSM_HOLD_PROMPT prefill, SSM_HOLD_STEPS steps); `hold_ssd_full`;
    the hybrid's shared attention; the reduced config on the card
    against the CPU."""
    import torch
    t_phase = time.perf_counter()
    cfg, model = fam_model(arch, seed, device)
    prompt = fam_prompt(cfg, seed).to(device)
    rec, toks, lg, steps, caches = serve_family(
        phase, cfg, model, {"tokens": prompt}, LM_MAX_LEN, LM_NEW, device)
    rec.update(bound_fields(ssm_step_bytes(model, cfg, caches),
                            rec["decode_ms_per_token"]))
    del caches
    if cfg.family == "hybrid":
        rec["shared_attention"] = hold_shared_attention(model, cfg, device)
    cfg32, m32 = f32_twin(model, cfg, device)
    del model
    torch.cuda.empty_cache()
    end = SSM_HOLD_PROMPT + SSM_HOLD_STEPS
    args = (prompt[:, :SSM_HOLD_PROMPT], prompt[:, SSM_HOLD_PROMPT:end],
            device)
    full = m32.state_dict()

    def cut_to(n):
        cut = dataclasses.replace(cfg32, n_layers=n)
        m_cut = type(m32)(cut, device=device)
        m_cut.load_state_dict({k: full[k] for k in m_cut.state_dict()},
                              assign=True)
        return cut, m_cut
    rec["f32"] = hold_decode_vs_forward(
        phase, *cut_to(SSM_HOLD_LAYERS[arch]), *args)
    del m32, full
    torch.cuda.empty_cache()
    rec["ssd"] = hold_ssd_full(cfg, seed, device)
    torch.cuda.empty_cache()
    rec["cpu"] = hold_family_cpu(arch, seed, device)
    rec["seconds"] = time.perf_counter() - t_phase
    from repro_torch.models.mamba import mamba_dims
    di, heads, _, state = mamba_dims(cfg)
    emit({"phase": phase, "arch": arch, "dtype": "bfloat16",
          "n_params": FAM_N_PARAMS[arch], "layers": cfg.n_layers,
          "d_model": cfg.d_model, "ssm": {"d_inner": di, "heads": heads,
                                          "head_dim": cfg.ssm_head_dim,
                                          "state": state,
                                          "chunk": cfg.ssm_chunk},
          "vocab": [cfg.vocab, cfg.vocab_padded], **rec})


def run_lm_encdec(seed, device):
    """Phase ``lm_encdec``: Whisper-medium over LM_BATCH streams of 1500
    stub frame embeddings from ``seed``, ENC_PROMPT prompt tokens,
    LM_NEW new, an ENC_MAX_LEN cache, served in bf16 (the encoder timed
    apart); the f32 decode-vs-forward hold over the 4 + 32 tokens; the
    reduced config on the card against the CPU."""
    import numpy as np
    import torch
    from repro_torch.models import encdec as encdec_lib
    t_phase = time.perf_counter()
    arch = "whisper-medium"
    cfg, model = fam_model(arch, seed, device)
    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(rng.normal(
        size=(LM_BATCH, cfg.n_frames, cfg.d_model)).astype(np.float32)
    ).to(device)
    prompt = fam_prompt(cfg, seed, LM_BATCH, ENC_PROMPT).to(device)
    batch = {"tokens": prompt, "frames": frames}
    rec, toks, lg, steps, caches = serve_family(
        "lm_encdec", cfg, model, batch, ENC_MAX_LEN, LM_NEW, device)
    with torch.inference_mode():
        rec["encode_ms"] = time_ms(lambda: model.encode(frames), 3)
    dec = [p for blk in model.dec_blocks for p in blk.parameters()]
    rows = LM_BATCH * cfg.d_model * 2 * model.embed.table.element_size()
    step_bytes = (nbytes(*dec) + nbytes(model.embed.table)
                  + nbytes(*model.final_norm.parameters()) + rows
                  + nbytes(caches.self_kv.k, caches.self_kv.v,
                           caches.cross_k, caches.cross_v))
    rec.update(bound_fields(int(step_bytes), rec["decode_ms_per_token"]))
    del caches
    cfg32, m32 = f32_twin(model, cfg, device)
    del model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with torch.inference_mode():
        enc = m32.encode(frames)
        h_full = m32(torch.cat([prompt, toks], dim=1), enc)[:,
                                                            ENC_PROMPT - 1:]
        c = encdec_lib.init_dec_caches(cfg32, m32, enc, LM_BATCH,
                                       ENC_MAX_LEN, torch.float32)
        h_pre, c = m32(prompt, caches=c)
        outs = [h_pre[:, -1]]
        for t in range(LM_NEW):
            h_t, c = m32(toks[:, t:t + 1], caches=c)
            outs.append(h_t[:, 0])
        h_dec = torch.stack(outs, dim=1)
    torch.cuda.synchronize(device)
    rec["f32"] = {
        "decode_vs_forward_max_abs_err": max_err(
            (h_dec,), (h_full,), LM_RTOL, LM_ATOL,
            "lm_encdec: f32 decode vs forward"),
        "rtol": LM_RTOL, "atol": LM_ATOL,
        "positions": [ENC_PROMPT - 1, ENC_PROMPT + LM_NEW - 1],
        "hidden_scale": float(h_full.abs().max()),
        "seconds": time.perf_counter() - t0}
    del m32, c, enc
    torch.cuda.empty_cache()
    rec["cpu"] = hold_family_cpu(arch, seed, device)
    rec["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "lm_encdec", "arch": arch, "dtype": "bfloat16",
          "n_params": FAM_N_PARAMS[arch],
          "layers": [cfg.n_enc_layers, cfg.n_layers],
          "d_model": cfg.d_model, "frames": cfg.n_frames,
          "vocab": [cfg.vocab, cfg.vocab_padded], **rec})


def run_lm_families(seed, device, reps) -> list:
    """The four family phases, each model freed before the next; returns
    lm_moe's kernel entries."""
    import torch
    entries = run_lm_moe(seed, device, reps)
    torch.cuda.empty_cache()
    for phase, arch in (("lm_ssm", "mamba2-2.7b"),
                        ("lm_hybrid", "zamba2-7b")):
        run_lm_ssm(phase, arch, seed, device)
        torch.cuda.empty_cache()
    run_lm_encdec(seed, device)
    torch.cuda.empty_cache()
    return entries


# lm_train / lm_train_moe / lm_train_dp: the training path
# (`repro_torch.launch.train.build`, `train.step`, `train.dp`, `optim`,
# `models.transformer.lm_loss`, remat) at the published configs, random
# weights from --seed, batches from `synthetic_token_batches`.
TRAIN_BATCH, TRAIN_SEQ = 8, 2048
TRAIN_LR, TRAIN_WARMUP, TRAIN_CLIP = 3e-4, 2, 1.0
TRAIN_STEPS, TRAIN_MOE_STEPS = 8, 3      # timed, after TRAIN_WARMUP warm-up
TRAIN_CKPT_AT = TRAIN_WARMUP             # checkpoint after this many steps
SMOKE_LOSS_REL = 0.5        # first loss vs ln(vocab), tests/test_archs_smoke.py:44
# H100 SXM dense bf16 tensor-core peak, published, at 700 W
BF16_PEAK_FLOP_PER_S = 989e12
# f32 twins (TF32 off): full width, TWIN_LAYERS layers, one step on the
# card against the same step on the CPU.  The loss within TWIN_LOSS_REL;
# every gradient within TWIN_GRAD_REL of its leaf's largest |g| (f32 sums
# in another order); the card's optimizer update against the CPU's
# optimizer applied to the card's gradients within TWIN_ULPS f32 ulps of
# the parameter plus TWIN_UPDATE_REL of the update (Adafactor's means and
# RMS are sums taken in another order).  OLMoE's twin holds one layer:
# the CPU's step of two, 64 experts each at cf = E/k, took 40–57 s on an
# H100 machine's host.
TWIN_LAYERS, TWIN_MOE_LAYERS, TWIN_BATCH, TWIN_SEQ = 2, 1, 2, 64
TWIN_LOSS_REL, TWIN_GRAD_REL, TWIN_ULPS = 1e-5, 1e-4, 2
TWIN_UPDATE_REL = 1e-5
# the checkpoint's resumed step where the card's kernels are not
# deterministic: the loss within CKPT_LOSS_REL, every parameter within
# one bf16 ulp (2^-8 of its value)
CKPT_LOSS_REL = 1e-4
DP_RANKS, DP_LAYERS, DP_STEPS, DP_BATCH = 2, 2, 2, 4
LM_N_PARAMS = 1_587_768_832     # Qwen2-1.5B as declared (tied, 16 Q slots)
DP_SAMPLE = 4099            # every n-th residual element returned by a rank


def train_flops(cfg, model, tokens: int) -> float:
    """Model FLOPs of one training step over ``tokens`` tokens (PaLM's
    count, remat's recompute not counted): 6·N per token for the
    parameters a token's products use — every weight but the input
    embedding's lookup (a tied table counts once, as the head), the MoE
    layers' experts at top_k / n_experts of their weights — plus
    12·L·H·hd·S per token for attention's scores and values over the
    sequence (real heads, not the padded ones)."""
    n = sum(p.numel() for p in model.parameters())
    if not cfg.tie_embeddings:
        n -= model.embed.table.numel()
    if cfg.is_moe:
        experts = sum(b.moe.w_in.numel() + b.moe.w_out.numel()
                      for s in model.stages for b in s.layers
                      if "moe" in b._modules)
        n -= experts * (1 - cfg.top_k / cfg.n_experts)
    attn = 12 * cfg.n_layers * cfg.n_heads * cfg.hd * TRAIN_SEQ
    return float(tokens * (6 * n + attn))


FLOPS_BAR = (0.85, 1.15)    # tests/test_flops_model.py:46


def hold_step_flops(cfg, model, step) -> dict:
    """One training ``step()`` under `counted_flops` (FlopCounterMode),
    held within FLOPS_BAR of `flops_model.step_flops` at the phase's
    8 × 2048 cell, printed beside `roofline.model_flops_for` and this
    script's `train_flops`, with the counter's per-op table and the ops
    it has no formula for."""
    from repro_torch.configs import ShapeCell
    from repro_torch.launch.flops_model import step_flops
    from repro_torch.launch.roofline import counted_flops, model_flops_for
    cell = ShapeCell("lm_train", TRAIN_SEQ, TRAIN_BATCH, "train")
    t0 = time.perf_counter()
    got = counted_flops(step)
    analytic = step_flops(cfg, cell)
    rec = {"counted": got["total"], "by_op": got["by_op"],
           "uncounted_ops": got["uncounted"], "step_flops": analytic,
           "ratio": analytic / got["total"], "bar": FLOPS_BAR,
           "model_flops_for": model_flops_for(cfg, cell),
           "train_flops": train_flops(cfg, model, TRAIN_BATCH * TRAIN_SEQ),
           "remat": cfg.remat, "loss": float(got["result"][1]["loss"]),
           "seconds": time.perf_counter() - t0}
    if not FLOPS_BAR[0] < rec["ratio"] < FLOPS_BAR[1]:
        raise AssertionError(f"lm_train: step_flops / counted FLOPs "
                             f"outside {FLOPS_BAR}: {rec}")
    return rec


def published_lm(arch, want):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    got = {k: getattr(cfg, k) for k in want}
    if got != want:
        raise AssertionError(f"{arch}: {got} is not the published {want}")
    return cfg


def train_batches(cfg, n, seed, batch=TRAIN_BATCH, seq=TRAIN_SEQ):
    from repro_torch.data.lm import synthetic_token_batches
    return [{"tokens": t, "labels": y} for t, y in synthetic_token_batches(
        cfg.vocab, batch, seq, steps=n, seed=seed)]


def timed_steps(state, step_fn, batches, device, on_step=None):
    """Every batch through ``step_fn``, each step timed to a synchronize;
    ``on_step(i, state)`` runs after step i, outside its time.  Returns
    (state, per-step ms, [{loss, grad_norm, lr}], peak device bytes)."""
    import torch
    from repro_torch.device import synchronize
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    ms, hist = [], []
    for i, b in enumerate(batches):
        synchronize(device)
        t0 = time.perf_counter()
        state, m = step_fn(state, b)
        synchronize(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        hist.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
        if on_step is not None:
            on_step(i, state)
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    return state, ms, hist, peak


def hold_losses(name, cfg, hist, *, falls=True) -> dict:
    """Every loss finite, the first within the smoke bar of ln(vocab),
    and (``falls``) the mean of the last 3 below the first."""
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: non-finite loss in {losses}")
    ln_v = math.log(cfg.vocab)
    if abs(losses[0] - ln_v) > SMOKE_LOSS_REL * ln_v:
        raise AssertionError(f"{name}: first loss {losses[0]} not within "
                             f"{SMOKE_LOSS_REL} of ln(vocab) = {ln_v}")
    last3 = sum(losses[-3:]) / 3
    if falls and not last3 < losses[0]:
        raise AssertionError(f"{name}: mean of the last 3 losses {last3} "
                             f"is not below the first {losses[0]}")
    return {"ln_vocab": ln_v, "first": losses[0], "last3_mean": last3,
            "smoke_rel": SMOKE_LOSS_REL}


def step_record(cfg, model, ms, hist, peak, warmup, tokens) -> dict:
    import numpy as np
    timed = ms[warmup:]
    med = float(np.median(timed))
    flops = train_flops(cfg, model, tokens)
    return {"steps": len(ms), "warmup_steps": warmup,
            "step_ms": ms, "step_ms_median": med,
            "step_ms_p10_p90": [float(np.percentile(timed, 10)),
                                float(np.percentile(timed, 90))],
            "tokens_per_step": tokens, "tokens_per_s": tokens / med * 1e3,
            "peak_device_bytes": peak, "model_flops_per_step": flops,
            "model_flops_share": flops / (med / 1e3) / BF16_PEAK_FLOP_PER_S,
            "bf16_peak_flop_per_s": BF16_PEAK_FLOP_PER_S,
            "history": hist}


def twin_side(cfg, state_dict, batch, opt_name, device, lr, taps=None,
              update=True):
    """One f32 step of a `DecoderLM` of ``cfg`` holding ``state_dict``, on
    ``device``: (loss, grad norm, clipped grads on the CPU by path,
    parameters after the step on the CPU — without ``update``, the
    gradients only —, route taps)."""
    from repro_torch.models import DecoderLM
    from repro_torch.optim import clip_by_global_norm, make
    from repro_torch.train.step import (loss_and_grads, on_device,
                                        param_groups)
    model = DecoderLM(cfg, device=device)
    model.load_state_dict({k: v.to(device) for k, v in state_dict.items()})
    model.requires_grad_(True)
    tap = taps(model, cfg) if taps is not None else None
    groups = param_groups(model)
    opt = make(opt_name)
    st = opt.init(groups)
    loss, grads = loss_and_grads(cfg, model, groups, on_device(batch, device))
    grads, gnorm = clip_by_global_norm(grads, TRAIN_CLIP)
    cpu_grads = {p: [t.detach().cpu() for t in ts] for p, ts in grads.items()}
    after = None
    if update:
        opt.update(grads, st, groups, lr)
        after = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    if tap is not None:
        tap.remove()
    return float(loss), float(gnorm), cpu_grads, after, tap


def hold_twin(name, cfg, state_dict, batch, opt_name, device,
              taps=None) -> dict:
    """The f32 twin's step on the card against the CPU's (TF32 off): the
    loss, every gradient, and the card's update against the CPU's
    optimizer applied to the card's gradients from the same start (the
    CPU's own update would only add the gradients' rounding, held
    already)."""
    import torch
    from repro_torch.models import DecoderLM
    from repro_torch.optim import make, schedule
    from repro_torch.train.step import param_groups
    torch.backends.cuda.matmul.allow_tf32 = False
    lr = schedule.cosine_schedule(0, peak=TRAIN_LR, warmup=TRAIN_WARMUP,
                                  total=TRAIN_WARMUP + TRAIN_STEPS)
    t0 = time.perf_counter()
    l_card, n_card, g_card, p_card, tap_card = twin_side(
        cfg, state_dict, batch, opt_name, device, lr, taps)
    l_cpu, n_cpu, g_cpu, _, tap_cpu = twin_side(
        cfg, state_dict, batch, opt_name, torch.device("cpu"), lr, taps,
        update=False)
    rec = {"layers": cfg.n_layers, "batch": list(batch["tokens"].shape),
           "optimizer": opt_name, "loss_card": l_card, "loss_cpu": l_cpu,
           "grad_norm_card": n_card, "grad_norm_cpu": n_cpu,
           "loss_rel_bar": TWIN_LOSS_REL, "grad_rel_bar": TWIN_GRAD_REL,
           "update_ulps_bar": TWIN_ULPS}
    if tap_card is not None:
        diff = routing_diff(tap_cpu, tap_card, batch["tokens"].shape)
        diff.pop("first")
        rec["routing"] = diff
        if diff["tokens_routed_differently"] or \
                diff["tokens_kept_differently"]:
            raise AssertionError(f"{name}: f32 twin routes differently on "
                                 f"the card and the CPU: {diff}")
    if not abs(l_card - l_cpu) <= TWIN_LOSS_REL * abs(l_cpu):
        raise AssertionError(f"{name}: f32 twin loss {l_card} on the card, "
                             f"{l_cpu} on the CPU")
    worst = 0.0
    for path, ts in g_cpu.items():
        scale = max(float(t.abs().max()) for t in ts)
        err = max(float((a - b).abs().max())
                  for a, b in zip(g_card[path], ts))
        worst = max(worst, err / scale if scale else err)
        if err > TWIN_GRAD_REL * scale:
            raise AssertionError(f"{name}: f32 twin gradient {path} off by "
                                 f"{err:.3e} of {scale:.3e}")
    rec["grad_worst_rel"] = worst
    # the CPU's optimizer on the card's gradients, from the same start
    ref = DecoderLM(cfg, device="cpu")
    ref.load_state_dict(state_dict)
    groups = param_groups(ref)
    opt = make(opt_name)
    opt.update(g_card, opt.init(groups), groups, lr)
    worst = 0.0
    for k, v in ref.state_dict().items():
        bar = (TWIN_ULPS * torch.finfo(torch.float32).eps
               * v.abs().clamp(min=torch.finfo(torch.float32).tiny)
               + TWIN_UPDATE_REL * (v - state_dict[k]).abs())
        worst = max(worst, float(((p_card[k] - v).abs() / bar).max()))
    rec["update_worst_share_of_bar"] = worst
    if worst > 1.0:
        raise AssertionError(f"{name}: the card's {opt_name} update is "
                             f"{worst}x its bar off the CPU's on its "
                             f"gradients")
    rec["seconds"] = time.perf_counter() - t0
    return rec


def twin_state(model, cfg, layers):
    """The first ``layers`` layers of ``model`` (and its embedding, norm
    and head) as an f32 state dict on the CPU."""
    out = {}
    for k, v in model.state_dict().items():
        parts = k.split(".")
        if parts[0] == "stages" and int(parts[3]) >= layers:
            continue
        out[k] = v.detach().float().cpu()
    return out


def hold_checkpoint(cfg, mgr, want, batch, seed, device) -> dict:
    """A fresh state (other weights, from ``seed`` + 1) restored from
    ``mgr``'s checkpoint takes the uninterrupted run's next step:
    ``want`` = (its loss, grad norm, parameters after it)."""
    import torch
    from repro_torch.launch.train import build, restore
    t0 = time.perf_counter()
    state, step_fn = build(cfg, optimizer="adamw", lr=TRAIN_LR,
                           warmup=TRAIN_WARMUP,
                           total_steps=TRAIN_WARMUP + TRAIN_STEPS,
                           seed=seed + 1, device=device)
    mgr.wait()
    state = restore(mgr, state)
    restore_s = time.perf_counter() - t0
    if int(state.step) != TRAIN_CKPT_AT:
        raise AssertionError(f"lm_train: restored step {int(state.step)}")
    state, m = step_fn(state, batch)
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    w_loss, w_gnorm, w_params = want
    params = state.params.state_dict()
    differ = [k for k, v in w_params.items() if not torch.equal(v, params[k])]
    bits = not differ and loss == w_loss and gnorm == w_gnorm
    rec = {"saved_after_steps": TRAIN_CKPT_AT, "loss": loss,
           "uninterrupted_loss": w_loss, "grad_norm": gnorm,
           "uninterrupted_grad_norm": w_gnorm, "bit_equal": bits,
           "params_differing": len(differ), "restore_s": restore_s}
    if not bits:
        # not bit for bit: the card's gradient sums (index_put_'s
        # accumulation in the embedding's backward, cuBLAS's split-K)
        # took another order; the step within CKPT_LOSS_REL and one bf16 ulp
        worst = 0.0
        for k in differ:
            ulp = w_params[k].float().abs() * 2.0 ** -8 + 2.0 ** -133
            worst = max(worst, float(((params[k].float()
                                       - w_params[k].float()).abs()
                                      / ulp).max()))
        rec["params_worst_bf16_ulps"] = worst
        if abs(loss - w_loss) > CKPT_LOSS_REL * abs(w_loss) or worst > 1.0:
            raise AssertionError(f"lm_train: the resumed step differs: "
                                 f"{rec}")
    del state, step_fn
    return rec


def run_lm_train(seed, device, ckpt_dir):
    """Phase ``lm_train``: Qwen2-1.5B at its published config trained
    through `launch.train.build` (AdamW, f32 moments, cosine schedule at
    peak TRAIN_LR, warmup TRAIN_WARMUP, clip TRAIN_CLIP) on 8 × 2048
    token batches from `synthetic_token_batches`: TRAIN_WARMUP warm-up
    and TRAIN_STEPS timed steps; a checkpoint after TRAIN_CKPT_AT steps
    restored into a fresh state takes the next step
    (`hold_checkpoint`); the f32 twin (`hold_twin`)."""
    import torch
    from repro_torch.device import synchronize
    from repro_torch.ft.checkpoint import CheckpointManager
    from repro_torch.launch.train import build, checkpoint_tree
    t_phase = time.perf_counter()
    cfg = published_lm(LM_ARCH, LM_PUBLISHED)
    total = TRAIN_WARMUP + TRAIN_STEPS
    batches = train_batches(cfg, total, seed)
    t0 = time.perf_counter()
    state, step_fn = build(cfg, optimizer="adamw", lr=TRAIN_LR,
                           warmup=TRAIN_WARMUP, total_steps=total,
                           seed=seed, device=device)
    synchronize(device)
    build_s = time.perf_counter() - t0
    model = state.params
    n = sum(p.numel() for p in model.parameters())
    if n != LM_N_PARAMS:
        raise AssertionError(f"lm_train: {n} parameters")
    mgr = CheckpointManager(str(ckpt_dir), keep=1)
    want, save_s = [], []

    def on_step(i, st):
        if i + 1 == TRAIN_CKPT_AT:
            t0 = time.perf_counter()
            mgr.save(i + 1, checkpoint_tree(st))     # host snapshot now
            t1 = time.perf_counter()
            mgr.wait()      # the write off the timed steps' host
            save_s.append((t1 - t0, time.perf_counter() - t1))
        if i == TRAIN_CKPT_AT:
            want.append({k: v.detach().clone()
                         for k, v in st.params.state_dict().items()})

    state, ms, hist, peak = timed_steps(state, step_fn, batches, device,
                                        on_step)
    rec = step_record(cfg, model, ms, hist, peak, TRAIN_WARMUP,
                      TRAIN_BATCH * TRAIN_SEQ)
    rec["losses_held"] = hold_losses("lm_train", cfg, hist)
    # two more steps on the state (dropped after): the second profiled
    rec["step_profile"] = profile_step(lambda: step_fn(state, batches[-1]),
                                       device)
    # and one counted, untimed
    rec["flops"] = hold_step_flops(cfg, model,
                                   lambda: step_fn(state, batches[-1]))
    twin = twin_state(model, cfg, TWIN_LAYERS)
    del state, step_fn, model
    torch.cuda.empty_cache()
    h = hist[TRAIN_CKPT_AT]
    rec["checkpoint"] = hold_checkpoint(
        cfg, mgr, (h["loss"], h["grad_norm"], want[0]),
        batches[TRAIN_CKPT_AT], seed, device)
    rec["checkpoint"]["snapshot_s"], rec["checkpoint"]["write_s"] = save_s[0]
    del want
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, n_layers=TWIN_LAYERS,
                                param_dtype="float32",
                                compute_dtype="float32")
    rec["f32_twin"] = hold_twin(
        "lm_train", cfg32, twin,
        train_batches(cfg, 1, seed + 7, TWIN_BATCH, TWIN_SEQ)[0], "adamw",
        device)
    rec["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "lm_train", "arch": LM_ARCH, "dtype": "bfloat16",
          "optimizer": "adamw", "n_params": n, "lr": TRAIN_LR,
          "warmup": TRAIN_WARMUP, "grad_clip": TRAIN_CLIP,
          "batch": [TRAIN_BATCH, TRAIN_SEQ], "remat": cfg.remat,
          "loss_chunk": cfg.loss_chunk, "build_s": build_s,
          "nvidia_smi": nvidia_smi(), **rec})


def drops_and_load(model, cfg, unseeded, tokens) -> dict:
    """A no-grad forward over ``tokens`` (B, S) tapped at every MoE
    layer: pairs dropped and the router load (`MoeTaps`)."""
    import torch
    taps = MoeTaps(model, cfg, unseeded)
    with torch.no_grad():
        model(tokens)
    taps.remove()
    n = len(taps.dropped)
    return {"dropped_pairs": [taps.dropped[i] for i in range(n)],
            "pairs": int(tokens.numel()) * cfg.top_k,
            "load": [load_summary(taps.seeded_load[i]) for i in range(n)]}


def run_lm_train_moe(model, cfg, unseeded, router_rec, seed, device):
    """Phase ``lm_train_moe``: OLMoE-1B-7B, `lm_moe`'s model with its
    BigFCM-seeded routers, trained through `launch.train.build` (its
    ``params=``) with Adafactor on 8 × 2048 batches: TRAIN_WARMUP
    warm-up and TRAIN_MOE_STEPS timed steps; the dropped pairs and router
    load of the first batch before and after; the f32 twin of its first
    TWIN_MOE_LAYERS layers at cf = E/k (no drops), routing held
    identical."""
    import torch
    from repro_torch.launch.train import build
    t_phase = time.perf_counter()
    total = TRAIN_WARMUP + TRAIN_MOE_STEPS
    batches = train_batches(cfg, total, seed)
    first = torch.as_tensor(batches[0]["tokens"], device=device)
    before = drops_and_load(model, cfg, unseeded, first)
    state, step_fn = build(cfg, optimizer="adafactor", lr=TRAIN_LR,
                           warmup=TRAIN_WARMUP, total_steps=total,
                           device=device, params=model)
    state, ms, hist, peak = timed_steps(state, step_fn, batches, device)
    rec = step_record(cfg, model, ms, hist, peak, TRAIN_WARMUP,
                      TRAIN_BATCH * TRAIN_SEQ)
    rec["losses_held"] = hold_losses("lm_train_moe", cfg, hist, falls=False)
    after = drops_and_load(model, cfg, unseeded, first)
    # two more steps (their weights are not held): the second profiled
    rec["step_profile"] = profile_step(lambda: step_fn(state, batches[-1]),
                                       device)
    del state, step_fn
    torch.cuda.empty_cache()
    rec["route"] = {"capacity": max(8, int(first.numel() * cfg.top_k
                                           * cfg.capacity_factor)
                                    // cfg.n_experts),
                    "before": before, "after": after}
    twin = twin_state(model, cfg, TWIN_MOE_LAYERS)
    model.requires_grad_(False)
    cfg32 = dataclasses.replace(
        cfg, n_layers=TWIN_MOE_LAYERS, param_dtype="float32",
        compute_dtype="float32", capacity_factor=cfg.n_experts / cfg.top_k)
    rec["f32_twin"] = hold_twin(
        "lm_train_moe", cfg32, twin,
        train_batches(cfg, 1, seed + 7, TWIN_BATCH, TWIN_SEQ)[0],
        "adafactor", device, taps=RouteTaps)
    rec["router_seed"] = {"run": "lm_moe", "launches": router_rec["launches"],
                          "backend": router_rec["backend"],
                          "fit_s": router_rec["fit_s"]}
    rec["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "lm_train_moe", "arch": "olmoe-1b-7b", "dtype": "bfloat16",
          "optimizer": "adafactor", "n_params": FAM_N_PARAMS["olmoe-1b-7b"],
          "lr": TRAIN_LR, "warmup": TRAIN_WARMUP, "grad_clip": TRAIN_CLIP,
          "batch": [TRAIN_BATCH, TRAIN_SEQ],
          "capacity_factor": cfg.capacity_factor, **rec})


def digest(t) -> str:
    """sha256 of a tensor's bytes."""
    import hashlib
    import torch
    return hashlib.sha256(t.detach().cpu().contiguous().reshape(-1)
                          .view(torch.uint8).numpy()).hexdigest()


def dp_config():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(LM_ARCH), n_layers=DP_LAYERS)


def dp_setup(cfg, seed, device):
    """(model, optimizer, schedule) of the DP phase: the bf16 model of
    ``cfg`` from ``seed`` on ``device``, trainable; AdamW."""
    import torch
    from repro_torch.models import DecoderLM
    from repro_torch.optim import adamw, cosine_schedule
    model = DecoderLM(cfg, torch.Generator(device=device).manual_seed(seed),
                      device=device)
    model.requires_grad_(True)
    return model, adamw(), (lambda s: cosine_schedule(
        s, peak=TRAIN_LR, warmup=TRAIN_WARMUP, total=DP_STEPS))


def dp_rank_job(mesh, seed, batches):
    """One rank of ``lm_train_dp``: `make_dp_train_step` over the mesh's
    "data" axis, DP_STEPS steps; the losses, the parameters (rank 0: all,
    as CPU tensors; both: digests), the residuals' digests and a strided
    sample, the bytes gathered and the seconds in collectives."""
    import torch
    from repro_torch import mesh as M
    from repro_torch import obs
    from repro_torch.device import synchronize
    from repro_torch.train.dp import init_dp_state, make_dp_train_step
    dev = M.rank_device(mesh)
    cfg = dp_config()
    model, opt, lr_fn = dp_setup(cfg, seed, dev)
    state = init_dp_state(model, opt)
    step = make_dp_train_step(cfg, opt, lr_fn, mesh, data_axes=("data",))
    gathered = obs.counter("mesh.gathered_bytes")
    coll = obs.counter("mesh.collective_s")
    b0, c0 = gathered.value, coll.value
    hist, step_s = [], []
    for b in batches:
        synchronize(dev)
        t0 = time.perf_counter()
        state, m = step(state, b)
        synchronize(dev)
        step_s.append(time.perf_counter() - t0)
        hist.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
    params = model.state_dict()
    first = mesh.mesh.flatten()[0] == torch.distributed.get_rank()
    return {"history": hist, "step_s": step_s,
            "gathered_bytes": gathered.value - b0,
            "collective_s": coll.value - c0,
            "param_digests": {k: digest(v) for k, v in params.items()},
            "params": ({k: v.detach().cpu() for k, v in params.items()}
                       if bool(first) else None),
            "error_digests": {p: [digest(t) for t in ts]
                              for p, ts in state.error.items()},
            "error_sample": {p: [t.reshape(-1)[::DP_SAMPLE].cpu()
                                 for t in ts]
                             for p, ts in state.error.items()}}


def dp_compose(cfg, seed, batches, device):
    """The DP steps composed in one process: each rank's row block's
    gradients (`loss_and_grads`), its error feedback, the wire values
    added in f32 in rank order and divided (`average_in_order`), the
    losses likewise, then the update (`apply_update`).  Returns (model,
    history, residuals per rank)."""
    import torch
    from repro_torch import mesh as M
    from repro_torch.train.dp import average_in_order, error_feedback
    from repro_torch.train.step import (apply_update, init_train_state,
                                        loss_and_grads, on_device,
                                        param_groups)
    model, opt, lr_fn = dp_setup(cfg, seed, device)
    state = init_train_state(model, opt)
    groups = param_groups(model)
    err = [{p: [torch.zeros(t.shape, dtype=torch.float32, device=device)
                for t in g.parts] for p, g in groups.items()}
           for _ in range(DP_RANKS)]
    hist = []
    for b in batches:
        rows = b["tokens"].shape[0] // DP_RANKS
        losses, wires = [], []
        for r in range(DP_RANKS):
            shard = on_device({k: v[r * rows:(r + 1) * rows]
                               for k, v in b.items()}, device)
            loss, grads = loss_and_grads(cfg, model, groups, shard)
            q, err[r] = error_feedback(grads, err[r], torch.bfloat16)
            losses.append(loss.reshape(1))
            wires.append(q)
            del grads
        g_sync = {p: [average_in_order(torch.stack(
            [wires[r][p][i] for r in range(DP_RANKS)]), DP_RANKS)
            for i in range(len(g.parts))] for p, g in groups.items()}
        loss = (M.sum_in_order(losses) / DP_RANKS)[0]
        del wires
        state, m = apply_update(state, groups, g_sync, loss, opt, lr_fn,
                                TRAIN_CLIP)
        hist.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
    return model, hist, err


def start_lm_train_dp(seed, device, work_dir):
    """``lm_train_dp``'s DP_RANKS ranks, spawned ahead (`spawn_ahead`),
    held until `run_lm_train_dp` → its handle."""
    cfg = dp_config()
    batches = train_batches(cfg, DP_STEPS, seed + 11, DP_BATCH)
    return spawn_ahead(str(work_dir / "go_dp"), dp_rank_job, (DP_RANKS,),
                       ("data",), 600.0, args=(seed, batches),
                       backend="gloo", device_type=device.type)


def run_lm_train_dp(seed, device, started):
    """Phase ``lm_train_dp``: `train.dp.make_dp_train_step` on DP_RANKS
    gloo ranks sharing the card (`mesh.spawn_mesh`, spawned ahead by
    `start_lm_train_dp`: ``started``), Qwen2-1.5B at full width and
    DP_LAYERS layers in bf16, a bf16 wire with error feedback, DP_STEPS
    steps of DP_BATCH × 2048 tokens; held against the same steps
    composed in this process (`dp_compose`), bit for bit."""
    import torch
    t_phase = time.perf_counter()
    cfg = dp_config()
    batches = train_batches(cfg, DP_STEPS, seed + 11, DP_BATCH)
    ranks, ranks_s, ahead_s = join_spawn(started)
    model, hist, err = dp_compose(cfg, seed, batches, device)
    params = model.state_dict()
    n = sum(p.numel() for p in model.parameters())
    rec = {"ranks": DP_RANKS, "layers": DP_LAYERS, "n_params": n,
           "batch": [DP_BATCH, TRAIN_SEQ], "steps": DP_STEPS,
           "wire": "bfloat16", "ranks_s": ranks_s,
           "spawned_before_phase_s": ahead_s,
           "rank_step_s": [r["step_s"] for r in ranks],
           "rank_gathered_bytes": [r["gathered_bytes"] for r in ranks],
           "f32_wire_bytes": 4 * n * DP_RANKS * DP_STEPS,
           "rank_collective_s": [r["collective_s"] for r in ranks],
           "history": ranks[0]["history"], "composed_history": hist}
    for r in ranks:
        if r["history"] != ranks[0]["history"] or \
                r["param_digests"] != ranks[0]["param_digests"]:
            raise AssertionError("lm_train_dp: the ranks' replicas differ")
    want = {k: digest(v) for k, v in params.items()}
    p_bits = want == ranks[0]["param_digests"]
    e_bits = all(r["error_digests"] == {p: [digest(t) for t in ts]
                                        for p, ts in err[i].items()}
                 for i, r in enumerate(ranks))
    rec["bit_equal"] = {"history": ranks[0]["history"] == hist,
                        "params": p_bits, "residuals": e_bits}
    if not all(rec["bit_equal"].values()):
        # not bit for bit: the card's gradient sums (index_put_'s
        # accumulation in the embedding's backward, cuBLAS's split-K)
        # took another order in the two processes
        got = ranks[0]["params"]
        worst = max(float(((got[k].float() - v.float().cpu()).abs()
                           / (v.float().cpu().abs() * 2.0 ** -8
                              + 2.0 ** -133)).max()) for k, v in params.items())
        loss_gap = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                       for a, b in zip(ranks[0]["history"], hist))
        res_gap = 0.0
        for i, r in enumerate(ranks):
            for p, ts in r["error_sample"].items():
                for a, t in zip(ts, err[i][p]):
                    b = t.reshape(-1)[::DP_SAMPLE].cpu()
                    res_gap = max(res_gap, float((a - b).abs().max()))
        rec["tolerance"] = {"params_worst_bf16_ulps": worst,
                            "loss_worst_rel": loss_gap,
                            "residual_sample_max_abs": res_gap}
        if worst > 1.0 or loss_gap > CKPT_LOSS_REL:
            raise AssertionError(f"lm_train_dp: off the composition: {rec}")
    if not all(g == 2 * n * DP_RANKS * DP_STEPS + 4 * DP_RANKS * DP_STEPS
               for g in rec["rank_gathered_bytes"]):
        raise AssertionError(f"lm_train_dp: gathered "
                             f"{rec['rank_gathered_bytes']} bytes, not a "
                             f"bf16 payload")
    rec["seconds"] = time.perf_counter() - t_phase
    del model, err
    torch.cuda.empty_cache()
    emit({"phase": "lm_train_dp", "arch": LM_ARCH, **rec})
    return rec


# lm_moe_ep: OLMoE-1B-7B's MoE layer at its published widths, expert
# parallel over a (1, 4) ("data", "model") mesh of gloo ranks sharing the
# card (`mesh.spawn_mesh`), each rank holding 16 of the 64 experts.
EP_ARCH = "olmoe-1b-7b"
EP_PUBLISHED = dict(d_model=2048, n_experts=64, top_k=8, d_ff=1024,
                    capacity_factor=1.25)
EP_SHAPE, EP_NAMES = (1, 4), ("data", "model")
# (a) the f32 hold at cf 8 (no pair dropped): 4096 N(0, 1) tokens as
# 4 × 1024, so that the global batch divides the 4 ranks (the
# reference's a2a condition; 2 × 2048 would take the tp branch under
# "fsdp" too).  Each branch's y and gradients (x, its expert slices, the
# router's parts summed over the ranks) against the single-rank layer
# on the card: |got − want| ≤ EP_REL · max|want| + EP_REL · |want|.
EP_HOLD = (4, 1024, 8.0)
EP_REL = 1e-4
# (b) the timed bf16 layer at the published cf 1.25 on lm_moe's prompt
# batch: 8 × 2048 tokens; EP_REPS timed repetitions after one warm-up.
EP_TIME = (8, 2048)
EP_REPS = 2
EP_DEADLINE_S = 600.0


def ep_config(cf, dtype):
    cfg = published_lm(EP_ARCH, EP_PUBLISHED)
    return dataclasses.replace(cfg, capacity_factor=cf, param_dtype=dtype,
                               compute_dtype=dtype)


def ep_layer(cfg, seed, batch, seq, device):
    """(the layer's whole weights from ``seed`` by `tree_init` on
    ``device``, x (batch, seq, d) and the cotangent g, both N(0, 1))."""
    import torch
    from repro_torch.models.moe import moe_decl
    from repro_torch.models.params import tree_init
    from repro_torch.models.transformer import torch_dtype
    dt = torch_dtype(cfg.param_dtype)
    p = tree_init(torch.Generator(device=device).manual_seed(seed),
                  moe_decl(cfg), dt, device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    x, g = (torch.randn((batch, seq, cfg.d_model), generator=gen,
                        device=device).to(dt) for _ in range(2))
    return p, x, g


def ep_blocks(cfg, p, x, g, mesh, profile, rank) -> dict:
    """This rank's part of one `moe` call under ``profile``: the branch,
    x's placement and block (a leaf), g's block, the weights (w_router
    whole, the expert slices; leaves) and the global batch."""
    from repro_torch.models import moe as TM
    from repro_torch.sharding import local_block, mesh_context, \
        profile_context
    with mesh_context(mesh), profile_context(profile):
        branch = TM.ep_branch(cfg, mesh, x.shape[0])
    spec = (TM.ep_batch_axes(branch, mesh), None, None)
    experts = ("model", None, None)

    def leaf(t):
        return t.detach().clone().requires_grad_(True)
    return {"profile": profile, "branch": branch, "spec": spec,
            "b": x.shape[0], "x": leaf(local_block(x, spec, mesh, rank)),
            "g": local_block(g, spec, mesh, rank).contiguous(),
            "p": {"w_router": leaf(p["w_router"]),
                  "w_in": leaf(local_block(p["w_in"], experts, mesh, rank)),
                  "w_out": leaf(local_block(p["w_out"], experts, mesh,
                                            rank))}}


def ep_run(cfg, mesh, blk, backward):
    """One `moe` call on the rank's blocks ``blk`` (`ep_blocks`; without
    a mesh, the whole layer on one rank), and the backward of sum(y·g)
    → y."""
    import torch
    from repro_torch.models import moe as TM
    from repro_torch.sharding import mesh_context, profile_context
    for t in (*blk["p"].values(), blk["x"]):
        t.grad = None
    with mesh_context(mesh), profile_context(blk["profile"]), \
            torch.set_grad_enabled(backward):
        y = TM.moe(cfg, blk["p"], blk["x"], global_batch=blk["b"])
        if backward:
            (y.float() * blk["g"].float()).sum().backward()
    return y


def ep_dropped(cfg, mesh, blk) -> int:
    from repro_torch import mesh as M
    from repro_torch.models import moe as TM
    return TM.dropped_pairs(cfg, blk["p"], blk["x"].detach(),
                            branch=blk["branch"],
                            n_ranks=M.axis_sizes(mesh)["model"],
                            rank=M.block_index(mesh, ("model",))[0])


def ep_err(got, want) -> dict:
    diff = (got.detach().float() - want.detach().float()).abs()
    mag = want.detach().float().abs()
    scale = float(mag.max())
    return {"max_abs_err": float(diff.max()), "scale": scale,
            "ok": bool((diff <= EP_REL * scale + EP_REL * mag).all())}


def ep_hold(mesh, seed, dev, rank) -> dict:
    """(a): the single-rank layer's y and gradients (computed on this
    rank's card in full), then each branch's on the rank's blocks."""
    import torch
    from repro_torch import mesh as M
    from repro_torch.models import moe as TM
    from repro_torch.sharding import local_block
    torch.backends.cuda.matmul.allow_tf32 = False
    b, s, cf = EP_HOLD
    cfg = ep_config(cf, "float32")
    p, x, g = ep_layer(cfg, seed, b, s, dev)
    want = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    xw = x.clone().requires_grad_(True)
    yw = TM.moe(cfg, want, xw)
    (yw * g).sum().backward()
    out = {"single_dropped": TM.dropped_pairs(cfg, p, x)}
    experts = ("model", None, None)
    for profile in ("tp", "fsdp"):
        blk = ep_blocks(cfg, p, x, g, mesh, profile, rank)
        y = ep_run(cfg, mesh, blk, True)
        spec, bp = blk["spec"], blk["p"]
        router = M.psum(bp["w_router"].grad, mesh, ("data", "model"))
        out[profile] = {
            "branch": blk["branch"],
            "y": ep_err(y, local_block(yw, spec, mesh, rank)),
            "grad_x": ep_err(blk["x"].grad,
                             local_block(xw.grad, spec, mesh, rank)),
            "grad_w_in": ep_err(bp["w_in"].grad, local_block(
                want["w_in"].grad, experts, mesh, rank)),
            "grad_w_out": ep_err(bp["w_out"].grad, local_block(
                want["w_out"].grad, experts, mesh, rank)),
            "grad_w_router_summed": ep_err(router, want["w_router"].grad),
            "dropped": ep_dropped(cfg, mesh, blk)}
        del y, blk, bp, router
    del p, x, g, want, xw, yw
    torch.cuda.empty_cache()
    return out


def ep_rank_job(mesh, seed):
    """One rank of ``lm_moe_ep``: (a) the f32 holds, (b) both branches
    timed in bf16, forward alone and forward + backward, with the bytes
    and seconds of one call's collectives and the pairs this rank
    dropped."""
    import torch
    import torch.distributed as dist
    from repro_torch import mesh as M
    from repro_torch import obs
    from repro_torch.device import synchronize
    dev = M.rank_device(mesh)
    rank = dist.get_rank()
    out = {"rank": rank, "hold": ep_hold(mesh, seed, dev, rank)}
    b, s = EP_TIME
    cfg = ep_config(EP_PUBLISHED["capacity_factor"], "bfloat16")
    p, x, g = ep_layer(cfg, seed + 2, b, s, dev)
    counters = {k: obs.counter("mesh." + k) for k in
                ("all_to_all_bytes", "gathered_bytes", "collective_s")}
    for profile in ("fsdp", "tp"):
        blk = ep_blocks(cfg, p, x, g, mesh, profile, rank)
        rec = {"branch": blk["branch"], "x_block": list(blk["x"].shape)}
        peak_bytes(dev, reset=True)
        for name, bwd in (("fwd", False), ("fwd_bwd", True)):
            before = {k: c.value for k, c in counters.items()}
            y = ep_run(cfg, mesh, blk, bwd)
            synchronize(dev)
            rec[name + "_one_call"] = {k: c.value - before[k]
                                       for k, c in counters.items()}
            if not bool(torch.isfinite(y).all()):
                raise AssertionError(f"lm_moe_ep: {blk['branch']}: y is "
                                     "not finite")
            del y
            rec[name + "_ms"] = time_calls(
                functools.partial(ep_run, cfg, mesh, blk, bwd), dev,
                before=dist.barrier)
        rec["dropped"] = ep_dropped(cfg, mesh, blk)
        rec["peak_device_bytes"] = peak_bytes(dev)
        out[blk["branch"]] = rec
        del blk
        torch.cuda.empty_cache()
    return out


def start_lm_moe_ep(seed, device, work_dir):
    """``lm_moe_ep``'s ranks, spawned ahead (`spawn_ahead`), held until
    `run_lm_moe_ep` → its handle."""
    return spawn_ahead(str(work_dir / "go_ep"), ep_rank_job, EP_SHAPE,
                       EP_NAMES, EP_DEADLINE_S, args=(seed,),
                       backend="gloo", device_type=device.type)


def run_lm_moe_ep(seed, device, started):
    """Phase ``lm_moe_ep``: `moe`'s expert-parallel branches (``tp``:
    tokens replicated over "model", a psum of the partial outputs;
    ``a2a`` under "fsdp": tokens split over "model", two `all_to_all`
    exchanges each way) on 4 gloo ranks sharing the card (spawned ahead
    by `start_lm_moe_ep`: ``started``), at
    OLMoE-1B-7B's published widths (d 2048, 64 experts, top-8, d_ff 1024;
    one layer, weights from ``seed``).  (a) f32 at cf 8: each branch's y
    and gradients against the single-rank layer on the card; (b) bf16 at
    cf 1.25 on 8 × 2048 tokens: ms a layer, forward and forward +
    backward, for a2a, tp and one rank, bytes each rank's collectives
    move, the pairs dropped."""
    import numpy as np
    import torch
    from repro_torch.models import moe as TM
    t_phase = time.perf_counter()
    ranks, ranks_s, ahead_s = join_spawn(started)
    # the single rank here, alone on the card
    b, s = EP_TIME
    cfg = ep_config(EP_PUBLISHED["capacity_factor"], "bfloat16")
    p, x, g = ep_layer(cfg, seed + 2, b, s, device)
    one = {"profile": "tp", "b": b, "g": g,
           "x": x.clone().requires_grad_(True),
           "p": {k: v.detach().clone().requires_grad_(True)
                 for k, v in p.items()}}
    peak_bytes(device, reset=True)
    one = {"fwd_ms": time_calls(functools.partial(ep_run, cfg, None, one,
                                                  False), device),
           "fwd_bwd_ms": time_calls(functools.partial(ep_run, cfg, None,
                                                      one, True), device),
           "dropped": TM.dropped_pairs(cfg, p, x),
           "peak_device_bytes": peak_bytes(device)}
    del p, x, g
    torch.cuda.empty_cache()
    pairs = b * s * cfg.top_k
    rec = {"arch": EP_ARCH, "mesh": dict(zip(EP_NAMES, EP_SHAPE)),
           "backend": "gloo", "experts_per_rank": cfg.n_experts
           // EP_SHAPE[1], "ranks_s": ranks_s,
           "spawned_before_phase_s": ahead_s, "reps": EP_REPS,
           "hold_f32": {"tokens": list(EP_HOLD[:2]), "cf": EP_HOLD[2],
                        "rel": EP_REL,
                        "ranks": [r["hold"] for r in ranks]},
           "timed_bf16": {"tokens": [b, s], "cf": cfg.capacity_factor,
                          "pairs": pairs, "single": one}}
    for r in ranks:
        for profile, branch in (("tp", "tp"), ("fsdp", "a2a")):
            h = r["hold"][profile]
            bad = [k for k, v in h.items()
                   if isinstance(v, dict) and not v["ok"]]
            if h["branch"] != branch or bad:
                raise AssertionError(f"lm_moe_ep: rank {r['rank']} "
                                     f"{profile}: {bad or h['branch']}: {h}")
            if h["dropped"] or r["hold"]["single_dropped"]:
                raise AssertionError(f"lm_moe_ep: pairs dropped at cf "
                                     f"{EP_HOLD[2]}: {r['hold']}")
    for branch in ("a2a", "tp"):
        per = [r[branch] for r in ranks]
        fwd = np.max([q["fwd_ms"] for q in per], axis=0)
        both = np.max([q["fwd_bwd_ms"] for q in per], axis=0)
        rec["timed_bf16"][branch] = {
            "fwd_ms": fwd.tolist(), "fwd_ms_median": float(np.median(fwd)),
            "fwd_bwd_ms": both.tolist(),
            "fwd_bwd_ms_median": float(np.median(both)),
            "dropped_share": sum(q["dropped"] for q in per) / pairs,
            "ranks": per}
    rec["timed_bf16"]["single"].update(
        fwd_ms_median=float(np.median(one["fwd_ms"])),
        fwd_bwd_ms_median=float(np.median(one["fwd_bwd_ms"])),
        dropped_share=one["dropped"] / pairs)
    if rec["timed_bf16"]["tp"]["dropped_share"] != \
            rec["timed_bf16"]["single"]["dropped_share"]:
        # one data rank: tp's capacity is the single rank's, and so are
        # its drops
        raise AssertionError(f"lm_moe_ep: tp drops differ from one "
                             f"rank's: {rec['timed_bf16']}")
    rec["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "lm_moe_ep", "nvidia_smi": nvidia_smi(), **rec})


# lm_train_mp: model-parallel training (`sharding.spmd`: FSDP over
# "data", tensor parallelism over "model", the sharded `launch.train`) on
# a (2, 2) ("data", "model") mesh of gloo ranks sharing the card, and the
# elastic restart onto half of them.
MP_SHAPE, MP_NAMES = (2, 2), ("data", "model")
MP_LAYERS, MP_MOE_LAYERS = 2, 1
# the other families' cuts: Mamba2 2 layers; Zamba2 one period of 5
# Mamba2 layers and the shared attention block, then one tail layer (both
# stage kinds); Whisper 2 encoder + 2 decoder layers
MP_FAM_LAYERS = {"mamba2-2.7b": 2, "zamba2-7b": 7, "whisper-medium": 2}
# (a) f32 (TF32 off), one AdamW step at the constant lr MP_LR on
# MP_HOLD global tokens, each case against the one-rank port step on the
# card from the same parameters and batch: the loss and the grad norm
# within MP_LOSS_REL; each rank's block of every updated leaf against its
# block of the one-rank leaf, every element within MP_STEP_BAR · lr
# (AdamW's first step moves an element by lr at most, plus the equal
# decay: where a gradient is rounding noise the two steps may go
# opposite ways) and all but MP_LOOSE_SHARE of a leaf's elements within
# MP_TIGHT_REL · |w| + MP_TIGHT_LR · lr — the K bias, whose gradient the
# softmax's shift invariance makes noise, held at the first bar alone.
MP_HOLD = (4, 64)
MP_LR = 1e-3
MP_LOSS_REL = 1e-5
MP_STEP_BAR = 2.02
MP_TIGHT_REL, MP_TIGHT_LR, MP_LOOSE_SHARE = 1e-5, 1e-2, 1e-3
MP_MOE_CF = 8.0
# (b) bf16 under "tp": 1 warm-up step and MP_TIMED timed ones of MP_TIME
# global tokens, lm_train's AdamW schedule; a sharded checkpoint after
# step MP_CKPT_AT.  (c) the restart on (1, 2): MP_RESUMED steps.
MP_TIME = (4, 2048)
MP_TIMED, MP_CKPT_AT, MP_RESUMED = 3, 2, 2
MP_DEADLINE_S = 600.0
# Both groups of ranks are spawned at once, before ``lm_train``, so
# that their processes' start (20–60 s of imports, CUDA contexts and the
# rendezvous a spawn on this card) overlaps that phase, ``lm_train_dp``,
# ``lm_moe_ep``, the parent's one-rank steps and the 4-rank run; each
# waits for its go-ahead file: the 4 ranks for the phase's start and then
# for each case's one-rank leaves (after their own step), the 2 restart
# ranks for the 4-rank run's end.
MP_POLL_S = 0.2


def mp_wait(path, deadline_s=MP_DEADLINE_S):
    """Block until ``path`` exists (another process's go-ahead); raise
    once its directory holds ``wants_failed`` (the parent failed: a
    phase before the rank's own, or the one-rank steps)."""
    t_end = time.monotonic() + deadline_s
    failed = os.path.join(os.path.dirname(path), "wants_failed")
    while not os.path.exists(path):
        if os.path.exists(failed):
            raise RuntimeError(f"no {path}: the parent failed")
        if time.monotonic() > t_end:
            raise TimeoutError(f"no {path} after {deadline_s} s")
        time.sleep(MP_POLL_S)


def mp_signal(path):
    with open(path + ".tmp", "w") as f:
        f.write("go")
    os.replace(path + ".tmp", path)


def held_job(mesh, go, fn, args):
    """A rank spawned ahead of its phase (`spawn_ahead`): ``fn(mesh,
    *args)`` once the file ``go`` exists."""
    mp_wait(go)
    return fn(mesh, *args)


def spawn_ahead(go, fn, shape, names, timeout_s, args=(), **kw):
    """`spawn_mesh` (``kw``: backend, device type) of ``fn`` started now
    on a thread, so that its processes' start (imports, CUDA contexts,
    the rendezvous: 10–60 s a spawn on the card's host) overlaps the
    phases before its own; each rank holds until ``go`` exists and fails
    once ``go``'s directory holds ``wants_failed`` → the handle
    `join_spawn` takes."""
    import threading
    from repro_torch.mesh import spawn_mesh
    box = {"go": go, "t_spawn": time.perf_counter()}

    def run():
        try:
            box["ranks"] = spawn_mesh(held_job, shape, names,
                                      timeout_s=timeout_s,
                                      args=(go, fn, args), **kw)
        except BaseException as e:      # re-raised by join_spawn
            box["error"] = e
    box["thread"] = threading.Thread(target=run, daemon=True)
    box["thread"].start()
    return box


def join_spawn(box) -> tuple:
    """A `spawn_ahead` group's go-ahead, then its ranks' results → (the
    results by rank, the seconds from the go-ahead to them, the seconds
    the spawn started before the go-ahead)."""
    t_go = time.perf_counter()
    mp_signal(box["go"])
    box["thread"].join()
    if "error" in box:
        raise box["error"]
    return (box["ranks"], time.perf_counter() - t_go,
            t_go - box["t_spawn"])


def mp_config(arch, layers, dtype, **kw):
    """An arch at its published widths (Qwen2-1.5B, OLMoE-1B-7B or one of
    `FAM_PUBLISHED`), cut to ``layers`` layers, in ``dtype``."""
    want = {LM_ARCH: LM_PUBLISHED, EP_ARCH: EP_PUBLISHED}.get(arch)
    cfg = published_lm(arch, want or FAM_PUBLISHED[arch])
    return dataclasses.replace(cfg, n_layers=layers, param_dtype=dtype,
                               compute_dtype=dtype, **kw)


def mp_cases():
    """(name, config, profile, rows) of the f32 holds: MP_HOLD's rows,
    and 2 under "fsdp" (split over "data" only: the sequence splits over
    "model")."""
    qwen = mp_config(LM_ARCH, MP_LAYERS, "float32")
    olmoe = mp_config(EP_ARCH, MP_MOE_LAYERS, "float32",
                      capacity_factor=MP_MOE_CF)
    fam = {arch: mp_config(arch, n, "float32", **(
        {"n_enc_layers": n} if arch == "whisper-medium" else {}))
        for arch, n in MP_FAM_LAYERS.items()}
    b = MP_HOLD[0]
    return [("qwen2_tp", qwen, "tp", b), ("qwen2_fsdp", qwen, "fsdp", b),
            ("qwen2_fsdp_b2", qwen, "fsdp", 2),
            ("olmoe_tp", olmoe, "tp", b),
            ("olmoe_fsdp_b2", olmoe, "fsdp", 2),
            ("mamba2_tp", fam["mamba2-2.7b"], "tp", b),
            ("zamba2_tp", fam["zamba2-7b"], "tp", b),
            ("zamba2_fsdp", fam["zamba2-7b"], "fsdp", b),
            ("whisper_tp", fam["whisper-medium"], "tp", b)]


def mp_key(cfg, rows) -> str:
    """A hold's batch and one-rank step: its config's, at ``rows``."""
    return f"{cfg.name}_b{rows}"


# lm_serve_mp (run by lm_train_mp's 4 ranks): (a) f32 holds of the
# sharded prefill and greedy decode at SERVE_HOLD prompts, SERVE_HOLD_NEW
# tokens generated, against the one-rank path on the card from the same
# draws: each rank's block of the prefill's last logits within
# SERVE_LOGIT_REL of the one-rank logits' largest magnitude, the tokens
# equal; (b) bf16 Qwen2-1.5B (MP_LAYERS layers) under "tp" and "fsdp",
# a prefill of SERVE_TIME tokens, then SERVE_NEW decode steps, timed,
# and under "fsdp" a prefill of SERVE_TIME_SPLIT tokens (2 rows: split
# over "data" only, the sequence over "model").
SERVE_HOLD = (4, 64)
SERVE_HOLD_NEW = 2     # the prefill's token and one decode step
SERVE_LOGIT_REL = 1e-5
SERVE_TIME = (4, 2048)
SERVE_TIME_SPLIT = (2, 4096)
SERVE_NEW = 8
# (record key, profile, prompt shape) of the timed runs
SERVE_TIMED = (("tp", "tp", SERVE_TIME), ("fsdp", "fsdp", SERVE_TIME),
               ("fsdp_b2", "fsdp", SERVE_TIME_SPLIT))


def serve_cases():
    """(name, config, profile, batch) of lm_serve_mp's f32 holds: a batch
    of 1 is whole on every rank, one of 2 under "fsdp" split over "data"
    only, the prompt's positions over "model" (the sequence split)."""
    qwen = mp_config(LM_ARCH, MP_LAYERS, "float32")
    olmoe = mp_config(EP_ARCH, MP_MOE_LAYERS, "float32",
                      capacity_factor=MP_MOE_CF)
    mamba = mp_config("mamba2-2.7b", MP_FAM_LAYERS["mamba2-2.7b"],
                      "float32")
    return [("qwen2_tp", qwen, "tp", 4), ("qwen2_fsdp", qwen, "fsdp", 4),
            ("qwen2_tp_b1", qwen, "tp", 1),
            ("qwen2_fsdp_b2", qwen, "fsdp", 2),
            ("olmoe_tp", olmoe, "tp", 4), ("olmoe_fsdp", olmoe, "fsdp", 4),
            ("olmoe_fsdp_b2", olmoe, "fsdp", 2),
            ("mamba2_tp", mamba, "tp", 4)]


def serve_key(cfg, batch) -> str:
    return f"{cfg.name}_b{batch}"


def serve_tokens(cfg, seed, batch):
    """The first ``batch`` prompts of SERVE_HOLD tokens of ``seed``."""
    return train_batches(cfg, 1, seed, *SERVE_HOLD)[0]["tokens"][:batch]


def serve_run(cfg, model, tokens, new, device):
    """Prefill ``tokens``, then ``new`` − 1 greedy decode steps, each
    timed from a barrier where ``model`` is sharded → (the prefill's
    logits, the (B, new) tokens, prefill ms, decode ms of each step, the
    bytes moved by kind in the prefill and in the decode steps)."""
    import torch
    import torch.distributed as dist
    from repro_torch.device import synchronize
    from repro_torch.serve.decode import (first_tokens, make_prefill,
                                          make_serve_step)
    tokens = torch.as_tensor(tokens, device=device)
    b, s = tokens.shape
    prefill = make_prefill(cfg, s + new)
    step = make_serve_step(cfg)
    sharded = getattr(model, "mesh", None) is not None

    def mark():
        if sharded:
            dist.barrier()
        synchronize(device)
        return time.perf_counter(), mp_counters()
    t0, c0 = mark()
    logits, caches = prefill(model, {"tokens": tokens})
    tok = first_tokens(cfg, model, logits, b)
    t1, c1 = mark()
    out, step_ms = [tok], []
    for _ in range(new - 1):
        ts, _ = mark()
        tok, caches = step(model, caches, tok)
        synchronize(device)
        step_ms.append((time.perf_counter() - ts) * 1e3)
        out.append(tok)
    _, c2 = mark()
    return {"logits": logits, "tokens": torch.cat(out, 1).cpu(),
            "prefill_ms": (t1 - t0) * 1e3, "step_ms": step_ms,
            "prefill_moved": {k: c1[k] - c0[k] for k in c0},
            "decode_moved": {k: c2[k] - c1[k] for k in c1}}


def serve_want(cfg, seed, tokens, device, path) -> None:
    """The one-rank path on the card (the model of ``seed`` as `build`
    draws it): its prefill logits and tokens saved to ``path``, the
    ranks' go-ahead for that hold."""
    import torch
    from repro_torch.models import DecoderLM
    torch.backends.cuda.matmul.allow_tf32 = False
    model = DecoderLM(cfg, torch.Generator(device=device).manual_seed(seed),
                      device=device)
    got = serve_run(cfg, model, tokens, SERVE_HOLD_NEW, device)
    torch.save({"logits": got["logits"].float().cpu(),
                "tokens": got["tokens"]}, path + ".tmp")
    os.replace(path + ".tmp", path)
    del model
    torch.cuda.empty_cache()


def serve_rank(mesh, seed, serve_wants, dev) -> dict:
    """lm_serve_mp on one rank: (a) each f32 hold's sharded run and its
    block of the logits and its tokens against the one-rank path's, (b)
    the timed bf16 runs."""
    import torch
    from repro_torch import mesh as M
    from repro_torch.launch.train import build
    from repro_torch.serve.decode import _vocab_block
    from repro_torch.sharding import mesh_context, profile_context, spmd
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"hold": {}, "timed": {}}
    for name, cfg, profile, b in serve_cases():
        t0 = time.perf_counter()
        with profile_context(profile):
            state, _ = build(cfg, mesh, seed=seed, device=dev.type)
            got = serve_run(cfg, state.params, serve_tokens(cfg, seed + 23,
                                                            b),
                            SERVE_HOLD_NEW, dev)
            del state
            path = serve_wants[serve_key(cfg, b)]
            t1 = time.perf_counter()
            mp_wait(path)
            wait_s = time.perf_counter() - t1
            want = torch.load(path)
            with mesh_context(mesh), spmd.rows(b, mesh):
                rows = M.shard_rows(want["logits"], mesh,
                                    spmd.batch_axes(mesh))
                v0, n = _vocab_block(cfg, mesh)
        blk = rows[..., v0:v0 + n].to(dev)
        err = float((got["logits"].float() - blk).abs().max())
        # the scale: the largest real logit (padded columns hold -1e30)
        scale = float(want["logits"][..., :cfg.vocab].abs().max())
        out["hold"][name] = {
            "max_abs_err": err, "rel": err / scale,
            "tokens_equal": bool(torch.equal(got["tokens"],
                                             want["tokens"])),
            "prefill_ms": got["prefill_ms"], "step_ms": got["step_ms"],
            "decode_moved": got["decode_moved"], "want_wait_s": wait_s,
            "seconds": time.perf_counter() - t0}
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = True
    cfg = mp_config(LM_ARCH, MP_LAYERS, "bfloat16")
    for key, profile, shape in SERVE_TIMED:
        tokens = train_batches(cfg, 1, seed + 24, *shape)[0]["tokens"]
        t0 = time.perf_counter()
        with profile_context(profile):
            state, _ = build(cfg, mesh, seed=seed + 1, device=dev.type)
            serve_run(cfg, state.params, tokens[:, :64], 2, dev)  # warm
            before = mp_counters()
            got = serve_run(cfg, state.params, tokens, SERVE_NEW, dev)
            del state
        out["timed"][key] = {
            "prefill_ms": got["prefill_ms"], "step_ms": got["step_ms"],
            "prefill_moved": got["prefill_moved"],
            "decode_moved": got["decode_moved"],
            "collective_s": mp_counters()["collective_s"]
            - before["collective_s"],
            "tokens": got["tokens"][:, :2].tolist(),
            "seconds": time.perf_counter() - t0}
        torch.cuda.empty_cache()
    return out


def mp_hold_batch(cfg, seed):
    """The f32 hold's batch: MP_HOLD tokens of ``seed``, with N(0, 1)
    frames of ``seed`` for the encoder–decoder."""
    import numpy as np
    batch = train_batches(cfg, 1, seed, *MP_HOLD)[0]
    if cfg.family == "encdec":
        batch["frames"] = np.random.default_rng(seed).standard_normal(
            (MP_HOLD[0], cfg.n_frames, cfg.d_model), dtype=np.float32)
    return batch


def mp_step_fn(cfg):
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step
    return make_train_step(cfg, adamw(), lambda s: MP_LR,
                           grad_clip=TRAIN_CLIP)


def mp_timed_step_fn(cfg):
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.train import make_train_step
    return make_train_step(cfg, adamw(), lambda s: cosine_schedule(
        s, peak=TRAIN_LR, warmup=TRAIN_WARMUP, total=1 + MP_TIMED),
        grad_clip=TRAIN_CLIP)


def mp_blocks(state) -> dict:
    """A (sharded) state's stacked parameter blocks, by reference path."""
    import torch
    from repro_torch.train.step import param_groups
    return {p: torch.stack([t.detach() for t in g.parts]).reshape(g.shape)
            for p, g in param_groups(state.params).items()}


def mp_want(cfg, seed, batch, device, path) -> dict:
    """The one-rank port step on the card: its loss and grad norm; its
    updated leaves saved to ``path``."""
    import torch
    from repro_torch.launch.train import build
    torch.backends.cuda.matmul.allow_tf32 = False
    state, _ = build(cfg, None, seed=seed, device=device)
    state, m = mp_step_fn(cfg)(state, batch)
    torch.save({k: v.cpu() for k, v in mp_blocks(state).items()},
               path + ".tmp")
    os.replace(path + ".tmp", path)     # the ranks' go-ahead for this case
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
    del state
    torch.cuda.empty_cache()
    return out


def mp_hold_blocks(state, want_path, mesh, rank) -> dict:
    """This rank's blocks of the updated leaves against its blocks of the
    one-rank step's: per leaf the largest error, the elements past the
    tight bar, the count."""
    import torch
    from repro_torch.launch.specs import model_decl
    from repro_torch.models.params import tree_paths, tree_pspecs
    from repro_torch.sharding import block_of
    want = torch.load(want_path, mmap=True)
    specs = tree_paths(tree_pspecs(model_decl(state.params.cfg), mesh))
    out = {}
    for path, got in mp_blocks(state).items():
        w = block_of(want[path], specs[path], mesh, rank).to(
            got.device).float()
        diff = (got.float() - w).abs()
        tight = MP_TIGHT_REL * w.abs() + MP_TIGHT_LR * MP_LR
        out[path] = {"max_abs_err": float(diff.max()),
                     "loose": int((diff > tight).sum()),
                     "numel": diff.numel()}
    return out


def mp_counters() -> dict:
    from repro_torch import obs
    return {k: obs.counter("mesh." + k).value for k in (
        "param_gather_bytes", "reduce_scatter_bytes", "psum_bytes",
        "all_to_all_bytes", "seq_gather_bytes", "collective_s")}


def mp_rank_job(mesh, seed, hold_batches, wants, batches, ckpt_dir,
                work_dir, serve_wants):
    """One rank of ``lm_train_mp``, once the phase begins (its ``go``
    file): (a) each f32 case's sharded step, timed with its bytes by
    kind, and its blocks held against the one-rank step's (once the
    parent has written them); (b) the timed
    bf16 steps, each with its bytes by kind and collective seconds, and
    the sharded checkpoint after step MP_CKPT_AT; then ``lm_serve_mp``
    (`serve_rank`)."""
    import torch
    import torch.distributed as dist
    from repro_torch import mesh as M
    from repro_torch.device import synchronize
    from repro_torch.ft import CheckpointManager
    from repro_torch.launch.specs import train_state_pspecs
    from repro_torch.launch.train import build, sharded_checkpoint_tree
    from repro_torch.sharding import profile_context
    t_ready = time.time()
    mp_wait(os.path.join(work_dir, "go"))
    t_start = time.time()
    dev = M.rank_device(mesh)
    rank = dist.get_rank()
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"rank": rank, "hold": {}, "hold_s": {}, "t_ready": t_ready,
           "t_start": t_start, "want_wait_s": {}}
    for name, cfg, profile, rows in mp_cases():
        key = mp_key(cfg, rows)
        t0 = time.perf_counter()
        with profile_context(profile):
            state, _ = build(cfg, mesh, seed=seed, device=dev.type)
            step = mp_step_fn(cfg)
            before = mp_counters()
            dist.barrier()
            synchronize(dev)
            t1 = time.perf_counter()
            state, m = step(state, hold_batches[key])
            synchronize(dev)
            ms = (time.perf_counter() - t1) * 1e3
            moved = {k: v - before[k] for k, v in mp_counters().items()}
            t1 = time.perf_counter()
            mp_wait(wants[key])
            out["want_wait_s"][name] = time.perf_counter() - t1
            out["hold"][name] = {
                "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "ms": ms, "bytes": moved,
                "leaves": mp_hold_blocks(state, wants[key], mesh, rank)}
        out["hold_s"][name] = time.perf_counter() - t0
        del state
        torch.cuda.empty_cache()
    cfg = mp_config(LM_ARCH, MP_LAYERS, "bfloat16")
    steps = []
    t_timed = time.perf_counter()
    with profile_context("tp"):
        state, _ = build(cfg, mesh, seed=seed + 1, device=dev.type)
        step = mp_timed_step_fn(cfg)
        peak_bytes(dev, reset=True)
        for i, b in enumerate(batches):
            before = mp_counters()
            dist.barrier()
            synchronize(dev)
            t0 = time.perf_counter()
            state, m = step(state, b)
            synchronize(dev)
            rec = {"ms": (time.perf_counter() - t0) * 1e3,
                   "loss": float(m["loss"]),
                   "grad_norm": float(m["grad_norm"])}
            rec.update({k: v - before[k] for k, v in mp_counters().items()})
            steps.append(rec)
            if i + 1 == MP_CKPT_AT:
                t0 = time.perf_counter()
                CheckpointManager(ckpt_dir).save(
                    i + 1, sharded_checkpoint_tree(state),
                    shardings=(mesh, train_state_pspecs(cfg, "adamw", mesh)))
                out["ckpt_save_s"] = time.perf_counter() - t0
        out["peak_device_bytes"] = peak_bytes(dev)
    out["timed"] = steps
    out["timed_s"] = time.perf_counter() - t_timed
    del state
    torch.cuda.empty_cache()
    dist.barrier()
    if M.is_first(mesh):
        mp_signal(os.path.join(work_dir, "four_ranks_done"))
    t0 = time.perf_counter()
    out["serve"] = serve_rank(mesh, seed, serve_wants, dev)
    out["serve_s"] = time.perf_counter() - t0
    out["t_end"] = time.time()
    return out


def mp_resume_job(mesh, seed, batches, ckpt_dir, work_dir):
    """One rank of the restart: `make_mesh_for` over the 2 ranks left
    (model_parallel 2: (1, 2)), a bf16 model built there, the checkpoint
    restored (`restore_sharded`), each restored block compared bit for
    bit (as 16- or 32-bit integers) with its block of the saved global
    leaf, then the remaining steps."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.ft import CheckpointManager, make_mesh_for
    from repro_torch.ft.checkpoint import _flatten_with_paths, flatten_specs
    from repro_torch.launch.specs import train_state_pspecs
    from repro_torch.launch.train import (build, restore_sharded,
                                          sharded_checkpoint_tree)
    from repro_torch.sharding import block_of, profile_context
    t_ready = time.time()
    mp_wait(os.path.join(work_dir, "four_ranks_done"))
    t_start = time.time()
    rank = dist.get_rank()
    new = make_mesh_for(list(range(dist.get_world_size())),
                        model_parallel=2, device_type=mesh.device_type)
    cfg = mp_config(LM_ARCH, MP_LAYERS, "bfloat16")

    def bits(t):
        return t.view({2: torch.int16, 4: torch.int32,
                       8: torch.int64}[t.element_size()])
    t0 = time.perf_counter()
    with profile_context("tp"):
        state, _ = build(cfg, new, seed=seed + 2, device=new.device_type)
        step = mp_timed_step_fn(cfg)
        build_s = time.perf_counter() - t0
        mgr = CheckpointManager(ckpt_dir)
        t0 = time.perf_counter()
        state = restore_sharded(mgr, state, "adamw")
        restore_s = time.perf_counter() - t0
        d, manifest = mgr._manifest(mgr.latest_step())
        specs = dict(flatten_specs(train_state_pspecs(cfg, "adamw", new)))
        same, leaves = 0, 0
        for path, t in _flatten_with_paths(sharded_checkpoint_tree(state)):
            saved = np.load(os.path.join(d, manifest[path]["file"]),
                            mmap_mode="r")
            blk = torch.from_numpy(np.array(block_of(saved, specs[path], new,
                                                     rank))).to(t.device)
            leaves += 1
            same += bool(torch.equal(bits(t.contiguous()), bits(blk)))
        digest_s = time.perf_counter() - t0 - build_s - restore_s
        losses = []
        for b in batches:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        steps_s = time.perf_counter() - t0 - build_s - restore_s - digest_s
    return {"rank": rank, "mesh": list(new.mesh.shape),
            "step": int(state.step) - len(batches), "restore_s": restore_s,
            "build_s": build_s, "digest_s": digest_s, "steps_s": steps_s,
            "t_ready": t_ready, "t_start": t_start, "t_end": time.time(),
            "leaves": leaves, "bit_equal": same, "losses": losses}


def start_lm_train_mp(seed, device, work_dir):
    """``lm_train_mp``'s two groups of ranks, spawned ahead of the phase
    so that their processes' start overlaps the phases before it: each
    waits in ``work_dir`` for its go-ahead (the 4 ranks for ``go``, which
    `run_lm_train_mp` writes) or for ``wants_failed`` → the handle
    `run_lm_train_mp` takes."""
    import threading
    from repro_torch import mesh as M
    hold_batches, wants = {}, {}
    for _, cfg, _, rows in mp_cases():
        key = mp_key(cfg, rows)
        hold_batches[key] = {k: v[:rows] for k, v in
                             mp_hold_batch(cfg, seed + 21).items()}
        wants[key] = str(work_dir / f"want_{key}.pt")
    serve_wants = {serve_key(cfg, b): str(
        work_dir / f"serve_want_{serve_key(cfg, b)}.pt")
        for _, cfg, _, b in serve_cases()}
    cfg = mp_config(LM_ARCH, MP_LAYERS, "bfloat16")
    batches = train_batches(cfg, 1 + MP_TIMED, seed + 22, *MP_TIME)
    ckpt_dir = str(work_dir / "ckpt")
    spawns = {
        "four_ranks": (mp_rank_job, MP_SHAPE, (
            seed, hold_batches, wants, batches, ckpt_dir, str(work_dir),
            serve_wants)),
        "two_ranks": (mp_resume_job, (1, 2), (
            seed, batches[MP_CKPT_AT:], ckpt_dir, str(work_dir)))}
    got, walls = {}, {}

    def spawn(name):
        fn, shape, args = spawns[name]
        walls[name] = [time.time()]
        try:
            got[name] = M.spawn_mesh(fn, shape, MP_NAMES, backend="gloo",
                                     device_type=device.type,
                                     timeout_s=MP_DEADLINE_S, args=args)
        except BaseException as e:      # re-raised below
            got[name] = e
        walls[name].append(time.time())
        if name == "four_ranks":        # the restart's go-ahead, whatever
            done = str(work_dir / "four_ranks_done")    # the outcome
            if not os.path.exists(done):
                mp_signal(done)
    threads = [threading.Thread(target=spawn, args=(n,), daemon=True)
               for n in spawns]
    for t in threads:
        t.start()
    return {"threads": threads, "got": got, "walls": walls,
            "spawns": spawns, "hold_batches": hold_batches, "wants": wants,
            "serve_wants": serve_wants}


def run_lm_train_mp(seed, device, work_dir, dp_rec, started):
    """Phase ``lm_train_mp``: the sharded trainer (`launch.train.build` /
    its step on a mesh, `sharding.spmd`) on MP_SHAPE gloo ranks sharing
    the card, spawned by `start_lm_train_mp` (``started``).  (a) each
    case of `mp_cases` at its published widths in f32, one step held
    against the one-rank step; (b) Qwen2-1.5B in bf16, timed, with its
    bytes by kind; (c) the restart on 2 of the ranks from (b)'s sharded
    checkpoint."""
    import numpy as np
    import torch
    t_phase = time.perf_counter()
    t_go = time.time()
    mp_signal(str(work_dir / "go"))
    threads, got, walls = (started[k] for k in ("threads", "got", "walls"))
    spawns, hold_batches, wants = (started[k] for k in (
        "spawns", "hold_batches", "wants"))
    want_rec = {}
    t0 = time.perf_counter()
    serve_wants = started["serve_wants"]
    served = set()
    try:
        for _, cfg, _, rows in mp_cases():
            key = mp_key(cfg, rows)
            if key not in want_rec:
                want_rec[key] = mp_want(cfg, seed, hold_batches[key],
                                        device, wants[key])
        for _, cfg, _, b in serve_cases():
            key = serve_key(cfg, b)
            if key not in served:
                serve_want(cfg, seed, serve_tokens(cfg, seed + 23, b),
                           device, serve_wants[key])
                served.add(key)
    finally:
        if len(want_rec) < len(wants) or len(served) < len(serve_wants):
            mp_signal(str(work_dir / "wants_failed"))  # the ranks fail
        want_s = time.perf_counter() - t0
        for t in threads:
            t.join()
    for name in spawns:
        if isinstance(got[name], BaseException):
            raise got[name]
    ranks, resumed = got["four_ranks"], got["two_ranks"]
    spawn_s = walls["four_ranks"][1] - walls["four_ranks"][0]
    resume_spawn_s = walls["two_ranks"][1] - walls["two_ranks"][0]
    # a spawn's seconds before its ranks were ready (process start,
    # imports, the group), its wait for the go-ahead, and after the last
    # rank's job ended (teardown)
    overhead = {name: {"start": max(r["t_ready"] for r in got[name])
                       - walls[name][0],
                       "wait": max(r["t_start"] - r["t_ready"]
                                   for r in got[name]),
                       "teardown": walls[name][1] - max(
                           r["t_end"] for r in got[name])}
                for name in spawns}
    hold = {}
    for name, cfg, profile, rows in mp_cases():
        want = want_rec[mp_key(cfg, rows)]
        per = [r["hold"][name] for r in ranks]
        gaps = {}
        for key in ("loss", "grad_norm"):
            gap = max(abs(p[key] - want[key]) / abs(want[key]) for p in per)
            gaps[key + "_rel"] = gap
            if gap > MP_LOSS_REL:
                raise AssertionError(f"lm_train_mp: {name} {key} off the "
                                     f"one-rank step by {gap}: {per}")
        worst, loose = 0.0, {}
        for r, p in enumerate(per):
            for path, e in p["leaves"].items():
                worst = max(worst, e["max_abs_err"])
                if e["max_abs_err"] > MP_STEP_BAR * MP_LR:
                    raise AssertionError(f"lm_train_mp: {name} rank {r} "
                                         f"{path}: {e}")
                if e["loose"] and not path.endswith("attn/bk"):
                    loose[path] = loose.get(path, 0) + e["loose"]
                    if e["loose"] > MP_LOOSE_SHARE * e["numel"]:
                        raise AssertionError(f"lm_train_mp: {name} rank {r} "
                                             f"{path}: {e}")
        hold[name] = {"arch": cfg.name, "profile": profile, "rows": rows,
                      "want": want,
                      "losses": [p["loss"] for p in per],
                      "grad_norms": [p["grad_norm"] for p in per],
                      **gaps, "leaves": len(per[0]["leaves"]),
                      "max_abs_err": worst,
                      "worst_over_step_bar": worst / (MP_STEP_BAR * MP_LR),
                      "loose_elements": loose,
                      "step_ms_slowest_rank": max(p["ms"] for p in per),
                      "bytes_per_rank": per[0]["bytes"],
                      "want_wait_s": max(r["want_wait_s"][name]
                                         for r in ranks)}
    timed = [[r["timed"][i] for r in ranks] for i in range(1 + MP_TIMED)]
    losses = [s[0]["loss"] for s in timed]
    if not all(math.isfinite(x) for x in losses) or any(
            s[j]["loss"] != s[0]["loss"] for s in timed
            for j in range(len(s))):
        raise AssertionError(f"lm_train_mp: the ranks' losses {timed}")
    slowest = [max(r["ms"] for r in s) for s in timed[1:]]
    tokens = MP_TIME[0] * MP_TIME[1]
    by_kind = {k: [s[0][k] for s in timed[1:]] for k in (
        "param_gather_bytes", "reduce_scatter_bytes", "psum_bytes",
        "all_to_all_bytes")}
    coll = [max(r["collective_s"] for r in s) for s in timed[1:]]
    for r in resumed:
        if r["bit_equal"] != r["leaves"] or r["step"] != MP_CKPT_AT:
            raise AssertionError(f"lm_train_mp: restore on (1, 2): {r}")
        if not r["losses"][0] < losses[0] + 0.5:
            raise AssertionError(f"lm_train_mp: resumed loss "
                                 f"{r['losses'][0]} not below the first "
                                 f"{losses[0]} + 0.5")
    rec = {"mesh": dict(zip(MP_NAMES, MP_SHAPE)), "backend": "gloo",
           "want_s": want_s, "spawn_s": spawn_s,
           "spawned_before_phase_s": t_go - walls["four_ranks"][0],
           "spawn_overhead_s": overhead,
           "hold_s": {name: max(r["hold_s"][name] for r in ranks)
                      for name, _, _, _ in mp_cases()},
           "timed_s": max(r["timed_s"] for r in ranks),
           "hold_f32": {"tokens": list(MP_HOLD), "lr": MP_LR,
                        "cases": hold,
                        "bars": {"loss_rel": MP_LOSS_REL,
                                 "step_bar_lr": MP_STEP_BAR,
                                 "tight": [MP_TIGHT_REL, MP_TIGHT_LR],
                                 "loose_share": MP_LOOSE_SHARE}},
           "timed_bf16": {
               "arch": LM_ARCH, "layers": MP_LAYERS, "profile": "tp",
               "tokens": list(MP_TIME), "losses": losses,
               "step_ms_slowest_rank": slowest,
               "step_ms_median": float(np.median(slowest)),
               "tokens_per_s": tokens / (float(np.median(slowest)) / 1e3),
               "peak_gb_per_rank": [(r["peak_device_bytes"] or 0) / 1e9
                                    for r in ranks],
               "bytes_per_rank_step": by_kind,
               "collective_s_slowest_rank": coll,
               "collective_share": float(np.median(
                   [c * 1e3 / ms for c, ms in zip(coll, slowest)])),
               "ckpt_save_s": max(r["ckpt_save_s"] for r in ranks),
               "lm_train_dp_step_ms_median": float(np.median(
                   [s * 1e3 for s in dp_rec["rank_step_s"][0][1:]]))
               if dp_rec else None},
           "restart": {"mesh": resumed[0]["mesh"],
                       "spawn_s": resume_spawn_s,
                       "restore_s": max(r["restore_s"] for r in resumed),
                       "build_s": max(r["build_s"] for r in resumed),
                       "digest_s": max(r["digest_s"] for r in resumed),
                       "steps_s": max(r["steps_s"] for r in resumed),
                       "leaves_bit_equal": [r["bit_equal"]
                                            for r in resumed],
                       "resumed_losses": resumed[0]["losses"],
                       "four_rank_losses": losses[MP_CKPT_AT:]}}
    rec["seconds"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    emit({"phase": "lm_train_mp", "nvidia_smi": nvidia_smi(), **rec})
    emit(serve_record(ranks))


def serve_record(ranks) -> dict:
    """Phase ``lm_serve_mp``'s record from the 4 ranks' `serve_rank`
    results; raises past a gate."""
    import numpy as np
    hold = {}
    for name, cfg, profile, b in serve_cases():
        per = [r["serve"]["hold"][name] for r in ranks]
        for r, p in enumerate(per):
            if not p["tokens_equal"] or not p["rel"] <= SERVE_LOGIT_REL:
                raise AssertionError(f"lm_serve_mp: {name} rank {r}: {p}")
        hold[name] = {"arch": cfg.name, "profile": profile, "batch": b,
                      "max_abs_err": max(p["max_abs_err"] for p in per),
                      "rel": max(p["rel"] for p in per),
                      "tokens_equal": True,
                      "prefill_ms_slowest_rank": max(p["prefill_ms"]
                                                     for p in per),
                      "decode_bytes_rank0": per[0]["decode_moved"]}
    timed = {}
    for key, profile, shape in SERVE_TIMED:
        per = [r["serve"]["timed"][key] for r in ranks]
        if any(p["tokens"] != per[0]["tokens"] for p in per):
            raise AssertionError(f"lm_serve_mp: {key}: the ranks' "
                                 f"tokens differ: {per}")
        timed[key] = {
            "profile": profile, "tokens": list(shape),
            "per_rank": [{
                "prefill_ms": p["prefill_ms"],
                "decode_ms_per_token": float(np.median(p["step_ms"])),
                "prefill_bytes": p["prefill_moved"],
                "decode_bytes": p["decode_moved"],
                "collective_s": p["collective_s"]} for p in per],
            "seconds": max(p["seconds"] for p in per)}
    return {"phase": "lm_serve_mp", "nvidia_smi": nvidia_smi(),
            "mesh": dict(zip(MP_NAMES, MP_SHAPE)), "backend": "gloo",
            "hold_f32": {"tokens": list(SERVE_HOLD), "new": SERVE_HOLD_NEW,
                         "logit_rel_bar": SERVE_LOGIT_REL, "cases": hold},
            "timed_bf16": {"arch": LM_ARCH, "layers": MP_LAYERS,
                           "new": SERVE_NEW, "runs": timed},
            "seconds": max(r["serve_s"] for r in ranks)}


def peak_bytes(device, reset=False):
    """The card's peak allocated bytes (None on the CPU); ``reset``
    starts a new peak."""
    import torch
    if device.type != "cuda":
        return None
    if reset:
        torch.cuda.reset_peak_memory_stats(device)
    return torch.cuda.max_memory_allocated(device)


def time_calls(fn, device, reps=EP_REPS, before=None) -> list:
    """``fn()`` once to warm up, then ``reps`` times, each from a
    synchronize (after ``before()``: the ranks' barrier) to a
    synchronize: ms each."""
    from repro_torch.device import synchronize
    fn()
    ms = []
    for _ in range(reps):
        if before is not None:
            before()
        synchronize(device)
        t0 = time.perf_counter()
        fn()
        synchronize(device)
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def bound_batched(t: int, n: int, d: int, c: int):
    """(ms, what sets it) for one tenant-stacked sweep: the (T, N, d)
    block, its (T, N) weights, V and m read once, the outputs written
    once, against 4·T·N·C·d f32 flops."""
    nbytes = 4 * (t * n * (d + 1) + 2 * t * c * d + t * c + 2 * t)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 4 * t * n * c * d / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_line(per_run) -> list:
    """One entry per kernel: its launches summed over the main-path
    runs, its worst error, and the numbers (and source file) of the shape
    with the most work (the largest bound) on top; every (run, shape)'s
    numbers, path and source under ``runs``."""
    entries = {}
    for e in per_run:
        name = e["name"] + {"ctiled": "_ctiled", "wide": "_wide"}.get(
            e["path"], "")
        if e["name"] == "fcm_sweep_batched" and e["path"] == "tile":
            name += "_tile"
        entries.setdefault(name, []).append(e)
    out = []
    for name, runs in entries.items():
        top = max(runs, key=lambda e: e["bound_ms"])
        for e in runs:
            e["source"] = f"{CSRC}/{PATH_SOURCE[e['name'], e['path']]}.cu"
        out.append({
            "name": name, "route": "cuda", "source": top["source"],
            "replaces": REPLACES[top["name"]],
            "launches": sum(e["launches"] for e in runs),
            "max_abs_err": max(e["max_abs_err"] for e in runs),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top.get("library_ms"), "at": top["run"],
            "runs": {e["run"]: {k: e[k] for k in (
                "launches", "max_abs_err", "ms", "ms_per_call", "plain_ms",
                "bound_ms", "bound_by", "bound_share", "shape", "path",
                "source", "dsplits", "rows", "launch_ms", "member_library_ms",
                "contraction_library_ms", "fleet_launches", "real_row_share")
                if k in e}
                for e in runs}})
    return out


# Phase ``dryrun``: the port's dry run of these cells, in a subprocess
# started before the build on one torch thread (fake tensors: no card
# work), collected before the kernels line.
DRYRUN_CELLS = ("qwen2-1.5b__train_4k__pod1",
                "qwen2-1.5b__train_4k__pod1__fsdp",
                "olmoe-1b-7b__train_4k__pod2__fsdp",
                "zamba2-7b__decode_32k__pod1",
                "mamba2-2.7b__long_500k__pod1",
                "kimi-k2-1t-a32b__decode_32k__pod1")
DRYRUN_DEADLINE_S = 900.0


def start_dryrun(out_dir: Path):
    """``python -m repro_torch.launch.dryrun`` over DRYRUN_CELLS into
    ``out_dir``, started now → (the process, its start on the perf
    counter, its start on the wall clock)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--out-dir", str(out_dir)]
    for cell in DRYRUN_CELLS:
        cmd += ["--cell", cell]
    log = open(out_dir / "log.txt", "w")
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                            env=env, cwd=str(ROOT))
    log.close()
    return proc, time.perf_counter(), time.time()


def run_dryrun(started, out_dir: Path) -> dict:
    """Phase ``dryrun``: wait for the subprocess, then each cell's
    status, a rank's argument and peak GB, its FLOPs, its collective
    bytes by kind, the three roofline terms and the bottleneck; raises
    if the process failed or a cell is not "ok"."""
    proc, t0, t0_wall = started
    t_wait = time.perf_counter()
    try:
        code = proc.wait(timeout=max(1.0, DRYRUN_DEADLINE_S
                                     - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    waited = time.perf_counter() - t_wait
    cells = {}
    for cell in DRYRUN_CELLS:
        path = out_dir / f"{cell}.json"
        if not path.exists():
            raise AssertionError(f"dryrun: no record of {cell}: "
                                 + (out_dir / "log.txt").read_text()[-3000:])
        rec = json.loads(path.read_text())
        if rec["status"] != "ok":
            raise AssertionError(f"dryrun: {cell}: {rec.get('error')}\n"
                                 f"{rec.get('traceback')}")
        ro, mem = rec["roofline"], rec["memory_analysis"]
        cells[cell] = {
            "status": rec["status"], "trace_s": rec["t_lower_s"],
            "argument_gb": mem["argument_size_in_bytes"] / 1e9,
            "peak_gb": rec["peak_bytes_per_rank"] / 1e9,
            "card_gb": rec["card_memory_bytes"] / 1e9,
            "counted_flops": rec["compiled_cost"]["flops"],
            "flops_per_dev": ro["flops_per_dev"],
            "counted_over_flops_per_dev": (rec["compiled_cost"]["flops"]
                                           / ro["flops_per_dev"]),
            "coll_breakdown": ro["coll_breakdown"],
            "t_compute_s": ro["t_compute_s"], "t_memory_s": ro["t_memory_s"],
            "t_collective_s": ro["t_collective_s"],
            "bottleneck": ro["bottleneck"], "mfu_bound": ro["mfu_bound"]}
    if code != 0:
        raise AssertionError(f"dryrun exited {code}: "
                             + (out_dir / "log.txt").read_text()[-3000:])
    # the process's own end: its last write (the log or a record)
    done_s = max(p.stat().st_mtime for p in out_dir.iterdir()) - t0_wall
    return {"phase": "dryrun", "cells": cells,
            "seconds": time.perf_counter() - t0, "done_after_s": done_s,
            "waited_s": waited, "nvidia_smi": nvidia_smi()}


# Phase ``examples``: the port's six examples (examples/torch_*.py) on
# the card, each in a process of its own with ``--device cuda`` and its
# default sizes, all started together after ``lm_families`` (whose
# timed loops have the card and the host to themselves).  Each must exit
# 0 with its reference's final "OK" line; the BigFCM ones print their
# kernels' launches by wrapper and plan path, held: every one on a path
# of the hand-written kernels, and for each of the example's roles some
# launch of one of its wrappers.  Backend "auto" races the two kernel
# backends per bucket ("hopper" sweeps with K2, "hopper_accumulate" with
# K1 and a normalization), so a role names both: the single-model fits
# K1 or K2, the cluster service's tenant fit their tenant-stacked twins.
EXAMPLES = {"torch_quickstart.py":
            "OK -- BigFCM recovered the mixture centers",
            "torch_stream_clustering.py":
            "OK -- bounded-skew disorder is absorbed by the event-time "
            "window.",
            "torch_cluster_service.py":
            "OK -- restart restores the clustering state bit-exactly.",
            "torch_serve_batch.py":
            "OK -- batched KV-cached serving matches the uncached oracle.",
            "torch_moe_router_init.py":
            "OK -- FCM-seeded router routes coherently",
            "torch_train_lm.py":
            "OK -- loss decreased; rerun the same command to test "
            "restart."}
SINGLE_MODEL = ("fcm_accumulate_cuda", "fcm_sweep_cuda")
TENANT_STACKED = ("fcm_accumulate_batched_cuda", "fcm_sweep_batched_cuda")
EXAMPLE_KERNELS = {"torch_quickstart.py": (SINGLE_MODEL,),
                   "torch_stream_clustering.py": (SINGLE_MODEL,),
                   "torch_cluster_service.py": (SINGLE_MODEL,
                                                TENANT_STACKED),
                   "torch_moe_router_init.py": (SINGLE_MODEL,)}
KERNEL_PATHS = {path for _, path in PATH_SOURCE}
EXAMPLES_DEADLINE_S = 600.0

def run_examples(work_dir: Path) -> dict:
    """Phase ``examples``: each of EXAMPLES in a process of its own, its
    own directory under ``work_dir`` for its output, temporary files and
    calibration, all started at once; then each one's exit, its "OK"
    line and its launches, held."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    procs = {}
    try:
        for name in EXAMPLES:
            d = work_dir / name[:-3]
            d.mkdir()
            with open(d / "out.txt", "w") as out, \
                    open(d / "err.txt", "w") as err:
                procs[name] = subprocess.Popen(
                    [sys.executable, str(ROOT / "examples" / name),
                     "--device", "cuda"], stdout=out, stderr=err,
                    env=dict(env, TMPDIR=str(d),
                             REPRO_CALIB_DIR=str(d / "calib")),
                    cwd=str(d))
        rec = {}
        for name, proc in procs.items():
            code = proc.wait(timeout=max(1.0, EXAMPLES_DEADLINE_S
                                         - (time.perf_counter() - t0)))
            d = work_dir / name[:-3]
            lines = (d / "out.txt").read_text().splitlines()
            if code != 0:
                raise AssertionError(f"examples: {name} exited {code}: "
                                     + (d / "err.txt").read_text()[-3000:])
            ok = [ln for ln in lines if ln.startswith("OK")]
            if not ok or not ok[-1].startswith(EXAMPLES[name]):
                raise AssertionError(f"examples: {name} printed no "
                                     f"{EXAMPLES[name]!r}: {lines[-20:]}")
            rec[name] = {"seconds": time.perf_counter() - t0,
                         "ok": ok[-1], "last_lines": lines[-4:]}
            if name in EXAMPLE_KERNELS:
                rec[name]["launches"] = example_launches(name, lines)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {"phase": "examples", "examples": rec,
            "seconds": time.perf_counter() - t0, "nvidia_smi": nvidia_smi()}


def example_launches(name, lines) -> dict:
    """An example's printed launches by wrapper and path, held (see the
    phase's note)."""
    got = [ln for ln in lines if ln.startswith("kernel launches: ")]
    if not got:
        raise AssertionError(f"examples: {name} printed no launches")
    launches = json.loads(got[-1][len("kernel launches: "):])
    for fn, paths in launches.items():
        if set(paths) - KERNEL_PATHS:
            raise AssertionError(f"examples: {name}: {fn} launched on "
                                 f"{sorted(paths)}")
    for role in EXAMPLE_KERNELS[name]:
        if not sum(sum(launches.get(fn, {}).values()) for fn in role):
            raise AssertionError(f"examples: {name} launched none of "
                                 f"{role}: {launches}")
    return launches


def build_all() -> dict:
    """Build every kernel source at once (one ``nvcc`` each, in
    parallel), timed; returns each one's ptxas register/smem lines."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        logs = dict(zip(SOURCES, pool.map(
            lambda name: build.compile_source(name, verbose=True), SOURCES)))
    return {"phase": "build", "seconds": time.perf_counter() - t0,
            "ptxas": {name: [ln.strip() for ln in log.splitlines()
                             if "registers" in ln or "smem" in ln]
                      for name, log in logs.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA card only", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))

    device = torch.device("cuda", 0)
    emit({"phase": "device", "nvidia_smi": nvidia_smi(),
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda})
    stores = ROOT / "build"
    stores.mkdir(exist_ok=True)
    # The calibration sandbox: no earlier run's winners or tuned plans
    # change a plan here.
    calib_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_calib_",
                                      dir=stores))
    os.environ["REPRO_CALIB_DIR"] = str(calib_dir)
    try:
        return run_all(args, device)
    finally:
        shutil.rmtree(calib_dir, ignore_errors=True)


def run_all(args, device) -> int:
    """Phases 1 (the build) to 9, in the calibration sandbox; the dry run
    in a subprocess alongside."""
    dry_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_",
                                    dir=ROOT / "build"))
    dry = start_dryrun(dry_dir)
    try:
        return run_phases(args, device, dry, dry_dir)
    finally:
        if dry[0].poll() is None:
            dry[0].kill()
            dry[0].wait()
        shutil.rmtree(dry_dir, ignore_errors=True)


def run_phases(args, device, dry, dry_dir) -> int:
    from concurrent.futures import ThreadPoolExecutor
    import torch
    # phase 3's arrays, made on the host while nvcc builds the kernels
    pool = ThreadPoolExecutor(1)
    made = pool.submit(main_path_arrays, args.seed)
    pool.shutdown(wait=False)
    emit(build_all())

    emit(check_kernels(device))
    emit(check_tenant_kernels(device))
    emit(check_ctiled_kernels(device))
    emit(check_wide_kernels(device))
    torch.cuda.empty_cache()
    emit(run_calibrate(device))
    torch.cuda.empty_cache()

    entries, held = [], {}
    arrays = made.result()
    for run in RUNS:
        got, held[run.name] = run_main_path(run, arrays.pop(run.name),
                                            args.seed, device, reps=20)
        entries += got
        torch.cuda.empty_cache()
    entries += run_router_fit(arrays.pop("router_fit"), args.seed, device,
                              reps=20)
    del arrays
    for run in TENANT_RUNS:
        entries.append(run_tenant_path(run, args.seed, device, reps=20))
        torch.cuda.empty_cache()
    stores = ROOT / "build"
    store_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_stores_",
                                      dir=stores))
    kdd_x = held["kdd99_like"]["x"]
    kdd_centers = held["kdd99_like"]["centers"]["hopper"].numpy()
    kdd_m = held["kdd99_like"]["cfg"].m
    mesh_x = {run.name: held[run.name]["x"] for run in RUNS}
    mesh_cfgs = {run.name: held[run.name]["cfg"] for run in RUNS}
    mesh_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_", dir=stores))
    try:
        try:
            for run in RUNS:
                run_held = held.pop(run.name)
                entries.append(run_store_path(run, run_held, store_dir,
                                              device))
                torch.cuda.empty_cache()
                if run.name == FLEET_RUN:
                    entries += run_fleet_path(run, run_held,
                                              held["kdd99_like"], store_dir,
                                              entries, device)
                    torch.cuda.empty_cache()
                    # the mesh phase's ranks start during the store phase
                    # after the fleet's
                    mesh = start_mesh_path(mesh_x, mesh_cfgs, args.seed,
                                           mesh_dir)
        finally:
            shutil.rmtree(store_dir, ignore_errors=True)
        entries += run_mesh_path(mesh, mesh_cfgs, device)
    except BaseException:               # the waiting ranks fail and exit
        mp_signal(str(mesh_dir / "wants_failed"))
        raise
    finally:
        shutil.rmtree(mesh_dir, ignore_errors=True)
    del mesh_x, mesh
    torch.cuda.empty_cache()
    emit(run_serve(kdd_x, kdd_centers, kdd_m, args.seed, device))
    torch.cuda.empty_cache()
    ckpt_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_stream_", dir=stores))
    try:
        entries += run_stream_path(kdd_x, args.seed, device, ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    model, lm_cfg = run_lm_serve(args.seed, device)
    torch.cuda.empty_cache()
    entries += run_curriculum(model, lm_cfg, args.seed, device, reps=20)
    del model
    torch.cuda.empty_cache()
    mp_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_mp_", dir=stores))
    try:
        # the ranks of lm_train_dp, lm_moe_ep and lm_train_mp, spawned
        # now: their processes start during lm_train
        started = start_lm_train_mp(args.seed, device, mp_dir)
        try:
            dp = start_lm_train_dp(args.seed, device, mp_dir)
            ep = start_lm_moe_ep(args.seed, device, mp_dir)
            ckpt_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_train_",
                                             dir=stores))
            try:
                run_lm_train(args.seed, device, ckpt_dir)
            finally:
                shutil.rmtree(ckpt_dir, ignore_errors=True)
            torch.cuda.empty_cache()
            dp_rec = run_lm_train_dp(args.seed, device, dp)
            torch.cuda.empty_cache()
            run_lm_moe_ep(args.seed, device, ep)
        except BaseException:           # the waiting ranks fail and exit
            mp_signal(str(mp_dir / "wants_failed"))
            raise
        torch.cuda.empty_cache()
        run_lm_train_mp(args.seed, device, mp_dir, dp_rec, started)
    finally:
        shutil.rmtree(mp_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    entries += run_lm_families(args.seed, device, reps=20)
    torch.cuda.empty_cache()
    ex_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_examples_",
                                   dir=stores))
    try:
        emit(run_examples(ex_dir))
    finally:
        shutil.rmtree(ex_dir, ignore_errors=True)
    emit(run_dryrun(dry, dry_dir))
    return finish(entries, device)


def finish(entries, device) -> int:
    """Phase 9: the kernels line, the ``nvidia-smi`` line, and the final
    ``{"ok": true, ...}`` line."""
    import torch
    emit({"kernels": kernel_line(entries),
          "library_note": "no single PyTorch call computes the FCM sweep, "
                          "single-model or tenant-stacked"})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
