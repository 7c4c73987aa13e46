"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # everything below
    python3 chip_smoke.py --kernels-only  # phases 1-3c, then stop (no "ok" line)
    python3 chip_smoke.py --kernels-only --sass out/sass
        # also: cuobjdump's SASS of every library into a directory
    python3 chip_smoke.py --mesh-cards    # needs two cards or more:
        # phases 1-2, the scene, main_path, then mesh_cards (no "ok" line)
    python3 chip_smoke.py --stages        # phases 1-2, main_path, profile,
        # item_waves, then stage_split and stage_split_render (no "ok" line)
    python3 chip_smoke.py --fused-stages  # phases 1-2, main_path,
        # path_fused, profile_fused, fused_cascade, then fused_stage_render
        # (the fused render's stages' bounds, eager sweeps: ~190 s; no "ok")

Phases (each prints one JSON line; any failure exits non-zero):
  1. device       CUDA must be available; the card's name and power limit;
                  torch's f32 sqrt on the card against its f64 sqrt rounded
                  once, on 2^24 inputs (none may differ: vec.sqrt_rn keeps
                  torch.sqrt on the card), and the f32 tan at 676 fovs
                  (the camera takes the f64 one on every device).
  2. build        nvcc builds every kernel source under csrc/, in parallel;
                  registers and spills of every kernel as ptxas reports them,
                  and the registers and resident warps per SM of the five
                  kernels at their paths' shapes.
  3. kernel       each of the five kernels against its plain PyTorch version
                  on the card, at its path's shapes (bitwise t; exact
                  cluster, slot, triangle id and occlusion; the fused
                  kernels' early_skip / sub_skip gates on == off).
                  tile_sweep at its three shapes: the closest path's
                  (T 128, S 256), the shadow cascade's with one cluster a
                  tile (T 64, S 128) and with two (tile_cid [nt, 2]), the
                  last also against two single-cluster launches folded;
                  its sub_skip and pack_t instances on the tiles of the
                  (T 128, S 256), (T 128, S 128) and (T 64, S 128) checks:
                  bitwise against their plain versions and the default
                  instance, timed, bounded (sub_skip over the sub-slabs its
                  plain version sweeps), registers and warps per SM; the
                  tile_sweep_options line sets them beside the default
                  instance and its figures from before the options
                  existed (0.2015 ms, 93/0/16; PERF.md's kernel table).
  3b. sweep_waves closest_sweep on the pallas bench render's own waves (wave
                  0 at bounce 0 and 1, kept from one render): bitwise
                  against its plain version, timed and bounded on each whole
                  wave, and timed on its first 2048 blocks alone.
  3c. generic_kernels each kernel's generic instance (S at run time, the
                  one that serves the cluster sizes no tuned instance is
                  compiled for) forced at S = 128 on the same inputs as
                  its tuned instance: tile_sweep at (T 64, G 2) and (T 128),
                  the pallas sweeps, the fused kernels, kslot_sweep's
                  closest wave, item_sweep on the worklist render's kept
                  closest wave; bitwise its plain version, timed and
                  bounded beside the tuned instance's time (after
                  item_waves, whose waves it reuses; also under
                  --kernels-only).
  3d. sweep_cases item_sweep and kslot_sweep on the crafted cases of
                  tests/test_torch_sweep_cases.py (exact t ties across an
                  item's clusters or a row's slots, a cluster named twice,
                  garbage slots, dead and overflowed rays, n_items 0 and =
                  i_cap, rays all occluded by the first chunk) at S 2, 16,
                  96, 128, 512, closest and any hit, through the instance
                  the wrapper picks and the generic one: each bitwise its
                  plain version (also under --kernels-only). Also the
                  first-slot instances of tile_sweep (tiles of T 1, 64,
                  256 lanes, G 1, 4, 8 clusters) and kslot_sweep (K 1, 4,
                  8) on the first-slot cases (exact t ties across a tile's
                  clusters and within one cluster, where the first slot's
                  id is the larger; dead lanes; misses; a cluster named
                  twice), tuned and generic. Also the cascade stage
                  kernel on the crafted cascades (cascade_case:
                  a stage ending with exactly size // 2 blocks active,
                  fewer than 64 blocks, blocks with no candidate, all
                  lanes dead, k carried over four stages, a closest block
                  retired by the entry rule and swept on to a nearer hit
                  on a box face, -0.0 / +0.0 ties) at S 16 and 128, T 1,
                  64, 256, G 2, 5, 8, both folds, tuned and generic: the
                  carry, block order and final k of its plain version.
                  The item_sweep and kslot_sweep lines of the kernel,
                  item_waves and generic_kernels phases carry the
                  instance's registers, spills and warps an SM and, for a
                  tuned instance, the time the earlier design took on the
                  same wave (earlier_ms).
  4. main_path    the benchmark render (blob subdiv 6 + room, 1920x1080,
                  2 spp, 5 bounces, seed 0, waves of 2^20, blocks of 64)
                  through path_tracer_ai_tpu_torch.engine.wavefront.render:
                  a warm pass, then a timed pass with the launch counts
                  zeroed just before it and read just after; tile_sweep's
                  launches and tiles also split by shape (T, S, G), the
                  cascade stage kernel's by fold and shape, the host reads
                  by call site. Fails past 400 host reads, or on one made
                  in the packet cascades (accel.traverse, cuda_cascade).
                  Then main_path_summary: kernels (profile), host reads,
                  launches, timed pass and busy share beside commit 9fef914's
                  215,501 / 6,741 / 6,653 / 3.819 s / 0.446. Since ctiles'
                  bounds went on the card: at most 67 host reads, none in
                  accel.ctiles and in accel.pairs only the overflow count;
                  block_cull and slot_sweep must launch.
  4a. ctiles_bounds block_cull and slot_sweep on the main path's first two
                  closest ctiles waves (wave 0, bounces 0 and 1, kept from
                  one more bench render that stops once it has them):
                  block_cull exact against its plain version (the eager
                  cull and extraction), timed, bounded over the ray/box
                  tests its data needs; the same wave with a quarter of
                  its rays on box corners along +x, at live-block counts
                  0, 1 and all, at 1 with the rays past it live, and at
                  cap 1; slot_sweep in each output
                  mode (closest and any-hit folds per block row, per slot)
                  and option (sub_skip, pack_t) on each wave, and on the
                  pair tiles of 8,192 of its rays (T 128, S 128, one lane
                  a slot): bitwise its plain version (eager tile_sweep_plain)
                  and the chunked form it replaced (tile_sweep launched a
                  chunk, the tile count read on the host), tuned (the
                  routes' two shapes, no option) and generic, timed beside
                  both and its bound; every crafted
                  slot case of tests/test_torch_sweep_cases.py (ties, a hit
                  at t_min, -0.0 / +0.0, spread, padding, no tiles) at S
                  128, each shape, output, option and instance; the main
                  render's host reads by site. About 20 s.
  4c. packet_cull the packet cascades' interval cull (after ctiles_bounds
                  and the main path's kept shadow calls): packet_cull
                  against its plain version on the main path's shadow calls
                  at wave 0, bounce 0 (unsorted) and 1 (65,536 blocks of 64,
                  C 641, no entries), a packets-route closest call (2^20
                  bounce rays, blocks of 256, t_max +inf, entries), the
                  worklist cell's accel (C 2,561) at blocks of 64, and the
                  crafted cull cases of tests/test_torch_sweep_cases.py at
                  four sizes (C up to 16,385: past the shared-memory sort),
                  with and without entries, the crafted ones against the
                  plain version on CPU copies: order and n_cand identical,
                  entry_sorted equal as values; each timed beside its bound
                  and the plain version. The main path must launch it 20
                  times; the line also holds the render's device time by
                  step (the profile phase's split: the shadow waves' eager
                  steps) and its timed pass.
  4b. profile     one more such render under torch.profiler: device kernel
                  time by kernel and by wave type, and the device's busy
                  share of the timed pass; and ("split") by step of both
                  wave types, the ranges of scripts/torch_ctiles_split.py
                  (ctiles' steps, the packet cascades' sort, cull, ray
                  pack, compaction, unpermute, unsort); the same for the
                  next two paths
                  (profile_pallas, profile_fused, each after its own timed
                  render), with the time of the path's own kernels.
  4c. path_pallas the same bench render with backend="pallas",
                  block_size=64 (accel.cuda_sweep: one launch per wave): a
                  small warm render, counts zeroed, one timed render; the
                  image agrees with the main path's at atol 1e-5.
  4d. path_fused  the same on the hybrid backend with the fused cascades
                  (cascade_fused closest; packets_fused shadows with
                  early_skip and sub_skip), each stage one launch of the
                  fused stage kernel; the image equals the main path's
                  bitwise; host reads by call site: one a cascade call (the
                  ids' range check), at most 32 others, none in the loop.
  4e. fused_cascade the fused route's two kept calls (wave 0, bounce 1:
                  the shadow call and the closest call) split by stage
                  (size, threshold, k in / out, active blocks at the first
                  and last vote, needed tests, bound, the host-stepped
                  loop's and the stage kernel's ms (its one instance), each
                  stage bitwise the host-stepped loop and the plain
                  version), then each call whole before (the host-stepped
                  loop: block_anyhit / block_closest launched an iteration)
                  and after in turns: bits, final k, device seconds, host
                  reads, kernels (lines fused_cascade_stages,
                  fused_cascade_loop, fused_cascade).
  5. consistency  the three paths vs the oracle on the card (96x54, 4 spp,
                  5 bounces, blob subdiv 4): main and fused bitwise, pallas
                  at atol 1e-5 (its tie rule keeps the first candidate);
                  the same with Russian roulette from bounce 2, and
                  rr_start=5 (never reached in 5 bounces) bitwise the
                  rr-off image.
  5a. reference   tests/data/jax_reference.npz (the JAX package's oracle
                  and wavefront images of the blob subdiv 3 + room at
                  48x27, 2 spp, 5 bounces, seed 0, rr_start 0 and 2, the
                  scene and camera arrays it rendered, and the port's CPU
                  images; scripts/torch_make_reference.py writes it), read
                  without JAX: the same frames on the card through the
                  oracle, the main path, pallas, the fused cascades, the
                  pool, the virtual (2, 2) mesh, tile_devices=8, worklist,
                  ctiles, perray, kslots and `cli.main -m gpu` (its scene
                  loader and camera patched to the file's); for each, bitwise
                  against the port's CPU image of the same engine, pixels
                  differing, and the RMSE against JAX's oracle image over
                  its mean. Then the same for the dielectric frame,
                  tests/data/jax_reference_dielectric.npz (the JAX
                  package's `dielectric` configuration's scene with its
                  blob glass, subdiv 3, 48x27, 2 spp, 8 bounces, seed 0: the
                  shadow cascade on rays that leave glass), and the
                  cornell frame, tests/data/jax_reference_cornell.npz (the
                  JAX `cornell` configuration's box of axis-aligned quads,
                  2 spp, 5 bounces); a line a file.
                  Fails if a route exceeds 1e-3 there, or if a route is not
                  bitwise its CPU image (the
                  line then names the first stage of a CPU / card lockstep
                  of the oracle whose tensors differ), or if the main path's
                  bench render gained kernels or host syncs over the
                  215,680 and 6,744 it took at commit 524103f (profile,
                  main_path).
  5b. cluster_sizes the 96x54 blob scene (subdiv 4 + room, 2 spp, 5
                  bounces) on base accels of S in 2, 16, 64, 96, 512 through
                  the main path (the default routing), backend "pallas",
                  "worklist", "kslots" and the fused cascades: each image
                  bitwise the oracle's (pallas within 1e-5, its tie rule),
                  every route at S 16, 96, 512 through generic instances
                  (launch counts by kernel); and each kernel's generic
                  instance against its plain version at each S.
  6. cli          the CLI (path_tracer_ai_tpu_torch.cli.main, in-process) on
                  an OBJ scene: the blob subdiv 6 written as blob.obj + a
                  two-material blob.mtl, loaded once by scene.build_scene
                  (parser, seconds, 81,928 triangles with the room), then
                  `-m gpu -w 1920 -h 1080 -s 2 -b 5 --seed 0 --validate
                  --checkpoint a.npz` as a warm run and a timed run with the
                  launch counts zeroed just before it (tile_sweep > 0; PNG
                  free of magenta, audit finite); the same with
                  `--backend pallas` (closest_sweep, anyhit_sweep > 0) and
                  with `--rr 2`, whose live rays (wavefront.RenderStats of
                  the same settings) must be fewer than without; a 1-spp
                  render stopped at a checkpoint and resumed to 2 spp
                  equals the uninterrupted render bitwise; `-m cpu` and
                  `-m gpu` on a blob subdiv 4 OBJ (96x54, 2 spp, 3 bounces)
                  write equal PNGs; `--backend worklist`, `kslots` (each
                  the `-m cpu` PNG) and `perray` (its perray folds must
                  launch; its PNG beside the `-m cpu` one, recorded) at
                  96x54 on the blob subdiv 6 OBJ.
  7. item_waves   the worklist scene (blob subdiv 7 + room: 327,688
                  triangles, 2,561 clusters of 128 in 161 supers, so the
                  2-level cull runs) rendered once at the bench settings
                  with the default routing (the worklist backend), keeping
                  the inputs of item_sweep's second closest and second
                  shadow launch (wave 0, bounce 1): on each, item_sweep
                  against its plain version (bitwise t, exact tri and
                  occlusion), timed, bounded over the needed tests (live
                  item x live lane x live slot x S). Also under
                  --kernels-only.
  8. path_worklist the same render timed, the counts zeroed just before
                  it: seconds, Mrays/s, host syncs, item_sweep and
                  tile_sweep launches (by shape), the overflow fallback's
                  blocks, rays through accel.pairs and whole-wave
                  fallbacks, and each worklist stage's device seconds
                  (build, sweep, fallback) for closest and shadow waves;
                  then profile_worklist: the closest and the shadow
                  query of wave 0, bounce 1 (kept from item_waves) under
                  torch.profiler (device time by kernel and by stage;
                  busy share of an unprofiled call). consistency and cli
                  also hold the worklist route (blob subdiv 4 in clusters
                  of 2, 2,564 clusters: worklist by default, pairs and
                  packets by name, against the oracle; `--backend
                  worklist` on the OBJ at 96x54 against `-m cpu`), and
                  `bench` runs `python -m path_tracer_ai_tpu_torch.bench
                  --quick`, whose stdout must be one JSON line with a
                  value > 0.
  9. path_pool    the bench render with scheduler="pool" (one pool of
                  2^20 lanes a pixel chunk, refilled as paths end; closest
                  waves on the S=128 accel), warm then timed: seconds, live
                  Mrays/s, host syncs, pool iterations a chunk, tile_sweep
                  launches by shape. Its image must equal the main path's
                  bit for bit, or differ only at pixels whose traced paths
                  (each sample through both routes and the oracle) meet an
                  exact t tie between two triangles, the one place where
                  the exact routes may part (ROADMAP §3); any other
                  difference fails.
  10. path_mesh   parallel.mesh: render_sharded_wavefront over a virtual
                  (2, 2) mesh of the one card, with its workers as the mesh
                  runs them (one a card) and with one a shard: the same
                  launches and host syncs,
                  the ratio to the main path, the first also profiled (busy
                  share a card), each also over a main path render made
                  just before (path_mesh_ratio); render(tile_devices=8)
                  (a 1x1 mesh on one card), both held to the main path's
                  image as path_pool is; render_sharded (scheduler "fused",
                  blocks of 256: the cascade stage kernel at T 256) at the
                  bench cell if 960x540 predicts it under 60 s, else at
                  960x540 (against the main path at that size). The
                  kernel phase checks tile_sweep at (T 256, S 128, G 2)
                  too.
  11. config_4k   benchmarks.run_config("4k", scale=1/1024): 3840x2160, 1
                  spp, 16 bounces, progressive with a checkpoint under a
                  temporary directory, through tile_devices=8; finite, no
                  magenta; the same call again resumes from the finished
                  checkpoint with no work (no ray, no launch) and the same
                  image.
  12. exact_cull  the main path with HYBRID_OCCLUDE_KW's exact_cull=6
                  (bitwise the main path's image; on the kept wave 0,
                  bounce 1 shadow wave: candidates per live block, mean /
                  p99 / max, exact against conservative, and the wave's
                  device ms under each cull); the fused path with
                  exact_cull=16 in both engines (bitwise the fused path's
                  image); the worklist cell's kept shadow wave through
                  any_hit_worklist and the "packets_exact" cascade (device
                  ms, the same occlusion). consistency also renders the
                  worklist route with WORKLIST_OCCLUDE_ENGINE =
                  "packets_exact" (bitwise the oracle).
  13. path_ctiles the bench render with backend="ctiles" (closest waves
                  T 128 on the S=128 accel, lane-major shadow waves in
                  blocks of 4, T 64), with sub_skip in CTILES_CLOSEST_KW,
                  and the main path with the hybrid shadow engine "ctiles":
                  each warm at 96x54 and timed (seconds, Mrays/s, host
                  syncs, tile_sweep launches by shape, overflow blocks),
                  each image bitwise the main path's; then the ctiles
                  backend on the worklist scene (2,561 clusters: levels 2,
                  the 2-level cull kernel), bitwise the worklist route's
                  image, no host read in accel.ctiles.
                  consistency also
                  holds ctiles' options bitwise against the oracle at
                  96x54: levels=2 (auto) on the 2,564-cluster accel,
                  pair_split=2, fallback_sorted=False and method="morton"
                  accels through the main path.
  14. path_perray the perray backend at 480x270 (bench spp and bounces),
                  and at the bench cell if 16 x that predicts under 60 s:
                  seconds, host syncs; the image at atol 1e-5 against the
                  main path at the size it ran and against the oracle at
                  96x54, differing pixels counted; perray_cull and the
                  stage kernel's perray folds (perray_stage_first,
                  perray_stage_any) must launch, the eager perray cull
                  must not run; host reads by site (line path_perray_reads:
                  the overflow counts, one a perray call, the stage loop's,
                  which must be 0, and the bounce loop's).
  14b. perray_cascade_loop the perray queries' loop on the card: two
                  calls kept from the perray bench render (wave 0, bounce
                  1: the first 2^16 rays of the closest call and the shadow
                  call after it; the render stops once it has them), each
                  split by stage (lines perray_cascade_stages): size,
                  threshold, k in and out, active rays at the first and
                  last vote, needed tests (kslot_sweep_plain's), bound, the
                  host-stepped loop's ms (perray_stage_plain sweeping
                  through kslot_sweep, the loop before the stage kernel),
                  the stage kernel's ms (its only instance, generic), bit
                  for bit the host-stepped loop and the plain version
                  (eager sweeps);
                  each call whole through the host-stepped loop and the
                  stage kernel in turns (before, after, after, before):
                  the same bits and final k, device seconds, host reads,
                  device kernels (lines perray_cascade_loop).
  15. path_kslots the kslots backend (per-ray K slots: one kslots_cull and
                  one kslot_sweep launch a query, overflow through pair
                  tiles; both must launch, the eager cull must not run)
                  warm at 96x54 (bitwise the oracle), at 480x270, and at
                  the bench cell if 16 x that predicts under 60 s (bitwise
                  the main path): seconds, Mrays/s, host syncs, launches,
                  the device seconds of cull, sweep and fallback, and the
                  overflow shares (over k_supers, over k_clusters, over
                  k_clusters only because of phantom children). The kernel
                  phase checks kslot_sweep on a closest (K 12) and a shadow
                  (K 8) wave of 2^20 rays culled by kslots (bitwise, timed,
                  bounded, the slot bytes requested); consistency renders
                  kslots on the 2,564-cluster accel (2-level cull) bitwise
                  the oracle; cli renders `--backend kslots` at 96x54 to
                  the `-m cpu` PNG. One more bench render, untimed, keeps
                  the inputs of its wave 0, bounce 1 kslot_sweep launches
                  (closest and shadow; lines "kslot_waves") and stops once
                  it has them: bitwise against the plain version, timed,
                  bounded, with the distinct clusters a run of 128 rays
                  names; it keeps its first two kslots_cull calls of each
                  wave type too.
  15b. ray_cull   the per-ray culls on the card: kslots_cull bit for bit
                  its plain version on the kslots render's kept wave 0,
                  bounce 1 calls (closest and shadow, levels 2) and on the
                  same calls forced to levels 1, perray_cull on the perray
                  render's two kept calls, both on every crafted per-ray
                  cull case (tests/test_torch_sweep_cases.py
                  ray_cull_case) at its caps and one past each (against
                  the plain version on the CPU); each render call timed
                  beside its bound (the box tests its rays need x the ops
                  of a test, or its bytes) and the plain version on the
                  card; then one more bench render of each route with the
                  plain version patched in (the eager cull of before):
                  the kslots stages' device seconds and the perray
                  render's seconds, before and after (line ray_cull).
  15c. pair_cull  the pair tables' kernels (cuda_cull.pair_tables: cull,
                  scan, rank) and ctiles' 2-level cull (block_cull at
                  levels 2) on the card, each bit for bit its plain
                  version (the eager body of before, on the card) on the
                  kept calls: the main path's first ctiles-fallback pair
                  call, the worklist render's first closest and shadow
                  pair calls, a kslots fallback pair call (a crafted
                  2^17-ray call at C 641 where the kslots render makes
                  none), the ctiles backend's first levels-2 closest and
                  shadow calls on the worklist scene (2,561 clusters); and
                  on the crafted
                  cases (tests/test_torch_sweep_cases.py pair_case,
                  ctiles2_case) against the plain version on the CPU.
                  Each kept call timed beside its bound and the plain
                  version; registers, spills and warps of each kernel;
                  the launches of each route (line pair_cull).
  16. packet_cascade the packet cascades' loop on the card and
                  the first-slot kernels: the cascade stage kernel on the
                  first stage of the main path's first shadow call (any
                  hit, T 64, G 2), of the worklist render's kept whole-
                  wave closest fallback (first slot, T 64, G 8) and of a
                  closest cascade at blocks of 256 on 2^18 bounce rays
                  (T 256, G 8): bitwise its plain version, tuned and
                  generic, timed beside its bound, its plain version and
                  the host-stepped loop (each on the first stage that
                  sweeps); tile_sweep's first-slot instance
                  on the first iteration of those two closest cascades run
                  host-stepped, and kslot_sweep's on closest_hit_perray's
                  first launch run host-stepped (2^16 bounce rays, K 4):
                  bitwise, timed, bounded; the main path's two kept shadow calls (wave 0,
                  bounces 0 and 1, kept by a render that stops once it
                  has them) and the worklist's and kslots render's kept
                  closest fallbacks through the host-stepped loop and the
                  stage kernel in turns (before, after, after, before):
                  the same bits and final k, device seconds, host reads
                  and device kernels of each (lines packet_cascade_loop);
                  then stage_split: every stage of the main path's two
                  kept shadow calls and of the worklist's first kept
                  closest fallback on copies of its inputs, at each W
                  (the warps the stage kernel gives a slot: 1, 2, 4, 8,
                  forced), each bit for bit the host-stepped loop (and
                  the eager plain version on the first tail stage, 1,024
                  blocks or fewer, that sweeps): size, threshold, k in and
                  out, active blocks at the first and last vote, needed
                  tests, bound, ms by W, the W the rule picks and the
                  fastest, beside the parent design's ms (PARENT_STAGES);
                  and stage_split_render: the profile's stage kernel
                  seconds against the sum of the bounds of the bench
                  render's stages (one more render, every stage run
                  host-stepped with stats), beside the parent's; the
                  first-stage checks above also force each W, tuned and
                  generic;
                  the "packets" route (blocks of 256) as path_perray
                  renders perray (line path_packets); the worklist,
                  kslots, perray and packets routes' seconds, host syncs
                  and launches. Fails if the eager sweep helpers
                  (traverse._packet_sweep_closest / _packet_sweep_any) or
                  the per-ray culls' plain versions ran in any route phase
                  (they are counted from the build on).
  17. worklist_mxu the worklist scene's kept closest and shadow queries
                  (wave 0, bounce 1) through intersector "mxu", "mxu:high"
                  and "mxu:default" at blocks of 64, sorted, against
                  "exact": hit (occlusion) flips, the largest relative t
                  error, the share of the same triangle, each over the
                  rays whose result came from the mxu sweep (live rays of
                  blocks that did not overflow; at least 1,000 rays and
                  1,000 hits a wave), the flips over the whole wave beside
                  them; the device ms of the mxu item sweep and of its
                  product alone beside item_sweep's; "mxu" must keep
                  JAX's bounds (flips < 5e-3, t rtol 5e-3, the same
                  triangle on > 99%) on its swept rays, and flip fewer
                  than 5e-3 of the swept rays that "exact" hits.
  mesh_cards      (--mesh-cards only) render_sharded_wavefront at the bench
                  cell over a mesh of distinct cards ((2, 2) on four, (n, 1)
                  on two or three), its cards driven at once by the mesh's
                  workers (a process a card), by a thread a card, and one
                  after another (every shard on one worker, the schedule
                  before the workers: the same launches by shape and host
                  syncs, exactly), and over a
                  virtual (2, 2) mesh of cuda:0; each warm and then timed,
                  held to the main path's image as path_pool is, the
                  concurrent runs profiled (busy share a card); then
                  mesh_cards_summary, each run's time over the main path's.
Then the kernels line (twenty-three kernels: the five, item_sweep and
kslot_sweep, which replace no TPU kernel, the first-slot instances
tile_sweep_first and kslot_sweep_first, which carry XLA-fused sweeps, the
cascade stage kernel's six folds, cascade_stage_any,
cascade_stage_first, fused_stage_any, fused_stage_closest,
perray_stage_any and perray_stage_first, which carry the cascades'
while_loop, and block_cull and slot_sweep, which carry ctiles' cull and
its sweep's fori_loops, and packet_cull, which carries the packet
cascades' interval cull (its launches on every route under
launches_by_route), worklist_cull, which carries the worklist's cull, and
kslots_cull and perray_cull, which carry the kslots and perray routes'
per-ray culls, pair_cull, which carries the pair tiles' CULL + PACK (the
overflow fallback of ctiles, the worklist and kslots), and
block_cull_2level, which carries ctiles' 2-level cull ("carries": the JAX
package's code each stands
for); tile_sweep's launches are the chunked form's in ctiles_bounds, its
body running in slot_sweep on the routes ("runs_as"); launches
on every path, the new ones under new_path_launches, the CLI's with
`--backend perray` under cli_perray_launches, tile_sweep_first's and
kslot_sweep_first's in the host-stepped loops, the only routes left that
launch them, and block_anyhit's and block_closest's in the fused
cascades' host-stepped loop (on the fused route their bodies run inside
the fused folds: "runs_as"), the stage kernel's also by W
(launches_by_w), the fused and perray folds' by shape
(launches_by_shape); each
kernel's generic instance under
"generic": its S = 128 time beside the tuned one's, its bound, and its
launches in cluster_sizes; the fused folds have only their generic
instance, "only_instance"), and last {"ok": true, "device": {...}}.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 non-tensor FLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# f32 operations of one Möller–Trumbore test as the kernel writes it
# (h: 9, a: 5, f: 1 division, s: 3, u: 6, q: 9, v: 6, t: 6, u+v: 1).
MT_OPS = 46


# While set (_generic_instances), every kernel line says which instance ran.
_INSTANCE = None

# The ms the earlier design of item_sweep and kslot_sweep (tuned
# instances) took on the H100 (NVIDIA H100 80GB HBM3, 700.00 W; this script
# at commit c004371) on the check waves that the lines below set beside
# them.
EARLIER = {
    "item_sweep": {"closest": 10.1811, "shadow": 11.9942},
    "kslot_sweep": {"closest": 0.9499, "shadow": 0.5494},
}

# Registers, spills and resident warps of item_sweep's and kslot_sweep's
# instances (phase_build fills it): {(kernel, S or 0 for the generic
# instance, closest): {...}}.
_FACTS = {}


def _instance_facts(name: str, s: int, closest: bool) -> dict:
    """The facts of the instance that ran (the generic one while
    _generic_instances is in force, or where no tuned one is compiled)."""
    key = (name, 0 if _INSTANCE == "generic" else s, closest)
    return _FACTS.get(key) or _FACTS.get((name, 0, closest), {})


def _earlier(name: str, wave: str, ms: float) -> dict:
    """The earlier design's time on this wave and this run's over it (none
    for a generic instance)."""
    if _INSTANCE == "generic":
        return {}
    before = EARLIER[name][wave.split(",")[0]]
    return {"earlier_ms": before, "ms_over_earlier": ms / before}


def emit(obj) -> None:
    if _INSTANCE and "phase" in obj:
        obj = {**obj, "instance": _INSTANCE}
    print(json.dumps(obj), flush=True)


def fail(phase: str, msg: str) -> None:
    print(json.dumps({"phase": phase, "ok": False, "error": msg}),
          file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    if not torch.cuda.is_available():
        fail("device", "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    print(card, flush=True)
    rounding = _card_rounding()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          **rounding})
    if rounding["sqrt_f32_differing"]:
        fail("device", f"torch.sqrt on the card is not correctly rounded "
                       f"({rounding}); vec.sqrt_rn keeps it on the card")
    return card


def _card_rounding() -> dict:
    """torch's f32 sqrt on the card against its f64 sqrt rounded once to
    f32 (the correctly rounded result, which vec.sqrt_rn takes it to be) on
    2^24 inputs: 2^23 uniform in [0, 50), 2^23 random bit patterns of
    positive finite f32; and the f32 tan against the f64 one rounded once
    at the half angles of fov 1-169.75 degrees in quarter degrees (the
    camera takes the f64 one on every device)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.cat([
        torch.rand(1 << 23, generator=g, device="cuda") * 50.0,
        torch.randint(0, 0x7F800000, (1 << 23,), generator=g, device="cuda",
                      dtype=torch.int32).view(torch.float32)])
    bits = lambda t: t.view(torch.int32)
    sqrt_differ = int((bits(torch.sqrt(x))
                       != bits(torch.sqrt(x.double()).float())).sum())
    fov = torch.arange(4, 680, device="cuda", dtype=torch.float32) / 4.0
    half = fov * (np.pi / 180.0) / 2.0
    tan_differ = (bits(torch.tan(half))
                  != bits(torch.tan(half.double()).float()))
    return {"sqrt_f32_inputs": int(x.numel()),
            "sqrt_f32_differing": sqrt_differ,
            "tan_f32_fovs": int(fov.numel()),
            "tan_f32_differing": int(tan_differ.sum()),
            "tan_f32_differs_at_45_degrees": bool(tan_differ[fov == 45.0])}


def dump_sass(out_dir: str) -> None:
    """cuobjdump -sass of every library built so far, one file each."""
    from path_tracer_ai_tpu_torch import cuda_build

    os.makedirs(out_dir, exist_ok=True)
    tool = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    for name in cuda_build.build_log:
        with open(os.path.join(out_dir, name + ".sass"), "w") as fh:
            subprocess.run([tool, "-sass", cuda_build.library_path(name)],
                           stdout=fh, stderr=subprocess.STDOUT, timeout=300)


def phase_build():
    from path_tracer_ai_tpu_torch import cuda_build
    from path_tracer_ai_tpu_torch.accel import (
        cuda_anyhit,
        cuda_cascade,
        cuda_closest,
        cuda_ctiles,
        cuda_cull,
        cuda_items,
        cuda_kslots,
        cuda_sweep,
    )

    t0 = time.perf_counter()
    built = cuda_build.build_all([m.SOURCE for m in (
        cuda_ctiles, cuda_sweep, cuda_anyhit, cuda_closest, cuda_items,
        cuda_kslots, cuda_cull)] + [cuda_ctiles.CULL_SOURCE,
                                    cuda_cull.WORKLIST_SOURCE,
                                    cuda_cull.RAY_SOURCE])
    seconds = time.perf_counter() - t0
    entry = re.compile(
        r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores, "
        r"(\d+) bytes spill loads.*?Used (\d+) registers", re.S)
    ptxas = {k: [{"entry": m[0], "registers": int(m[3]),
                  "spill_bytes": int(m[1]) + int(m[2])}
                 for m in entry.findall(v["ptxas"])]
             for k, v in cuda_build.build_log.items()}
    # the instances the three renders launch
    occupancy = {
        "tile_sweep T128 S256": cuda_ctiles.kernel_occupancy(256, 128),
        "tile_sweep T64 S128": cuda_ctiles.kernel_occupancy(128, 64),
        "block_closest T128 S128": cuda_closest.kernel_occupancy(128, 128),
        "block_anyhit T128 S128": cuda_anyhit.kernel_occupancy(128, 128),
        "closest_sweep S128 R64": cuda_sweep.closest_occupancy(128, 64),
        "anyhit_sweep S128": cuda_sweep.anyhit_occupancy(128),
        "tile_sweep T128 S128": cuda_ctiles.kernel_occupancy(128, 128),
        **{f"tile_sweep {opt} T{t} S{s_}": cuda_ctiles.kernel_occupancy(
            s_, t, **{opt: True})
           for opt in ("sub_skip", "pack_t")
           for t, s_ in ((128, 256), (128, 128), (64, 128))},
    }
    # ctiles' bounds on the card: block_cull (blocks of 8 and 4 rays) and
    # slot_sweep's instances (the routes' two shapes; generic, with and
    # without each option)
    # the packet cascades' interval cull at the main path's C (its sort in
    # shared memory), the worklist's, and past the shared-memory sort
    for c in (641, 2561, cuda_cull.SMEM_SORT_MAX_C + 1):
        occupancy[f"packet_cull C{c}"] = {
            **cuda_cull.occupancy(c), "spill_bytes": sum(
                e["spill_bytes"] for e in ptxas.get("packet_cull", [])
                if "packet_cull_kernel" in e["entry"])}
    # the exact cull at the main path's blocks of 64 (ksup 6) and the fused
    # routes' 128 (ksup 16), on the bench accel's 41 supers of 16
    for r, ksup in ((64, 6), (128, 16)):
        occupancy[f"exact_cull R{r} ksup{ksup}"] = {
            **cuda_cull.exact_occupancy(r, 41, ksup, 16), "spill_bytes": sum(
                e["spill_bytes"] for e in ptxas.get("packet_cull", [])
                if "exact_cull_kernel" in e["entry"])}
    occupancy["worklist_cull"] = {
        **cuda_cull.worklist_occupancy(), "spill_bytes": sum(
            e["spill_bytes"] for e in ptxas.get("worklist_cull", []))}
    # the per-ray culls (kslots_cull with the routes' list of 6 supers)
    for name, occ in cuda_cull.ray_occupancy(6).items():
        occupancy[name] = {**occ, "spill_bytes": sum(
            e["spill_bytes"] for e in ptxas.get("ray_cull", [])
            if name + "_kernel" in e["entry"])}
    for b in (8, 4):
        occupancy[f"block_cull b{b}"] = {
            **cuda_ctiles.cull_occupancy(b), "spill_bytes": sum(
                e["spill_bytes"] for e in ptxas.get("ctiles_cull", [])
                if "block_cull_kernel" in e["entry"])}
    # ctiles' 2-level cull (blocks of 8, ctiles' super_cap 48) and the pair
    # tables' three kernels (the rank at the worklist scene's C)
    occupancy["block_cull_2level b8"] = {
        **cuda_ctiles.cull_occupancy(8, levels=2, super_cap=48),
        "spill_bytes": sum(e["spill_bytes"]
                           for e in ptxas.get("ctiles_cull", [])
                           if "block_cull2_kernel" in e["entry"])}
    for name, occ in cuda_cull.pair_occupancy(2561).items():
        occupancy[name] = {**occ, "spill_bytes": sum(
            e["spill_bytes"] for e in ptxas.get("ray_cull", [])
            if name + "_kernel" in e["entry"])}
    for opt, mode in ((None, 0), ("sub_skip", 1), ("pack_t", 2)):
        for t, s_ in ((128, 256), (128, 128), (0, 0)) if opt is None else (
                (0, 0),):
            tag = (f"slot_sweep_kernelILi{s_}ELi{t}ELi{4 if t == 128 else 1}"
                   f"ELi{mode}EE" if s_ else
                   f"slot_sweep_generic_kernelILi{mode}EE")
            label = (f"slot_sweep{' ' + opt if opt else ''} "
                     + (f"T{t} S{s_}" if s_ else "generic"))
            occupancy[label] = {
                **cuda_ctiles.slot_occupancy(
                    s_, t, sub_skip=opt == "sub_skip",
                    pack_t=opt == "pack_t"),
                "spill_bytes": sum(e["spill_bytes"]
                                   for e in ptxas.get("ctiles_sweep", [])
                                   if tag in e["entry"])}
    # the first-slot instances (the packet cascade's, perray's), with the
    # spills ptxas reports for them
    for key, occ, tag in (
            ("tile_sweep_first T64 S128",
             cuda_ctiles.kernel_occupancy(128, 64, tie="slot"),
             "tile_sweep_kernelILi128ELi64ELi1ELb1E"),
            ("tile_sweep_first T256 S128",
             cuda_ctiles.kernel_occupancy(128, 256, tie="slot"),
             "tile_sweep_kernelILi128ELi256ELi1ELb1E"),
            ("kslot_sweep_first S128",
             cuda_kslots.kernel_occupancy(128, True, tie="slot"),
             "kslot_sweep_kernelILi128ELb1ELb1E"),
            ("kslot_sweep_first Sgeneric",
             cuda_kslots.kernel_occupancy(0, True, tie="slot"),
             "kslot_sweep_kernelILi0ELb1ELb1E")):
        occupancy[key] = {**occ, "spill_bytes": sum(
            e["spill_bytes"] for es in ptxas.values() for e in es
            if tag in e["entry"])}
    # the cascade stage kernel (its loop on the card): the packet folds
    # tuned at T 64 and 256 (S 128), generic (S 0); the fused folds' only
    # instance, generic
    for any_hit in (True, False):
        name = cuda_cascade.NAMES[any_hit]
        for s_, t in ((128, 64), (128, 256), (0, 0)):
            tag = (f"cascade_stage_kernelI8TileFoldILb{int(any_hit)}EELi{s_}"
                   f"ELi{t}EE")
            occupancy[f"{name} " + (f"T{t} S{s_}" if s_ else "generic")] = {
                **cuda_cascade.kernel_occupancy(name, s_, t),
                "spill_bytes": sum(e["spill_bytes"]
                                   for e in ptxas.get("ctiles_sweep", [])
                                   if tag in e["entry"])}
        name = cuda_cascade.FUSED_NAMES[any_hit]
        fold = "8FusedAny" if any_hit else "12FusedClosest"
        tag = f"cascade_stage_kernelI{fold}Li0ELi0EE"
        occupancy[f"{name} generic"] = {
            **cuda_cascade.kernel_occupancy(name),
            "spill_bytes": sum(
                e["spill_bytes"]
                for e in ptxas.get(cuda_cascade.FUSED_SOURCES[any_hit], [])
                if tag in e["entry"])}
    # the perray folds' only instance (kslot_sweep.cu), generic
    for any_hit in (True, False):
        name = cuda_cascade.PERRAY_NAMES[any_hit]
        tag = (f"cascade_stage_kernelI10PerrayFoldILb{int(not any_hit)}"
               "EELi0ELi1EE")
        occupancy[f"{name} generic"] = {
            **cuda_cascade.kernel_occupancy(name),
            "spill_bytes": sum(e["spill_bytes"]
                               for e in ptxas.get("kslot_sweep", [])
                               if tag in e["entry"])}
    for name, mod in (("item_sweep", cuda_items),
                      ("kslot_sweep", cuda_kslots)):
        for s_, closest in ((128, True), (128, False), (0, True),
                            (0, False)):
            # kslot_sweep's instances of the oracle's rule (not first-slot)
            tag = (f"{name}_kernelILi{s_}ELb{int(closest)}E"
                   + ("Lb0E" if name == "kslot_sweep" else ""))
            spills = [e for e in ptxas.get(name, []) if tag in e["entry"]]
            _FACTS[(name, s_, closest)] = {
                **mod.kernel_occupancy(s_, closest),
                "spill_bytes": sum(e["spill_bytes"] for e in spills)}
            occupancy[f"{name} S{s_ or 'generic'} "
                      f"{'closest' if closest else 'anyhit'}"] = \
                _FACTS[(name, s_, closest)]
    emit({"phase": "build", "seconds": seconds, "built": sorted(built),
          "spilling": [e["entry"] for es in ptxas.values() for e in es
                       if e["spill_bytes"]],
          "ptxas": ptxas, "occupancy": occupancy})
    return occupancy, ptxas


def _bound(nbytes: int, tests: int) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the tests' f32 operations over the f32 peak. `tests`
    are the ray/triangle tests this run's data needs: those of the lanes
    that are live (t_max >= 0) and, for an any-hit kernel, not yet occluded
    when a cluster or sub-slab is swept. Dead and occluded lanes need none,
    though a kernel may spend some on them."""
    by_bytes = nbytes / PEAK_BYTES_PER_S
    by_ops = tests * MT_OPS / PEAK_F32_PER_S
    return {"bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes > by_ops else "operations",
            "bytes": nbytes, "tests": tests}


def _bits_equal(a, b) -> bool:
    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def _same_outputs(a, b) -> bool:
    """Two kernels' output tuples: f32 bit for bit, the rest exactly."""
    return all((_bits_equal(x, y) if x.dtype == torch.float32
                else bool(torch.equal(x, y))) for x, y in zip(a, b))


def _max_abs_err(a, b) -> float:
    fin = torch.isfinite(a) & torch.isfinite(b)
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _tile_rays(accel, nt, t_lanes, rng, g=1, dead_every=7):
    """Bounce-like tiles: tile i's rays leave points near the triangles of
    its first cluster in random directions (bench.py's exactness wave),
    t_max inf, with every `dead_every`-th lane dead (t_max = -1). Cluster
    ids [nt] for g = 1, else [nt, g]."""
    from path_tracer_ai_tpu_torch.accel import cuda_ctiles

    dev = accel.v0.device
    c, s = accel.num_clusters, accel.cluster_size
    cid = rng.integers(0, c, (nt, g)).astype(np.int32)
    v0 = accel.v0.cpu().numpy()
    slot = rng.integers(0, s, (nt, t_lanes))
    o = v0[cid[:, :1], slot].reshape(-1, 3)
    o = o + rng.standard_normal(o.shape).astype(np.float32) * 1e-3
    d = rng.standard_normal(o.shape).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = np.full(o.shape[0], np.inf, np.float32)
    tm[::dead_every] = -1.0
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    rays = cuda_ctiles.pack_rays_tiles(t(o), t(d), t(tm), t_lanes)
    return rays, t(cid if g > 1 else cid[:, 0])


def _check_tile_sweep(accel, t_lanes, nt, rng, reps, g=1, options=False):
    """tile_sweep against its plain version at one shape; with g > 1 the
    [nt, g] form, also against g single-cluster launches folded with
    combine_min_tri (and timed beside them); with `options`, its sub_skip
    and pack_t instances on the same tiles (_check_tile_options)."""
    from path_tracer_ai_tpu_torch.accel import cuda_ctiles

    pack = cuda_ctiles.pack_tris(accel)
    rays, cid = _tile_rays(accel, nt, t_lanes, rng, g)
    t_k, tri_k = cuda_ctiles.tile_sweep(pack, rays, cid)
    t_p, tri_p = cuda_ctiles.tile_sweep_plain(pack, rays, cid)
    torch.cuda.synchronize()
    bitwise = _bits_equal(t_k, t_p)
    tri_eq = bool(torch.equal(tri_k, tri_p))
    hits = int((tri_k != cuda_ctiles.I32_MAX).sum())
    ms = cuda_ms(lambda: cuda_ctiles.tile_sweep(pack, rays, cid), reps)
    plain_ms = cuda_ms(lambda: cuda_ctiles.tile_sweep_plain(pack, rays, cid), 2)
    s = accel.cluster_size
    n_used = int(torch.unique(cid).numel())
    nbytes = n_used * 10 * s * 4 + _nbytes(rays, cid, t_k, tri_k)
    live_lanes = int((rays[:, 6] >= 0.0).sum())
    res = {"phase": "kernel", "name": "tile_sweep", "T": t_lanes, "S": s,
           "G": g, "nt": nt, "t_bitwise": bitwise, "tri_equal": tri_eq,
           "matches_plain": bitwise and tri_eq,
           "max_abs_err": _max_abs_err(t_k, t_p), "hit_lanes": hits, "ms": ms,
           "plain_ms": plain_ms, "swept_tests": nt * t_lanes * s * g,
           **_bound(nbytes, live_lanes * s * g),
           "gtests_per_s": nt * t_lanes * s * g / ms / 1e6}
    if g > 1:
        cols = [cid[:, j].contiguous() for j in range(g)]

        def folded():
            t_f, tri_f = cuda_ctiles.tile_sweep(pack, rays, cols[0])
            for col in cols[1:]:
                t_f, tri_f = cuda_ctiles.combine_min_tri(
                    t_f, tri_f, *cuda_ctiles.tile_sweep(pack, rays, col))
            return t_f, tri_f

        t_f, tri_f = folded()
        res["matches_single_calls"] = (_bits_equal(t_k, t_f)
                                       and bool(torch.equal(tri_k, tri_f)))
        res["single_calls_folded_ms"] = cuda_ms(folded, reps)
        res["matches_plain"] = res["matches_plain"] and res["matches_single_calls"]
    res["ms_over_bound"] = ms / res["bound_ms"]
    if options:
        res["options"] = _check_tile_options(accel, rays, cid, t_k, tri_k,
                                             reps)
        res["matches_plain"] = res["matches_plain"] and all(
            o["matches_plain"] and o["equals_default"]
            for o in res["options"].values())
    emit(res)
    if not res["matches_plain"]:
        fail("kernel", f"tile_sweep T={t_lanes} G={g} disagrees with its plain "
                       "version, with single-cluster launches or, with an "
                       "option, with the default instance")
    if hits == 0:
        fail("kernel", f"tile_sweep T={t_lanes} check wave hit nothing")
    return res


def _check_tile_options(accel, rays, cid, t_def, tri_def, reps):
    """tile_sweep's sub_skip and pack_t instances on one check's tiles:
    each bitwise against its plain version and against the default
    instance's result, timed, and bounded over the tests it needs (sub_skip:
    the live lanes' tests of the sub-slabs its plain version sweeps, a
    tile-uniform gate; pack_t: every live lane's)."""
    from path_tracer_ai_tpu_torch.accel import cuda_ctiles

    out = {}
    s = accel.cluster_size
    t_lanes = rays.shape[2]
    n_used = int(torch.unique(cid).numel())
    for opt, pack in (("sub_skip", cuda_ctiles.pack_tris16(accel)),
                      ("pack_t", cuda_ctiles.pack_tris16_t(accel))):
        kw = {opt: True}
        t_k, tri_k = cuda_ctiles.tile_sweep(pack, rays, cid, **kw)
        st = {}
        t_p, tri_p = cuda_ctiles.tile_sweep_plain(pack, rays, cid, stats=st,
                                                  **kw)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: cuda_ctiles.tile_sweep(pack, rays, cid, **kw),
                     reps)
        plain_ms = cuda_ms(
            lambda: cuda_ctiles.tile_sweep_plain(pack, rays, cid, **kw), 2)
        words = 16 if opt == "sub_skip" else 10
        nbytes = n_used * words * s * 4 + _nbytes(rays, cid, t_k, tri_k)
        res = {"T": t_lanes, "S": s,
               "matches_plain": (_bits_equal(t_k, t_p)
                                 and bool(torch.equal(tri_k, tri_p))),
               "equals_default": (_bits_equal(t_k, t_def)
                                  and bool(torch.equal(tri_k, tri_def))),
               "max_abs_err": _max_abs_err(t_k, t_p), "ms": ms,
               "plain_ms": plain_ms, "plain_swept_tests": st["tests"],
               **_bound(nbytes, st["lane_tests"]),
               "occupancy": cuda_ctiles.kernel_occupancy(s, t_lanes, **kw)}
        res["ms_over_bound"] = ms / res["bound_ms"]
        out[opt] = res
    return out


def _bounce_wave(accel, n, rng, shadow):
    """n bounce-like rays: they leave points near the accel's triangles in
    random directions, with t_max inf as in a closest wave or, with
    `shadow`, finite lengths as in a shadow wave."""
    dev = accel.v0.device
    v0 = accel.v0.cpu().numpy().reshape(-1, 3)
    v0 = v0[accel.tri_id.cpu().numpy().reshape(-1) >= 0]
    o = v0[rng.integers(0, v0.shape[0], n)]
    o = o + rng.standard_normal(o.shape).astype(np.float32) * 1e-2
    d = rng.standard_normal(o.shape).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = (rng.uniform(0.5, 15.0, n) if shadow else np.full(n, np.inf))
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                  device=dev)
    return t(o), t(d), t(tm)


def _kill_every_seventh(rays):
    """A dead lane (t_max = -1) in every seventh place of each block, set
    after the sort and cull so that live and dead lanes share blocks."""
    rays = rays.clone()
    rays[:, 6, ::7] = -1.0
    return rays


def _warp_visits(cuda_sweep, slab, rays, order, n_cand) -> int:
    """The (warp, cluster) visits of anyhit_sweep's walk, which stops warp by
    warp: the plain version's visits over the blocks cut into 32 lanes."""
    b, rows, r = rays.shape
    w = r // 32
    st = {}
    cuda_sweep.anyhit_sweep_plain(
        slab, rays.reshape(b, rows, w, 32).transpose(1, 2).reshape(
            b * w, rows, 32), order.repeat_interleave(w, dim=0),
        n_cand.repeat_interleave(w), stats=st)
    return st["visits"]


def _listed_slab_bytes(order, n_cand, s) -> int:
    """Bytes of the slab rows of every cluster some block lists."""
    listed = torch.arange(order.shape[1], device=order.device) \
        < n_cand[:, None]
    return int(torch.unique(order[listed]).numel()) * 9 * s * 4


def _closest_check(slab, rays, order, entry, n_cand, slab_bytes,
                   t_min=1e-3, reps=10) -> dict:
    """closest_sweep against its plain version on one wave (t as bits,
    cluster, slot) and its time over `reps` launches. The bound counts the
    (block, cluster) visits the plain version really made: per visit the
    4-byte order and entry words and the S tests of every live lane."""
    from path_tracer_ai_tpu_torch.accel import cuda_sweep

    b, _, r = rays.shape
    s = slab.tri.shape[2]
    st = {}
    k_t, k_cid, k_slot = cuda_sweep.closest_sweep(slab, rays, order, entry,
                                                  n_cand, t_min)
    p_t, p_cid, p_slot = cuda_sweep.closest_sweep_plain(
        slab, rays, order, entry, n_cand, t_min, stats=st)
    torch.cuda.synchronize()
    ok = {"t_bitwise": _bits_equal(k_t, p_t),
          "cid_equal": bool(torch.equal(k_cid, p_cid)),
          "slot_equal": bool(torch.equal(k_slot, p_slot))}
    ms = cuda_ms(lambda: cuda_sweep.closest_sweep(slab, rays, order, entry,
                                                  n_cand, t_min), reps)
    nbytes = (slab_bytes + _nbytes(rays, n_cand, k_t, k_cid, k_slot)
              + st["visits"] * 8)
    res = {"B": b, "R": r, "S": s, "c_pad": order.shape[1],
           "mean_candidates": float(n_cand.float().mean()),
           "visits": st["visits"], **ok, "matches_plain": all(ok.values()),
           "max_abs_err": _max_abs_err(k_t, p_t),
           "hit_lanes": int((k_cid >= 0).sum()), "ms": ms,
           "swept_tests": st["visits"] * r * s,
           "gtests_per_s": st["visits"] * r * s / ms / 1e6,
           **_bound(nbytes, st["lane_tests"])}
    res["ms_over_bound"] = ms / res["bound_ms"]
    return res


def _check_sweeps(accel, rng, nb=2048, r=64):
    """closest_sweep and anyhit_sweep (the pallas backend's kernels) at
    B = 2048 blocks of R = 64 lanes, candidate lists from the port's own
    sort and cull of a bounce-like wave over the bench accel. The bound
    counts the (block, cluster) visits the plain version really made: per
    visit the 4-byte order (and entry) word and the S tests of every lane
    that needs them (live; for the any-hit, not yet occluded)."""
    from path_tracer_ai_tpu_torch.accel import cuda_sweep

    slab = cuda_sweep.build_slab_table(accel)
    s = accel.cluster_size
    out = {}

    def inputs(shadow):
        o, d, tm = _bounce_wave(accel, nb * r, rng, shadow)
        rays, order, entry, n_cand, _perm = cuda_sweep._prep_wave(
            accel, o, d, tm, r, True)
        return (_kill_every_seventh(rays), order, entry, n_cand,
                _listed_slab_bytes(order, n_cand, s))

    rays, order, entry, n_cand, slab_bytes = inputs(shadow=False)
    res = {"phase": "kernel", "name": "closest_sweep",
           **_closest_check(slab, rays, order, entry, n_cand, slab_bytes),
           "plain_ms": cuda_ms(lambda: cuda_sweep.closest_sweep_plain(
               slab, rays, order, entry, n_cand), 1)}
    emit(res)
    if not res["matches_plain"]:
        fail("kernel", "closest_sweep disagrees with its plain version")
    if res["hit_lanes"] == 0:
        fail("kernel", "closest_sweep check wave hit nothing")
    out["closest_sweep"] = res

    rays, order, _entry, n_cand, slab_bytes = inputs(shadow=True)
    st = {}
    k_occ = cuda_sweep.anyhit_sweep(slab, rays, order, n_cand)
    p_occ = cuda_sweep.anyhit_sweep_plain(slab, rays, order, n_cand, stats=st)
    torch.cuda.synchronize()
    equal = bool(torch.equal(k_occ, p_occ))
    hits = int(k_occ.sum())
    ms = cuda_ms(lambda: cuda_sweep.anyhit_sweep(slab, rays, order, n_cand), 10)
    plain_ms = cuda_ms(lambda: cuda_sweep.anyhit_sweep_plain(
        slab, rays, order, n_cand), 1)
    nbytes = slab_bytes + _nbytes(rays, n_cand, k_occ) + st["visits"] * 4
    res = {"phase": "kernel", "name": "anyhit_sweep", "B": nb, "R": r, "S": s,
           "c_pad": order.shape[1], "mean_candidates": float(n_cand.float().mean()),
           "visits": st["visits"],
           "warp_visits": _warp_visits(cuda_sweep, slab, rays, order, n_cand),
           "occ_equal": equal, "matches_plain": equal,
           "max_abs_err": float((k_occ != p_occ).sum()),  # lanes that differ
           "hit_lanes": hits, "ms": ms, "plain_ms": plain_ms,
           "swept_tests": st["visits"] * r * s,
           **_bound(nbytes, st["lane_tests"])}
    res["ms_over_bound"] = ms / res["bound_ms"]
    emit(res)
    if not equal:
        fail("kernel", "anyhit_sweep disagrees with its plain version")
    if hits == 0:
        fail("kernel", "anyhit_sweep check wave hit nothing")
    out["anyhit_sweep"] = res
    return out


# Launches a timing of the fused kernels averages over: their 0.2-0.5 ms
# read 0.43-0.51 ms across runs of one kernel when averaged over 10.
FUSED_REPS = 50


def _check_fused(accel, rng, size=2048, t_lanes=128):
    """block_anyhit and block_closest (the fused cascades' kernels) at
    size = 2048 blocks of T = 128 lanes against the first GROUP = 8
    candidates of each block, from the port's own sort and cull. Options off
    and on must give the same bits. Timed and bounded with the options the
    path sets (early_skip + sub_skip; sub_skip); the bound counts, over the
    sub-slab sweeps the plain version really made, the tests of every lane
    that needs them (live; for the any-hit, not yet occluded)."""
    from path_tracer_ai_tpu_torch.accel import cuda_anyhit, cuda_ctiles

    pack = cuda_anyhit.pack_tris_dummy(accel)
    s = accel.cluster_size
    out = {}

    def inputs(sort_mode, shadow):
        o, d, tm = _bounce_wave(accel, size * t_lanes, rng, shadow)
        o, d, tm, _perm, _nc, _ent, order_g = cuda_anyhit.prepare_fused_wave(
            accel, o, d, tm, t_lanes, True, sort_mode)
        rays = cuda_ctiles.pack_rays_tiles(o, d, tm, t_lanes)
        cid8 = order_g[:, 0].reshape(-1).contiguous()
        used = int(torch.unique(cid8).numel())
        return _kill_every_seventh(rays), cid8, used * 16 * s * 4

    out["block_anyhit"] = _check_block_anyhit(pack, inputs, size, t_lanes, s)
    out["block_closest"] = _check_block_closest(pack, inputs, size, t_lanes, s)
    return out


def _check_block_anyhit(pack, inputs, size, t_lanes, s):
    from path_tracer_ai_tpu_torch.accel import cuda_anyhit

    rays, cid8, pack_bytes = inputs("dir", shadow=True)
    st_on, st_off = {}, {}
    p_occ = cuda_anyhit.block_anyhit_plain(pack, rays, cid8, stats=st_off)
    cuda_anyhit.block_anyhit_plain(pack, rays, cid8, True, True, stats=st_on)
    variants = {}
    lanes_differing = 0
    for early_skip in (False, True):
        for sub_skip in (False, True):
            k_occ = cuda_anyhit.block_anyhit(pack, rays, cid8,
                                             early_skip=early_skip,
                                             sub_skip=sub_skip)
            torch.cuda.synchronize()
            variants[f"early{int(early_skip)}_sub{int(sub_skip)}"] = bool(
                torch.equal(k_occ, p_occ))
            lanes_differing = max(lanes_differing,
                                  int((k_occ != p_occ).sum()))
    hits = int(p_occ.sum())
    ms = cuda_ms(lambda: cuda_anyhit.block_anyhit(
        pack, rays, cid8, early_skip=True, sub_skip=True), FUSED_REPS)
    ms_off = cuda_ms(lambda: cuda_anyhit.block_anyhit(pack, rays, cid8),
                     FUSED_REPS)
    plain_ms = cuda_ms(lambda: cuda_anyhit.block_anyhit_plain(
        pack, rays, cid8, True, True), 1)
    nbytes = pack_bytes + _nbytes(rays, cid8, p_occ)
    res = {"phase": "kernel", "name": "block_anyhit", "size": size,
           "T": t_lanes, "S": s, "equals_plain": variants,
           "matches_plain": all(variants.values()),
           "tests_options_off": st_off["tests"],
           "max_abs_err": float(lanes_differing),  # lanes that differ
           "hit_lanes": hits, "ms": ms, "ms_options_off": ms_off,
           "plain_ms": plain_ms, "swept_tests": st_on["tests"],
           **_bound(nbytes, st_on["lane_tests"])}
    res["ms_over_bound"] = ms / res["bound_ms"]
    emit(res)
    if not all(variants.values()):
        fail("kernel", f"block_anyhit disagrees with its plain version: {variants}")
    if hits == 0:
        fail("kernel", "block_anyhit check wave hit nothing")
    return res


def _check_block_closest(pack, inputs, size, t_lanes, s):
    from path_tracer_ai_tpu_torch.accel import cuda_closest, cuda_ctiles

    rays, cid8, pack_bytes = inputs("octorig", shadow=False)
    st_on, st_off = {}, {}
    p_t, p_tri = cuda_closest.block_closest_plain(pack, rays, cid8, True,
                                                  stats=st_on)
    cuda_closest.block_closest_plain(pack, rays, cid8, False, stats=st_off)
    variants = {}
    err = 0.0
    for sub_skip in (False, True):
        k_t, k_tri = cuda_closest.block_closest(pack, rays, cid8, sub_skip)
        torch.cuda.synchronize()
        variants[f"sub{int(sub_skip)}"] = (
            _bits_equal(k_t, p_t) and bool(torch.equal(k_tri, p_tri)))
        err = max(err, _max_abs_err(k_t, p_t))
    hits = int((p_tri != cuda_ctiles.I32_MAX).sum())
    ms = cuda_ms(lambda: cuda_closest.block_closest(pack, rays, cid8, True),
                 FUSED_REPS)
    ms_off = cuda_ms(lambda: cuda_closest.block_closest(pack, rays, cid8,
                                                        False), FUSED_REPS)
    plain_ms = cuda_ms(lambda: cuda_closest.block_closest_plain(
        pack, rays, cid8, True), 1)
    nbytes = pack_bytes + _nbytes(rays, cid8, p_t, p_tri)
    res = {"phase": "kernel", "name": "block_closest", "size": size,
           "T": t_lanes, "S": s, "equals_plain": variants,
           "matches_plain": all(variants.values()),
           "tests_options_off": st_off["tests"],
           "max_abs_err": err, "hit_lanes": hits, "ms": ms,
           "ms_options_off": ms_off, "plain_ms": plain_ms,
           "swept_tests": st_on["tests"],
           **_bound(nbytes, st_on["lane_tests"])}
    res["ms_over_bound"] = ms / res["bound_ms"]
    emit(res)
    if not all(variants.values()):
        fail("kernel", f"block_closest disagrees with its plain version: {variants}")
    if hits == 0:
        fail("kernel", "block_closest check wave hit nothing")
    return res


def phase_kernels(accel_base, accel_c):
    """{kernel name: its check at the shape its path gives it}; tile_sweep
    also at the shadow cascade's shape, one and two clusters a tile."""
    rng = np.random.default_rng(0)
    out = {"tile_sweep": _check_tile_sweep(accel_c, 128, 2048, rng, reps=20,
                                           options=True),
           "tile_sweep_t64": _check_tile_sweep(accel_base, 64, 2048, rng,
                                               reps=20, options=True)}
    out.update(_check_sweeps(accel_base, rng))
    out.update(_check_fused(accel_base, rng))
    # last, so that the checks above draw the same waves as they always have
    out["tile_sweep_t64_g2"] = _check_tile_sweep(accel_base, 64, 2048, rng,
                                                 reps=20, g=2)
    # the worklist path's shapes: pair tiles (T 128, S 128) and the packet
    # any-hit cascade of its fallbacks (T 64, groups of 8; that cascade
    # now sweeps in the stage kernel, this shape only in the host-stepped
    # loop)
    out["tile_sweep_t128_s128"] = _check_tile_sweep(accel_base, 128, 2048,
                                                    rng, reps=20,
                                                    options=True)
    out["tile_sweep_t64_g8"] = _check_tile_sweep(accel_base, 64, 2048, rng,
                                                 reps=20, g=8)
    # render_sharded's shadow cascade's shape: blocks of 256, groups of 2
    out["tile_sweep_t256_g2"] = _check_tile_sweep(accel_base, 256, 2048, rng,
                                                  reps=20, g=2)
    # the kslots backend's closest (K 12) and shadow (K 8) waves
    out["kslot_sweep"] = _check_kslot_sweep(accel_base, rng, shadow=False)
    out["kslot_sweep_shadow"] = _check_kslot_sweep(accel_base, rng,
                                                   shadow=True)
    return out


KSLOT_WAVE = 1 << 20  # rays of each kslot_sweep check wave (a render wave)


def kslot_check_args(accel, rng, shadow: bool) -> tuple:
    """(kslot_sweep's arguments, facts of the wave) on a bounce-1-like wave
    of KSLOT_WAVE rays over `accel` (closest: t_max inf, K 12; shadow:
    finite lengths, K 8), every 7th ray dead, with the cid and n_slots
    tables of kslots' own cull (overflowed rays go in with t_max -1)."""
    from path_tracer_ai_tpu_torch.accel import cuda_ctiles, cuda_kslots, kslots
    from path_tracer_ai_tpu_torch.engine import wavefront

    kw = wavefront.KSLOTS_OCCLUDE_KW if shadow else wavefront.KSLOTS_CLOSEST_KW
    o, d, tm = _bounce_wave(accel, KSLOT_WAVE, rng, shadow)
    tm[::7] = -1.0
    levels = kslots.resolve_levels(accel, 0)
    tab = kslots._tables(accel, o, d, tm, 1e-3, kw["k_supers"],
                         kw["k_clusters"], levels, 1 << 15)
    tb = torch.where((tm >= 0) & ~tab["over"], tm, -1.0)
    return ((cuda_ctiles.pack_tris(accel),
             cuda_kslots.pack_rays(o, d, tb, 1e-3), tab["cid"],
             tab["n_slots"], not shadow),
            {"levels": levels, "overflow_rays": int(tab["over"].sum())})


def _check_kslot_sweep(accel, rng, shadow: bool, reps: int = 10) -> dict:
    """kslot_sweep against its plain version on kslot_check_args' wave."""
    args, info = kslot_check_args(accel, rng, shadow)
    return _kslot_check(args, "kernel", "shadow" if shadow else "closest",
                        reps, info)


def _distinct_cids(cid, n_slots, live, group: int = 128) -> dict:
    """Over runs of `group` consecutive rays: the mean count of distinct
    clusters their live slots name, and of live slots (the reuse a block
    of `group` rays could get from staging each cluster once)."""
    k = cid.shape[1]
    m = ((torch.arange(k, device=cid.device)[None, :] < n_slots[:, None])
         & live[:, None])
    n = cid.shape[0] // group * group
    c = torch.where(m, cid, -1)[:n].reshape(-1, group * k).sort(dim=1).values
    distinct = ((c[:, 1:] != c[:, :-1]) & (c[:, 1:] >= 0)).sum(1) + (
        c[:, 0] >= 0)
    slots = m[:n].reshape(-1, group * k).sum(1)
    d_mean = float(distinct.float().mean())
    return {"rays_a_run": group, "distinct_cids_mean": d_mean,
            "slots_mean": float(slots.float().mean()),
            "slots_over_distinct": float(slots.sum()) / max(
                float(distinct.sum()), 1.0)}


def _kslot_check(args, phase: str, wave: str, reps: int = 10,
                 info=None) -> dict:
    """kslot_sweep against its plain version on `args`: bitwise t, exact
    tri and occlusion; timed, bounded over the needed tests, with the bytes
    the swept slots request (40 * S a slot: a count from the cid table, not
    a measurement of L1 or L2 traffic; the shadow walk leaves at a hit, so
    it requests fewer) and the distinct clusters a run of 128 rays names."""
    from path_tracer_ai_tpu_torch.accel import cuda_ctiles, cuda_kslots

    shadow = not args[-1]
    pack, rays, cid, n_slots = args[:4]
    k = cuda_kslots.kslot_sweep(*args)
    stats = {}
    p = cuda_kslots.kslot_sweep_plain(*args, stats=stats)
    torch.cuda.synchronize()
    if shadow:
        ok = bool(torch.equal(k[0], p[0]))
        err = float((k[0] != p[0]).sum())  # rays that differ
        hits = int(k[0].sum())
    else:
        ok = _bits_equal(k[0], p[0]) and bool(torch.equal(k[1], p[1]))
        err = _max_abs_err(k[0], p[0])
        hits = int((k[1] != cuda_ctiles.I32_MAX).sum())
    ms = cuda_ms(lambda: cuda_kslots.kslot_sweep(*args), reps)
    plain_ms = cuda_ms(lambda: cuda_kslots.kslot_sweep_plain(*args), 1)
    s = pack.shape[2]
    n = rays.shape[0]
    live = rays[:, 6] >= rays[:, 7]
    slots = int(n_slots[live].sum())
    used = int(torch.unique(cid[live][torch.arange(
        cid.shape[1], device=cid.device)[None, :] < n_slots[live, None]])
        .numel())
    nbytes = (used * 10 * s * 4 + _nbytes(rays, cid, n_slots)
              + n * (1 if shadow else 8))
    res = {"phase": phase, "name": "kslot_sweep", "wave": wave, "rays": n,
           "swept_rays": int(live.sum()), "K": cid.shape[1], "S": s,
           **(info or {}), "slots": slots, "matches_plain": ok,
           "max_abs_err": err, "hit_rays": hits, "ms": ms,
           "plain_ms": plain_ms, "requested_slot_bytes": slots * s * 40,
           "reuse": _distinct_cids(cid, n_slots, live),
           **_bound(nbytes, stats["tests"]),
           **_instance_facts("kslot_sweep", s, not shadow),
           **(_earlier("kslot_sweep", wave, ms) if phase == "kernel"
              else {})}
    res["ms_over_bound"] = ms / res["bound_ms"]
    emit(res)
    if not ok:
        fail(phase, f"kslot_sweep disagrees with its plain version on the "
                    f"{wave} wave")
    if hits == 0:
        fail(phase, f"kslot_sweep: the {wave} wave hit nothing")
    return res


def phase_sweep_waves(scene, accel_base, card, n_first=2048):
    """closest_sweep on the pallas bench render's own waves: the inputs of
    its first two launches (wave 0 at bounce 0 and at bounce 1) are kept
    from one bench render; on each whole wave the kernel is held bitwise
    against its plain version, timed and bounded, and timed again on the
    wave's first `n_first` blocks alone (with few blocks, the longest walk
    among them rather than the throughput sets that time)."""
    from path_tracer_ai_tpu_torch.accel import cuda_sweep
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import wavefront
    from path_tracer_ai_tpu_torch.scene.camera import default_camera

    kernel = cuda_sweep.closest_sweep
    kept = []

    def keep(slab, rays, order, entry, n_cand, t_min=1e-3):
        if len(kept) < 2:
            kept.append((slab, rays.clone(), order.clone(), entry.clone(),
                         n_cand.clone(), t_min))
        return kernel(slab, rays, order, entry, n_cand, t_min)

    cuda_sweep.closest_sweep = keep
    try:
        wavefront.render(scene, default_camera("cuda"),
                         RenderSettings(**BENCH), wave_size=1 << 20,
                         device="cuda", accel=accel_base, backend="pallas",
                         block_size=64)
    finally:
        cuda_sweep.closest_sweep = kernel
    out = []
    for bounce, (slab, rays, order, entry, n_cand, t_min) in enumerate(kept):
        s = slab.tri.shape[2]
        t0 = time.perf_counter()
        res = {"phase": "sweep_waves", "card": card, "wave": 0,
               "bounce": bounce,
               **_closest_check(slab, rays, order, entry, n_cand,
                                _listed_slab_bytes(order, n_cand, s), t_min,
                                reps=5)}
        first = [a[:n_first].contiguous() for a in (rays, order, entry, n_cand)]
        res.update({
            "max_candidates": int(n_cand.max()),
            "first_blocks": first[0].shape[0],
            "first_blocks_ms": cuda_ms(lambda: kernel(slab, *first, t_min), 5),
            "seconds": time.perf_counter() - t0})
        emit(res)
        if not res["matches_plain"]:
            fail("sweep_waves", f"closest_sweep disagrees with its plain "
                                f"version on the bounce-{bounce} wave")
        if res["hit_lanes"] == 0:
            fail("sweep_waves", f"the bounce-{bounce} wave hit nothing")
        out.append(res)
    if len(out) != 2:
        fail("sweep_waves", f"the render launched closest_sweep {len(kept)} "
                            "times, not at least twice")
    return out


# The main path's bench render on the H100 at commit 524103f (profile
# phase: device kernels and copies; main_path: host syncs): none may be
# gained.
BENCH_KERNELS_MAX = 215680
BENCH_SYNCS_MAX = 6744
BENCH = dict(width=1920, height=1080, samples_per_pixel=2, max_bounces=5,
             seed=0)
FUSED_ENGINES = dict(
    HYBRID_CLOSEST_KW=dict(engine="cascade_fused"),
    HYBRID_OCCLUDE_KW=dict(engine="packets_fused", early_skip=True,
                           sub_skip=True))


class _patched:
    """Sets attributes of a module for the duration of a block."""

    def __init__(self, module, **attrs):
        self.module, self.attrs = module, attrs

    def __enter__(self):
        self.saved = {k: getattr(self.module, k) for k in self.attrs}
        for k, v in self.attrs.items():
            setattr(self.module, k, v)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(self.module, k, v)


class _engines(_patched):
    """Sets the hybrid backend's engine tables for the duration of a block."""

    def __init__(self, tables):
        from path_tracer_ai_tpu_torch.engine import wavefront

        super().__init__(wavefront, **(tables or {}))


def _reset_counts():
    from path_tracer_ai_tpu_torch.accel import (
        cuda_anyhit,
        cuda_cascade,
        cuda_closest,
        cuda_ctiles,
        cuda_cull,
        cuda_items,
        cuda_kslots,
        cuda_sweep,
        kslots,
        pairs,
        worklist,
    )
    from path_tracer_ai_tpu_torch.utils import sync

    for mod in (cuda_ctiles, cuda_sweep, cuda_anyhit, cuda_closest,
                cuda_items, cuda_kslots, cuda_cascade, cuda_cull):
        mod.reset_launches()
    kslots.reset_overflow_counts()
    worklist.reset_fallback_counts()
    pairs.reset_fallback_counts()
    sync.reset()
    for name in FUSED_CALLS:
        FUSED_CALLS[name] = 0


def _read_counts() -> dict:
    from path_tracer_ai_tpu_torch.accel import (
        cuda_anyhit,
        cuda_cascade,
        cuda_closest,
        cuda_ctiles,
        cuda_cull,
        cuda_items,
        cuda_kslots,
        cuda_sweep,
    )

    return {"tile_sweep": cuda_ctiles.launches, **cuda_sweep.launches,
            **cuda_cascade.launches,
            "block_anyhit": cuda_anyhit.launches,
            "block_closest": cuda_closest.launches,
            "item_sweep": cuda_items.launches,
            "kslot_sweep": cuda_kslots.launches,
            # the first-slot instances (counted in the two above as well)
            "tile_sweep_first": cuda_ctiles.slot_launches,
            "kslot_sweep_first": cuda_kslots.slot_launches,
            # ctiles' bounds on the card
            "block_cull": cuda_ctiles.cull_launches,
            "slot_sweep": cuda_ctiles.sweep_launches,
            # the packet cascades' interval cull
            "packet_cull": cuda_cull.launches,
            # the worklist's cull
            "worklist_cull": cuda_cull.worklist_launches,
            # the per-ray culls of kslots and perray
            "kslots_cull": cuda_cull.kslots_launches,
            "perray_cull": cuda_cull.perray_launches,
            # the pair tables (a call: three launches) and ctiles' 2-level
            # cull
            "pair_cull": cuda_cull.pair_launches,
            "block_cull_2level": cuda_ctiles.cull2_launches,
            # the exact shadow cull (a packet_cull launch before each, in
            # the count above) and perray's entry order
            "exact_cull": cuda_cull.exact_launches,
            "perray_entry": cuda_cull.entry_launches}


def _tile_shapes() -> list:
    from path_tracer_ai_tpu_torch.accel import cuda_ctiles

    return [{"T": key[0], "S": key[1], "G": key[2], "launches": n,
             "tiles": tiles, **({"option": key[3]} if len(key) > 3 else {})}
            for key, (n, tiles) in sorted(cuda_ctiles.launch_shapes.items())
            ] + [{"kernel": "slot_sweep", "T": key[0], "S": key[1],
                  "out": key[2], "launches": n, "slot_cap_tiles": tiles,
                  **({"option": key[3]} if len(key) > 3
                     and key[3] != "generic" else {}),
                  **({"instance": "generic"} if key[-1] == "generic"
                     else {})}
                 for key, (n, tiles) in sorted(
                     cuda_ctiles.sweep_shapes.items())]


def _stage_shapes() -> list:
    """The cascade stage kernel's launches by fold and shape (the packet
    folds' and the fused folds')."""
    from path_tracer_ai_tpu_torch.accel import cuda_cascade

    return [{"kernel": key[0], "T": key[1], "S": key[2], "G": key[3],
             "W": key[4], "launches": n, "blocks": blocks,
             **({"instance": key[5]} if len(key) > 5 else {})}
            for key, (n, blocks) in sorted(
                cuda_cascade.launch_shapes.items())]


def _launches_by_w(shapes, kernel) -> dict:
    """A stage kernel fold's launches by W (the warps a slot), from
    _stage_shapes."""
    out = {}
    for sh in shapes:
        if sh["kernel"] == kernel:
            out[sh["W"]] = out.get(sh["W"], 0) + sh["launches"]
    return dict(sorted(out.items()))


def _sync_sites() -> dict:
    """Host reads by call site ("module:line"), most first."""
    from path_tracer_ai_tpu_torch.utils import sync

    return dict(sorted(sync.sites.items(), key=lambda kv: -kv[1]))


def _bench_render(phase, scene, card, kernels, warm_small, engines=None,
                  **render_kw):
    """One path's bench render: a warm pass (the bench render itself, or a
    96x54 one), then the launch counts and host syncs set to 0, the timed
    render, and the counts read. Fails unless every kernel in `kernels` was
    launched and the image is finite, free of magenta and mostly lit."""
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import wavefront
    from path_tracer_ai_tpu_torch.scene.camera import default_camera
    from path_tracer_ai_tpu_torch.utils import sync

    settings = RenderSettings(**BENCH)
    warm = RenderSettings(**{**BENCH, "width": 96, "height": 54}) \
        if warm_small else settings
    cam = default_camera("cuda")
    kw = dict(wave_size=1 << 20, device="cuda", **render_kw)
    with _engines(engines):
        t0 = time.perf_counter()
        wavefront.render(scene, cam, warm, **kw)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0

        _reset_counts()
        stats = wavefront.RenderStats()
        img = wavefront.render(scene, cam, settings, stats=stats, **kw)
        launches = _read_counts()
        syncs = sync.count
        sites = _sync_sites()
        tile_shapes = _tile_shapes()
        stage_shapes = _stage_shapes()

    from path_tracer_ai_tpu_torch.accel import worklist

    res = {"phase": phase, "card": card,
           "warm": "96x54" if warm_small else "bench render",
           "warm_seconds": warm_s,
           "seconds": stats.seconds, "closest_rays": stats.closest_rays,
           "shadow_rays": stats.shadow_rays, "mrays_per_s": stats.mrays_per_s,
           "launches": launches, "tile_sweep_shapes": tile_shapes,
           "cascade_stage_shapes": stage_shapes,
           "fused_calls": dict(FUSED_CALLS), "host_syncs": syncs,
           "host_sync_sites": sites,
           "overflow_fallback": dict(worklist.fallback_counts)}
    if stats.pool_iterations:
        res["pool_iterations_per_chunk"] = stats.pool_iterations
    image_ok = _image_verdict(img, res)
    missing = [k for k in kernels if launches[k] <= 0]
    return res, img, missing, image_ok


def _image_verdict(img, res) -> bool:
    """Adds the image's audit to `res`; True when it is finite, free of
    magenta and mostly lit."""
    finite = bool(np.isfinite(img).all())
    magenta = float(np.all(img == np.asarray([1.0, 0.0, 1.0], np.float32),
                           axis=-1).mean())
    nonblack = float((img.max(axis=-1) > 0).mean())
    res.update({"finite": finite, "magenta_share": magenta,
                "nonblack_share": nonblack, "image_mean": float(img.mean()),
                "image_sha256": hashlib.sha256(img.tobytes()).hexdigest()})
    return finite and magenta == 0.0 and nonblack >= 0.5


def _finish_path(res, missing, image_ok):
    emit(res)
    if missing:
        fail(res["phase"], f"the render launched no {', '.join(missing)} kernel")
    if not image_ok:
        fail(res["phase"], "bad image (non-finite, magenta or mostly black)")


# The main path's bench render on the H100 at commit 9fef914 (its profile
# and main_path phases), before the packet cascades' loop ran on the card.
MAIN_AT_9FEF914 = {"device_kernels": 215501, "host_syncs": 6741,
             "tile_sweep_launches": 6653, "timed_pass_seconds": 3.819,
             "busy_share": 0.446}
# Since then: host reads a bench render at most (103 before ctiles' bounds
# went on the card, 36 of them in accel.ctiles and 10 in accel.pairs' sweep
# and compaction), and the modules in which none may be made (the packet
# cascades and their stage).
MAIN_SYNCS_MAX = 67
NO_SYNC_MODULES = ("path_tracer_ai_tpu_torch.accel.traverse:",
                   "path_tracer_ai_tpu_torch.accel.cuda_cascade:")


def phase_main_path(scene, accel_base, accel_c, card):
    from path_tracer_ai_tpu_torch.io.image import save_image

    res, img, missing, image_ok = _bench_render(
        "main_path", scene, card,
        ["slot_sweep", "block_cull", "cascade_stage_any", "packet_cull",
         "pair_cull"],
        warm_small=False, accel=accel_base, accel_closest=accel_c)
    png = os.path.join(tempfile.gettempdir(), "chip_smoke_bench.png")
    save_image(png, img, 2.2)
    res["png"] = png
    _finish_path(res, missing, image_ok)
    cascade = [k for k in res["host_sync_sites"]
               if k.startswith(NO_SYNC_MODULES)]
    bounds = _ctiles_bound_reads(res["host_sync_sites"])
    if res["host_syncs"] > MAIN_SYNCS_MAX or cascade or bounds:
        fail("main_path", f"{res['host_syncs']} host reads (at most "
                          f"{MAIN_SYNCS_MAX}), {cascade} in the cascades, "
                          f"{bounds} in ctiles' bounds")
    return res, img


def _pairs_count_site() -> str:
    """accel.pairs' one host read left: the overflow count of
    _overflow_fallback (the reference's lax.cond)."""
    import inspect

    from path_tracer_ai_tpu_torch.accel import pairs

    lines, first = inspect.getsourcelines(pairs._overflow_fallback)
    at = next(i for i, ln in enumerate(lines)
              if "sync.host_int(overflow.sum())" in ln)
    return f"{pairs.__name__}:{first + at}"


def _ctiles_bound_reads(sites) -> list:
    """The host read sites a render may no longer have: any in
    accel.ctiles, and any in accel.pairs but its overflow count."""
    keep = _pairs_count_site()
    return [k for k in sites if k.startswith(
        "path_tracer_ai_tpu_torch.accel.ctiles:")
        or (k.startswith("path_tracer_ai_tpu_torch.accel.pairs:")
            and k != keep)]


def phase_main_summary(card, render, profile):
    """The main path's bench render beside commit 9fef914's: kernels
    (profile), host reads by call site, tile_sweep and stage launches by
    shape, the timed pass and the busy share."""
    res = {"phase": "main_path_summary", "card": card,
           "device_kernels": profile["device_kernels"],
           "host_syncs": render["host_syncs"],
           "host_sync_sites": render["host_sync_sites"],
           "tile_sweep_launches": render["launches"]["tile_sweep"],
           "slot_sweep_launches": render["launches"]["slot_sweep"],
           "block_cull_launches": render["launches"]["block_cull"],
           "tile_sweep_shapes": render["tile_sweep_shapes"],
           "cascade_stage_launches": render["launches"]["cascade_stage_any"],
           "cascade_stage_shapes": render["cascade_stage_shapes"],
           "timed_pass_seconds": render["seconds"],
           "busy_share": profile["busy_share_of_timed_pass"],
           "image_sha256": render["image_sha256"],
           "at_commit_9fef914": MAIN_AT_9FEF914}
    emit(res)
    return res


def phase_path_pallas(scene, accel_base, card, img_main):
    res, img, missing, image_ok = _bench_render(
        "path_pallas", scene, card, ["closest_sweep", "anyhit_sweep"],
        warm_small=True, accel=accel_base, backend="pallas", block_size=64)
    diff = np.abs(img - img_main)
    res["max_abs_diff_vs_main"] = float(diff.max())
    res["pixels_differing_from_main"] = int((diff.max(axis=-1) > 0).sum())
    res["pixels_over_1e-5"] = int((diff.max(axis=-1) > 1e-5).sum())
    _finish_path(res, missing, image_ok)
    if res["pixels_over_1e-5"]:
        fail("path_pallas", "image differs from the main path's beyond 1e-5")
    return res


def _fused_reads(res) -> dict:
    """A fused render's host reads: its cascade calls, the reads of their
    range checks (one a call), the others, and the sites in the loop's
    modules (none allowed)."""
    checks = sum(n for k, n in res["host_sync_sites"].items()
                 if k.startswith(FUSED_READ_SITE))
    return {"cascade_calls": sum(res["fused_calls"].values()),
            "range_checks": checks, "others": res["host_syncs"] - checks,
            "in_the_loop": [k for k in res["host_sync_sites"]
                            if k.startswith(FUSED_NO_SYNC_MODULES)]}


def phase_path_fused(scene, accel_base, card, img_main):
    """The fused cascades' bench render (every stage one launch of the
    stage kernel): bitwise the main path's image, host reads by call site
    (one a cascade call, the range check, and at most the 32 others the
    route made at commit d2f509c; none in the loop), and the stage launches
    by fold and shape."""
    res, img, missing, image_ok = _bench_render(
        "path_fused", scene, card, ["fused_stage_any", "fused_stage_closest"],
        warm_small=True, engines=FUSED_ENGINES, accel=accel_base)
    res["bitwise_equal_to_main"] = bool(np.array_equal(img, img_main))
    res["host_reads"] = {**_fused_reads(res), "at_d2f509c": FUSED_AT_D2F509C}
    _finish_path(res, missing, image_ok)
    if not res["bitwise_equal_to_main"]:
        fail("path_fused", "image differs from the main path's")
    reads = res["host_reads"]
    if (reads["range_checks"] > reads["cascade_calls"]
            or reads["others"] > FUSED_OTHER_READS_MAX
            or reads["in_the_loop"]):
        fail("path_fused", f"host reads {reads}: at most one a cascade call "
                           f"and {FUSED_OTHER_READS_MAX} others, none in the "
                           "loop")
    return res, img


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _range_us(evt) -> float:
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _profiled_render(scene, engines=None, keep=None, **render_kw):
    """One bench render under torch.profiler -> (its key_averages(), the
    profiled wall seconds); keep["prof"] gets the profile where keep is a
    dict."""
    from torch.profiler import ProfilerActivity, profile

    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import wavefront
    from path_tracer_ai_tpu_torch.scene.camera import default_camera

    t0 = time.perf_counter()
    with _engines(engines), profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as prof:
        wavefront.render(scene, default_camera("cuda"),
                         RenderSettings(**BENCH), wave_size=1 << 20,
                         device="cuda", **render_kw)
        torch.cuda.synchronize()
    if keep is not None:
        keep["prof"] = prof
    return prof.key_averages(), time.perf_counter() - t0


WAVE_LABELS = ("closest_wave", "shadow_wave")  # wavefront's record_function
# the main path's steps' ranges (scripts/torch_ctiles_split.py), which the
# profile phase wraps
SPLIT_LABELS = set()


def _is_label(key: str) -> bool:
    """A record_function range (wavefront's wave types, accel.worklist's
    stages, the profile phase's steps), not a kernel."""
    return (key in WAVE_LABELS or key.startswith("worklist_")
            or key in SPLIT_LABELS)


def _kernel_time(phase, avgs, wall, timed_seconds, names):
    """The profile line's common part: device kernel time in all and, for
    each of `names` (substrings of kernel symbols), the time and count of
    the kernels that match. Device-side entries are kernels and copies; the
    labelled ranges also appear there (as spans, gaps included) and are
    left out. The busy share divides the device time by the UNPROFILED
    timed pass's wall time (profiling slows the host, not the kernels)."""
    kernels = [e for e in avgs if str(e.device_type).endswith("CUDA")
               and not _is_label(e.key)]
    busy_us = sum(_device_us(e) for e in kernels)
    top = sorted(kernels, key=_device_us, reverse=True)[:8]
    own = {}
    for name in names:
        match = [e for e in kernels if name in e.key]
        sec = sum(_device_us(e) for e in match) / 1e6
        own[name] = {"count": int(sum(e.count for e in match)),
                     "seconds": sec,
                     "share_of_device_time": sec / (busy_us / 1e6)
                     if busy_us else "not measured",
                     "instances": [{"name": e.key[:80], "count": e.count,
                                    "seconds": _device_us(e) / 1e6}
                                   for e in match]}
    return {"phase": phase, "profiled_wall_seconds": wall,
            "timed_pass_seconds": timed_seconds,
            "device_kernel_seconds": busy_us / 1e6,
            "device_kernels": int(sum(e.count for e in kernels)),
            "busy_share_of_timed_pass": (busy_us / 1e6 / timed_seconds
                                         if busy_us else "not measured"),
            "path_kernels": own,
            "top_kernels": [{"name": e.key[:80], "count": e.count,
                             "seconds": _device_us(e) / 1e6} for e in top]}


def phase_profile(scene, accel_base, accel_c, timed_seconds):
    """The main path's bench render under torch.profiler: device kernel
    time by name and by wave type, and by step of both wave types
    ("split": scripts/torch_ctiles_split.py's ranges and charge)."""
    split = _split_module()
    SPLIT_LABELS.update(split.labels())
    wrapped, restore = split.wrap_steps()
    keep = {}
    try:
        avgs, wall = _profiled_render(scene, keep=keep, accel=accel_base,
                                      accel_closest=accel_c)
    finally:
        restore()
    res = _kernel_time("profile", avgs, wall, timed_seconds,
                       ["tile_sweep_kernel", "cascade_stage_kernel",
                        "packet_cull_kernel"])
    res["split"] = {"wrapped": wrapped, **split.split_profile(keep["prof"])}
    sweeps = res["path_kernels"]["tile_sweep_kernel"]
    host = [e for e in avgs
            if e.key in WAVE_LABELS
            and not str(e.device_type).endswith("CUDA")]
    res.update({
        "tile_sweep_kernel_seconds": sweeps["seconds"],
        "tile_sweep_kernels": sweeps["instances"],
        "wave_kernel_seconds": {e.key: _range_us(e) / 1e6 for e in host},
        # host wall inside each label, syncs included (inflated by profiling)
        "wave_profiled_host_seconds": {e.key: float(e.cpu_time_total) / 1e6
                                       for e in host}})
    emit(res)
    return res


def phase_profile_path(phase, scene, accel_base, timed_seconds, names,
                       engines=None, **render_kw):
    """A path's bench render under torch.profiler, as phase_profile: device
    kernel time, busy share, and the time of the path's own kernels."""
    avgs, wall = _profiled_render(scene, engines, accel=accel_base,
                                  **render_kw)
    res = _kernel_time(phase, avgs, wall, timed_seconds, names)
    emit(res)
    return res


# ---- ctiles' dynamic bounds on the card: block_cull and slot_sweep -------

# f32 operations of one ray/box test (csrc/ctiles_cull.cu slab_hit): an
# axis 2 subtractions, 2 products, 2 NaN compares, a min and a max; then 3
# max and 3 min over the axes and the window, and the final compare (the
# selects of a NaN axis are not counted)
CULL_OPS = 3 * 8 + 7
PAIRS_RAYS = 1 << 13  # a compacted overflow wave (the worklist fallback's)
SLOT_REPS = 20


def _slot_case_args(case, option):
    """(pack, rays, slot_ref, slot_cid, n_tiles) of a crafted slot case on
    the card, the pack in the option's layout."""
    from types import SimpleNamespace

    from path_tracer_ai_tpu_torch.accel import cuda_ctiles

    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device="cuda")
    acc = SimpleNamespace(v0=t(case["v0"]), e1=t(case["e1"]),
                          e2=t(case["e2"]), tri_id=t(case["tri_id"]))
    pack = {None: cuda_ctiles.pack_tris, "sub_skip": cuda_ctiles.pack_tris16,
            "pack_t": cuda_ctiles.pack_tris16_t}[option](acc)
    return (pack, t(case["rays"]), t(case["slot_ref"]), t(case["slot_cid"]),
            torch.tensor([case["n_tiles"]], dtype=torch.int32,
                         device="cuda"))


def _keep_ctiles_calls(scene, accel_base, accel_c) -> dict:
    """The bench render's first two closest ctiles waves (wave 0, bounces 0
    and 1): the inputs of their block_cull and slot_sweep launches. The
    render stops once it has them."""
    from path_tracer_ai_tpu_torch.accel import cuda_ctiles
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import wavefront
    from path_tracer_ai_tpu_torch.scene.camera import default_camera

    kept = {"block_cull": [], "slot_sweep": []}
    real = {k: getattr(cuda_ctiles, k) for k in kept}

    def keeper(name):
        def fn(*args, **kw):
            out = real[name](*args, **kw)
            if name == "block_cull" or kw.get("out") == "closest":
                if len(kept[name]) < 2:
                    kept[name].append((tuple(
                        a.clone() if torch.is_tensor(a) else a
                        for a in args), dict(kw)))
            if min(len(v) for v in kept.values()) >= 2:
                raise _Kept
            return out
        return fn

    try:
        for k in kept:
            setattr(cuda_ctiles, k, keeper(k))
        wavefront.render(scene, default_camera("cuda"),
                         RenderSettings(**BENCH), wave_size=1 << 20,
                         device="cuda", accel=accel_base,
                         accel_closest=accel_c)
    except _Kept:
        pass
    finally:
        for k, fn in real.items():
            setattr(cuda_ctiles, k, fn)
    if min(len(v) for v in kept.values()) < 2:
        fail("ctiles_bounds", f"the bench render made fewer than two closest "
                              f"ctiles calls: {[len(v) for v in kept.values()]}")
    return kept


def _cull_tests(accel, o_blk, d_blk, tm_blk, t_min, lb) -> int:
    """The ray/box tests block_cull's data needs: per live block and box,
    its rays up to the first that passes (all b where none does)."""
    from path_tracer_ai_tpu_torch.accel.kslots import _ray_slab

    nb, b = o_blk.shape[:2]
    step = max(1, (1 << 24) // (b * accel.num_clusters))
    tests = 0
    for lo in range(0, lb, step):
        hi = min(lo + step, lb)
        tf = tm_blk[lo:hi].reshape(-1)
        rc = _ray_slab(accel.bmin, accel.bmax, o_blk[lo:hi].reshape(-1, 3),
                       d_blk[lo:hi].reshape(-1, 3),
                       torch.full_like(tf, float(t_min)),
                       torch.where(tf >= 0.0, tf, -float("inf")))
        rc = rc.reshape(hi - lo, b, -1)
        first = torch.argmax(rc.to(torch.int8), dim=1) + 1
        tests += int(torch.where(rc.any(dim=1), first, b).sum())
    return tests


def _check_cull(call, wave, reps=SLOT_REPS) -> dict:
    """block_cull on a kept call: exact against its plain version, timed,
    bounded over the tests its data needs."""
    from path_tracer_ai_tpu_torch.accel import cuda_ctiles

    args, kw = call
    accel, o_blk, d_blk, tm_blk, t_min, cap, live = args
    got = cuda_ctiles.block_cull(*args, **kw)
    want = cuda_ctiles.block_cull_plain(*args, **kw)
    torch.cuda.synchronize()
    same = all(bool(torch.equal(g, w)) for g, w in zip(got, want))
    nb, b = o_blk.shape[:2]
    lb = nb if live is None else int(live)
    ms = cuda_ms(lambda: cuda_ctiles.block_cull(*args, **kw), reps)
    plain_ms = cuda_ms(lambda: cuda_ctiles.block_cull_plain(*args, **kw), 2)
    tests = _cull_tests(accel, o_blk, d_blk, tm_blk, t_min, lb)
    nbytes = lb * b * 7 * 4 + _nbytes(accel.bmin, accel.bmax, *got)
    by_bytes = nbytes / PEAK_BYTES_PER_S
    by_ops = tests * CULL_OPS / PEAK_F32_PER_S
    bound_ms = max(by_bytes, by_ops) * 1e3
    return {"wave": wave, "blocks": nb, "b": b, "live_blocks": lb,
            "clusters": accel.num_clusters, "cap": cap,
            "candidates_mean": float(got[1][:lb].float().mean())
            if lb else 0.0, "overflow_blocks": int(got[2].sum()),
            "matches_plain": same, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "box_tests": tests, "bytes": nbytes,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if by_bytes > by_ops else "operations",
            "ms_over_bound": ms / bound_ms}


def _cull_crafted(call) -> dict:
    """block_cull on a kept wave whose first quarter of rays start on a box
    corner along +x (0 * inf in the slab's y and z axes), at live-block
    counts 0, 1 and all (the rays past the count dead, as a sorted wave's
    are), at 1 with the rays past it live (their blocks must still get the
    empty set), and at cap 1 (every block with two candidates or more
    overflows): each exact against the plain version."""
    from path_tracer_ai_tpu_torch.accel import cuda_ctiles

    (accel, o_blk, d_blk, tm_blk, t_min, cap, live), kw = call
    o, d = o_blk.clone(), d_blk.clone()
    nb, b = o.shape[:2]
    q = nb // 4
    g = torch.Generator(device="cuda").manual_seed(5)
    cid = torch.randint(0, accel.num_clusters, (q, b), device="cuda",
                        generator=g)
    o[:q] = accel.bmin[cid]
    d[:q] = torch.tensor([1.0, 0.0, 0.0], device="cuda")
    lb = nb if live is None else int(live)
    out = {}
    for label, cap_, n, dead_tail in (
            ("live_0", cap, 0, True), ("live_1", cap, 1, True),
            ("live_1_live_tail", cap, 1, False),
            ("live_all", cap, lb, True), ("cap_1", 1, lb, True)):
        bound = torch.tensor([n], dtype=torch.int32, device="cuda")
        tm = tm_blk.clone()
        if dead_tail:  # a sorted wave: the rays past the bound are dead
            tm[n:] = -1.0
        args = (accel, o, d, tm, t_min, cap_, bound)
        got = cuda_ctiles.block_cull(*args, **kw)
        want = cuda_ctiles.block_cull_plain(*args, **kw)
        out[label] = all(bool(torch.equal(x, y)) for x, y in zip(got, want))
    return out


def _slot_tests(call) -> tuple:
    """(needed tests, bytes) of a slot_sweep call: the live lanes of the
    live tiles' slots against their cluster's S triangles; the live slots'
    refs and cluster ids, their lanes' rays, the distinct clusters' packs
    and the outputs."""
    (pack, rays, ref, cid, n_tiles), kw = call
    tb, b = kw["tile_slots"], rays.shape[2]
    nt = int(n_tiles)
    live_ref = ref[:nt * tb]
    rows = torch.where(live_ref >= 0, live_ref // kw["cap"],
                       rays.shape[0] - 1).long()
    lanes = int((rays[rows, 6] >= 0.0).sum())
    s = pack.shape[1] if kw.get("pack_t") else pack.shape[2]
    stride = kw.get("cid_stride", 1)
    used = int(torch.unique(cid[:nt * stride:stride]).numel()) if nt else 0
    out_bytes = {"closest": (rays.shape[0] - 1) * b * 8,
                 "any": (rays.shape[0] - 1) * b,
                 "slot": ref.shape[0] * b * 8}[kw["out"]]
    nbytes = (nt * tb * 4 + nt * 4 + int((live_ref >= 0).sum()) * b * 32
              + used * pack.shape[1 if not kw.get("pack_t") else 2]
              * s * 4 + out_bytes)
    return lanes * s, nbytes


def _check_slot(call, wave, variant, reps=SLOT_REPS) -> dict:
    """slot_sweep on a kept call: bitwise against its plain version (eager
    tile_sweep_plain) and against the chunked form it replaced (the plain
    version sweeping through the tile_sweep kernel, its tile count read on
    the host); kernel, generic, plain and stepped ms, bound."""
    from functools import partial

    from path_tracer_ai_tpu_torch.accel import cuda_ctiles

    args, kw = call
    run = lambda: cuda_ctiles.slot_sweep(*args, **kw)

    def run_generic():
        with _generic_instances():
            return run()

    got = run()
    generic = run_generic()
    plain = partial(cuda_ctiles.slot_sweep_plain, *args, **kw,
                    sweep=cuda_ctiles.tile_sweep_plain)
    stepped = partial(cuda_ctiles.slot_sweep_plain, *args, **kw)
    swept = {}  # the plain version's tests: sub_skip's, of its sub-slabs
    want = cuda_ctiles.slot_sweep_plain(
        *args, **kw, sweep=partial(cuda_ctiles.tile_sweep_plain,
                                   stats=swept))
    old = stepped()
    torch.cuda.synchronize()
    tests, nbytes = _slot_tests(call)
    if kw.get("sub_skip"):
        tests = swept["lane_tests"]
    ms = cuda_ms(run, reps)
    generic_ms = cuda_ms(run_generic, reps)
    res = {"wave": wave, "variant": variant, "out": kw["out"],
           "T": kw["tile_slots"] * args[1].shape[2],
           "S": args[0].shape[1] if kw.get("pack_t") else args[0].shape[2],
           "slot_cap_tiles": args[2].shape[0] // kw["tile_slots"],
           "live_tiles": int(args[4]),
           "matches_plain": _same_outputs(got, want),
           "generic_matches_plain": _same_outputs(generic, want),
           "matches_stepped": _same_outputs(old, want),
           "max_abs_err": (_max_abs_err(got[0], want[0])
                           if len(got) == 2 else 0.0),
           "ms": ms, "generic_ms": generic_ms,
           "plain_ms": cuda_ms(plain, 1),
           "host_stepped_ms": cuda_ms(stepped, 3),
           **_bound(nbytes, tests)}
    res["ms_over_bound"] = ms / res["bound_ms"]
    res["generic_over_bound"] = generic_ms / res["bound_ms"]
    return res


def _pairs_call(call, accel_base) -> tuple:
    """A pairs sweep of the worklist fallback's shape (T 128, S 128, one
    lane a slot): the first PAIRS_RAYS live rays of a kept closest wave
    through pairs.build_pair_tables (cap 64, pair budget 12) and
    pairs._sweep_tiles, whose slot_sweep inputs are kept."""
    from path_tracer_ai_tpu_torch.accel import cuda_ctiles, pairs

    (_pack, rays, _ref, _cid, _n), kw = call
    table = rays[:-1]
    o = table[:, 0:3].transpose(1, 2).reshape(-1, 3)
    d = table[:, 3:6].transpose(1, 2).reshape(-1, 3)
    tm = table[:, 6].reshape(-1)
    t_min = float(table[0, 7, 0])
    live = torch.nonzero(tm >= 0.0).squeeze(1)[:PAIRS_RAYS]
    o, d, tm = o[live].contiguous(), d[live].contiguous(), tm[live].contiguous()
    tables = pairs.build_pair_tables(accel_base, o, d, t_min, tm, cap=64,
                                     pair_budget=12, pair_align=256)
    kept = []
    real = cuda_ctiles.slot_sweep

    def keep(*a, **k):
        kept.append((a, dict(k)))
        return real(*a, **k)

    cuda_ctiles.slot_sweep = keep
    try:
        pairs._sweep_tiles(accel_base, tables, o, d, t_min, tm, 128, True,
                           cuda_ctiles.pack_tris(accel_base))
    finally:
        cuda_ctiles.slot_sweep = real
    return kept[0]


def _slot_crafted() -> dict:
    """slot_sweep on every crafted slot case (tests/test_torch_sweep_cases
    slot_case) at S 128, each shape, output, option, tuned and generic:
    bitwise its plain version."""
    from path_tracer_ai_tpu_torch.accel import cuda_ctiles

    c = _cases()
    bad, n = [], 0
    for name in c.SLOT_CASES:
        for tb, b in c.SLOT_SHAPES:
            case = c.slot_case(name, 128, tb, b)
            for opt in (None, "sub_skip", "pack_t"):
                args = _slot_case_args(case, opt)
                for out in ("closest", "any", "slot"):
                    kw = dict(tile_slots=tb, cap=case["cap"], out=out,
                              cid_stride=tb, sub_skip=opt == "sub_skip",
                              pack_t=opt == "pack_t")
                    want = cuda_ctiles.slot_sweep_plain(
                        *args, **kw, sweep=cuda_ctiles.tile_sweep_plain)
                    got = cuda_ctiles.slot_sweep(*args, **kw)
                    with _generic_instances():
                        generic = cuda_ctiles.slot_sweep(*args, **kw)
                    n += 2
                    for label, res in (("tuned", got), ("generic", generic)):
                        if not _same_outputs(res, want):
                            bad.append([name, tb, b, opt, out, label])
    return {"runs": n, "disagree": bad}


def phase_ctiles_bounds(scene, accel_base, accel_c, card, render) -> tuple:
    """ctiles' dynamic bounds on the card: block_cull and slot_sweep on the
    main path's kept closest waves (wave 0, bounces 0 and 1) and on crafted
    inputs, each bitwise its plain version, timed beside its bound; the
    main render's host reads by site. Returns (checks for the kernels line,
    generic entries, the stepped comparison's tile_sweep launches)."""
    from path_tracer_ai_tpu_torch.accel import cuda_ctiles

    t0 = time.perf_counter()
    kept = _keep_ctiles_calls(scene, accel_base, accel_c)
    culls = [_check_cull(call, f"wave 0, bounce {i}")
             for i, call in enumerate(kept["block_cull"])]
    crafted_cull = _cull_crafted(kept["block_cull"][1])
    _reset_counts()
    slots = []
    for i, call in enumerate(kept["slot_sweep"]):
        wave = f"wave 0, bounce {i}"
        args, kw = call
        slots.append(_check_slot(call, wave, "default"))
        for out in ("any", "slot"):
            slots.append(_check_slot((args, {**kw, "out": out}), wave,
                                     "default"))
        for opt, pack in (("sub_skip", cuda_ctiles.pack_tris16(accel_c)),
                          ("pack_t", cuda_ctiles.pack_tris16_t(accel_c))):
            slots.append(_check_slot(((pack,) + args[1:],
                                      {**kw, opt: True}), wave, opt))
    slots.append(_check_slot(_pairs_call(kept["slot_sweep"][1], accel_base),
                             "pairs on 8,192 rays of wave 0, bounce 1",
                             "default"))
    stepped = _read_counts()["tile_sweep"]
    crafted_slot = _slot_crafted()
    sites = render["host_sync_sites"]
    res = {"phase": "ctiles_bounds", "card": card, "block_cull": culls,
           "block_cull_crafted": crafted_cull, "slot_sweep": slots,
           "slot_sweep_crafted": crafted_slot,
           "main_path_host_reads": render["host_syncs"],
           "main_path_host_read_sites": sites,
           "ctiles_or_pairs_sweep_reads": _ctiles_bound_reads(sites),
           "seconds": time.perf_counter() - t0}
    emit(res)
    ok = (all(c["matches_plain"] for c in culls) and all(crafted_cull.values())
          and all(c["matches_plain"] and c["generic_matches_plain"]
                  and c["matches_stepped"] for c in slots)
          and not crafted_slot["disagree"])
    if not ok:
        fail("ctiles_bounds", "block_cull or slot_sweep disagrees with its "
                              "plain version")
    main = slots[5]  # wave 0, bounce 1, closest, default (T 128, S 256)
    cull = culls[1]
    checks = {"block_cull": {**cull, "waves": culls},
              "slot_sweep": {**main, "waves": [
                  {k: c[k] for k in ("wave", "variant", "out", "T", "S",
                                     "live_tiles", "ms", "generic_ms",
                                     "plain_ms", "host_stepped_ms",
                                     "bound_ms", "ms_over_bound",
                                     "matches_plain")} for c in slots]}}
    generic = {"block_cull": None, "slot_sweep": {
        "S": main["S"], "generic_ms": main["generic_ms"],
        "tuned_ms": main["ms"],
        "generic_over_tuned": main["generic_ms"] / main["ms"],
        "bound_ms": main["bound_ms"],
        "generic_over_bound": main["generic_over_bound"],
        "plain_ms": main["plain_ms"],
        "matches_plain": main["generic_matches_plain"]}}
    return checks, generic, {"tile_sweep": stepped}


# ---- the packet cascades' interval cull on the card: packet_cull ---------

# f32 operations of the interval cull (csrc/packet_cull.cu), counted per
# (block, cluster) pair: per axis whose direction interval does not span 0,
# 2 subtractions, 4 divisions, 6 min / max for the quotients' bounds and 2
# for lb / ub (PCULL_AXIS_OPS); then 3 compares for the candidate test, a
# max and a select for the entry (PCULL_PAIR_OPS). The sort: n log2 n
# compares a block at n finite entries, a comparison sort's least.
PCULL_AXIS_OPS = 14
PCULL_PAIR_OPS = 5
PCULL_REPS = 20
# crafted inputs on the card: (blocks, rays a block, clusters); C 48
# sorts in one warp's two registers a lane (all_candidates: 48 finite
# entries), C 16,385 is past the shared-memory sort
# (cuda_cull.SMEM_SORT_MAX_C)
PCULL_CRAFTED_SIZES = ((64, 64, 641), (16, 256, 2561), (4, 1024, 70),
                       (8, 8, 48), (6, 32, 16385))
PCULL_WAVE = 1 << 20  # rays of the packets-route and worklist-shape inputs


def _split_module():
    """scripts/torch_ctiles_split.py, loaded by path: its profiler ranges
    and the device-time split of a profiled render."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts", "torch_ctiles_split.py")
    spec = importlib.util.spec_from_file_location("torch_ctiles_split", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cull_inputs(accel, o, d, t_max, block, sort):
    """(accel, o_blk, d_blk, tm_blk) that a packet cascade gives the cull:
    the rays sorted as the query sorts them ("dir" keys), in blocks."""
    from path_tracer_ai_tpu_torch.accel import traverse

    n = o.shape[0]
    tm = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                            device=o.device), (n,))
    if sort:
        o, d, tm, _perm = traverse._sort_rays(accel, o, d, tm, "dir")
    nb = n // block
    return (accel, o.reshape(nb, block, 3).contiguous(),
            d.reshape(nb, block, 3).contiguous(),
            tm.reshape(nb, block).contiguous())


def _shadow_cull_inputs(call):
    """The cull's inputs of a kept any_hit_packets call (args, kw)."""
    args, kw = call
    accel, o, d, _t_min, t_max = args[:5]
    return _cull_inputs(accel, o, d, t_max, kw.get("block_size", 256),
                        kw.get("sort", True))


def _same_cull(got, want) -> bool:
    """order and n_cand identical; entry_sorted equal as values (-0.0 ==
    +0.0), without NaN; both without entries where want has none."""
    ok = (torch.equal(got[0].cpu(), want[0].cpu())
          and torch.equal(got[1].cpu(), want[1].cpu()))
    if want[2] is None:
        return ok and got[2] is None
    g, w = got[2].cpu(), want[2].cpu()
    return ok and bool((g == w).all()) and not bool(torch.isnan(g).any())


def _pcull_bound(inputs, with_entry) -> dict:
    """Bytes (the rays once, the boxes, order, n_cand and the entries where
    written) and operations (the interval test of the axes that do not span
    0, the candidate test, the sort of the finite entries) of one call."""
    from path_tracer_ai_tpu_torch.accel import cuda_cull, traverse

    accel, o_blk, d_blk, tm_blk = inputs
    nb, r = o_blk.shape[:2]
    c = accel.num_clusters
    _olo, _ohi, dlo, dhi = traverse._ray_block_bounds(o_blk, d_blk,
                                                      tm_blk >= 0.0)
    axes = int((~((dlo <= 0.0) & (dhi >= 0.0))).sum())
    entry = cuda_cull.block_candidates_plain(*inputs)[2]
    n_fin = torch.isfinite(entry).sum(dim=1).double()
    sort_ops = float((n_fin * torch.ceil(torch.log2(
        torch.clamp(n_fin, min=1.0)))).sum())
    ops = nb * c * PCULL_PAIR_OPS + axes * c * PCULL_AXIS_OPS + sort_ops
    nbytes = (nb * r * 28 + c * 24 + nb * c * 4 + nb * 4
              + (nb * c * 4 if with_entry else 0))
    by_bytes = nbytes / PEAK_BYTES_PER_S
    by_ops = ops / PEAK_F32_PER_S
    return {"bytes": nbytes, "operations": ops, "axis_tests": axes * c,
            "finite_entries_mean": float(n_fin.mean()),
            "bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _check_pcull(label, inputs, with_entry, plain_on_cpu=False,
                 reps=PCULL_REPS) -> dict:
    """packet_cull on one input: against its plain version (on the card, or
    on CPU copies of the inputs), timed beside its bound and the plain
    version on the card."""
    from path_tracer_ai_tpu_torch.accel import cuda_cull

    run = lambda: cuda_cull.block_candidates(*inputs, with_entry)
    plain = lambda: cuda_cull.block_candidates_plain(*inputs, with_entry)
    got = run()
    if plain_on_cpu:
        from types import SimpleNamespace

        acc = inputs[0]
        cpu = (SimpleNamespace(bmin=acc.bmin.cpu(), bmax=acc.bmax.cpu(),
                               num_clusters=acc.num_clusters),
               *(x.cpu() for x in inputs[1:]))
        want = cuda_cull.block_candidates_plain(*cpu, with_entry)
    else:
        want = plain()
    torch.cuda.synchronize()
    accel, o_blk = inputs[:2]
    res = {"input": label, "blocks": o_blk.shape[0], "R": o_blk.shape[1],
           "C": accel.num_clusters, "with_entry": with_entry,
           "plain_on": "cpu" if plain_on_cpu else "card",
           "candidates_mean": float(got[1].float().mean()),
           "matches_plain": _same_cull(got, want), "max_abs_err": 0.0,
           "ms": cuda_ms(run, reps), "plain_ms": cuda_ms(plain, 2),
           **_pcull_bound(inputs, with_entry)}
    res["ms_over_bound"] = res["ms"] / res["bound_ms"]
    return res


def phase_packet_cull(card, render, profile, kept_shadows, accel_base,
                      accel_w) -> dict:
    """The packet cascades' interval cull on the card: packet_cull against
    its plain version on the main path's kept shadow calls (wave 0, bounce
    0 unsorted and bounce 1 sorted: 65,536 blocks of 64, C 641, no
    entries), a packets-route closest call (blocks of 256, t_max +inf, with
    entries), the worklist cell's accel (C 2,561) at the fallbacks' blocks
    of 64, and every crafted cull case (tests/test_torch_sweep_cases.py
    cull_case) at PCULL_CRAFTED_SIZES, with and without entries; each
    timed beside its bound and the plain version. The main render's cull
    launches, its device time split by step (the profile phase's ranges),
    its timed pass. Returns the kernels line's check."""
    from types import SimpleNamespace

    rng = np.random.default_rng(20)
    t0 = time.perf_counter()
    if len(kept_shadows) < 2:
        fail("packet_cull", f"{len(kept_shadows)} kept shadow calls, not 2")
    waves = [_check_pcull(
        f"main path shadow call, wave 0, bounce {i}"
        + ("" if kw.get("sort", True) else " (unsorted)"),
        _shadow_cull_inputs((args, kw)), False)
        for i, (args, kw) in enumerate(kept_shadows[:2])]
    o, d, tm = _bounce_wave(accel_base, PCULL_WAVE, rng, shadow=False)
    waves.append(_check_pcull(
        f"packets-route closest call: {PCULL_WAVE:,} bounce rays, t_max +inf",
        _cull_inputs(accel_base, o, d, tm, 256, True), True))
    o, d, tm = _bounce_wave(accel_w, PCULL_WAVE, rng, shadow=True)
    waves.append(_check_pcull(
        f"worklist cell's accel (C {accel_w.num_clusters:,}): {PCULL_WAVE:,} "
        f"shadow rays, blocks of 64", _cull_inputs(accel_w, o, d, tm, 64,
                                                   True), False))
    c = _cases()
    t = lambda a: torch.as_tensor(a, device="cuda")
    crafted = []
    for name in c.CULL_CASES:
        for nb, r, cc in PCULL_CRAFTED_SIZES:
            case = c.cull_case(name, nb, r, cc)
            acc = SimpleNamespace(bmin=t(case["bmin"]), bmax=t(case["bmax"]),
                                  num_clusters=cc)
            for with_entry in (True, False):
                crafted.append(_check_pcull(
                    name, (acc, t(case["o"]), t(case["d"]), t(case["tm"])),
                    with_entry, plain_on_cpu=True, reps=3))
    split = profile.get("split", {}).get("ranges", {})
    shadow = {k: v["seconds"] for k, v in split.items()
              if k.startswith("packet_") or k == "cascade_stage"}
    res = {"phase": "packet_cull", "card": card,
           "waves": waves,
           "crafted": [{k: x[k] for k in ("input", "blocks", "R", "C",
                                          "with_entry", "matches_plain",
                                          "ms", "plain_ms", "bound_ms",
                                          "ms_over_bound")}
                       for x in crafted],
           "crafted_disagree": [[x["input"], x["blocks"], x["R"], x["C"],
                                 x["with_entry"]]
                                for x in crafted if not x["matches_plain"]],
           "main_path_launches": render["launches"]["packet_cull"],
           "main_path_timed_pass_seconds": render["seconds"],
           "main_path_host_reads": render["host_syncs"],
           "main_path_device_kernel_seconds":
               profile.get("device_kernel_seconds"),
           "main_path_split_seconds": {k: v["seconds"]
                                       for k, v in split.items()},
           "shadow_eager_steps_seconds": shadow,
           "shadow_eager_seconds": sum(shadow.values()),
           "packet_cull_kernel_seconds": profile["path_kernels"].get(
               "packet_cull_kernel", {}).get("seconds"),
           "seconds": time.perf_counter() - t0}
    emit(res)
    if not all(w["matches_plain"] for w in waves) or res["crafted_disagree"]:
        fail("packet_cull", "packet_cull disagrees with its plain version")
    if render["launches"]["packet_cull"] != 20:
        fail("packet_cull", f"the main path launched packet_cull "
                            f"{render['launches']['packet_cull']} times, "
                            f"not 20")
    return {**waves[1], "waves": [
        {k: w[k] for k in ("input", "blocks", "R", "C", "with_entry", "ms",
                           "plain_ms", "bound_ms", "bound_by",
                           "ms_over_bound", "matches_plain")}
        for w in waves]}


# ---- the generic instances: any cluster size ------------------------------

class _generic_instances:
    """Every kernel wrapper launches its generic instance (S at run time)
    for the duration of the block, also where a tuned one is compiled: the
    wrappers launch through cuda_build.launch_instance, whose use_generic
    this forces."""

    def __enter__(self):
        global _INSTANCE
        from path_tracer_ai_tpu_torch import cuda_build

        self.real = real = cuda_build.launch_instance
        cuda_build.launch_instance = (
            lambda tuned, generic, dev, args, generic_args=None,
            use_generic=False: real(tuned, generic, dev, args, generic_args,
                                    use_generic=True))
        _INSTANCE = "generic"

    def __exit__(self, *exc):
        global _INSTANCE
        from path_tracer_ai_tpu_torch import cuda_build

        cuda_build.launch_instance = self.real
        _INSTANCE = None


def _generic_counts() -> dict:
    """Launches of each kernel's generic instance since the last reset."""
    from path_tracer_ai_tpu_torch.accel import (
        cuda_anyhit,
        cuda_cascade,
        cuda_closest,
        cuda_ctiles,
        cuda_items,
        cuda_kslots,
        cuda_sweep,
    )

    return {"tile_sweep": cuda_ctiles.generic_launches,
            "slot_sweep": cuda_ctiles.sweep_generic_launches,
            **cuda_sweep.generic_launches,
            **cuda_cascade.generic_launches,
            "block_anyhit": cuda_anyhit.generic_launches,
            "block_closest": cuda_closest.generic_launches,
            "item_sweep": cuda_items.generic_launches,
            "kslot_sweep": cuda_kslots.generic_launches}


def phase_generic_kernels(accel_base, item_args, checks, card):
    """Each kernel's generic instance at S = 128 beside its tuned instance
    on the same inputs (the shapes of the paths' checks: tile_sweep at the
    main path's shadow cascade (T 64, G 2) and at pair tiles (T 128), the
    pallas sweeps, the fused kernels, kslot_sweep's two waves, item_sweep
    on the worklist render's kept waves): bitwise its plain version, its
    time, bound and plain time beside the tuned instance's time."""
    def both(run):
        tuned = run(np.random.default_rng(17))
        _reset_counts()
        with _generic_instances():
            gen = run(np.random.default_rng(17))
        return tuned, gen, _generic_counts()

    runs = {
        "tile_sweep": lambda rng: {"tile_sweep": _check_tile_sweep(
            accel_base, 64, 2048, rng, reps=20, g=2)},
        "tile_sweep_t128": lambda rng: {"tile_sweep_t128": _check_tile_sweep(
            accel_base, 128, 2048, rng, reps=20)},
        "sweeps": lambda rng: _check_sweeps(accel_base, rng),
        "fused": lambda rng: _check_fused(accel_base, rng),
        "kslot_sweep": lambda rng: {"kslot_sweep": _check_kslot_sweep(
            accel_base, rng, shadow=False)},
    }
    rows = {}
    for key, run in runs.items():
        tuned, gen, counts = both(run)
        for name, g in gen.items():
            kernel = name.split("_t128")[0]
            if counts[kernel] <= 0:
                fail("generic_kernels", f"{name}: no generic launch")
            rows[name] = {"tuned_ms": tuned[name]["ms"], "generic": g}
    # item_sweep: the worklist render's kept waves (the tuned instance's
    # checks ran in item_waves on the same arguments)
    _reset_counts()
    with _generic_instances():
        gen = _check_item_sweep(item_args[0], "closest, wave 0, bounce 1")
    if _generic_counts()["item_sweep"] <= 0:
        fail("generic_kernels", "item_sweep: no generic launch")
    rows["item_sweep"] = {"tuned_ms": checks["item_sweep"]["ms"],
                          "generic": gen}
    out = {name: {"S": r["generic"]["S"], "tuned_ms": r["tuned_ms"],
                  "generic_ms": r["generic"]["ms"],
                  "generic_over_tuned": r["generic"]["ms"] / r["tuned_ms"],
                  "bound_ms": r["generic"]["bound_ms"],
                  "bound_by": r["generic"]["bound_by"],
                  "generic_over_bound": r["generic"]["ms_over_bound"],
                  "plain_ms": r["generic"]["plain_ms"],
                  "matches_plain": r["generic"]["matches_plain"],
                  "max_abs_err": r["generic"]["max_abs_err"]}
           for name, r in rows.items()}
    emit({"phase": "generic_kernels", "card": card, "kernels": out})
    return out


_CASES = []


def _cases():
    """tests/test_torch_sweep_cases.py (numpy only), loaded by its path:
    another installed package may answer to "tests"."""
    import importlib.util

    if not _CASES:
        spec = importlib.util.spec_from_file_location(
            "sweep_cases", os.path.join(
                os.path.dirname(os.path.abspath(__file__)), "tests",
                "test_torch_sweep_cases.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _CASES.append(mod)
    return _CASES[0]


def phase_sweep_cases(card):
    """item_sweep and kslot_sweep on the crafted cases of
    tests/test_torch_sweep_cases.py (exact t ties across an item's clusters
    or a row's slots, a cluster named twice, garbage slots past n_cand /
    n_slots, dead and overflowed rays, n_items 0 and = i_cap, rays all
    occluded by the first chunk) at each of its sizes, closest and any hit,
    through the instance the wrapper picks and through the generic one:
    each bitwise its plain version; a mismatch fails the run."""
    import contextlib

    from path_tracer_ai_tpu_torch.accel import cuda_ctiles, cuda_items, cuda_kslots

    cases = _cases()
    t = lambda a: torch.as_tensor(a, device="cuda")
    inputs = []
    for s in cases.SIZES:
        for name in cases.ITEM_CASES:
            c = cases.item_case(name, s)
            inputs.append(("item_sweep", name, s, (
                t(cases.pack(c)), t(cases.item_block_rays(c)),
                *(t(c[k]) for k in ("item_block", "ibase", "order_g",
                                    "n_cand")), c["n_items"])))
        for name in cases.KSLOT_CASES:
            c = cases.kslot_case(name, s)
            inputs.append(("kslot_sweep", name, s, (
                t(cases.pack(c)), t(cases.kslot_rays(c)), t(c["cid"]),
                t(c["n_slots"]))))
    bad = []
    checked = 0
    for kernel, name, s, args in inputs:
        mod = cuda_items if kernel == "item_sweep" else cuda_kslots
        for want_tri in (True, False):
            plain = getattr(mod, kernel + "_plain")(*args, want_tri)
            for forced in (False, True):
                with (_generic_instances() if forced
                      else contextlib.nullcontext()):
                    got = getattr(mod, kernel)(*args, want_tri)
                checked += 1
                if not _same_outputs(got, plain):
                    bad.append([kernel, name, s, want_tri, forced])
    # the first-slot instances (tie="slot") on the first-slot cases: tiles of
    # T 1, 64, 256 lanes against G 1, 4, 8 clusters; kslots rows of K 1, 4, 8
    first = []
    for s in cases.SIZES:
        for name in cases.FIRST_CASES:
            for t_lanes in cases.FIRST_T:
                for g in cases.FIRST_G:
                    c = cases.first_case(name, s, t_lanes, g)
                    first.append((cuda_ctiles.tile_sweep,
                                  cuda_ctiles.tile_sweep_plain,
                                  [name, s, t_lanes, g],
                                  (t(cases.pack(c)), t(c["rays"]),
                                   t(c["tile_cid"]))))
            for k in cases.FIRST_G:
                c = cases.first_kslot_case(name, s, k)
                first.append((cuda_kslots.kslot_sweep,
                              cuda_kslots.kslot_sweep_plain, [name, s, k],
                              (t(cases.pack(c)), t(c["rays"]), t(c["cid"]),
                               t(c["n_slots"]), True)))
    for run, run_plain, tag, args in first:
        plain = run_plain(*args, tie="slot")
        for forced in (False, True):
            with (_generic_instances() if forced
                  else contextlib.nullcontext()):
                got = run(*args, tie="slot")
            checked += 1
            if not _same_outputs(got, plain):
                bad.append([run.__name__ + "_first", *tag, forced])
    # the cascade stage kernel on the crafted cascades, through
    # traverse._cascade_stages: the carry, the block order and the final k
    from path_tracer_ai_tpu_torch.accel import cuda_cascade

    for name in cases.CASCADE_CASES:
        for s_ in CASCADE_CASE_SIZES:
            for t_lanes in cases.CASCADE_T:
                for g in CASCADE_CASE_G:
                    case = cases.cascade_case(name, s_, t_lanes, g)
                    for closest in (False, True):
                        want = _cascade_case_run(
                            cuda_cascade.cascade_stage_plain, case, closest)
                        for forced in (False, True):
                            with (_generic_instances() if forced
                                  else contextlib.nullcontext()):
                                got = _cascade_case_run(
                                    cuda_cascade.cascade_stage, case,
                                    closest)
                            checked += 1
                            if not (_same_outputs(got[0], want[0])
                                    and got[1:] == want[1:]):
                                bad.append(["cascade_stage", name, s_,
                                            t_lanes, g, closest, forced])
    torch.cuda.synchronize()
    emit({"phase": "sweep_cases", "card": card, "sizes": list(cases.SIZES),
          "cascade_cases": list(cases.CASCADE_CASES),
          "cascade_S": list(CASCADE_CASE_SIZES),
          "cascade_T": list(cases.CASCADE_T),
          "cascade_G": list(CASCADE_CASE_G),
          "item_cases": list(cases.ITEM_CASES),
          "kslot_cases": list(cases.KSLOT_CASES),
          "first_slot_cases": list(cases.FIRST_CASES),
          "first_slot_T": list(cases.FIRST_T),
          "first_slot_G": list(cases.FIRST_G), "checked": checked,
          "mismatches": bad})
    if bad:
        fail("sweep_cases", f"{len(bad)} crafted cases differ from the "
                            f"plain versions: {bad[:8]}")


# The crafted cascades' cluster sizes and groups on the card (the tuned
# stage instances are S 128; G 5 and 8 leave C = 12 ragged).
CASCADE_CASE_SIZES = (16, 128)
CASCADE_CASE_G = (2, 5, 8)


def _cascade_case_run(stage, case, closest) -> tuple:
    """A crafted cascade through traverse._cascade_stages with `stage` (the
    wrapper or its plain version): (carry + (blk_index,), final k)."""
    from path_tracer_ai_tpu_torch.accel import traverse

    t = lambda a: torch.as_tensor(a, device="cuda")
    pack = t(_cases().pack(case))
    nb, t_lanes = case["tm"].shape
    blocks = (t(case["rays"]), t(case["order_g"]), t(case["n_cand"]))
    if closest:
        blocks += (t(case["entry"]),)
        carry = (torch.full((nb, t_lanes), np.inf, device="cuda"),
                 torch.full((nb, t_lanes), -1, dtype=torch.int32,
                            device="cuda"))
    else:
        carry = (torch.zeros((nb, t_lanes), dtype=torch.bool,
                             device="cuda"),)
    ks = []

    def run(b, c, k, thr):
        out = stage(pack, b[0], b[1], b[2], c, k, thr,
                    **({"entry": b[3]} if closest else {}))
        ks.append(out[1])
        return out

    carry, blk = traverse._cascade_stages(blocks, carry, run)
    return (*carry, blk), int(ks[-1])


CLUSTER_SIZES = (2, 16, 64, 96, 512)
CLUSTER_ROUTES = ("main", "pallas", "worklist", "kslots", "fused")


def _generic_checks(acc, rng) -> dict:
    """Each kernel's generic instance (forced) against its plain version on
    a small wave over `acc`, at the shapes the routes give it: {name: bitwise
    / exact}."""
    from path_tracer_ai_tpu_torch.accel import (
        cuda_anyhit,
        cuda_closest,
        cuda_ctiles,
        cuda_items,
        cuda_kslots,
        cuda_sweep,
        kslots,
        worklist,
    )
    from path_tracer_ai_tpu_torch.accel.traverse import pack_block_rays

    same = _same_outputs
    out = {}
    with _generic_instances():
        pack = cuda_ctiles.pack_tris(acc)
        ok = True
        for t_lanes, g in ((64, 2), (128, 1), (32, 1)):
            rays, cid = _tile_rays(acc, 256, t_lanes, rng, g)
            ok = ok and same(cuda_ctiles.tile_sweep(pack, rays, cid),
                             cuda_ctiles.tile_sweep_plain(pack, rays, cid))
        for opt, opt_pack in (("sub_skip", cuda_ctiles.pack_tris16(acc)),
                              ("pack_t", cuda_ctiles.pack_tris16_t(acc))):
            ok = ok and same(
                cuda_ctiles.tile_sweep(opt_pack, rays, cid, **{opt: True}),
                cuda_ctiles.tile_sweep_plain(opt_pack, rays, cid,
                                             **{opt: True}))
        out["tile_sweep"] = ok
        ok = True
        for name in ("ties", "spread"):
            case = _cases().slot_case(name, acc.cluster_size, 16, 8)
            args = _slot_case_args(case, None)
            for out_ in ("closest", "any", "slot"):
                kw = dict(tile_slots=16, cap=case["cap"], out=out_,
                          cid_stride=16)
                ok = ok and same(
                    cuda_ctiles.slot_sweep(*args, **kw),
                    cuda_ctiles.slot_sweep_plain(
                        *args, **kw, sweep=cuda_ctiles.tile_sweep_plain))
        out["slot_sweep"] = ok

        slab = cuda_sweep.build_slab_table(acc)
        o, d, tm = _bounce_wave(acc, 256 * 64, rng, shadow=True)
        rays, order, entry, n_cand, _p = cuda_sweep._prep_wave(
            acc, o, d, tm, 64, True)
        rays = _kill_every_seventh(rays)
        out["closest_sweep"] = same(
            cuda_sweep.closest_sweep(slab, rays, order, entry, n_cand),
            cuda_sweep.closest_sweep_plain(slab, rays, order, entry, n_cand))
        out["anyhit_sweep"] = same(
            (cuda_sweep.anyhit_sweep(slab, rays, order, n_cand),),
            (cuda_sweep.anyhit_sweep_plain(slab, rays, order, n_cand),))

        fpack = cuda_anyhit.pack_tris_dummy(acc)
        o2, d2, tm2, _p, _nc, _e, order_g = cuda_anyhit.prepare_fused_wave(
            acc, o, d, tm, 64, True, "dir")
        frays = _kill_every_seventh(cuda_ctiles.pack_rays_tiles(o2, d2, tm2,
                                                                64))
        cid8 = order_g[:, 0].reshape(-1).contiguous()
        out["block_anyhit"] = all(
            same((cuda_anyhit.block_anyhit(fpack, frays, cid8, e_, s_),),
                 (cuda_anyhit.block_anyhit_plain(fpack, frays, cid8, e_,
                                                 s_),))
            for e_ in (False, True) for s_ in (False, True))
        out["block_closest"] = all(
            same(cuda_closest.block_closest(fpack, frays, cid8, s_),
                 cuda_closest.block_closest_plain(fpack, frays, cid8, s_))
            for s_ in (False, True))

        small = acc.cluster_size < 64
        kw = dict(cap=1024, item_budget=64,
                  super_cap=max(acc.num_supers, 1)) if small else dict(
            cap=96, item_budget=8, super_cap=32)
        ok = True
        for want_tri in (True, False):
            tmw = torch.where(tm >= 0, torch.inf, tm) if want_tri else tm
            blocks = worklist._prepare_blocks(acc, o, d, tmw, 8, True)[:3]
            wl = worklist._build_worklist(acc, *blocks, 1e-3, kw["cap"], 4,
                                          kw["item_budget"], 1 << 13, 1024,
                                          super_cap=kw["super_cap"])
            args = (pack, pack_block_rays(*blocks, 1e-3), wl.item_block,
                    wl.ibase, wl.order_g, wl.n_cand, int(wl.n_items),
                    want_tri)
            ok = ok and same(cuda_items.item_sweep(*args),
                             cuda_items.item_sweep_plain(*args))
        out["item_sweep"] = ok

        ok = True
        for want_tri, k in ((True, 12), (False, 8)):
            tmk = torch.where(tm >= 0, torch.inf, tm) if want_tri else tm
            tab = kslots._tables(acc, o, d, tmk, 1e-3, 6, k, 0, 1 << 15)
            tb = torch.where(tab["live"] & ~tab["over"], tmk, -1.0)
            args = (pack, cuda_kslots.pack_rays(o, d, tb, 1e-3), tab["cid"],
                    tab["n_slots"], want_tri)
            ok = ok and same(cuda_kslots.kslot_sweep(*args),
                             cuda_kslots.kslot_sweep_plain(*args))
        out["kslot_sweep"] = ok

        # the cascade stage kernel: whole cascades at blocks of 64, against
        # its plain version in every stage
        from path_tracer_ai_tpu_torch.accel import cuda_cascade, traverse

        ok_any = ok_first = True
        for g in (2, 8):
            args = (acc, o, d, 1e-3, tm)
            kw = dict(block_size=64, group_size=g)
            occ = traverse.any_hit_packets(*args, **kw)
            hit = traverse.closest_hit_packets(*args, **kw)
            with _patched(cuda_cascade,
                          cascade_stage=cuda_cascade.cascade_stage_plain):
                ok_any = ok_any and bool(torch.equal(
                    occ, traverse.any_hit_packets(*args, **kw)))
                want = traverse.closest_hit_packets(*args, **kw)
            ok_first = ok_first and same((hit.t, hit.tri),
                                         (want.t, want.tri))
        out["cascade_stage_any"] = ok_any
        out["cascade_stage_first"] = ok_first
    torch.cuda.synchronize()
    return out


def phase_cluster_sizes(card):
    """The 96x54 blob scene (subdiv 4 + room, 2 spp, 5 bounces) with base
    accels of S in CLUSTER_SIZES, through the main path (the default
    routing: worklist past 2048 clusters, at S = 2), backend "pallas",
    "worklist" and "kslots" (blocks of 64) and the fused cascades (on
    backend "hybrid", also past 2048 clusters): each
    image bitwise the oracle's (pallas: within 1e-5, its first-candidate tie
    rule), every route at S without a tuned instance (16, 96, 512) through
    some generic instance; and each kernel's generic instance against its
    plain version on a small wave at each S."""
    from path_tracer_ai_tpu_torch.accel.clusters import build_clusters
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import oracle, wavefront
    from path_tracer_ai_tpu_torch.scene.camera import default_camera
    from path_tracer_ai_tpu_torch.scene.scene import blob_scene

    scene = blob_scene(subdivisions=4, device="cuda")
    cam = default_camera("cuda")
    settings = RenderSettings(width=96, height=54, samples_per_pixel=2,
                              max_bounces=5, seed=0)
    t0 = time.perf_counter()
    ref = oracle.render(scene, cam, settings, device="cuda")
    oracle_s = time.perf_counter() - t0
    rng = np.random.default_rng(5)
    rows = []
    for s in CLUSTER_SIZES:
        acc = build_clusters(scene.triangles, cluster_size=s)
        renders = {}
        for route in CLUSTER_ROUTES:
            kw = dict(accel=acc, wave_size=1 << 14, device="cuda")
            if route == "fused":  # the hybrid backend's engines at any C
                kw.update(backend="hybrid")
            elif route != "main":
                kw.update(backend=route, block_size=64)
            _reset_counts()
            t0 = time.perf_counter()
            with _engines(FUSED_ENGINES if route == "fused" else None):
                img = wavefront.render(scene, cam, settings, **kw)
            torch.cuda.synchronize()
            diff = float(np.abs(img - ref).max())
            renders[route] = {
                "seconds": time.perf_counter() - t0,
                "bitwise_equal_to_oracle": bool(np.array_equal(img, ref)),
                "max_abs_diff_vs_oracle": diff,
                "launches": {k: v for k, v in _read_counts().items() if v},
                "generic_launches": {k: v for k, v in
                                     _generic_counts().items() if v}}
        row = {"phase": "cluster_sizes", "card": card, "S": s,
               "clusters": acc.num_clusters,
               "default_backend": wavefront.default_backend(acc),
               "oracle_seconds": oracle_s, "renders": renders,
               "generic_matches_plain": _generic_checks(acc, rng)}
        emit(row)
        for route, r in renders.items():
            if not (r["bitwise_equal_to_oracle"] or (
                    route == "pallas" and r["max_abs_diff_vs_oracle"] <= 1e-5)):
                fail("cluster_sizes", f"S = {s}, {route}: the image differs "
                                      "from the oracle's")
            if s in (16, 96, 512) and not r["generic_launches"]:
                fail("cluster_sizes", f"S = {s}, {route}: no generic launch")
        bad = [k for k, v in row["generic_matches_plain"].items() if not v]
        if bad:
            fail("cluster_sizes", f"S = {s}: the generic instances of {bad} "
                                  "disagree with their plain versions")
        rows.append(row)
    return rows


def phase_consistency():
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import oracle, wavefront
    from path_tracer_ai_tpu_torch.scene.camera import default_camera
    from path_tracer_ai_tpu_torch.scene.scene import blob_scene

    scene = blob_scene(subdivisions=4, device="cuda")
    cam = default_camera("cuda")
    kw = dict(wave_size=1 << 14, device="cuda")

    def paths(settings):
        img_o = oracle.render(scene, cam, settings, device="cuda")
        img_w = wavefront.render(scene, cam, settings, **kw)
        with _engines(FUSED_ENGINES):
            img_f = wavefront.render(scene, cam, settings, **kw)
        img_p = wavefront.render(scene, cam, settings, backend="pallas",
                                 block_size=64, **kw)
        return img_o, img_w, img_f, img_p

    res = {"phase": "consistency"}
    t0 = time.perf_counter()
    for rr in (0, 2):
        settings = RenderSettings(width=96, height=54, samples_per_pixel=4,
                                  max_bounces=5, seed=0, rr_start=rr)
        img_o, img_w, img_f, img_p = paths(settings)
        diff = {"main": float(np.abs(img_w - img_o).max()),
                "fused": float(np.abs(img_f - img_o).max()),
                "pallas": float(np.abs(img_p - img_o).max())}
        res[f"rr{rr}"] = {
            "max_abs_diff_vs_oracle": diff,
            "main_bitwise": bool(np.array_equal(img_w, img_o)),
            "fused_bitwise": bool(np.array_equal(img_f, img_o)),
            "pallas_pixels_differing": int(
                (np.abs(img_p - img_o).max(axis=-1) > 0).sum()),
            "image_mean": float(img_o.mean())}
        if rr == 0:
            img_off, img_oracle = img_w, img_o
        if diff["main"] != 0.0 or diff["fused"] != 0.0:
            res["seconds"] = time.perf_counter() - t0
            emit(res)
            fail("consistency", f"rr_start={rr}: wavefront and oracle "
                                f"differ: {diff}")
        if diff["pallas"] > 1e-5:
            res["seconds"] = time.perf_counter() - t0
            emit(res)
            fail("consistency", f"rr_start={rr}: pallas backend and oracle "
                                f"differ: {diff}")
    # roulette from bounce 5 never fires within 5 bounces
    img_late = wavefront.render(scene, cam, RenderSettings(
        width=96, height=54, samples_per_pixel=4, max_bounces=5, seed=0,
        rr_start=5), **kw)
    res["rr5_bitwise_rr0"] = bool(np.array_equal(img_late, img_off))
    res["rr2_differs_from_rr0"] = not np.array_equal(img_w, img_off)
    res["worklist_route"] = _consistency_worklist(scene, cam, img_oracle, kw)
    res["ctiles_routes"] = _consistency_ctiles(scene, cam, img_oracle, kw)
    res["seconds"] = time.perf_counter() - t0
    emit(res)
    ct = res["ctiles_routes"]
    bad = [k for k, v in ct.items() if isinstance(v, dict)
           and not (v["bitwise"] and v["launches"] > 0)]
    if bad or ct["ctiles_2level_c2"]["two_level_culls"] <= 0:
        fail("consistency", f"ctiles routes against the oracle (bitwise, "
                            f"slot_sweep launched, the 2-level cull on the "
                            f"2,564-cluster accel): {bad} {ct}")
    wl = res["worklist_route"]
    if wl["default_backend"] != "worklist" or not wl["worklist"]["bitwise"]:
        fail("consistency", f"the worklist route: {wl}")
    ex = wl["packets_exact"]
    if not ex["bitwise"] or min(ex["launches"]["item_sweep"],
                                ex["launches"]["cascade_stage_any"]) <= 0:
        fail("consistency", f"the worklist route with packets_exact shadows "
                            f"(bitwise the oracle, item_sweep and the "
                            f"cascade stage kernel launched): {ex}")
    if any(wl[b]["pixels_over_1e-5"] for b in ("pairs", "packets")):
        fail("consistency", f"pairs or packets backend differ from the "
                            f"oracle beyond 1e-5: {wl}")
    if min(wl["worklist"]["launches"]["item_sweep"],
           wl["pairs"]["launches"]["slot_sweep"],
           wl["packets"]["launches"]["cascade_stage_any"],
           wl["packets"]["launches"]["cascade_stage_first"],
           wl["kslots"]["launches"]["kslot_sweep"]) <= 0:
        fail("consistency", f"a backend launched none of its kernels: {wl}")
    if not wl["kslots"]["bitwise"]:
        fail("consistency", f"the kslots backend (2-level cull on the "
                            f"2,564-cluster accel) differs from the oracle: "
                            f"{wl['kslots']}")
    # tests/test_torch_render.py and tests/test_torch_rr.py hold the same
    # pairs on the CPU
    if not res["rr5_bitwise_rr0"]:
        fail("consistency", "rr_start=5 changed the 5-bounce image")
    if not res["rr2_differs_from_rr0"]:
        fail("consistency", "rr_start=2 left the image unchanged")


def _consistency_worklist(scene, cam, img_oracle, kw):
    """The blob subdiv 4 of the consistency phase in clusters of two
    triangles (more than 2048: the default routing picks the worklist
    backend, with its 2-level cull), the pairs, packets and kslots (its
    2-level cull) backends on the
    same accel, and the worklist backend with WORKLIST_OCCLUDE_ENGINE =
    "packets_exact", against the oracle's rr-off image."""
    from path_tracer_ai_tpu_torch.accel.clusters import build_clusters
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import wavefront

    acc = build_clusters(scene.triangles, cluster_size=2)
    settings = RenderSettings(width=96, height=54, samples_per_pixel=4,
                              max_bounces=5, seed=0)
    out = {"clusters": acc.num_clusters, "supers": acc.num_supers,
           "default_backend": wavefront.resolve_backend(acc, 64, False, None)}
    routes = (("worklist", None, None), ("pairs", "pairs", None),
              ("packets", "packets", None),
              ("packets_exact", None,
               {"WORKLIST_OCCLUDE_ENGINE": "packets_exact"}),
              ("kslots", "kslots", None))
    for name, backend, tables in routes:
        _reset_counts()
        with _engines(tables):
            img = wavefront.render(scene, cam, settings, accel=acc,
                                   backend=backend, **kw)
        diff = np.abs(img - img_oracle).max(axis=-1)
        out[name] = {"bitwise": bool(np.array_equal(img, img_oracle)),
                     "max_abs_diff": float(diff.max()),
                     "pixels_differing": int((diff > 0).sum()),
                     "pixels_over_1e-5": int((diff > 1e-5).sum()),
                     "launches": _read_counts(),
                     "tile_sweep_shapes": _tile_shapes()}
    return out


REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                         "data", "jax_reference.npz")
# the dielectric frame: the blob glass, 8 bounces (rr_start 0 only)
REFERENCE_DIELECTRIC = os.path.join(os.path.dirname(REFERENCE),
                                    "jax_reference_dielectric.npz")
# the cornell frame: the JAX cornell configuration's box of axis-aligned
# quads (rr_start 0 only)
REFERENCE_CORNELL = os.path.join(os.path.dirname(REFERENCE),
                                 "jax_reference_cornell.npz")
REFERENCE_RMSE = 1e-3  # over the JAX image's mean: tests/test_torch_render.py


def _reference_cli(ref, settings) -> np.ndarray:
    """cli.main -m gpu on the reference frame: the CLI's scene loader and
    camera hand it the reference's scene and camera, and its image writer
    keeps the linear image it writes."""
    from path_tracer_ai_tpu_torch import cli
    from path_tracer_ai_tpu_torch.io.image import save_image

    kept = {}

    def keep(path, image, gamma):
        kept["image"] = image
        return save_image(path, image, gamma)

    png = os.path.join(tempfile.gettempdir(), "chip_smoke_reference.png")
    argv = ["-m", "gpu", "-w", str(settings.width), "-h",
            str(settings.height), "-s", str(settings.samples_per_pixel),
            "-b", str(settings.max_bounces), "--seed", str(settings.seed),
            "--rr", str(settings.rr_start), "-i", "reference.obj", "-o", png]
    with _patched(cli, build_scene=lambda *a, **k: ref.scene,
                  default_camera=lambda dev: ref.camera, save_image=keep):
        rc = cli.main(argv)
    if rc != 0 or "image" not in kept:
        fail("reference", f"cli.main({argv}) returned {rc}")
    return kept["image"]


def _reference_routes(ref, settings) -> dict:
    """Every route chip_smoke.py renders, as a call that renders the
    reference frame on the card."""
    from path_tracer_ai_tpu_torch.engine import oracle, wavefront
    from path_tracer_ai_tpu_torch.parallel import mesh

    scene, cam = ref.scene, ref.camera
    card0 = torch.device("cuda", 0)

    def wave(engines=None, **kw):
        def run():
            with _engines(engines):
                return wavefront.render(scene, cam, settings, device="cuda",
                                        **kw)
        return run

    return {
        "oracle": lambda: oracle.render(scene, cam, settings, device="cuda"),
        "main": wave(),
        "pallas": wave(backend="pallas", block_size=64),
        "fused": wave(FUSED_ENGINES),
        "pool": wave(scheduler="pool"),
        "mesh_virtual_2x2": lambda: mesh.render_sharded_wavefront(
            scene, cam, settings, mesh.make_mesh(2, 2, devices=[card0] * 4)),
        "tile_devices_8": wave(tile_devices=8),
        "worklist": wave(backend="worklist"),
        "ctiles": wave(backend="ctiles"),
        "perray": wave(backend="perray"),
        "kslots": wave(backend="kslots"),
        "cli": lambda: _reference_cli(ref, settings),
    }


def _bits_differ(a, b) -> int:
    """Elements whose bits differ (NaN payloads count, -0 != 0)."""
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    word = np.dtype(f"u{a.dtype.itemsize}")
    return int((a.view(word) != b.view(word)).sum())


def _lockstep(cpu_ref, card_ref, settings) -> dict:
    """The oracle's frame stepped on the CPU and on the card side by side,
    one wave of every pixel and sample: the first stage whose tensors
    differ (the camera rays and keys, then at each bounce the closest hit
    and the lanes' state after it), with the elements that differ there."""
    from path_tracer_ai_tpu_torch.core import threefry
    from path_tracer_ai_tpu_torch.engine import tracer, wavefront

    w, h, sc = settings.width, settings.height, settings.samples_per_pixel
    steps = []
    for ref in (cpu_ref, card_ref):
        dev = ref.camera.position.device
        ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w),
                                indexing="ij")
        xs, ys = xs.reshape(-1).to(dev), ys.reshape(-1).to(dev)
        o, d, keys, _ = wavefront._wave_gen(
            ref.camera, threefry.key(settings.seed, device=dev), xs, ys, 0,
            w=w, h=h, sc=sc, lanes_padded=w * h * sc,
            aspect=settings.aspect_ratio())
        out = [("camera", {"o": o, "d": d, "keys": keys})]
        closest, occlude = tracer.brute_force_backend(ref.scene)
        beta, rad = torch.ones_like(o), torch.zeros_like(o)
        alive = torch.ones(o.shape[0], dtype=torch.bool, device=dev)
        for depth in range(settings.max_bounces):
            hits = {}

            def logged(o_, d_, t_min, t_max, hits=hits):
                hit = closest(o_, d_, t_min, t_max)
                hits.update(t=hit.t, tri=hit.tri)
                return hit

            o, d, beta, rad, alive, _, _ = tracer.bounce_step(
                ref.scene, logged, occlude, o, d, beta, rad, alive, keys,
                depth, rr_start=settings.rr_start)
            out += [(f"bounce {depth} closest hit", hits),
                    (f"bounce {depth} lanes", {"o": o, "d": d, "beta": beta,
                                               "radiance": rad,
                                               "alive": alive})]
        steps.append(out)
    for (stage, a), (_, b) in zip(*steps):
        bad = {k: _bits_differ(a[k].cpu().numpy(), b[k].cpu().numpy())
               for k in a}
        bad = {k: n for k, n in bad.items() if n}
        if bad:
            return {"stage": stage, "elements_differing": bad}
    return {"stage": None}


def _reference_frame(path, card) -> tuple:
    """One reference file's frames through every route on the card:
    (the phase's line, the routes over the RMSE bound, the routes not
    bitwise their CPU image)."""
    from path_tracer_ai_tpu_torch.convert import load_reference

    t0 = time.perf_counter()
    ref = load_reference(path, device="cuda")
    first = next(iter(ref.settings.values()))
    res = {"phase": "reference", "card": card, "file": path,
           "jax_version": ref.jax_version,
           "settings": {"width": first.width, "height": first.height,
                        "spp": first.samples_per_pixel,
                        "bounces": first.max_bounces, "seed": first.seed,
                        "rr_starts": sorted(ref.settings),
                        "subdivisions": ref.subdivisions,
                        "triangles": ref.scene.triangles.count},
           "rmse_bound": REFERENCE_RMSE}
    over, not_bitwise = [], []
    for rr, settings in ref.settings.items():
        jax_img = ref.images[f"jax_oracle_rr{rr}"]
        routes = {}
        for name, run in _reference_routes(ref, settings).items():
            _reset_counts()
            img = run()
            launches = {k: v for k, v in _read_counts().items() if v}
            cpu_img = ref.images[
                f"port_{'oracle' if name == 'oracle' else 'main'}_rr{rr}"]
            diff = np.abs(img - cpu_img).max(axis=-1)
            ratio = float(np.sqrt(np.mean((img - jax_img) ** 2))
                          / jax_img.mean())
            routes[name] = {
                "bitwise_cpu": _bits_differ(img, cpu_img) == 0,
                "pixels_differing_cpu": int((diff > 0).sum()),
                "max_abs_diff_cpu": float(diff.max()),
                "rmse_over_mean_vs_jax_oracle": ratio,
                "launches": launches}
            if not ratio <= REFERENCE_RMSE:
                over.append(f"{os.path.basename(path)} rr{rr} {name}: "
                            f"{ratio}")
            if not routes[name]["bitwise_cpu"]:
                not_bitwise.append((rr, name))
        routes["jax_wavefront"] = {"rmse_over_mean_vs_jax_oracle": float(
            np.sqrt(np.mean((ref.images[f"jax_wavefront_rr{rr}"] - jax_img)
                            ** 2)) / jax_img.mean())}
        res[f"rr{rr}"] = routes
    if not_bitwise:
        rr = not_bitwise[0][0]
        res["first_difference"] = _lockstep(
            load_reference(path, device="cpu"), ref, ref.settings[rr])
    res["seconds"] = time.perf_counter() - t0
    return res, over, [f"{os.path.basename(path)} rr{rr} {name}"
                       for rr, name in not_bitwise]


def phase_reference(card, render, profile):
    """The JAX package's renders (tests/data/jax_reference.npz, the
    dielectric frame's jax_reference_dielectric.npz and the cornell frame's
    jax_reference_cornell.npz, made by scripts/torch_make_reference.py;
    read without JAX) against every
    route on the card, at each of a file's settings (one line each):
    bitwise against the port's CPU image of the same engine (the oracle's
    for the oracle, the main path's for the rest), the pixels that differ
    from it, and the RMSE against JAX's oracle image over that image's
    mean, which must stay within 1e-3; a route not bitwise fails (the line
    then names the first stage of a CPU / card lockstep of the oracle
    whose tensors differ). Also the main path's bench render against the
    215,680 kernels and 6,744 host syncs it took at commit 524103f (none
    gained)."""
    over, not_bitwise, lines = [], [], []
    for path in (REFERENCE, REFERENCE_DIELECTRIC, REFERENCE_CORNELL):
        res, o, nb = _reference_frame(path, card)
        over += o
        not_bitwise += nb
        lines.append(res)
    res["bench_render"] = {
        "device_kernels": profile["device_kernels"],
        "host_syncs": render["host_syncs"],
        "at_524103f": {"device_kernels": BENCH_KERNELS_MAX,
                       "host_syncs": BENCH_SYNCS_MAX}}
    for line in lines:
        emit(line)
    if over:
        fail("reference", f"over RMSE {REFERENCE_RMSE} x the mean of JAX's "
                          f"oracle image: {over}")
    if not_bitwise:
        fail("reference", f"not bitwise the port's CPU image: {not_bitwise}; "
                          "first difference " + str(
                              {ln["file"]: ln["first_difference"]
                               for ln in lines if "first_difference" in ln}))
    if (profile["device_kernels"] > BENCH_KERNELS_MAX
            or render["host_syncs"] > BENCH_SYNCS_MAX):
        fail("reference", f"the main path's bench render gained kernels or "
                          f"host syncs: {res['bench_render']}")


class _LogRecords(logging.Handler):
    """The port's log records of a block, at INFO (the CLI reports its
    audit, times and parser through logging)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []
        self.logger = logging.getLogger("path_tracer_ai_tpu_torch")

    def emit(self, record):
        self.records.append(record)

    def __enter__(self):
        self.level = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)
        self.logger.setLevel(self.level)

    def args(self, msg: str) -> list:
        """The arguments of every record logged with format `msg`."""
        return [r.args for r in self.records if r.msg == msg]


CLI_BENCH = ["-m", "gpu", "-w", str(BENCH["width"]), "-h",
             str(BENCH["height"]), "-s", str(BENCH["samples_per_pixel"]),
             "-b", str(BENCH["max_bounces"]), "--seed", str(BENCH["seed"])]


def _cli_run(argv, png):
    """cli.main(argv + -o png) -> (seconds, its log records); fails unless
    it returns 0 and the PNG it wrote holds no magenta pixel."""
    from path_tracer_ai_tpu_torch import cli
    from path_tracer_ai_tpu_torch.io.png import read_png

    with _LogRecords() as logs:
        t0 = time.perf_counter()
        rc = cli.main(argv + ["-o", png])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    if rc != 0:
        fail("cli", f"cli.main({' '.join(argv)}) returned {rc}")
    img = read_png(png)
    if np.all(img == np.asarray([255, 0, 255], np.uint8), axis=-1).any():
        fail("cli", f"magenta pixels in {png}")
    return seconds, logs


def _render_seconds(logs) -> float:
    return float(logs.args("Rendering completed in %.3f seconds")[-1][0])


def phase_cli(card):
    """The CLI on an OBJ scene at the bench render's size (see the module
    docstring, phase 6)."""
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import wavefront
    from path_tracer_ai_tpu_torch.engine.oracle import finish_image
    from path_tracer_ai_tpu_torch.io import checkpoint as ckpt
    from path_tracer_ai_tpu_torch.io.png import read_png
    from path_tracer_ai_tpu_torch.scene.camera import default_camera
    from path_tracer_ai_tpu_torch.scene.procgen import write_blob_obj
    from path_tracer_ai_tpu_torch.scene.scene import build_scene
    from path_tracer_ai_tpu_torch.utils import sync

    res = {"phase": "cli", "card": card}
    with tempfile.TemporaryDirectory() as tmp:
        obj = os.path.join(tmp, "blob.obj")
        t0 = time.perf_counter()
        res["obj_faces"] = write_blob_obj(obj, subdivisions=6)
        res["write_seconds"] = time.perf_counter() - t0

        with _LogRecords() as logs:
            t0 = time.perf_counter()
            scene = build_scene(obj, device="cuda")
            torch.cuda.synchronize()
            res["load_seconds"] = time.perf_counter() - t0
        res["parser"] = logs.args("Parsed %s with the %s parser")[0][1]
        res["triangles"] = scene.triangles.count
        res["materials"] = scene.materials.count
        print(f"cli: {res['parser']} parser, {res['load_seconds']:.3f} s, "
              f"{res['triangles']} triangles", flush=True)
        if res["triangles"] != 81928:
            emit(res)
            fail("cli", f"the OBJ scene has {res['triangles']} triangles, "
                        "not 81,928")

        ck_a = os.path.join(tmp, "a.npz")
        argv = CLI_BENCH + ["-i", obj, "--validate", "--checkpoint", ck_a]
        png = os.path.join(tmp, "a.png")
        res["warm_seconds"], _ = _cli_run(argv, png)
        os.remove(ck_a)  # else the timed run resumes from a finished render
        _reset_counts()
        res["seconds"], logs = _cli_run(argv, png)
        res["launches"] = _read_counts()
        res["host_syncs"] = sync.count
        res["render_seconds"] = _render_seconds(logs)
        audit = logs.args("Image audit: %s")[0][0]
        res["audit"] = audit._asdict()
        img_cli = finish_image(*ckpt.load(ck_a, ckpt.peek_fingerprint(ck_a))[:2],
                               BENCH["width"], BENCH["height"])
        print(f"cli: 1080p timed run {res['seconds']:.3f} s, launches "
              f"{res['launches']}", flush=True)
        if min(res["launches"][k] for k in ("slot_sweep", "block_cull")) <= 0:
            emit(res)
            fail("cli", "the CLI render launched no slot_sweep or block_cull "
                        "kernel")
        if not (audit.finite and audit.n_nan == 0 and audit.n_inf == 0
                and audit.n_magenta == 0):
            emit(res)
            fail("cli", f"image audit: {audit}")

        _reset_counts()
        sec, logs = _cli_run(CLI_BENCH + ["-i", obj, "--backend", "pallas"],
                             os.path.join(tmp, "p.png"))
        res["pallas"] = {"seconds": sec, "render_seconds": _render_seconds(logs),
                         "launches": _read_counts()}
        if min(res["pallas"]["launches"][k]
               for k in ("closest_sweep", "anyhit_sweep")) <= 0:
            emit(res)
            fail("cli", "--backend pallas launched no closest_sweep or "
                        "anyhit_sweep kernel")

        sec, logs = _cli_run(CLI_BENCH + ["-i", obj, "--rr", "2",
                                          "--validate"],
                             os.path.join(tmp, "rr.png"))
        audit = logs.args("Image audit: %s")[0][0]
        res["rr2"] = {"seconds": sec, "render_seconds": _render_seconds(logs),
                      "audit": audit._asdict()}
        if not (audit.finite and audit.n_magenta == 0):
            emit(res)
            fail("cli", f"--rr 2 image audit: {audit}")
        cam = default_camera("cuda")
        rays = {}
        for rr in (0, 2):
            stats = wavefront.RenderStats()
            img = wavefront.render(scene, cam, RenderSettings(
                **BENCH, rr_start=rr), stats=stats, device="cuda")
            rays[rr] = stats
            if rr == 0:
                img_full = img
        res["rr0"] = {}
        for rr, st in rays.items():
            res[f"rr{rr}"].update(closest_rays=st.closest_rays,
                                  shadow_rays=st.shadow_rays,
                                  api_render_seconds=st.seconds)
        res["cli_image_equals_api_image"] = bool(np.array_equal(img_cli,
                                                                img_full))
        print(f"cli: --rr 2 {res['rr2']['seconds']:.3f} s, live rays "
              f"{rays[2].total_rays} against {rays[0].total_rays}", flush=True)
        if rays[2].total_rays >= rays[0].total_rays:
            emit(res)
            fail("cli", "--rr 2 traced no fewer rays than --rr 0")
        if not res["cli_image_equals_api_image"]:
            emit(res)
            fail("cli", "the CLI's image differs from wavefront.render's")

        # stop after 1 of 2 samples, restamp under the 2-spp fingerprint
        # (tests/test_wavefront.py:162-173), resume
        ck_b = os.path.join(tmp, "b.npz")
        full = RenderSettings(**BENCH)
        half = full.replace(samples_per_pixel=1)
        n_tri = scene.triangles.count
        wavefront.render(scene, cam, half, checkpoint_path=ck_b, device="cuda")
        acc, cnt, nxt = ckpt.load(ck_b, ckpt.fingerprint(half, n_tri,
                                                          BENCH["seed"]))
        ckpt.save(ck_b, acc, cnt, nxt,
                  ckpt.fingerprint(full, n_tri, BENCH["seed"]))
        resumed_stats = wavefront.RenderStats()
        img_resumed = wavefront.render(scene, cam, full, checkpoint_path=ck_b,
                                       stats=resumed_stats, device="cuda")
        res["resume"] = {
            "next_sample": nxt,
            "resumed_closest_rays": resumed_stats.closest_rays,
            "bitwise_equal_to_uninterrupted": bool(
                np.array_equal(img_resumed, img_full))}
        if not res["resume"]["bitwise_equal_to_uninterrupted"]:
            emit(res)
            fail("cli", "the resumed render differs from the uninterrupted one")

        small = os.path.join(tmp, "small.obj")
        write_blob_obj(small, subdivisions=4)
        common = ["-w", "96", "-h", "54", "-s", "2", "-b", "3", "-i", small]
        pngs = {}
        for mode in ("cpu", "gpu"):
            pngs[mode] = os.path.join(tmp, f"mode_{mode}.png")
            res[f"mode_{mode}_seconds"], _ = _cli_run(["-m", mode] + common,
                                                      pngs[mode])
        res["modes_equal"] = bool(np.array_equal(read_png(pngs["cpu"]),
                                                 read_png(pngs["gpu"])))

        # the worklist backend by flag, on the 81,928-triangle OBJ
        common6 = ["-w", "96", "-h", "54", "-s", "2", "-b", "3", "-i", obj]
        png_w = os.path.join(tmp, "worklist.png")
        png_c = os.path.join(tmp, "worklist_cpu.png")
        _reset_counts()
        sec, _ = _cli_run(["-m", "gpu", "--backend", "worklist"] + common6,
                          png_w)
        res["worklist"] = {"seconds": sec, "launches": _read_counts()}
        res["worklist"]["cpu_mode_seconds"], _ = _cli_run(
            ["-m", "cpu"] + common6, png_c)
        res["worklist"]["equals_cpu_mode"] = bool(np.array_equal(
            read_png(png_w), read_png(png_c)))
        # the kslots backend by flag, against the same -m cpu PNG
        png_k = os.path.join(tmp, "kslots.png")
        _reset_counts()
        sec, _ = _cli_run(["-m", "gpu", "--backend", "kslots"] + common6,
                          png_k)
        res["kslots"] = {"seconds": sec, "launches": _read_counts(),
                         "equals_cpu_mode": bool(np.array_equal(
                             read_png(png_k), read_png(png_c)))}
        # the perray backend by flag (the packet cascade's tie rule: the
        # PNG may differ from the -m cpu one where a path meets an exact
        # tie; recorded, not required)
        png_p = os.path.join(tmp, "perray.png")
        _reset_counts()
        sec, _ = _cli_run(["-m", "gpu", "--backend", "perray"] + common6,
                          png_p)
        res["perray"] = {"seconds": sec, "launches": _read_counts(),
                         "equals_cpu_mode": bool(np.array_equal(
                             read_png(png_p), read_png(png_c)))}
    emit(res)
    if not res["modes_equal"]:
        fail("cli", "-m cpu and -m gpu wrote different PNGs")
    if not res["worklist"]["equals_cpu_mode"]:
        fail("cli", "--backend worklist and -m cpu wrote different PNGs")
    if res["worklist"]["launches"]["item_sweep"] <= 0:
        fail("cli", "--backend worklist launched no item_sweep kernel")
    if not res["kslots"]["equals_cpu_mode"]:
        fail("cli", "--backend kslots and -m cpu wrote different PNGs")
    if res["kslots"]["launches"]["kslot_sweep"] <= 0:
        fail("cli", "--backend kslots launched no kslot_sweep kernel")
    if min(res["perray"]["launches"][k]
           for k in ("perray_stage_any", "perray_stage_first")) <= 0:
        fail("cli", "--backend perray launched no perray stage kernel")
    return res


def phase_bench(card):
    """`python -m path_tracer_ai_tpu_torch.bench --quick` in a child
    process: its stdout must be exactly one JSON line with a value > 0."""
    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "path_tracer_ai_tpu_torch.bench", "--quick"],
        cwd=repo, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=repo))
    lines = out.stdout.strip().splitlines()
    res = {"phase": "bench", "card": card, "rc": out.returncode,
           "seconds": time.perf_counter() - t0, "stdout_lines": len(lines),
           "stderr_tail": out.stderr[-600:]}
    try:
        res["result"] = json.loads(lines[0]) if len(lines) == 1 else None
    except json.JSONDecodeError:
        res["result"] = None
    emit(res)
    if (out.returncode != 0 or res["result"] is None
            or not res["result"].get("value", 0) > 0):
        fail("bench", "the bench did not print one JSON line with a value > 0")
    return res


# --- the worklist path (scenes past 2048 clusters) ---------------------------

WORKLIST_SUBDIV = 7
# blob subdiv 7 + room; clusters of 128; supers of 16
WORKLIST_SCENE = {"triangles": 327688, "clusters": 2561, "supers": 161}


def worklist_scene():
    from path_tracer_ai_tpu_torch.accel.clusters import build_clusters
    from path_tracer_ai_tpu_torch.scene.scene import blob_scene

    t0 = time.perf_counter()
    scene = blob_scene(subdivisions=WORKLIST_SUBDIV, device="cuda")
    accel = build_clusters(scene.triangles, cluster_size=128)
    torch.cuda.synchronize()
    got = {"triangles": scene.triangles.count,
           "clusters": accel.num_clusters, "supers": accel.num_supers}
    emit({"phase": "worklist_scene", **got,
          "seconds": time.perf_counter() - t0})
    if got != WORKLIST_SCENE:
        fail("worklist_scene", f"{got}, expected {WORKLIST_SCENE}")
    return scene, accel


def _item_bound(args) -> tuple:
    """(bytes, needed tests) of one item_sweep call: the live slots'
    cluster packs, the rays of the blocks that own items, the item tables
    read and the rows written; the tests of live item x live lane (t_max >=
    t_min) x live slot x S."""
    pack, rays, item_block, ibase, order_g, n_cand, n_items, want_tri = args
    n_items = int(n_items)  # an int or the worklist's device count
    s = pack.shape[2]
    n_groups, g = order_g.shape[1:]
    b = rays.shape[2]
    j = torch.arange(n_items, device=rays.device)
    blk = item_block[:n_items].long()
    k = torch.clamp(j - ibase[blk].long(), 0, n_groups - 1)
    live_slot = (k[:, None] * g + torch.arange(g, device=rays.device)
                 < n_cand[blk][:, None])
    live_lane = rays[blk, 6] >= rays[blk, 7]
    tests = int((live_slot.sum(1) * live_lane.sum(1)).sum()) * s
    used = int(torch.unique(order_g[blk, k][live_slot]).numel())
    owners = int(torch.unique(blk).numel())
    nbytes = (used * 10 * s * 4 + owners * 8 * b * 4 + n_items * (4 + g * 4)
              + _nbytes(ibase, n_cand) + n_items * b * (8 if want_tri else 1))
    return nbytes, tests


def _check_item_sweep(args, wave: str, reps: int = 5) -> dict:
    from path_tracer_ai_tpu_torch.accel import cuda_ctiles, cuda_items

    want_tri = args[-1]
    n_items = int(args[6])  # the worklist passes its device count
    k = cuda_items.item_sweep(*args)
    p = cuda_items.item_sweep_plain(*args)
    torch.cuda.synchronize()
    if want_tri:
        ok = _bits_equal(k[0], p[0]) and bool(torch.equal(k[1], p[1]))
        err = _max_abs_err(k[0], p[0])
        hits = int((k[1] != cuda_ctiles.I32_MAX).sum())
    else:
        ok = bool(torch.equal(k[0], p[0]))
        err = float((k[0] != p[0]).sum())  # rows x lanes that differ
        hits = int(k[0].sum())
    ms = cuda_ms(lambda: cuda_items.item_sweep(*args), reps)
    plain_ms = cuda_ms(lambda: cuda_items.item_sweep_plain(*args), 1)
    nbytes, tests = _item_bound(args)
    s = args[0].shape[2]
    swept = n_items * args[1].shape[2] * args[4].shape[2] * s
    res = {"phase": "item_waves", "name": "item_sweep", "wave": wave,
           "blocks": args[1].shape[0], "i_cap": args[2].shape[0],
           "n_items": n_items, "S": s, "matches_plain": ok,
           "max_abs_err": err, "hit_lanes": hits, "ms": ms,
           "plain_ms": plain_ms, "swept_tests": swept,
           "gtests_per_s": swept / ms / 1e6, **_bound(nbytes, tests),
           **_instance_facts("item_sweep", s, want_tri),
           **_earlier("item_sweep", wave, ms)}
    res["ms_over_bound"] = ms / res["bound_ms"]
    emit(res)
    if not ok:
        fail("item_waves", f"item_sweep disagrees with its plain version on "
                           f"the {wave} wave")
    if hits == 0:
        fail("item_waves", f"the {wave} wave hit nothing")
    return res


def _keeping(mod, name, kept, key, limit=2):
    """Replaces mod.name by a wrapper that keeps (a copy of) the arguments
    of its first `limit` calls under kept[key(args)]; returns the original."""
    real = getattr(mod, name)

    def keep(*args, **kw):
        calls = kept.setdefault(key(args), [])
        if len(calls) < limit:
            calls.append((tuple(a.clone() if torch.is_tensor(a) else a
                                for a in args), dict(kw)))
        return real(*args, **kw)

    setattr(mod, name, keep)
    return real


class _Kept(Exception):
    """A render's kept launches are all in: it need not go on."""


def phase_item_waves(scene, accel, card):
    """The worklist scene's bench render once (the default routing, which
    must be the worklist backend), keeping the inputs of item_sweep's
    second closest and second shadow launch (wave 0, bounce 1), then
    item_sweep against its plain version on each. Also keeps the same two
    waves' worklist queries for profile_worklist, and the first two
    worklist_cull calls of each wave type (KEPT_CULLS). Returns the two checks,
    the kept queries and the render's seconds (the warm pass of
    path_worklist)."""
    import inspect

    from path_tracer_ai_tpu_torch.accel import (
        cuda_cull,
        cuda_items,
        traverse,
        worklist,
    )
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import wavefront
    from path_tracer_ai_tpu_torch.scene.camera import default_camera

    backend = wavefront.resolve_backend(accel, 64, False, None)
    if backend != "worklist":
        fail("item_waves", f"default routing picked {backend!r}")
    kept = {}
    # the worklist_cull calls, told apart by their cap (the closest waves'
    # WORKLIST_CLOSEST_KW cap, the shadow waves' default)
    caps = {wavefront.WORKLIST_CLOSEST_KW["cap"]: "cull_closest",
            inspect.signature(worklist.any_hit_worklist).parameters[
                "cap"].default: "cull_shadow"}
    if len(caps) != 2:
        fail("item_waves", "the closest and shadow waves cull at one cap")
    wrapped = [(cuda_items, "item_sweep", lambda a: a[-1]),
               (cuda_cull, "worklist_cull", lambda a: caps[a[4]]),
               (worklist, "closest_hit_worklist", lambda a: "closest_wave"),
               (worklist, "any_hit_worklist", lambda a: "shadow_wave"),
               # the closest fallback's whole-wave cascades (packet_cascade)
               (traverse, "closest_hit_packets", lambda a: "fallback")]
    reals = [(mod, name, _keeping(mod, name, kept, key))
             for mod, name, key in wrapped]
    try:
        t0 = time.perf_counter()
        wavefront.render(scene, default_camera("cuda"),
                         RenderSettings(**BENCH), accel=accel,
                         wave_size=1 << 20, block_size=64, device="cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        for mod, name, real in reals:
            setattr(mod, name, real)
    if min(len(kept.get(k, ())) for k in (True, False, "closest_wave",
                                           "shadow_wave")) < 2:
        fail("item_waves", "the render made fewer than two item_sweep "
                           "launches or worklist queries of a wave type")
    KEPT_FALLBACKS["worklist"] = kept.get("fallback", [])
    for wave in ("closest", "shadow"):
        KEPT_CULLS[wave] = kept.get(f"cull_{wave}", [])
    checks = [_check_item_sweep(kept[True][1][0], "closest, wave 0, bounce 1"),
              _check_item_sweep(kept[False][1][0],
                                "shadow, wave 0, bounce 1")]
    waves = {k: kept[k][1] for k in ("closest_wave", "shadow_wave")}
    return checks, waves, seconds, [kept[True][1][0], kept[False][1][0]]


# the worklist_cull calls of the item_waves render: wave type -> [(args,
# kw)] of its first two calls (bounce 0, bounce 1)
KEPT_CULLS = {}
# f32 operations of the worklist cull (csrc/worklist_cull.cu): 14 a (block,
# box) pair and axis whose direction interval does not span 0 (2
# subtractions, 4 divisions, 6 min / max for the quotients' bounds, 2 for
# lb and ub), 3 a pair (the candidate test's compares); the boxes counted
# are those a block must test: every box (super) up to the one past its cap
# where it overflows, and at levels 2 the children of its candidate supers
# up to the one past cap
WCULL_AXIS_OPS = 14
WCULL_PAIR_OPS = 3
WCULL_REPS = 20
WCULL_ROW_ELEMS = 1 << 22  # [rows, boxes] elements a step of _wcull_work


def _first_past(cand, k):
    """Per row, the boxes tested up to the (k + 1)-th candidate (all where
    there are k or fewer)."""
    past = torch.cumsum(cand.to(torch.int32), dim=1) > k
    return torch.where(past.any(dim=1), past.to(torch.int32).argmax(dim=1)
                       + 1, cand.shape[1])


def _wcull_work(call) -> dict:
    """Bytes (the rays once, the boxes, order, n_cand and over) and
    operations (WCULL_*_OPS over the boxes each live block must test) of
    one worklist_cull call (accel, o_blk, d_blk, tm_blk, cap, k_eff, width,
    levels, super_cap)."""
    from path_tracer_ai_tpu_torch.accel import traverse, worklist

    accel, o_blk, d_blk, tm_blk, cap, _k_eff, width, levels, super_cap = call
    nb, b = o_blk.shape[:2]
    c = accel.num_clusters
    cs, ss = accel.num_supers, accel.super_size
    scap = min(super_cap, cs)
    step = max(1, WCULL_ROW_ELEMS // (c if levels == 1 else cs + scap * ss))
    tests = axis_tests = 0
    for lo in range(0, nb, step):
        o, d, tm = (x[lo:lo + step] for x in (o_blk, d_blk, tm_blk))
        rows = o.shape[0]
        olo, ohi, dlo, dhi = traverse._ray_block_bounds(o, d, live=tm >= 0.0)
        bnd = (olo, ohi, dlo, dhi)
        tmax = tm.amax(dim=1)
        live = tmax >= 0.0
        axes = (~((dlo <= 0.0) & (dhi >= 0.0))).sum(dim=1)

        def cand_of(lo_, hi_):
            lb, ub = traverse._interval_slab(lo_, hi_, *bnd)
            return ((lb <= ub) & (ub >= 0.0) & (lb <= tmax[:, None])
                    & live[:, None])

        if levels == 1:
            n_t = _first_past(cand_of(accel.bmin, accel.bmax), cap)
        else:
            cand_s = cand_of(accel.sbmin, accel.sbmax)
            ns = cand_s.sum(dim=1)
            over_s = ns > scap
            sorder = worklist._extract_k(cand_s & ~over_s[:, None], scap,
                                         cs - 1).long()
            slot_ok = (torch.arange(scap, device=o.device)[None, :]
                       < ns[:, None]).repeat_interleave(ss, dim=1)
            cand = cand_of(accel.cbmin[sorder].reshape(rows, scap * ss, 3),
                           accel.cbmax[sorder].reshape(rows, scap * ss, 3))
            child = torch.minimum(_first_past(cand & slot_ok, cap), ns * ss)
            n_t = _first_past(cand_s, scap) + torch.where(over_s, 0, child)
        n_t = torch.where(live, n_t, 0).long()
        tests += int(n_t.sum())
        axis_tests += int((n_t * axes).sum())
    ops = tests * WCULL_PAIR_OPS + axis_tests * WCULL_AXIS_OPS
    boxes = c * 24 if levels == 1 else cs * 24 + cs * ss * 24
    nbytes = nb * b * 28 + boxes + nb * width * 4 + nb * 4 + nb
    by_bytes = nbytes / PEAK_BYTES_PER_S
    by_ops = ops / PEAK_F32_PER_S
    return {"bytes": nbytes, "operations": ops, "box_tests": tests,
            "box_tests_per_live_block": tests / max(1, int(
                (tm_blk.amax(dim=1) >= 0.0).sum())),
            "bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _wcull_call(call, levels=None):
    """A kept worklist_cull call's positional arguments, at its own levels
    or forced to `levels` (k_eff and the row width then as _build_worklist
    gives them)."""
    from path_tracer_ai_tpu_torch.accel import cuda_items

    accel, o, d, tm, cap, k_eff, width, lv, super_cap = call
    if levels is not None and levels != lv:
        k_eff = min(cap, accel.num_clusters)
        if levels == 2:
            k_eff = min(k_eff, min(super_cap, accel.num_supers)
                        * accel.super_size)
        g = cuda_items.GROUP
        width, lv = -(-k_eff // g) * g, levels
    return (accel, o, d, tm, cap, k_eff, width, lv, super_cap)


def _check_wcull(label, call, plain_on_cpu=False, reps=WCULL_REPS,
                 bound=True) -> dict:
    """worklist_cull on one call: against its plain version (on the card,
    or on CPU copies of the inputs), timed beside its bound and the plain
    version on the card."""
    from types import SimpleNamespace

    from path_tracer_ai_tpu_torch.accel import cuda_cull

    run = lambda: cuda_cull.worklist_cull(*call)
    plain = lambda: cuda_cull.worklist_cull_plain(*call)
    got = run()
    if plain_on_cpu:
        acc = call[0]
        cpu = SimpleNamespace(**{k: getattr(acc, k).cpu() for k in (
            "bmin", "bmax", "sbmin", "sbmax", "cbmin", "cbmax")},
            num_clusters=acc.num_clusters, num_supers=acc.num_supers,
            super_size=acc.super_size)
        want = cuda_cull.worklist_cull_plain(
            cpu, *(x.cpu() for x in call[1:4]), *call[4:])
    else:
        want = plain()
    torch.cuda.synchronize()
    accel, o_blk = call[:2]
    res = {"input": label, "levels": call[7], "blocks": o_blk.shape[0],
           "B": o_blk.shape[1], "C": accel.num_clusters,
           "supers": accel.num_supers, "cap": call[4], "k_eff": call[5],
           "super_cap": call[8],
           "plain_on": "cpu" if plain_on_cpu else "card",
           "candidates_mean": float(got[1].float().mean()),
           "overflow_share": float(got[2].float().mean()),
           "matches_plain": all(bool(torch.equal(a.cpu(), b.cpu()))
                                for a, b in zip(got, want)),
           "max_abs_err": 0.0, "ms": cuda_ms(run, reps),
           "plain_ms": cuda_ms(plain, 1)}
    if bound:
        res.update(_wcull_work(call))
        res["ms_over_bound"] = res["ms"] / res["bound_ms"]
    return res


def phase_worklist_cull(card) -> dict:
    """The worklist's cull on the card: worklist_cull against its plain
    version, bit for bit, on the item_waves render's kept calls (the
    closest and the shadow wave of wave 0, bounce 1: the worklist cell's
    accel, C 2,561 in 161 supers, the 2-level cull), on the same calls
    forced to levels 1 (the flat cull past 2048 clusters), and on every
    crafted worklist-cull case (tests/test_torch_sweep_cases.py
    wl_cull_case) at its caps and one past each; each render call timed
    beside its bound (_wcull_work) and the plain version on the card.
    Returns the kernels line's check (the shadow call, 2-level)."""
    from types import SimpleNamespace

    t0 = time.perf_counter()
    if min(len(KEPT_CULLS.get(w, ())) for w in ("closest", "shadow")) < 2:
        fail("worklist_cull", "fewer than two kept worklist_cull calls of a "
                              "wave type")
    waves = []
    for levels in (2, 1):
        for wave in ("closest", "shadow"):
            args, _kw = KEPT_CULLS[wave][1]
            waves.append(_check_wcull(
                f"worklist render {wave} call, wave 0, bounce 1"
                + ("" if levels == args[7] else
                   f", forced to levels {levels}"),
                _wcull_call(args, levels)))
    c = _cases()
    t = lambda a: torch.as_tensor(a, device="cuda")
    crafted = []
    for name in c.WL_CULL_CASES:
        case = c.wl_cull_case(name)
        acc = SimpleNamespace(**{k: t(case[k]) for k in (
            "bmin", "bmax", "sbmin", "sbmax", "cbmin", "cbmax")},
            num_clusters=case["bmin"].shape[0],
            num_supers=case["sbmin"].shape[0], super_size=case["ss"])
        for levels in case["levels"]:
            for cap_add, scap_add in ((0, 0), (1, 0), (0, 1)):
                call = _wcull_call(
                    (acc, t(case["o"]), t(case["d"]), t(case["tm"]),
                     case["cap"] + cap_add, 0, 0, 0,
                     case["super_cap"] + scap_add), levels)
                crafted.append(_check_wcull(name, call, plain_on_cpu=True,
                                            reps=3, bound=False))
    res = {"phase": "worklist_cull", "card": card, "waves": waves,
           "crafted": len(crafted),
           "crafted_disagree": [[x["input"], x["levels"], x["cap"],
                                 x["super_cap"]]
                                for x in crafted if not x["matches_plain"]],
           "seconds": time.perf_counter() - t0}
    emit(res)
    if not all(w["matches_plain"] for w in waves) or res["crafted_disagree"]:
        fail("worklist_cull", "worklist_cull disagrees with its plain "
                              "version")
    keys = ("input", "levels", "blocks", "B", "C", "cap", "k_eff", "ms",
            "plain_ms", "bound_ms", "bound_by", "ms_over_bound",
            "candidates_mean", "overflow_share", "matches_plain")
    return {**waves[1], "waves": [{k: w[k] for k in keys} for w in waves]}


def phase_path_worklist(scene, accel, card, warm_seconds):
    """The worklist scene's bench render, timed, the counts zeroed just
    before it and read just after; each worklist stage's device seconds,
    the build split into sort, cull and table; host reads by site. Then
    one more render under torch.profiler (device activity only: about 30 s
    on the H100) for its device kernels and copies."""
    from torch.profiler import ProfilerActivity, profile

    from path_tracer_ai_tpu_torch.accel import pairs, worklist
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import wavefront
    from path_tracer_ai_tpu_torch.scene.camera import default_camera
    from path_tracer_ai_tpu_torch.utils import sync

    cam = default_camera("cuda")
    eager_pairs = EAGER_CALLS["pair_tables_plain"]
    _reset_counts()
    worklist.stage_events = {}
    stats = wavefront.RenderStats()
    try:
        img = wavefront.render(scene, cam, RenderSettings(**BENCH),
                               accel=accel, stats=stats, wave_size=1 << 20,
                               block_size=64, device="cuda")
        launches = _read_counts()
        syncs = sync.count
        sites = _sync_sites()
        stages = worklist.stage_seconds()
    finally:
        worklist.stage_events = None
    res = {"phase": "path_worklist", "card": card,
           "backend": wavefront.resolve_backend(accel, 64, False, None),
           "triangles": scene.triangles.count,
           "clusters": accel.num_clusters, "supers": accel.num_supers,
           "warm": "the item_waves render", "warm_seconds": warm_seconds,
           "seconds": stats.seconds,
           "closest_rays": stats.closest_rays,
           "shadow_rays": stats.shadow_rays,
           "mrays_per_s": stats.mrays_per_s, "launches": launches,
           "tile_sweep_shapes": _tile_shapes(),
           "cascade_stage_shapes": _stage_shapes(), "host_syncs": syncs,
           "worklist_fallback": dict(worklist.fallback_counts),
           "pairs_fallback": dict(pairs.fallback_counts),
           "stage_device_seconds": stages,
           "build_split_seconds": {
               wave: {step: stages.get(f"{wave}_{step}", 0.0)
                      for step in ("build", "sort", "cull", "table")}
               for wave in ("closest", "shadow")},
           "host_sync_sites": sites,
           # the worklist's own reads: the fallback's count, one a query
           "worklist_host_reads": sum(
               n for k, n in sites.items()
               if k.startswith("path_tracer_ai_tpu_torch.accel.worklist:"))}
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wavefront.render(scene, cam, RenderSettings(**BENCH), accel=accel,
                         wave_size=1 << 20, block_size=64, device="cuda")
        torch.cuda.synchronize()
    res["device_kernels"] = int(sum(
        e.count for e in prof.key_averages()
        if str(e.device_type).endswith("CUDA") and not _is_label(e.key)))
    res["profiled_render_wall_seconds"] = time.perf_counter() - t0
    image_ok = _image_verdict(img, res)
    res["eager_pair_calls"] = EAGER_CALLS["pair_tables_plain"] - eager_pairs
    _finish_path(res, [k for k in ("item_sweep", "worklist_cull",
                                   "pair_cull") if launches[k] <= 0],
                 image_ok)
    if res["eager_pair_calls"]:
        fail("path_worklist", "the eager pair tables ran on the card")
    queries = launches["worklist_cull"]
    if res["worklist_host_reads"] != queries or launches["item_sweep"] != \
            queries:
        fail("path_worklist", f"{res['worklist_host_reads']} worklist host "
                              f"reads and {launches['item_sweep']} item "
                              f"sweeps for {queries} worklist queries")
    return res


def phase_profile_worklist(waves, card):
    """The worklist render's two kept queries (wave 0, bounce 1: the closest
    and the shadow wave) under torch.profiler, each after an unprofiled
    timed call: device time by kernel and by worklist stage, and the busy
    share of the unprofiled call. The whole render launches a few million
    kernels, which the profiler cannot take within the script's time (it
    cost about 0.7 ms a kernel on the H100 host of PERF.md); its stages'
    device seconds come from path_worklist's CUDA events instead."""
    from torch.profiler import ProfilerActivity, profile

    from path_tracer_ai_tpu_torch.accel import worklist

    out = {}
    for label, (args, kw) in waves.items():
        fn = (worklist.closest_hit_worklist if label == "closest_wave"
              else worklist.any_hit_worklist)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn(*args, **kw)
            torch.cuda.synchronize()
        avgs = prof.key_averages()
        res = _kernel_time("profile_worklist", avgs,
                           time.perf_counter() - t0, seconds,
                           ["item_sweep_kernel", "tile_sweep_kernel",
                            "worklist_cull_kernel"])
        host = [e for e in avgs if _is_label(e.key)
                and not str(e.device_type).endswith("CUDA")]
        res.update({
            "card": card, "wave": f"{label}, wave 0, bounce 1",
            "rays": int(args[1].shape[0]),
            "range_device_seconds": {e.key: _range_us(e) / 1e6
                                     for e in host},
            "range_profiled_host_seconds": {
                e.key: float(e.cpu_time_total) / 1e6 for e in host}})
        emit(res)
        out[label] = res
    return out


# --- the pool, the mesh, the 4k configuration and the exact cull -------------

# Differing pixels that the tie check traces, at most.
TIE_CHECK_PIXELS = 32


def _route_backends(accel_base, accel_c, route):
    """(bounce-0 backend, later backend) of a route of the bench render:
    "main" (the main path: S=256 closest accel, bounce 0 unsorted), or
    "s128" (the pool's and the mesh's: one hybrid backend on the S=128
    accel, sorted at every bounce)."""
    from path_tracer_ai_tpu_torch.engine import wavefront

    if route == "main":
        kw = dict(backend="hybrid", accel_closest=accel_c, packs={})
        return (wavefront.packet_backend(accel_base, 64, occlude_sort=False,
                                         closest_sort=False, **kw),
                wavefront.packet_backend(accel_base, 64, **kw))
    backend = wavefront.packet_backend(accel_base, 64)
    return backend, backend


def _trace_sample(scene, backends, x, y, s, record, size):
    """One sample of pixel (x, y) of a (width, height) frame through a
    route's backends, alone in a block of 64 lanes (the padding lanes
    replay pixel 0): each bounce's closest (t, tri) of that lane into
    `record`."""
    from path_tracer_ai_tpu_torch.core import threefry
    from path_tracer_ai_tpu_torch.engine import tracer, wavefront
    from path_tracer_ai_tpu_torch.scene.camera import default_camera

    w, h = size
    t = lambda v: torch.tensor([v], dtype=torch.int64, device="cuda")
    o, d, keys, _ = wavefront._wave_gen(
        default_camera("cuda"), threefry.key(BENCH["seed"], device="cuda"),
        t(x), t(y), s, w=w, h=h, sc=1, lanes_padded=64, aspect=16 / 9)
    beta = torch.ones_like(o)
    rad = torch.zeros_like(o)
    alive = torch.ones((64,), dtype=torch.bool, device="cuda")
    for depth in range(BENCH["max_bounces"]):
        closest, occlude = backends[0 if depth == 0 else 1]

        def logged(o_, d_, t_min, t_max, closest=closest):
            hit = closest(o_, d_, t_min, t_max)
            record.append((float(hit.t[0]), int(hit.tri[0]))
                          if bool(alive[0]) else None)
            return hit

        o, d, beta, rad, alive, _, _ = tracer.bounce_step(
            scene, logged, occlude, o, d, beta, rad, alive, keys, depth)


def _tied_on_path(scene, x, y, s, size) -> list:
    """The oracle's path of one sample: at each bounce its closest t and how
    many triangles reach that t exactly (brute force over all of them)."""
    from path_tracer_ai_tpu_torch.core.geometry import moller_trumbore
    from path_tracer_ai_tpu_torch.engine import tracer

    tris = scene.triangles
    base_closest, occlude = tracer.brute_force_backend(scene)
    out = []

    def counted(o_, d_, t_min, t_max):
        hit = base_closest(o_, d_, t_min, t_max)
        if bool(t_max[0] >= 0):
            ts = moller_trumbore(o_[:1], d_[:1], tris.v0, tris.v1, tris.v2,
                                 t_min, t_max[:1]).t[0]
            best = float(hit.t[0])
            out.append({"t": best, "tri": int(hit.tri[0]),
                        "n_at_t": int((ts == best).sum())
                        if np.isfinite(best) else 0})
        return hit

    _trace_sample(scene, ((counted, occlude),) * 2, x, y, s, [], size)
    return out


def _differences(phase, scene, img, img_main, accel_base, accel_c,
                 route="s128") -> dict:
    size = (img.shape[1], img.shape[0])
    """How an image differs from the main path's. Where pixels differ, the
    first TIE_CHECK_PIXELS of them are traced (each sample on both routes
    and through the oracle); `explained` holds only if every one of them
    has, on its oracle path, a bounce whose closest t is reached exactly by
    two or more triangles: the only place where the exact routes may part
    (the packet cascade's first-slot rule against min tri, ROADMAP §3)."""
    diff = np.abs(img - img_main).max(axis=-1)
    ys, xs = np.nonzero(diff > 0)
    out = {"bitwise_equal_to_main": len(xs) == 0,
           "pixels_differing_from_main": int(len(xs)),
           "max_abs_diff_vs_main": float(diff.max())}
    if not len(xs):
        return out
    routes = {"main": _route_backends(accel_base, accel_c, "main"),
              route: _route_backends(accel_base, accel_c, route)}
    traced = []
    for x, y in list(zip(xs.tolist(), ys.tolist()))[:TIE_CHECK_PIXELS]:
        pix = {"pixel": [x, y], "samples": []}
        for s in range(BENCH["samples_per_pixel"]):
            sample = {"sample": s,
                      "oracle": _tied_on_path(scene, x, y, s, size)}
            for name, backends in routes.items():
                sample[name] = []
                _trace_sample(scene, backends, x, y, s, sample[name], size)
            pix["samples"].append(sample)
        pix["tie_on_path"] = any(b["n_at_t"] >= 2 for smp in pix["samples"]
                                 for b in smp["oracle"])
        traced.append(pix)
    out["traced_pixels"] = traced
    out["explained"] = (len(xs) <= TIE_CHECK_PIXELS
                        and all(p["tie_on_path"] for p in traced))
    print(f"{phase}: {len(xs)} pixels differ from the main path; first: "
          f"{json.dumps(traced[:4])}", flush=True)
    return out


def _image_against_main(phase, res, scene, img, img_main, accel_base,
                        accel_c):
    res.update(_differences(phase, scene, img, img_main, accel_base,
                            accel_c))
    if not (res["bitwise_equal_to_main"] or res["explained"]):
        emit(res)
        fail(phase, f"{res['pixels_differing_from_main']} pixels differ from "
                    "the main path's, not all at exact t ties")


def phase_path_pool(scene, accel_base, accel_c, card, img_main):
    """The bench render with scheduler="pool" (a pool of 2^20 lanes a pixel
    chunk, closest waves on the S=128 accel), warm and timed, against the
    main path's image."""
    res, img, missing, image_ok = _bench_render(
        "path_pool", scene, card, ["slot_sweep", "block_cull"],
        warm_small=False,
        accel=accel_base, scheduler="pool")
    _image_against_main("path_pool", res, scene, img, img_main, accel_base,
                        accel_c)
    _finish_path(res, missing, image_ok)
    return res


def _timed_mesh_render(phase, card, render, main_seconds):
    """render(stats) with the counts set to 0 just before it, read just
    after; its wall time also over the main path's render seconds."""
    from path_tracer_ai_tpu_torch.engine import wavefront
    from path_tracer_ai_tpu_torch.utils import sync

    _reset_counts()
    stats = wavefront.RenderStats()
    t0 = time.perf_counter()
    img = render(stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = {"phase": phase, "card": card, "wall_seconds": wall,
           "wall_over_main_path_seconds": wall / main_seconds,
           "seconds": stats.seconds, "closest_rays": stats.closest_rays,
           "shadow_rays": stats.shadow_rays,
           "mrays_per_s": stats.mrays_per_s, "launches": _read_counts(),
           "tile_sweep_shapes": _tile_shapes(),
           "cascade_stage_shapes": _stage_shapes(), "host_syncs": sync.count,
           "host_sync_sites": _sync_sites()}
    return res, img, _image_verdict(img, res)


class _mesh_schedule:
    """The mesh's workers for the duration of a block: "per_card" (as the
    mesh runs them: one worker a card, a process a card where the mesh
    spans two cards or more), "threads" (one worker thread a card),
    "per_shard" (a worker a mesh entry) or "sequential" (every shard on
    one worker, the schedule of the mesh before its workers: shards issued
    one after another)."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        from path_tracer_ai_tpu_torch.parallel import mesh, workers

        self.saved = (mesh._groups, workers.use_processes)
        if self.name == "per_shard":
            mesh._groups = lambda shards: [[i] for i in range(len(shards))]
        elif self.name == "threads":
            workers.use_processes = lambda group_devices: False
        elif self.name == "sequential":
            mesh._groups = lambda shards: [list(range(len(shards)))]

    def __exit__(self, *exc):
        from path_tracer_ai_tpu_torch.parallel import mesh, workers

        mesh._groups, workers.use_processes = self.saved


def _same_counts(res, ref) -> bool:
    """Launches (by kernel and, for tile_sweep, by shape) and host syncs of
    two renders of one image agree exactly."""
    return (res["launches"] == ref["launches"]
            and res["tile_sweep_shapes"] == ref["tile_sweep_shapes"]
            and res["host_syncs"] == ref["host_syncs"])


def _busy_by_card(render) -> dict:
    """render() under torch.profiler, its mesh's worker processes tracing
    their own steps (workers.PROFILE): each card's device kernel seconds
    and its busy share of the profiled wall ("not measured" where no trace
    holds a device kernel)."""
    from torch.profiler import ProfilerActivity, profile

    from path_tracer_ai_tpu_torch.parallel import workers

    workers.device_seconds.clear()
    workers.PROFILE = True
    try:
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            render()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        workers.PROFILE = False
    busy = workers.kernel_seconds(prof)
    for dev, sec in workers.device_seconds.items():
        busy[dev] = busy.get(dev, 0.0) + sec
    if not busy:
        return {"profiled_wall_seconds": wall, "busy": "not measured"}
    return {"profiled_wall_seconds": wall,
            "device_kernel_seconds": dict(sorted(busy.items())),
            "busy_share_of_profiled_wall": {d: v / wall for d, v in
                                            sorted(busy.items())}}


def _mesh_runs(phase, card, scene, accel_base, accel_c, img_main,
               main_seconds, grid, schedules, warm=True):
    """The bench render over `grid` under each schedule of `schedules`
    (warm at 96x54 first, then timed), each held to the main path's image;
    the launches and host syncs of every schedule must equal the first's
    exactly. The first schedule's render is also profiled (busy share a
    card)."""
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.parallel import mesh
    from path_tracer_ai_tpu_torch.scene.camera import default_camera

    settings = RenderSettings(**BENCH)
    cam = default_camera(grid.devices[0][0])
    render = lambda st=None: mesh.render_sharded_wavefront(
        scene, cam, settings, grid, accel=accel_base, stats=st)
    out = {}
    for sched in schedules:
        with _mesh_schedule(sched):
            if warm:
                mesh.render_sharded_wavefront(
                    scene, cam, settings.replace(width=96, height=54), grid,
                    accel=accel_base)
                torch.cuda.synchronize()
            res, img, image_ok = _timed_mesh_render(phase, card, render,
                                                    main_seconds)
        res["schedule"] = sched
        res["route"] = ("render_sharded_wavefront, mesh "
                        f"{tuple(grid.shape.values())} of "
                        f"{[str(d) for row in grid.devices for d in row]}")
        _image_against_main(phase, res, scene, img, img_main, accel_base,
                            accel_c)
        first = out[schedules[0]] if out else res
        res["counts_equal_to_" + schedules[0]] = _same_counts(res, first)
        if sched == schedules[0]:
            with _mesh_schedule(sched):
                prof = _busy_by_card(render)
            # as the profile phases: device time over the UNPROFILED wall
            prof["busy_share_of_timed_pass"] = {
                dev: sec / res["wall_seconds"] for dev, sec in
                prof.get("device_kernel_seconds", {}).items()} or \
                "not measured"
            res["profile"] = prof
        _finish_path(res, [] if res["launches"]["slot_sweep"]
                     else ["slot_sweep"], image_ok)
        if not res["counts_equal_to_" + schedules[0]]:
            fail(phase, f"the {sched} schedule's launches or host syncs "
                        f"differ from the {schedules[0]} schedule's")
        out[sched] = res
    return out


def phase_path_mesh(scene, accel_base, accel_c, card, img_main,
                    main_seconds):
    """The bench render over a virtual (2, 2) mesh on the one card
    (render_sharded_wavefront), through render(tile_devices=8) (a 1x1 mesh
    on one card), and through render_sharded (scheduler "fused", blocks of
    256) at the bench cell if 960x540 predicts under 60 s, else at
    960x540."""
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import wavefront
    from path_tracer_ai_tpu_torch.parallel import mesh
    from path_tracer_ai_tpu_torch.scene.camera import default_camera

    cam = default_camera("cuda")
    settings = RenderSettings(**BENCH)
    card0 = torch.device("cuda", 0)
    out = {}
    # The main path's render time moves by up to 1.4x between calls and
    # over a call; the mesh's ratio is also taken against a main path
    # render made just before it.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wavefront.render(scene, cam, settings, accel=accel_base,
                     accel_closest=accel_c, wave_size=1 << 20, device="cuda")
    torch.cuda.synchronize()
    adjacent = time.perf_counter() - t0
    virtual = mesh.make_mesh(2, 2, devices=[card0] * 4)
    runs = _mesh_runs("path_mesh", card, scene, accel_base, accel_c,
                      img_main, main_seconds, virtual,
                      ["per_card", "per_shard"], warm=False)
    for res in runs.values():
        res["main_path_seconds_just_before"] = adjacent
        res["wall_over_main_path_just_before"] = res["wall_seconds"] / adjacent
    emit({"phase": "path_mesh_ratio", "card": card,
          "main_path_seconds_just_before": adjacent,
          **{f"{k}_wall_over_it": v["wall_over_main_path_just_before"]
             for k, v in runs.items()}})
    out["virtual_2x2"] = runs["per_card"]
    out["virtual_2x2_per_shard"] = runs["per_shard"]

    res, img, image_ok = _timed_mesh_render(
        "path_mesh", card, lambda st: wavefront.render(
            scene, cam, settings, accel=accel_base, tile_devices=8,
            stats=st, device="cuda"), main_seconds)
    res["route"] = (f"render(tile_devices=8): {torch.cuda.device_count()} "
                    "card(s), a 1x1 mesh on one")
    _image_against_main("path_mesh", res, scene, img, img_main, accel_base,
                        accel_c)
    _finish_path(res, [] if res["launches"]["slot_sweep"] else ["slot_sweep"],
                 image_ok)
    out["tile_devices_8"] = res

    one = mesh.make_mesh(1, 1, devices=[card0])
    small = settings.replace(width=960, height=540)
    sharded = lambda s: (lambda st: mesh.render_sharded(
        scene, cam, s, one, accel=accel_base))
    res, img, image_ok = _timed_mesh_render("path_mesh", card, sharded(small),
                                            main_seconds)
    small_wall = res["wall_seconds"]
    predicted = 4 * small_wall
    res["route"] = "render_sharded (fused), blocks of 256, 960x540"
    size = "960x540"
    if predicted < 60.0:
        res, img, image_ok = _timed_mesh_render("path_mesh", card,
                                                sharded(settings),
                                                main_seconds)
        res["route"] = "render_sharded (fused), blocks of 256, bench cell"
        size = "bench cell"
        _image_against_main("path_mesh", res, scene, img, img_main,
                            accel_base, accel_c)
    else:
        ref = wavefront.render(scene, cam, small, accel=accel_base,
                               accel_closest=accel_c, device="cuda")
        res["bitwise_equal_to_main_path_at_960x540"] = bool(
            np.array_equal(img, ref))
        if not res["bitwise_equal_to_main_path_at_960x540"]:
            _image_against_main("path_mesh", res, scene, img, ref,
                                accel_base, accel_c)
    res.update(size=size, wall_seconds_960x540=small_wall,
               predicted_bench_cell_seconds=predicted)
    # its shadow cascade: the stage kernel at blocks of 256
    t256 = [sh for sh in res["cascade_stage_shapes"] if sh["T"] == 256]
    _finish_path(res, [] if t256 else ["cascade_stage_any at T 256"],
                 image_ok)
    out["render_sharded"] = res
    return out


def phase_mesh_cards(scene, accel_base, accel_c, card, img_main,
                     main_seconds):
    """The bench render over a mesh of distinct cards ((2, 2) on four or
    more, (n, 1) on two or three): with the mesh's workers (a process a
    card), with a thread a card, and with every shard on one worker (the
    sequential schedule of the mesh before its workers), whose launches
    and host syncs must all be the same; and, in the same run, over a
    virtual (2, 2) mesh of cuda:0. Each warm (a 96x54 render on its mesh),
    then timed, and each image against the main path's; the first of each
    mesh also under torch.profiler (busy share a card)."""
    from path_tracer_ai_tpu_torch.parallel import mesh

    n = torch.cuda.device_count()
    if n < 2:
        fail("mesh_cards", f"needs two cards or more, has {n}")
    cards = [torch.device("cuda", i) for i in range(min(n, 4))]
    shape = (2, 2) if len(cards) == 4 else (len(cards), 1)
    runs = _mesh_runs("mesh_cards", card, scene, accel_base, accel_c,
                      img_main, main_seconds,
                      mesh.make_mesh(*shape, devices=cards),
                      ["per_card", "threads", "sequential"])
    out = {"cards": runs["per_card"], "cards_threads": runs["threads"],
           "cards_sequential": runs["sequential"]}
    out["virtual_2x2"] = _mesh_runs(
        "mesh_cards", card, scene, accel_base, accel_c, img_main,
        main_seconds, mesh.make_mesh(2, 2, devices=[cards[0]] * 4),
        ["per_card"])["per_card"]
    emit({"phase": "mesh_cards_summary", "card": card, "mesh": shape,
          "main_path_seconds": main_seconds,
          **{f"{k}_wall_over_main_path": v["wall_over_main_path_seconds"]
             for k, v in out.items()},
          "cards_over_sequential": out["cards"]["wall_seconds"]
          / out["cards_sequential"]["wall_seconds"],
          "cards_threads_over_sequential": out["cards_threads"][
              "wall_seconds"] / out["cards_sequential"]["wall_seconds"]})
    return out


def phase_config_4k(card):
    """benchmarks.run_config("4k", scale=1/1024): 3840x2160, 1 spp, 16
    bounces, progressive (a checkpoint a pass) through tile_devices=8;
    then the same call again on its checkpoint, which must do no work and
    return the same image."""
    from path_tracer_ai_tpu_torch import benchmarks
    from path_tracer_ai_tpu_torch.utils import sync

    res = {"phase": "config_4k", "card": card}
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "4k.npz")
        _reset_counts()
        t0 = time.perf_counter()
        img, stats = benchmarks.run_config("4k", scale=1 / 1024,
                                           checkpoint_path=ck, device="cuda")
        res.update(wall_seconds=time.perf_counter() - t0,
                   seconds=stats.seconds, closest_rays=stats.closest_rays,
                   shadow_rays=stats.shadow_rays,
                   mrays_per_s=stats.mrays_per_s, launches=_read_counts(),
                   tile_sweep_shapes=_tile_shapes(), host_syncs=sync.count,
                   shape=list(img.shape))
        _reset_counts()
        t0 = time.perf_counter()
        again, stats2 = benchmarks.run_config("4k", scale=1 / 1024,
                                              checkpoint_path=ck,
                                              device="cuda")
        res["resume"] = {"wall_seconds": time.perf_counter() - t0,
                         "rays": stats2.total_rays,
                         "launches": _read_counts(),
                         "bitwise_equal": bool(np.array_equal(again, img))}
    res["finite"] = bool(np.isfinite(img).all())
    res["magenta_pixels"] = int(np.all(
        img == np.asarray([1.0, 0.0, 1.0], np.float32), axis=-1).sum())
    res["image_mean"] = float(img.mean())
    emit(res)
    if img.shape != (2160, 3840, 3) or not res["finite"] \
            or res["magenta_pixels"]:
        fail("config_4k", "bad 4k image (shape, non-finite or magenta)")
    if res["launches"]["slot_sweep"] <= 0:
        fail("config_4k", "the 4k render launched no slot_sweep kernel")
    r = res["resume"]
    if r["rays"] or any(r["launches"].values()) or not r["bitwise_equal"]:
        fail("config_4k", f"the resume from a finished checkpoint: {r}")
    return res


def _event_ms(fn) -> float:
    """Device ms of one call (CUDA events around it, host waits included)
    after a warm call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _candidates(values) -> dict:
    v = values.double()
    return {"mean": float(v.mean()), "p99": float(torch.quantile(v, 0.99)),
            "max": int(values.max())}


def _shadow_wave_culls(args, kw, ksup) -> dict:
    """Candidates per live block of a kept any_hit_packets wave under the
    conservative and the exact cull (sorted as the cascade sorts it), and
    the wave's device ms under each."""
    from path_tracer_ai_tpu_torch.accel import traverse

    accel, o, d, t_min, t_max = args
    b = kw.get("block_size", 256)
    os_, ds, ts, _ = traverse._sort_rays(accel, o, d, t_max, "dir")
    blk = (os_.reshape(-1, b, 3), ds.reshape(-1, b, 3), ts.reshape(-1, b))
    live = traverse.live_block_count(blk[2])
    _, n_cons, _ = traverse._block_candidates(accel, *blk)
    _, n_ex, _ = traverse._exact_block_candidates(accel, *blk, t_min,
                                                  ksup=ksup, live_blocks=live)
    base = {k: v for k, v in kw.items() if k != "exact_cull"}
    occ_c = traverse.any_hit_packets(*args, **base)
    occ_e = traverse.any_hit_packets(*args, **base, exact_cull=ksup)
    return {"rays": int(o.shape[0]), "blocks": blk[2].shape[0],
            "live_blocks": live,
            "conservative": _candidates(n_cons[:live]),
            "exact": _candidates(n_ex[:live]),
            # blocks past the super shortlist keep the conservative list
            "live_blocks_with_the_conservative_count": int(
                (n_ex[:live] == n_cons[:live]).sum()),
            "occlusion_equal": bool(torch.equal(occ_c, occ_e)),
            "conservative_ms": _event_ms(
                lambda: traverse.any_hit_packets(*args, **base)),
            "exact_ms": _event_ms(
                lambda: traverse.any_hit_packets(*args, **base,
                                                 exact_cull=ksup))}


EXACT_OCCLUDE_KW = dict(engine="packets", group_size=2, exact_cull=6)
FUSED_EXACT_ENGINES = dict(
    HYBRID_CLOSEST_KW=dict(engine="cascade_fused", exact_cull=16),
    HYBRID_OCCLUDE_KW=dict(engine="packets_fused", early_skip=True,
                           sub_skip=True, exact_cull=16))
EXACT_REPS = 20
EXACT_ROW_ELEMS = 1 << 24  # [rows, R, Cs] elements a step of _exact_work


def _exact_work(call) -> dict:
    """Bytes and operations of one exact_cull launch on these inputs. The
    operations: each live lane's (t_max >= t_min) Cs super tests, and in a
    block within the shortlist (n_sup <= kx) its tests of the listed
    supers' children below C, at PERRAY_TEST_OPS a test (the kernel's
    perray_slab). The bytes: the rays (28 B a lane), the boxes, n_cand in
    and out, the in-cap blocks' finite conservative prefix read (8 B an
    entry) and their rows written (8 B a cluster)."""
    from path_tracer_ai_tpu_torch.accel import cuda_cull

    accel, o, d, tm, t_min, ksup = call
    nb, b = tm.shape
    c, cs, ss = accel.num_clusters, accel.num_supers, accel.super_size
    kx = min(ksup, cs)
    valid = torch.clamp(c - torch.arange(cs, device=o.device) * ss,
                        0, ss).float()  # children below C a super
    step = max(1, EXACT_ROW_ELEMS // (b * cs))
    tests = 0
    in_cap = 0
    prefix = 0
    entry = cuda_cull.block_candidates(accel, o, d, tm)[2]
    n_fin = torch.isfinite(entry).sum(dim=1)
    for lo in range(0, nb, step):
        tc = tm[lo:lo + step]
        hi0 = torch.where(tc >= 0.0, tc, -float("inf"))
        sup = cuda_cull._slab_lanes(o[lo:lo + step], d[lo:lo + step], hi0,
                                    accel.sbmin, accel.sbmax,
                                    t_min).any(dim=1)
        n_sup = sup.sum(dim=1)
        cap = n_sup <= kx
        live = (tc >= t_min).sum(dim=1)
        kids = torch.where(cap, sup.float() @ valid, 0.0)
        tests += int((live * (cs + kids)).sum())
        in_cap += int(cap.sum())
        prefix += int(torch.where(cap, n_fin[lo:lo + step], 0).sum())
    ops = tests * PERRAY_TEST_OPS
    nbytes = (nb * b * 28 + cs * 24 + cs * ss * 24 + nb * 8 + prefix * 8
              + in_cap * c * 8)
    by_bytes = nbytes / PEAK_BYTES_PER_S
    by_ops = ops / PEAK_F32_PER_S
    return {"bytes": nbytes, "operations": ops, "box_tests": tests,
            "in_cap_blocks": in_cap,
            "bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _exact_kernel_ms(call, reps=EXACT_REPS) -> dict:
    """Device ms of the exact_cull kernel alone (CUDA events around each
    launch, on one set of packet_cull tables: the kernel is idempotent) and
    of packet_cull's launch before it, a call."""
    from path_tracer_ai_tpu_torch.accel import cuda_cull

    accel, o, d, tm, t_min, ksup = call
    tables = cuda_cull.block_candidates(accel, o, d, tm)
    launch = lambda: cuda_cull._exact_launch(accel, o, d, tm, t_min, ksup,
                                             *tables)
    return {"ms": cuda_ms(launch, reps),
            "packet_cull_ms": cuda_ms(
                lambda: cuda_cull.block_candidates(accel, o, d, tm), reps)}


def _same_exact(got, want, bits=True) -> bool:
    ok = all(bool(torch.equal(a.cpu(), b_.cpu()))
             for a, b_ in zip(got[:2], want[:2]))
    if bits:
        return ok and bool(torch.equal(got[2].cpu().view(torch.int32),
                                       want[2].cpu().view(torch.int32)))
    return ok and bool((got[2].cpu() == want[2].cpu()).all())


def _check_exact(label, call, reps=EXACT_REPS) -> dict:
    """One exact cull call (accel, o_blk, d_blk, tm_blk, t_min, ksup) of a
    route: the kernel against the plain version on the card (whole tables,
    entries bit for bit), the kernel's ms beside its bound, the whole call
    (packet_cull and exact_cull) and the plain version on the card."""
    from path_tracer_ai_tpu_torch.accel import cuda_cull

    accel, o, d, tm, t_min, ksup = call
    got = cuda_cull.exact_cull(*call)
    want = cuda_cull.exact_cull_plain(*call)
    torch.cuda.synchronize()
    kx = min(ksup, accel.num_supers)
    res = {"input": label, "blocks": tm.shape[0], "R": tm.shape[1],
           "C": accel.num_clusters, "supers": accel.num_supers,
           "ksup": ksup, "kchild": kx * accel.super_size,
           "live_blocks": int((tm >= 0).any(dim=1).sum()),
           "candidates_mean": float(got[1].float().mean()),
           "matches_plain": _same_exact(got, want), "max_abs_err": 0.0,
           **_exact_kernel_ms(call, reps),
           "call_ms": cuda_ms(lambda: cuda_cull.exact_cull(*call), reps),
           "plain_ms": cuda_ms(lambda: cuda_cull.exact_cull_plain(*call), 1),
           **_exact_work(call)}
    res["ms_over_bound"] = res["ms"] / res["bound_ms"]
    res["plain_over_call"] = res["plain_ms"] / res["call_ms"]
    return res


def _crafted_exact() -> list:
    """exact_cull on every crafted exact case (tests/test_torch_sweep_cases.py
    exact_case) at its ksup and one past it, against the plain version on
    the CPU (entries as values: the CPU's conservative entries are the
    plain cull's)."""
    from types import SimpleNamespace

    from path_tracer_ai_tpu_torch.accel import cuda_cull

    c = _cases()
    out = []
    for name in c.EXACT_CASES:
        case = c.exact_case(name)
        args = [(SimpleNamespace(
            **{k: torch.as_tensor(case[k], device=dev) for k in (
                "bmin", "bmax", "sbmin", "sbmax", "cbmin", "cbmax")},
            num_clusters=case["bmin"].shape[0],
            num_supers=case["sbmin"].shape[0], super_size=case["ss"]),
            *(torch.as_tensor(case[k], device=dev)
              for k in ("o_blk", "d_blk", "tm_blk")), case["t_min"])
            for dev in ("cuda", "cpu")]
        for ksup in (case["ksup"], case["ksup"] + 1):
            got = cuda_cull.exact_cull(*args[0], ksup)
            want = cuda_cull.exact_cull_plain(*args[1], ksup)
            torch.cuda.synchronize()
            out.append({"case": name, "ksup": ksup,
                        "matches_plain": _same_exact(got, want, bits=False)})
    return out


def phase_exact_cull(scene, accel_base, accel_c, card, img_main, img_fused,
                     worklist_waves, accel_w, base_syncs):
    """The exact cull on three routes: the main path with the shadow
    engine's exact_cull=6 (bitwise the main path's image, and its host
    reads; the kept bounce-1 shadow wave's candidates per block and device
    ms under each cull); the fused path with exact_cull=16 in both engines
    (bitwise the fused path's image and host reads); the worklist cell's
    kept shadow wave through any_hit_worklist and through the
    "packets_exact" cascade (device ms, the same occlusion). The
    exact_cull kernel on the routes' kept calls (the main route's first
    two, the fused route's first four, the worklist wave's) and on every
    crafted case, against its plain version; its ms beside its bound, the
    whole call's and the plain version's on the card; launches by route.
    The consistency phase holds "packets_exact" against the oracle.
    base_syncs: the host reads of the main and fused renders without the
    exact cull, which the exact renders must equal (the kernel needs no
    live-block count)."""
    import inspect

    from path_tracer_ai_tpu_torch.accel import cuda_cull, traverse, worklist
    from path_tracer_ai_tpu_torch.engine import wavefront

    t0 = time.perf_counter()
    eager_before = dict(EAGER_CALLS)
    out = {}
    kept = {}
    calls = {}
    big = lambda a: a[1].shape[0] >= 4096  # not the 96x54 warm render's
    # the first sorted shadow wave of the bench render: wave 0, bounce 1
    real = _keeping(traverse, "any_hit_packets", kept,
                    lambda a: a[1].shape[0] >= 1 << 21, limit=4)
    real_cull = _keeping(cuda_cull, "exact_cull", calls,
                         lambda a: ("main", big(a)), limit=2)
    try:
        res, img, missing, image_ok = _bench_render(
            "exact_cull", scene, card, ["slot_sweep", "exact_cull"],
            warm_small=True,
            engines={"HYBRID_OCCLUDE_KW": EXACT_OCCLUDE_KW},
            accel=accel_base, accel_closest=accel_c)
    finally:
        traverse.any_hit_packets = real
        cuda_cull.exact_cull = real_cull
    res["route"] = f"main path, HYBRID_OCCLUDE_KW = {EXACT_OCCLUDE_KW}"
    res["bitwise_equal_to_main"] = bool(np.array_equal(img, img_main))
    res["host_syncs_without_exact_cull"] = base_syncs["main"]
    waves = [c for c in kept.get(True, []) if c[1].get("sort", True)]
    if waves:
        args, kw = waves[0]
        res["shadow_wave_bounce_1"] = _shadow_wave_culls(args, kw, 6)
    _finish_path(res, missing, image_ok)
    if not res["bitwise_equal_to_main"]:
        fail("exact_cull", "the exact cull changed the main path's image")
    if res["host_syncs"] != base_syncs["main"]:
        fail("exact_cull", "the exact cull read the host on the main path")
    if not waves or not res["shadow_wave_bounce_1"]["occlusion_equal"]:
        fail("exact_cull", "no kept bounce-1 shadow wave, or its occlusion "
                           "differs between the culls")
    out["main"] = res

    real_cull = _keeping(cuda_cull, "exact_cull", calls,
                         lambda a: ("fused", big(a)), limit=4)
    try:
        res, img, missing, image_ok = _bench_render(
            "exact_cull", scene, card,
            ["fused_stage_any", "fused_stage_closest", "exact_cull"],
            warm_small=True, engines=FUSED_EXACT_ENGINES, accel=accel_base)
    finally:
        cuda_cull.exact_cull = real_cull
    res["route"] = "fused path, exact_cull=16 in both engines"
    res["bitwise_equal_to_fused"] = bool(np.array_equal(img, img_fused))
    res["host_syncs_without_exact_cull"] = base_syncs["fused"]
    _finish_path(res, missing, image_ok)
    if not res["bitwise_equal_to_fused"]:
        fail("exact_cull", "the exact cull changed the fused path's image")
    if res["host_syncs"] != base_syncs["fused"]:
        fail("exact_cull", "the exact cull read the host on the fused path")
    out["fused"] = res

    args, kw = worklist_waves["shadow_wave"]
    pkw = dict(wavefront.WORKLIST_OCCLUDE_PACKETS_KW,
               tri_pack=kw.get("tri_pack"))
    occ_w = worklist.any_hit_worklist(*args, **kw)
    real_cull = _keeping(cuda_cull, "exact_cull", calls,
                         lambda a: ("worklist", True), limit=1)
    _reset_counts()
    try:
        occ_p = traverse.any_hit_packets(*args, **pkw)
        torch.cuda.synchronize()
    finally:
        cuda_cull.exact_cull = real_cull
    wave_launches = _read_counts()
    res = {"phase": "exact_cull", "card": card,
           "route": "worklist cell, shadow wave 0 bounce 1",
           "rays": int(args[1].shape[0]), "clusters": accel_w.num_clusters,
           "launches": {k: wave_launches[k] for k in ("packet_cull",
                                                       "exact_cull")},
           "occlusion_equal": bool(torch.equal(occ_w, occ_p)),
           "worklist_ms": _event_ms(
               lambda: worklist.any_hit_worklist(*args, **kw)),
           "packets_exact_ms": _event_ms(
               lambda: traverse.any_hit_packets(*args, **pkw))}
    emit(res)
    if not res["occlusion_equal"]:
        fail("exact_cull", "packets_exact and the worklist disagree on the "
                           "worklist cell's shadow wave")
    out["worklist_wave"] = res

    checks = []
    for route in ("main", "fused", "worklist"):
        for i, (cargs, ckw) in enumerate(calls.get((route, True), [])):
            bound = inspect.signature(cuda_cull.exact_cull).bind(*cargs,
                                                                 **ckw)
            bound.apply_defaults()
            checks.append(_check_exact(f"{route} route, call {i + 1}",
                                       tuple(bound.arguments.values())))
    crafted = _crafted_exact()
    EAGER_CALLS.update(eager_before)  # the comparisons' own calls
    line = {"phase": "exact_cull_kernel", "card": card, "waves": checks,
            "crafted": len(crafted),
            "crafted_disagree": [[x["case"], x["ksup"]] for x in crafted
                                 if not x["matches_plain"]],
            "launches_by_route": {
                "main_exact": out["main"]["launches"]["exact_cull"],
                "fused_exact": out["fused"]["launches"]["exact_cull"],
                "worklist_wave": wave_launches["exact_cull"]},
            "host_syncs": {"main_exact": out["main"]["host_syncs"],
                           "fused_exact": out["fused"]["host_syncs"]},
            "seconds": time.perf_counter() - t0}
    emit(line)
    if (len(checks) < 7 or not all(c["matches_plain"] for c in checks)
            or line["crafted_disagree"]):
        fail("exact_cull", "exact_cull disagrees with its plain version, or "
                           "a route's calls were not kept")
    keys = ("input", "blocks", "R", "C", "ksup", "ms", "packet_cull_ms",
            "call_ms", "plain_ms", "bound_ms", "bound_by", "ms_over_bound",
            "box_tests", "in_cap_blocks", "candidates_mean",
            "matches_plain")
    # the main route's second call (wave 0, bounce 1) heads the line
    out["check"] = {**checks[1], "matches_plain": all(
        c["matches_plain"] for c in checks),
        "waves": [{k: c[k] for k in keys} for c in checks]}
    return out


# --- the ctiles and perray backends ------------------------------------------

def phase_path_ctiles(scene, accel_base, accel_c, card, img_main, scene_w,
                      accel_w, worklist_sha):
    """The bench render with backend="ctiles" (closest waves on the S=128
    accel, T 128; lane-major shadow waves in blocks of 4, T 64), warm at
    96x54 and timed; then the same with sub_skip in CTILES_CLOSEST_KW, and
    the main path with the hybrid shadow engine "ctiles". Each image must
    equal the main path's bit for bit (occlusion and ctiles' closest hits
    are exact, with the oracle's tie rule)."""
    from path_tracer_ai_tpu_torch.engine import wavefront

    runs = {
        "path_ctiles": (dict(backend="ctiles"), None, ["slot_sweep"]),
        "path_ctiles_sub_skip": (
            dict(backend="ctiles"),
            {"CTILES_CLOSEST_KW": dict(wavefront.CTILES_CLOSEST_KW,
                                       sub_skip=True)}, ["slot_sweep"]),
        "path_hybrid_ctiles_shadows": (
            dict(accel_closest=accel_c),
            {"HYBRID_OCCLUDE_KW": dict(engine="ctiles")}, ["slot_sweep"]),
    }
    out = {}
    for name, (kw, engines, kernels) in runs.items():
        res, img, missing, image_ok = _bench_render(
            "path_ctiles", scene, card, kernels, warm_small=True,
            engines=engines, accel=accel_base, **kw)
        res["route"] = name
        res["tables"] = {k: str(v) for k, v in (engines or {}).items()}
        res["bitwise_equal_to_main"] = bool(np.array_equal(img, img_main))
        _finish_path(res, missing, image_ok)
        if not res["bitwise_equal_to_main"]:
            fail("path_ctiles", f"{name}: the image differs from the main "
                                "path's")
        out[name] = res
    if not any(sh.get("option") == "sub_skip" for sh in
               out["path_ctiles_sub_skip"]["tile_sweep_shapes"]):
        fail("path_ctiles", "the sub_skip render launched no sub_skip sweep")
    out["path_ctiles_2level"] = _ctiles_2level_render(scene_w, accel_w, card,
                                                      worklist_sha)
    return out


def _ctiles_2level_render(scene_w, accel_w, card, worklist_sha) -> dict:
    """The ctiles backend on the worklist scene (2,561 clusters: levels 2,
    the 2-level cull on the card), warm at 96x54 and timed; its image must
    be the worklist route's bit for bit (path_worklist's sha256: both
    exact, on the oracle's tie rule where no ray falls back). Fails where
    the 2-level kernel did not run, the eager 2-level cull did, or
    accel.ctiles read the host."""
    eager = EAGER_CALLS["_block_candidates_2level"]
    res, img, missing, image_ok = _bench_render(
        "path_ctiles", scene_w, card, ["block_cull_2level", "slot_sweep"],
        warm_small=True, accel=accel_w, backend="ctiles")
    res["route"] = "path_ctiles_2level"
    res["clusters"] = accel_w.num_clusters
    res["levels"] = 2 if accel_w.num_clusters > 2048 else 1  # levels=0
    res["eager_2level_calls"] = EAGER_CALLS["_block_candidates_2level"] - eager
    res["ctiles_host_reads"] = sum(
        n for k, n in res["host_sync_sites"].items()
        if k.startswith("path_tracer_ai_tpu_torch.accel.ctiles:"))
    res["bitwise_equal_to_worklist"] = res["image_sha256"] == worklist_sha
    _finish_path(res, missing, image_ok)
    if res["eager_2level_calls"] or res["ctiles_host_reads"]:
        fail("path_ctiles", "the ctiles levels-2 render ran the eager 2-level "
                            "cull or read the host in accel.ctiles")
    if not res["bitwise_equal_to_worklist"]:
        fail("path_ctiles", "the levels-2 image differs from the worklist "
                            "route's")
    return res


ROUTE_CUT = dict(width=480, height=270)
ROUTE_BENCH_LIMIT_S = 60.0


def _route_at_cut(phase, scene, accel_base, accel_c, card, img_main, kernels,
                  **render_kw):
    """A route whose tie rule is the packet cascade's first slot (perray,
    packets): at 480x270 first (the bench's spp and bounces; warm at
    96x54, then timed), then at the bench cell if 16 times that predicts
    under ROUTE_BENCH_LIMIT_S. Its image is held at atol 1e-5 against the
    main path at the size it ran (a main-path render at 480x270 when cut),
    and at 96x54 against the oracle, with the differing pixels counted.
    Fails unless every kernel in `kernels` was launched in the timed
    render."""
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import oracle, wavefront
    from path_tracer_ai_tpu_torch.scene.camera import default_camera
    from path_tracer_ai_tpu_torch.utils import sync

    cam = default_camera("cuda")
    kw = dict(wave_size=1 << 20, device="cuda", accel=accel_base,
              **render_kw)

    def timed(settings):
        _reset_counts()
        stats = wavefront.RenderStats()
        img = wavefront.render(scene, cam, settings, stats=stats, **kw)
        return img, {"seconds": stats.seconds,
                     "mrays_per_s": stats.mrays_per_s,
                     "closest_rays": stats.closest_rays,
                     "shadow_rays": stats.shadow_rays,
                     "host_syncs": sync.count, "host_sync_sites": _sync_sites(),
                     "launches": _read_counts(),
                     "tile_sweep_shapes": _tile_shapes(),
                     "cascade_stage_shapes": _stage_shapes()}

    def against(img, ref):
        diff = np.abs(img - ref).max(axis=-1)
        return {"max_abs_diff": float(diff.max()),
                "pixels_differing": int((diff > 0).sum()),
                "pixels_over_1e-5": int((diff > 1e-5).sum())}

    small = RenderSettings(**{**BENCH, "width": 96, "height": 54})
    img_small, _ = timed(small)  # also the warm pass
    res = {"phase": phase, "card": card, "render_kw": render_kw,
           "vs_oracle_96x54": against(img_small, oracle.render(
               scene, cam, small, device="cuda"))}
    cut = RenderSettings(**{**BENCH, **ROUTE_CUT})
    img_cut, res["cut_480x270"] = timed(cut)
    predicted = res["cut_480x270"]["seconds"] * 16
    res["predicted_bench_seconds"] = predicted
    if predicted < ROUTE_BENCH_LIMIT_S:
        img, run = timed(RenderSettings(**BENCH))
        res.update(run, size="1920x1080", vs_main=against(img, img_main))
    else:
        img_m = wavefront.render(scene, cam, cut, wave_size=1 << 20,
                                 device="cuda", accel=accel_base,
                                 accel_closest=accel_c)
        img = img_cut
        res.update(res["cut_480x270"], size="480x270 (cut: 16 x the "
                   "480x270 render predicts over "
                   f"{ROUTE_BENCH_LIMIT_S:.0f} s at 1920x1080)",
                   vs_main=against(img, img_m))
    image_ok = _image_verdict(img, res)
    _finish_path(res, [k for k in kernels if res["launches"][k] <= 0],
                 image_ok)
    bad = {k: v for k, v in (("vs_main", res["vs_main"]),
                             ("vs_oracle_96x54", res["vs_oracle_96x54"]))
           if v["pixels_over_1e-5"]}
    if bad:
        fail(phase, f"{render_kw} differs beyond atol 1e-5: {bad}")
    return res


# Modules in which the perray route may make no host read: the stage loop
# (traverse's stages and the stage wrapper; the overflow count is
# traverse._perray_fallback's, a read a call, counted apart).
PERRAY_NO_SYNC_SITES = ("path_tracer_ai_tpu_torch.accel.cuda_cascade:",)


def _perray_reads(res) -> dict:
    """The perray route's host reads by kind: the overflow count (one a
    perray call), the stage loop's (none since the stage kernel) and the
    others (the bounce loop's)."""
    from path_tracer_ai_tpu_torch.accel import traverse

    fallback = f"{traverse.__name__}:{_perray_fallback_line()}"
    sites = res["host_sync_sites"]
    loop = sum(n for k, n in sites.items()
               if k.startswith(PERRAY_NO_SYNC_SITES)
               or (k.startswith(traverse.__name__ + ":") and k != fallback))
    return {"host_reads": res["host_syncs"],
            "overflow_counts": sites.get(fallback, 0), "stage_loop": loop,
            "others": res["host_syncs"] - sites.get(fallback, 0) - loop}


def _perray_fallback_line() -> int:
    """The line of traverse._perray_fallback's host read (its site)."""
    import inspect

    from path_tracer_ai_tpu_torch.accel import traverse

    lines, first = inspect.getsourcelines(traverse._perray_fallback)
    return first + next(i for i, line in enumerate(lines)
                        if "host_int" in line)


def phase_path_perray(scene, accel_base, accel_c, card, img_main):
    """The perray backend (traverse's per-ray queries: their candidate
    lists one launch each of perray_cull, their cascades' stages one
    launch each of the stage kernel's perray folds) through _route_at_cut;
    the cull and both folds must launch, no stage may read the host
    (host_sync_sites: the overflow count, one a call, and the bounce loop's
    reads only) and no eager cull may run."""
    res = _route_at_cut("path_perray", scene, accel_base, accel_c, card,
                        img_main, ["perray_stage_any", "perray_stage_first",
                                   "perray_cull"],
                        backend="perray")
    res["host_reads"] = _perray_reads(res)
    emit({"phase": "path_perray_reads", "card": card, **res["host_reads"],
          "sites": res["host_sync_sites"]})
    if res["host_reads"]["stage_loop"]:
        fail("path_perray", f"the perray stages read the host: "
                            f"{res['host_sync_sites']}")
    if EAGER_CALLS["perray_cull_plain"]:
        fail("path_perray", "the eager perray cull ran on the card")
    return res


KSLOTS_CUT = dict(width=480, height=270)
KSLOTS_BENCH_LIMIT_S = 60.0


def phase_path_kslots(scene, accel_base, accel_c, card, img_main):
    """The kslots backend (per-ray K slots: one kslots_cull and one
    kslot_sweep launch a query, overflow rays through pair tiles):
    warm at 96x54 (bench spp and bounces), whose image must equal the
    oracle's bit for bit; then at 480x270, and at the bench cell if 16
    times that predicts under KSLOTS_BENCH_LIMIT_S, its image bitwise the
    main path's (at 480x270 against a main-path render of that size when
    cut). Each timed render: seconds, Mrays/s, host syncs, launches (and
    tile_sweep's by shape), the device seconds of each kslots stage (cull,
    sweep, fallback; CUDA events) and the overflow shares (over k_supers,
    over k_clusters, over k_clusters only for phantom children)."""
    from path_tracer_ai_tpu_torch.accel import (
        cuda_cull,
        cuda_kslots,
        kslots,
        traverse,
        worklist,
    )
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import oracle, wavefront
    from path_tracer_ai_tpu_torch.scene.camera import default_camera
    from path_tracer_ai_tpu_torch.utils import sync

    cam = default_camera("cuda")
    kw = dict(wave_size=1 << 20, device="cuda", accel=accel_base,
              backend="kslots")

    def timed(settings):
        _reset_counts()
        kslots.stage_events = {}
        stats = wavefront.RenderStats()
        try:
            img = wavefront.render(scene, cam, settings, stats=stats, **kw)
            run = {"seconds": stats.seconds,
                   "mrays_per_s": stats.mrays_per_s,
                   "closest_rays": stats.closest_rays,
                   "shadow_rays": stats.shadow_rays,
                   "host_syncs": sync.count, "launches": _read_counts(),
                   "tile_sweep_shapes": _tile_shapes(),
                   "stage_device_seconds": kslots.stage_seconds(),
                   "overflow": kslots.read_overflow_counts(),
                   "overflow_fallback": dict(worklist.fallback_counts)}
        finally:
            kslots.stage_events = None
        ov = run["overflow"]
        rays = max(ov["rays"], 1)
        run["overflow_share"] = {
            "all": (ov["over_supers"] + ov["over_clusters"]) / rays,
            "over_supers": ov["over_supers"] / rays,
            "over_clusters": ov["over_clusters"] / rays,
            "phantom_only": ov["phantom_only"] / rays,
            "slots_per_live_ray": ov["slots"] / rays}
        return img, run

    def against(img, ref):
        diff = np.abs(img - ref).max(axis=-1)
        return {"bitwise": bool(np.array_equal(img, ref)),
                "max_abs_diff": float(diff.max()),
                "pixels_differing": int((diff > 0).sum())}

    small = RenderSettings(**{**BENCH, "width": 96, "height": 54})
    img_small, warm = timed(small)  # also the warm pass
    res = {"phase": "path_kslots", "card": card,
           "clusters": accel_base.num_clusters,
           "supers": accel_base.num_supers,
           "levels": kslots.resolve_levels(accel_base, 0),
           "closest_kw": wavefront.KSLOTS_CLOSEST_KW,
           "occlude_kw": wavefront.KSLOTS_OCCLUDE_KW,
           "warm_96x54": warm,
           "vs_oracle_96x54": against(img_small, oracle.render(
               scene, cam, small, device="cuda"))}
    cut = RenderSettings(**{**BENCH, **KSLOTS_CUT})
    img_cut, res["cut_480x270"] = timed(cut)
    predicted = res["cut_480x270"]["seconds"] * 16
    res["predicted_bench_seconds"] = predicted
    kept = {}
    if predicted < KSLOTS_BENCH_LIMIT_S:
        img, run = timed(RenderSettings(**BENCH))
        res.update(run, size="1920x1080", vs_main=against(img, img_main))
        # one more bench render, untimed, keeps (copies of) the arguments
        # of its first two kslot_sweep launches of each kind and stops
        # once it has them
        real = _keeping(cuda_kslots, "kslot_sweep", kept, lambda a: a[-1])
        keeping = cuda_kslots.kslot_sweep
        # and of its first two closest fallback cascades (packet_cascade)
        real_fb = _keeping(traverse, "closest_hit_packets", kept,
                           lambda a: "fallback")
        # and of its first two kslots_cull calls of each wave type (the
        # closest waves' k_clusters, the shadow waves'), for ray_cull
        waves = {wavefront.KSLOTS_CLOSEST_KW["k_clusters"]: "cull_closest",
                 wavefront.KSLOTS_OCCLUDE_KW["k_clusters"]: "cull_shadow"}
        real_cull = _keeping(cuda_cull, "kslots_cull", kept,
                             lambda a: waves[a[6]])

        def until_kept(*a, **kw):
            out = keeping(*a, **kw)
            if min(len(kept.get(k, ())) for k in (True, False)) >= 2:
                raise _Kept
            return out

        cuda_kslots.kslot_sweep = until_kept
        try:
            wavefront.render(scene, cam, RenderSettings(**BENCH), **kw)
        except _Kept:
            pass
        finally:
            cuda_kslots.kslot_sweep = real
            traverse.closest_hit_packets = real_fb
            cuda_cull.kslots_cull = real_cull
        KEPT_FALLBACKS["kslots"] = kept.get("fallback", [])
        for wave in ("closest", "shadow"):
            KEPT_RAY_CULLS["kslots_" + wave] = kept.get(f"cull_{wave}", [])
    else:
        img_m = wavefront.render(scene, cam, cut, wave_size=1 << 20,
                                 device="cuda", accel=accel_base,
                                 accel_closest=accel_c)
        img = img_cut
        res.update(res["cut_480x270"], size="480x270 (cut: 16 x the "
                   "480x270 render predicts over "
                   f"{KSLOTS_BENCH_LIMIT_S:.0f} s at 1920x1080)",
                   vs_main=against(img, img_m))
    image_ok = _image_verdict(img, res)
    res["eager_cull_calls"] = EAGER_CALLS["kslots_cull_plain"]
    res["eager_pair_calls"] = EAGER_CALLS["pair_tables_plain"]
    # the fallback's pair queries (a compacted wave of overflow rays) build
    # their tables through the pair kernels, one call each
    fb = res["overflow_fallback"]
    pair_queries = res["overflow_fallback_pair_queries"] = (
        fb["calls"] - fb["whole_wave"])
    _finish_path(res, [k for k in ("kslots_cull", "kslot_sweep")
                       if res["launches"][k] <= 0], image_ok)
    if res["eager_cull_calls"] or res["eager_pair_calls"]:
        fail("path_kslots", "the eager kslots cull or pair tables ran on the "
                            "card")
    if res["launches"]["pair_cull"] != pair_queries:
        fail("path_kslots", f"{pair_queries} pair queries and "
                            f"{res['launches']['pair_cull']} pair_cull "
                            f"launches")
    bad = [k for k in ("vs_main", "vs_oracle_96x54") if not res[k]["bitwise"]]
    if bad:
        fail("path_kslots", f"the kslots image differs: "
                            f"{ {k: res[k] for k in bad} }")
    # kslot_sweep on the bench render's own wave 0, bounce 1 queries
    if min(len(kept.get(k, ())) for k in (True, False)) >= 2:
        res["kept_waves"] = [
            _kslot_check(kept[k][1][0], "kslot_waves",
                         f"{w}, wave 0, bounce 1")
            for k, w in ((True, "closest"), (False, "shadow"))]
    elif predicted < KSLOTS_BENCH_LIMIT_S:
        fail("path_kslots", "the bench render made fewer than two "
                            "kslot_sweep launches of a kind")
    return res


# --- the per-ray culls: kslots_cull, perray_cull ---------------------------

# The kslots render's kslots_cull calls (path_kslots: "kslots_closest",
# "kslots_shadow" -> [(args, kw)] of its first two calls of that wave type,
# bounce 0 and 1 of wave 0) and the perray render's two kept calls
# (perray_cascade_loop: "perray" -> [(label, fn, (args, kw))]).
KEPT_RAY_CULLS = {}
# f32 operations of one ray/box test as csrc/ray_cull.cu writes it.
# kslots_slab: an axis 2 subtractions, 2 multiplications, 2 NaN compares,
# a min, a max, 2 selects and the running max / min (12); a box 3 (the
# window's min and max, the compare). perray_slab: an axis 2
# subtractions, 2 multiplications, the sign compare, 2 selects, 2 compares
# and 2 selects of the running bounds (11); a box 1 (the compare).
KSLOTS_TEST_OPS = 3 * 12 + 3
PERRAY_TEST_OPS = 3 * 11 + 1
RCULL_REPS = 20
RCULL_ROW_ELEMS = 1 << 22  # [rows, boxes] elements a step of the counts


def _rcull_work(which, call) -> dict:
    """Bytes (the rays once, the boxes, the tables out) and operations
    (*_TEST_OPS over the boxes each ray must test: none for a ray whose
    window is empty; kslots at levels 1 every cluster box, at levels 2 the
    supers up to the one past k_supers and the children of the listed
    ones; perray the boxes up to the one past cap; perray's entry order,
    "entry", every box) of one call."""
    from path_tracer_ai_tpu_torch.accel import cuda_cull, kslots

    if which == "kslots":
        accel, o, d, tm, t_min, ks, kc, levels = call
    else:
        accel, o, d, t_min, tm, cap = call
    n = o.shape[0]
    c, cs, ss = accel.num_clusters, accel.num_supers, accel.super_size
    width = c if which != "kslots" or levels == 1 else cs
    step = max(1, RCULL_ROW_ELEMS // width)
    tests = 0
    for lo in range(0, n, step):
        oc, dc, tc = o[lo:lo + step], d[lo:lo + step], tm[lo:lo + step]
        rows = oc.shape[0]
        if which == "perray":
            some = tc >= t_min
            n_t = _first_past(cuda_cull.perray_slab_plain(
                accel, oc, dc, tc, t_min)[0], cap)
        elif which == "entry":
            some = tc >= t_min
            n_t = torch.full((rows,), c, device=o.device)
        else:
            hi0 = torch.where(tc >= 0.0, tc, -float("inf"))
            some = hi0 >= t_min
            lo0 = torch.full((rows,), float(t_min), device=o.device)
            if levels == 1:
                n_t = torch.full((rows,), c, device=o.device)
            else:
                cand_s = kslots._ray_slab(accel.sbmin, accel.sbmax, oc, dc,
                                          lo0, hi0)
                listed = torch.clamp(cand_s.sum(dim=1), max=ks)
                n_t = _first_past(cand_s, ks) + listed * ss
        tests += int(torch.where(some, n_t, 0).sum())
    ops = tests * (KSLOTS_TEST_OPS if which == "kslots" else PERRAY_TEST_OPS)
    if which == "kslots":
        boxes = c * 24 if levels == 1 else cs * 24 + cs * ss * 24
        out = n * (kc * 4 + 8 + 5)
    elif which == "perray":
        boxes = c * 24
        out = n * (cap * 4 + 5)
    else:  # order and entry
        boxes = c * 24
        out = n * (cap * 8 + 5)
    nbytes = n * 28 + boxes + out
    by_bytes = nbytes / PEAK_BYTES_PER_S
    by_ops = ops / PEAK_F32_PER_S
    return {"bytes": nbytes, "operations": ops, "box_tests": tests,
            "box_tests_per_ray": tests / max(1, n),
            "bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _rcull_fns(which):
    from path_tracer_ai_tpu_torch.accel import cuda_cull

    if which == "kslots":
        return cuda_cull.kslots_cull, cuda_cull.kslots_cull_plain
    if which == "entry":
        return cuda_cull.perray_entry, cuda_cull.perray_entry_plain
    return cuda_cull.perray_cull, cuda_cull.perray_cull_plain


def _rcull_same(got, want) -> bool:
    if isinstance(got, dict):
        return set(got) == set(want) and all(
            bool(torch.equal(got[k].cpu(), want[k].cpu())) for k in got)
    return all(bool(torch.equal(a.cpu(), b.cpu())) for a, b in zip(got, want))


def _check_rcull(which, label, call, plain_cpu=None, reps=RCULL_REPS,
                 bound=True) -> dict:
    """One kslots_cull / perray_cull call against its plain version (on the
    card, or on the CPU copy `plain_cpu` of the call), timed beside its
    bound and the plain version on the card."""
    run_k, run_p = _rcull_fns(which)
    got = run_k(*call)
    want = run_p(*plain_cpu) if plain_cpu is not None else run_p(*call)
    torch.cuda.synchronize()
    accel, o = call[:2]
    over = (got["over"] if which == "kslots"
            else got[3] if which == "entry" else got[2])
    n_cand = got["n_cand"] if which == "kslots" else got[1]
    res = {"input": label, "rays": o.shape[0], "C": accel.num_clusters,
           "supers": accel.num_supers,
           **({"levels": call[7], "k_supers": call[5], "k_clusters": call[6]}
              if which == "kslots" else {"cap": call[5]}),
           "plain_on": "card" if plain_cpu is None else "cpu",
           "candidates_mean": float(n_cand.float().mean()),
           "overflow_share": float(over.float().mean()),
           "matches_plain": _rcull_same(got, want), "max_abs_err": 0.0}
    if reps:
        res["ms"] = cuda_ms(lambda: run_k(*call), reps)
        res["plain_ms"] = cuda_ms(lambda: run_p(*call), 1)
    if bound:
        res.update(_rcull_work(which, call))
        res["ms_over_bound"] = res["ms"] / res["bound_ms"]
    return res


def _perray_call(args, kw):
    """perray_cull's arguments of a kept perray query."""
    import inspect

    from path_tracer_ai_tpu_torch.accel import traverse

    b = inspect.signature(traverse.closest_hit_perray).bind(*args, **kw)
    b.apply_defaults()
    a = b.arguments
    n = a["origins"].shape[0]
    tm = torch.broadcast_to(torch.as_tensor(
        a["t_max"], dtype=torch.float32, device="cuda"), (n,)).contiguous()
    return (a["accel"], a["origins"].contiguous(),
            a["directions"].contiguous(), a["t_min"], tm, a["cap"])


def _crafted_rcull() -> list:
    """Both kernels on every crafted per-ray cull case (tests/
    test_torch_sweep_cases.py ray_cull_case) at its caps and one past
    each, against their plain versions on the CPU."""
    from types import SimpleNamespace

    c = _cases()
    out = []
    for name in c.RAY_CULL_CASES:
        case = c.ray_cull_case(name)
        accs = [SimpleNamespace(
            **{k: torch.as_tensor(case[k], device=dev) for k in (
                "bmin", "bmax", "sbmin", "sbmax", "cbmin", "cbmax")},
            num_clusters=case["bmin"].shape[0],
            num_supers=case["sbmin"].shape[0], super_size=case["ss"])
            for dev in ("cuda", "cpu")]
        rays = [[torch.as_tensor(case[k], device=dev)
                 for k in ("o", "d", "tm")] for dev in ("cuda", "cpu")]
        calls = [("kslots", (case["ks"] + a, case["kc"] + b, levels))
                 for levels in (1, 2)
                 for a, b in ((0, 0), (1, 0), (0, 1))]
        calls += [("perray", (case["cap"] + a,)) for a in (0, 1)]
        calls += [("entry", (cap,)) for cap in c.perray_entry_caps(case)]
        for which, caps in calls:
            pair = []
            for acc, (o, d, tm) in zip(accs, rays):
                pair.append((acc, o, d, tm, case["t_min"], *caps)
                            if which == "kslots" else
                            (acc, o, d, case["t_min"], tm, *caps))
            r = _check_rcull(which, name, pair[0], plain_cpu=pair[1],
                             reps=0, bound=False)
            out.append({"which": which, "case": name, "caps": caps,
                        "matches_plain": r["matches_plain"]})
    return out


def _route_before_after(scene, accel_base, render_kw, patch, after) -> dict:
    """One bench render of a route with its per-ray cull's plain version
    patched in (on the card: the eager cull of before), beside the route
    phase's own timed render (after): render seconds and, for kslots, the
    device seconds of its stages."""
    from path_tracer_ai_tpu_torch.accel import cuda_cull, kslots
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import wavefront
    from path_tracer_ai_tpu_torch.scene.camera import default_camera

    name, plain = patch
    stats = wavefront.RenderStats()
    kslots.stage_events = {} if render_kw["backend"] == "kslots" else None
    try:
        with _patched(cuda_cull, **{name: lambda *a: plain(*a)}):
            wavefront.render(scene, default_camera("cuda"),
                             RenderSettings(**BENCH), stats=stats,
                             wave_size=1 << 20, device="cuda",
                             accel=accel_base, **render_kw)
        stages = kslots.stage_seconds() if kslots.stage_events else None
    finally:
        kslots.stage_events = None
    before = {"seconds": stats.seconds}
    if stages is not None:
        before["stage_device_seconds"] = stages
    keep = ("seconds", "size", "stage_device_seconds", "launches")
    return {"before": before,
            "after": {k: after[k] for k in keep if k in after}}


def phase_ray_cull(scene, accel_base, card, paths) -> tuple:
    """The per-ray culls on the card. kslots_cull against its plain
    version, bit for bit, on the kslots render's kept calls (wave 0,
    bounce 1, closest and shadow: the bench accel, C 641 in 41 supers of
    16, levels 2) and on the same calls forced to levels 1; perray_cull on
    the perray render's two kept calls (wave 0, bounce 1: 2^16 rays each);
    perray_entry (order_mode "entry", on no route) on the same two calls,
    first as its path (the counts read around the two calls), then each
    checked; all three on every crafted case at its caps and one past each
    (perray_entry also at cap 1). Each render call timed beside its bound
    (_rcull_work) and the plain version on the card. Then each route's
    bench render once more with the plain version patched in (the eager
    cull of before), beside the route phase's own: the kslots cull's stage
    seconds, the perray render's seconds. Returns the kernels line's
    checks (the shadow calls) and perray_entry's path."""
    from path_tracer_ai_tpu_torch.accel import cuda_cull, traverse

    t0 = time.perf_counter()
    eager_before = dict(EAGER_CALLS)
    kept_k = [KEPT_RAY_CULLS.get("kslots_" + w, []) for w in
              ("closest", "shadow")]
    kept_p = KEPT_RAY_CULLS.get("perray", [])
    if min(len(k) for k in kept_k) < 2 or len(kept_p) < 2:
        fail("ray_cull", "fewer than two kept kslots_cull calls of a wave "
                         "type, or no kept perray calls")
    waves = {"kslots_cull": [], "perray_cull": [], "perray_entry": []}
    for levels in (2, 1):
        for wave, kept in zip(("closest", "shadow"), kept_k):
            args = kept[1][0]
            call = args[:7] + (levels,)
            waves["kslots_cull"].append(_check_rcull(
                "kslots", f"kslots render {wave} call, wave 0, bounce 1"
                + ("" if levels == args[7] else
                   f", forced to levels {levels}"), call))
    for label, _fn, (args, kw) in kept_p:
        waves["perray_cull"].append(_check_rcull(
            "perray", label, _perray_call(args, kw)))
    # perray's entry order, on no route: its path is the entry-order lists
    # of the perray render's kept calls (counts set to 0 before, read
    # after), then each call checked
    entry_calls = [_perray_call(args, kw) for _l, _f, (args, kw) in kept_p]
    _reset_counts()
    for call in entry_calls:
        traverse._perray_candidates(*call, order_mode="entry")
    torch.cuda.synchronize()
    entry_path = {"launches": _read_counts()}
    if entry_path["launches"]["perray_entry"] != len(entry_calls):
        fail("ray_cull", "the entry-order lists did not launch perray_entry "
                         "once a call")
    waves["perray_entry"] = [_check_rcull("entry", label, call)
                             for (label, _f, _a), call in zip(kept_p,
                                                              entry_calls)]
    crafted = _crafted_rcull()
    routes = {
        "kslots": _route_before_after(
            scene, accel_base, {"backend": "kslots"},
            ("kslots_cull", cuda_cull.kslots_cull_plain),
            paths["path_kslots"]),
        "perray": _route_before_after(
            scene, accel_base, {"backend": "perray"},
            ("perray_cull", cuda_cull.perray_cull_plain),
            paths["path_perray"])}
    EAGER_CALLS.update(eager_before)  # the comparisons' own calls
    res = {"phase": "ray_cull", "card": card, "waves": waves,
           "routes": routes, "crafted": len(crafted),
           "crafted_disagree": [[x["which"], x["case"], x["caps"]]
                                for x in crafted if not x["matches_plain"]],
           "seconds": time.perf_counter() - t0}
    emit(res)
    if (not all(w["matches_plain"] for ws in waves.values() for w in ws)
            or res["crafted_disagree"]):
        fail("ray_cull", "a per-ray cull disagrees with its plain version")
    keys = ("input", "rays", "C", "ms", "plain_ms", "bound_ms", "bound_by",
            "ms_over_bound", "box_tests_per_ray", "candidates_mean",
            "overflow_share", "matches_plain")
    return tuple(
        {**ws[1], "matches_plain": all(w["matches_plain"] for w in ws),
         "waves": [{k: w[k] for k in keys + (("levels",) if name ==
                                             "kslots_cull" else ("cap",))}
                   for w in ws]}
        for name, ws in waves.items()) + (entry_path,)


# --- the pair tables and ctiles' 2-level cull: pair_cull -------------------

PAIR_REPS = 20
KSLOTS_PAIR_RAYS = 1 << 17  # kslots' compacted fallback wave (kslots.py)


class _KeepCalls:
    """While entered, mod.name keeps copies of the arguments of its calls
    (self.calls: [(label, args, kw)]) for which label_of(args, kw) gives a
    label not yet kept `per_label` times, and raises _Kept once every label
    in `want` has them."""

    def __init__(self, mod, name, label_of, want, per_label=1):
        self.mod, self.name, self.label_of = mod, name, label_of
        self.want, self.per_label = want, per_label
        self.calls = []

    def __enter__(self):
        self.real = real = getattr(self.mod, self.name)

        def keep(*a, **kw):
            label = self.label_of(a, kw)
            if label is not None and sum(
                    c[0] == label for c in self.calls) < self.per_label:
                self.calls.append((label, tuple(
                    x.clone() if torch.is_tensor(x) else x for x in a),
                    dict(kw)))
            out = real(*a, **kw)
            if all(sum(c[0] == w for c in self.calls) >= self.per_label
                   for w in self.want):
                raise _Kept
            return out

        setattr(self.mod, self.name, keep)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.real)
        return exc[0] is _Kept


def _keep_pair_calls(scene, accel, render_kw, want, wave_of=None) -> list:
    """The bench render of a route until its first build_pair_tables call
    of each label in `want` ("closest" / "shadow": the fallback query that
    made it); [(label, args, kw)]."""
    from path_tracer_ai_tpu_torch.accel import pairs
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import wavefront
    from path_tracer_ai_tpu_torch.scene.camera import default_camera

    state = {"wave": None}
    reals = {k: getattr(pairs, k) for k in ("closest_hit_pairs",
                                            "any_hit_pairs")}

    def tagged(name):
        def fn(*a, **kw):
            state["wave"] = "closest" if name == "closest_hit_pairs" \
                else "shadow"
            return reals[name](*a, **kw)
        return fn

    keeper = _KeepCalls(pairs, "build_pair_tables",
                        lambda a, kw: state["wave"], want)
    try:
        for k in reals:
            setattr(pairs, k, tagged(k))
        with keeper:
            wavefront.render(scene, default_camera("cuda"),
                             RenderSettings(**BENCH), wave_size=1 << 20,
                             device="cuda", accel=accel, **render_kw)
    finally:
        for k, fn in reals.items():
            setattr(pairs, k, fn)
    return keeper.calls


def _pair_args(args, kw) -> tuple:
    """pair_tables' arguments (accel, o, d, t_min, t_max, cap, pair_budget,
    tile_rays, pair_align) of a kept build_pair_tables call."""
    import inspect

    from path_tracer_ai_tpu_torch.accel import pairs

    b = inspect.signature(pairs.build_pair_tables).bind(*args, **kw)
    b.apply_defaults()
    a = b.arguments
    return (a["accel"], a["origins"].contiguous(),
            a["directions"].contiguous(), a["t_min"],
            a["t_max"].contiguous(), a["cap"], a["pair_budget"],
            a["tile_rays"], a["pair_align"])


def _pair_work(call, got) -> dict:
    """Bytes (the rays and boxes in once, the tables out once) and
    operations (PERRAY_TEST_OPS over the boxes each ray must test: none
    for a dead ray or an empty window, else every box up to the one past
    cap) of one pair_tables call."""
    from path_tracer_ai_tpu_torch.accel import cuda_cull

    accel, o, d, t_min, tm, cap = call[:6]
    n, c = o.shape[0], accel.num_clusters
    step = max(1, RCULL_ROW_ELEMS // c)
    tests = 0
    for lo in range(0, n, step):
        oc, dc, tc = o[lo:lo + step], d[lo:lo + step], tm[lo:lo + step]
        cand = cuda_cull.perray_slab_plain(accel, oc, dc, tc, t_min)[0]
        some = (tc >= 0.0) & (tc >= t_min)
        tests += int(torch.where(some, _first_past(cand, cap), 0).sum())
    ops = tests * PERRAY_TEST_OPS
    nbytes = n * 28 + c * 24 + _nbytes(*got)
    by_bytes = nbytes / PEAK_BYTES_PER_S
    by_ops = ops / PEAK_F32_PER_S
    return {"bytes": nbytes, "operations": ops, "box_tests": tests,
            "box_tests_per_ray": tests / max(1, n),
            "bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _check_pairs(label, call, reps=PAIR_REPS) -> dict:
    """pair_tables on a kept call against its plain version on the card
    (the eager body of before): every field bit for bit; timed beside its
    bound and the plain version."""
    from path_tracer_ai_tpu_torch.accel import cuda_cull

    got = cuda_cull.pair_tables(*call)
    want = cuda_cull.pair_tables_plain(*call)
    torch.cuda.synchronize()
    same = all(a.dtype == b.dtype and bool(torch.equal(a, b))
               for a, b in zip(got, want))
    n = call[1].shape[0]
    res = {"input": label, "rays": n, "C": call[0].num_clusters,
           "cap": call[5], "pair_budget": call[6], "tile_rays": call[7],
           "P": got[0].shape[0], "live_tiles": int(got[5]),
           "rays_per_tile": cuda_cull.pair_tile_rays(n),
           "candidates_mean": float(got[3].float().mean()),
           "overflow_share": float(got[4].float().mean()),
           "matches_plain": same, "max_abs_err": 0.0,
           "ms": cuda_ms(lambda: cuda_cull.pair_tables(*call), reps),
           "plain_ms": cuda_ms(lambda: cuda_cull.pair_tables_plain(*call),
                               2)}
    res.update(_pair_work(call, got))
    res["ms_over_bound"] = res["ms"] / res["bound_ms"]
    return res


def _cull2_work(call, got) -> dict:
    """Bytes (the live blocks' rays, the super and child boxes once, the
    tables out) and operations of one levels-2 block_cull call: per live
    block, each super up to the one past scap tested against the block's
    rays with a window up to the first that passes (CULL_OPS a test,
    kslots' rule), and where the block keeps its supers each listed
    super's children up to the one past kx, the same way (PERRAY_TEST_OPS
    a test)."""
    from path_tracer_ai_tpu_torch.accel import worklist
    from path_tracer_ai_tpu_torch.accel.kslots import _ray_slab

    (accel, o_blk, d_blk, tm_blk, t_min, cap, live), kw = call
    nb, b = o_blk.shape[:2]
    lb = nb if live is None else int(live)
    cs, ss, c = accel.num_supers, accel.super_size, accel.num_clusters
    scap = min(kw.get("super_cap", 48), cs)
    kx = min(cap, scap * ss, c)
    step = max(1, (1 << 22) // (b * max(cs, scap * ss)))
    super_tests = child_tests = 0

    def needed(mask, lc):
        """[rows, b, k] passes, lc [rows, b] live rays so far -> the live
        rays a (row, box) needs: those up to its first passing ray, or
        all of them."""
        first = torch.argmax(mask.to(torch.int8), dim=1)
        return torch.where(mask.any(dim=1), torch.gather(lc, 1, first),
                           lc[:, -1:])

    k_child = scap * ss
    for lo in range(0, lb, step):
        hi = min(lo + step, lb)
        rows = hi - lo
        oc, dc = o_blk[lo:hi], d_blk[lo:hi]
        tf = tm_blk[lo:hi].reshape(-1)
        hi0 = torch.where(tf >= 0.0, tf, -float("inf"))
        lo0 = torch.full_like(tf, float(t_min))
        rs = _ray_slab(accel.sbmin, accel.sbmax, oc.reshape(-1, 3),
                       dc.reshape(-1, 3), lo0, hi0).reshape(rows, b, cs)
        lc = torch.cumsum((hi0 >= t_min).reshape(rows, b).to(torch.int64),
                          dim=1)  # rays with a window, a dead ray none
        blk_s = rs.any(dim=1)
        n_s = _first_past(blk_s, scap)
        col = torch.arange(cs, device=o_blk.device)[None, :]
        super_tests += int(torch.where(col < n_s[:, None], needed(rs, lc),
                                       0).sum())
        # the children of the listed supers of the blocks that keep them,
        # in perray's rule against each ray's window
        keep = blk_s.sum(dim=1) <= scap
        sup = worklist._extract_k(blk_s & keep[:, None], scap, cs).long()
        sup_c = torch.clamp(sup, max=cs - 1)
        valid = (sup < cs).repeat_interleave(ss, dim=1)     # [rows, K]
        cb_lo = accel.cbmin[sup_c].reshape(rows, k_child, 3)
        cb_hi = accel.cbmax[sup_c].reshape(rows, k_child, 3)
        inv = 1.0 / dc
        lo_t = torch.full((rows, b, k_child), float(t_min),
                          device=o_blk.device)
        hi_t = hi0.reshape(rows, b)[:, :, None].expand(rows, b, k_child)
        for ax in range(3):
            inv_a = inv[:, :, None, ax]
            t0 = (cb_lo[:, None, :, ax] - oc[:, :, None, ax]) * inv_a
            t1 = (cb_hi[:, None, :, ax] - oc[:, :, None, ax]) * inv_a
            neg = inv_a < 0.0
            near = torch.where(neg, t1, t0)
            far = torch.where(neg, t0, t1)
            lo_t = torch.where(near > lo_t, near, lo_t)
            hi_t = torch.where(far < hi_t, far, hi_t)
        rc = (hi_t >= lo_t) & valid[:, None, :]
        k_t = torch.minimum(_first_past(rc.any(dim=1), kx), valid.sum(dim=1))
        colk = torch.arange(k_child, device=o_blk.device)[None, :]
        child_tests += int(torch.where(colk < k_t[:, None], needed(rc, lc),
                                       0).sum())
    ops = super_tests * CULL_OPS + child_tests * PERRAY_TEST_OPS
    nbytes = (lb * b * 7 * 4 + _nbytes(accel.sbmin, accel.sbmax,
                                       accel.cbmin, accel.cbmax, *got))
    by_bytes = nbytes / PEAK_BYTES_PER_S
    by_ops = ops / PEAK_F32_PER_S
    return {"live_blocks": lb, "super_tests": super_tests,
            "child_tests": child_tests, "bytes": nbytes, "operations": ops,
            "bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _check_cull2(label, call, reps=SLOT_REPS) -> dict:
    """block_cull at levels 2 on a kept call against its plain version on
    the card (the eager 2-level cull of before): exact; timed beside its
    bound and the plain version."""
    from path_tracer_ai_tpu_torch.accel import cuda_ctiles

    args, kw = call
    got = cuda_ctiles.block_cull(*args, **kw)
    want = cuda_ctiles.block_cull_plain(*args, **kw)
    torch.cuda.synchronize()
    nb, b = args[1].shape[:2]
    res = {"input": label, "blocks": nb, "b": b,
           "C": args[0].num_clusters, "supers": args[0].num_supers,
           "cap": args[5], "super_cap": kw.get("super_cap"),
           "matches_plain": all(bool(torch.equal(g, w))
                                for g, w in zip(got, want)),
           "max_abs_err": 0.0,
           "candidates_mean": float(got[1].float().mean()),
           "overflow_blocks": int(got[2].sum()),
           "ms": cuda_ms(lambda: cuda_ctiles.block_cull(*args, **kw), reps),
           "plain_ms": cuda_ms(
               lambda: cuda_ctiles.block_cull_plain(*args, **kw), 2)}
    res.update(_cull2_work(call, got))
    res["ms_over_bound"] = res["ms"] / res["bound_ms"]
    return res


def _crafted_pairs() -> list:
    """Both kernels on every crafted case (tests/test_torch_sweep_cases.py
    pair_case at its cap and one past it, at three ray tilings: the
    default, one ray a tile, one tile a call;
    ctiles2_case in blocks of 8 and 4, at its caps and one past each, with
    no live-block count and one inside the wave) against their plain
    versions on the CPU."""
    from types import SimpleNamespace

    from path_tracer_ai_tpu_torch.accel import cuda_ctiles, cuda_cull

    c = _cases()
    out = []
    box_keys = ("bmin", "bmax", "sbmin", "sbmax", "cbmin", "cbmax")
    for name in c.PAIR_CASES:
        case = c.pair_case(name)
        for cap in (case["cap"], case["cap"] + 1):
            calls = []
            for dev in ("cuda", "cpu"):
                t = lambda a: torch.as_tensor(a, device=dev)
                acc = SimpleNamespace(bmin=t(case["bmin"]),
                                      bmax=t(case["bmax"]),
                                      num_clusters=case["bmin"].shape[0])
                calls.append((acc, t(case["o"]), t(case["d"]), case["t_min"],
                              t(case["tm"]), cap, case["pair_budget"],
                              case["tile_rays"], case["pair_align"]))
            want = cuda_cull.pair_tables_plain(*calls[1])
            for tiling, tiles, least in (
                    ("default", cuda_cull.PAIR_TILES,
                     cuda_cull.PAIR_MIN_TILE_RAYS),
                    ("one_ray", 1 << 30, 1), ("one_tile", 1, 1)):
                with _patched(cuda_cull, PAIR_TILES=tiles,
                              PAIR_MIN_TILE_RAYS=least):
                    got = cuda_cull.pair_tables(*calls[0])
                out.append({"kernel": "pair_cull", "case": name, "cap": cap,
                            "tiling": tiling, "matches_plain": all(
                                bool(torch.equal(a.cpu(), b))
                                for a, b in zip(got, want))})
    for name in c.CTILES2_CASES:
        for b in c.CTILES2_BLOCKS:
            case = c.ctiles2_case(name, b)
            nb = case["o_blk"].shape[0]
            for cap, scap, lb in ((case["cap"], case["super_cap"], None),
                                  (case["cap"] + 1, case["super_cap"], None),
                                  (case["cap"], case["super_cap"] + 1, None),
                                  (case["kc"], case["ks"], None),
                                  (case["cap"], case["super_cap"],
                                   nb // 2 + 1)):
                res = []
                for dev in ("cuda", "cpu"):
                    t = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                                  device=dev)
                    acc = SimpleNamespace(
                        **{k: t(case[k]) for k in box_keys},
                        num_clusters=case["bmin"].shape[0],
                        num_supers=case["sbmin"].shape[0],
                        super_size=case["ss"])
                    bound = lb
                    if dev == "cuda" and lb is not None:
                        bound = torch.tensor([lb], dtype=torch.int32,
                                             device="cuda")
                    fn = (cuda_ctiles.block_cull if dev == "cuda"
                          else cuda_ctiles.block_cull_plain)
                    res.append(fn(acc, t(case["o_blk"]), t(case["d_blk"]),
                                  t(case["tm_blk"]), case["t_min"], cap,
                                  bound, levels=2, super_cap=scap))
                out.append({"kernel": "block_cull_2level", "case": name,
                            "b": b, "cap": cap, "super_cap": scap,
                            "live_blocks": lb, "matches_plain": all(
                                bool(torch.equal(g.cpu(), w))
                                for g, w in zip(*res))})
    return out


def phase_pair_cull(scene, accel_base, accel_c, scene_w, accel_w, card,
                    paths, occupancy) -> tuple:
    """The pair tables' kernels and ctiles' 2-level cull on the card (the
    docstring's 15c): kept calls and crafted cases, each bit for bit the
    plain version; ms, bound, plain ms, occupancy, launches by route.
    Returns the kernels line's checks (pair_cull: the worklist render's
    closest call; block_cull_2level: its first kept call)."""
    from path_tracer_ai_tpu_torch.accel import cuda_ctiles, cuda_cull
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import wavefront
    from path_tracer_ai_tpu_torch.scene.camera import default_camera

    t0 = time.perf_counter()
    eager_before = dict(EAGER_CALLS)
    kept = {
        "main": _keep_pair_calls(scene, accel_base,
                                 {"accel_closest": accel_c}, ["closest"]),
        "worklist": _keep_pair_calls(scene_w, accel_w, {"block_size": 64},
                                     ["closest", "shadow"]),
        "kslots": _keep_pair_calls(scene, accel_base, {"backend": "kslots"},
                                   ["closest"])}
    pair_calls = []
    labels = {"main": "main path's ctiles fallback",
              "worklist": "worklist render's fallback",
              "kslots": "kslots render's fallback"}
    for route, calls in kept.items():
        for wave, args, kw in calls:
            pair_calls.append((f"{labels[route]}, first {wave} call",
                               _pair_args(args, kw)))
    if not kept["kslots"]:
        rng = np.random.default_rng(23)
        o, d, tm = _bounce_wave(accel_base, KSLOTS_PAIR_RAYS, rng, False)
        pair_calls.append(("crafted 2^17-ray bounce wave at the kslots "
                           "fallback's shape (the kslots render made no "
                           "pair call)",
                           (accel_base, o, d, 1e-3, tm, 64, 12, 128, 256)))
    if len(kept["main"]) < 1 or len(kept["worklist"]) < 2:
        fail("pair_cull", f"kept pair calls: main {len(kept['main'])}, "
                          f"worklist {len(kept['worklist'])}")
    pairs_res = [_check_pairs(label, call) for label, call in pair_calls]
    # ctiles at levels 2 on the worklist scene: its first two block_cull
    # calls
    keeper = _KeepCalls(cuda_ctiles, "block_cull",
                        lambda a, kw: "l2" if kw.get("levels") == 2 else None,
                        ["l2"], per_label=2)
    with keeper:
        wavefront.render(scene_w, default_camera("cuda"),
                         RenderSettings(**BENCH), wave_size=1 << 20,
                         device="cuda", accel=accel_w, backend="ctiles")
    if len(keeper.calls) < 2:
        fail("pair_cull", "the ctiles render on the worklist scene made "
                          "fewer than two levels-2 culls")
    # the render's first closest wave (blocks of 8) and first shadow wave
    # (lane-major blocks of a lane's 4 rays), wave 0, bounce 0
    cull2_res = [_check_cull2(
        f"ctiles backend, worklist scene, wave 0, bounce 0, "
        f"{'closest' if args[1].shape[1] == 8 else 'shadow'}", (args, kw))
        for _l, args, kw in keeper.calls]
    crafted = _crafted_pairs()
    EAGER_CALLS.update(eager_before)  # the comparisons' own calls
    launches = {name: {route: v["launches"][name] for route, v in
                       paths.items() if isinstance(v.get("launches"), dict)
                       and name in v["launches"]}
                for name in ("pair_cull", "block_cull_2level")}
    occ = {k: occupancy[k] for k in ("pair_cull", "pair_scan", "pair_rank",
                                     "block_cull_2level b8")}
    res = {"phase": "pair_cull", "card": card, "pair_tables": pairs_res,
           "block_cull_2level": cull2_res, "occupancy": occ,
           "launches_by_route": launches, "crafted": len(crafted),
           "crafted_disagree": [x for x in crafted
                                if not x["matches_plain"]],
           "seconds": time.perf_counter() - t0}
    emit(res)
    if (not all(r["matches_plain"] for r in pairs_res + cull2_res)
            or res["crafted_disagree"]):
        fail("pair_cull", "a pair table or 2-level cull disagrees with its "
                          "plain version")
    keys = ("input", "ms", "plain_ms", "bound_ms", "bound_by",
            "ms_over_bound", "matches_plain")
    worklist_closest = next(r for r in pairs_res
                            if r["input"].startswith("worklist") and
                            "closest" in r["input"])
    return ({**worklist_closest,
             "matches_plain": all(r["matches_plain"] for r in pairs_res),
             "waves": [{k: r[k] for k in keys + ("rays", "C", "cap",
                                                 "candidates_mean",
                                                 "overflow_share")}
                       for r in pairs_res]},
            {**cull2_res[0],
             "matches_plain": all(r["matches_plain"] for r in cull2_res),
             "waves": [{k: r[k] for k in keys + ("blocks", "C",
                                                 "candidates_mean",
                                                 "overflow_blocks")}
                       for r in cull2_res]})


# --- the packet cascade's and perray's first-slot sweeps --------------------

# Calls of the eager sweep helpers (traverse._packet_sweep_closest and
# _packet_sweep_any), of the per-ray culls' plain versions
# (cuda_cull.kslots_cull_plain, perray_cull_plain, pair_tables_plain) and
# of the eager 2-level cull (ctiles._block_candidates_2level) since
# _spy_eager_sweeps: on the card every cascade sweeps and every per-ray
# list is culled through a kernel, so the route phases must leave all six
# at 0 (packet_cascade's, ray_cull's, pair_cull's and path_ctiles' "before"
# runs put their own calls back).
EAGER_CALLS = {}

# The closest fallbacks' whole-wave packet cascades kept from the worklist
# render (item_waves) and the kslots render (path_kslots): (args, kw) of
# their first two traverse.closest_hit_packets calls.
KEPT_FALLBACKS = {"worklist": [], "kslots": []}


def _spy_eager_sweeps() -> None:
    from path_tracer_ai_tpu_torch.accel import ctiles, cuda_cull, traverse

    for mod, name in ((traverse, "_packet_sweep_closest"),
                      (traverse, "_packet_sweep_any"),
                      (cuda_cull, "kslots_cull_plain"),
                      (cuda_cull, "perray_cull_plain"),
                      (cuda_cull, "pair_tables_plain"),
                      (cuda_cull, "exact_cull_plain"),
                      (cuda_cull, "perray_entry_plain"),
                      (ctiles, "_block_candidates_2level")):
        EAGER_CALLS[name] = 0

        def spy(*a, _real=getattr(mod, name), _name=name, **kw):
            EAGER_CALLS[_name] += 1
            return _real(*a, **kw)

        setattr(mod, name, spy)


class _KeepFirst:
    """While entered, mod.name keeps copies of the arguments of its first
    call for which want(args, kw) holds (self.args, self.kw)."""

    def __init__(self, mod, name, want):
        self.mod, self.name, self.want = mod, name, want
        self.args = self.kw = None

    def __enter__(self):
        self.real = real = getattr(self.mod, self.name)

        def keep(*a, **kw):
            if self.args is None and self.want(a, kw):
                self.args = tuple(x.clone() if torch.is_tensor(x) else x
                                  for x in a)
                self.kw = dict(kw)
            return real(*a, **kw)

        setattr(self.mod, self.name, keep)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.real)


def _check_first(name, run, plain, args, stats, nbytes, wave, reps=20):
    """A first-slot instance (run(*args)) against its plain version
    (plain(*args, stats=...)): bitwise t, exact tri; timed beside its bound
    over the needed tests (stats["tests"]) and its plain version; its
    generic instance (forced) on the same arguments, bitwise and timed."""
    from path_tracer_ai_tpu_torch.accel import cuda_ctiles

    k = run(*args)
    p = plain(*args, stats=stats)
    torch.cuda.synchronize()
    ok = _same_outputs(k, p)
    ms = cuda_ms(lambda: run(*args), reps)
    with _generic_instances():
        gen_ok = _same_outputs(run(*args), p)
        gen_ms = cuda_ms(lambda: run(*args), reps)
    plain_ms = cuda_ms(lambda: plain(*args), 1)
    hits = int((k[1] != cuda_ctiles.I32_MAX).sum())
    res = {"phase": "packet_cascade", "name": name, "wave": wave,
           "hits": hits, "matches_plain": ok,
           "max_abs_err": _max_abs_err(k[0], p[0]), "ms": ms,
           "plain_ms": plain_ms, **_bound(nbytes, stats["tests"]),
           "generic_ms": gen_ms, "generic_matches_plain": gen_ok}
    res["ms_over_bound"] = ms / res["bound_ms"]
    res["generic_over_bound"] = gen_ms / res["bound_ms"]
    return res


def _check_first_tile(args, wave) -> dict:
    """tile_sweep's first-slot instance on one cascade iteration's launch
    (pack, rays [nt, 8, T] with t_max = min(t_max, best t), tile_cid
    [nt, G]); bound over the live lanes' G x S tests."""
    from path_tracer_ai_tpu_torch.accel import cuda_ctiles

    pack, rays, cid = args
    nt, _, t_lanes = rays.shape
    s = pack.shape[2]
    stats = {}

    def plain(*a, stats=None):
        got = cuda_ctiles.tile_sweep_plain(*a, stats=stats, tie="slot")
        if stats is not None:
            stats["tests"] = stats["lane_tests"]
        return got

    nbytes = (int(torch.unique(cid).numel()) * 10 * s * 4
              + _nbytes(rays, cid) + nt * t_lanes * 8)
    res = _check_first(
        "tile_sweep_first",
        lambda *a: cuda_ctiles.tile_sweep(*a, tie="slot"), plain, args,
        stats, nbytes, wave)
    res.update(T=t_lanes, S=s, G=cid.shape[1], nt=nt,
               live_lanes=int((rays[:, 6] >= 0).sum()))
    return res


def _check_first_kslot(args, wave) -> dict:
    """kslot_sweep's first-slot instance on one perray iteration's launch
    (pack, rays [n, 8] with t_max = min(t_max, best t), cid [n, g],
    n_slots = g); bound over the live rays' slots x S tests."""
    from path_tracer_ai_tpu_torch.accel import cuda_kslots

    pack, rays, cid, n_slots = args[:4]
    s = pack.shape[2]
    nbytes = (int(torch.unique(cid).numel()) * 10 * s * 4
              + _nbytes(rays, cid, n_slots) + rays.shape[0] * 8)
    res = _check_first(
        "kslot_sweep_first",
        lambda *a: cuda_kslots.kslot_sweep(*a, True, tie="slot"),
        lambda *a, stats=None: cuda_kslots.kslot_sweep_plain(
            *a, True, stats=stats, tie="slot"),
        (pack, rays, cid, n_slots), {}, nbytes, wave)
    res.update(rays=rays.shape[0], K=cid.shape[1], S=s,
               live_rays=int((rays[:, 6] >= rays[:, 7]).sum()))
    return res


def _host_stepped():
    """While entered, the packet cascades' stages run the host-stepped loop
    that the card ran before the stage kernel: cascade_stage_plain with
    tile_sweep (one launch an iteration, one host read a vote)."""
    from functools import partial

    from path_tracer_ai_tpu_torch.accel import cuda_cascade, cuda_ctiles

    return _patched(cuda_cascade, cascade_stage=partial(
        cuda_cascade.cascade_stage_plain,
        sweep=lambda *a, **k: cuda_ctiles.tile_sweep(*a, **k)))


def _device_kernels(fn) -> int:
    """Device kernels and copies of one fn() under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return int(sum(e.count for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")
                   and not _is_label(e.key)))


def _loop_run(fn, args, kw) -> tuple:
    """fn(*args, **kw) once (a packet cascade): (result, {device seconds
    (CUDA events), wall seconds, host reads, the final k of its last
    cascade, tile_sweep_first launches}); the device kernels of a second
    run under torch.profiler."""
    from path_tracer_ai_tpu_torch.accel import cuda_cascade, cuda_ctiles
    from path_tracer_ai_tpu_torch.utils import sync

    ks = []
    real = cuda_cascade.cascade_stage

    def stage(*a, **k):
        out = real(*a, **k)
        ks.append(out[1])
        return out

    ev = lambda: torch.cuda.Event(enable_timing=True)
    with _patched(cuda_cascade, cascade_stage=stage):
        torch.cuda.synchronize()
        reads, slot = sync.count, cuda_ctiles.slot_launches
        start, end = ev(), ev()
        t0 = time.perf_counter()
        start.record()
        out = fn(*args, **kw)
        end.record()
        torch.cuda.synchronize()
        run = {"device_seconds": start.elapsed_time(end) / 1e3,
               "wall_seconds": time.perf_counter() - t0,
               "host_reads": sync.count - reads,
               "tile_sweep_first_launches": cuda_ctiles.slot_launches - slot,
               "final_k": int(ks[-1])}
        run["device_kernels"] = _device_kernels(lambda: fn(*args, **kw))
    return out, run


def _keep_stages(fn, args, kw) -> list:
    """Copies of the inputs of every cascade_stage call of fn(*args, **kw),
    in order, [(args, kw)]: the stage updates its carry and k in place, so
    each is copied before it runs."""
    from path_tracer_ai_tpu_torch.accel import cuda_cascade

    kept = []
    real = cuda_cascade.cascade_stage

    def stage(*a, **k):
        kept.append((tuple(tuple(c.clone() for c in x) if isinstance(x, tuple)
                           else x.clone() if torch.is_tensor(x) else x
                           for x in a),
                     {n: v.clone() for n, v in k.items()}))
        return real(*a, **k)

    with _patched(cuda_cascade, cascade_stage=stage):
        fn(*args, **kw)
    return kept


def _stage_bytes(rays, n_cand, carry, g, s, closest, stats) -> int:
    """The bytes a stage must move, each once: the rays, n_cand, act, the
    carry read and written, the swept blocks' candidate groups (and
    entries) and the swept clusters."""
    clusters = int(stats["clusters"].sum()) if "clusters" in stats else 0
    return (_nbytes(rays, n_cand) + rays.shape[0] + 2 * _nbytes(*carry)
            + stats.get("blocks", 0) * (g + int(closest)) * 4
            + clusters * 10 * s * 4)


def _stage_run(kept, stage, **extra):
    """One kept stage through `stage` on fresh copies of its carry and k:
    (carry..., k, act)."""
    (pack, rays, order_g, n_cand, carry, k, thr), kw = kept
    out = stage(pack, rays, order_g, n_cand, tuple(c.clone() for c in carry),
                k.clone(), thr, **kw, **extra)
    return (*out[0], out[1], out[2])


class _forced_split(_patched):
    """While entered, the stage kernel gives every slot W warps: its
    wrapper's rule (cuda_cascade.split_warps) answers w whatever the
    stage."""

    def __init__(self, w):
        from path_tracer_ai_tpu_torch.accel import cuda_cascade

        super().__init__(cuda_cascade, split_warps=lambda *a: w)


def _rule_w(rays, pack, any_hit) -> int:
    """The W the stage kernel's rule picks for a stage on these inputs."""
    from path_tracer_ai_tpu_torch.accel import cuda_cascade

    size, _, t_lanes = rays.shape
    return cuda_cascade.split_warps(size, t_lanes, *cuda_cascade._resident_warps(
        rays.device, pack.shape[2], t_lanes, any_hit))


def _stage_split(fn, args, kw, variants, reps=5, tail_plain=False):
    """Every stage of one packet cascade fn(*args, **kw), a row each: its
    slice size and threshold, k in and out, the active blocks at its first
    and at its last vote, its needed tests (live, unresolved lanes of the
    swept blocks x g x S, from the host-stepped loop with stats), its
    bound (_bound, as _check_stage's), the W the kernel's rule picks and,
    for each variant (name -> context manager factory: the stage kernel
    with some W forced), its device ms (CUDA events over `reps` runs on
    copies of the stage's inputs, the copy timed alone and taken off), its
    ms over the bound and whether its (carry, k, act) are the host-stepped
    loop's bits. tail_plain: on the first stage of 1,024 blocks or fewer
    that sweeps, each variant is also held against the plain version
    (eager sweeps, cascade_stage_plain as it is)."""
    from functools import partial

    from path_tracer_ai_tpu_torch.accel import cuda_cascade, cuda_ctiles

    rows = []
    for kept in _keep_stages(fn, args, kw):
        (pack, rays, order_g, n_cand, carry, k, thr), skw = kept
        stats = {}
        want = _stage_run(kept, partial(cuda_cascade.cascade_stage_plain,
                                        sweep=cuda_ctiles.tile_sweep,
                                        stats=stats))
        size, _kg, g = order_g.shape
        s = pack.shape[2]
        row = {"size": size, "threshold": thr, "k_in": int(k),
               "k_out": int(want[-2]), "active_first": stats["active"][0],
               "active_last": stats["active"][-1],
               "sweeps": stats.get("sweeps", 0),
               "rule_w": _rule_w(rays, pack, not skw),
               **_bound(_stage_bytes(rays, n_cand, carry, g, s, bool(skw),
                                     stats), stats.get("tests", 0))}
        eager = None
        if (tail_plain and size <= 1024 and row["sweeps"]
                and not any("eager_plain" in r for r in rows)):
            eager = _stage_run(kept, cuda_cascade.cascade_stage_plain)
            row["eager_plain"] = _same_outputs(want, eager)
        copy_ms = cuda_ms(lambda: tuple(c.clone() for c in carry)
                          + (k.clone(),), reps)
        for name, ctx in variants.items():
            with ctx():
                got = _stage_run(kept, cuda_cascade.cascade_stage)
                same = _same_outputs(got, want) and (
                    eager is None or _same_outputs(got, eager))
                ms = cuda_ms(lambda: _stage_run(
                    kept, cuda_cascade.cascade_stage), reps) - copy_ms
            row[name] = {"ms": ms, "ms_over_bound": ms / row["bound_ms"],
                         "matches_plain": same}
        rows.append(row)
    return rows


def _render_stage_bounds(scene, accel_base, accel_c) -> dict:
    """One main-path bench render with every cascade stage run by the
    host-stepped loop with stats: the stages, their needed tests and bytes
    and the sum of their bounds (each stage's _bound)."""
    from functools import partial

    from path_tracer_ai_tpu_torch.accel import cuda_cascade, cuda_ctiles
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import wavefront
    from path_tracer_ai_tpu_torch.scene.camera import default_camera

    tot = {"stages": 0, "tests": 0, "bytes": 0, "bound_ms": 0.0,
           "bound_by_operations": 0}

    def stage(pack, rays, order_g, n_cand, carry, k, thr, entry=None):
        stats = {}
        out = cuda_cascade.cascade_stage_plain(
            pack, rays, order_g, n_cand, carry, k, thr, entry=entry,
            sweep=cuda_ctiles.tile_sweep, stats=stats)
        b = _bound(_stage_bytes(rays, n_cand, carry, order_g.shape[2],
                                pack.shape[2], entry is not None, stats),
                   stats.get("tests", 0))
        tot["stages"] += 1
        tot["tests"] += b["tests"]
        tot["bytes"] += b["bytes"]
        tot["bound_ms"] += b["bound_ms"]
        tot["bound_by_operations"] += b["bound_by"] == "operations"
        return out

    t0 = time.perf_counter()
    with _patched(cuda_cascade, cascade_stage=stage):
        wavefront.render(scene, default_camera("cuda"),
                         RenderSettings(**BENCH), wave_size=1 << 20,
                         device="cuda", accel=accel_base,
                         accel_closest=accel_c)
    torch.cuda.synchronize()
    return {**tot, "seconds": time.perf_counter() - t0}


def _stage_calls(kept_shadows) -> list:
    """The cascades split by stage: the main path's two kept shadow calls
    (wave 0, bounces 0 and 1) and the worklist render's first kept
    first-slot closest fallback."""
    from path_tracer_ai_tpu_torch.accel import traverse

    return ([(f"main path shadow, wave 0, bounce {i}",
              traverse.any_hit_packets, c)
             for i, c in enumerate(kept_shadows[:2])]
            + [("worklist closest fallback 0", traverse.closest_hit_packets,
                c) for c in KEPT_FALLBACKS["worklist"][:1]])


# The parent design's stage kernel (a thread block owns its ray blocks for
# the stage, one warp a slot) split by stage on the H100 (NVIDIA H100 80GB
# HBM3, 700.00 W; this script's --stages at commit 37eb47e): for each kept
# cascade, (size, k in, k out, ms) a stage; and the render level, the
# profile's stage kernel seconds and the sum of the main render's stage
# bounds (ms).
PARENT_STAGES = {
    "main path shadow, wave 0, bounce 0": [
        (65536, 0, 2, 3.9885), (32768, 2, 2, 0.0852), (16384, 4, 5, 0.3837),
        (8192, 5, 8, 0.7151), (4096, 8, 11, 0.4692), (2048, 11, 38, 2.033),
        (1024, 38, 221, 7.0179), (512, 221, 321, 2.8173),
        (256, 321, 321, 0.0721), (128, 321, 321, 0.0673),
        (64, 321, 321, 0.0639), (32, 321, 321, 0.0669)],
    "main path shadow, wave 0, bounce 1": [
        (65536, 0, 2, 2.615), (32768, 2, 4, 1.3173), (16384, 5, 17, 5.2087),
        (8192, 17, 60, 10.3891), (4096, 60, 101, 6.3063),
        (2048, 101, 138, 3.64), (1024, 138, 179, 1.6786),
        (512, 179, 238, 1.6865), (256, 238, 307, 1.5985),
        (128, 307, 321, 0.3165), (64, 321, 321, 0.0666),
        (32, 321, 321, 0.0667)],
    "worklist closest fallback 0": [
        (16384, 0, 0, 0.0828), (8192, 0, 0, 0.0577), (4096, 0, 0, 0.0894),
        (2048, 0, 68, 18.5745), (1024, 68, 134, 11.2145),
        (512, 134, 216, 10.705), (256, 216, 299, 9.7613),
        (128, 299, 321, 2.571), (64, 321, 321, 0.0458),
        (32, 321, 321, 0.0415)],
}
PARENT_RENDER = {"stage_kernel_seconds": 0.4981, "stage_bound_ms": 84.458}


def _stage_table(label, rows) -> dict:
    """A kept cascade's stages beside the parent design's
    (PARENT_STAGES): the rule's W and its ms, the fastest forced W, and
    the parent's ms where the stage is the same (size, k in, k out)."""
    parent = {r[:3]: r[3] for r in PARENT_STAGES.get(label, [])}
    out = []
    for r in rows:
        forced = {w: r[f"w{w}"]["ms"] for w in (1, 2, 4, 8)}
        fastest = min(forced, key=forced.get)
        before = parent.get((r["size"], r["k_in"], r["k_out"]))
        out.append({
            **{k: r[k] for k in ("size", "threshold", "k_in", "k_out",
                                 "active_first", "active_last", "tests",
                                 "bound_ms", "bound_by", "rule_w")},
            "ms": forced[r["rule_w"]],
            "ms_over_bound": forced[r["rule_w"]] / r["bound_ms"],
            "ms_by_w": forced, "fastest_w": fastest,
            "rule_is_fastest": fastest == r["rule_w"] or not r["sweeps"],
            "rule_over_fastest": forced[r["rule_w"]] / forced[fastest],
            "matches_plain": all(r[f"w{w}"]["matches_plain"]
                                 for w in forced),
            **({"eager_plain": r["eager_plain"]} if "eager_plain" in r
               else {}),
            "parent_ms": before,
            "ms_over_parent": forced[r["rule_w"]] / before if before
            else None})
    return {"call": label, "stages": out,
            "ms": sum(x["ms"] for x in out),
            "parent_ms": sum(x["parent_ms"] or 0.0 for x in out),
            "bound_ms": sum(x["bound_ms"] for x in out)}


def phase_stage_split(scene, accel_base, accel_c, card, kept_shadows,
                      profile) -> dict:
    """Each stage of the kept cascades (_stage_calls) split
    (_stage_split), each W forced (each bit for bit the host-stepped loop,
    and the eager plain version on the first tail stage that sweeps),
    beside the parent design's (PARENT_STAGES; lines stage_split), and the
    render level: the stage kernel's seconds in the main path's profile
    beside the sum of the bounds of the main render's stages
    (_render_stage_bounds) and the parent's (line stage_split_render)."""
    t0 = time.perf_counter()
    variants = {f"w{w}": (lambda w=w: _forced_split(w)) for w in (1, 2, 4, 8)}
    tables = {}
    for label, fn, call in _stage_calls(kept_shadows):
        rows = _stage_split(fn, *call, variants=variants, tail_plain=True)
        tables[label] = _stage_table(label, rows)
        emit({"phase": "stage_split", "card": card, **tables[label]})
        bad = [r["size"] for r in tables[label]["stages"]
               if not (r["matches_plain"] and r.get("eager_plain", True))]
        if bad:
            fail("stage_split", f"{label}: the stages of {bad} blocks differ "
                                "from the plain version at some W")
    render = _render_stage_bounds(scene, accel_base, accel_c)
    prof = profile["path_kernels"]["cascade_stage_kernel"]
    res = {"phase": "stage_split_render", "card": card, **render,
           "profile_stage_kernel_seconds": prof["seconds"],
           "profile_stage_launches": prof["count"],
           "seconds_over_bound": prof["seconds"] / (render["bound_ms"] / 1e3),
           "parent": {**PARENT_RENDER, "seconds_over_bound":
                      PARENT_RENDER["stage_kernel_seconds"]
                      / (PARENT_RENDER["stage_bound_ms"] / 1e3)},
           "rule_is_fastest": all(r["rule_is_fastest"]
                                  for t in tables.values()
                                  for r in t["stages"]),
           "phase_seconds": time.perf_counter() - t0}
    emit(res)
    return {"tables": tables, "render": res}


def _loop_before_after(label, fn, call) -> dict:
    """One kept packet cascade (fn = traverse.any_hit_packets or
    closest_hit_packets) in turns: before (the host-stepped loop, the
    parent's route), after (the stage kernel), after, before. The two must
    give the same bits and the same final k."""
    args, kw = call
    runs = {"before": [], "after": []}
    outs = {}
    for which in ("before", "after", "after", "before"):
        if which == "before":
            with _host_stepped():
                out, r = _loop_run(fn, args, kw)
        else:
            out, r = _loop_run(fn, args, kw)
        runs[which].append(r)
        outs.setdefault(which, out)
    a, b = outs["before"], outs["after"]
    same = (_same_outputs((a.t, a.tri), (b.t, b.tri))
            if isinstance(a, tuple) else bool(torch.equal(a, b)))
    best = {w: {k: min(r[k] for r in runs[w]) for k in runs[w][0]}
            for w in runs}
    return {"call": label, "rays": int(args[1].shape[0]),
            "live_rays": int((torch.as_tensor(args[4]) >= 0).sum()),
            "block_size": kw.get("block_size"),
            "group_size": kw.get("group_size"),
            "same_bits": same,
            "same_final_k": all(r["final_k"] == runs["before"][0]["final_k"]
                                for w in runs for r in runs[w]),
            "runs": runs, "best": best,
            "device_over_before": best["after"]["device_seconds"]
            / best["before"]["device_seconds"]}


def _keep_sweeping_stage(fn, args, kw) -> tuple:
    """The arguments of the first cascade_stage call of fn(*args, **kw)
    that sweeps (k moves; a stage can end at once, under its threshold):
    copies, since the stage updates its carry and k in place."""
    from path_tracer_ai_tpu_torch.accel import cuda_cascade

    kept = []
    real = cuda_cascade.cascade_stage

    def stage(*a, **k):
        if kept:
            return real(*a, **k)
        copy = (tuple(tuple(c.clone() for c in x) if isinstance(x, tuple)
                      else x.clone() if torch.is_tensor(x) else x
                      for x in a),
                {n: v.clone() for n, v in k.items()})
        out = real(*a, **k)
        if int(out[1]) > int(copy[0][5]):
            kept.append(copy)
        return out

    with _patched(cuda_cascade, cascade_stage=stage):
        fn(*args, **kw)
    return kept[0]


def _check_stage(name, fn, call, wave, reps=10) -> dict:
    """The cascade stage kernel on the first stage of a kept cascade that
    sweeps: bitwise
    (carry, k, act) its plain version (tile_sweep's plain sweeps: eager
    torch only), tuned and generic (forced), at the W its rule picks and
    at each W forced (splits); timed beside its plain
    version and the host-stepped loop (the plain version sweeping through
    tile_sweep), and bounded over the needed tests: the live (any hit: not
    yet occluded) lanes of the sweeps x g x S, and the bytes of the rays,
    the candidate table, the carry (read and written), act and the swept
    clusters, each once. Each timed call first copies the carry and k
    (the stage updates them in place); that copy is timed alone and taken
    off."""
    from functools import partial

    from path_tracer_ai_tpu_torch.accel import cuda_cascade, cuda_ctiles

    (pack, rays, order_g, n_cand, carry, k, thr), kw = _keep_sweeping_stage(
        fn, *call)
    fresh = lambda: (tuple(c.clone() for c in carry), k.clone())

    def run(stage=None, **extra):
        c, k_ = fresh()
        return (stage or cuda_cascade.cascade_stage)(
            pack, rays, order_g, n_cand, c, k_, thr, **kw, **extra)

    def outputs(r):
        return (*r[0], r[1], r[2])

    stats = {}
    plain = outputs(run(cuda_cascade.cascade_stage_plain, stats=stats))
    got = outputs(run())
    torch.cuda.synchronize()
    ok = _same_outputs(got, plain)
    copy_ms = cuda_ms(fresh, reps)
    ms = cuda_ms(run, reps) - copy_ms
    with _generic_instances():
        gen_ok = _same_outputs(outputs(run()), plain)
        gen_ms = cuda_ms(run, reps) - copy_ms
    splits = {}
    for w in (1, 2, 4, 8):  # each W forced, tuned and generic
        with _forced_split(w):
            sp = {"matches_plain": _same_outputs(outputs(run()), plain),
                  "ms": cuda_ms(run, reps) - copy_ms}
            with _generic_instances():
                sp["generic_matches_plain"] = _same_outputs(outputs(run()),
                                                            plain)
                sp["generic_ms"] = cuda_ms(run, reps) - copy_ms
        splits[w] = sp
    plain_ms = cuda_ms(lambda: run(cuda_cascade.cascade_stage_plain), 1)
    stepped_ms = cuda_ms(lambda: run(partial(
        cuda_cascade.cascade_stage_plain, sweep=cuda_ctiles.tile_sweep)), 1)
    size, kgroups, g = order_g.shape
    s = pack.shape[2]
    k_end = int(plain[-2])
    nbytes = _stage_bytes(rays, n_cand, carry, g, s, bool(kw), stats)
    res = {"phase": "packet_cascade", "name": name, "wave": wave,
           "T": rays.shape[2], "S": s, "G": g, "blocks": size,
           "threshold": thr, "k_in": int(k), "k_out": k_end,
           "sweeps": stats.get("sweeps", 0),
           "W": _rule_w(rays, pack, not kw), "splits": splits,
           "matches_plain": ok and all(
               sp["matches_plain"] for sp in splits.values()),
           "generic_matches_plain": gen_ok and all(
               sp["generic_matches_plain"] for sp in splits.values()),
           "max_abs_err": (_max_abs_err(got[0], plain[0])
                           if got[0].dtype == torch.float32 else 0.0),
           "ms": ms, "copy_ms": copy_ms, "plain_ms": plain_ms,
           "host_stepped_ms": stepped_ms,
           **_bound(nbytes, stats.get("tests", 0)),
           "generic_ms": gen_ms}
    res["ms_over_bound"] = ms / res["bound_ms"]
    res["generic_over_bound"] = gen_ms / res["bound_ms"]
    return res


def _route_summary(res) -> dict:
    keys = ("size", "seconds", "mrays_per_s", "host_syncs",
            "stage_device_seconds")
    out = {k: res[k] for k in keys if k in res}
    out["launches"] = {k: v for k, v in res["launches"].items() if v}
    return out


def phase_packet_cascade(scene, accel_base, accel_c, card, img_main,
                         routes, kept_shadows, profile) -> tuple:
    """The packet cascades' loop on the card and the first-slot kernels.
    (1) The cascade stage kernel on the first stage that sweeps of the main
    path's first kept shadow call (any hit, T 64, G 2), of the worklist
    render's first kept closest fallback (first slot, T 64, G 8) and of a
    closest cascade at blocks of 256 on a 2^18-ray bounce wave (T 256, G
    8): bitwise
    its plain version, tuned and generic, timed beside its bound, its plain
    version and the host-stepped loop. (2) tile_sweep's first-slot instance
    (the host-stepped loop's sweep) on the first iteration of the same two
    closest cascades, run host-stepped; kslot_sweep's on the first launch
    of closest_hit_perray on a 2^16-ray bounce wave (K 4): each bitwise its
    plain version and its forced generic instance, timed beside its bound
    and its plain version. (3) The main path's two kept shadow calls (wave
    0, bounces 0 and 1) and the worklist's and the kslots render's kept
    whole-wave closest fallbacks, before (the host-stepped loop) and
    after (the stage kernel) in turns: the same bits and final k; device
    seconds, host reads and device kernels of each. (4) The "packets"
    route (blocks of 256) rendered as path_perray renders perray. (5) The
    eager sweep helpers ran 0 times in the route phases so far. Returns
    the kernel checks for the kernels line, the packets route and the
    host-stepped loop's tile_sweep_first launches."""
    from path_tracer_ai_tpu_torch.accel import cuda_ctiles, cuda_kslots, traverse

    eager_before = dict(EAGER_CALLS)
    rng = np.random.default_rng(14)
    checks = {}
    fb = KEPT_FALLBACKS["worklist"]
    if not fb or not kept_shadows:
        fail("packet_cascade", "no kept whole-wave closest fallback of the "
                               "worklist render or shadow call of the main "
                               "path")
    o, d, tm = _bounce_wave(accel_base, 1 << 18, rng, shadow=False)
    tm[::7] = -1.0
    t256 = ((accel_base, o, d, 1e-3, tm), {"block_size": 256})
    stages = {
        "cascade_stage_any": (traverse.any_hit_packets, kept_shadows[0],
                              "main path's shadow call, wave 0, bounce 0"),
        "cascade_stage_first": (traverse.closest_hit_packets, fb[0],
                                "worklist render's closest fallback"),
        "cascade_stage_first_t256": (traverse.closest_hit_packets, t256,
                                     "2^18 bounce rays, blocks of 256")}
    for key, (fn, call, wave) in stages.items():
        checks[key] = _check_stage(key.split("_t256")[0], fn, call,
                                   wave + ", first stage that sweeps")
    for key, (wave, call) in {
            "tile_sweep_first": ("worklist render's closest fallback", fb[0]),
            "tile_sweep_first_t256": ("2^18 bounce rays, blocks of 256",
                                      t256)}.items():
        with _host_stepped(), _KeepFirst(
                cuda_ctiles, "tile_sweep",
                lambda a, kw: kw.get("tie") == "slot") as kept:
            traverse.closest_hit_packets(*call[0], **call[1])
        checks[key] = _check_first_tile(
            kept.args, f"{wave}, host-stepped, first iteration")
    o, d, tm = _bounce_wave(accel_base, 1 << 16, rng, shadow=False)
    tm[::7] = -1.0
    with _perray_host_stepped(), _KeepFirst(
            cuda_kslots, "kslot_sweep",
            lambda a, kw: kw.get("tie") == "slot") as kept:
        traverse.closest_hit_perray(accel_base, o, d, 1e-3, tm)
    checks["kslot_sweep_first"] = _check_first_kslot(
        kept.args, "2^16 bounce rays, perray, first iteration")
    for c in checks.values():
        emit(c)
        if not (c["matches_plain"] and c["generic_matches_plain"]):
            fail("packet_cascade", f"{c['name']} disagrees with its plain "
                                   f"version on the {c['wave']} wave")
        if c.get("hits") == 0:
            fail("packet_cascade", f"{c['name']}: the {c['wave']} wave hit "
                                   "nothing")

    calls = ([(f"main path shadow, wave 0, call {i}", traverse.any_hit_packets,
               c) for i, c in enumerate(kept_shadows)]
             + [(f"{r} closest fallback {i}", traverse.closest_hit_packets, c)
                for r in ("worklist", "kslots")
                for i, c in enumerate(KEPT_FALLBACKS[r])])
    loops = [_loop_before_after(label, fn, call)
             for label, fn, call in calls]
    split = phase_stage_split(scene, accel_base, accel_c, card, kept_shadows,
                              profile)
    for f in loops:
        emit({"phase": "packet_cascade_loop", "card": card, **f})
    if not all(f["same_bits"] and f["same_final_k"] for f in loops):
        fail("packet_cascade", "a cascade's stage kernel differs from the "
                               "host-stepped loop (bits or final k)")
    stepped = {"tile_sweep_first": sum(
        r["tile_sweep_first_launches"] for f in loops
        for r in f["runs"]["before"])}

    packets = _route_at_cut("path_packets", scene, accel_base, accel_c,
                            card, img_main,
                            ["cascade_stage_first", "cascade_stage_any"],
                            backend="packets", block_size=256)
    routes = {**routes, "packets": packets}
    res = {"phase": "packet_cascade", "card": card,
           "eager_calls_in_route_phases": eager_before,
           "checks": {k: {x: c[x] for x in (
               "ms", "bound_ms", "ms_over_bound", "plain_ms", "generic_ms")}
               for k, c in checks.items()},
           "loops": [{"call": f["call"], "live_rays": f["live_rays"],
                      **{w: {x: f["best"][w][x] for x in (
                          "device_seconds", "host_reads", "device_kernels",
                          "final_k")} for w in ("before", "after")},
                      "device_over_before": f["device_over_before"]}
                     for f in loops],
           "host_stepped_launches": stepped,
           "stage_split": {k: {x: t[x] for x in ("ms", "parent_ms",
                                                 "bound_ms")}
                           for k, t in split["tables"].items()},
           "stage_split_render": {x: split["render"][x] for x in (
               "profile_stage_kernel_seconds", "bound_ms",
               "seconds_over_bound", "parent", "rule_is_fastest")},
           "routes": {k: _route_summary(v) for k, v in routes.items()}}
    emit(res)
    if any(eager_before.values()):
        fail("packet_cascade", f"the eager sweeps ran in a route phase on "
                               f"the card: {eager_before}")
    return checks, packets, stepped


def _keep_shadow_calls(scene, accel_base, accel_c) -> list:
    """(args, kw) copies of the main path's first two shadow calls
    (any_hit_packets: wave 0, bounces 0 and 1), from a bench render that
    stops once it has them."""
    from path_tracer_ai_tpu_torch.accel import traverse
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import wavefront
    from path_tracer_ai_tpu_torch.scene.camera import default_camera

    kept = {}
    real = _keeping(traverse, "any_hit_packets", kept, lambda a: "shadow")
    keeping = traverse.any_hit_packets

    def until_kept(*a, **kw):
        out = keeping(*a, **kw)
        if len(kept["shadow"]) >= 2:
            raise _Kept
        return out

    traverse.any_hit_packets = until_kept
    try:
        wavefront.render(scene, default_camera("cuda"),
                         RenderSettings(**BENCH), wave_size=1 << 20,
                         device="cuda", accel=accel_base,
                         accel_closest=accel_c)
    except _Kept:
        pass
    finally:
        traverse.any_hit_packets = real
    return kept.get("shadow", [])


# ---- the fused cascades' loop on the card ----------------------------------

# The calls of the fused cascades in the path phases since the last reset
# (_reset_counts), counted by _spy_fused_calls.
FUSED_CALLS = {"any_hit_fused": 0, "closest_hit_fused": 0}
# The fused route's bench render at commit d2f509c (this script's parent
# design, the loop stepped on the host; scripts/torch_route_timing.py
# --profile fused, H100 80GB HBM3, 700.00 W): host reads by kind, kernels.
FUSED_AT_D2F509C = {"host_reads": 6302, "votes": 3302, "range_checks": 2968,
                    "others": 32, "device_kernels": 130378}
FUSED_OTHER_READS_MAX = 32
# The fused route's kernels in its profile (substrings of their symbols):
# the stage kernel's two folds, and the standalone sweeps, which must not
# run there.
FUSED_KERNEL_TAGS = ["cascade_stage_kernel<FusedAny",
                     "cascade_stage_kernel<FusedClosest",
                     "block_closest_kernel", "block_anyhit_kernel"]
# The stage wrappers' module, whose only read on the fused route is the
# range check (raise_bad_ids).
FUSED_READ_SITE = "path_tracer_ai_tpu_torch.accel.cuda_cascade:"
# Modules in which the fused route may make no host read: the stage loop
# (votes) and the standalone kernels' range checks.
FUSED_NO_SYNC_MODULES = ("path_tracer_ai_tpu_torch.accel.traverse:",
                         "path_tracer_ai_tpu_torch.accel.cuda_anyhit:",
                         "path_tracer_ai_tpu_torch.accel.cuda_closest:")


def _spy_fused_calls() -> None:
    from path_tracer_ai_tpu_torch.accel import cuda_anyhit, cuda_closest

    for mod, name in ((cuda_anyhit, "any_hit_fused"),
                      (cuda_closest, "closest_hit_fused")):
        def spy(*a, _real=getattr(mod, name), _name=name, **kw):
            FUSED_CALLS[_name] += 1
            return _real(*a, **kw)

        setattr(mod, name, spy)


class _fused_host_stepped(_patched):
    """While entered, the fused cascades' stages run the host-stepped loop
    that the card ran before the stage kernel: fused_stage_plain sweeping
    through block_anyhit / block_closest (one launch an iteration, one host
    read a vote)."""

    def __init__(self):
        from path_tracer_ai_tpu_torch.accel import cuda_cascade

        super().__init__(cuda_cascade,
                         fused_stage=cuda_cascade.fused_stage_plain)


def _keep_fused_calls(scene, accel_base) -> list:
    """(label, fn, (args, kw)) copies of the fused route's wave 0, bounce 1
    calls, the shadow call (any_hit_fused) and the closest call
    (closest_hit_fused), from a fused bench render that stops once it has
    them."""
    from path_tracer_ai_tpu_torch.accel import cuda_anyhit, cuda_closest
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import wavefront
    from path_tracer_ai_tpu_torch.scene.camera import default_camera

    kept = {"shadow": [], "closest": []}
    real = {"shadow": (cuda_anyhit, "any_hit_fused"),
            "closest": (cuda_closest, "closest_hit_fused")}
    saved = {k: getattr(*v) for k, v in real.items()}

    def keeping(kind):
        def fn(*a, **kw):
            copy = lambda x: x.clone() if torch.is_tensor(x) else x
            kept[kind].append((tuple(copy(x) for x in a),
                               {n: copy(v) for n, v in kw.items()}))
            out = saved[kind](*a, **kw)
            if len(kept["shadow"]) >= 2 and len(kept["closest"]) >= 2:
                raise _Kept
            return out
        return fn

    for kind, (mod, name) in real.items():
        setattr(mod, name, keeping(kind))
    try:
        with _engines(FUSED_ENGINES):
            wavefront.render(scene, default_camera("cuda"),
                             RenderSettings(**BENCH), wave_size=1 << 20,
                             device="cuda", accel=accel_base)
    except _Kept:
        pass
    finally:
        for kind, (mod, name) in real.items():
            setattr(mod, name, saved[kind])
    if len(kept["shadow"]) < 2 or len(kept["closest"]) < 2:
        fail("fused_cascade", "the fused bench render made fewer than two "
                              "calls of a fused cascade")
    return [("fused shadow, wave 0, bounce 1", saved["shadow"],
             kept["shadow"][1]),
            ("fused closest, wave 0, bounce 1", saved["closest"],
             kept["closest"][1])]


def _keep_fused_stages(fn, args, kw) -> list:
    """Copies of the inputs of every fused_stage call of fn(*args, **kw), in
    order, [(args, kw)] (the stage updates its carry and k in place), each
    with error words of its own."""
    from path_tracer_ai_tpu_torch.accel import cuda_cascade

    kept = []
    real = cuda_cascade.fused_stage
    copy = lambda x: x.clone() if torch.is_tensor(x) else x

    def stage(*a, **k):
        # error words of the stage's own, never read, as the cascade's are
        # read once after its last stage
        kept.append((tuple(tuple(copy(c) for c in x) if isinstance(x, tuple)
                           else copy(x) for x in a),
                     {**{n: copy(v) for n, v in k.items() if n != "err"},
                      "err": cuda_cascade.new_error(a[1].device)}))
        return real(*a, **k)

    with _patched(cuda_cascade, fused_stage=stage):
        fn(*args, **kw)
    return kept


def _fused_stage_run(kept, stage, **extra):
    """One kept fused stage through `stage` on fresh copies of its carry
    and k: (carry..., k, act)."""
    (pack, rays, order_g, n_cand, carry, k, thr), kw = kept
    out = stage(pack, rays, order_g, n_cand, tuple(c.clone() for c in carry),
                k.clone(), thr, **kw, **extra)
    return (*out[0], out[1], out[2])


def _fused_stage_bytes(rays, n_cand, carry, s, closest, stats) -> int:
    """The bytes a fused stage must move, each once: the rays, n_cand, act,
    the carry read and written, the swept blocks' candidate groups (and
    entries) and the swept clusters' [16, S] packs."""
    clusters = int(stats["clusters"].sum()) if "clusters" in stats else 0
    return (_nbytes(rays, n_cand) + rays.shape[0] + 2 * _nbytes(*carry)
            + stats.get("blocks", 0) * (8 + int(closest)) * 4
            + clusters * 16 * s * 4)


def _fused_stage_table(fn, args, kw, reps=5) -> list:
    """Every stage of one fused cascade fn(*args, **kw), a row each: its
    slice size and threshold, k in and out, the active blocks at its first
    and at its last vote, its needed tests (the plain sweeps' lane_tests:
    open lanes x the swept sub-slab rows), its bound, the host-stepped
    loop's ms (fused_stage_plain with the standalone kernels; one run, host
    reads included), the stage kernel's ms (CUDA events over `reps` runs on
    copies, the copy timed alone and taken off), and whether the kernel's
    (carry, k, act) are the host-stepped loop's bits and the plain
    version's (eager sweeps)."""
    from functools import partial

    from path_tracer_ai_tpu_torch.accel import (
        cuda_anyhit,
        cuda_closest,
        cuda_cascade,
    )

    rows = []
    for kept in _keep_fused_stages(fn, args, kw):
        (pack, rays, order_g, n_cand, carry, k, thr), skw = kept
        closest = "entry" in skw
        stats = {}
        eager = _fused_stage_run(kept, partial(
            cuda_cascade.fused_stage_plain, stats=stats))
        stepped = _fused_stage_run(kept, cuda_cascade.fused_stage_plain)
        stepped_ms = cuda_ms(lambda: _fused_stage_run(
            kept, cuda_cascade.fused_stage_plain), 1)
        got = _fused_stage_run(kept, cuda_cascade.fused_stage)
        copy_ms = cuda_ms(lambda: tuple(c.clone() for c in carry)
                          + (k.clone(),), reps)
        ms = cuda_ms(lambda: _fused_stage_run(
            kept, cuda_cascade.fused_stage), reps) - copy_ms
        s = pack.shape[2]
        row = {"size": rays.shape[0], "T": rays.shape[2], "S": s,
               "threshold": thr, "k_in": int(k),
               "k_out": int(stepped[-2]), "active_first": stats["active"][0],
               "active_last": stats["active"][-1],
               "sweeps": stats.get("sweeps", 0),
               "blocks_swept": stats.get("blocks", 0),
               **_bound(_fused_stage_bytes(rays, n_cand, carry, s, closest,
                                           stats),
                        stats.get("lane_tests", 0)),
               "host_stepped_ms": stepped_ms, "ms": ms,
               "matches_host_stepped": _same_outputs(got, stepped),
               "matches_plain": _same_outputs(got, eager)
               and _same_outputs(stepped, eager),
               "max_abs_err": (_max_abs_err(got[0], eager[0])
                               if closest else 0.0)}
        row["ms_over_bound"] = ms / row["bound_ms"]
        row["host_stepped_over_bound"] = stepped_ms / row["bound_ms"]
        if not rows or not any(r.get("check") for r in rows):
            if row["sweeps"]:
                # the kernels line's check: the first stage that sweeps,
                # its plain version timed once
                row["check"] = True
                row["plain_ms"] = cuda_ms(lambda: _fused_stage_run(
                    kept, partial(cuda_cascade.fused_stage_plain,
                                  sweep=(cuda_closest.block_closest_plain
                                         if closest else
                                         cuda_anyhit.block_anyhit_plain))),
                    1)
        rows.append(row)
    return rows


def _render_fused_stage_bounds(scene, accel_base) -> dict:
    """One fused bench render with every stage run by the plain version
    with stats (eager sweeps on the card): by fold, the stages, their
    needed tests and bytes and the sum of their bounds (each stage's
    _bound, as _fused_stage_table's)."""
    from functools import partial

    from path_tracer_ai_tpu_torch.accel import cuda_cascade
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import wavefront
    from path_tracer_ai_tpu_torch.scene.camera import default_camera

    tot = {name: {"stages": 0, "sweeps": 0, "tests": 0, "bytes": 0,
                  "bound_ms": 0.0, "bound_by_operations": 0}
           for name in cuda_cascade.FUSED_NAMES.values()}
    real = cuda_cascade.fused_stage_plain

    def stage(pack, rays, order_g, n_cand, carry, k, thr, entry=None, **kw):
        stats = {}
        out = partial(real, stats=stats)(pack, rays, order_g, n_cand, carry,
                                         k, thr, entry=entry, **kw)
        b = _bound(_fused_stage_bytes(rays, n_cand, carry, pack.shape[2],
                                      entry is not None, stats),
                   stats.get("lane_tests", 0))
        t = tot[cuda_cascade.FUSED_NAMES[entry is None]]
        t["stages"] += 1
        t["sweeps"] += stats.get("sweeps", 0)
        t["tests"] += b["tests"]
        t["bytes"] += b["bytes"]
        t["bound_ms"] += b["bound_ms"]
        t["bound_by_operations"] += b["bound_by"] == "operations"
        return out

    t0 = time.perf_counter()
    with _patched(cuda_cascade, fused_stage=stage), \
            _engines(FUSED_ENGINES):
        wavefront.render(scene, default_camera("cuda"),
                         RenderSettings(**BENCH), wave_size=1 << 20,
                         device="cuda", accel=accel_base)
    torch.cuda.synchronize()
    return {"folds": tot, "seconds": time.perf_counter() - t0}


def phase_fused_stage_render(scene, accel_base, card, profile) -> dict:
    """The fused route's render level (--fused-stages): each fold's
    seconds in the fused profile beside the sum of the bounds of the fused
    bench render's stages (_render_fused_stage_bounds)."""
    render = _render_fused_stage_bounds(scene, accel_base)
    res = {"phase": "fused_stage_render", "card": card, **render}
    for name, fold in render["folds"].items():
        tag = ("cascade_stage_kernel<FusedAny" if name == "fused_stage_any"
               else "cascade_stage_kernel<FusedClosest")
        prof = profile["path_kernels"][tag]
        fold.update({"profile_seconds": prof["seconds"],
                     "profile_launches": prof["count"],
                     "seconds_over_bound": prof["seconds"]
                     / (fold["bound_ms"] / 1e3)})
    emit(res)
    return res


def _fused_call_run(fn, args, kw) -> tuple:
    """fn(*args, **kw) once (a fused cascade): (result, {device seconds
    (CUDA events), wall seconds, host reads, the final k of its last stage,
    stage kernel, block_anyhit and block_closest launches}); the device
    kernels of a second run under torch.profiler."""
    from path_tracer_ai_tpu_torch.accel import (
        cuda_anyhit,
        cuda_closest,
        cuda_cascade,
    )
    from path_tracer_ai_tpu_torch.utils import sync

    ks = []
    real = cuda_cascade.fused_stage
    stage_launches = lambda: sum(cuda_cascade.launches[n] for n in
                                 cuda_cascade.FUSED_NAMES.values())

    def stage(*a, **k):
        out = real(*a, **k)
        ks.append(out[1])
        return out

    ev = lambda: torch.cuda.Event(enable_timing=True)
    with _patched(cuda_cascade, fused_stage=stage):
        torch.cuda.synchronize()
        reads = sync.count
        counts = (stage_launches(),
                  cuda_anyhit.launches, cuda_closest.launches)
        start, end = ev(), ev()
        t0 = time.perf_counter()
        start.record()
        out = fn(*args, **kw)
        end.record()
        torch.cuda.synchronize()
        run = {"device_seconds": start.elapsed_time(end) / 1e3,
               "wall_seconds": time.perf_counter() - t0,
               "host_reads": sync.count - reads,
               "stage_launches": stage_launches() - counts[0],
               "block_anyhit_launches": cuda_anyhit.launches - counts[1],
               "block_closest_launches": cuda_closest.launches - counts[2],
               "final_k": int(ks[-1]), "stages": len(ks)}
        run["device_kernels"] = _device_kernels(lambda: fn(*args, **kw))
    return out, run


def _fused_before_after(label, fn, call) -> dict:
    """One kept fused cascade in turns: before (the host-stepped loop, the
    parent's route), after (the stage kernel), after, before. All must
    give the same bits and the same final k."""
    args, kw = call
    runs = {"before": [], "after": []}
    outs = {}
    for which in ("before", "after", "after", "before"):
        if which == "before":
            with _fused_host_stepped():
                out, r = _fused_call_run(fn, args, kw)
        else:
            out, r = _fused_call_run(fn, args, kw)
        runs[which].append(r)
        outs.setdefault(which, out)
    flat = lambda o: ((o.hit, o.t, o.tri) if isinstance(o, tuple) else (o,))
    same = _same_outputs(flat(outs["after"]), flat(outs["before"]))
    best = {w: {k: min(r[k] for r in runs[w]) for k in runs[w][0]}
            for w in runs}
    return {"call": label, "rays": int(args[1].shape[0]),
            "live_rays": int((torch.as_tensor(args[4]) >= 0).sum()),
            "same_bits": same,
            "same_final_k": all(r["final_k"] == runs["before"][0]["final_k"]
                                for w in runs for r in runs[w]),
            "runs": runs, "best": best,
            "device_over_before": best["after"]["device_seconds"]
            / best["before"]["device_seconds"]}


def phase_fused_cascade(scene, accel_base, card, img_main) -> tuple:
    """The fused cascades' loop on the card. (1) The fused route's two kept
    calls (wave 0, bounce 1: the shadow call and the closest call), each
    split by stage (_fused_stage_table; lines fused_cascade_stages): the
    stage kernel bit for bit the host-stepped loop and the plain version
    at every stage. (2) Each kept call whole, before (the host-stepped
    loop) and after (the stage kernel) in turns: the same bits and final
    k; device seconds, host
    reads and device kernels (lines fused_cascade_loop). Returns the
    kernel checks for the kernels line (each fold's first stage that
    sweeps) and the host-stepped loop's block_anyhit / block_closest
    launches."""
    from path_tracer_ai_tpu_torch.accel import cuda_cascade

    t0 = time.perf_counter()
    calls = _keep_fused_calls(scene, accel_base)
    checks, tables, loops = {}, {}, []
    for label, fn, (args, kw) in calls:
        rows = _fused_stage_table(fn, args, kw)
        closest = "closest" in label
        tables[label] = rows
        emit({"phase": "fused_cascade_stages", "card": card, "call": label,
              "stages": rows, "bound_ms": sum(r["bound_ms"] for r in rows),
              "ms": sum(r["ms"] for r in rows),
              "host_stepped_ms": sum(r["host_stepped_ms"] for r in rows)})
        bad = [r["size"] for r in rows
               if not (r["matches_host_stepped"] and r["matches_plain"])]
        if bad:
            fail("fused_cascade", f"{label}: the stages of {bad} blocks "
                                  "differ from the host-stepped loop or the "
                                  "plain version")
        check = next((r for r in rows if r.get("check")), None)
        if check is None:
            fail("fused_cascade", f"{label}: no stage swept")
        name = cuda_cascade.FUSED_NAMES[not closest]
        checks[name] = {
            "name": name, "wave": f"{label}, first stage that sweeps",
            "T": check["T"], "S": check["S"], "G": 8,
            "blocks": check["size"], "k_in": check["k_in"],
            "k_out": check["k_out"], "sweeps": check["sweeps"],
            "ms": check["ms"], "plain_ms": check["plain_ms"],
            "host_stepped_ms": check["host_stepped_ms"],
            "bound_ms": check["bound_ms"], "bound_by": check["bound_by"],
            "tests": check["tests"], "bytes": check["bytes"],
            "ms_over_bound": check["ms_over_bound"],
            "matches_plain": check["matches_plain"]
            and check["matches_host_stepped"],
            "max_abs_err": check["max_abs_err"],
            "call_ms": sum(r["ms"] for r in rows),
            "call_bound_ms": sum(r["bound_ms"] for r in rows),
            "call_host_stepped_ms": sum(r["host_stepped_ms"] for r in rows)}
        loops.append(_fused_before_after(label, fn, (args, kw)))
    for f in loops:
        emit({"phase": "fused_cascade_loop", "card": card, **f})
    if not all(f["same_bits"] and f["same_final_k"] for f in loops):
        fail("fused_cascade", "a fused cascade's stage kernel differs from "
                              "the host-stepped loop (bits or final k)")
    stepped = {k: sum(r[f"{k}_launches"] for f in loops
                      for r in f["runs"]["before"])
               for k in ("block_anyhit", "block_closest")}
    if not all(stepped.values()):
        fail("fused_cascade", f"the host-stepped loop launched no "
                              f"standalone kernel: {stepped}")
    emit({"phase": "fused_cascade", "card": card,
          "checks": {k: {x: c[x] for x in (
              "ms", "bound_ms", "ms_over_bound", "plain_ms",
              "host_stepped_ms", "call_ms", "call_bound_ms",
              "call_host_stepped_ms")} for k, c in checks.items()},
          "loops": [{"call": f["call"], "live_rays": f["live_rays"],
                     **{w: {x: f["best"][w][x] for x in (
                         "device_seconds", "host_reads", "device_kernels",
                         "stage_launches", "final_k")}
                        for w in ("before", "after")},
                     "device_over_before": f["device_over_before"]}
                    for f in loops],
          "host_stepped_launches": stepped,
          "seconds": time.perf_counter() - t0})
    return checks, stepped


# ---- the perray queries' loop on the card ----------------------------------

class _perray_host_stepped(_patched):
    """While entered, the perray queries' stages run the host-stepped loop
    that the card ran before the stage kernel: perray_stage_plain sweeping
    through kslot_sweep (one launch an iteration, one host read a vote)."""

    def __init__(self):
        from path_tracer_ai_tpu_torch.accel import cuda_cascade

        super().__init__(cuda_cascade,
                         perray_stage=cuda_cascade.perray_stage_plain)


def _keep_perray_calls(scene, accel_base) -> list:
    """(label, fn, (args, kw)) copies of two calls of the perray bench
    render, which stops once it has them: the closest call on the first
    2^16 rays of wave 0, bounce 1 (closest_hit_perray's call 16: bounce 0
    takes 16 chunks of 2^16 camera rays) and the shadow call that follows
    it (any_hit_perray)."""
    from path_tracer_ai_tpu_torch.accel import traverse
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import wavefront
    from path_tracer_ai_tpu_torch.scene.camera import default_camera

    saved = {n: getattr(traverse, n)
             for n in ("closest_hit_perray", "any_hit_perray")}
    seen = {"closest_hit_perray": 0}
    kept = {}
    copy = lambda x: x.clone() if torch.is_tensor(x) else x

    def keeping(name):
        def fn(*a, **kw):
            if name == "closest_hit_perray":
                seen[name] += 1
            if ((name == "closest_hit_perray" and seen[name] == 17)
                    or (name == "any_hit_perray" and seen[
                        "closest_hit_perray"] >= 17 and name not in kept)):
                kept.setdefault(name, (tuple(copy(x) for x in a),
                                       {k: copy(v) for k, v in kw.items()}))
            out = saved[name](*a, **kw)
            if len(kept) == 2:
                raise _Kept
            return out
        return fn

    try:
        with _patched(traverse, **{n: keeping(n) for n in saved}):
            wavefront.render(scene, default_camera("cuda"),
                             RenderSettings(**BENCH), wave_size=1 << 20,
                             device="cuda", accel=accel_base,
                             backend="perray")
    except _Kept:
        pass
    if len(kept) < 2:
        fail("perray_cascade_loop", f"the perray bench render made no "
                                    f"wave 0, bounce 1 calls: {seen}")
    return [("perray closest, wave 0, bounce 1", saved["closest_hit_perray"],
             kept["closest_hit_perray"]),
            ("perray shadow, wave 0, bounce 1", saved["any_hit_perray"],
             kept["any_hit_perray"])]


def _keep_perray_stages(fn, args, kw) -> list:
    """Copies of the inputs of every perray_stage call of fn(*args, **kw),
    in order, [(args, {})] (the stage updates its carry and k in place)."""
    from path_tracer_ai_tpu_torch.accel import cuda_cascade

    kept = []
    real = cuda_cascade.perray_stage
    copy = lambda x: x.clone() if torch.is_tensor(x) else x

    def stage(*a):
        kept.append((tuple(tuple(copy(c) for c in x) if isinstance(x, tuple)
                           else copy(x) for x in a), {}))
        return real(*a)

    with _patched(cuda_cascade, perray_stage=stage):
        fn(*args, **kw)
    return kept


def _perray_eager(any_hit, stats=None):
    """The perray folds' plain version on the card: perray_stage_plain
    sweeping through kslot_sweep's plain version (eager torch); stats
    gains the sweeps' needed "tests" (kslot_sweep_plain's count)."""
    from functools import partial

    from path_tracer_ai_tpu_torch.accel import cuda_cascade, cuda_kslots

    def sweep(pack, rays, cid):
        n_slots = torch.full((rays.shape[0],), cid.shape[1],
                             dtype=torch.int32, device=rays.device)
        return cuda_kslots.kslot_sweep_plain(
            pack, rays, cid, n_slots, not any_hit, stats=stats,
            **({} if any_hit else {"tie": "slot"}))

    return partial(cuda_cascade.perray_stage_plain, sweep=sweep, stats=stats)


def _perray_stage_bytes(rays, n_cand, carry, g, s, stats) -> int:
    """The bytes a perray stage must move, each once: the rays, n_cand,
    act, the carry read and written, the swept rays' candidate groups and
    the swept clusters' [10, S] packs."""
    clusters = int(stats["clusters"].sum()) if "clusters" in stats else 0
    return (_nbytes(rays, n_cand) + rays.shape[0] + 2 * _nbytes(*carry)
            + stats.get("rays", 0) * g * 4 + clusters * 10 * s * 4)


def _perray_stage_table(fn, args, kw, reps=5) -> list:
    """Every stage of one perray call fn(*args, **kw), a row each: its
    size and threshold, k in and out, the active rays at its first and
    last vote, its needed tests (kslot_sweep_plain's: a live ray's g x S
    tests, for any hit up to its first occluding cluster), its bound, the
    host-stepped loop's ms (perray_stage_plain through kslot_sweep; one
    run, host reads included), the stage kernel's ms (CUDA events over
    `reps` runs on copies, the copy timed alone and taken off), and whether
    the kernel's (carry, k, act) are the host-stepped loop's bits and the
    plain version's (eager sweeps)."""
    from path_tracer_ai_tpu_torch.accel import cuda_cascade

    rows = []
    for kept in _keep_perray_stages(fn, args, kw):
        (pack, rays, order_g, n_cand, carry, k, thr), _kw = kept
        any_hit = len(carry) == 1
        stats = {}
        eager = _fused_stage_run(kept, _perray_eager(any_hit, stats))
        stepped = _fused_stage_run(kept, cuda_cascade.perray_stage_plain)
        stepped_ms = cuda_ms(lambda: _fused_stage_run(
            kept, cuda_cascade.perray_stage_plain), 1)
        got = _fused_stage_run(kept, cuda_cascade.perray_stage)
        copy_ms = cuda_ms(lambda: tuple(c.clone() for c in carry)
                          + (k.clone(),), reps)
        ms = cuda_ms(lambda: _fused_stage_run(
            kept, cuda_cascade.perray_stage), reps) - copy_ms
        s, g = pack.shape[2], order_g.shape[2]
        row = {"size": rays.shape[0], "S": s, "G": g, "threshold": thr,
               "k_in": int(k), "k_out": int(stepped[-2]),
               "active_first": stats["active"][0],
               "active_last": stats["active"][-1],
               "sweeps": stats.get("sweeps", 0),
               "rays_swept": stats.get("rays", 0),
               **_bound(_perray_stage_bytes(rays, n_cand, carry, g, s,
                                            stats), stats.get("tests", 0)),
               "host_stepped_ms": stepped_ms, "ms": ms,
               "matches_host_stepped": _same_outputs(got, stepped),
               "matches_plain": _same_outputs(got, eager)
               and _same_outputs(stepped, eager),
               "max_abs_err": 0.0 if any_hit else _max_abs_err(got[0],
                                                               eager[0])}
        row["ms_over_bound"] = ms / row["bound_ms"]
        row["host_stepped_over_bound"] = stepped_ms / row["bound_ms"]
        if row["sweeps"] and not any(r.get("check") for r in rows):
            # the kernels line's check: the first stage that sweeps, its
            # plain version timed once
            row["check"] = True
            row["plain_ms"] = cuda_ms(lambda: _fused_stage_run(
                kept, _perray_eager(any_hit)), 1)
        rows.append(row)
    return rows


def _perray_call_run(fn, args, kw) -> tuple:
    """fn(*args, **kw) once (a perray query): (result, {device seconds
    (CUDA events), wall seconds, host reads, the final k of its last
    stage, stages, stage kernel and kslot_sweep launches}); the device
    kernels of a second run under torch.profiler."""
    from path_tracer_ai_tpu_torch.accel import cuda_cascade, cuda_kslots
    from path_tracer_ai_tpu_torch.utils import sync

    ks = []
    real = cuda_cascade.perray_stage
    stage_launches = lambda: sum(cuda_cascade.launches[n] for n in
                                 cuda_cascade.PERRAY_NAMES.values())

    def stage(*a):
        out = real(*a)
        ks.append(out[1])
        return out

    ev = lambda: torch.cuda.Event(enable_timing=True)
    with _patched(cuda_cascade, perray_stage=stage):
        torch.cuda.synchronize()
        reads = sync.count
        counts = (stage_launches(), cuda_kslots.launches,
                  cuda_kslots.slot_launches)
        start, end = ev(), ev()
        t0 = time.perf_counter()
        start.record()
        out = fn(*args, **kw)
        end.record()
        torch.cuda.synchronize()
        run = {"device_seconds": start.elapsed_time(end) / 1e3,
               "wall_seconds": time.perf_counter() - t0,
               "host_reads": sync.count - reads,
               "stage_launches": stage_launches() - counts[0],
               "kslot_sweep_launches": cuda_kslots.launches - counts[1],
               "kslot_sweep_first_launches":
                   cuda_kslots.slot_launches - counts[2],
               "final_k": int(ks[-1]), "stages": len(ks)}
        run["device_kernels"] = _device_kernels(lambda: fn(*args, **kw))
    return out, run


def _perray_before_after(label, fn, call) -> dict:
    """One kept perray call in turns: before (the host-stepped loop, the
    route before the stage kernel), after (the stage kernel), after,
    before. All must give the same bits and the same final k."""
    args, kw = call
    runs = {"before": [], "after": []}
    outs = {}
    for which in ("before", "after", "after", "before"):
        if which == "before":
            with _perray_host_stepped():
                out, r = _perray_call_run(fn, args, kw)
        else:
            out, r = _perray_call_run(fn, args, kw)
        runs[which].append(r)
        outs.setdefault(which, out)
    flat = lambda o: ((o.hit, o.t, o.tri) if isinstance(o, tuple) else (o,))
    best = {w: {k: min(r[k] for r in runs[w]) for k in runs[w][0]}
            for w in runs}
    return {"call": label, "rays": int(args[1].shape[0]),
            "live_rays": int((torch.as_tensor(args[4]) >= 0).sum()),
            "same_bits": _same_outputs(flat(outs["after"]),
                                       flat(outs["before"])),
            "same_final_k": all(r["final_k"] == runs["before"][0]["final_k"]
                                for w in runs for r in runs[w]),
            "runs": runs, "best": best,
            "device_over_before": best["after"]["device_seconds"]
            / best["before"]["device_seconds"]}


def phase_perray_cascade_loop(scene, accel_base, card) -> tuple:
    """The perray queries' loop on the card. (1) Two kept calls of the
    perray bench render (wave 0, bounce 1: 2^16 rays of the closest call
    and the shadow call after it), each split by stage
    (_perray_stage_table; lines perray_cascade_stages): the stage kernel
    bit for bit the host-stepped loop and the plain version at every
    stage. (2) Each kept call whole, before (the
    host-stepped loop) and after (the stage kernel) in turns: the same bits
    and final k; device seconds, host reads and device kernels (lines
    perray_cascade_loop). Returns the kernel checks for the kernels line
    (each fold's first stage that sweeps) and the host-stepped loop's
    kslot_sweep_first launches."""
    from path_tracer_ai_tpu_torch.accel import cuda_cascade

    t0 = time.perf_counter()
    calls = _keep_perray_calls(scene, accel_base)
    KEPT_RAY_CULLS["perray"] = calls
    checks, loops = {}, []
    for label, fn, (args, kw) in calls:
        rows = _perray_stage_table(fn, args, kw)
        closest = "closest" in label
        emit({"phase": "perray_cascade_stages", "card": card, "call": label,
              "stages": rows, "bound_ms": sum(r["bound_ms"] for r in rows),
              "ms": sum(r["ms"] for r in rows),
              "host_stepped_ms": sum(r["host_stepped_ms"] for r in rows)})
        bad = [r["size"] for r in rows
               if not (r["matches_host_stepped"] and r["matches_plain"])]
        if bad:
            fail("perray_cascade_loop", f"{label}: the stages of {bad} rays "
                                        "differ from the host-stepped loop "
                                        "or the plain version")
        check = next((r for r in rows if r.get("check")), None)
        if check is None:
            fail("perray_cascade_loop", f"{label}: no stage swept")
        name = cuda_cascade.PERRAY_NAMES[not closest]
        checks[name] = {
            "name": name, "wave": f"{label}, first stage that sweeps",
            "T": 1, "S": check["S"], "G": check["G"],
            "blocks": check["size"], "k_in": check["k_in"],
            "k_out": check["k_out"], "sweeps": check["sweeps"],
            "ms": check["ms"], "plain_ms": check["plain_ms"],
            "host_stepped_ms": check["host_stepped_ms"],
            "bound_ms": check["bound_ms"], "bound_by": check["bound_by"],
            "tests": check["tests"], "bytes": check["bytes"],
            "ms_over_bound": check["ms_over_bound"],
            "matches_plain": check["matches_plain"]
            and check["matches_host_stepped"],
            "max_abs_err": check["max_abs_err"],
            "call_ms": sum(r["ms"] for r in rows),
            "call_bound_ms": sum(r["bound_ms"] for r in rows),
            "call_host_stepped_ms": sum(r["host_stepped_ms"] for r in rows)}
        loops.append(_perray_before_after(label, fn, (args, kw)))
    for f in loops:
        emit({"phase": "perray_cascade_loop", "card": card, **f})
    if not all(f["same_bits"] and f["same_final_k"] for f in loops):
        fail("perray_cascade_loop", "a perray call's stage kernel differs "
                                    "from the host-stepped loop (bits or "
                                    "final k)")
    stepped = sum(r["kslot_sweep_first_launches"] for f in loops
                  for r in f["runs"]["before"])
    if not stepped:
        fail("perray_cascade_loop", "the host-stepped loop launched no "
                                    "kslot_sweep")
    emit({"phase": "perray_cascade_loop", "card": card,
          "checks": {k: {x: c[x] for x in (
              "ms", "bound_ms", "ms_over_bound", "plain_ms",
              "host_stepped_ms", "call_ms", "call_bound_ms",
              "call_host_stepped_ms")}
              for k, c in checks.items()},
          "loops": [{"call": f["call"], "live_rays": f["live_rays"],
                     **{w: {x: f["best"][w][x] for x in (
                         "device_seconds", "wall_seconds", "host_reads",
                         "device_kernels", "stage_launches",
                         "kslot_sweep_launches", "final_k")}
                        for w in ("before", "after")},
                     "device_over_before": f["device_over_before"]}
                    for f in loops],
          "host_stepped_kslot_launches": stepped,
          "seconds": time.perf_counter() - t0})
    return checks, stepped


def phase_worklist_mxu(waves, item_checks, card, min_swept=1000):
    """The worklist scene's kept closest and shadow queries (wave 0, bounce
    1) through intersector "mxu", "mxu:high" and "mxu:default" at blocks
    of 64, groups of 4 and sort=True (the JAX tests' setting; the render
    sends its shadow waves unsorted, which at blocks of 64 would send most
    live shadow rays to the exact fallback), against the same query
    through "exact" (the render's own options). Blocks past `cap` complete
    through the exact fallback, so every accuracy figure is taken over the
    rays whose result came from the mxu sweep: live rays (t_max >= 0) of
    blocks that did not overflow (the overflow mask the query hands to
    worklist._overflow_fallback). Over those: the share of hits
    (occlusions) that flip, and the same share over the swept rays that
    "exact" finds hitting (occluded), so that easy misses cannot hide lost
    hits; the largest relative t error where both hit; the share of the
    same triangle; beside them the flips over the whole wave. Also the
    device ms of the mxu item sweep and of its matrix product alone (CUDA
    events) beside item_sweep's ms on the same wave (item_waves). Fails
    when "mxu" misses JAX's own bounds on its swept rays (flips < 5e-3, t
    within rtol 5e-3, the same triangle on more than 99%), flips 5e-3 or
    more of its swept hits (occlusions), or swept fewer than `min_swept`
    rays, or hits, of a wave."""
    import inspect

    from path_tracer_ai_tpu_torch.accel import mxu, worklist

    spans = {"sweep": [], "product": []}
    overflow_masks = []

    def timed(mod, name, key):
        real = getattr(mod, name)

        def run(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real(*a, **k)
            end.record()
            spans[key].append((start, end))
            return out

        setattr(mod, name, run)
        return real

    real_fallback = worklist._overflow_fallback

    def keep_overflow(*a, **k):
        overflow_masks.append(inspect.signature(real_fallback).bind(
            *a, **k).arguments["overflow"])
        return real_fallback(*a, **k)

    out = {"phase": "worklist_mxu", "card": card, "min_swept": min_swept}
    reals = [(worklist, "_sweep_items_mxu",
              timed(worklist, "_sweep_items_mxu", "sweep")),
             (mxu, "linear_product", timed(mxu, "linear_product", "product")),
             (worklist, "_overflow_fallback", real_fallback)]
    worklist._overflow_fallback = keep_overflow
    try:
        for (label, (args, kw)), check in zip(waves.items(), item_checks):
            closest = label == "closest_wave"
            fn = (worklist.closest_hit_worklist if closest
                  else worklist.any_hit_worklist)
            ref = fn(*args, **kw)
            n = int(args[1].shape[0])
            t_max = inspect.signature(fn).bind(*args, **kw).arguments["t_max"]
            live = torch.broadcast_to(torch.as_tensor(
                t_max, device=args[1].device), (n,)) >= 0
            wave = {"rays": n, "live_rays": int(live.sum()),
                    "item_sweep_ms": check["ms"]}
            for name in ("mxu", "mxu:high", "mxu:default"):
                for v in spans.values():
                    v.clear()
                overflow_masks.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = fn(*args, **dict(kw, block=64, group=4, sort=True,
                                       intersector=name))
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                if len(overflow_masks) != 1:
                    fail("worklist_mxu", f"{label} {name}: "
                         f"{len(overflow_masks)} overflow masks, not one")
                swept = live & ~overflow_masks[0]
                n_swept = int(swept.sum())
                r = {"query_seconds": seconds, "swept_rays": n_swept,
                     "swept_share_of_live": n_swept / max(wave["live_rays"],
                                                          1),
                     **{f"{k}_ms": sum(a.elapsed_time(b) for a, b in v)
                        for k, v in spans.items()}}
                if closest:
                    both = ref.hit & got.hit & swept
                    rel = ((got.t - ref.t).abs() / ref.t.abs())[both]
                    flips = ref.hit != got.hit
                    r.update(hits=int((ref.hit & swept).sum()),
                             flip_share=float(flips[swept].float().mean()),
                             hit_flip_share=float(
                                 flips[swept & ref.hit].float().mean()),
                             wave_flip_share=float(flips.float().mean()),
                             max_rel_t_err=float(rel.max()) if rel.numel()
                             else 0.0,
                             same_tri_share=float((ref.tri == got.tri)[both]
                                                  .float().mean()))
                else:
                    flips = ref != got
                    r.update(hits=int((ref & swept).sum()),
                             flip_share=float(flips[swept].float().mean()),
                             hit_flip_share=float(
                                 flips[swept & ref].float().mean()),
                             wave_flip_share=float(flips.float().mean()))
                wave[name] = r
            out[label] = wave
    finally:
        for mod, name, real in reals:
            setattr(mod, name, real)
    emit(out)
    c, sh = out["closest_wave"]["mxu"], out["shadow_wave"]["mxu"]
    if not (c["max_rel_t_err"] <= 5e-3 and c["same_tri_share"] > 0.99
            and all(w["flip_share"] < 5e-3 and w["hit_flip_share"] < 5e-3
                    and min(w["swept_rays"], w["hits"]) >= min_swept
                    for w in (c, sh))):
        fail("worklist_mxu", f"mxu misses JAX's bounds on its swept rays: "
                             f"closest {c}, shadow {sh}")
    return out


def _consistency_ctiles(scene, cam, img_oracle, kw):
    """ctiles' options against the oracle's rr-off image of the consistency
    phase (96x54, 4 spp, 5 bounces), each bitwise: the ctiles backend on
    the 2,564-cluster accel (clusters of two: levels=0 picks the 2-level
    cull), pair_split=2 in CTILES_CLOSEST_KW (the ctiles backend and the
    main path), fallback_sorted=False on the main path, and accels built
    with method="morton" through the main path."""
    from path_tracer_ai_tpu_torch.accel.clusters import build_clusters
    from path_tracer_ai_tpu_torch.config import RenderSettings
    from path_tracer_ai_tpu_torch.engine import wavefront

    settings = RenderSettings(width=96, height=54, samples_per_pixel=4,
                              max_bounces=5, seed=0)
    acc2 = build_clusters(scene.triangles, cluster_size=2)
    ckw = wavefront.CTILES_CLOSEST_KW
    routes = {
        "ctiles_2level_c2": (dict(backend="ctiles", accel=acc2), None),
        "ctiles_pair_split_2": (
            dict(backend="ctiles"),
            {"CTILES_CLOSEST_KW": dict(ckw, pair_split=2)}),
        "main_pair_split_2": (
            {}, {"CTILES_CLOSEST_KW": dict(ckw, pair_split=2)}),
        "main_fallback_unsorted": (
            {}, {"CTILES_CLOSEST_KW": dict(ckw, fallback_sorted=False)}),
        "main_morton": (
            dict(accel=build_clusters(scene.triangles, method="morton"),
                 accel_closest=build_clusters(scene.triangles,
                                              cluster_size=256,
                                              method="morton")), None),
    }
    out = {"clusters_c2": acc2.num_clusters}
    for name, (rkw, tables) in routes.items():
        _reset_counts()
        with _engines(tables):
            img = wavefront.render(scene, cam, settings, **{**kw, **rkw})
        diff = np.abs(img - img_oracle).max(axis=-1)
        counts = _read_counts()
        out[name] = {"bitwise": bool(np.array_equal(img, img_oracle)),
                     "max_abs_diff": float(diff.max()),
                     "pixels_differing": int((diff > 0).sum()),
                     # the 2-level cull's kernel launches
                     "two_level_culls": counts["block_cull_2level"],
                     "launches": counts["slot_sweep"]}
    return out


# The default tile_sweep instance at (T 128, S 256) as measured on the H100
# before its options were compiled beside it (PERF.md's kernel table): the
# tile_sweep_options line holds this run's figures against these.
BEFORE_OPTIONS = {"ms": 0.2015, "registers": 93, "spill_bytes": 0,
                  "warps_per_sm": 16}


# name -> (source under path_tracer_ai_tpu_torch/csrc, TPU kernel it replaces,
#          phase whose render gives its launch count)
KERNELS = {
    # since ctiles' bounds went on the card its body runs in slot_sweep;
    # launched standalone by the kernel phase and by the chunked form that
    # slot_sweep replaced (ctiles_bounds' comparison, "ctiles_stepped")
    "tile_sweep": ("ctiles_sweep.cu",
                   "path_tracer_ai_tpu/accel/pallas_ctiles.py:239",
                   "ctiles_stepped"),
    # on the fused route these two run as the sweep bodies of the fused
    # stage kernel's folds (fused_stage_any, fused_stage_closest); launched
    # standalone by the kernel phase and the host-stepped comparison loop
    # (fused_cascade phase), whose launches the line counts
    "block_anyhit": ("fused_anyhit.cu",
                     "path_tracer_ai_tpu/accel/pallas_anyhit.py:181",
                     "fused_host_stepped"),
    "block_closest": ("fused_closest.cu",
                      "path_tracer_ai_tpu/accel/pallas_closest.py:140",
                      "fused_host_stepped"),
    "closest_sweep": ("packet_sweep.cu",
                      "path_tracer_ai_tpu/accel/pallas_sweep.py:179",
                      "path_pallas"),
    "anyhit_sweep": ("packet_sweep.cu",
                     "path_tracer_ai_tpu/accel/pallas_sweep.py:321",
                     "path_pallas"),
    # no Pallas kernel: the XLA-fused body of worklist._sweep_items
    "item_sweep": ("item_sweep.cu", None, "path_worklist"),
    # no Pallas kernel: the XLA-fused SWEEP and RESOLVE of
    # kslots._chunk_pipeline
    "kslot_sweep": ("kslot_sweep.cu", None, "path_kslots"),
    # the first-slot instances (no Pallas kernel): the XLA-fused sweep of
    # traverse.closest_hit_packets (traverse.py:823-845), whose busiest
    # route is the worklist's closest fallback, and of closest_hit_perray
    # (traverse.py:648-665)
    # no path launches them any more: the cascade stage kernel sweeps those
    # cascades; the host-stepped loops (packet_cascade and
    # perray_cascade_loop phases) do
    "tile_sweep_first": ("ctiles_sweep.cu", None, "host_stepped_loop"),
    "kslot_sweep_first": ("kslot_sweep.cu", None, "host_stepped_loop"),
    # the cascade stage kernel (no Pallas kernel): the jax.lax.while_loop of
    # traverse._cascade_traverse (traverse.py:439-520) for any_hit_packets
    # (the main path's shadows) and closest_hit_packets (the worklist's
    # whole-wave closest fallbacks)
    "cascade_stage_any": ("ctiles_sweep.cu", None, "main_path"),
    "cascade_stage_first": ("ctiles_sweep.cu", None, "path_worklist"),
    # the same stage loop (csrc/stage.cuh) with the fused cascades' folds,
    # whose sweeps are block_anyhit's and block_closest's bodies: the
    # jax.lax.while_loop of any_hit_fused and closest_hit_fused
    "fused_stage_any": ("fused_anyhit.cu", None, "path_fused"),
    "fused_stage_closest": ("fused_closest.cu", None, "path_fused"),
    # the same stage loop with the perray queries' folds, whose sweeps are
    # kslot_sweep's walk of one ray: the jax.lax.while_loop of
    # closest_hit_perray and any_hit_perray
    "perray_stage_any": ("kslot_sweep.cu", None, "path_perray"),
    "perray_stage_first": ("kslot_sweep.cu", None, "path_perray"),
    # ctiles' bounds on the card (no Pallas kernel): the flat cull of
    # ctiles._ray_masks + _extract_order_flat, and tile_sweep's body over
    # static slot tables with the tile count on the device (ctiles'
    # _sweep_resolve, pairs' _sweep_tiles)
    "block_cull": ("ctiles_cull.cu", None, "main_path"),
    "slot_sweep": ("ctiles_sweep.cu", None, "main_path"),
    # the packet cascades' interval cull (no Pallas kernel): the XLA-fused
    # body of traverse._block_candidates, on every packets route
    "packet_cull": ("packet_cull.cu", None, "main_path"),
    # the worklist's cull (no Pallas kernel): the XLA-fused CULL + EXTRACT
    # of worklist._build_worklist, on the worklist route past 2048 clusters
    "worklist_cull": ("worklist_cull.cu", None, "path_worklist"),
    # the per-ray culls (no Pallas kernel): the XLA-fused CULL + EXTRACT of
    # kslots._chunk_pipeline on the kslots route, and perray's candidate
    # lists (_perray_candidates, "id") on the perray route
    "kslots_cull": ("ray_cull.cu", None, "path_kslots"),
    "perray_cull": ("ray_cull.cu", None, "path_perray"),
    # the pair tiles' CULL + PACK (no Pallas kernel): the overflow fallback
    # of ctiles (the main path's closest waves), the worklist and kslots;
    # a launch is one call of its three kernels. ctiles' 2-level cull (no
    # Pallas kernel): the ctiles backend past 2048 clusters
    "pair_cull": ("ray_cull.cu", None, "main_path"),
    "block_cull_2level": ("ctiles_cull.cu", None, "path_ctiles_2level"),
    # the exact shadow cull (no Pallas kernel): the XLA-fused body of
    # traverse._exact_block_candidates, at exact_cull=K on the packets and
    # fused routes and the worklist's "packets_exact"; perray's entry order
    # (no Pallas kernel), on no route of either package: its path is
    # _perray_candidates(order_mode="entry") on the perray render's kept
    # waves
    "exact_cull": ("packet_cull.cu", None, "exact_cull_main"),
    "perray_entry": ("ray_cull.cu", None, "perray_entry"),
}
# what a kernel without a Pallas counterpart carries in the JAX package
CARRIES = {
    "item_sweep": "path_tracer_ai_tpu/accel/worklist.py:325 _sweep_items",
    "kslot_sweep": "path_tracer_ai_tpu/accel/kslots.py:165 _chunk_pipeline",
    "tile_sweep_first":
        "path_tracer_ai_tpu/accel/traverse.py:823-845 (closest sweep)",
    "kslot_sweep_first":
        "path_tracer_ai_tpu/accel/traverse.py:648-665 (perray sweep)",
    "cascade_stage_any":
        "path_tracer_ai_tpu/accel/traverse.py:491 (while_loop), 940-955",
    "cascade_stage_first":
        "path_tracer_ai_tpu/accel/traverse.py:491 (while_loop), 812-845",
    "fused_stage_any":
        "path_tracer_ai_tpu/accel/traverse.py:491 (while_loop), "
        "pallas_anyhit.py:327-367",
    "fused_stage_closest":
        "path_tracer_ai_tpu/accel/traverse.py:491 (while_loop), "
        "pallas_closest.py:271-318",
    "perray_stage_any":
        "path_tracer_ai_tpu/accel/traverse.py:491 (while_loop), 727-738",
    "perray_stage_first":
        "path_tracer_ai_tpu/accel/traverse.py:491 (while_loop), 648-665",
    "block_cull": "path_tracer_ai_tpu/accel/ctiles.py:81-191 (_ray_masks, "
                  "_extract_order_flat; fori_loop to live_blocks)",
    "slot_sweep": "path_tracer_ai_tpu/accel/ctiles.py:485-667 "
                  "(_sweep_resolve's fori_loops to n_chunks), pairs.py:193-259 "
                  "(_sweep_tiles)",
    "packet_cull": "path_tracer_ai_tpu/accel/traverse.py:171-202 "
                   "(_block_candidates: _ray_block_bounds, _interval_slab, "
                   "the stable argsort)",
    "worklist_cull": "path_tracer_ai_tpu/accel/worklist.py:169-266 "
                     "(_build_worklist's one_chunk_flat / one_chunk_2level: "
                     "_ray_block_bounds, _interval_slab, _extract_k)",
    "kslots_cull": "path_tracer_ai_tpu/accel/kslots.py:110-163 "
                   "(_chunk_pipeline's CULL + EXTRACT: _ray_slab, "
                   "_pack_bits, _peel_k)",
    "perray_cull": "path_tracer_ai_tpu/accel/traverse.py:530-603 "
                   "(_perray_candidates, order_mode \"id\")",
    "pair_cull": "path_tracer_ai_tpu/accel/pairs.py:61-190 "
                 "(build_pair_tables: _ray_slab_chunk, the lax.scan's "
                 "per-cluster counts, the segments and the scatter)",
    "block_cull_2level": "path_tracer_ai_tpu/accel/ctiles.py:194-343 "
                         "(_block_candidates_2level; fori_loop to "
                         "live_blocks)",
    "exact_cull": "path_tracer_ai_tpu/accel/traverse.py:205-397 "
                  "(_exact_block_candidates: slab_lanes, the super "
                  "shortlist's top_k, the children, the entry argsort; "
                  "fori_loop to live_blocks)",
    "perray_entry": "path_tracer_ai_tpu/accel/traverse.py:530-603 "
                    "(_perray_candidates, order_mode \"entry\": the "
                    "argsort of the entries)",
}
# what a kernel runs as on its route besides its own launches
RUNS_AS = {
    "tile_sweep": "the sweep body of slot_sweep (sweep_clusters) on the "
                  "ctiles closest waves and the pair tiles; standalone in the "
                  "kernel phase, the host-stepped comparison loops and the "
                  "chunked form slot_sweep replaced",
    "block_anyhit": "the sweep body of fused_stage_any on the fused route "
                    "(anyhit_group); standalone in the kernel phase and "
                    "the host-stepped comparison loop",
    "block_closest": "the sweep body of fused_stage_closest on the fused "
                     "route (closest_group); standalone in the kernel phase "
                     "and the host-stepped comparison loop",
}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="build and check the kernels, then stop")
    parser.add_argument("--mesh-cards", action="store_true",
                        help="build the kernels, render the main path, then "
                        "the bench render over a mesh of distinct cards "
                        "(needs two or more) and a virtual one, and stop")
    parser.add_argument("--stages", action="store_true",
                        help="build the kernels, render the main path and "
                        "its profile, keep its shadow calls and the worklist "
                        "render's closest fallbacks, split those cascades by "
                        "stage (stage_split), and stop")
    parser.add_argument("--fused-stages", action="store_true",
                        help="build the kernels, render the main path and "
                        "the fused route and its profile, split the fused "
                        "route's kept calls by stage (fused_cascade), sum "
                        "the bounds of the fused render's stages "
                        "(fused_stage_render), and stop")
    parser.add_argument("--sass", metavar="DIR",
                        help="write cuobjdump's SASS of every library there")
    args = parser.parse_args()
    t_start = time.perf_counter()
    import path_tracer_ai_tpu_torch  # noqa: F401  (fails outside the repo)

    card = phase_device()
    occupancy, ptxas = phase_build()
    _spy_eager_sweeps()
    _spy_fused_calls()
    if args.sass:
        dump_sass(args.sass)

    from path_tracer_ai_tpu_torch.accel.clusters import build_clusters
    from path_tracer_ai_tpu_torch.scene.scene import blob_scene

    t0 = time.perf_counter()
    scene = blob_scene(subdivisions=6, device="cuda")
    accel_base = build_clusters(scene.triangles, cluster_size=128)
    accel_c = build_clusters(scene.triangles, cluster_size=256)
    emit({"phase": "scene", "triangles": scene.triangles.count,
          "clusters_s128": accel_base.num_clusters,
          "clusters_s256": accel_c.num_clusters,
          "seconds": time.perf_counter() - t0})

    if args.mesh_cards:
        render, img_main = phase_main_path(scene, accel_base, accel_c, card)
        phase_mesh_cards(scene, accel_base, accel_c, card, img_main,
                         render["seconds"])
        return 0
    if args.stages:
        render, _img = phase_main_path(scene, accel_base, accel_c, card)
        profile = phase_profile(scene, accel_base, accel_c, render["seconds"])
        kept_shadows = _keep_shadow_calls(scene, accel_base, accel_c)
        phase_item_waves(*worklist_scene(), card)
        phase_stage_split(scene, accel_base, accel_c, card, kept_shadows,
                          profile)
        return 0
    if args.fused_stages:
        render, img_main = phase_main_path(scene, accel_base, accel_c, card)
        fused, _img = phase_path_fused(scene, accel_base, card, img_main)
        profile = phase_profile_path(
            "profile_fused", scene, accel_base, fused["seconds"],
            FUSED_KERNEL_TAGS, engines=FUSED_ENGINES)
        phase_fused_cascade(scene, accel_base, card, img_main)
        phase_fused_stage_render(scene, accel_base, card, profile)
        return 0
    checks = phase_kernels(accel_base, accel_c)
    sweep_waves = phase_sweep_waves(scene, accel_base, card)
    scene_w, accel_w = worklist_scene()
    item_waves, worklist_waves, warm_w, item_args = phase_item_waves(
        scene_w, accel_w, card)
    checks["item_sweep"] = dict(item_waves[0], matches_plain=all(
        c["matches_plain"] for c in item_waves))
    checks["worklist_cull"] = phase_worklist_cull(card)
    generic = phase_generic_kernels(accel_base, item_args, checks, card)
    generic["worklist_cull"] = None  # its only instance
    phase_sweep_cases(card)
    if args.kernels_only:
        return 0
    render, img_main = phase_main_path(scene, accel_base, accel_c, card)
    profile = phase_profile(scene, accel_base, accel_c, render["seconds"])
    phase_main_summary(card, render, profile)
    bounds_checks, bounds_generic, bounds_stepped = phase_ctiles_bounds(
        scene, accel_base, accel_c, card, render)
    checks.update(bounds_checks)
    generic.update(bounds_generic)
    kept_shadows = _keep_shadow_calls(scene, accel_base, accel_c)
    checks["packet_cull"] = phase_packet_cull(card, render, profile,
                                              kept_shadows, accel_base,
                                              accel_w)
    generic["packet_cull"] = None  # its only instance
    paths = {"main_path": render,
             "ctiles_stepped": {"launches": bounds_stepped},
             "path_pallas": phase_path_pallas(scene, accel_base, card, img_main)}
    phase_profile_path("profile_pallas", scene, accel_base,
                       paths["path_pallas"]["seconds"],
                       ["closest_sweep_kernel", "anyhit_sweep_kernel"],
                       backend="pallas", block_size=64)
    paths["path_fused"], img_fused = phase_path_fused(scene, accel_base,
                                                      card, img_main)
    phase_profile_path(
        "profile_fused", scene, accel_base, paths["path_fused"]["seconds"],
        FUSED_KERNEL_TAGS, engines=FUSED_ENGINES)
    fused_checks, fused_stepped = phase_fused_cascade(scene, accel_base,
                                                      card, img_main)
    checks.update(fused_checks)
    paths["fused_host_stepped"] = {"launches": fused_stepped}
    paths["path_worklist"] = phase_path_worklist(scene_w, accel_w, card,
                                                 warm_w)
    phase_profile_worklist(worklist_waves, card)
    phase_consistency()
    phase_reference(card, render, profile)
    sizes = phase_cluster_sizes(card)
    cli = phase_cli(card)
    phase_bench(card)
    paths["path_pool"] = phase_path_pool(scene, accel_base, accel_c, card,
                                         img_main)
    meshes = phase_path_mesh(scene, accel_base, accel_c, card, img_main,
                             render["seconds"])
    paths["config_4k"] = phase_config_4k(card)
    exact = phase_exact_cull(scene, accel_base, accel_c, card, img_main,
                             img_fused, worklist_waves, accel_w,
                             {"main": render["host_syncs"],
                              "fused": paths["path_fused"]["host_syncs"]})
    checks["exact_cull"] = exact["check"]
    generic["exact_cull"] = None  # its only instance
    paths["exact_cull_main"] = exact["main"]
    ctiles_paths = phase_path_ctiles(
        scene, accel_base, accel_c, card, img_main, scene_w, accel_w,
        paths["path_worklist"]["image_sha256"])
    paths["path_ctiles_2level"] = ctiles_paths["path_ctiles_2level"]
    perray = phase_path_perray(scene, accel_base, accel_c, card, img_main)
    paths["path_perray"] = perray
    perray_checks, perray_stepped = phase_perray_cascade_loop(
        scene, accel_base, card)
    checks.update(perray_checks)
    paths["path_kslots"] = phase_path_kslots(scene, accel_base, accel_c,
                                             card, img_main)
    (checks["kslots_cull"], checks["perray_cull"], checks["perray_entry"],
     paths["perray_entry"]) = phase_ray_cull(scene, accel_base, card, paths)
    generic["kslots_cull"] = generic["perray_cull"] = None  # one instance
    generic["perray_entry"] = None
    checks["pair_cull"], checks["block_cull_2level"] = phase_pair_cull(
        scene, accel_base, accel_c, scene_w, accel_w, card, paths, occupancy)
    generic["pair_cull"] = generic["block_cull_2level"] = None
    first_checks, packets, stepped = phase_packet_cascade(
        scene, accel_base, accel_c, card, img_main,
        {"worklist": paths["path_worklist"], "kslots": paths["path_kslots"],
         "perray": perray}, kept_shadows, profile)
    checks.update(first_checks)
    paths["host_stepped_loop"] = {"launches": {
        **stepped, "kslot_sweep_first": perray_stepped}}
    for name in ("fused_stage_any", "fused_stage_closest",
                 "perray_stage_any", "perray_stage_first"):
        generic[name] = None  # its only instance: the line's own numbers
    for name in ("tile_sweep_first", "kslot_sweep_first",
                 "cascade_stage_any", "cascade_stage_first"):
        c = checks[name]
        generic[name] = {"S": c["S"], "generic_ms": c["generic_ms"],
                         "tuned_ms": c["ms"],
                         "generic_over_tuned": c["generic_ms"] / c["ms"],
                         "bound_ms": c["bound_ms"],
                         "generic_over_bound": c["generic_over_bound"],
                         "plain_ms": c["plain_ms"],
                         "matches_plain": c["generic_matches_plain"]}
    phase_worklist_mxu(worklist_waves, item_waves, card)
    if any(EAGER_CALLS.values()):
        fail("packet_cascade", f"the eager sweeps or culls ran on the card: "
                               f"{EAGER_CALLS}")
    new_paths = {**ctiles_paths, "path_perray": perray,
                 "path_packets": packets,
                 "path_kslots": paths["path_kslots"],
                 "path_pool": paths["path_pool"],
                 "path_mesh_virtual_2x2": meshes["virtual_2x2"],
                 "path_mesh_tile_devices_8": meshes["tile_devices_8"],
                 "render_sharded": meshes["render_sharded"],
                 "config_4k": paths["config_4k"],
                 "exact_cull_main": exact["main"],
                 "exact_cull_fused": exact["fused"]}

    emit({"phase": "tile_sweep_options", "card": card,
          "default_T128_S256": {
              "ms": checks["tile_sweep"]["ms"],
              "ms_over_before_options": checks["tile_sweep"]["ms"]
              / BEFORE_OPTIONS["ms"],
              "occupancy": occupancy["tile_sweep T128 S256"],
              "before_options": BEFORE_OPTIONS},
          "checks": [{"option": opt, "T": o["T"], "S": o["S"],
                      "matches_plain": o["matches_plain"],
                      "equals_default": o["equals_default"], "ms": o["ms"],
                      "default_ms": checks[name]["ms"],
                      "bound_ms": o["bound_ms"],
                      "ms_over_bound": o["ms_over_bound"],
                      "plain_ms": o["plain_ms"],
                      "occupancy": o["occupancy"]}
                     for name in ("tile_sweep", "tile_sweep_t128_s128",
                                  "tile_sweep_t64")
                     for opt, o in checks[name]["options"].items()],
          "ptxas": [e for e in ptxas.get("ctiles_sweep", [])
                    if "options" in e["entry"]],
          "new_path_launches": {k: v["tile_sweep_shapes"]
                                for k, v in ctiles_paths.items()}})
    emit({"phase": "tile_sweep_shapes", "card": card, "checks": [
        {k: checks[name][k] for k in ("T", "S", "G", "nt", "ms", "bound_ms",
                                      "ms_over_bound", "matches_plain")}
        for name in ("tile_sweep", "tile_sweep_t64", "tile_sweep_t64_g2",
                     "tile_sweep_t128_s128", "tile_sweep_t64_g8",
                     "tile_sweep_t256_g2")],
        "main_path_launches": render["tile_sweep_shapes"],
        "worklist_path_launches": paths["path_worklist"]["tile_sweep_shapes"],
        **{f"{k}_launches": v["tile_sweep_shapes"]
           for k, v in new_paths.items()}})
    emit({"kernels": [{
        "name": name, "route": "cuda",
        "source": "path_tracer_ai_tpu_torch/csrc/" + source,
        "replaces": replaces, "path": phase,
        **({"carries": CARRIES[name]} if name in CARRIES else {}),
        "launches": paths[phase]["launches"][name],
        "cli_launches": cli["launches"][name],
        "cli_pallas_launches": cli["pallas"]["launches"][name],
        "cli_perray_launches": cli["perray"]["launches"][name],
        "new_path_launches": {k: v["launches"][name]
                              for k, v in new_paths.items()},
        "matches_plain": checks[name]["matches_plain"],
        "max_abs_err": checks[name]["max_abs_err"], "ms": checks[name]["ms"],
        "plain_ms": checks[name]["plain_ms"],
        "bound_ms": checks[name]["bound_ms"],
        "bound_by": checks[name]["bound_by"], "library_ms": None,
        "ms_over_bound": checks[name]["ms_over_bound"],
        "generic": {**({k: generic[name][k] for k in (
            "S", "generic_ms", "tuned_ms", "generic_over_tuned", "bound_ms",
            "generic_over_bound", "plain_ms", "matches_plain")}
            if generic[name] else {"only_instance": True}),
            "cluster_sizes_launches": {
                row["S"]: sum(r["generic_launches"].get(name, 0)
                              for r in row["renders"].values())
                for row in sizes},
            # the first-slot instances are not held there (sweep_cases
            # and packet_cascade hold their generic instance)
            "cluster_sizes_matches_plain": all(
                row["generic_matches_plain"][name] for row in sizes)
            if name in sizes[0]["generic_matches_plain"] else None},
        "occupancy": {k: v for k, v in occupancy.items()
                      if k.split()[0] == name},
        **({"render_waves": [
            {k: w[k] for k in ("bounce", "B", "visits", "ms", "bound_ms",
                               "ms_over_bound", "matches_plain")}
            for w in sweep_waves]} if name == "closest_sweep" else {}),
        **({"render_waves": [
            {k: w[k] for k in ("wave", "n_items", "ms", "plain_ms",
                               "bound_ms", "ms_over_bound", "matches_plain")}
            for w in item_waves]} if name == "item_sweep" else {}),
        **({"waves": [
            {k: w[k] for k in ("wave", "K", "slots", "overflow_rays", "ms",
                               "plain_ms", "bound_ms", "ms_over_bound",
                               "matches_plain")}
            for w in (checks["kslot_sweep"], checks["kslot_sweep_shadow"])],
            "matches_plain": all(checks[k]["matches_plain"] for k in (
                "kslot_sweep", "kslot_sweep_shadow"))}
           if name == "kslot_sweep" else {}),
        **({"waves": [
            {k: w[k] for k in ("wave", "T", "S", "G", "nt", "ms", "plain_ms",
                               "bound_ms", "ms_over_bound", "matches_plain")}
            for w in (checks["tile_sweep_first"],
                      checks["tile_sweep_first_t256"])],
            "matches_plain": checks["tile_sweep_first"]["matches_plain"]
            and checks["tile_sweep_first_t256"]["matches_plain"]}
           if name == "tile_sweep_first" else {}),
        **({"waves": [
            {k: w[k] for k in ("wave", "T", "S", "G", "blocks", "sweeps",
                               "ms", "plain_ms", "host_stepped_ms",
                               "bound_ms", "ms_over_bound", "matches_plain")}
            for w in (checks["cascade_stage_first"],
                      checks["cascade_stage_first_t256"])],
            "matches_plain": checks["cascade_stage_first"]["matches_plain"]
            and checks["cascade_stage_first_t256"]["matches_plain"]}
           if name == "cascade_stage_first" else {}),
        **({"host_stepped_ms": checks[name]["host_stepped_ms"]}
           if name == "cascade_stage_any" else {}),
        **({"runs_as": RUNS_AS[name]} if name in RUNS_AS else {}),
        **({"waves": checks[name]["waves"]}
           if name in ("block_cull", "slot_sweep", "packet_cull",
                       "worklist_cull", "kslots_cull", "perray_cull",
                       "pair_cull", "block_cull_2level", "exact_cull",
                       "perray_entry")
           else {}),
        **({"launches_by_route": {
            **{k: v["launches"][name] for k, v in paths.items()
               if "launches" in v and isinstance(v["launches"], dict)
               and name in v["launches"]},
            **{k: v["launches"][name] for k, v in new_paths.items()},
            "cli": cli["launches"][name],
            "cli_pallas": cli["pallas"]["launches"][name],
            "cli_perray": cli["perray"]["launches"][name]}}
           if name in ("packet_cull", "pair_cull", "block_cull_2level",
                       "exact_cull")
           else {}),
        **({"wave": checks[name]["wave"],
            "host_stepped_ms": checks[name]["host_stepped_ms"],
            "call_ms": checks[name]["call_ms"],
            "call_bound_ms": checks[name]["call_bound_ms"],
            "call_host_stepped_ms": checks[name]["call_host_stepped_ms"],
            "launches_by_shape": [
                sh for sh in paths[phase]["cascade_stage_shapes"]
                if sh["kernel"] == name],
            "new_path_launches_by_shape": {
                k: [sh for sh in v["cascade_stage_shapes"]
                    if sh["kernel"] == name]
                for k, v in new_paths.items()
                if any(sh["kernel"] == name
                       for sh in v.get("cascade_stage_shapes", []))}}
           if name.startswith(("fused_stage", "perray_stage")) else {}),
        **({"W": checks[name]["W"],
            "splits": checks[name]["splits"],
            "launches_by_w": _launches_by_w(
                paths[phase]["cascade_stage_shapes"], name),
            "new_path_launches_by_w": {
                k: _launches_by_w(v["cascade_stage_shapes"], name)
                for k, v in new_paths.items()
                if "cascade_stage_shapes" in v}}
           if name.startswith("cascade_stage") else {}),
    } for name, (source, replaces, phase) in KERNELS.items()],
        "seconds": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
