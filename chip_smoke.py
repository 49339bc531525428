#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one CUDA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs a CUDA card; without one (or without the repository beside it)
it exits nonzero and prints no result.  Phases, one JSON line each:

1. ``device``: the card's name and power limit (nvidia-smi).
2. ``build``: builds every kernel source under csrc/ (the CUDA kernels,
   the ICP kernels K4 / K4s in icp.cu, the frontend and pyramid kernels
   K3a / K3b in preprocess.cu, the splat kernels K8 / K9 in splat.cu,
   the fuse kernels K6 / K7 in fuse.cu, the allocation kernels K5a / K5b
   in alloc.cu, the BA kernels K13a-c in pose_graph.cu, the map's free
   and restore kernels K10 / K14 / K15 in maintain.cu, the march kernels
   K11 / K12 in raycast.cu, the dense fusion K20 in dense.cu, the empty
   kernels that measure
   the launch and barrier floors, and the host codec) for sm_90a into the
   package's _build/ directory, one compiler process each, started
   together.
3. ``kernel``: both window-gather kernels (one CTA per block row;
   one warp per block row, "streamed") against their plain PyTorch
   versions on the card at 480x640, V=512.  First the frame step's own
   gather inputs: ``step_rows``, the visible rows after the first
   N_STEP_FRAMES frames of the noisy room sweep, projected as integrate
   projects them (the row count that comes out, about 900), and
   ``step_rows_x4096``, the same rows tiled to the ``max_active`` ceiling.
   Then the synthetic cases, (v, u) uniform inside a spread: spread 120,
   spread 400 and the invalid corner at C=4096, spread 120 at C=832 and at
   C=4099.  Values and covered must be bit-exact, and the two kernels
   equal to each other; the shapes the kernels branch on (row lengths
   510, 520, 1000, 1024, 4096, one row, fewer rows than the card has SMs,
   rows off a 16-byte boundary) are checked untimed.  Per case and
   kernel: the wrapper's time (CUDA events around Python calls), the
   kernel's device time (a CUDA graph of launches replayed, per launch;
   once on the same inputs, once on inputs rotated through more than the
   L2 cache holds), the plain version's time and the byte bound.
3b. ``probes``: the probe tools (voxelhashing_demo_tpu_torch/tools/, the
   port of the Pallas probes under tools/): each tool's ``main()`` once,
   every launch count set to 0 just before and read just after (each of
   K16 ``take_flat``, K17 ``take_along_axis``, K18
   ``gather_window_two_step``, K19 ``integrate_chunk``, K1 and K2 must
   launch).  At the probes' shapes (65 536 and 524 288 flat gathers from
   640x480, take_along_axis at (512, 256) / (512, 128), the two-step
   gather over 128 blocks x 512 x 256, one 128 x 512 integrate chunk on
   zero rows and on rows with weight) every kernel variant equals its
   plain version bit for bit.  Per variant: device time warm and L2-cold
   (CUDA-graph replay), wrapper time, the plain version's and the one
   PyTorch call's (``img.view(-1)[idx]``, ``torch.gather``); the frame
   step with the window gather off and on (``exp_landed``: in K7 on the
   step since K7 landed, its ``k1_launches`` K7's); the tools' own lines are
   kept off stdout.  Bounds from the tools' own inputs, counting the
   32-byte sectors that each gather's indices reach (``_probe_bounds``).
   The launch floor: the empty kernel (csrc/launch_floor.cu) through
   ``kernels.launch``, timed like the probe kernels
   (``tools/probe.launch_floor_ms``); a probe case within about 0.1 us
   of it is launch-bound.
3c. ``icp``: the ICP kernels (csrc/icp.cu: K4 ``icp_gn_level``, a
   pyramid level's whole Gauss-Newton loop in one cooperative launch for
   C candidates; K4s ``icp_sums``, one pass of its sums) on the flagship
   step's own inputs: the frame after the first N_STEP_FRAMES room-sweep
   frames through ``HashSLAM(flagship_gather_config())``, each K4 launch
   its pyramid makes (the L4 race: identity and motion-prior starts as
   C = 2 with the score epilogue; L2; L1: the 2x-pooled source against
   the 640x480 target).  Per launch: K4s's ``NormalSystem`` against
   ``build_normal_system(*associate(...))`` (rtol 1e-4, atol 1e-7; both
   beside the float64 sum of the kernel's own per-pixel terms) and bit
   for bit against its in-order reference, the score sums likewise (rtol
   1e-5 against plain, counts equal); the level bit for bit against the
   frozen-lane reference ``_level_reference``, each candidate against
   ``icp_align_reference`` (transforms 1e-5, error and count rtol 1e-3,
   iterations equal or a printed tie at tol2) and the race's pick against
   the plain race; host syncs (0), launches (one a level).  Times: each
   kernel alone by CUDA-graph replay, warm and L2-cold, µs an iteration,
   its wrapper, its plain version, the bound (24 bytes a source pixel, 8
   an iteration for each pixel that projects into the image), the launch
   floor and the barrier floor (csrc/launch_floor.cu's empty cooperative
   kernel with 8 grid barriers at the level's grid), and the least time
   max(bound, floor + barriers x barrier floor).  Then the race and a
   level captured in one CUDA graph and replayed equal to eager; the ICP
   stage of the step (``icp_align_pyramid``), kernel against the plain
   versions in turns plain / kernel / kernel / plain, the host µs that
   issue it, its host syncs, K4 launches (3) and device kernels
   (torch.profiler); the pair-ICP batch (4 candidates at the coarse
   level: one launch), syncs and ms, kernel and plain.  The pyramid hands
   K4 packed targets; the checks pack the levels' target Frames of the
   plain chain.
3d. ``preprocess``: the frontend and the pyramid's level inputs
   (csrc/preprocess.cu: K3a ``preprocess_frame``, raw depth to the
   frame's depth, vertices and normals; K3b ``pyramid_levels``, every
   level's source Frame and packed target) on the flagship step's own
   inputs, as ``icp`` takes them.  Each against its plain version
   (``preprocess_reference``; ``_pyramid_reference``, the chain of plain
   functions) bit for bit, field by field and level by level.
   Times as ``icp``'s (CUDA-graph replay warm and L2-cold, wrapper,
   plain, the bytes bound, launch floor and least time), K3a's host
   µs to issue a call and K3b's wrapper piece by piece
   (``k3b_wrapper_pieces``); the step's preprocess and ICP stages, kernels
   against the plain versions: host ms and device kernels
   (torch.profiler), the preprocess stage one kernel,
   the ICP stage at most 20; one K3a and one K3b launch a step.
3e. ``splat``: the splat surface prediction (csrc/splat.cu: K8
   ``splat_zbuffer``, the scatter-min z-buffer of the visible set with
   ``surface_filter`` as a row's skip and the row count read on the
   device; K9 ``splat_finalize``, hole fill, smooth, points and normals)
   on the flagship step's own splat: the arguments of the step's
   ``splat_raycast`` call on frame N_STEP_FRAMES of the room sweep, after
   the first N_STEP_FRAMES frames.  K8 against
   ``splat_depth_from_map_reference`` (with and without the band filter),
   K9 against ``finalize_depth_reference`` on the plain raw buffer (0 for
   none, the sharded path's input) and the pair against
   ``splat_raycast_reference``: bit for bit, field by field (depth,
   points, normals, hit).  Times as ``preprocess``'s (each kernel alone by
   CUDA-graph replay, warm and L2-cold; its wrapper, the reset and K8 for
   K8; its plain version; the bound from this run's rows and pixels; the
   launch floor and least time); the stage (``splat_raycast``) kernel
   against plain in turns plain / kernel / kernel / plain: host ms, host
   µs to issue, device kernels (torch.profiler, at most 3: the reset, K8,
   K9) and host reads (none); one K8 and one K9 launch a step.
3f. ``fuse``: visible-set compaction and integration (csrc/fuse.cu: K6
   ``compact_visible``, the frustum test of the whole table and the
   compaction in table order in one launch, a decoupled look-back over
   its tiles on a scratch that persists a stream; K7
   ``integrate_rows``, the update of the visible rows with the window
   gather's coverage and ``touch_active``'s stamp fused in) on the
   flagship step's own inputs: the map, frame and pose of the step's
   ``fuse_frame`` call on frame N_STEP_FRAMES of the room sweep, after the
   first N_STEP_FRAMES frames, the step's allocation applied to a copy.
   K6 against ``compact_visible_reference`` (the set, its order and
   count) and K7 against ``integrate_reference`` + ``touch_active`` in
   both gather modes and both signs (``max_born`` gating the last two
   frames' rows out of the de-integration), bit for bit on tsdf, weight,
   band_min, last_seen and born.  Times as ``splat``'s (K6 warm and
   L2-cold; K7 warm on the map, L2-cold on its live rows gathered into a
   map of their own; wrappers; plain versions; bounds from this run's
   table and rows; K6's least time the launch floor, beside it what one
   grid barrier among its tiles would cost; every K6 scratch left clean);
   the stage (compact -> touch -> integrate) kernel
   against plain in turns plain / kernel / kernel / plain: host ms, host
   µs to issue, device kernels (exactly 2) and host reads (none); one K6
   and one K7 launch a step.
3g. ``alloc``: block allocation (csrc/alloc.cu: K5a ``alloc_candidates``,
   the frame's candidate keys; K5b ``insert_blocks``, unique, cap, probe,
   bucket rank, free-list pop, scatter and row reset in one cooperative
   launch) on the flagship step's own ``allocate_from_frame`` call on
   frame N_STEP_FRAMES of the room sweep, its map copied before the call.
   K5a against ``frame_candidate_keys_reference`` bit for bit; K5b against
   ``insert_blocks_reference`` on every map field and n_alloc, bit for
   bit, in four cases: the step's map; max_new_per_frame cut to
   ALLOC_CAP (the cap path); free_top below the new keys (the heap runs
   dry mid-bucket); a table of ALLOC_FULL_BUCKETS buckets filled to 3 and
   4 by the candidates of a shifted pose (the in-bucket rank overflows).
   The distinct keys U and n_alloc of the step's frame.  Times: K5a warm
   and L2-cold (CUDA-graph replay), K5b warm and L2-cold (a CUDA graph of
   8 or 32 launches on copies of the map's integer state, restored before
   each replay, captured on the warm-up's stream; CUDA events around one
   replay, over its launches) and, with a graph of 1 launch, its own
   device µs a launch by torch.profiler in each (what a replay's fixed
   cost adds to the events' time), wrappers and K5b's host µs
   to issue a call, plain versions, bounds from this run's keys and
   rows, least times (the launch floor; plus one grid barrier for K5b's
   grid-wide arrival); every K5b scratch left clean (its counts 0, its
   set empty); the stage (``allocate_from_frame``) kernel against plain in
   turns plain / kernel / kernel / plain: host ms, host µs to issue, device
   kernels (exactly 2) and host reads (none); ``fuse_frame``'s host reads
   (none; 16 before K5); one K5a and one K5b launch a step.  Then K10
   (csrc/maintain.cu ``gc_free``, ``garbage_collect`` on the card)
   against ``garbage_collect_reference`` bit for bit on the flagship's GC
   frame's own map (frame 15 of the sweep: the age gate keeps every row)
   and on the same map 16 frames later (the weight test runs, blocks are
   freed); the call's device kernels (at most MAINT_GC_KERNELS), device
   µs, host ms and host reads (none); K10 alone warm and L2-cold (a CUDA
   graph of 8 and 32 launches on copies of the map's integer state, its
   own µs by the profiler), its wrapper, the plain version, the bound from
   the map and the least (the floor and one status exchange); and the
   whole step's host reads and device kernels on the next frame (what
   stands between the step and a CUDA graph).
4. ``parity``: the port on the card (kernel) against the port on the CPU
   (plain gather) over 10 frames at 80x60: per-frame pose translation
   within 1e-4 m.
5. ``slice``: 12 synthetic 640x480 frames through
   ``HashSLAM(flagship_gather_config())`` (splat prediction); asserts the
   window gather (in K7) ran on every frame, >= 11/12 frames tracked,
   finite poses, unaligned ATE and render hit fraction inside their
   bounds.
6. ``march``: 24 frames of the noisy room sweep through the same
   configuration with ``raycast.mode = "march"``; asserts the window
   gather (in K7) ran on every frame, >= 23/24 tracked, finite poses, ATE and hit
   fraction inside bounds set from the JAX package on the same frames;
   then ``render`` from the last pose, the surface point cloud and the
   mesh of the card's map (non-empty, finite, points on the room's
   surface).  The march kernels (csrc/raycast.cu): one K12
   ``densify_cache`` and one K11 ``raycast_march`` launch a frame; K12
   against ``densify_active_reference`` (sdf, weight, origin, voxel
   size) and K11 against ``raycast_rays_reference`` on the plain cache
   (depth, points, normals, hit), and ``raycast_hash`` against the plain
   chain, bit for bit, on the final map and pose, on the final map from
   the identity pose (a render at another pose) and on a copy of the map,
   set and pose of frame 12's prediction; the stage (``raycast_hash``)
   makes no host read and runs at most the pixel rays' kernels, K12's two
   device kernels and K11's; each kernel alone warm and L2-cold (CUDA-graph
   replay into buffers of its own), its wrapper, its plain version, the
   bound from this run's data (K12: the cache written and the rows in it
   read; K11: its outputs and the 32-byte cache sectors its samples
   reach, or its float operations a step, counted by ``_march_work``),
   registers and spills.  Prints per-frame times, the march stage alone
   at the final state (``march_stage_ms``: kernels and plain versions)
   beside the frame, peak memory.
7. ``streamed_entry``: the streamed gather's public entry point on the
   frame step's own gather inputs (the last sweep frame's visible rows,
   any row count), with its launch count set to 0 just before.
7b. ``dense``: the dense pipeline, BASELINE config 1: ``DenseSLAM``
   (preprocess -> ICP against the raycast model -> fuse -> raycast) on
   the slice's 20-frame orbit at 640x480, 2 cm voxels, truncation 0.08,
   max_steps 128, on the 160 x 128 x 160 grid at (-1.6, -0.7, 0) of
   tests/test_dense_pipeline.py (config 1's 128^3 cube does not hold the
   scene).  Asserts: every frame but frame 0 tracked, unaligned ATE below
   twice the JAX ``DenseSLAM``'s on the same frames, hit fraction above
   JAX's - 0.1, a finite render equal to ``raycast_rays_reference`` bit
   for bit; one K20 ``integrate_dense`` launch a frame and one K11 a frame
   and the render.  On the step's inputs kept at frames 10 and 19: K3b's
   pack of the model, K20, K11 and the model bit for bit against their
   plain versions, K4 against the plain loop (transform 1e-5, equal
   iterations or a tie at tol2), no host read in a step, at most
   DENSE_STEP_KERNELS_MAX device kernels.  K20 against
   ``integrate_dense_reference`` bit for bit and timed (warm, L2-cold,
   wrapper, plain, the bound from the input's data) on the final volume
   and on a 512^3 volume over a 3 m cube fused from the room sweep's first
   two frames.  Prints per-frame ms, the step's ms, device kernels, busy
   µs and idle share, peak memory.

8. ``backend``: ``KeyframeSLAM(flagship_gather_config())`` with the
   keyframe settings ``BACKEND_KEYFRAMES`` on 48 frames of a noisy
   150-degree room sweep with two injected drifts (``BACKEND_INJECT``).
   Asserts: >= 1 accepted loop edge, >= 2 BA events, the first map update
   a full rebuild and a later one incremental with something moved, no
   saturated reintegration, no ring overflow, every frame but frame 0
   tracked, unaligned ATE below the frontend-only ``HashSLAM`` on the same
   injected run and below twice the JAX figure; K7's window-gather
   launches (K1's before K7 took its work), counted from 0, equal frames
   + keyframes fused by full rebuilds + 2 x moves; K7 equals the plain
   integrate bit for bit on a de-integration call's rows; a map fused from
   scratch from the ledger renders like the maintained one; ``optimize``
   on a seeded ring graph at K = 64 (dense) and K = 512 (CG) agrees with
   the CPU within 1e-4 and repeats bit for bit; one relocalization
   attempt recovers a mid-run frame's pose within 5 cm.  The BA kernels
   (``pg_case``) on the run's final graph (K = 32) and on both ring
   graphs: K13a ``pg_edge_blocks`` in dense, CG and chi2 mode (J, r, the
   edge rows, b, chi2, H or Hd), K13b ``pg_cg_solve`` (the CG step and its
   retract, the same iteration count) and K13c ``pg_retract`` (on the
   library's dense solve) within 1e-6 of each tensor's scale of their
   plain versions on the card; ``optimize`` within 1e-5 of
   ``optimize_reference`` on the card, two runs bit for bit, 0 host syncs
   and returning while a sleep kernel ahead of it still runs; a BA solve
   and its fetch 1 host sync (``_fetch_ba``).  Their launches made by the
   checks are not counted.  Prints ms per pair-ICP batch, BA solve,
   rebuild fuse, move, keyframe insert and relocalization, host
   synchronisations per piece (and the Python lines they come from, for a
   BA solve and a fuse), peak memory; each K13 kernel's warm, L2-cold,
   plain and issue times, bound and least, and cuSOLVER's factor + solve
   of the same dense system.
9. ``stream``: out-of-core streaming, BASELINE config 5 (bench.py
   ``_streaming_run``): the 201-frame noisy 170-degree room sweep out and
   back through ``HashSLAM`` with a 2048-block map (``STREAM_HASH``) and
   streaming every 8 frames at age 16, after ``warm_stream`` on a
   throwaway instance.  Asserts: tracked frames within 2 of the JAX run's,
   unaligned ATE below twice the JAX figure, more blocks evicted than the
   map holds, > 100 restored, more distinct blocks on the device and in
   the store together than the map holds; a non-streaming twin on the
   same frames exhausts the heap, with its ATE below twice the JAX twin's
   (it tracks no worse than the streaming run on these frames, in the JAX
   package as here: printed as ``tracks_worse``); K7's window gather once
   per frame, K7 equal to the plain integrate on the last frame's rows.
   Prints frame ms by class (the frame that runs the cycle's dispatch, the
   one that runs its completion, the rest), evict / restore ms (CUDA
   events), the copies' bytes and device µs per batch, host syncs of the
   eviction scan, a restore, a dispatch and a completion (``sync_sites``;
   none in the eviction and the restore), peak device memory and pinned
   host bytes.  K14 (``evict_free``) and K15 (``restore_rows``,
   csrc/maintain.cu) against ``evict_stale_reference`` and
   ``restore_blocks_reference`` bit for bit on every call the run made,
   on copies of the call's own map and batch (``CallRecorder``); then
   each on the call that moved the most rows: warm and L2-cold (CUDA-graph
   copies, as K10), wrapper, plain, the bound from that call's data, the
   least (the floor and one status exchange or arrival).
10. ``stream_backend``: the same frames through the streaming
   ``KeyframeSLAM`` (bench.py ``_streaming_backend_run``: interval 12,
   age 24, ``STREAM_BACKEND_KEYFRAMES`` over the flagship's keyframe
   settings), after ``warm_compile``.  Asserts: ATE below the ``stream``
   phase's and below twice the JAX figure, no spill overflow, restore
   counters carried, no saturation, keyframes within one of the JAX run's,
   K7's window-gather launches = frames + keyframes fused by full
   rebuilds + 2 x moves, K7 equal to the plain integrate; then a full
   rebuild into a fresh store: the run's own or, when its BA corrections
   stayed under the rebuild thresholds (as in the JAX run on these
   frames), one asked for after the run (fresh store, counters carried,
   K7 once per keyframe).  Prints what
   ``stream`` prints and the decisions beside the JAX run's.
11. ``cli``: the application layer.  The same 201 frames exported as a
   TUM directory (``tum.export_sequence``, native codec); the first
   N_CLI_LIBRARY through ``stream.FramePipeline`` into ``KeyframeSLAM``
   under the CLI's ``_default_config`` with the window gather on, saved
   with ``checkpoint.save_keyframe_slam`` (reloaded bit-exact); then
   ``cli.main(["run", "--dataset", ..., "--backend", "keyframe",
   "--resume", ...])`` in this process.  The stored config carries the
   gather, so K7 does it on every resumed frame.  Asserts: K7's
   window-gather launches, counted from 0, == resumed frames + keyframes
   fused by full rebuilds + 2 x moves; the JSON keys equal the JAX CLI's on the same frames,
   keyframes within one of JAX's, loop edges within one keyframe's batch;
   tracked >= all but 1; unaligned ATE < 2 x the JAX figure.  Then
   ``render --orbit 3 --ply --mesh``, ``info`` and ``evaluate`` on the
   outputs (exports non-empty and finite, evaluate's ATE equals the run's,
   the run's checkpoint reloads bit-exact), the hash backend over the real
   PNG16 fixture ``tests/fixtures/kinect_png16`` and ``demo`` on two of its
   files (as the JAX CLI; every frame decoded by the native codec).
   Prints the CLI's fps, frame ms p50 / p99 / max (``StageTimer`` around
   ``process``, CUDA events), the pipeline consumer's waits, checkpoint
   bytes and save / load seconds, peak device memory.
   Last, ``run --devices N`` with more ranks than cards exits naming
   both counts (``cli_devices``).
12. ``bench``: the benchmark twin (voxelhashing_demo_tpu_torch/bench.py).
   ``cli.main(["bench", "--quick"])`` in this process (the JAX bench's
   quick keys plus ``detail.device``, the card's nvidia-smi line), then
   each section function at the cut frame counts of ``BENCH_SECTIONS`` at
   ``flagship_config()`` (640x480, the gather off as in the JAX bench).
   Asserts per section: the key set of bench.py's (``BENCH_KEYS``), every
   fps > 0, finite ATE, the decisions equal to the JAX run's on the same
   frames (``JAX_REFERENCE_BENCH``; keyframes within one, loop edges
   within one insert's batch, tracked within 2, block counts within
   0.1 %) and every ATE below twice JAX's.  Then ``_long_run`` at
   ``BENCH_GATHER`` under ``flagship_gather_config()``: K7's window-gather
   launches, counted from 0, == frame steps == 2 x frames + 1 + chunk, and
   K7 equal to the plain integrate on the last call's depth and pose; its
   decisions and ATE against JAX's as above.
   Prints each section's line, seconds and peak device memory.
13. ``entry``: ``entry()`` (voxelhashing_demo_tpu_torch/entry.py, the
   twin of __graft_entry__.py) on the card: its ``fn`` on the zero frame
   it returns, then the first two sweep frames; poses finite, blocks
   allocated on the sweep frames; ms per step.
14. ``dryrun``: ``dryrun_multichip(1)`` on one NCCL rank and
   ``dryrun_multichip(2, backend="gloo")`` with both ranks on the card:
   the JAX dry run's sequence and checks (sharded step, keyframe backend
   with streaming, rebuild, incremental move, render hit > 0.1, sharded
   BA); the ranks agree.
15. ``roofline``: ``tools/roofline.main()`` under ``flagship_config()``
   (the gather off, as the JAX tool) and under ``flagship_gather_config()``:
   the
   five primitives (device time, CUDA-graph replay) beside the launch
   floor, the seven stage ms, the bounds and % of bound, and beside them
   the same model's data volumes over the card's HBM rate
   (``hbm_bounds_ms``, ``pct_of_hbm_bound``); K7's window-gather launches
   counted from 0 in each: none without the gather, 24 sweep frames + 21
   integrate + 21 full-step calls with it (the ``roofline`` path); K7
   bit-exact against the plain integrate on that run's last call's depth
   and pose (``k7_bit_exact``).
16. ``bench_micro``: ``tools/bench_micro.measure()``, the sixteen
   primitives, host ms and device ms.
17. ``scaling``: ``tools/scaling_bench`` at 640x480 over the cards
   present (NCCL, a card per rank); with one card, two Gloo ranks on it
   as a line of its own marked ``shared_card`` (it checks the partition,
   not the speed of two cards).
18. ``nccl``: one rank over NCCL (``parallel.launch.spawn``): the
   collective helpers (``ranks.collectives``) exact, then
   ``ShardedHashSLAM(flagship_gather_config())`` on the slice's 12 frames,
   K7's window gather on every frame.  This one-rank run is the reference partition
   of ``sharded``.
19. ``sharded_backend``: ``KeyframeSLAM(mesh)`` on two Gloo ranks sharing
   the card over the first 24 frames of the backend scenario (the drift
   before frame 18): decisions (keyframe frames, edges, BA frames, rebuild
   modes, moves, tracked, capacity, saturation) equal on both ranks and
   to a one-rank NCCL mesh's; unaligned ATE below twice the single-card
   ``KeyframeSLAM``'s on the same frames; K7's window-gather launches per
   rank = frames + rebuild fuses + 2 x moves; K13a and K13c launched on
   each rank (each rank's ``build_normal_equations`` and
   ``apply_update``).  Prints BA ms per solve and the staged collective
   bytes.
20. ``sharded``, the slice's main path: ``ShardedHashSLAM`` on two Gloo
   ranks sharing the card at ``flagship_gather_config()`` (32 768 blocks
   a rank) over the slice's 12 frames.  Asserts: per-frame allocated and
   active blocks equal to the one-rank NCCL run's, poses within 5e-4 m of
   it, replicated poses bit-identical on both ranks, unaligned ATE <
   7.5 mm, the ranks' key sets disjoint with the one-rank map's as their
   union, render hit fraction > 0.8, K7's window gather once per frame on
   each rank (counted from 0 in each rank) and K7 bit-exact against the
   plain integrate on each rank's own rows.  Prints per-rank frame ms p50 / max,
   staged collective bytes and collectives per frame, peak memory per
   rank, and the single-card ``HashSLAM`` beside it (ATE, pose gap,
   counts: the sharded step is the JAX package's, which pools the coarse
   ICP source by its minimum, so it is not the single-device step).

Then the kernel summary line: K1 and K2 with the times and bound of the
``step_rows`` case, the rows the frame step gives the window gather
(``launches`` is the count of the last path that drives the kernel:
``probes`` for K1, whose work on the frame paths K7 does since K7 landed;
``bound_ms`` is 14 bytes per voxel plus the depth image once over the
card's memory rate); K16-K19 with their ``probes`` counts and the
times of their first tool case (65 536 flat gathers; axis 0; the two-step
gather; the integrate chunk alone), the others under ``cases``, and the
launch floor of this run (``floor_ms``);
``launches_by_path`` has each path's own count; K4 and K4s with the
times and bound of the L1 case (the others under ``cases``), counted from
0 on every path that runs the frame step (``parity`` through
``roofline`` in this process, rank 0's count on ``nccl``,
``sharded_backend`` and ``sharded``): K4 must launch on every
single-card path (the pyramid) and on ``sharded_backend`` (its pair-ICP
batches), K4s on the three multi-rank paths (the sharded level's
systems); ``launches`` is the count of the last path that drives each.
K3a and K3b with the times and bound of the ``preprocess`` phase,
counted like K4 on the same paths, must launch on every one (K3a once a
``preprocess`` call, K3b once a flagship frame and once a keyframe's
pooled frame).  K8 and K9 with the times and bound of the ``splat``
phase, counted like K3 on the same paths: they must launch on every path
that predicts by splatting and on each rank of the multi-rank paths, and
never on ``march``.  K6 and K7 with the times and bound of the ``fuse``
phase, counted like K3 on the same paths: they must launch on every path
and rank; K7's entry also carries ``launches_window_by_path``, its
window-gather launches on each path (the former K1 gates).  K5a and K5b
with the times and bound of the ``alloc`` phase, counted like K3 on the
same paths: they must launch on every path and rank.  K13a-c
(``pg_edge_blocks``, ``pg_cg_solve``, ``pg_retract``) with the times and
bound of the ``backend`` phase's final graph (the ring graphs under
``cases``), counted like K3 on every path, and on ``backend_ba_K64_dense``
and ``backend_ba_K512_cg`` (each ring graph's first ``optimize``: K13a
each iteration and twice for chi2, K13c or K13b each iteration);
``launches`` the ``backend`` path's count (K13b's the K = 512 ring's, the
path that drives it: the backend's capacity 32 takes the dense solver).
K13a and one of K13b / K13c must launch on every path with a
BA event (``backend``, ``stream_backend``, ``cli``, ``bench``; K13a and
K13c on each rank of ``sharded_backend``) and none on the frontend-only
paths (``parity``, ``slice``, ``march``, ``stream``, ``entry``,
``roofline``); ``library_ms`` null (no PyTorch call computes them; the
dense step's cuSOLVER time is ``cusolver_ms``), ``ptxas`` each kernel's
registers and spills.  K10, K14 and K15 (``gc_free``, ``evict_free``,
``restore_rows``) with the times and bound of the ``alloc`` phase's GC
frame (K10) and of the ``stream`` phase's largest call (K14, K15),
counted like K3 on every path (rank 0's on the multi-rank paths): on
each path one launch a ``garbage_collect``, ``evict_stale`` or
``restore_blocks`` call on the card (``MaintCalls``; the checks' own
launches are not counted), K10 on ``march``, ``backend``, ``stream``,
``stream_backend`` and each rank of ``sharded_backend``, K14 and K15 on
``stream`` and ``stream_backend``; ``launches`` the ``stream`` path's.
K11 and K12 (``raycast_march``, ``densify_cache``) with the times and
bound of the ``march`` phase's final state, counted like K3 on every
path (rank 0's on the multi-rank paths): both on ``march``, neither on
any other path (they predict by splatting); ``launches`` the ``march``
path's; library none.  K20 (``integrate_dense``) with the times and
bound of the ``dense`` phase's final volume (the 512^3 volume under
``cases``), counted like K3 on every path (rank 0's on the multi-rank
paths): on ``dense`` and on no other path; ``launches`` the ``dense``
path's; library none.
  Last, the contract line
``{"ok": true, "device": {...}}``.  Any failed check raises (exit 1).
"""

import contextlib
import ctypes
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

H, W, C, V = 480, 640, 4096, 512
# rows at the slice's last frame (JAX reference); timed beside C = 4096
C_SLICE = 832
C_ODD = 4099          # not a multiple of 8: the streamed kernel only
N_FRAMES = 12
N_MARCH = 24
N_STEP_FRAMES = 6     # sweep frames run to get the step's own gather rows
# The JAX package on the CPU (Pallas kernel in interpret mode) on the same
# frames at flagship_gather_config(), from tests/torch_port_reference.py:
# accuracy references, not speeds.
JAX_REFERENCE = {"frames": 20, "tracked": 19, "ate_mm": 3.757,
                 "hit_frac": 0.9282, "active_blocks": 832,
                 "blocks_freed": 0}
JAX_REFERENCE_MARCH = {"frames": 24, "tracked": 23, "ate_mm": 21.857,
                       "hit_frac": 0.9845, "active_blocks": 896,
                       "blocks_freed": 0}
# The backend phase: 48 frames of a 150-degree noisy room sweep with two
# injected drifts (the live pose is left-multiplied by exp(twist) just
# before the frame), through KeyframeSLAM at the flagship gather width.
# Keyframe settings of the JAX package's drift scenario
# (tests/test_reintegration.py) with the keyframe image at a quarter of
# 640x480 (160x120) and the inlier gate scaled to it (800 of 80x60 there
# -> 3200 of 160x120 here).
N_BACKEND = 48
BACKEND_SWEEP_DEG = 150.0
BACKEND_INJECT = {
    18: (0.04, -0.03, 0.025, 0.0, 2.0, 0.0),      # m, m, m, deg, deg, deg
    34: (-0.03, 0.025, -0.02, 0.0, -1.5, 0.0),
}
BACKEND_KEYFRAMES = dict(
    max_keyframes=32, max_edges=128, min_rotation_deg=5.0,
    min_translation=0.06, icp_downsample=4, loop_radius=0.6,
    min_loop_separation=6, min_loop_inliers=3200, max_loop_error=1e-4,
    ba_iters=8, rebuild_map=True, rebuild_min_trans=0.03,
    rebuild_incremental=True, sync_every=1,
)
# tests/torch_port_reference.py backend: the JAX KeyframeSLAM on the CPU on
# the same frames, settings and injections
JAX_REFERENCE_BACKEND = {
    "frames": 48, "tracked": 47, "keyframes": 26, "edges": 79,
    "loop_edges": 54, "ba_events": 19,
    "ba_modes": ["full", None, None, "incremental", "incremental",
                 "incremental", "incremental"] + [None] * 12,
    "keyframes_reintegrated": [0, 0, 0, 6, 5, 1, 1] + [0] * 12,
    "ate_mm": 16.453,
}
# The streaming phases: BASELINE config 5 (bench.py ``_streaming_run`` and
# ``_streaming_backend_run``), a noisy 170-degree room sweep out and back
# (101 frames forward, then the same frames back: 201) through a map cut
# to 2048 blocks, about two thirds of what the sweep touches, so eviction
# and restore stay active the whole run.
N_STREAM_HALF = 101
STREAM_SWEEP_DEG = 170.0
STREAM_HASH = dict(num_buckets=8192, bucket_size=4, num_blocks=2048,
                   max_active=2048, max_new_per_frame=2048)
STREAM = dict(enabled=True, interval=8, max_age=16, max_evict=2048,
              max_restore=2048)
STREAM_BACKEND = dict(STREAM, interval=12, max_age=24)
STREAM_BACKEND_KEYFRAMES = dict(
    min_loop_separation=8, loop_radius=0.35, min_rotation_deg=15.0,
    min_translation=0.25, rebuild_move_min_trans=0.02,
    rebuild_move_min_rot_deg=1.0)
# tests/torch_port_reference.py stream / stream_twin / stream_backend: the
# JAX package on the CPU on the same frames and settings.  Neither run
# rebuilds the map (the two BA corrections stay under the rebuild
# thresholds), and the twin without streaming exhausts the heap but tracks
# no worse than the streaming run on these frames.
JAX_REFERENCE_STREAM = {"frames": 201, "tracked": 200, "ate_mm": 30.113,
                        "evicted": 3060, "restored": 1617,
                        "store_blocks": 1443, "twin_ate_mm": 29.210,
                        "twin_min_free_blocks": 0}
JAX_REFERENCE_STREAM_BACKEND = {
    "frames": 201, "tracked": 200,
    "keyframe_frames": [0, 9, 18, 27, 36, 45, 54, 63, 72, 81, 90, 99, 110,
                        119, 128, 137, 146, 155, 164, 173, 182, 191, 200],
    "edges": 45,
    "loop_edges": [[6, 15], [5, 15], [6, 16], [7, 16], [5, 16], [5, 17],
                   [6, 17], [4, 17], [4, 18], [5, 18], [3, 18], [3, 19],
                   [4, 19], [2, 19], [2, 20], [3, 20], [1, 20], [1, 21],
                   [2, 21], [0, 21], [0, 22], [1, 22], [2, 22]],
    "ba_frames": [192, 201], "ba_modes": [None, None],
    "keyframes_reintegrated": [0, 0],
    "evicted": 2676, "restored": 1520, "store_blocks": 1156,
    "ate_mm": 9.154,
}
# The cli phase: the out-and-back frames exported as a TUM directory; the
# first N_CLI_LIBRARY frames go through the library (FramePipeline into
# KeyframeSLAM under the CLI's default configuration with the window
# gather on) and are saved, and ``run --resume`` continues from there.
N_CLI_LIBRARY = 24
CLI_RENDER_EVERY = 50
# tests/torch_port_reference.py cli: the JAX package's library run and CLI
# ``run --resume`` on the CPU on the same exported frames (Pallas kernel in
# interpret mode).  ``result`` is the CLI's JSON line (its fps is a CPU
# figure, not a reference); loop edges are the saved graph's.
JAX_REFERENCE_CLI = {
    "frames": 201, "library_frames": 24, "library_keyframes": 4,
    "result_keys": ["ate_rmse_m", "ate_rmse_unaligned_m", "backend_saturated",
                    "ba_runs", "checkpoint", "command", "fps", "frames",
                    "graph_capacity", "graph_edges", "keyframes",
                    "live_frames", "renders", "rpe_rot_rmse_deg",
                    "rpe_trans_rmse_m", "tracked_frames"],
    "resumed_frames": 177, "tracked": 177, "keyframes": 31,
    "graph_edges": 108, "ba_runs": 27, "loop_edges": 78, "live_frames": 3,
    "ate_mm": 27.97,
}
# tests/torch_port_reference.py fixture: the JAX CLI's hash ``run`` over
# tests/fixtures/kinect_png16 (8 real PNG16 frames, 640x480) and ``demo``
# on its first two files, on the CPU
JAX_REFERENCE_FIXTURE = {
    "result_keys": ["ate_rmse_m", "ate_rmse_unaligned_m", "checkpoint",
                    "command", "fps", "frames", "renders",
                    "rpe_rot_rmse_deg", "rpe_trans_rmse_m",
                    "tracked_frames"],
    "tracked": 7, "ate_aligned_mm": 10.42,
    "demo_occupied_blocks": 1596, "demo_icp_inliers": 98107,
    "demo_translation_m": [-0.08174049854278564, 0.005167483352124691,
                           0.00011866165732499212],
}
# The bench phase: the benchmark twin (voxelhashing_demo_tpu_torch/bench.py)
# section by section at flagship_config() (640x480, the gather off, as in
# the JAX bench), each at a cut frame count with its workload's shape kept:
# the backend's closed 360-degree pan in 96 frames (3.75 degrees a frame,
# keyframes every 15 degrees, the loop closes), the out-and-back in 101.
PER_CLOSURE = dict(ba_defer_edges=1, ba_defer_frames=0)
BENCH_SECTIONS = {
    "long_run": ("_long_run", dict(num_frames=64, chunk=8)),
    "keyframe_backend": ("_backend_run", dict(num_frames=96,
                                              warm_frames=12)),
    "per_closure_ba_incremental": ("_backend_run", dict(
        num_frames=96, warm_frames=8, frontend_baseline=False,
        kf_overrides=PER_CLOSURE)),
    "localized_micro": ("_incremental_micro", dict(num_frames=40)),
    "streaming_beyond_capacity": ("_streaming_run", dict(num_frames=100)),
    "streaming_plus_backend": ("_streaming_backend_run",
                               dict(num_frames=100)),
    "stages": ("_stage_breakdown", dict(frames=24, reps=5)),
}
# ``_long_run`` once more, on its frames, under flagship_gather_config():
# the window gather (in K7) on every step
BENCH_GATHER = dict(num_frames=64, chunk=8)
# bench.py's output keys, section by section (this script may not import
# it): the sections' own lines and the --quick line
BACKEND_RUN_KEYS = {
    "fps", "fps_sustained", "excluded_hitches", "frames", "sweep_deg",
    "ate_rmse_m", "ate_aligned_m", "keyframes", "loop_edges", "ba_runs",
    "rebuilds_full", "rebuilds_incremental", "keyframes_reintegrated",
    "rebuild_s_full_mean", "rebuild_s_incremental_mean", "max_frame_ms",
    "p50_frame_ms", "tracked"}
BENCH_KEYS = {
    "quick": {"metric", "value", "unit", "vs_baseline"},
    "long_run": {"fps", "dispatch_mode", "fps_per_frame_dispatch",
                 "fps_chunked", "chunk", "frames", "ate_rmse_m", "tracked",
                 "blocks_used", "blocks_active_final"},
    "keyframe_backend": BACKEND_RUN_KEYS | {
        "fps_frontend_only", "ate_frontend_only_m",
        "ate_frontend_aligned_m"},
    "per_closure_ba_incremental": BACKEND_RUN_KEYS,
    "localized_micro": {"keyframes", "moved", "incremental_s",
                        "full_rebuild_s", "speedup"},
    "streaming_beyond_capacity": {
        "fps", "frames", "ate_rmse_m", "tracked", "device_blocks",
        "evicted", "restored", "store_blocks_final"},
    "streaming_plus_backend": {
        "fps", "frames", "ate_rmse_m", "tracked", "keyframes", "loop_edges",
        "ba_runs", "rebuilds_full", "rebuilds_incremental", "device_blocks",
        "evicted", "restored", "store_blocks_final", "final_drain_s",
        "fps_end_to_end"},
    "stages": {"preprocess_ms", "icp_ms", "fuse_ms", "raycast_ms"},
}
# tests/torch_port_reference.py bench: the JAX bench.py's sections on the
# CPU on the same frames at the same counts, every field but the timings
JAX_REFERENCE_BENCH = {
    "long_run": {"chunk": 8, "frames": 64, "ate_rmse_m": 0.11214,
                 "tracked": 63, "blocks_used": 3698,
                 "blocks_active_final": 949},
    "keyframe_backend": {
        "frames": 96, "sweep_deg": 360.0, "ate_rmse_m": 0.04363,
        "ate_aligned_m": 0.03302, "keyframes": 24, "loop_edges": 5,
        "ba_runs": 1, "rebuilds_full": 1, "rebuilds_incremental": 0,
        "keyframes_reintegrated": 0, "tracked": 95,
        "ate_frontend_only_m": 0.07745, "ate_frontend_aligned_m": 0.03441},
    "per_closure_ba_incremental": {
        "frames": 96, "sweep_deg": 360.0, "ate_rmse_m": 0.03843,
        "ate_aligned_m": 0.03427, "keyframes": 24, "loop_edges": 5,
        "ba_runs": 3, "rebuilds_full": 1, "rebuilds_incremental": 0,
        "keyframes_reintegrated": 0, "tracked": 95},
    "localized_micro": {"keyframes": 8, "moved": 2},
    "streaming_beyond_capacity": {
        "frames": 101, "ate_rmse_m": 0.06301, "tracked": 100,
        "device_blocks": 2048, "evicted": 2278, "restored": 1282,
        "store_blocks_final": 996},
    "streaming_plus_backend": {
        "frames": 101, "ate_rmse_m": 0.01804, "tracked": 100,
        "keyframes": 21, "loop_edges": 20, "ba_runs": 2, "rebuilds_full": 1,
        "rebuilds_incremental": 0, "device_blocks": 2048, "evicted": 4176,
        "restored": 1076, "store_blocks_final": 2312},
    # _long_run at BENCH_GATHER with the Pallas gather (interpret mode)
    "gather": {"chunk": 8, "frames": 64, "ate_rmse_m": 0.11214,
               "tracked": 63, "blocks_used": 3698,
               "blocks_active_final": 949},
}
# one keyframe more or less moves the loop edges by at most one insert's
# candidate batch: loop_max_batch - 1 = 3 (KeyframeConfig default)
CLI_LOOP_EDGE_SLACK = 3
# the bench phase's decisions against JAX: equal but for these (keyframes
# within one as the cli phase; tracked frames within 2 as the stream phase)
BENCH_SLACK = {"keyframes": 1, "loop_edges": CLI_LOOP_EDGE_SLACK,
               "tracked": 2}
# block counts follow each package's own trajectory at the voxel scale
# (ROADMAP Queue 3, F2): within 0.1 % of JAX's, the share the float map
# rows are held to (the 64-frame long run on an H100: 3 699 blocks used
# against JAX's 3 698, ATE equal)
BENCH_BLOCK_COUNTS = ("blocks_used", "blocks_active_final", "evicted",
                      "restored", "store_blocks_final")
BENCH_BLOCK_RTOL = 1e-3
ATE_BOUND_MM = 7.5
HIT_BOUND = 0.8
PARITY_ATOL_M = 1e-4
# H100 SXM data sheet: device memory rate and float32 rate outside the
# tensor cores (the gather's few integer operations are counted at it)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# v 4, u 4, valid 1 read; value 4, covered 1 written.  The depth image is
# the function's fourth input and is counted once, whole, in _bound.
BYTES_PER_VOXEL = 14
OPS_PER_VOXEL = 10        # 2 min, 2 subtract, 4 compare, 2 address

KERNEL_META = {
    "gather_depth_window": {
        "route": "cuda",
        "source": "voxelhashing_demo_tpu_torch/csrc/window_gather.cu",
        "replaces": "voxelhashing_demo_tpu/ops/pallas_gather.py:88",
    },
    "gather_depth_window_streamed": {
        "route": "cuda",
        "source":
            "voxelhashing_demo_tpu_torch/csrc/window_gather_streamed.cu",
        "replaces": "voxelhashing_demo_tpu/ops/pallas_gather.py:143",
    },
    "take_flat": {
        "route": "cuda",
        "source": "voxelhashing_demo_tpu_torch/csrc/take_flat.cu",
        "replaces": "tools/exp_pallas_integrate.py:131, "
                    "tools/exp_pallas_integrate.py:158, "
                    "tools/exp_pallas_vmem_gather.py:69, "
                    "tools/exp_pallas_vmem_gather.py:89, "
                    "tools/exp_pallas_vmem_gather.py:117, "
                    "tools/exp_pallas_gather.py:63",
    },
    "take_along_axis": {
        "route": "cuda",
        "source": "voxelhashing_demo_tpu_torch/csrc/take_along.cu",
        "replaces": "tools/exp_pallas_gather2.py:57, "
                    "tools/exp_pallas_gather2.py:79, "
                    "tools/exp_pallas_gather2.py:101",
    },
    "gather_window_two_step": {
        "route": "cuda",
        "source":
            "voxelhashing_demo_tpu_torch/csrc/window_gather_two_step.cu",
        "replaces": "tools/exp_pallas_gather2.py:145",
    },
    "integrate_chunk": {
        "route": "cuda",
        "source": "voxelhashing_demo_tpu_torch/csrc/integrate_chunk.cu",
        "replaces": "tools/exp_pallas_integrate.py:209",
    },
}
WINDOW_KERNELS = ("gather_depth_window", "gather_depth_window_streamed")
# the probe tools (voxelhashing_demo_tpu_torch/tools/), in the order the
# ``probes`` phase runs their main()
PROBE_TOOLS = ("exp_vmem_gather", "exp_gather", "exp_gather2",
               "exp_integrate", "exp_landed")


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def _gather_cases(rng):
    """(name, v, u, valid) numpy cases, as in tests/test_pallas_gather.py
    but at C=4096 rows, plus spread 120 at the slice's row count and at a
    row count that is no multiple of 8."""
    cases = []
    for name, spread, rows in (("spread120", 120, C),
                               ("spread400", 400, C),
                               ("spread120_c832", 120, C_SLICE),
                               ("spread120_c4099", 120, C_ODD)):
        v0 = rng.integers(0, H - spread, size=(rows, 1))
        u0 = rng.integers(0, W - spread, size=(rows, 1))
        v = v0 + rng.integers(0, spread, size=(rows, V))
        u = u0 + rng.integers(0, spread, size=(rows, V))
        valid = rng.random((rows, V)) > 0.15
        cases.append((name, v, u, valid))
    v = np.full((C, V), 100)
    u = np.full((C, V), 200)
    valid = np.ones((C, V), bool)
    v[:, 0], u[:, 0], valid[:, 0] = H - 1, W - 1, False
    cases.append(("invalid_corner", v, u, valid))
    return cases


def _bound(rows: int, vlen: int = V, height: int = H, width: int = W):
    """(bound_ms, bound_by): the larger of bytes over the memory rate
    (every input read once, the depth image included, every output
    written once) and operations over the float32 rate, for ``rows``
    block rows of ``vlen`` voxels."""
    n = rows * vlen
    by_bytes = ((n * BYTES_PER_VOXEL + height * width * 4)
                / HBM_BYTES_PER_S * 1e3)
    by_ops = n * OPS_PER_VOXEL / FP32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def gather_inputs(slam, depth_raw, pose=None):
    """The window gather's inputs as ``integrate`` builds them for
    ``depth_raw`` on ``slam``'s map at ``pose`` (default: the current
    pose, as the frame step does; a keyframe's ledger pose gives the rows
    of a de-integration call): the visible rows at the pose (a row count
    no one chose), projected as integrate projects them.  Returns
    contiguous (depth (H, W) f32, v, u (C, 512) int32, valid (C, 512)
    bool)."""
    from voxelhashing_demo_tpu_torch.geometry import se3
    from voxelhashing_demo_tpu_torch.models.hash_slam import depth_tensor
    from voxelhashing_demo_tpu_torch.ops import hash_ops
    from voxelhashing_demo_tpu_torch.ops import preprocess as pre_ops

    cfg, st = slam.config, slam.state
    pose = st.pose if pose is None else pose
    frame = pre_ops.preprocess(depth_tensor(depth_raw, slam.device),
                               cfg.camera, cfg.frontend)
    active = hash_ops.compact_visible(st.hmap, cfg.hash, pose,
                                      cfg.camera, cfg.fusion)
    n = int(active.count)
    _, v, u, in_img, row_valid = hash_ops.project_rows(
        active.blocks[:n], active.ptrs[:n], cfg.hash, se3.inverse(pose),
        cfg.camera, cfg.fusion)
    return (frame.depth.contiguous(), v.contiguous(), u.contiguous(),
            (in_img & row_valid[:, None]).contiguous())


def step_rows(cfg, depths, device=None):
    """Run ``depths`` through ``HashSLAM(cfg)`` and return
    ``gather_inputs`` for the last frame at the final state."""
    from voxelhashing_demo_tpu_torch.models import hash_slam

    slam = hash_slam.HashSLAM(cfg, device=device)
    for d in depths:
        slam.process(d)
    return gather_inputs(slam, depths[-1])


def k7_window() -> int:
    """K7's launches in the window-gather mode since they were last set to
    0: the frame step's window gather, which K1 did before K7 took its
    work over (every gate that counted K1 on a frame path counts these)."""
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    return hash_ops.LAUNCHES_INTEGRATE_WINDOW


def zero_k7_window() -> None:
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    hash_ops.LAUNCHES_INTEGRATE_WINDOW = 0


def k7_check(slam, depth_raw, pose=None, sign: int = 1,
             max_born: int | None = None) -> dict:
    """K7 against the plain integrate (``tools/probe.integrate_check``) on
    the rows ``depth_raw`` fuses into ``slam``'s map at ``pose`` (default:
    the current pose; a keyframe's ledger pose with ``sign=-1`` and its
    ``max_born`` gives a de-integration call's rows): {"rows",
    "bit_exact", "max_abs_err"}, its launches not counted."""
    from voxelhashing_demo_tpu_torch.models.hash_slam import depth_tensor
    from voxelhashing_demo_tpu_torch.ops import preprocess as pre_ops
    from voxelhashing_demo_tpu_torch.tools.probe import integrate_check

    cfg, st = slam.config, slam.state
    pose = st.pose if pose is None else pose
    depth = pre_ops.preprocess(depth_tensor(depth_raw, slam.device),
                               cfg.camera, cfg.frontend).depth
    return integrate_check(st.hmap, cfg.hash, cfg.camera, cfg.fusion, depth,
                           pose, sign, max_born)


def tile_rows(t, rows: int):
    """(C, V) -> (rows, V): the rows of ``t`` repeated in order."""
    reps = -(-rows // t.shape[0])
    return t.repeat(reps, 1)[:rows].contiguous()


# (rows, row length) checked untimed on both kernels (the first takes row
# lengths up to 1024): row lengths that are no multiple of 4 and of 16
# (the streamed kernel's scalar loop), over 512 (the first kernel's
# 512-thread CTAs: 520, 1000, 1024), longer than a lane keeps in registers
# (1000, 4096), one row, fewer rows than the card has SMs
SHAPE_CASES = ((37, 510), (5, 520), (16, 1000), (9, 1024), (9, 4096),
               (1, 512), (100, 512))


def _check_shapes(torch, wg, depth, rng) -> int:
    """Both kernels against the plain version on the shapes they branch
    on, and on rows that start off a 16-byte boundary; returns the number
    of comparisons made."""
    dev = depth.device

    def shifted(a):
        buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=dev)
        view = buf[1:].view(a.shape)
        view.copy_(a)
        return view

    def draw(rows, vlen):
        return (torch.as_tensor(rng.integers(0, H, (rows, vlen)),
                                dtype=torch.int32, device=dev),
                torch.as_tensor(rng.integers(0, W, (rows, vlen)),
                                dtype=torch.int32, device=dev),
                torch.as_tensor(rng.random((rows, vlen)) > 0.15, device=dev))

    cases = [(f"C={r} V={n}", draw(r, n)) for r, n in SHAPE_CASES]
    v, u, m = draw(16, 512)
    cases.append(("unaligned rows", (shifted(v), shifted(u), shifted(m))))
    m = torch.zeros_like(m)
    m[1::2, 7] = True
    cases.append(("all-invalid rows", (v, u, m)))
    done = 0
    for what, (v, u, m) in cases:
        ref, ref_cov = wg.gather_depth_window_reference(depth, v, u, m)
        wrappers = [wg.gather_depth_window_streamed]
        if v.shape[1] <= 1024:
            wrappers.append(wg.gather_depth_window)
        for wrapper in wrappers:
            got, got_cov = wrapper(depth, v, u, m)
            torch.cuda.synchronize()
            _require(bool(torch.equal(got, ref)
                          and torch.equal(got_cov, ref_cov)),
                     f"{wrapper.__name__} == plain version at {what}")
            done += 1
    return done


def _kernel_cases(torch, rng, step_args):
    """(name, depth, v, u, valid) tensors on the card: the step's own rows
    first, then the synthetic cases on a random image."""
    dev = torch.device("cuda")
    depth_s, v_s, u_s, m_s = step_args
    cases = [("step_rows", depth_s, v_s, u_s, m_s),
             ("step_rows_x4096", depth_s, tile_rows(v_s, C),
              tile_rows(u_s, C), tile_rows(m_s, C))]
    depth = torch.as_tensor(rng.random((H, W), dtype=np.float32) + 0.5,
                            device=dev)
    for name, v, u, valid in _gather_cases(rng):
        cases.append((name, depth,
                      torch.as_tensor(v, dtype=torch.int32, device=dev),
                      torch.as_tensor(u, dtype=torch.int32, device=dev),
                      torch.as_tensor(valid, device=dev)))
    return cases


def phase_kernel(torch, wg, step_args):
    from voxelhashing_demo_tpu_torch.tools import probe

    rng = np.random.default_rng(0)
    kernels = (
        ("gather_depth_window", wg.gather_depth_window,
         wg.gather_depth_window_reference),
        ("gather_depth_window_streamed", wg.gather_depth_window_streamed,
         wg.gather_depth_window_streamed_reference),
    )
    rows = {}
    worst = {name: 0.0 for name, _, _ in kernels}
    cases = _kernel_cases(torch, rng, step_args)
    for case, depth, vt, ut, mt in cases:
        n_rows, vlen = (int(n) for n in vt.shape)
        bound_ms, bound_by = _bound(n_rows, vlen, *depth.shape)
        row = {"case": case, "C": n_rows, "V": vlen, "valid": int(mt.sum()),
               "bound_ms": bound_ms, "bound_by": bound_by}
        outs = {}
        for name, wrapper, plain in kernels:
            got, got_cov = wrapper(depth, vt, ut, mt)
            ref, ref_cov = plain(depth, vt, ut, mt)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            worst[name] = max(worst[name], err)
            exact = bool(torch.equal(got, ref)
                         and torch.equal(got_cov, ref_cov))
            _require(exact, f"{name} == its plain version bit for bit "
                            f"({case})")
            outs[name] = (got, got_cov)
            row[name] = {
                "bit_exact": exact, "max_abs_err": err,
                "covered": int(got_cov.sum()),
                **probe.timings(lambda *a: wrapper(depth, *a),
                                (vt, ut, mt)),
                "plain_ms": probe.host_ms(lambda: plain(depth, vt, ut, mt),
                                          iters=10),
            }
        (a, a_cov), (b, b_cov) = outs.values()
        _require(bool(torch.equal(a, b) and torch.equal(a_cov, b_cov)),
                 f"the two kernels agree bit for bit ({case})")
        rows[case] = row
    shapes = _check_shapes(torch, wg, cases[-1][1], rng)
    clipped = rows["spread400"]
    _require(clipped["gather_depth_window"]["covered"] < clipped["valid"],
             "spread-400 case clips something")
    _emit({"phase": "kernel", "H": H, "W": W, "shape_checks": shapes,
           "cases": list(rows.values())})
    return rows, worst


def _probe_bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by) for ``n_bytes`` moved and ``n_ops`` done."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / FP32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def _sector_bytes(flat) -> int:
    """Bytes of the distinct 32-byte sectors (8 float32) that the element
    offsets ``flat`` reach in a buffer that starts on a sector."""
    return 32 * np.unique(np.asarray(flat, np.int64).ravel() // 8).size


def _probe_bounds(tools) -> dict:
    """Each probe kernel's bound on the inputs its tool drew in this run
    (the tools draw them from a fixed seed): every index array read once,
    every output written once, and of each gathered source (the image,
    K18's dv rows) only the 32-byte sectors that this data's indices
    reach; a few integer operations per output."""
    import torch

    from voxelhashing_demo_tpu_torch.ops import integrate_chunk as ic

    vm = tools["exp_vmem_gather"].inputs()
    ga = tools["exp_gather"].inputs()
    g2 = tools["exp_gather2"].inputs()
    it = tools["exp_integrate"].inputs()
    flat, in_img, _ = (t.numpy() for t in ic.project_indices(
        torch.from_numpy(it["blocks"])))
    out = {"take_flat": {
        key: _probe_bound(idx.size * 8 + _sector_bytes(idx), idx.size * 4)
        for key, idx in (("n65536", vm["idx"]), ("n524288", ga["idx"]),
                         ("chunk", flat))}}
    rc = vm["r"].astype(np.int64) * vm["img2"].shape[1] + vm["c"]
    out["take_flat"]["rc"] = _probe_bound(rc.size * 12 + _sector_bytes(rc),
                                          rc.size * 6)

    def taa(src_stride, idx, axis):
        rows, cols = np.indices(idx.shape)
        at = (idx * src_stride + cols if axis == 0
              else rows * src_stride + idx)
        return _probe_bound(2 * idx.nbytes + _sector_bytes(at), idx.size * 4)

    out["take_along_axis"] = {
        "axis0": taa(g2["img"].shape[1], g2["v_idx"], 0),   # a view
        "axis1": taa(g2["src"].shape[1], g2["u_idx"], 1),
        "axis1b": taa(g2["src256"].shape[1], g2["u256"], 1)}
    du = g2["du"][..., :128].astype(np.int64)
    dv_rows = np.arange(du.shape[0] * du.shape[1]).reshape(du.shape[:2])
    dv_at = dv_rows[..., None] * g2["dv"].shape[-1] + du
    dv_pick = np.take_along_axis(g2["dv"], du, axis=-1).astype(np.int64)
    img_at = ((g2["v0"][:, None, None] + dv_pick) * g2["img"].shape[1]
              + g2["u0"][:, None, None] + du)
    out["gather_window_two_step"] = {"full": _probe_bound(
        2 * du.size * 4 + _sector_bytes(dv_at) + _sector_bytes(img_at)
        + g2["v0"].nbytes + g2["u0"].nbytes, du.size * 8)}
    n_vox = it["w_rows"].size
    out["integrate_chunk"] = {"chunk": _probe_bound(
        7 * 4 * n_vox + _sector_bytes(flat[in_img]), n_vox * 16)}
    return out


# the id each probe kernel carries in its tools' variant names
PROBE_TAGS = {"take_flat": "K16", "take_along_axis": "K17",
              "gather_window_two_step": "K18", "integrate_chunk": "K19"}
# (kernel, tool, kernel variant, plain variant, library variant or None,
# bound key): the case of each kernel that the kernels line reports first
PROBE_MAIN_CASES = (
    ("take_flat", "exp_vmem_gather", "take_flat flat 65k (K16; pallas_take)",
     "plain gather 65k from 307k (XLA img[i])", "torch img.view(-1)[idx] 65k",
     "n65536"),
    ("take_along_axis", "exp_gather2",
     "taa axis=0 (512,256) from (256,256) (K17)",
     "plain taa axis=0 (512,256) from (256,256)",
     "torch.gather taa axis=0 (512,256) from (256,256)", "axis0"),
    ("gather_window_two_step", "exp_gather2",
     "full per-block 2-step gather x128 blocks (K18)",
     "plain full per-block 2-step gather x128 blocks", None, "full"),
    ("integrate_chunk", "exp_integrate", "K19 integrate_chunk alone",
     "plain integrate_chunk alone", None, "chunk"),
)
# (kernel, tool, kernel variant, plain variant, library variant, bound key)
# of the further cases each kernel runs in its tools
PROBE_MORE_CASES = (
    ("take_flat", "exp_vmem_gather",
     "take_flat (512,128) idx (K16; pallas_take2)",
     "plain gather 65k from 307k (XLA img[i])", "torch img.view(-1)[idx] 65k",
     "n65536"),
    ("take_flat", "exp_vmem_gather",
     "take_flat 2D->flat (r, c) (K16; pallas_taa)",
     "plain gather 65k from 307k (XLA img[i])", "torch img.view(-1)[idx] 65k",
     "rc"),
    ("take_flat", "exp_gather", "take_flat 524k (K16; pallas_gather)",
     "plain gather 524k from 1.2MB (XLA img[i])",
     "torch img.view(-1)[idx] 524k", "n524288"),
    ("take_flat", "exp_integrate", "K16 gather alone", "plain gather alone",
     "torch img.view(-1)[idx] alone", "chunk"),
    ("take_along_axis", "exp_gather2", "taa axis=1 (512,128) lanes (K17)",
     "plain taa axis=1 (512,128) lanes",
     "torch.gather taa axis=1 (512,128) lanes", "axis1"),
    ("take_along_axis", "exp_gather2", "taa axis=1 (512,256) lanes (K17)",
     "plain taa axis=1 (512,256) lanes",
     "torch.gather taa axis=1 (512,256) lanes", "axis1b"),
)


def _probe_case(results, bounds, kname, tool, var, plain, lib, bkey):
    got, ref = results[tool][var], results[tool][plain]
    bound_ms, bound_by = bounds[kname][bkey]
    return {"tool": tool, "variant": var, "ms": got["ms"],
            "cold_ms": got["cold_ms"], "wrapper_ms": got["wrapper_ms"],
            "plain_ms": ref["wrapper_ms"], "plain_device_ms": ref["ms"],
            "library_ms": None if lib is None else results[tool][lib]["ms"],
            "bound_ms": bound_ms, "bound_by": bound_by}


def _probe_summary(results: dict, bounds: dict, floor_ms: float) -> dict:
    """{kernel: its kernels-line fields}: the main case's times and bound,
    the launch floor, the worst error over every variant that launches
    it, the further cases."""
    compared = {f"{t}: {v}": e for t, r in results.items()
                for v, e in r.items() if "bit_exact" in e}
    summary = {}
    for case in PROBE_MAIN_CASES:
        kname = case[0]
        tag = re.compile(rf"\b{PROBE_TAGS[kname]}\b")
        summary[kname] = {
            **_probe_case(results, bounds, *case),
            "floor_ms": floor_ms,
            "max_abs_err": max(e["max_abs_err"]
                               for w, e in compared.items()
                               if tag.search(w)),
            "cases": []}
    for case in PROBE_MORE_CASES:
        summary[case[0]]["cases"].append(_probe_case(results, bounds, *case))
    return summary


def phase_probes(torch, wg):
    """The probe tools' main() on the card, each once, with every launch
    count set to 0 just before and read just after; every kernel variant
    bit-exact against its plain version (K19 on zero rows and on rows with
    weight); the launch floor measured once.  Returns ({kernel:
    launches}, {kernel: summary})."""
    import importlib

    from voxelhashing_demo_tpu_torch.ops import image_gather as ig
    from voxelhashing_demo_tpu_torch.ops import integrate_chunk as ic
    from voxelhashing_demo_tpu_torch.tools import probe

    tools = {n: importlib.import_module(
        f"voxelhashing_demo_tpu_torch.tools.{n}") for n in PROBE_TOOLS}
    t0 = time.perf_counter()
    ig.LAUNCHES_TAKE_FLAT = ig.LAUNCHES_TAKE_ALONG = 0
    ig.LAUNCHES_TWO_STEP = ic.LAUNCHES = 0
    wg.LAUNCHES = wg.LAUNCHES_STREAMED = 0
    with contextlib.redirect_stdout(io.StringIO()):   # one JSON line a phase
        results = {n: tool.main() for n, tool in tools.items()}
    launches = {"take_flat": ig.LAUNCHES_TAKE_FLAT,
                "take_along_axis": ig.LAUNCHES_TAKE_ALONG,
                "gather_window_two_step": ig.LAUNCHES_TWO_STEP,
                "integrate_chunk": ic.LAUNCHES,
                "gather_depth_window": wg.LAUNCHES,
                "gather_depth_window_streamed": wg.LAUNCHES_STREAMED}
    seconds = time.perf_counter() - t0
    for kname, n in launches.items():
        _require(n > 0, f"{kname} launched in the probe tools")
    compared = [(f"{t}: {v}", e["bit_exact"]) for t, r in results.items()
                for v, e in r.items() if "bit_exact" in e]
    for what, exact in compared:
        _require(exact, f"{what} equals its plain version bit for bit")
    landed = results["exp_landed"]
    _require(landed["full step (window gather K1)"]["k1_launches"]
             >= tools["exp_landed"].REPS
             and landed["full step (XLA gather)"]["k1_launches"] == 0,
             "the landed tool's step does the window gather (in K7) on "
             "every timed frame with the gather on, never with it off")
    floor_ms = probe.launch_floor_ms()
    _emit({"phase": "probes", "seconds": seconds, "launches": launches,
           "bit_exact_checks": len(compared), "floor_ms": floor_ms,
           "results": results})
    return launches, _probe_summary(results, _probe_bounds(tools),
                                    floor_ms)


# The flagship ICP (K4, csrc/icp.cu): the pyramid's levels on the frame
# step's own inputs, each launch against its in-order reference and the
# plain loop.
ICP_KERNELS = ("icp_gn_level", "icp_sums")
ICP_META = {
    "icp_gn_level": {
        "route": "cuda",
        "source": "voxelhashing_demo_tpu_torch/csrc/icp.cu",
        "replaces": "voxelhashing_demo_tpu/ops/icp.py:136 (associate), "
                    "voxelhashing_demo_tpu/ops/icp.py:196 "
                    "(build_normal_system), "
                    "voxelhashing_demo_tpu/ops/icp.py:233 "
                    "(solve_normal_system), "
                    "voxelhashing_demo_tpu/ops/icp.py:252 (icp_align's "
                    "while_loop), voxelhashing_demo_tpu/ops/icp.py:358 "
                    "(pick_by_score), voxelhashing_demo_tpu/ops/icp.py:394 "
                    "(icp_align_pyramid's raced level): fused by XLA, no "
                    "Pallas kernel",
    },
    "icp_sums": {
        "route": "cuda",
        "source": "voxelhashing_demo_tpu_torch/csrc/icp.cu",
        "replaces": "voxelhashing_demo_tpu/ops/icp.py:136 (associate), "
                    "voxelhashing_demo_tpu/ops/icp.py:196 "
                    "(build_normal_system), "
                    "voxelhashing_demo_tpu/ops/icp.py:312 "
                    "(alignment_score_sums): fused by XLA, no Pallas kernel",
    },
}
ICP_SYSTEM_TOL = dict(rtol=1e-4, atol=1e-7)   # NormalSystem vs plain
ICP_SCORE_RTOL = 1e-5
ICP_T_ATOL = 1e-5           # transforms
ICP_ERR_RTOL = 1e-3         # error and count of a whole loop
ICP_TIE_RTOL = 1e-3         # a differing iteration count: dnorm vs tol2
ICP_MAIN_CASE = "L1"        # the fine level: the largest source
ICP_LEVELS = ["L4_race", "L2", "L1"]   # the pyramid's launches, in order
# bytes K4 must move: a source pixel's vertex and normal once a level, the
# packed target of each pixel that projects into the image once an
# iteration; ~150 float operations a pixel an iteration
K4_SRC_BYTES, K4_GATHER_BYTES, K4_OPS_PER_PIXEL = 24, 8, 150
PAIR_BATCH = 4              # candidates of the timed pair-ICP batch
BARRIER_SYNCS = 8           # grid barriers of the timed barrier floor


def icp_launches() -> list:
    """[K4, K4s] launches counted since they were last set to 0."""
    from voxelhashing_demo_tpu_torch.ops import icp

    return [icp.LAUNCHES_LEVEL, icp.LAUNCHES_SUMS]


def zero_icp_launches() -> None:
    from voxelhashing_demo_tpu_torch.ops import icp

    icp.LAUNCHES_LEVEL = icp.LAUNCHES_SUMS = 0


def icp_calls(torch, cfg, depths):
    """Run ``depths[:-1]`` through ``HashSLAM(cfg)`` and record the K4
    launches that the next step's pyramid makes for ``depths[-1]``:
    ([(name, srcs, tgts, lcam, lcfg, inits, race)], the pyramid's
    arguments, its keywords).  The coarsest level races the identity
    against the motion prior (C = 2), then each finer level runs once.
    The pyramid hands K4 packed targets (K3b makes no target Frame), so
    ``tgts`` are the levels' target Frames by the plain chain
    (``preprocess_metric_reference(downsample_depth(model))``, the model
    itself at factor 1), which pack to the same targets."""
    from voxelhashing_demo_tpu_torch.models import hash_slam
    from voxelhashing_demo_tpu_torch.ops import icp
    from voxelhashing_demo_tpu_torch.ops import preprocess as pre_ops

    slam = hash_slam.HashSLAM(cfg)
    for d in depths[:-1]:
        slam.process(d)
    st = slam.state
    frame = pre_ops.preprocess(hash_slam.depth_tensor(depths[-1],
                                                      slam.device),
                               cfg.camera, cfg.frontend)
    args = (frame.depth, st.model.depth, cfg.camera, cfg.icp)
    kw = dict(src_full=frame, tgt_full=st.model, prior_T=st.vel)
    calls = []

    def make(real):
        def fn(srcs, tgts, cam, lcfg, inits, race=False, packed=None):
            calls.append((list(srcs), cam, lcfg,
                          [None if i is None else i.clone() for i in inits],
                          race))
            return real(srcs, tgts, cam, lcfg, inits, race, packed)
        return fn

    def target(factor, lcam):
        if factor == 1:
            return st.model
        return pre_ops.preprocess_metric_reference(
            pre_ops.downsample_depth(st.model.depth, factor), lcam)

    with _wrapped(icp, "_align_candidates", make):
        icp.icp_align_pyramid(*args, **kw)
    named = []
    for srcs, lcam, lcfg, inits, race in calls:
        factor = cfg.camera.width // lcam.width
        named.append((f"L{factor}" + ("_race" if race else ""), srcs,
                      [target(factor, lcam)] * len(srcs), lcam, lcfg, inits,
                      race))
    return named, args, kw


@contextlib.contextmanager
def plain_icp():
    """The plain ICP in the kernels' place while the block runs:
    ``icp_align_reference``, the plain score sums, race and batch, and
    the plain level inputs (``_pyramid_reference``)."""
    from voxelhashing_demo_tpu_torch.ops import icp
    from voxelhashing_demo_tpu_torch.ops import preprocess as pre

    def score(T, src, tgt, cam, cfg, tgt_packed=None):
        packed = icp.pack_target(tgt) if tgt_packed is None else tgt_packed
        return icp._score_sums_reference(T, src, cam, cfg, packed)

    with _wrapped(icp, "icp_align", lambda real: icp.icp_align_reference), \
            _wrapped(icp, "alignment_score_sums", lambda real: score), \
            _wrapped(icp, "icp_align_raced", lambda real: icp._race_plain), \
            _wrapped(icp, "icp_align_batch", lambda real: icp._batch_plain), \
            _wrapped(icp, "pyramid_inputs",
                     lambda real: pre._pyramid_reference):
        yield


def _dnorms(torch, icp, src, tgt, lcam, lcfg, T0, kernel: bool) -> list:
    """|delta|^2 of each iteration of the loop (K4 run with 1, 2, ...
    iterations, or the plain loop), for the tie rule."""
    from voxelhashing_demo_tpu_torch.geometry import se3

    out = []
    if kernel:
        for k in range(1, lcfg.max_iters + 1):
            rows, _ = icp._align_candidates(
                [src], [tgt], lcam, dataclasses.replace(lcfg, max_iters=k),
                [T0])
            out.append(float(rows[0, icp._ROW_DNORM]))
        return out
    T = se3.identity(device=src.depth.device) if T0 is None else T0
    packed = icp.pack_target(tgt)
    tol2 = icp._tol2(lcfg)
    for _ in range(lcfg.max_iters):
        system = icp.build_normal_system(
            *icp.associate(T, src, None, lcam, lcfg, packed),
            lcfg.huber_delta)
        delta = icp.solve_normal_system(system, lcfg.damping)
        T = se3.exp(delta) @ T
        out.append(float(torch.sum(delta * delta)))
        if not out[-1] > tol2:
            break
    return out


def _in_image(torch, src, lcam, T) -> int:
    """Source-valid pixels that project into the target image under T."""
    from voxelhashing_demo_tpu_torch.geometry import camera as cam_geom
    from voxelhashing_demo_tpu_torch.geometry import se3

    T = se3.identity(device=src.depth.device) if T is None else T
    _, inside = cam_geom.project_nearest(se3.apply(T, src.vertices), lcam)
    return int((inside & (src.vertices[..., 2] != 0)).sum())


def _loop_vs_plain(torch, icp, src, tgt, lcam, lcfg, T0, got) -> dict:
    """One candidate's K4 result against ``icp_align_reference``."""
    ref = icp.icp_align_reference(src, tgt, lcam, lcfg, init_T=T0)
    it_k, it_p = int(got.iters), int(ref.iters)
    out = {"iters": it_k, "iters_plain": it_p,
           "transform_max_abs_err": float((got.transform
                                           - ref.transform).abs().max()),
           "error": float(got.error), "error_plain": float(ref.error),
           "count": float(got.count), "count_plain": float(ref.count)}
    if it_k != it_p:
        dk = _dnorms(torch, icp, src, tgt, lcam, lcfg, T0, True)
        dp = _dnorms(torch, icp, src, tgt, lcam, lcfg, T0, False)
        k = min(it_k, it_p) - 1
        tol2 = icp._tol2(lcfg)
        out["tie"] = {"iteration": k + 1, "dnorm": dk[k],
                      "dnorm_plain": dp[k], "tol2": tol2,
                      "ok": all(abs(d - tol2) <= ICP_TIE_RTOL * tol2
                                for d in (dk[k], dp[k]))}
    return out


def _icp_case(torch, icp, probe, floor_ms, barrier_ms, name, srcs, tgts,
              lcam, lcfg, inits, race):
    """One K4 launch of the pyramid (its candidates' inputs): K4s's system
    and score sums at the first start, against the plain versions and
    their in-order references; the level against ``_level_reference`` bit
    for bit and each candidate (and a race's pick) against the plain loop;
    host syncs, launches and times."""
    from voxelhashing_demo_tpu_torch.geometry import se3

    C = len(srcs)
    src, tgt = srcs[0], tgts[0]
    packed = icp.pack_target(tgt)
    T = se3.identity(device=src.depth.device) if inits[0] is None \
        else inits[0]
    n = src.vertices.numel() // 3
    n_cta = icp._ctas(n, C)
    row = {"case": name, "candidates": C, "race": race,
           "source_hw": list(src.depth.shape),
           "target_hw": [lcam.height, lcam.width],
           "max_iters": lcfg.max_iters, "ctas_per_candidate": n_cta}

    # K4s: the system and the score sums under the first start
    before = icp_launches()
    got = icp.normal_system(T, src, packed, lcam, lcfg)
    sn, sd = icp.alignment_score_sums(T, src, None, lcam, lcfg, packed)
    sums_launches = [a - b for a, b in zip(icp_launches(), before)]
    want = icp.build_normal_system(
        *icp.associate(T, src, None, lcam, lcfg, packed), lcfg.huber_delta)
    ordered = icp._system_from_sums(icp._sums_reference(
        icp._partials_reference(T, src, packed, lcam, lcfg)))
    exact = icp._system_from_sums(icp._terms_reference(
        T, src, packed, lcam, lcfg, False).double().sum(0))
    fields = ("JTJ", "JTr", "error", "count")

    def rel64(s):
        return max(float(((getattr(s, f).double() - getattr(exact, f)).abs()
                          / getattr(exact, f).abs().clamp(min=1e-30)).max())
                   for f in fields)

    rn, rd = icp._score_sums_reference(T, src, lcam, lcfg, packed)
    on, od = icp._sums_reference(icp._partials_reference(
        T, src, packed, lcam, lcfg, score=True))
    row["sums"] = {
        "launches": sums_launches,
        "ok": all(bool(torch.allclose(getattr(got, f), getattr(want, f),
                                      **ICP_SYSTEM_TOL)) for f in fields),
        "max_abs_err": max(float((getattr(got, f)
                                  - getattr(want, f)).abs().max())
                           for f in fields),
        "bit_exact": all(probe.compare(getattr(got, f),
                                       getattr(ordered, f))["bit_exact"]
                         for f in fields),
        "count": float(got.count),
        "max_rel_err_vs_float64": {"kernel": rel64(got),
                                   "plain": rel64(want)},
        "score": {"num": float(sn), "num_plain": float(rn),
                  "den": float(sd), "den_plain": float(rd),
                  "bit_exact": probe.compare((sn, sd),
                                             (on, od))["bit_exact"]}}

    # K4: the level in one launch against the frozen-lane reference
    before = icp_launches()
    rows, iters = icp._align_candidates(srcs, tgts, lcam, lcfg, inits, race)
    launches = [a - b for a, b in zip(icp_launches(), before)]
    rrows, riters = icp._level_reference(srcs, tgts, lcam, lcfg, inits,
                                         race)
    cmp = probe.compare(rows, rrows)
    row["level"] = {"launches": launches,
                    "bit_exact": cmp["bit_exact"]
                    and bool(torch.equal(iters, riters)),
                    "max_abs_err_vs_reference": cmp["max_abs_err"],
                    "iters": iters.tolist()}
    row["loop"] = [_loop_vs_plain(torch, icp, s, t, lcam, lcfg, i,
                                  icp._row_result(rows[c], iters[c]))
                   for c, (s, t, i) in enumerate(zip(srcs, tgts, inits))]
    if race:
        with plain_icp():
            plain = icp._race_plain(src, tgt, lcam, lcfg, inits[1],
                                    init_T=inits[0])
        got_pick = icp._row_result(rows[C], iters[C])
        row["pick"] = {
            "scores": rows[:C, icp._ROW_SCORE].tolist(),
            "kept": int(torch.equal(rows[C, :16], rows[1, :16])
                        and not torch.equal(rows[0, :16], rows[1, :16])),
            "iters": int(got_pick.iters), "iters_plain": int(plain.iters),
            "transform_max_abs_err": float((got_pick.transform
                                            - plain.transform).abs().max())}
    row["syncs"] = count_syncs(
        torch, lambda: icp._align_candidates(srcs, tgts, lcam, lcfg, inits,
                                             race))
    row["syncs_plain"] = count_syncs(torch, lambda: [
        icp.icp_align_reference(s, t, lcam, lcfg, init_T=i)
        for s, t, i in zip(srcs, tgts, inits)])

    # times: each kernel alone (CUDA-graph replay, warm and L2-cold), its
    # wrapper, its plain version; the bound, the launch and barrier floors
    entries = [icp._kernel_inputs(
        se3.identity(device=src.depth.device) if i is None else i, s,
        icp.pack_target(t), lcam) for s, t, i in zip(srcs, tgts, inits)]
    flat = tuple(x for e in entries for x in e)

    def level(*a):
        return icp._launch_level([a[k:k + 4] for k in range(0, len(a), 4)],
                                 lcam, lcfg, race)

    rounds = max(int(i) for i in iters) + (0 if C == 1 and not race else 1)
    per_c = [(_in_image(torch, s, lcam, i), int(it))
             for s, i, it in zip(srcs, inits, iters[:C])]
    k4 = {**probe.timings(level, flat),
          "plain_ms": probe.host_ms(lambda: [
              icp.icp_align_reference(s, t, lcam, lcfg, init_T=i)
              for s, t, i in zip(srcs, tgts, inits)], iters=5),
          "barriers": rounds, "barrier_floor_ms": barrier_ms,
          "floor_ms": floor_ms}
    k4["ms_per_iteration"] = k4["ms"] / max(rounds, 1)
    k4["bound_ms"], k4["bound_by"] = _probe_bound(
        sum(K4_SRC_BYTES * n + K4_GATHER_BYTES * n_in * (it + int(race))
            for n_in, it in per_c) + icp.ROW * 4 * len(rows),
        sum(K4_OPS_PER_PIXEL * n * (it + int(race)) for _, it in per_c))
    k4["least_ms"] = max(k4["bound_ms"], floor_ms + rounds * barrier_ms)
    sys_in = _in_image(torch, src, lcam, T)
    k4s = {**probe.timings(
        lambda t, v, nrm, pk: icp._launch_sums(
            t, icp.Frame(v, nrm, src.depth), pk, lcam, lcfg, score=False),
        (T, src.vertices, src.normals, packed)),
        "plain_ms": probe.host_ms(lambda: icp.build_normal_system(
            *icp.associate(T, src, None, lcam, lcfg, packed),
            lcfg.huber_delta), iters=10),
        "barriers": 1, "barrier_floor_ms": barrier_ms, "floor_ms": floor_ms}
    k4s["bound_ms"], k4s["bound_by"] = _probe_bound(
        K4_SRC_BYTES * n + K4_GATHER_BYTES * sys_in + 44 * 4,
        K4_OPS_PER_PIXEL * n)
    k4s["least_ms"] = max(k4s["bound_ms"], floor_ms + barrier_ms)
    row["icp_gn_level"], row["icp_sums"] = k4, k4s
    return row


def _cuda_events(torch, fn) -> list:
    """torch.profiler's CUDA events of one call of ``fn``.  A profile that
    saw none is taken again, once: a profile on the card has come back
    empty while the call launched its kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        if events:
            break
    return events


def _device_kernels(torch, fn) -> dict:
    """CUDA kernels one call of ``fn`` runs, and their busy µs, from
    torch.profiler."""
    events = _cuda_events(torch, fn)
    return {"kernels": len(events),
            "busy_us": sum(e.time_range.elapsed_us() for e in events)}


def barrier_floor_ms(torch, kernels, ctas: int) -> float:
    """Device time of one grid barrier among ``ctas`` CTAs of 256
    threads: the empty cooperative kernel (csrc/launch_floor.cu) with
    BARRIER_SYNCS barriers less the same with none, over BARRIER_SYNCS,
    each timed like the probe kernels (CUDA-graph replay)."""
    from voxelhashing_demo_tpu_torch.tools import probe

    index = torch.cuda.current_device()
    t = [probe.device_ms([lambda k=k: kernels.launch(
        "grid_sync_floor", index, ctas, k)] * probe.WARM_CALLS)
        for k in (0, BARRIER_SYNCS)]
    return (t[1] - t[0]) / BARRIER_SYNCS


KERNEL_INFO_KEYS = ("registers", "spilled_bytes", "resident_ctas",
                    "threads", "shared_bytes")


def kernel_info(name: str, arg: int) -> dict:
    """What the CUDA runtime says of the instantiation that the C function
    ``name`` (``splat_finalize_info``: fill rounds; ``integrate_rows_info``:
    block size) picks for ``arg``: registers and spilled bytes a thread,
    resident CTAs a multiprocessor, threads and shared bytes a CTA."""
    from voxelhashing_demo_tpu_torch import kernels

    out = (ctypes.c_int * len(KERNEL_INFO_KEYS))()
    err = kernels.function(name)(arg, out)
    _require(err == 0, f"{name}({arg}) answers (CUDA error {err})")
    return dict(zip(KERNEL_INFO_KEYS, out))


def host_issue_us(fn, reps: int = 20) -> float:
    """Median host µs to issue one call of ``fn`` (perf_counter around the
    call, no synchronisation inside; the queue drains after each)."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return float(np.median(times))


def phase_icp(torch, card: str, sweep):
    """K4 on the flagship step's own ICP inputs: the frame after the first
    N_STEP_FRAMES room-sweep frames through ``HashSLAM(flagship_gather_
    config())``; every launch of the pyramid (the coarsest level's race as
    C = 2, then L2 and L1).  Returns {kernel: its kernels-line fields}."""
    from voxelhashing_demo_tpu_torch import kernels
    from voxelhashing_demo_tpu_torch.config import flagship_gather_config
    from voxelhashing_demo_tpu_torch.ops import icp
    from voxelhashing_demo_tpu_torch.tools import probe

    t0 = time.perf_counter()
    cfg = flagship_gather_config()
    calls, args, kw = icp_calls(torch, cfg, sweep[:N_STEP_FRAMES + 1])
    _require([c[0] for c in calls] == ICP_LEVELS,
             "the flagship pyramid's three K4 launches")
    floor_ms = probe.launch_floor_ms()
    barriers = {}
    for c in calls:
        ctas = icp._ctas(c[1][0].vertices.numel() // 3, len(c[1])) * len(
            c[1])
        if ctas not in barriers:
            barriers[ctas] = barrier_floor_ms(torch, kernels, ctas)
    rows = [_icp_case(torch, icp, probe, floor_ms,
                      barriers[icp._ctas(c[1][0].vertices.numel() // 3,
                                         len(c[1])) * len(c[1])], *c)
            for c in calls]

    # a level and the race captured into a CUDA graph, replayed
    _, srcs, tgts, lcam, lcfg, inits, _ = calls[0]
    _, srcs2, tgts2, lcam2, lcfg2, inits2, _ = calls[1]

    def captured_pair():
        return (icp.icp_align_raced(srcs[0], tgts[0], lcam, lcfg, inits[1],
                                    init_T=inits[0])
                + icp.icp_align(srcs2[0], tgts2[0], lcam2, lcfg2,
                                init_T=inits2[0]))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        captured_pair()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = captured_pair()
    graph.replay()
    torch.cuda.synchronize()
    eager = captured_pair()
    graph_equal = all(bool(torch.equal(a, b))
                      for a, b in zip(captured, eager))

    # the ICP stage of the step: the pyramid, kernel against plain, in
    # turns plain / kernel / kernel / plain
    def pyramid():
        return icp.icp_align_pyramid(*args, **kw)

    stage = {"kernel": [], "plain": []}
    for turn in ("plain", "kernel", "kernel", "plain"):
        if turn == "plain":
            with plain_icp():
                stage[turn].append(median_ms(torch, pyramid))
        else:
            stage[turn].append(median_ms(torch, pyramid))
    issue_us = host_issue_us(pyramid)
    before = icp_launches()
    frame_syncs = count_syncs(torch, pyramid)
    per_frame = [a - b for a, b in zip(icp_launches(), before)]
    frame_kernels = _device_kernels(torch, pyramid)
    with plain_icp():
        frame_syncs_plain = count_syncs(torch, pyramid)
        frame_kernels_plain = _device_kernels(torch, pyramid)
    a, b = pyramid(), None
    with plain_icp():
        b = pyramid()
    pyramid_err = float((a.transform - b.transform).abs().max())

    # the pair-ICP batch at the keyframe resolution (the coarsest level's
    # frames), kernel and plain
    pair_cfg = dataclasses.replace(
        cfg.icp, max_iters=cfg.keyframes.loop_icp_max_iters)
    src4, tgt4, T04 = srcs[0], tgts[0], inits[1]

    def batch():
        return icp.icp_align_batch([src4] * PAIR_BATCH, [tgt4] * PAIR_BATCH,
                                   lcam, pair_cfg, [T04] * PAIR_BATCH)

    before = icp_launches()
    pair = {"candidates": PAIR_BATCH, "max_iters": pair_cfg.max_iters,
            "syncs": count_syncs(torch, batch)}
    pair["launches"] = [a - b for a, b in zip(icp_launches(), before)]
    pair["ms"] = median_ms(torch, batch)
    with plain_icp():
        pair["syncs_plain"] = count_syncs(torch, batch)
        pair["ms_plain"] = median_ms(torch, batch)
        plain_rows = batch()
    pair["transform_max_abs_err"] = float(
        (batch()[:, :16] - plain_rows[:, :16]).abs().max())
    pair["sync_sites"] = sync_sites(torch, batch)

    _emit({"phase": "icp", "card": card, "cases": rows,
           "graph_replay_equal_eager": graph_equal,
           "graph_cases": ICP_LEVELS[:2],
           "stage_ms": stage, "stage_host_issue_us": issue_us,
           "stage_syncs": frame_syncs,
           "stage_syncs_plain": frame_syncs_plain,
           "launches_per_frame": dict(zip(ICP_KERNELS, per_frame)),
           "stage_device_kernels": frame_kernels,
           "stage_device_kernels_plain": frame_kernels_plain,
           "pyramid_transform_max_abs_err": pyramid_err,
           "pair_icp_batch": pair, "floor_ms": floor_ms,
           "barrier_floor_ms": barriers,
           "seconds": time.perf_counter() - t0})
    for r in rows:
        c = r["case"]
        s = r["sums"]
        _require(s["ok"], f"K4s NormalSystem == plain within rtol 1e-4, "
                          f"atol 1e-7 ({c})")
        _require(s["bit_exact"] and s["score"]["bit_exact"],
                 f"K4s system and score sums == their in-order references "
                 f"bit for bit ({c})")
        _require(abs(s["score"]["num"] - s["score"]["num_plain"])
                 <= ICP_SCORE_RTOL * abs(s["score"]["num_plain"])
                 and s["score"]["den"] == s["score"]["den_plain"],
                 f"K4s score sums == plain within rtol 1e-5 ({c})")
        _require(s["launches"] == [0, 2], f"K4s: one launch a sum ({c})")
        _require(r["level"]["bit_exact"],
                 f"K4 level == the frozen-lane in-order reference bit for "
                 f"bit ({c})")
        _require(r["level"]["launches"] == [1, 0], f"K4: one launch a "
                                                   f"level ({c})")
        for k, lp in enumerate(r["loop"]):
            _require(lp["transform_max_abs_err"] <= ICP_T_ATOL,
                     f"K4 transform == plain within 1e-5 ({c}, {k})")
            _require(abs(lp["error"] - lp["error_plain"])
                     <= ICP_ERR_RTOL * abs(lp["error_plain"])
                     and abs(lp["count"] - lp["count_plain"])
                     <= ICP_ERR_RTOL * abs(lp["count_plain"]),
                     f"K4 error and count == plain within rtol 1e-3 "
                     f"({c}, {k})")
            _require(lp["iters"] == lp["iters_plain"]
                     or lp.get("tie", {}).get("ok", False),
                     f"K4 iterations == plain, or a tie at tol2 ({c}, {k})")
        if r["race"]:
            p = r["pick"]
            _require(p["transform_max_abs_err"] <= ICP_T_ATOL
                     and (p["iters"] == p["iters_plain"]
                          or any(lp.get("tie", {}).get("ok", False)
                                 for lp in r["loop"])),
                     f"K4's race keeps what pick_by_score keeps ({c})")
        _require(r["syncs"] == 0, f"a K4 level syncs 0 times ({c})")
    _require(graph_equal, "the race and a level captured in a CUDA graph "
                          "== eager")
    _require(per_frame == [len(ICP_LEVELS), 0] and frame_syncs == 0,
             "the pyramid launches K4 once a level (3), no K4s, no sync")
    _require(pair["launches"] == [1, 0] and pair["syncs"] <= 1
             and pair["transform_max_abs_err"] <= ICP_T_ATOL,
             "the pair-ICP batch: one K4 launch, one sync, == plain")
    main = next(r for r in rows if r["case"] == ICP_MAIN_CASE)
    summary = {}
    errs = {"icp_gn_level": max(lp["transform_max_abs_err"]
                                for r in rows for lp in r["loop"]),
            "icp_sums": max(r["sums"]["max_abs_err"] for r in rows)}
    for kname in ICP_KERNELS:
        def fields(r, kname=kname):
            return {"case": r["case"], **r[kname]}
        summary[kname] = {**fields(main), "max_abs_err": errs[kname],
                          "library_ms": None,
                          "cases": [fields(r) for r in rows
                                    if r is not main]}
    return summary


K3_KERNELS = ("preprocess_frame", "pyramid_levels")
K3_META = {
    "preprocess_frame": {
        "route": "cuda",
        "source": "voxelhashing_demo_tpu_torch/csrc/preprocess.cu",
        "replaces": "voxelhashing_demo_tpu/ops/preprocess.py:31 "
                    "(depth_to_meters), voxelhashing_demo_tpu/ops/"
                    "preprocess.py:86 (reject_outliers), "
                    "voxelhashing_demo_tpu/ops/preprocess.py:118 "
                    "(bilateral_filter), voxelhashing_demo_tpu/ops/"
                    "preprocess.py:43 (compute_vertices), "
                    "voxelhashing_demo_tpu/ops/preprocess.py:50 "
                    "(compute_normals), voxelhashing_demo_tpu/ops/"
                    "preprocess.py:151 (preprocess): fused by XLA, no "
                    "Pallas kernel",
    },
    "pyramid_levels": {
        "route": "cuda",
        "source": "voxelhashing_demo_tpu_torch/csrc/preprocess.cu",
        "replaces": "voxelhashing_demo_tpu/ops/preprocess.py:184 "
                    "(downsample_depth), voxelhashing_demo_tpu/ops/"
                    "preprocess.py:210 (downsample_depth_mean), "
                    "voxelhashing_demo_tpu/ops/preprocess.py:175 "
                    "(preprocess_metric), voxelhashing_demo_tpu/ops/"
                    "icp.py:118 (pack_target), voxelhashing_demo_tpu/ops/"
                    "icp.py:77 (oct_encode_bits), voxelhashing_demo_tpu/"
                    "ops/icp.py:438 (icp_align_pyramid's level inputs): "
                    "fused by XLA, no Pallas kernel",
    },
}
# float operations a pixel: K3a's gate, support count, vertices and
# normals, and each bilateral tap's; K3b's a level pixel and a pooled one
K3A_OPS_PER_PIXEL, K3A_OPS_PER_TAP = 80, 9
K3B_OPS_PER_PIXEL, K3B_OPS_PER_POOLED = 60, 4
K3_ICP_STAGE_KERNELS = 20     # "well below" the 407 of PR 13's stage
WRAPPER_REPS = 50             # calls behind a wrapper's host_issue_us


def k3_launches() -> list:
    """[K3a, K3b] launches counted since they were last set to 0."""
    from voxelhashing_demo_tpu_torch.ops import preprocess as pre

    return [pre.LAUNCHES_FRAME, pre.LAUNCHES_LEVELS]


def zero_k3_launches() -> None:
    from voxelhashing_demo_tpu_torch.ops import preprocess as pre

    pre.LAUNCHES_FRAME = pre.LAUNCHES_LEVELS = 0


@contextlib.contextmanager
def plain_k3():
    """The plain frontend and level inputs in K3's place while the block
    runs."""
    from voxelhashing_demo_tpu_torch.ops import icp
    from voxelhashing_demo_tpu_torch.ops import preprocess as pre

    with _wrapped(pre, "preprocess", lambda real: pre.preprocess_reference), \
            _wrapped(icp, "pyramid_inputs",
                     lambda real: pre._pyramid_reference):
        yield


def _k3_compare(probe, got: list, plain: list) -> dict:
    """K3 outputs (Frames and packed targets, in level order) against the
    plain version's, bit for bit."""
    parts = [{"shape": list((g.depth if hasattr(g, "depth") else g).shape),
              **probe.compare(tuple(g) if hasattr(g, "depth") else g,
                              tuple(p) if hasattr(p, "depth") else p)}
             for g, p in zip(got, plain)]
    return {"outputs": parts,
            "bit_exact": all(x["bit_exact"] for x in parts),
            "max_abs_err": max(x["max_abs_err"] for x in parts)}


def _loop_us(fn, iters: int = 200) -> float:
    """Host µs a call of ``fn`` (perf_counter around a loop; the device is
    not waited for), the median of five loops."""
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        times.append((time.perf_counter() - t0) / iters * 1e6)
    return float(np.median(times))


def k3b_wrapper_pieces(torch, frame, model, cam, icfg) -> dict:
    """What K3b's wrapper (``pyramid_inputs`` on the step's inputs, both
    full-resolution Frames given) spends its host µs on, piece by piece:
    the whole call; the plan and layout lookups (by identity and shapes);
    the checks of the inputs; the output buffer; the 12 output views; the
    C call and launch with its arguments built (the whole call and the
    launch with the queue drained before each, as ``host_issue_us``).
    Then what the wrapper no longer does: hashing the camera and ICP
    configuration for the plan's cache, hashing the jobs and shapes for
    the layout's, and building a 36-pointer argument array."""
    from voxelhashing_demo_tpu_torch import kernels
    from voxelhashing_demo_tpu_torch.ops import preprocess as pre

    def whole():
        return pre.pyramid_inputs(frame.depth, model.depth, cam, icfg,
                                  src_full=frame, tgt_full=model)

    whole()
    torch.cuda.synchronize()
    jobs, _ = pre._plan(cam, icfg, True, True, True)
    inputs = (frame.depth, model.depth, model.depth, model.normals)
    lay = pre._LAYOUTS[(id(jobs), *(t.shape for t in inputs))][1]
    dev = frame.depth.device
    buf = torch.empty(lay.total, dtype=torch.float32, device=dev)
    fn = kernels.function("pyramid_levels")
    stream = torch._C._cuda_getCurrentRawStream(buf.get_device())
    args = (*(t.data_ptr() for t in inputs), buf.data_ptr(), lay.ints,
            lay.floats, len(jobs), pre.EDGE_BAND, stream)
    shapes = tuple((t.shape[0], t.shape[1]) for t in inputs)
    ptrs = [buf.data_ptr()] * 36

    def checks():
        read = list(inputs)
        return (dev.type != "cuda" or any(t.device != dev for t in read)
                or any(t.dtype != torch.float32 for t in read),
                [t.contiguous().data_ptr() for t in read])

    def views():
        return [buf.as_strided(*v) if job.kind != pre._SOURCE
                else pre.Frame(*(buf.as_strided(*x) for x in v))
                for job, v in zip(jobs, lay.views)]

    pieces = {
        "whole": host_issue_us(whole, reps=WRAPPER_REPS),
        "plan_lookup": _loop_us(lambda: pre._LEVEL_PLANS.get(
            (id(cam), id(icfg), True, True, True))),
        "layout_lookup": _loop_us(lambda: pre._LAYOUTS.get(
            (id(jobs), *(t.shape for t in inputs)))),
        "checks": _loop_us(checks),
        "empty": _loop_us(lambda: torch.empty(
            lay.total, dtype=torch.float32, device=dev)),
        "views_12": _loop_us(views),
        "c_call_and_launch": host_issue_us(lambda: fn(*args),
                                           reps=WRAPPER_REPS),
        "cut_plan_hash": _loop_us(lambda: hash((cam, icfg))),
        "cut_layout_hash": _loop_us(lambda: hash((jobs, shapes))),
        "cut_pointer_array_36": _loop_us(
            lambda: (ctypes.c_void_p * 36)(*ptrs)),
    }
    torch.cuda.synchronize()
    return pieces


def phase_preprocess(torch, card: str, sweep) -> dict:
    """K3a ``preprocess_frame`` and K3b ``pyramid_levels`` on the flagship
    step's own inputs: frame N_STEP_FRAMES of the room sweep and the model
    after the first N_STEP_FRAMES frames through ``HashSLAM(flagship_
    gather_config())``.  Returns {kernel: its kernels-line fields}."""
    from voxelhashing_demo_tpu_torch.config import flagship_gather_config
    from voxelhashing_demo_tpu_torch.models import hash_slam
    from voxelhashing_demo_tpu_torch.ops import icp
    from voxelhashing_demo_tpu_torch.ops import preprocess as pre
    from voxelhashing_demo_tpu_torch.tools import probe

    t0 = time.perf_counter()
    cfg = flagship_gather_config()
    cam, front, icfg = cfg.camera, cfg.frontend, cfg.icp
    slam = hash_slam.HashSLAM(cfg)
    for d in sweep[:N_STEP_FRAMES]:
        slam.process(d)
    st = slam.state
    raw = hash_slam.depth_tensor(sweep[N_STEP_FRAMES], slam.device)

    frame = pre.preprocess(raw, cam, front)
    k3a_cmp = _k3_compare(probe, [frame],
                          [pre.preprocess_reference(raw, cam, front)])
    kw = dict(src_full=frame, tgt_full=st.model)
    srcs, tgts = pre.pyramid_inputs(frame.depth, st.model.depth, cam, icfg,
                                    **kw)
    ps, pt = pre._pyramid_reference(frame.depth, st.model.depth, cam, icfg,
                                    **kw)
    k3b_cmp = _k3_compare(probe, srcs + tgts, ps + pt)

    # each kernel alone (CUDA-graph replay, warm and L2-cold), its wrapper,
    # its plain version; the bound from this run's shapes
    floor_ms = probe.launch_floor_ms()
    n = raw.numel()
    taps = (2 * front.bilateral_radius + 1) ** 2 if front.bilateral else 0
    k3a = {**probe.timings(lambda r: pre.preprocess(r, cam, front), (raw,)),
           "host_issue_us": host_issue_us(
               lambda: pre.preprocess(raw, cam, front), reps=WRAPPER_REPS),
           "plain_ms": probe.host_ms(
               lambda: pre.preprocess_reference(raw, cam, front), iters=10)}
    k3a["bound_ms"], k3a["bound_by"] = _probe_bound(
        n * (4 + 28), n * (K3A_OPS_PER_PIXEL + taps * K3A_OPS_PER_TAP))

    def levels(ds, dt, mn):
        return pre.pyramid_inputs(ds, dt, cam, icfg, src_full=frame,
                                  tgt_full=pre.Frame(st.model.vertices, mn,
                                                     dt))

    k3b = {**probe.timings(levels, (frame.depth, st.model.depth,
                                    st.model.normals)),
           "plain_ms": probe.host_ms(lambda: pre._pyramid_reference(
               frame.depth, st.model.depth, cam, icfg, **kw), iters=10),
           "wrapper_pieces_us": k3b_wrapper_pieces(torch, frame, st.model,
                                                   cam, icfg)}
    level_hw = ([s.depth.shape for s in srcs]
                + [t.shape[:2] for t in tgts])
    out_bytes = 4 * (sum(7 * s.depth.numel() for s in srcs)
                     + sum(t.numel() for t in tgts))
    # input pixels the pools read: a level pixel's factor^2 window
    pooled = sum(h * w * (raw.shape[0] // h) ** 2 for h, w in level_hw)
    k3b["bound_ms"], k3b["bound_by"] = _probe_bound(
        n * (4 + 4 + 12) + out_bytes,
        sum(h * w for h, w in level_hw) * K3B_OPS_PER_PIXEL
        + pooled * K3B_OPS_PER_POOLED)
    for k in (k3a, k3b):
        k["floor_ms"] = floor_ms
        k["least_ms"] = max(k["bound_ms"], floor_ms)

    # the step's two stages, kernels against plain: host ms, device kernels
    def pre_stage():
        return pre.preprocess(raw, cam, front)

    def icp_stage():
        return icp.icp_align_pyramid(frame.depth, st.model.depth, cam, icfg,
                                     src_full=frame, tgt_full=st.model,
                                     prior_T=st.vel)

    stages = {}
    for name, fn in (("preprocess", pre_stage), ("icp", icp_stage)):
        stages[name] = {"host_ms": median_ms(torch, fn),
                        "device_kernels": _device_kernels(torch, fn)}
        with plain_k3():
            stages[name]["host_ms_plain"] = median_ms(torch, fn)
            stages[name]["device_kernels_plain"] = _device_kernels(torch, fn)
    # one frame of the step: one launch of each
    zero_k3_launches()
    slam.process(sweep[N_STEP_FRAMES])
    per_frame = k3_launches()
    _emit({"phase": "preprocess", "card": card,
           "frame_hw": list(raw.shape), "frontend": dataclasses.asdict(front),
           "pyramid": list(icfg.pyramid),
           "source_pools": list(icfg.source_pools),
           "preprocess_frame": {"check": k3a_cmp, **k3a},
           "pyramid_levels": {"check": k3b_cmp, **k3b},
           "launches_per_frame": dict(zip(K3_KERNELS, per_frame)),
           "stages": stages, "seconds": time.perf_counter() - t0})
    for kname, c in (("K3a", k3a_cmp), ("K3b", k3b_cmp)):
        _require(c["bit_exact"], f"{kname} == its plain version bit for "
                                 f"bit, every output")
    _require(per_frame == [1, 1], "one K3a and one K3b launch a frame")
    _require(stages["preprocess"]["device_kernels"]["kernels"] == 1,
             "the preprocess stage is one device kernel")
    _require(stages["icp"]["device_kernels"]["kernels"]
             <= K3_ICP_STAGE_KERNELS,
             f"the ICP stage runs at most {K3_ICP_STAGE_KERNELS} device "
             f"kernels")
    return {kname: {"case": "step", **d, "max_abs_err": c["max_abs_err"],
                    "library_ms": None}
            for kname, d, c in (("preprocess_frame", k3a, k3a_cmp),
                                ("pyramid_levels", k3b, k3b_cmp))}


SPLAT_KERNELS = ("splat_zbuffer", "splat_finalize")
SPLAT_META = {
    "splat_zbuffer": {
        "route": "cuda",
        "source": "voxelhashing_demo_tpu_torch/csrc/splat.cu",
        "replaces": "voxelhashing_demo_tpu/ops/splat.py:252 "
                    "(surface_filter), voxelhashing_demo_tpu/ops/splat.py:"
                    "141 (splat_depth_from_map), voxelhashing_demo_tpu/ops/"
                    "splat.py:84 (splat_depth_estimates), "
                    "voxelhashing_demo_tpu/ops/splat.py:187 "
                    "(_splat_rows_into): fused by XLA, no Pallas kernel",
    },
    "splat_finalize": {
        "route": "cuda",
        "source": "voxelhashing_demo_tpu_torch/csrc/splat.cu",
        "replaces": "voxelhashing_demo_tpu/ops/splat.py:229 "
                    "(finalize_depth), voxelhashing_demo_tpu/ops/splat.py:"
                    "48 (_min_fill), voxelhashing_demo_tpu/ops/splat.py:66 "
                    "(_edge_preserving_smooth), voxelhashing_demo_tpu/"
                    "geometry/camera.py:33 (pixel_rays), "
                    "voxelhashing_demo_tpu/ops/preprocess.py:50 "
                    "(compute_normals): fused by XLA, no Pallas kernel",
    },
}
# float operations: K8 a voxel of a live row (the pose, 9 + 3 FMAs and
# adds, the projection, the gates); K9 a pixel (each fill round's 9
# minima, the smooth's 9 taps, points and the normal)
K8_OPS_PER_VOXEL, K9_OPS_PER_PIXEL, K9_OPS_PER_ROUND = 60, 130, 12
SPLAT_STAGE_KERNELS = 3      # a buffer reset, K8, K9


def splat_launches() -> list:
    """[K8, K9] launches counted since they were last set to 0."""
    from voxelhashing_demo_tpu_torch.ops import splat

    return [splat.LAUNCHES_ZBUFFER, splat.LAUNCHES_FINALIZE]


def zero_splat_launches() -> None:
    from voxelhashing_demo_tpu_torch.ops import splat

    splat.LAUNCHES_ZBUFFER = splat.LAUNCHES_FINALIZE = 0


def phase_splat(torch, card: str, sweep) -> dict:
    """K8 ``splat_zbuffer`` and K9 ``splat_finalize`` on the flagship
    step's own inputs: the map, the visible set and the pose that the
    step's splat takes on frame N_STEP_FRAMES of the room sweep, after the
    first N_STEP_FRAMES frames through ``HashSLAM(flagship_gather_
    config())``.  Returns {kernel: its kernels-line fields}."""
    from voxelhashing_demo_tpu_torch import kernels
    from voxelhashing_demo_tpu_torch.config import flagship_gather_config
    from voxelhashing_demo_tpu_torch.models import hash_slam
    from voxelhashing_demo_tpu_torch.ops import splat
    from voxelhashing_demo_tpu_torch.tools import probe

    t0 = time.perf_counter()
    cfg = flagship_gather_config()
    slam = hash_slam.HashSLAM(cfg)
    for d in sweep[:N_STEP_FRAMES]:
        slam.process(d)
    # one frame of the step: its splat's arguments, one launch of each
    last = []
    zero_splat_launches()
    with _wrapped(splat, "splat_raycast", _recorded(last)):
        slam.process(sweep[N_STEP_FRAMES])
    per_frame = splat_launches()
    hmap, active, hcfg, T_wc, cam, rc, fusion = last
    args = tuple(last)
    band = rc.splat_band * fusion.voxel_size

    # each kernel and the pair against the plain versions, bit for bit
    k8_raw = splat.splat_depth_from_map(*args)
    k8_plain = splat.splat_depth_from_map_reference(*args)
    filtered = splat.surface_filter(hmap, active, band)
    k8_filtered = torch.nan_to_num(splat._launch_zbuffer(
        *args, band_filter=True).view(cam.height, cam.width), posinf=0.0)
    k8_cmp = {"unfiltered": probe.compare(k8_raw, k8_plain),
              "filtered": probe.compare(
                  k8_filtered, splat.splat_depth_from_map_reference(
                      hmap, filtered, hcfg, T_wc, cam, rc, fusion))}
    k9_cmp = probe.compare(
        tuple(splat.finalize_depth(k8_plain, cam, rc, fusion)),
        tuple(splat.finalize_depth_reference(k8_plain, cam, rc, fusion)))
    pair = splat.splat_raycast(*args)
    plain = splat.splat_raycast_reference(*args)
    pair_cmp = {f: probe.compare(getattr(pair, f), getattr(plain, f))
                for f in pair._fields}
    k8_cmp["bit_exact"] = all(c["bit_exact"] for c in (
        k8_cmp["unfiltered"], k8_cmp["filtered"]))
    k8_cmp["max_abs_err"] = max(k8_cmp["unfiltered"]["max_abs_err"],
                                k8_cmp["filtered"]["max_abs_err"])

    # each kernel alone (CUDA-graph replay, warm and L2-cold), its wrapper
    # (the reset and K8; K9), its plain version; bounds from this run's data
    floor_ms = probe.launch_floor_ms()
    index = torch.cuda.current_device()
    rows = active.ptrs.shape[0]
    zbuf = torch.full((cam.height * cam.width,), float("inf"),
                      device=T_wc.device)

    def k8_alone(blocks, ptrs, count, tsdf, weight, band_min, T, zb):
        # the wrapper's arguments on these tensors, launched on ``zb``
        # without the reset and without counting
        m = hmap._replace(tsdf=tsdf, weight=weight, band_min=band_min)
        args, _ = splat._zbuffer_args(m, splat.ActiveSet(blocks, ptrs,
                                                         count),
                                      hcfg, T, cam, rc, fusion, True)
        kernels.launch("splat_zbuffer", index, zb.data_ptr(), *args)

    k8 = {**probe.timings(k8_alone, (active.blocks, active.ptrs,
                                     active.count, hmap.tsdf, hmap.weight,
                                     hmap.band_min, T_wc, zbuf)),
          "wrapper_ms": probe.host_ms(
              lambda: splat._launch_zbuffer(*args, band_filter=True)),
          "plain_ms": probe.host_ms(
              lambda: splat.splat_depth_from_map_reference(
                  hmap, splat.surface_filter(hmap, active, band), hcfg,
                  T_wc, cam, rc, fusion), iters=10)}
    n = int(active.count)
    live = int(filtered.count)
    V = hcfg.voxels_per_block
    px = cam.height * cam.width
    k8["bound_ms"], k8["bound_by"] = _probe_bound(
        n * (12 + 4 + 4) + live * V * 8 + 64 + 4 + px * 4,
        live * V * K8_OPS_PER_VOXEL)
    k9 = {**probe.timings(lambda d: splat.finalize_depth(d, cam, rc, fusion),
                          (k8_plain,)),
          "plain_ms": probe.host_ms(lambda: splat.finalize_depth_reference(
              k8_plain, cam, rc, fusion), iters=10)}
    k9["bound_ms"], k9["bound_by"] = _probe_bound(
        px * (4 + 4 + 12 + 12 + 1),
        px * (K9_OPS_PER_PIXEL + K9_OPS_PER_ROUND * rc.splat_fill_rounds))
    k9["info"] = kernel_info("splat_finalize_info", rc.splat_fill_rounds)
    for k in (k8, k9):
        k["floor_ms"] = floor_ms
        k["least_ms"] = max(k["bound_ms"], floor_ms)

    # the stage, kernels against plain in turns plain / kernel / kernel /
    # plain: host ms, device kernels, host reads
    fns = {"kernel": lambda: splat.splat_raycast(*args),
           "plain": lambda: splat.splat_raycast_reference(*args)}
    host_ms = {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        host_ms[which].append(median_ms(torch, fns[which]))
    stage = {"host_ms": host_ms["kernel"], "host_ms_plain": host_ms["plain"],
             "issue_us": host_issue_us(fns["kernel"]),
             "issue_us_plain": host_issue_us(fns["plain"], reps=5)}
    for which, fn in fns.items():
        tag = "" if which == "kernel" else "_plain"
        stage["device_kernels" + tag] = _device_kernels(torch, fn)
        stage["host_reads" + tag] = sync_sites(torch, fn)
    _emit({"phase": "splat", "card": card, "frame_hw": [cam.height,
                                                        cam.width],
           "rows": rows, "count": n, "live_rows": live,
           "hit_fraction": float(pair.hit.float().mean()),
           "fill_rounds": rc.splat_fill_rounds,
           "splat_zbuffer": {"check": k8_cmp, **k8},
           "splat_finalize": {"check": k9_cmp, **k9},
           "pair_check": pair_cmp,
           "launches_per_frame": dict(zip(SPLAT_KERNELS, per_frame)),
           "stage": stage, "seconds": time.perf_counter() - t0})
    _require(k8_cmp["bit_exact"], "K8 == its plain version bit for bit "
                                  "(with and without the band filter)")
    _require(k9_cmp["bit_exact"], "K9 == its plain version bit for bit, "
                                  "every field")
    _require(all(c["bit_exact"] for c in pair_cmp.values()),
             "K8 + K9 == splat_raycast_reference bit for bit, every field")
    _require(per_frame == [1, 1], "one K8 and one K9 launch a frame")
    _require(stage["device_kernels"]["kernels"] <= SPLAT_STAGE_KERNELS,
             f"the splat stage runs at most {SPLAT_STAGE_KERNELS} device "
             f"kernels")
    _require(not stage["host_reads"], "the splat stage reads nothing on "
                                      "the host")
    _require(0 < live <= n and float(pair.hit.float().mean()) > 0.5,
             "the step's splat sees live rows and hits half the image")
    return {kname: {"case": "step", **d, "max_abs_err": c["max_abs_err"],
                    "library_ms": None}
            for kname, d, c in (("splat_zbuffer", k8, k8_cmp),
                                ("splat_finalize", k9, k9_cmp))}


# The fuse kernels (csrc/fuse.cu): K6 compaction and K7 integration on
# the flagship step's own inputs.
FUSE_KERNELS = ("compact_visible", "integrate_rows")
FUSE_META = {
    "compact_visible": {
        "route": "cuda",
        "source": "voxelhashing_demo_tpu_torch/csrc/fuse.cu",
        "replaces": "voxelhashing_demo_tpu/ops/hash_ops.py:319 "
                    "(block_in_frustum), voxelhashing_demo_tpu/ops/"
                    "hash_ops.py:365 (compact_visible): fused by XLA, no "
                    "Pallas kernel",
    },
    "integrate_rows": {
        "route": "cuda",
        "source": "voxelhashing_demo_tpu_torch/csrc/fuse.cu",
        "replaces": "voxelhashing_demo_tpu/ops/hash_ops.py:405 "
                    "(_integrate_rows), voxelhashing_demo_tpu/ops/"
                    "hash_ops.py:511 (integrate), voxelhashing_demo_tpu/"
                    "ops/pallas_gather.py:88 (gather_depth_window, its "
                    "pallas_call at :101), voxelhashing_demo_tpu/ops/"
                    "hash_ops.py:648 (touch_active)",
    },
}
# K6's least bytes on this run's table: every ptr (4 B an entry), the
# 32-byte sectors that hold a live entry's key, the set written (block,
# ptr: 16 B a row, its pads included) and count; ~45 integer and float
# operations a live entry (a free entry's test is one compare)
K6_PTR_BYTES, K6_ROW_BYTES, K6_OPS_PER_ENTRY = 4, 16, 45
# K7's least bytes on this run's rows: each live voxel's tsdf and weight
# read (8 B), each tsdf, weight, band_min or last_seen value that the step
# changes written (4 B), the 32-byte sectors of the depth pixels that
# covered voxels read, each row's block and ptr (16 B), count and pose;
# ~70 operations a voxel (projection, window, update, reductions)
K7_VOXEL_READ_BYTES, K7_ROW_BYTES, K7_OPS_PER_VOXEL = 8, 16, 70
FUSE_STAGE_KERNELS = 2       # K6, K7


def fuse_launches() -> list:
    """[K6, K7] launches counted since they were last set to 0."""
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    return [hash_ops.LAUNCHES_COMPACT, hash_ops.LAUNCHES_INTEGRATE]


def zero_fuse_launches() -> None:
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    hash_ops.LAUNCHES_COMPACT = hash_ops.LAUNCHES_INTEGRATE = 0


def _k6_bytes(base) -> int:
    """Bytes K6 must read of the table ``base``: every ptr, and the
    sectors of the keys of its live entries (ptr != FREE_PTR)."""
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    live = (base.ptrs != hash_ops.FREE_PTR).nonzero().flatten()
    return (base.ptrs.numel() * K6_PTR_BYTES
            + _sector_bytes(live.cpu().numpy()))


def _k7_bytes(base, active, hcfg, depth, T_wc, cam, fusion, stamp) -> int:
    """Bytes K7 must move for one update of ``base`` from ``active`` with
    ``stamp`` (as its timed launch makes it): each live voxel's tsdf and
    weight read, each map value that the plain update changes written,
    the sectors of the depth pixels that covered voxels read, the rows'
    block and ptr, count and pose."""
    from voxelhashing_demo_tpu_torch.geometry import se3
    from voxelhashing_demo_tpu_torch.ops import hash_ops
    from voxelhashing_demo_tpu_torch.ops import window_gather as wg
    from voxelhashing_demo_tpu_torch.tools import probe

    n = int(active.count)
    blocks, ptrs = active.blocks[:n], active.ptrs[:n]
    after = probe.map_copy(base, probe.MAP_FIELDS)
    hash_ops.touch_active(after, active, stamp)
    hash_ops.integrate_reference(after, active, hcfg, depth, T_wc, cam,
                                 fusion)
    written = sum(int((getattr(after, f) != getattr(base, f)).sum())
                  for f in ("tsdf", "weight", "band_min", "last_seen"))
    _, v, u, in_img, row_valid = hash_ops.project_rows(
        blocks, ptrs, hcfg, se3.inverse(T_wc), cam, fusion)
    mask = in_img & row_valid[:, None]
    if hash_ops._window_mode(hcfg):
        mask = wg.gather_depth_window_reference(depth.contiguous(), v, u,
                                                mask)[1]
    pixels = (v.long() * cam.width + u.long())[mask]
    V = hcfg.voxels_per_block
    return (n * V * K7_VOXEL_READ_BYTES + 4 * written
            + _sector_bytes(pixels.cpu().numpy()) + n * K7_ROW_BYTES
            + 4 + 64)


def phase_fuse(torch, card: str, sweep) -> dict:
    """K6 ``compact_visible`` and K7 ``integrate_rows`` on the flagship
    step's own inputs: the map, the frame and the pose that ``fuse_frame``
    takes on frame N_STEP_FRAMES of the room sweep, after the first
    N_STEP_FRAMES frames through ``HashSLAM(flagship_gather_config())``,
    with the step's allocation applied to a copy of that map.  Returns
    {kernel: its kernels-line fields}."""
    from voxelhashing_demo_tpu_torch import kernels
    from voxelhashing_demo_tpu_torch.config import flagship_gather_config
    from voxelhashing_demo_tpu_torch.models import hash_slam
    from voxelhashing_demo_tpu_torch.ops import hash_ops
    from voxelhashing_demo_tpu_torch.tools import probe

    t0 = time.perf_counter()
    cfg = flagship_gather_config()
    slam = hash_slam.HashSLAM(cfg)
    for d in sweep[:N_STEP_FRAMES]:
        slam.process(d)
    # one frame of the step: fuse_frame's arguments, its map copied before
    # the call; one K6 and one K7 launch
    last = []

    def record(real):
        def fn(hmap, frame, T_wc, cam, hcfg, fusion, frame_idx=0):
            last[:] = [probe.map_copy(hmap), frame, T_wc, cam, hcfg, fusion,
                       frame_idx]
            return real(hmap, frame, T_wc, cam, hcfg, fusion,
                        frame_idx=frame_idx)
        return fn

    zero_fuse_launches()
    with _wrapped(hash_ops, "fuse_frame", record):
        slam.process(sweep[N_STEP_FRAMES])
    per_frame = fuse_launches()
    base, frame, T_wc, cam, hcfg, fusion, frame_idx = last
    hash_ops.allocate_from_frame(base, frame, T_wc, cam, hcfg, fusion,
                                 frame_idx=frame_idx)
    depth = frame.depth
    args6 = (hcfg, T_wc, cam, fusion)

    # K6 and K7 against the plain versions, bit for bit: the visible set
    # and its order; every map field after K7 in both gather modes and
    # both signs (the max_born gate cutting the last two frames' rows out
    # of the de-integration)
    active = hash_ops.compact_visible_reference(base, *args6)
    k6_cmp = probe.compare(tuple(hash_ops.compact_visible(base, *args6)),
                           tuple(active))
    n = int(active.count)
    max_born = frame_idx - 2
    k7_cmp = {
        f"{mode}_sign{sign:+d}": probe.integrate_check(
            base, h, cam, fusion, depth, T_wc, sign,
            None if sign > 0 else max_born,
            frame_idx if sign > 0 else None)
        for mode, h in (("window", hcfg), ("plain_gather", dataclasses.replace(
            hcfg, use_pallas_gather=False)))
        for sign in (1, -1)}
    k6_exact = k6_cmp["bit_exact"]
    k7_exact = all(c["bit_exact"] and c["rows"] == n
                   for c in k7_cmp.values())

    # each kernel alone (CUDA-graph replay), warm and L2-cold, its wrapper,
    # its plain version; bounds from this run's table and rows
    floor_ms = probe.launch_floor_ms()
    index = torch.cuda.current_device()
    T, A, V = base.keys.shape[0], hcfg.max_active, hcfg.voxels_per_block
    tiles = -(-T // hash_ops.COMPACT_TILE)
    ints6, floats6 = hash_ops._compact_plan(hcfg, cam, fusion)
    out6 = torch.empty(4 * A + 1, dtype=torch.int32, device=T_wc.device)
    # a scratch of its own, zeroed once: each launch leaves it clean
    words6 = hash_ops.COMPACT_STATUS_WORDS * tiles
    scratch6 = torch.zeros(1 + words6, dtype=torch.int64, device=T_wc.device)

    def k6_alone(keys, ptrs, pose):
        kernels.launch("compact_visible", index, keys.data_ptr(),
                       ptrs.data_ptr(), pose.data_ptr(), out6.data_ptr(),
                       scratch6.data_ptr(), words6, T, ints6, floats6)

    k6 = {**probe.timings(k6_alone, (base.keys, base.ptrs, T_wc)),
          "wrapper_ms": probe.host_ms(
              lambda: hash_ops.compact_visible(base, *args6)),
          "plain_ms": probe.host_ms(
              lambda: hash_ops.compact_visible_reference(base, *args6),
              iters=10)}
    # every launch leaves its scratch as the next one needs it: the epoch
    # word's low half 0
    torch.cuda.synchronize()
    k6["scratch_clean"] = all(
        int(t[0]) & 0xFFFFFFFF == 0
        for t in [scratch6] + [x for x, _ in
                               hash_ops._COMPACT_SCRATCH.values()])
    live = int((base.ptrs != hash_ops.FREE_PTR).sum())
    k6["bound_bytes"] = _k6_bytes(base) + A * K6_ROW_BYTES + 4
    k6["bound_ms"], k6["bound_by"] = _probe_bound(
        k6["bound_bytes"], live * K6_OPS_PER_ENTRY + T)
    # what a grid barrier among the step's tiles would cost (the design
    # before the look-back paid one); K6's least is its bound or the floor
    k6["barrier_floor_ms"] = barrier_floor_ms(torch, kernels, tiles)
    k6["least_ms"] = max(k6["bound_ms"], floor_ms)

    head, (falloff, *tail) = hash_ops._integrate_plan(hcfg, cam, fusion)
    floats7 = (ctypes.c_float * len(tail))(*tail)

    def k7_alone(blocks, ptrs, count, tsdf, weight, band_min, born,
                 last_seen, d, pose):
        rows7 = (ctypes.c_void_p * 5)(*(t.data_ptr() for t in (
            tsdf, weight, band_min, born, last_seen)))
        ints7 = (ctypes.c_int * 8)(tsdf.shape[0], *head, falloff)
        kernels.launch("integrate_rows", index, blocks.data_ptr(),
                       ptrs.data_ptr(), count.data_ptr(), rows7,
                       d.data_ptr(), pose.data_ptr(), None, A, 1, 0, 0, 1,
                       frame_idx, ints7, floats7)

    m = probe.map_copy(base)
    on_map = (active.blocks, active.ptrs, active.count, m.tsdf, m.weight,
              m.band_min, m.born, m.last_seen, depth, T_wc)
    # L2-cold: the live rows alone, gathered into a map of their own (the
    # whole map is too large for ``probe.cold_args`` to rotate)
    rows = active.ptrs[:n].long()
    own = torch.full((A,), hash_ops.FREE_PTR, dtype=torch.int32,
                     device=T_wc.device)
    own[:n] = torch.arange(n, dtype=torch.int32, device=T_wc.device)
    gathered = (active.blocks, own, active.count, m.tsdf[rows],
                m.weight[rows], m.band_min[rows], m.born[rows],
                m.last_seen[rows], depth, T_wc)
    k7 = {"ms": probe.device_ms([lambda: k7_alone(*on_map)]
                                * probe.WARM_CALLS),
          "cold_ms": probe.timings(k7_alone, gathered)["cold_ms"],
          "wrapper_ms": probe.host_ms(lambda: hash_ops.integrate(
              m, active, hcfg, depth, T_wc, cam, fusion, stamp=frame_idx)),
          "plain_ms": probe.host_ms(lambda: hash_ops.integrate_reference(
              hash_ops.touch_active(m, active, frame_idx), active, hcfg,
              depth, T_wc, cam, fusion), iters=10)}
    k7["bound_bytes"] = _k7_bytes(base, active, hcfg, depth, T_wc, cam,
                                  fusion, frame_idx)
    k7["bound_ms"], k7["bound_by"] = _probe_bound(
        k7["bound_bytes"], n * V * K7_OPS_PER_VOXEL)
    k7["info"] = kernel_info("integrate_rows_info", hcfg.block_size)
    for k in (k6, k7):
        k["floor_ms"] = floor_ms
    k7["least_ms"] = max(k7["bound_ms"], floor_ms)

    # the stage (compact -> touch -> integrate), kernels against plain in
    # turns plain / kernel / kernel / plain: host ms, device kernels, host
    # reads
    maps = {"kernel": probe.map_copy(base), "plain": probe.map_copy(base)}

    def kernel_stage():
        mk = maps["kernel"]
        a = hash_ops.compact_visible(mk, *args6)
        hash_ops.integrate(mk, a, hcfg, depth, T_wc, cam, fusion,
                           stamp=frame_idx)

    def plain_stage():
        mp = maps["plain"]
        a = hash_ops.compact_visible_reference(mp, *args6)
        hash_ops.touch_active(mp, a, frame_idx)
        hash_ops.integrate_reference(mp, a, hcfg, depth, T_wc, cam, fusion)

    fns = {"kernel": kernel_stage, "plain": plain_stage}
    host_ms = {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        host_ms[which].append(median_ms(torch, fns[which]))
    stage = {"host_ms": host_ms["kernel"], "host_ms_plain": host_ms["plain"],
             "issue_us": host_issue_us(fns["kernel"]),
             "issue_us_plain": host_issue_us(fns["plain"], reps=5)}
    for which, fn in fns.items():
        tag = "" if which == "kernel" else "_plain"
        stage["device_kernels" + tag] = _device_kernels(torch, fn)
        stage["host_reads" + tag] = sync_sites(torch, fn)
    _emit({"phase": "fuse", "card": card,
           "frame_hw": [cam.height, cam.width], "table": T,
           "max_active": A, "count": n, "frame_idx": frame_idx,
           "max_born": max_born,
           "compact_visible": {"check": k6_cmp, **k6},
           "integrate_rows": {"checks": k7_cmp, **k7},
           "launches_per_frame": dict(zip(FUSE_KERNELS, per_frame)),
           "stage": stage, "seconds": time.perf_counter() - t0})
    _require(k6_exact, "K6 == its plain version bit for bit (the visible "
                       "set, its order and count)")
    _require(k6["scratch_clean"], "every K6 launch leaves its scratch "
                                  "clean")
    _require(k7_exact, "K7 == the plain integrate (+ touch_active) bit for "
                       "bit, every field, both gather modes and both signs")
    _require(per_frame == [1, 1], "one K6 and one K7 launch a frame")
    _require(stage["device_kernels"]["kernels"] == FUSE_STAGE_KERNELS,
             f"compact + touch + integrate run {FUSE_STAGE_KERNELS} device "
             f"kernels")
    _require(not stage["host_reads"], "compact + touch + integrate read "
                                      "nothing on the host")
    _require(0 < n < A, "the step's visible set is neither empty nor capped")
    k7_err = max(c["max_abs_err"] for c in k7_cmp.values())
    return {"compact_visible": {"case": "step", **k6,
                                "max_abs_err": k6_cmp["max_abs_err"],
                                "library_ms": None},
            "integrate_rows": {"case": "step", **k7, "max_abs_err": k7_err,
                               "library_ms": None}}


# The allocation kernels (csrc/alloc.cu): K5a the frame's candidate keys
# and K5b their insert, on the flagship step's own inputs.
ALLOC_KERNELS = ("alloc_candidates", "insert_blocks")
ALLOC_META = {
    "alloc_candidates": {
        "route": "cuda",
        "source": "voxelhashing_demo_tpu_torch/csrc/alloc.cu",
        "replaces": "voxelhashing_demo_tpu/ops/hash_ops.py:151 "
                    "(frame_candidate_keys): fused by XLA, no Pallas kernel",
    },
    "insert_blocks": {
        "route": "cuda",
        "source": "voxelhashing_demo_tpu_torch/csrc/alloc.cu",
        "replaces": "voxelhashing_demo_tpu/ops/hash_ops.py:200 "
                    "(_unique_compact), voxelhashing_demo_tpu/ops/"
                    "hash_ops.py:218 (insert_blocks), voxelhashing_demo_tpu/"
                    "ops/hash_ops.py:118 (lookup_keys): fused by XLA, no "
                    "Pallas kernel",
    },
}
ALLOC_BARRIERS = 1           # K5b's grid-wide arrival (a barrier's cost)
ALLOC_STAGE_KERNELS = 2      # K5a, K5b
ALLOC_CAP = 256              # max_new_per_frame of the cap case
ALLOC_FULL_BUCKETS = 1024    # buckets of the rank-overflow case's table
ALLOC_WARM_COPIES = 8        # K5b's timed launches on L2-resident state
ALLOC_COLD_COPIES = 32       # ... on state rotated through more than L2
ALLOC_INT_FIELDS = ("keys", "ptrs", "bucket_fill", "free_top")
# K5a's least bytes: a strided pixel's depth and vertex (16 B) read, a key
# (4 B) written, the pose; ~45 float and integer operations a key
K5A_PIXEL_BYTES, K5A_OPS = 16, 45
# K5b: ~30 integer operations a candidate key (the dedupe), ~60 a kept
# key (hash, probe, rank); its bytes in ``_alloc_stats``
K5B_KEY_OPS, K5B_KEPT_OPS = 30, 60


MAINT_KERNELS = ("gc_free", "evict_free", "restore_rows")
MAINT_SOURCE = "voxelhashing_demo_tpu_torch/csrc/maintain.cu"
MAINT_META = {
    "gc_free": {
        "route": "cuda", "source": MAINT_SOURCE,
        "replaces": "voxelhashing_demo_tpu/ops/hash_ops.py:613 "
                    "(garbage_collect), voxelhashing_demo_tpu/ops/"
                    "hash_ops.py:566 (_free_marked): fused by XLA, no Pallas "
                    "kernel",
    },
    "evict_free": {
        "route": "cuda", "source": MAINT_SOURCE,
        "replaces": "voxelhashing_demo_tpu/ops/hash_ops.py:663 "
                    "(evict_stale), voxelhashing_demo_tpu/ops/hash_ops.py:566 "
                    "(_free_marked): fused by XLA, no Pallas kernel",
    },
    "restore_rows": {
        "route": "cuda", "source": MAINT_SOURCE,
        "replaces": "voxelhashing_demo_tpu/ops/hash_ops.py:715 "
                    "(restore_blocks), voxelhashing_demo_tpu/ops/"
                    "hash_ops.py:118 (lookup_keys): fused by XLA, no Pallas "
                    "kernel",
    },
}
# the public function each stands behind
MAINT_PUBLIC = ("garbage_collect", "evict_stale", "restore_blocks")
# the paths on which each must launch (flagship GC every 16 frames on runs
# of 24 frames and more; the streaming cycle)
MAINT_REQUIRED = {"gc_free": ("march", "backend", "stream",
                              "stream_backend"),
                  "evict_free": ("stream", "stream_backend"),
                  "restore_rows": ("stream", "stream_backend")}
GC_FIELDS = ("keys", "ptrs", "bucket_fill", "free_list", "free_top")
MAINT_GC_KERNELS = 2        # the GC frame's garbage_collect: K10 at most + 1
MAINT_SLOT_OPS = 12         # integer operations a table slot (K10, K14)


def maint_launches() -> list:
    """[K10, K14, K15] launches counted since they were last set to 0."""
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    return [hash_ops.LAUNCHES_GC, hash_ops.LAUNCHES_EVICT,
            hash_ops.LAUNCHES_RESTORE]


def zero_maint_launches() -> None:
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    hash_ops.LAUNCHES_GC = hash_ops.LAUNCHES_EVICT = 0
    hash_ops.LAUNCHES_RESTORE = 0


def set_maint_launches(counts) -> None:
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    (hash_ops.LAUNCHES_GC, hash_ops.LAUNCHES_EVICT,
     hash_ops.LAUNCHES_RESTORE) = counts


_MAINT_CALLS: list = []     # the MaintCalls installed


class MaintCalls:
    """While installed, counts the calls of ``garbage_collect``,
    ``evict_stale`` and ``restore_blocks`` (called by module attribute)
    on a map on the card (a restore only with keys): each must be one
    launch of its kernel."""

    def __init__(self, hash_ops):
        self.ops = hash_ops
        self.counts = dict.fromkeys(MAINT_PUBLIC, 0)

    def __enter__(self):
        _MAINT_CALLS.append(self)
        self.real = {k: getattr(self.ops, k) for k in MAINT_PUBLIC}

        def counted(name):
            fn = self.real[name]

            def wrapper(hmap, cfg, *a, **k):
                keys = (a[0] if a else k["keys"]) if \
                    name == "restore_blocks" else None
                if hmap.keys.is_cuda and (keys is None or keys.numel()):
                    self.counts[name] += 1
                return fn(hmap, cfg, *a, **k)
            return wrapper

        for k in MAINT_PUBLIC:
            setattr(self.ops, k, counted(k))
        return self

    def __exit__(self, *exc):
        _MAINT_CALLS.remove(self)
        for k, fn in self.real.items():
            setattr(self.ops, k, fn)

    def list(self) -> list:
        return [self.counts[k] for k in MAINT_PUBLIC]


@contextlib.contextmanager
def uncounted_maint():
    """K10's, K14's and K15's launches, and the calls MaintCalls counts,
    left as they were before the block: the checks against the plain
    versions and the timings do not count as a path's launches."""
    launches = maint_launches()
    calls = [dict(c.counts) for c in _MAINT_CALLS]
    try:
        yield
    finally:
        set_maint_launches(launches)
        for c, saved in zip(_MAINT_CALLS, calls):
            c.counts = saved


def alloc_launches() -> list:
    """[K5a, K5b] launches counted since they were last set to 0."""
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    return [hash_ops.LAUNCHES_ALLOC_CANDIDATES, hash_ops.LAUNCHES_INSERT]


def zero_alloc_launches() -> None:
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    hash_ops.LAUNCHES_ALLOC_CANDIDATES = hash_ops.LAUNCHES_INSERT = 0


def _restore(dst, src, fields=ALLOC_INT_FIELDS) -> None:
    """``dst``'s ``fields`` copied back from ``src`` (on the device)."""
    for f in fields:
        getattr(dst, f).copy_(getattr(src, f))


def _prepped_ms(torch, fn, prep, reps: int = 5) -> float:
    """Median ms of ``fn`` (CUDA events around the call, synchronised),
    ``prep()`` run and drained before each call, outside the timing."""
    times = []
    for _ in range(reps + 1):
        prep()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times[1:]))


def _alloc_stats(torch, base, hcfg, cand, n_alloc: int) -> dict:
    """The distinct keys U, the kept (the cap) and the new ones, the
    buckets they probe, and the bytes K5b must move for one insert of
    ``cand`` into ``base`` that takes ``n_alloc`` rows: each candidate
    key read; each probed bucket's slots and fill; for each new row a
    free-list entry read, its key, ptr and row (2 V floats, band_min,
    last_seen, born) written; the fills it changes, free_top and
    n_alloc."""
    from voxelhashing_demo_tpu_torch.geometry import coords
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    uniq = torch.unique(cand[cand != hash_ops.EMPTY_KEY])
    kept = uniq[:hcfg.max_new_per_frame]
    _, found = hash_ops.lookup_keys(base, hcfg, kept)
    bucket = hash_ops.default_bucket_fn(hcfg)(
        coords.unpack_block_key(kept, hcfg.key_bits))
    probed = int(torch.unique(bucket).numel())
    filled = int(torch.unique(bucket[~found]).numel())
    V = hcfg.voxels_per_block
    nbytes = (cand.numel() * 4 + probed * 4 * (hcfg.bucket_size + 1)
              + n_alloc * (4 + 8 + 4 * (2 * V + 3)) + 4 * filled + 8)
    return {"U": int(uniq.numel()), "kept": int(kept.numel()),
            "new": int((~found).sum()), "buckets_probed": probed,
            "bound_bytes": nbytes,
            "ops": cand.numel() * K5B_KEY_OPS + kept.numel() * K5B_KEPT_OPS}


def _scratch_state(torch) -> dict:
    """K5b's persistent scratches after the phase's launches: how many,
    and whether each is as every launch must leave it (its counts 0, its
    set EMPTY_KEY)."""
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    torch.cuda.synchronize()
    clean = []
    for t, capacity, set_bits in hash_ops._INSERT_SCRATCH.values():
        hdr, st = hash_ops.insert_scratch_parts(t, capacity, set_bits)
        clean.append(bool((hdr == 0).all())
                     and bool((st == hash_ops.EMPTY_KEY).all()))
    return {"scratches": len(clean), "clean": bool(clean) and all(clean)}


def _kernel_us(torch, fn, name: str) -> dict:
    """Device µs a launch of the kernels whose name holds ``name`` in one
    call of ``fn`` (torch.profiler's CUDA events): their count, min and
    median (None when the profiler saw none)."""
    us = [e.time_range.elapsed_us() for e in _cuda_events(torch, fn)
          if name in e.name]
    return {"launches": len(us),
            "min_us": float(np.min(us)) if us else None,
            "median_us": float(np.median(us)) if us else None}


def _k5b_graph(torch, launch, base, rows, copies: int, reps: int,
               fields=ALLOC_INT_FIELDS, name: str = "insert_blocks") -> dict:
    """A map kernel alone (K5b unless ``name`` says otherwise): ``copies``
    launches, each on its own copy of ``base``'s ``fields`` (``rows``'
    other fields shared), captured into one CUDA graph; the copies
    restored before each of ``reps`` replays.  Returns {"ms": device ms
    per launch (CUDA events around one replay, over ``copies``),
    "kernel_us": the kernel's own device µs a launch in one replay, and
    "eager_kernel_us" in the same launches made one by one (the
    profiler's), "replayed": the first copy after the last replay}."""
    maps = [rows._replace(**{f: getattr(base, f).clone() for f in fields})
            for _ in range(copies)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch(maps[0])
    torch.cuda.current_stream().wait_stream(side)
    # captured on the warm-up's stream, whose K5b scratch exists already
    # (a capture that finds none takes its own, filled in every replay)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for m in maps:
            launch(m)

    def prep():
        for m in maps:
            _restore(m, base, fields)

    ms = _prepped_ms(torch, graph.replay, prep, reps) / copies
    prep()
    kernel_us = _kernel_us(torch, graph.replay, name)
    prep()
    eager_us = _kernel_us(torch, lambda: [launch(m) for m in maps], name)
    prep()
    graph.replay()
    return {"ms": ms, "kernel_us": kernel_us, "eager_kernel_us": eager_us,
            "replayed": maps[0]}


def _maps_equal(torch, got, want) -> dict:
    """{field: bit for bit} of two HashMaps (floats by their bits)."""
    def same(a, b):
        if a.dtype == torch.float32:
            return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))
        return bool(torch.equal(a, b))
    return {f: same(getattr(got, f), getattr(want, f)) for f in got._fields}


def _changed_slots(base, after) -> int:
    """Table slots whose key or ptr differ between two maps."""
    return int(((base.keys != after.keys) | (base.ptrs != after.ptrs)).sum())


def _k10_case(torch, base, hcfg, min_weight, max_free, frame, min_age):
    """K10 against ``garbage_collect_reference`` on copies of ``base``:
    {"fields", "bit_exact", "n_freed", "live", "gated_rows", "changed",
    "bound_bytes"} (the bytes K10 must move: every slot's key and ptr, the
    live rows' last_seen, the weight rows of the live rows the age gate
    passes, the fills, the changed slots, the pushed stack entries)."""
    from voxelhashing_demo_tpu_torch.ops import hash_ops
    from voxelhashing_demo_tpu_torch.tools import probe

    got, want = probe.map_copy(base), probe.map_copy(base)
    _, n_got = hash_ops.garbage_collect(got, hcfg, min_weight, max_free,
                                        frame, min_age)
    _, n_want = hash_ops.garbage_collect_reference(
        want, hcfg, min_weight, max_free, frame, min_age)
    fields = _maps_equal(torch, got, want)
    fields["n_freed"] = int(n_got) == int(n_want)
    live_ptrs = base.ptrs[base.ptrs != hash_ops.FREE_PTR].long()
    gated = live_ptrs.numel()
    if frame is not None and min_age > 0:
        gated = int(((frame - base.last_seen[live_ptrs]) >= min_age).sum())
    n = int(n_want)
    changed = _changed_slots(base, want)
    nbytes = (8 * base.keys.numel() + 4 * live_ptrs.numel()
              + 4 * hcfg.voxels_per_block * gated + 4 * hcfg.num_buckets
              + 8 * changed + 4 * n + 8)
    return {"fields": fields, "bit_exact": all(fields.values()),
            "n_freed": n, "live": int(live_ptrs.numel()),
            "gated_rows": gated, "changed_slots": changed,
            "bound_bytes": nbytes}


def _k10_check(torch, slam, sweep, floor_ms: float) -> dict:
    """K10 (``garbage_collect`` on the card) on the run's first GC frame
    (frame ``interval - 1``), on the map as the step handed it over: bit
    for bit against ``garbage_collect_reference`` there (the age gate
    keeps every row: nothing freed) and 16 frames later on the same map
    (every row past the gate: the weight test runs, blocks freed); the
    call's device kernels (torch.profiler), host ms (CUDA events) and host
    reads; the kernel alone warm and L2-cold (a CUDA graph of 8 and 32
    launches on copies of the map's integer state, restored before each
    replay; its own µs a launch by the profiler), its wrapper's host ms
    and µs to issue, the plain version's ms, the bound from this run's
    map, the least (the launch floor and one status exchange, a grid
    barrier's cost)."""
    from voxelhashing_demo_tpu_torch import kernels
    from voxelhashing_demo_tpu_torch.ops import hash_ops
    from voxelhashing_demo_tpu_torch.tools import probe

    gc = slam.config.gc
    frame = slam.state.frame_idx
    while frame % gc.interval != gc.interval - 1:
        slam.process(sweep[frame])
        frame += 1
    last = []

    def record(real):
        def fn(hmap, *a, **k):
            last[:] = [probe.map_copy(hmap), *a]
            return real(hmap, *a, **k)
        return fn

    with _wrapped(hash_ops, "garbage_collect", record):
        slam.process(sweep[frame])
    base, hcfg, min_weight, max_free = last[:4]
    args = (hcfg, min_weight, max_free, frame, gc.min_age)
    cases = {"step": _k10_case(torch, base, *args),
             "aged_16": _k10_case(torch, base, hcfg, min_weight, max_free,
                                  frame + 16, gc.min_age)}
    fields = GC_FIELDS
    work = base._replace(**{f: getattr(base, f).clone() for f in fields})

    def run():
        return hash_ops.garbage_collect(work, *args)

    def prep():
        _restore(work, base, fields)

    host_ms = _prepped_ms(torch, run, prep)
    prep()
    kern = _device_kernels(torch, run)
    prep()
    reads = sync_sites(torch, run)
    prep()

    def k10_alone(m):
        hash_ops.garbage_collect(m, *args)

    rows = probe.map_copy(base, probe.MAP_FIELDS)
    graphs = {n: _k5b_graph(torch, k10_alone, base, rows, n,
                            probe.WARM_CALLS // 2 if n < 32 else 5,
                            fields, "free_kernel")
              for n in (1, ALLOC_WARM_COPIES, ALLOC_COLD_COPIES)}
    want = probe.map_copy(base, fields)
    hash_ops.garbage_collect_reference(want, *args)
    replay_exact = all(bool(torch.equal(getattr(g["replayed"], f),
                                        getattr(want, f)))
                       for g in graphs.values() for f in fields)
    step = cases["step"]
    out = {"frame": frame, "cases": cases,
           "ms": graphs[ALLOC_WARM_COPIES]["ms"],
           "cold_ms": graphs[ALLOC_COLD_COPIES]["ms"],
           "graph_copies": {str(n): {k: g[k] for k in (
               "ms", "kernel_us", "eager_kernel_us")}
               for n, g in graphs.items()},
           "graph_replay_bit_exact": replay_exact,
           "wrapper_ms": probe.host_ms(run),
           "host_issue_us": host_issue_us(run, reps=WRAPPER_REPS),
           "plain_ms": _prepped_ms(torch, lambda: hash_ops.
                                   garbage_collect_reference(work, *args),
                                   prep),
           "call_host_ms": host_ms, "device_kernels": kern["kernels"],
           "device_us": kern["busy_us"], "host_reads": reads,
           "bound_bytes": step["bound_bytes"]}
    prep()
    out["bound_ms"], out["bound_by"] = _probe_bound(
        step["bound_bytes"], MAINT_SLOT_OPS * base.keys.numel())
    tiles = -(-hcfg.num_buckets // hash_ops.MAINTAIN_TILE)
    out["barrier_floor_ms"] = barrier_floor_ms(torch, kernels, tiles)
    out["floor_ms"] = floor_ms
    out["least_ms"] = max(out["bound_ms"],
                          floor_ms + out["barrier_floor_ms"])
    return out


def phase_alloc(torch, card: str, sweep) -> dict:
    """K5a ``alloc_candidates`` and K5b ``insert_blocks`` on the flagship
    step's own inputs: the map, frame and pose that ``allocate_from_frame``
    takes on frame N_STEP_FRAMES of the room sweep, after the first
    N_STEP_FRAMES frames through ``HashSLAM(flagship_gather_config())``,
    its map copied before the call; then ``garbage_collect`` on the same
    run's first GC frame (K10's cost).  Returns {kernel: its kernels-line
    fields}."""
    from voxelhashing_demo_tpu_torch import kernels
    from voxelhashing_demo_tpu_torch.config import flagship_gather_config
    from voxelhashing_demo_tpu_torch.models import hash_slam
    from voxelhashing_demo_tpu_torch.ops import hash_ops
    from voxelhashing_demo_tpu_torch.tools import probe

    t0 = time.perf_counter()
    cfg = flagship_gather_config()
    slam = hash_slam.HashSLAM(cfg)
    for d in sweep[:N_STEP_FRAMES]:
        slam.process(d)
    # one frame of the step: allocate_from_frame's arguments, its map
    # copied before the call; one K5a and one K5b launch
    last = []

    def record(real):
        def fn(hmap, frame, T_wc, cam, hcfg, fusion, frame_idx=0,
               bucket_fn=None):
            last[:] = [probe.map_copy(hmap), frame, T_wc, cam, hcfg, fusion,
                       frame_idx]
            return real(hmap, frame, T_wc, cam, hcfg, fusion,
                        frame_idx=frame_idx, bucket_fn=bucket_fn)
        return fn

    zero_alloc_launches()
    with _wrapped(hash_ops, "allocate_from_frame", record):
        slam.process(sweep[N_STEP_FRAMES])
    per_frame = alloc_launches()
    base, frame, T_wc, cam, hcfg, fusion, frame_idx = last
    cargs = (frame, T_wc, cam, hcfg, fusion)

    # K5a and K5b against the plain versions, bit for bit: every map field
    # and n_alloc, in the four cases
    cand = hash_ops.frame_candidate_keys_reference(*cargs)
    k5a_cmp = probe.compare(hash_ops.frame_candidate_keys(*cargs), cand)

    def insert_case(m0, h):
        got, want = probe.map_copy(m0), probe.map_copy(m0)
        _, n_got = hash_ops.insert_blocks(got, h, cand, frame_idx)
        _, n_want = hash_ops.insert_blocks_reference(want, h, cand,
                                                     frame_idx)
        fields = {f: bool(torch.equal(getattr(got, f), getattr(want, f)))
                  for f in base._fields}
        fields["n_alloc"] = int(n_got) == int(n_want)
        stats = _alloc_stats(torch, m0, h, cand, int(n_want))
        return {"bit_exact": all(fields.values()), "fields": fields,
                "n_alloc": int(n_want), "free_top_before": int(m0.free_top),
                **{k: stats[k] for k in ("U", "kept", "new",
                                         "buckets_probed")}}

    cases = {"step": insert_case(base, hcfg)}
    cases["cap"] = insert_case(base, dataclasses.replace(
        hcfg, max_new_per_frame=ALLOC_CAP))
    heap = probe.map_copy(base)
    heap.free_top.fill_(max(cases["step"]["n_alloc"] // 2, 1))
    cases["heap"] = insert_case(heap, hcfg)
    del heap
    full_cfg = dataclasses.replace(hcfg, num_buckets=ALLOC_FULL_BUCKETS)
    full = hash_ops.create(full_cfg)
    shifted = T_wc.clone()
    shifted[:3, 3] += torch.tensor([0.3, 0.1, -0.2], device=T_wc.device)
    hash_ops.insert_blocks_reference(
        full, full_cfg, hash_ops.frame_candidate_keys_reference(
            frame, shifted, cam, full_cfg, fusion), frame_idx - 1)
    fills = [int((full.bucket_fill == k).sum()) for k in range(5)]
    cases["full_buckets"] = {**insert_case(full, full_cfg),
                             "fills_0_to_4": fills}
    del full
    torch.cuda.empty_cache()
    k5b_exact = all(c["bit_exact"] for c in cases.values())
    step = cases["step"]

    # each kernel alone (CUDA graphs), warm and L2-cold, its wrapper, its
    # plain version; bounds from this run's frame, keys and rows
    floor_ms = probe.launch_floor_ms()
    index = torch.cuda.current_device()
    H_, W_ = frame.depth.shape
    s = hcfg.candidate_stride
    out5a = torch.empty_like(cand)
    ints5a, floats5a = hash_ops._candidate_tables(hcfg, fusion)

    def k5a_alone(verts, depth, pose):
        kernels.launch("alloc_candidates", index, verts.data_ptr(),
                       depth.data_ptr(), pose.data_ptr(), out5a.data_ptr(),
                       H_, W_, ints5a, floats5a)

    k5a = {**probe.timings(k5a_alone, (frame.vertices.contiguous(),
                                       frame.depth.contiguous(), T_wc)),
           "wrapper_ms": probe.host_ms(
               lambda: hash_ops.frame_candidate_keys(*cargs)),
           "plain_ms": probe.host_ms(
               lambda: hash_ops.frame_candidate_keys_reference(*cargs),
               iters=10)}
    rays = -(-H_ // s) * -(-W_ // s)
    k5a["bound_bytes"] = rays * K5A_PIXEL_BYTES + cand.numel() * 4 + 64
    k5a["bound_ms"], k5a["bound_by"] = _probe_bound(
        k5a["bound_bytes"], cand.numel() * K5A_OPS)
    k5a["least_ms"] = max(k5a["bound_ms"], floor_ms)

    rows = probe.map_copy(base, probe.MAP_FIELDS)
    want = probe.map_copy(base, ALLOC_INT_FIELDS)
    hash_ops.insert_blocks_reference(want, hcfg, cand, frame_idx)

    def k5b_alone(m):
        hash_ops.insert_blocks(m, hcfg, cand, frame_idx)

    # ms: CUDA events around one replay of a graph of ALLOC_WARM_COPIES
    # (ALLOC_COLD_COPIES) launches, over its launches, so a replay's fixed
    # cost is spread over 8 (32) of them; the kernel's own time is the
    # profiler's, and a graph of one launch shows the fixed cost whole
    graphs = {n: _k5b_graph(torch, k5b_alone, base, rows, n,
                            probe.WARM_CALLS // 2 if n < 32 else 5)
              for n in (1, ALLOC_WARM_COPIES, ALLOC_COLD_COPIES)}
    warm_ms = graphs[ALLOC_WARM_COPIES]["ms"]
    cold_ms = graphs[ALLOC_COLD_COPIES]["ms"]
    replay_exact = all(bool(torch.equal(getattr(g["replayed"], f),
                                        getattr(want, f)))
                       for g in graphs.values() for f in ALLOC_INT_FIELDS)
    work = rows._replace(**{f: getattr(base, f).clone()
                            for f in ALLOC_INT_FIELDS})

    def prep():
        _restore(work, base)

    k5b = {"ms": warm_ms, "cold_ms": cold_ms,
           "wrapper_ms": probe.host_ms(lambda: k5b_alone(work)),
           "host_issue_us": host_issue_us(lambda: k5b_alone(work),
                                          reps=WRAPPER_REPS),
           "plain_ms": _prepped_ms(torch, lambda: hash_ops.
                                   insert_blocks_reference(
                                       work, hcfg, cand, frame_idx), prep),
           "graph_replay_bit_exact": replay_exact,
           "graph_copies": {str(n): {k: g[k] for k in (
               "ms", "kernel_us", "eager_kernel_us")}
               for n, g in graphs.items()}}
    stats = _alloc_stats(torch, base, hcfg, cand, step["n_alloc"])
    k5b["bound_bytes"] = stats["bound_bytes"]
    k5b["bound_ms"], k5b["bound_by"] = _probe_bound(stats["bound_bytes"],
                                                    stats["ops"])
    ctas = min(-(-cand.numel() // 1024),
               torch.cuda.get_device_properties(index).multi_processor_count)
    k5b["barrier_floor_ms"] = barrier_floor_ms(torch, kernels, ctas)
    k5b["barriers"] = ALLOC_BARRIERS
    k5b["least_ms"] = max(k5b["bound_ms"], floor_ms
                          + ALLOC_BARRIERS * k5b["barrier_floor_ms"])
    for k in (k5a, k5b):
        k["floor_ms"] = floor_ms

    # the stage (allocate_from_frame), kernels against plain in turns
    # plain / kernel / kernel / plain, each on its own map copy restored
    # before each call: host ms, µs to issue, device kernels, host reads
    maps = {"kernel": probe.map_copy(base), "plain": probe.map_copy(base)}
    fns = {"kernel": lambda: hash_ops.allocate_from_frame(
               maps["kernel"], *cargs, frame_idx=frame_idx),
           "plain": lambda: hash_ops.insert_blocks_reference(
               maps["plain"], hcfg,
               hash_ops.frame_candidate_keys_reference(*cargs), frame_idx)}
    preps = {w: (lambda w=w: _restore(maps[w], base)) for w in maps}
    host_ms = {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        host_ms[which].append(_prepped_ms(torch, fns[which], preps[which]))
    stage = {"host_ms": host_ms["kernel"], "host_ms_plain": host_ms["plain"]}
    for which, fn in fns.items():
        tag = "" if which == "kernel" else "_plain"
        stage["issue_us" + tag] = host_issue_us(
            fn, reps=20 if which == "kernel" else 5)
        preps[which]()
        stage["device_kernels" + tag] = _device_kernels(torch, fn)
        preps[which]()
        stage["host_reads" + tag] = sync_sites(torch, fn)
    whole = probe.map_copy(base)
    fuse_reads = sync_sites(torch, lambda: hash_ops.fuse_frame(
        whole, *cargs, frame_idx=frame_idx))
    k10 = _k10_check(torch, slam, sweep, floor_ms)
    # what stands between the whole step and a CUDA graph: its host reads
    # and device kernels on the next sweep frame
    depth_next = hash_slam.depth_tensor(sweep[slam.state.frame_idx],
                                        slam.device)

    def whole_step():
        hash_slam.step(slam.state, depth_next, cfg)

    step_reads = sync_sites(torch, whole_step)
    step_kernels = _device_kernels(torch, whole_step)
    scratch = _scratch_state(torch)

    _emit({"phase": "alloc", "card": card,
           "frame_hw": [cam.height, cam.width], "frame_idx": frame_idx,
           "candidates": cand.numel(), "U": step["U"],
           "n_alloc": step["n_alloc"], "max_new": hcfg.max_new_per_frame,
           "alloc_candidates": {"check": k5a_cmp, **k5a},
           "insert_blocks": {"cases": cases, **k5b},
           "launches_per_frame": dict(zip(ALLOC_KERNELS, per_frame)),
           "stage": stage, "fuse_frame_host_reads": fuse_reads,
           "gc_free": k10, "step_host_reads": step_reads,
           "step_device_kernels": step_kernels, "k5b_scratch": scratch,
           "seconds": time.perf_counter() - t0})
    _require(k5a_cmp["bit_exact"], "K5a == frame_candidate_keys_reference "
                                   "bit for bit")
    _require(k5b_exact, "K5b == insert_blocks_reference bit for bit, every "
                        "map field and n_alloc, in every case")
    _require(scratch["clean"], "every K5b scratch left clean (counts 0, "
                               "set empty)")
    _require(replay_exact, "K5b replayed from a CUDA graph == the plain "
                           "insert")
    _require(step["n_alloc"] > 0 and step["new"] > 0,
             "the step's frame allocates")
    _require(cases["cap"]["U"] > ALLOC_CAP
             and cases["cap"]["kept"] == ALLOC_CAP, "the cap case caps")
    _require(cases["heap"]["n_alloc"] == cases["heap"]["free_top_before"]
             < cases["step"]["n_alloc"], "the heap case runs the heap dry")
    _require(min(fills[3:]) > 0 and cases["full_buckets"]["n_alloc"]
             < cases["full_buckets"]["new"],
             "the full-bucket case has buckets at 3 and 4 and drops keys")
    _require(per_frame == [1, 1], "one K5a and one K5b launch a frame")
    _require(stage["device_kernels"]["kernels"] == ALLOC_STAGE_KERNELS,
             f"allocate_from_frame runs {ALLOC_STAGE_KERNELS} device kernels")
    _require(not stage["host_reads"], "allocate_from_frame reads nothing on "
                                      "the host")
    _require(not fuse_reads, "fuse_frame reads nothing on the host")
    _require(all(c["bit_exact"] for c in k10["cases"].values()),
             "K10 == garbage_collect_reference bit for bit on the GC "
             "frame's map, at its frame and 16 frames later")
    _require(k10["cases"]["aged_16"]["n_freed"] > 0,
             "K10's aged case frees blocks")
    _require(k10["graph_replay_bit_exact"], "K10 replayed from a CUDA graph "
                                            "== the plain GC")
    _require(k10["device_kernels"] <= MAINT_GC_KERNELS,
             f"the GC frame's garbage_collect runs <= {MAINT_GC_KERNELS} "
             f"device kernels")
    _require(not k10["host_reads"], "garbage_collect reads nothing on the "
                                    "host")
    return {"gc_free": {"case": "step", **{
                k: v for k, v in k10.items() if k != "cases"},
                "max_abs_err": 0.0, "library_ms": None},
            "alloc_candidates": {"case": "step", **k5a,
                                 "max_abs_err": k5a_cmp["max_abs_err"],
                                 "library_ms": None},
            "insert_blocks": {"case": "step", **k5b,
                              "max_abs_err": 0.0 if k5b_exact
                              else float("inf"), "library_ms": None}}


def _run_port(torch, cfg, depths, device):
    from voxelhashing_demo_tpu_torch.models import hash_slam

    slam = hash_slam.HashSLAM(cfg, device=device)
    for d in depths:
        slam.process(d)
    return slam


def phase_parity(torch):
    """Port on the card vs the port on the CPU, tiny flagship config."""
    from voxelhashing_demo_tpu_torch.config import (flagship_gather_config,
                                                    tiny_config)
    from voxelhashing_demo_tpu_torch.utils import synthetic

    base = flagship_gather_config()
    cfg = dataclasses.replace(
        base, camera=tiny_config().camera,
        hash=dataclasses.replace(base.hash, num_buckets=4096,
                                 num_blocks=4096, max_active=2048,
                                 max_new_per_frame=2048),
    )
    depths, _ = synthetic.make_sequence(cfg.camera, 10, trans_amp=0.05,
                                        rot_amp_deg=2.5, device="cpu")
    cpu = _run_port(torch, cfg, depths, "cpu")
    gpu = _run_port(torch, cfg, depths, "cuda")
    diff = max(float((a.cpu() - b)[:3, 3].abs().max())
               for a, b in zip(gpu.trajectory, cpu.trajectory))
    same_tracked = all(bool(a.tracked) == bool(b.tracked)
                       for a, b in zip(gpu.infos, cpu.infos))
    _emit({"phase": "parity", "frames": len(depths),
           "max_pose_trans_diff_m": diff, "atol_m": PARITY_ATOL_M,
           "same_tracked": same_tracked})
    _require(same_tracked, "same tracked flags on card and CPU")
    _require(diff <= PARITY_ATOL_M, "card pose within 1e-4 m of CPU pose")


def _drive(torch, slam, depths):
    """Process the frames; returns (per-frame ms, K7's window-gather
    launches per frame).  The launch count starts at 0 here."""
    zero_k7_window()
    frame_ms, launches = [], []
    for d in depths:
        before = k7_window()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        slam.process(d)
        end.record()
        torch.cuda.synchronize()
        frame_ms.append(start.elapsed_time(end))
        launches.append(k7_window() - before)
    return frame_ms, launches


def _run_stats(slam, gt, frame_ms, launches) -> dict:
    from voxelhashing_demo_tpu_torch.utils import metrics

    poses = [p.cpu().numpy() for p in slam.trajectory]
    return {
        "frames": len(poses),
        "tracked": sum(bool(i.tracked) for i in slam.infos),
        "finite_poses": all(np.isfinite(p).all() for p in poses),
        "ate_mm": metrics.ate_rmse(poses, gt, align=False) * 1000.0,
        "active_blocks": int(slam.infos[-1].blocks_active),
        "blocks_allocated": int(sum(int(i.blocks_allocated)
                                    for i in slam.infos)),
        "blocks_freed": int(sum(int(i.blocks_freed) for i in slam.infos)),
        "kernel_launches": sum(launches),
        "launches_per_frame": launches,
        "frame_ms_p50": float(np.percentile(frame_ms, 50)),
        "frame_ms_max": float(np.max(frame_ms)),
        "frame_ms": frame_ms,
    }


def _check_run(stats: dict, hit: float, ate_bound_mm: float,
               hit_bound: float) -> None:
    n = stats["frames"]
    _require(all(k > 0 for k in stats["launches_per_frame"]),
             "K7 (window gather) launched on every integrating frame")
    _require(stats["tracked"] >= n - 1, f">= {n - 1}/{n} frames tracked")
    _require(stats["finite_poses"], "finite poses")
    _require(stats["ate_mm"] < ate_bound_mm,
             f"unaligned ATE < {ate_bound_mm} mm")
    _require(hit > hit_bound, f"render hit fraction > {hit_bound}")


def phase_slice(torch):
    from voxelhashing_demo_tpu_torch.config import flagship_gather_config
    from voxelhashing_demo_tpu_torch.models import hash_slam
    from voxelhashing_demo_tpu_torch.utils import synthetic

    cfg = flagship_gather_config()
    # the first N_FRAMES of the 20-frame orbit the JAX reference ran
    depths, gt = synthetic.make_sequence(
        cfg.camera, JAX_REFERENCE["frames"], trans_amp=0.05,
        rot_amp_deg=2.5)
    depths, gt = depths[:N_FRAMES], gt[:N_FRAMES]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    slam = hash_slam.HashSLAM(cfg)
    frame_ms, launches = _drive(torch, slam, depths)
    hit = float(slam.render().hit.float().mean())
    stats = _run_stats(slam, gt, frame_ms, launches)
    _emit({"phase": "slice", "H": H, "W": W, **stats, "hit_frac": hit,
           "note": f"first {N_FRAMES} of the reference's 20 frames",
           "peak_mem_bytes": int(torch.cuda.max_memory_allocated()),
           "jax_reference": JAX_REFERENCE})
    _check_run(stats, hit, ATE_BOUND_MM, HIT_BOUND)
    return stats["kernel_launches"]


def median_ms(torch, fn, reps: int = 5) -> float:
    """Median time of ``fn`` over ``reps`` runs after one warm-up (CUDA
    events, synchronised after each run)."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def march_stage_ms(torch, cfg, state, active) -> dict:
    """The march prediction alone on ``state``: the cache build, and the
    cache build plus the sphere trace, through the kernels (K12, K11) and
    through their plain versions on the same state.  chip_profile.py times
    the same stage through this function."""
    from voxelhashing_demo_tpu_torch.geometry import camera as cam_geom
    from voxelhashing_demo_tpu_torch.ops import hash_raycast
    from voxelhashing_demo_tpu_torch.ops import raycast as rc_ops

    dims = cfg.raycast.cache_dims
    args = (state.hmap, active, cfg.hash, cfg.fusion, state.pose, dims)

    def plain_march():
        cache = hash_raycast.densify_active_reference(*args)
        rays = cam_geom.pixel_rays(cfg.camera, device=state.pose.device)
        return rc_ops.raycast_rays_reference(cache, state.pose, rays,
                                             cfg.raycast)

    with uncounted_march():
        return {
            "densify": median_ms(
                torch, lambda: hash_raycast.densify_active(*args)),
            "densify_and_march": median_ms(
                torch, lambda: hash_raycast.raycast_hash(
                    state.hmap, active, cfg.hash, state.pose, cfg.camera,
                    cfg.raycast, cfg.fusion, cache_dims=dims)),
            "densify_plain": median_ms(
                torch, lambda: hash_raycast.densify_active_reference(*args)),
            "densify_and_march_plain": median_ms(torch, plain_march),
        }


def room_sweep():
    """(config, frames, ground truth) of the noisy room sweep in march
    mode; its first frames also give the kernel phase its step rows."""
    from voxelhashing_demo_tpu_torch.config import flagship_gather_config
    from voxelhashing_demo_tpu_torch.utils import synthetic

    base = flagship_gather_config()
    cfg = dataclasses.replace(
        base, raycast=dataclasses.replace(base.raycast, mode="march"))
    depths, gt = synthetic.make_room_sweep(
        cfg.camera, N_MARCH, sweep_deg=40.0, noise_seed=1)
    return cfg, depths, gt


# The march kernels (csrc/raycast.cu): K12 builds the view-local cache,
# K11 sphere-traces it.
MARCH_KERNELS = ("raycast_march", "densify_cache")
MARCH_SOURCE = "voxelhashing_demo_tpu_torch/csrc/raycast.cu"
MARCH_META = {
    "raycast_march": {
        "route": "cuda", "source": MARCH_SOURCE,
        "replaces": "voxelhashing_demo_tpu/ops/raycast.py:52 "
                    "(raycast_rays, its lax.fori_loop :111), "
                    "voxelhashing_demo_tpu/ops/tsdf.py:120 "
                    "(trilinear_sample), voxelhashing_demo_tpu/ops/tsdf.py:"
                    "165 (sdf_gradient): fused by XLA, no Pallas kernel",
    },
    "densify_cache": {
        "route": "cuda", "source": MARCH_SOURCE,
        "replaces": "voxelhashing_demo_tpu/ops/hash_raycast.py:117 "
                    "(densify_rows), voxelhashing_demo_tpu/ops/"
                    "hash_raycast.py:87 (densify_active): fused by XLA, no "
                    "Pallas kernel",
    },
}
# float operations K11 does: a step (the sample's position, voxel
# coordinate, floor and fractions, 8 corner weights and the two sums, the
# step), a hit's gradient normal (6 samples, the norm, the divide, the
# rotation and the flip), a ray's set-up and outputs
K11_OPS_PER_STEP, K11_OPS_GRADIENT, K11_OPS_RAY = 80, 460, 40
K11_OUT_BYTES = 4 + 12 + 12 + 1      # depth, points, normals, hit a ray
MARCH_SECTOR_BYTES = 32               # bytes a sector


def march_launches() -> list:
    """[K11, K12] launches counted since they were last set to 0."""
    from voxelhashing_demo_tpu_torch.ops import hash_raycast
    from voxelhashing_demo_tpu_torch.ops import raycast as rc_ops

    return [rc_ops.LAUNCHES_MARCH, hash_raycast.LAUNCHES_DENSIFY]


def set_march_launches(counts=(0, 0)) -> None:
    from voxelhashing_demo_tpu_torch.ops import hash_raycast
    from voxelhashing_demo_tpu_torch.ops import raycast as rc_ops

    rc_ops.LAUNCHES_MARCH, hash_raycast.LAUNCHES_DENSIFY = counts


@contextlib.contextmanager
def uncounted_march():
    """K11's and K12's launches left as they were before the block: the
    checks against the plain versions and the timings are not a path's
    launches."""
    saved = march_launches()
    try:
        yield
    finally:
        set_march_launches(saved)


def _march_work(torch, state, T_wc, rays, rc) -> dict:
    """What K11 must do on these inputs, counted by a plain replay of the
    march (the reference's arithmetic, ops/tsdf.py's sampler): the
    distinct 32-byte sectors of the cache that the samples a ray takes
    reach (a sample inside the volume, before the ray's hit or its exit
    from the volume, and the 6 gradient samples of a hit), the steps the
    rays take, and the hits."""
    from voxelhashing_demo_tpu_torch.ops import raycast as rc_ops
    from voxelhashing_demo_tpu_torch.ops.preprocess import _norm

    X, Y, Z = state.sdf.shape
    per_sector = MARCH_SECTOR_BYTES // 4
    marked = torch.zeros(X * Y * Z // per_sector + 2, dtype=torch.bool,
                         device=T_wc.device)
    dims = torch.tensor([X, Y, Z], device=T_wc.device)
    offs = torch.tensor([(dx * Y + dy) * Z + dz for dx in (0, 1)
                         for dy in (0, 1) for dz in (0, 1)],
                        device=T_wc.device)

    def mark(pos, live):
        g = (pos - state.origin) / state.voxel_size
        base = torch.floor(g).to(torch.int64)
        inside = torch.all((base >= 0) & (base + 1 <= dims - 1), dim=-1)
        use = live & inside
        b = base[use]
        flat0 = (b[:, 0] * Y + b[:, 1]) * Z + b[:, 2]
        marked[((flat0[:, None] + offs) // per_sector).reshape(-1)] = True
        return base, inside

    R, origin = T_wc[:3, :3], T_wc[:3, 3]
    dirs = rays @ R.T
    inv_len = 1.0 / _norm(dirs)
    vox = state.voxel_size
    min_step, coarse_step = rc.min_step * vox, rc.coarse_step * vox
    shape = rays.shape[:2]
    t = torch.zeros(shape, device=T_wc.device) + rc.near
    t_hit = torch.zeros_like(t)
    hit = torch.zeros(shape, dtype=torch.bool, device=T_wc.device)
    gone = torch.zeros_like(hit)
    prev_sdf, prev_t = torch.full_like(t, float("inf")), t
    steps = torch.zeros(shape, dtype=torch.int64, device=T_wc.device)
    for _ in range(rc.max_steps):
        live = ~hit & ~gone
        steps += live.to(torch.int64)
        pos = origin + dirs * t[..., None]
        base, inside = mark(pos, live)
        s, w = rc_ops.trilinear_sample(state, pos)
        known = w > 0
        crossed = known & (s <= 0) & (prev_sdf > 0)
        diff = prev_sdf - s
        denom = torch.where(torch.abs(diff) > 1e-12, diff, 1e-12)
        t_ref = prev_t + (t - prev_t) * (prev_sdf / denom)
        t_hit = torch.where(crossed & ~hit, t_ref, t_hit)
        hit = hit | crossed
        step_m = torch.where(known, torch.maximum(
            rc.step_scale * torch.abs(s), min_step), coarse_step)
        prev_sdf = torch.where(known, s, prev_sdf)
        prev_t = torch.where(known, t, prev_t)
        t = torch.where(hit, t, t + step_m * inv_len)
        away = (((base < 0) & (dirs <= 0))
                | ((base > dims - 2) & (dirs >= 0))).any(dim=-1)
        gone = gone | (~inside & ~known & away)
    hit = hit & (t_hit > rc.near) & (t_hit < rc.far)
    p = origin + dirs * t_hit[..., None]
    for axis in range(3):
        e = torch.zeros(3, device=T_wc.device)
        e[axis] = vox
        mark(p + e, hit)
        mark(p - e, hit)
    return {"sectors": int(marked.sum()), "steps": int(steps.sum()),
            "hits": int(hit.sum()), "rays": int(hit.numel())}


def _k11_bound(work: dict) -> tuple:
    n = work["rays"]
    n_bytes = (2 * work["sectors"] * MARCH_SECTOR_BYTES + n * 12
               + n * K11_OUT_BYTES + 64 + 16)
    n_ops = (work["steps"] * K11_OPS_PER_STEP
             + work["hits"] * K11_OPS_GRADIENT + n * K11_OPS_RAY)
    return _probe_bound(n_bytes, n_ops)


def _march_case(torch, probe, name, hmap, active, cfg, pose) -> dict:
    """K12 against ``densify_active_reference`` and K11 against
    ``raycast_rays_reference`` (on the plain cache) on one state, every
    field bit for bit, and ``raycast_hash`` against the plain chain."""
    from voxelhashing_demo_tpu_torch.geometry import camera as cam_geom
    from voxelhashing_demo_tpu_torch.ops import hash_raycast
    from voxelhashing_demo_tpu_torch.ops import raycast as rc_ops

    dims = cfg.raycast.cache_dims
    dargs = (hmap, active, cfg.hash, cfg.fusion, pose, dims)
    plain_cache = hash_raycast.densify_active_reference(*dargs)
    k12 = probe.compare(tuple(hash_raycast.densify_active(*dargs)),
                        tuple(plain_cache))
    rays = cam_geom.pixel_rays(cfg.camera, device=pose.device)
    plain = rc_ops.raycast_rays_reference(plain_cache, pose, rays,
                                          cfg.raycast)
    k11 = {f: probe.compare(getattr(got, f), getattr(plain, f))
           for got in [rc_ops.raycast_rays(plain_cache, pose, rays,
                                           cfg.raycast)]
           for f in got._fields}
    chain = probe.compare(tuple(hash_raycast.raycast_hash(
        hmap, active, cfg.hash, pose, cfg.camera, cfg.raycast, cfg.fusion,
        cache_dims=dims)), tuple(plain))
    return {"case": name, "count": int(active.count),
            "hit_fraction": float(plain.hit.float().mean()),
            "densify_cache": k12, "raycast_march": k11, "chain": chain,
            "bit_exact": (k12["bit_exact"] and chain["bit_exact"]
                          and all(c["bit_exact"] for c in k11.values()))}


def _march_timings(torch, probe, kernels, hmap, active, cfg, pose,
                   floor_ms: float) -> dict:
    """K11 and K12 alone on the final state (CUDA-graph replay, warm and
    L2-cold, into buffers of their own), their wrappers, their plain
    versions, their wrappers' host µs to issue a call, the bounds from
    this run's data (``_march_work``; K12: the cache written and the rows
    in it read), registers and spills."""
    from voxelhashing_demo_tpu_torch.geometry import camera as cam_geom
    from voxelhashing_demo_tpu_torch.ops import hash_raycast
    from voxelhashing_demo_tpu_torch.ops import raycast as rc_ops

    dev = pose.device
    index = dev.index
    dims = cfg.raycast.cache_dims
    X, Y, Z = dims
    B = cfg.hash.block_size
    rc = cfg.raycast
    dargs = (hmap, active, cfg.hash, cfg.fusion, pose, dims)
    cache = hash_raycast.densify_active_reference(*dargs)
    rays = cam_geom.pixel_rays(cfg.camera, device=dev)
    h, w = rays.shape[:2]
    ints, floats = hash_raycast._densify_tables(cfg.hash, cfg.fusion, dims)
    grid = torch.empty(-(-X // B) * -(-Y // B) * -(-Z // B),
                       dtype=torch.int32, device=dev)
    out_sdf = torch.empty(dims, device=dev)
    out_w = torch.empty(dims, device=dev)
    out_origin = torch.empty(3, device=dev)

    def k12_alone(blocks, ptrs, count, tsdf, weight, T):
        kernels.launch("densify_cache", index, blocks.data_ptr(),
                       ptrs.data_ptr(), count.data_ptr(), None,
                       T.data_ptr(), tsdf.data_ptr(), weight.data_ptr(),
                       grid.data_ptr(), out_sdf.data_ptr(), out_w.data_ptr(),
                       out_origin.data_ptr(), blocks.shape[0],
                       tsdf.shape[0], ints, floats)

    mints, mfloats = rc_ops._march_tables(rc, dims)
    buf = torch.empty(7 * h * w, device=dev)
    hit = torch.empty((h, w), dtype=torch.bool, device=dev)

    def k11_alone(r, T, sdf, weight, origin, vox):
        kernels.launch("raycast_march", index, r.data_ptr(), T.data_ptr(),
                       sdf.data_ptr(), weight.data_ptr(), origin.data_ptr(),
                       vox.data_ptr(), buf.data_ptr(), hit.data_ptr(), h, w,
                       mints, mfloats)

    k12 = {**probe.timings(k12_alone, (active.blocks, active.ptrs,
                                       active.count, hmap.tsdf, hmap.weight,
                                       pose)),
           "wrapper_ms": probe.host_ms(
               lambda: hash_raycast.densify_active(*dargs)),
           "issue_us": host_issue_us(
               lambda: hash_raycast.densify_active(*dargs)),
           "plain_ms": probe.host_ms(
               lambda: hash_raycast.densify_active_reference(*dargs),
               iters=10)}
    # the rows K12 reads: the walked rows with a map row whose block lies
    # in the cache
    n = int(active.count)
    ob = torch.round(cache.origin / cfg.fusion.voxel_size).to(
        torch.int64) // B
    rb = active.blocks[:n].to(torch.int64) - ob
    in_grid = torch.all((rb >= 0) & (rb < torch.tensor(
        [-(-X // B), -(-Y // B), -(-Z // B)], device=dev)), dim=-1)
    live = int(((active.ptrs[:n] != -1) & in_grid).sum())
    V = cfg.hash.voxels_per_block
    k12["bound_ms"], k12["bound_by"] = _probe_bound(
        2 * X * Y * Z * 4 + live * V * 8 + n * 16 + 76, X * Y * Z * 4)
    k12["rows_in_cache"] = live
    k11 = {**probe.timings(k11_alone, (rays, pose, *cache)),
           "wrapper_ms": probe.host_ms(
               lambda: rc_ops.raycast_rays(cache, pose, rays, rc)),
           "issue_us": host_issue_us(
               lambda: rc_ops.raycast_rays(cache, pose, rays, rc)),
           "plain_ms": probe.host_ms(
               lambda: rc_ops.raycast_rays_reference(cache, pose, rays, rc),
               iters=5)}
    work = _march_work(torch, cache, pose, rays, rc)
    k11["bound_ms"], k11["bound_by"] = _k11_bound(work)
    k11["work"] = work
    ptxas = kernels.ptxas_report("raycast")
    for k, part in ((k11, "march_kernel"), (k12, "densify")):
        k["floor_ms"] = floor_ms
        k["least_ms"] = max(k["bound_ms"], floor_ms)
        k["ptxas"] = {n: v for n, v in ptxas.items() if part in n}
        k["library_ms"] = None
    return {"raycast_march": k11, "densify_cache": k12}


MARCH_SUMMARY: dict = {}   # the march phase's K11 / K12 figures


def phase_march(torch, card, cfg, depths, gt):
    from voxelhashing_demo_tpu_torch import kernels
    from voxelhashing_demo_tpu_torch.geometry import camera as cam_geom
    from voxelhashing_demo_tpu_torch.models import hash_slam
    from voxelhashing_demo_tpu_torch.ops import hash_ops, hash_raycast
    from voxelhashing_demo_tpu_torch.tools import probe
    from voxelhashing_demo_tpu_torch.utils import (meshing, pointcloud,
                                                   synthetic)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    slam = hash_slam.HashSLAM(cfg)
    # the step's march arguments on a frame mid-run, the map copied then
    mid, calls, kept = N_MARCH // 2, [0], {}

    def keep_mid(real):
        def fn(hmap, active, *a, **k):
            if calls[0] == mid:
                kept["args"] = (probe.map_copy(hmap), hash_ops.ActiveSet(
                    *(t.clone() for t in active)), a[1].clone())
            calls[0] += 1
            return real(hmap, active, *a, **k)
        return fn

    with _wrapped(hash_raycast, "raycast_hash", keep_mid):
        frame_ms, launches = _drive(torch, slam, depths)
    per_run = march_launches()
    stats = _run_stats(slam, gt, frame_ms, launches)
    peak = int(torch.cuda.max_memory_allocated())

    out = slam.render(slam.state.pose)
    hit = float(out.hit.float().mean())
    _require(bool(torch.isfinite(out.depth).all()
                  and torch.isfinite(out.normals).all()),
             "finite render")
    st = slam.state
    active = hash_ops.compact_visible(st.hmap, cfg.hash, st.pose, cfg.camera,
                                      cfg.fusion)
    with uncounted_march():
        cases = [_march_case(torch, probe, "final", st.hmap, active, cfg,
                             st.pose)]
        eye = torch.eye(4, device=st.pose.device)
        cases.append(_march_case(
            torch, probe, "render_identity", st.hmap,
            hash_ops.compact_visible(st.hmap, cfg.hash, eye, cfg.camera,
                                     cfg.fusion), cfg, eye))
        m_map, m_active, m_pose = kept["args"]
        cases.append(_march_case(torch, probe, f"frame_{mid}", m_map,
                                 m_active, cfg, m_pose))
        stage_ms = march_stage_ms(torch, cfg, st, active)
        dims = cfg.raycast.cache_dims

        def stage():
            return hash_raycast.raycast_hash(
                st.hmap, active, cfg.hash, st.pose, cfg.camera, cfg.raycast,
                cfg.fusion, cache_dims=dims)

        stage_kernels = _device_kernels(torch, stage)
        ray_kernels = _device_kernels(torch, lambda: cam_geom.pixel_rays(
            cfg.camera, device=st.pose.device))["kernels"]
        stage_reads = sync_sites(torch, stage)
        timing = _march_timings(torch, probe, kernels, st.hmap, active, cfg,
                                st.pose, probe.launch_floor_ms())

    t0 = time.perf_counter()
    pts, normals, _ = pointcloud.extract_surface_points(
        slam.state.hmap, cfg.hash, cfg.fusion, with_normals=True)
    t1 = time.perf_counter()
    verts, faces = meshing.extract_mesh(slam.state.hmap, cfg.hash,
                                        cfg.fusion)
    t2 = time.perf_counter()
    # the map's world frame is the first camera frame; room_sdf lives in
    # the sweep's own frame
    T0 = synthetic.room_sweep_pose(0.0, 40.0).astype(np.float64)
    room_pts = pts.astype(np.float64) @ T0[:3, :3].T + T0[:3, 3]
    dist = synthetic.room_sdf(
        torch.as_tensor(room_pts, dtype=torch.float32)).abs().numpy()
    median_dist = float(np.median(dist)) if len(dist) else float("nan")
    worst = {k: max(max(c["densify_cache"]["max_abs_err"]
                        for c in cases) if k == "densify_cache" else
                    max(f["max_abs_err"] for c in cases
                        for f in c["raycast_march"].values()), 0.0)
             for k in MARCH_KERNELS}
    MARCH_SUMMARY.update({k: {"case": "march_final", **timing[k],
                              "max_abs_err": worst[k]}
                          for k in MARCH_KERNELS})
    _emit({
        "phase": "march", "card": card, "H": H, "W": W, **stats,
        "hit_frac": hit, "stage_ms": stage_ms,
        "frame_ms_p50_less_march":
            stats["frame_ms_p50"] - stage_ms["densify_and_march"],
        "march_launches_run": dict(zip(MARCH_KERNELS, per_run)),
        "stage_device_kernels": stage_kernels,
        "pixel_ray_kernels": ray_kernels,
        "stage_host_reads": stage_reads,
        "checks": cases, "kernels": timing,
        "peak_mem_bytes": peak,
        "points": int(len(pts)), "vertices": int(len(verts)),
        "faces": int(len(faces)),
        "points_median_dist_m": median_dist,
        "extract_points_s": t1 - t0, "extract_mesh_s": t2 - t1,
        "jax_reference": JAX_REFERENCE_MARCH,
    })
    _check_run(stats, hit, 2.0 * JAX_REFERENCE_MARCH["ate_mm"],
               JAX_REFERENCE_MARCH["hit_frac"] - 0.1)
    _require(len(pts) > 0 and len(verts) > 0 and len(faces) > 0,
             "non-empty point cloud and mesh")
    _require(bool(np.isfinite(pts).all() and np.isfinite(normals).all()
                  and np.isfinite(verts).all()),
             "finite points, normals and vertices")
    _require(len(verts) == 3 * len(faces), "triangle soup: V == 3 F")
    _require(median_dist < 3 * cfg.fusion.voxel_size,
             "median point distance to the room's surface < 3 voxels")
    for c in cases:
        _require(c["bit_exact"], f"K12 and K11 == their plain versions bit "
                                 f"for bit, every field ({c['case']})")
    _require(per_run == [len(depths), len(depths)],
             "one K11 and one K12 launch a march frame")
    _require(not stage_reads, "the march stage reads nothing on the host")
    _require(stage_kernels["kernels"] <= ray_kernels + 3,
             "the march stage on the card runs at most the pixel rays' "
             "kernels, K12's two device kernels and K11's one")
    return slam, depths[-1], stats["kernel_launches"]


def phase_streamed_entry(torch, wg, slam, depth_raw):
    """The streamed gather through its public entry point, on the gather
    inputs the frame step itself produces at the march run's final state.
    Its result must equal the first kernel's on the same inputs."""
    args = gather_inputs(slam, depth_raw)
    wg.LAUNCHES_STREAMED = 0
    calls = 4
    for _ in range(calls):
        got, got_cov = wg.gather_depth_window_streamed(*args)
    torch.cuda.synchronize()
    launches = wg.LAUNCHES_STREAMED
    ref, ref_cov = wg.gather_depth_window(*args)
    plain, plain_cov = wg.gather_depth_window_streamed_reference(*args)
    torch.cuda.synchronize()
    same = bool(torch.equal(got, ref) and torch.equal(got_cov, ref_cov)
                and torch.equal(got, plain)
                and torch.equal(got_cov, plain_cov))
    _emit({"phase": "streamed_entry", "rows": int(args[1].shape[0]),
           "calls": calls, "launches": launches,
           "covered": int(got_cov.sum()),
           "equals_first_kernel_and_plain": same})
    _require(launches == calls, "one streamed launch per call")
    _require(same, "streamed entry point == first kernel == plain version")
    return launches


# The dense pipeline (BASELINE config 1): DenseSLAM on the slice's orbit
# with the fusion and raycast settings of tests/test_dense_pipeline.py and
# its grid (config 1's default 128^3 cube at (-1.28, -1.28, 0) does not
# hold that scene); K20 (csrc/dense.cu) fuses, K11 raycasts the model.
DENSE_KERNELS = ("integrate_dense",)
DENSE_SOURCE = "voxelhashing_demo_tpu_torch/csrc/dense.cu"
DENSE_META = {
    "integrate_dense": {
        "route": "cuda", "source": DENSE_SOURCE,
        "replaces": "voxelhashing_demo_tpu/ops/tsdf.py:80 "
                    "(integrate_dense, with voxel_world_positions :53 and "
                    "sample_weight :63): fused by XLA, no Pallas kernel",
    },
}
N_DENSE = 20                  # the whole orbit of JAX_REFERENCE
DENSE_DIMS, DENSE_ORIGIN = (160, 128, 160), (-1.6, -0.7, 0.0)
# The JAX DenseSLAM on the CPU on the same 20 frames at the same
# configuration (tests/torch_port_reference.py dense): accuracy
# references, not speeds.
JAX_REFERENCE_DENSE = {"frames": 20, "tracked": 19,
                       "ate_mm": 1.1225891066715121,
                       "hit_frac": 0.7464811197916666}
# K20's second timing case: a 512^3 volume over a 3 m cube (5.86 mm
# voxels, 1.07 GB of state) in front of the room sweep's first camera,
# fused from its first two frames
DENSE_BIG, DENSE_BIG_EDGE_M = 512, 3.0
DENSE_BIG_ORIGIN = (-1.5, -1.5, 0.0)
# device kernels a dense step may run: K3a, K3b's pack, K4, K20, K11, the
# pixel rays and the pose glue (the tracking gate, the motion test, the
# pose product)
DENSE_STEP_KERNELS_MAX = 64
# float operations K20 does: every voxel (its centre, the transform, the
# projection and its tests), and a voxel in view besides (the pixel, the
# sdf, the band, the weight and the update)
K20_OPS_VOXEL, K20_OPS_VIEW = 30, 20
K20_BYTES_VOXEL = 16          # sdf and weight, each read and written
DEPTH_SECTOR_BYTES = 32

DENSE_SUMMARY: dict = {}      # the dense phase's K20 figures


def dense_launches() -> list:
    """[K20] launches counted since they were last set to 0."""
    from voxelhashing_demo_tpu_torch.ops import tsdf

    return [tsdf.LAUNCHES_DENSE]


def set_dense_launches(counts=(0,)) -> None:
    from voxelhashing_demo_tpu_torch.ops import tsdf

    (tsdf.LAUNCHES_DENSE,) = counts


@contextlib.contextmanager
def uncounted_dense():
    """Every launch count a dense step moves (K3a, K3b, K4, K4s, K11,
    K12, K20) left as it was before the block: the checks against the
    plain versions and the timings are not the path's launches."""
    from voxelhashing_demo_tpu_torch.ops import icp
    from voxelhashing_demo_tpu_torch.ops import preprocess as pre

    saved = (icp_launches(), k3_launches(), march_launches(),
             dense_launches())
    try:
        yield
    finally:
        icp.LAUNCHES_LEVEL, icp.LAUNCHES_SUMS = saved[0]
        pre.LAUNCHES_FRAME, pre.LAUNCHES_LEVELS = saved[1]
        set_march_launches(saved[2])
        set_dense_launches(saved[3])


def dense_config():
    """The dense phase's PipelineConfig: the default camera, frontend and
    ICP (one level, 20 iterations), 2 cm voxels, truncation 0.08,
    max_steps 128 and the 160 x 128 x 160 grid
    (tests/torch_port_reference.py ``dense_config`` in the JAX types)."""
    from voxelhashing_demo_tpu_torch.config import (DenseGridConfig,
                                                    FusionConfig,
                                                    PipelineConfig,
                                                    RaycastConfig)

    return PipelineConfig(
        fusion=FusionConfig(voxel_size=0.02, truncation=0.08),
        grid=DenseGridConfig(dims=DENSE_DIMS, origin=DENSE_ORIGIN),
        raycast=RaycastConfig(max_steps=128))


def _k20_work(torch, state, depth_m, T_wc, cam) -> dict:
    """What K20 must do on these inputs, counted by the plain projection:
    the voxels, those inside the image (they read the depth), and the
    distinct 32-byte sectors of the depth image they read."""
    from voxelhashing_demo_tpu_torch.geometry import camera as cam_geom
    from voxelhashing_demo_tpu_torch.geometry import se3
    from voxelhashing_demo_tpu_torch.ops import tsdf

    pc = se3.apply(se3.inverse(T_wc), tsdf.voxel_world_positions(state))
    ij, in_img = cam_geom.project_nearest(pc, cam)
    del pc
    pix = (ij[..., 1].to(torch.int64) * cam.width + ij[..., 0])[in_img]
    per = DEPTH_SECTOR_BYTES // 4
    return {"voxels": int(state.sdf.numel()), "in_view": int(in_img.sum()),
            "depth_sectors": int(torch.unique(pix // per).numel())}


def _k20_bound(work: dict) -> tuple:
    n_bytes = (work["voxels"] * K20_BYTES_VOXEL
               + work["depth_sectors"] * DEPTH_SECTOR_BYTES + 64 + 16)
    n_ops = work["voxels"] * K20_OPS_VOXEL + work["in_view"] * K20_OPS_VIEW
    return _probe_bound(n_bytes, n_ops)


def _k20_case(torch, probe, kernels, name, state, depth_m, T_wc, cam,
              fusion, floor_ms: float, timed: bool = True) -> tuple:
    """(figures, K20's volume): K20 against ``integrate_dense_reference``
    bit for bit on one input (sdf and weight; the inputs unchanged); then,
    ``timed``, K20 alone warm and L2-cold (CUDA-graph replay into buffers
    of its own), its wrapper, its host µs to issue a call, its plain
    version and the bound from this input's data (``_k20_work``)."""
    from voxelhashing_demo_tpu_torch.ops import tsdf

    before = (state.sdf.clone(), state.weight.clone())
    got = tsdf.integrate_dense(state, depth_m, T_wc, cam, fusion)
    plain = tsdf.integrate_dense_reference(state, depth_m, T_wc, cam,
                                           fusion)
    cmp = probe.compare((got.sdf, got.weight), (plain.sdf, plain.weight))
    untouched = bool(torch.equal(before[0], state.sdf)
                     and torch.equal(before[1], state.weight))
    del before, plain
    out = {"case": name, "dims": list(state.sdf.shape),
           "voxel_size": float(state.voxel_size),
           "observed": int((got.weight > 0).sum()),
           **cmp, "inputs_untouched": untouched}
    if not timed:
        return out, got
    index = T_wc.device.index
    ints, floats = tsdf._dense_tables(cam, fusion, tuple(state.sdf.shape))
    o_sdf, o_w = torch.empty_like(state.sdf), torch.empty_like(state.weight)

    def k20_alone(sdf, weight, d, T, origin, vox):
        kernels.launch("integrate_dense", index, sdf.data_ptr(),
                       weight.data_ptr(), d.data_ptr(), T.data_ptr(),
                       origin.data_ptr(), vox.data_ptr(), o_sdf.data_ptr(),
                       o_w.data_ptr(), ints, floats)

    args = (state.sdf, state.weight, depth_m, T_wc, state.origin,
            state.voxel_size)
    out.update(probe.timings(k20_alone, args))

    def wrapper():
        return tsdf.integrate_dense(state, depth_m, T_wc, cam, fusion)

    out["wrapper_ms"] = probe.host_ms(wrapper)
    out["issue_us"] = host_issue_us(wrapper)
    out["plain_ms"] = probe.host_ms(
        lambda: tsdf.integrate_dense_reference(state, depth_m, T_wc, cam,
                                               fusion), iters=5)
    work = _k20_work(torch, state, depth_m, T_wc, cam)
    out["bound_ms"], out["bound_by"] = _k20_bound(work)
    out["work"] = work
    out["floor_ms"] = floor_ms
    out["least_ms"] = max(out["bound_ms"], floor_ms)
    out["library_ms"] = None
    return out, got


def _dense_frame_checks(torch, probe, icp, pre, rc_ops, tsdf, dense_slam,
                        cfg, name, state, depth) -> dict:
    """One dense step's kernels against their plain versions on a state
    kept from the run: K3b's pack of the model against ``pack_target``,
    K4 against the plain loop, K20 against ``integrate_dense_reference``
    and K11 against ``raycast_rays_reference`` on the fused volume, all
    bit for bit but K4 (transform 1e-5, equal iterations or a tie at
    tol2); and the step itself: its host reads, its device kernels, their
    busy µs and the six costliest by name, and its ms (CUDA events)."""
    from voxelhashing_demo_tpu_torch.geometry import camera as cam_geom

    cam = cfg.camera
    frame = pre.preprocess(depth, cam, cfg.frontend)
    packed = pre.pack_model(state.model, cam)
    pack = probe.compare(packed, icp.pack_target(state.model))
    got = icp.icp_align(frame, None, cam, cfg.icp, tgt_packed=packed)
    loop = _loop_vs_plain(torch, icp, frame, state.model, cam, cfg.icp,
                          None, got)
    new_state, info = dense_slam.step(state, depth, cfg)
    k20 = probe.compare(tuple(new_state.tsdf[:2]), tuple(
        tsdf.integrate_dense_reference(state.tsdf, frame.depth, info.pose,
                                       cam, cfg.fusion)[:2]))
    rays = cam_geom.pixel_rays(cam, device=depth.device)
    plain = rc_ops.raycast_rays_reference(new_state.tsdf, info.pose, rays,
                                          cfg.raycast)
    k11 = probe.compare(tuple(rc_ops.raycast_dense(
        new_state.tsdf, info.pose, cam, cfg.raycast, cfg.fusion)),
        tuple(plain))
    model = probe.compare(tuple(new_state.model),
                          (plain.points, plain.normals, plain.depth))

    def step():
        return dense_slam.step(state, depth, cfg)

    reads = sync_sites(torch, step)
    events = _cuda_events(torch, step)
    kern = {"kernels": len(events),
            "busy_us": sum(e.time_range.elapsed_us() for e in events)}
    by_name = {}
    for e in events:
        kname = e.name[:60]
        by_name[kname] = by_name.get(kname, 0.0) + e.time_range.elapsed_us()
    kern["top_us"] = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:6])
    ms = median_ms(torch, step)
    return {"case": name, "pack": pack, "icp": loop, "integrate_dense": k20,
            "raycast_march": k11, "model": model,
            "hit_fraction": float(plain.hit.float().mean()),
            "step_host_reads": reads, "step_device_kernels": kern,
            "step_ms": ms,
            "step_idle_share": 1.0 - kern["busy_us"] / (ms * 1e3),
            "bit_exact": (pack["bit_exact"] and k20["bit_exact"]
                          and k11["bit_exact"] and model["bit_exact"])}


def phase_dense(torch, card: str, sweep, sweep_gt) -> None:
    """DenseSLAM (BASELINE config 1) on the card over the orbit, its
    kernels against their plain versions on states of the run, and K20's
    timings on the run's grid and on a 512^3 volume."""
    from voxelhashing_demo_tpu_torch import kernels
    from voxelhashing_demo_tpu_torch.geometry import camera as cam_geom
    from voxelhashing_demo_tpu_torch.models import dense_slam
    from voxelhashing_demo_tpu_torch.models.hash_slam import depth_tensor
    from voxelhashing_demo_tpu_torch.ops import icp
    from voxelhashing_demo_tpu_torch.ops import preprocess as pre
    from voxelhashing_demo_tpu_torch.ops import raycast as rc_ops
    from voxelhashing_demo_tpu_torch.ops import tsdf
    from voxelhashing_demo_tpu_torch.tools import probe
    from voxelhashing_demo_tpu_torch.utils import metrics, synthetic

    cfg = dense_config()
    cam = cfg.camera
    depths, gt = synthetic.make_sequence(cam, N_DENSE, trans_amp=0.05,
                                         rot_amp_deg=2.5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    slam = dense_slam.DenseSLAM(cfg)
    # the step's inputs mid-run and at the last frame (the state is never
    # written in place, so keeping it is enough)
    keep, calls, kept = (N_DENSE // 2, N_DENSE - 1), [0], {}

    def keep_steps(real):
        def fn(state, depth_raw, config):
            if calls[0] in keep:
                kept[calls[0]] = (state, depth_raw)
            calls[0] += 1
            return real(state, depth_raw, config)
        return fn

    frame_ms = []
    with _wrapped(dense_slam, "step", keep_steps):
        for d in depths:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            slam.process(d)
            end.record()
            torch.cuda.synchronize()
            frame_ms.append(start.elapsed_time(end))
    poses = [p.cpu().numpy() for p in slam.trajectory]
    stats = {"frames": len(poses),
             "tracked": sum(bool(i.tracked) for i in slam.infos),
             "tracked_flags": [bool(i.tracked) for i in slam.infos],
             "finite_poses": all(np.isfinite(p).all() for p in poses),
             "ate_mm": metrics.ate_rmse(poses, gt, align=False) * 1e3,
             "frame_ms_p50": float(np.percentile(frame_ms, 50)),
             "frame_ms_max": float(np.max(frame_ms)),
             "frame_ms": frame_ms}
    out = slam.render()
    per_run = dense_launches() + march_launches()[:1]
    hit = float(out.hit.float().mean())
    finite = bool(torch.isfinite(out.depth).all()
                  and torch.isfinite(out.points).all()
                  and torch.isfinite(out.normals).all())
    peak = int(torch.cuda.max_memory_allocated())

    floor_ms = probe.launch_floor_ms()
    with uncounted_dense():
        frames = [_dense_frame_checks(
            torch, probe, icp, pre, rc_ops, tsdf, dense_slam, cfg,
            f"frame_{k}", *kept[k]) for k in keep]
        st = slam.state
        # K20 on the final volume with the last frame's depth and pose
        # again, and K11 on the final state (the render)
        last_depth = pre.preprocess(kept[N_DENSE - 1][1], cam,
                                    cfg.frontend).depth
        grid_case = _k20_case(torch, probe, kernels, "grid_final", st.tsdf,
                              last_depth, st.pose, cam, cfg.fusion,
                              floor_ms)[0]
        render = probe.compare(tuple(out), tuple(
            rc_ops.raycast_rays_reference(
                st.tsdf, st.pose, cam_geom.pixel_rays(cam, device="cuda"),
                cfg.raycast)))
        # the 512^3 volume, fused from the room sweep's first two frames
        # (poses relative to the first)
        big_state = tsdf.DenseTSDF(
            sdf=torch.full((DENSE_BIG,) * 3, cfg.fusion.truncation,
                           device="cuda"),
            weight=torch.zeros((DENSE_BIG,) * 3, device="cuda"),
            origin=torch.tensor(DENSE_BIG_ORIGIN, device="cuda"),
            voxel_size=torch.tensor(DENSE_BIG_EDGE_M / DENSE_BIG,
                                    device="cuda"))
        g0 = np.linalg.inv(sweep_gt[0])
        big_in = [(pre.preprocess(depth_tensor(sweep[k], "cuda"), cam,
                                  cfg.frontend).depth,
                   torch.as_tensor(g0 @ sweep_gt[k], dtype=torch.float32,
                                   device="cuda")) for k in (0, 1)]
        big_first, big_state = _k20_case(
            torch, probe, kernels, "big_first", big_state, *big_in[0], cam,
            cfg.fusion, floor_ms, timed=False)
        big_case = _k20_case(torch, probe, kernels, f"big_{DENSE_BIG}",
                             big_state, *big_in[1], cam, cfg.fusion,
                             floor_ms)[0]
        del big_state
        torch.cuda.empty_cache()
        ptxas = kernels.ptxas_report("dense")
    for c in (grid_case, big_case):
        c["ptxas"] = ptxas
    worst = max([c["max_abs_err"] for c in (grid_case, big_first, big_case)]
                + [f["integrate_dense"]["max_abs_err"] for f in frames])
    DENSE_SUMMARY["integrate_dense"] = {
        **grid_case, "max_abs_err": worst,
        "cases": {big_case["case"]: big_case, "big_first": big_first}}
    _emit({"phase": "dense", "card": card, "H": cam.height, "W": cam.width,
           "dims": list(DENSE_DIMS), "origin": list(DENSE_ORIGIN),
           **stats, "hit_frac": hit, "finite_render": finite,
           "render_vs_plain": render, "launches_run": dict(zip(
               ("integrate_dense", "raycast_march"), per_run)),
           "checks": frames, "kernels": {"integrate_dense": grid_case,
                                         big_case["case"]: big_case,
                                         "big_first": big_first},
           "peak_mem_bytes": peak, "jax_reference": JAX_REFERENCE_DENSE,
           "step_kernels_max": DENSE_STEP_KERNELS_MAX})
    n = stats["frames"]
    _require(stats["tracked_flags"] == [False] + [True] * (n - 1),
             "dense: every frame but frame 0 tracked")
    _require(stats["finite_poses"], "dense: finite poses")
    ate_bound = 2.0 * JAX_REFERENCE_DENSE["ate_mm"]
    _require(stats["ate_mm"] < ate_bound,
             f"dense: unaligned ATE < {ate_bound} mm (2 x JAX)")
    hit_bound = JAX_REFERENCE_DENSE["hit_frac"] - 0.1
    _require(hit > hit_bound, f"dense: render hit fraction > {hit_bound}")
    _require(finite, "dense: finite render")
    _require(render["bit_exact"], "dense: the render (K11) == "
                                  "raycast_rays_reference bit for bit")
    for c in (grid_case, big_first, big_case):
        _require(c["bit_exact"] and c["inputs_untouched"],
                 f"K20 == integrate_dense_reference bit for bit, inputs "
                 f"untouched ({c['case']})")
    for f in frames:
        _require(f["bit_exact"], f"dense: K3b's pack, K20, K11 and the "
                                 f"model == their plain versions bit for "
                                 f"bit ({f['case']})")
        lp = f["icp"]
        _require(lp["transform_max_abs_err"] <= ICP_T_ATOL
                 and (lp["iters"] == lp["iters_plain"]
                      or lp.get("tie", {}).get("ok", False)),
                 f"dense: K4 == the plain loop (transform 1e-5, equal "
                 f"iterations or a tie at tol2; {f['case']})")
        _require(not f["step_host_reads"],
                 f"dense: a step reads nothing on the host ({f['case']})")
        _require(f["step_device_kernels"]["kernels"]
                 <= DENSE_STEP_KERNELS_MAX,
                 f"dense: a step runs at most {DENSE_STEP_KERNELS_MAX} "
                 f"device kernels ({f['case']})")
    _require(per_run == [n, n + 1],
             "dense: one K20 launch a frame, one K11 a frame and the "
             "render")


def backend_config():
    """flagship_gather_config() with the backend phase's keyframe
    settings."""
    from voxelhashing_demo_tpu_torch.config import (KeyframeConfig,
                                                    flagship_gather_config)

    return dataclasses.replace(
        flagship_gather_config(),
        keyframes=KeyframeConfig(**BACKEND_KEYFRAMES))


def backend_drive(torch, slam, depths, on_frame=None):
    """Run the backend scenario's frames through ``slam`` (a HashSLAM or a
    KeyframeSLAM), left-multiplying the live pose by each injected drift
    just before its frame.  Returns the per-frame host times (ms)."""
    from voxelhashing_demo_tpu_torch.geometry import se3

    frame_ms = []
    for i, d in enumerate(depths):
        if i in BACKEND_INJECT:
            tw = np.array(BACKEND_INJECT[i], np.float32)
            tw[3:] = np.deg2rad(tw[3:])
            D = se3.exp(torch.as_tensor(tw, device=slam.device))
            slam.state = slam.state._replace(pose=D @ slam.state.pose)
        t0 = time.perf_counter()
        slam.process(d)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    return frame_ms


def sync_sites(torch, fn) -> dict:
    """Host synchronisations (blocking device-to-host reads, ``item()``,
    boolean-mask indexing) that one call of ``fn`` makes, from PyTorch's
    own sync-debug warnings: ``{"file:line": count}`` of the Python lines
    that were running, most frequent first."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sites = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            site = f"{os.path.basename(w.filename)}:{w.lineno}"
            sites[site] = sites.get(site, 0) + 1
    return dict(sorted(sites.items(), key=lambda kv: -kv[1]))


def count_syncs(torch, fn) -> int:
    """The number of host synchronisations one call of ``fn`` makes."""
    return sum(sync_sites(torch, fn).values())


def ring_graph(torch, real: int, cap: int, seed: int, chords: bool, device):
    """Seeded ring pose graph: ``real`` poses on a circle in a graph of
    capacity ``cap``; initial estimates integrate noisy odometry, the
    edges measure the truth (odometry chain, the ring closure and, with
    ``chords``, a chord every 16 poses)."""
    from voxelhashing_demo_tpu_torch.geometry import se3
    from voxelhashing_demo_tpu_torch.ops import pose_graph

    rng = np.random.RandomState(seed)
    ang = 2 * np.pi * np.arange(real) / real
    xi = np.zeros((real, 6), np.float32)
    xi[:, 0], xi[:, 2], xi[:, 4] = np.cos(ang), np.sin(ang), ang
    gt = se3.exp(torch.from_numpy(xi)).numpy().astype(np.float64)

    def rel(i, j):
        return (np.linalg.inv(gt[i]) @ gt[j]).astype(np.float32)

    noise = np.concatenate([rng.normal(0, 0.01, (real - 1, 3)),
                            rng.normal(0, 0.005, (real - 1, 3))],
                           axis=1).astype(np.float32)
    steps = se3.exp(torch.from_numpy(noise)).numpy()
    est = [gt[0].astype(np.float32)]
    for i in range(real - 1):
        est.append((est[-1] @ rel(i, i + 1) @ steps[i]).astype(np.float32))
    graph = pose_graph.create(cap, 2 * cap, device=device)
    for T in est:
        graph = pose_graph.add_pose(graph, T)
    pairs = [(i, i + 1) for i in range(real - 1)] + [(real - 1, 0)]
    if chords:
        pairs += [(i, i + real // 2)
                  for i in range(0, real - real // 2, 16)]
    for i, j in pairs:
        graph = pose_graph.add_edge(graph, i, j, rel(i, j))
    return graph


PG_KERNELS = ("pg_edge_blocks", "pg_cg_solve", "pg_retract")
PG_SUMMARY: dict = {}   # the backend phase's K13 figures, for the kernels line
# K13 launches of each ring graph's first ``optimize`` (``backend_ba_*``
# paths) and the path whose count is each kernel's ``launches``
PG_RING_PATHS: dict = {}
PG_MAIN_PATH = {"pg_edge_blocks": "backend",
                "pg_cg_solve": "backend_ba_K512_cg", "pg_retract": "backend"}
PG_SOURCE = "voxelhashing_demo_tpu_torch/csrc/pose_graph.cu"
PG_META = {
    "pg_edge_blocks": {
        "route": "cuda", "source": PG_SOURCE,
        "replaces": "voxelhashing_demo_tpu/ops/pose_graph.py:237 "
                    "(_edge_blocks), voxelhashing_demo_tpu/ops/"
                    "pose_graph.py:194 (build_normal_equations), "
                    "voxelhashing_demo_tpu/ops/pose_graph.py:189 (_chi2): "
                    "fused by XLA, no Pallas kernel",
    },
    "pg_cg_solve": {
        "route": "cuda", "source": PG_SOURCE,
        "replaces": "voxelhashing_demo_tpu/ops/pose_graph.py:292 "
                    "(solve_delta_cg, its while_loop :379): fused by XLA, "
                    "no Pallas kernel",
    },
    "pg_retract": {
        "route": "cuda", "source": PG_SOURCE,
        "replaces": "voxelhashing_demo_tpu/ops/pose_graph.py:383 "
                    "(apply_update's guard and retract): fused by XLA, no "
                    "Pallas kernel",
    },
}
# each C function's kernels in ptxas' report (mangled names)
PG_PTXAS = {"pg_edge_blocks": ("edge_kernel", "assemble_kernel"),
            "pg_cg_solve": ("cg_kernel",), "pg_retract": ("retract_kernel",)}
PG_RTOL = 1e-6        # K13a-c against their plain versions, of each
                      # tensor's largest magnitude (bit for bit where the
                      # orders agree)
PG_POSE_ATOL = 1e-5   # optimize on the card against optimize_reference
PG_REPS = 20          # queued launches a warm time
PG_COLD_REPS = 5      # launches a cold time, L2 flushed before each
PG_SLEEP_CYCLES = 40_000_000   # ~20 ms of sleep kernel ahead of a queue
# paths that run a BA event (K13a and K13b or K13c must launch) and paths
# that run none (no K13 launch)
BA_PATHS = ("backend", "stream_backend", "cli", "bench")
NO_BA_PATHS = ("parity", "slice", "march", "dense", "stream", "entry",
               "roofline")
# float operations: an edge with its Jacobian (the value path ~250, twelve
# tangents ~330 each, 120 six-term sums), one without (chi2 mode); a CG
# iteration per edge (two 6x6 matvecs each side) and per pose (update,
# two triangular solves, three dots); a retract per pose
PG_EDGE_OPS, PG_CHI2_OPS = 5700, 260
PG_CG_EDGE_OPS, PG_CG_POSE_OPS = 300, 180
PG_RETRACT_OPS = 150
FP32_FLOPS = 67e12    # H100 SXM float32 outside the tensor cores


def pg_launches() -> list:
    """[K13a, K13b, K13c] launches counted since they were last set."""
    from voxelhashing_demo_tpu_torch.ops import pose_graph

    return [pose_graph.LAUNCHES_EDGE_BLOCKS, pose_graph.LAUNCHES_CG,
            pose_graph.LAUNCHES_RETRACT]


def set_pg_launches(counts=(0, 0, 0)) -> None:
    from voxelhashing_demo_tpu_torch.ops import pose_graph

    (pose_graph.LAUNCHES_EDGE_BLOCKS, pose_graph.LAUNCHES_CG,
     pose_graph.LAUNCHES_RETRACT) = counts


def _pg_err(got, plain) -> dict:
    """max |got - plain|, over the plain tensor's largest magnitude (at
    least 1), and whether the two are equal as values."""
    got, plain = got.float(), plain.float()
    err = float((got - plain).abs().max())
    scale = max(1.0, float(plain.abs().max()))
    return {"max_abs_err": err, "rel_err": err / scale,
            "bit_exact": bool(got.equal(plain))}


def _queued_ms(torch, fn, reps: int = PG_REPS) -> float:
    """Device ms a call of ``fn``: ``reps`` calls queued behind a sleep
    kernel, so they run back to back, CUDA events around them."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(PG_SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _cold_ms(torch, fn, flush, reps: int = PG_COLD_REPS) -> float:
    """Median device ms of one call of ``fn`` after ``flush`` has written
    more than the L2 cache, queued behind a sleep kernel."""
    times = []
    for _ in range(reps):
        flush.add_(1.0)
        torch.cuda._sleep(PG_SLEEP_CYCLES // 4)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _pg_bound(n_bytes: float, n_ops: float) -> dict:
    b, o = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / FP32_FLOPS * 1e3
    return {"bytes": n_bytes, "ops": n_ops, "bound_ms": max(b, o),
            "bound_by": "bytes" if b >= o else "operations"}


def returns_before_device(torch, fn) -> bool:
    """``fn`` returns while a ~100 ms sleep kernel queued ahead of it still
    runs: it waited on nothing the card does."""
    torch.cuda.synchronize()
    torch.cuda._sleep(10 * PG_SLEEP_CYCLES)
    fn()
    busy = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    return busy


def pg_case(torch, name: str, graph, kcfg, floor_ms: float,
            barrier_ms: dict) -> dict:
    """K13a, K13b and K13c on ``graph`` under ``kcfg`` against their plain
    versions on the card (gnc_delta's first width), their times (warm
    queued, L2-cold, plain, host µs to issue), bounds and least times;
    the library's factor + solve of the same dense system; then
    ``optimize`` against ``optimize_reference`` on the card, two runs, its
    host syncs and whether it returns before the card is done."""
    from voxelhashing_demo_tpu_torch.ops import pose_graph as pg

    K, E = graph.poses.shape[0], graph.edges_ij.shape[0]
    use_cg = kcfg.ba_solver == "cg" or (kcfg.ba_solver == "auto"
                                        and K > kcfg.ba_dense_max_k)
    delta, kern = pg.gnc_delta(kcfg, 0), kcfg.ba_robust_kernel
    flush = torch.zeros(64 << 20, dtype=torch.float32, device="cuda")
    out = {"K": K, "E": E, "solver": "cg" if use_cg else "dense"}

    # K13a: the step's mode, and the CG operands and chi2 of every graph
    k13a = {}
    for mode, kw in (("dense", dict(diag=True, damping=kcfg.ba_damping)),
                     ("cg", dict(damping=kcfg.ba_damping)),
                     ("chi2", {})):
        args = (graph, mode) + ((delta, kern) if mode != "chi2" else ())
        got = pg.edge_system(*args, **kw)
        plain = pg.edge_system_reference(*args, **kw)
        errs = {"r": _pg_err(got.r, plain.r),
                "chi2": _pg_err(got.chi2, plain.chi2)}
        if mode != "chi2":
            errs.update(J=_pg_err(got.J, plain.J),
                        rows=_pg_err(got.rows[:, :122], plain.rows[:, :122]),
                        b=_pg_err(got.b, plain.b), H=_pg_err(got.H, plain.H))
        jac = mode != "chi2"
        n_bytes = (K * 64 + E * 76 + E * 512 + E * (312 if jac else 24)
                   + (K * 24 + 4 if jac else 4)
                   + {"dense": 144 * K * K, "cg": 144 * K, "chi2": 0}[mode]
                   + (8 * K * -(-E // 32) if jac else 0))
        case = {"errors": errs,
                "ms": _queued_ms(torch, lambda: pg.edge_system(*args, **kw)),
                "cold_ms": _cold_ms(torch, lambda: pg.edge_system(*args,
                                                                  **kw),
                                    flush),
                "plain_ms": median_ms(torch, lambda: pg.edge_system_reference(
                    *args, **kw)),
                "issue_us": host_issue_us(lambda: pg.edge_system(*args,
                                                                 **kw)),
                **_pg_bound(n_bytes, E * (PG_EDGE_OPS if jac else PG_CHI2_OPS))}
        case["least_ms"] = max(case["bound_ms"], 2 * floor_ms)
        k13a[mode] = case
    out["pg_edge_blocks"] = k13a

    # K13b on the CG operands
    s = pg.edge_system(graph, "cg", delta, kern, damping=kcfg.ba_damping)
    got = pg.cg_solve(s, graph, kcfg)
    plain = pg.cg_reference(s, graph, kcfg)
    iters = int(got[2])
    ctas = -(-K // 8)              # a warp a pose (K <= 3 168 on an H100)
    if ctas not in barrier_ms:
        from voxelhashing_demo_tpu_torch import kernels
        barrier_ms[ctas] = barrier_floor_ms(torch, kernels, ctas)
    k13b = {"errors": {"poses": _pg_err(got[0], plain[0]),
                       "delta": _pg_err(got[1], plain[1])},
            "iterations": iters, "iterations_plain": int(plain[2]),
            "ms": _queued_ms(torch, lambda: pg.cg_solve(s, graph, kcfg)),
            "cold_ms": _cold_ms(torch, lambda: pg.cg_solve(s, graph, kcfg),
                                flush),
            "plain_ms": median_ms(torch, lambda: pg.cg_reference(s, graph,
                                                                kcfg)),
            "issue_us": host_issue_us(lambda: pg.cg_solve(s, graph, kcfg)),
            "ctas": ctas, "barriers": 2 * iters + 2,
            **_pg_bound(E * 520 + K * (144 + 24 + 64 + 64 + 24)
                     + 8 * K * -(-E // 32),
                     iters * (E * PG_CG_EDGE_OPS + K * PG_CG_POSE_OPS))}
    k13b["least_ms"] = max(k13b["bound_ms"], floor_ms + k13b["barriers"]
                           * barrier_ms[ctas])
    out["pg_cg_solve"] = k13b

    # K13c on the dense step of the same graph; the library's factor and
    # solve timed beside it
    sd = pg.edge_system(graph, "dense", delta, kern, diag=True,
                        damping=kcfg.ba_damping)

    def factor_solve():
        L, info = torch.linalg.cholesky_ex(sd.H)
        return torch.cholesky_solve(-sd.b.reshape(-1, 1), L)[:, 0], info

    dl, info = factor_solve()
    dl = dl.contiguous()
    got = pg.retract(dl, info, graph.poses)
    plain = pg.retract_reference(dl, info, graph.poses)
    k13c = {"errors": {"poses": _pg_err(got[0], plain[0]),
                       "delta": _pg_err(got[1], plain[1])},
            "info": int(info),
            "ms": _queued_ms(torch, lambda: pg.retract(dl, info,
                                                        graph.poses)),
            "cold_ms": _cold_ms(torch, lambda: pg.retract(dl, info,
                                                          graph.poses),
                                flush),
            "plain_ms": median_ms(torch, lambda: pg.retract_reference(
                dl, info, graph.poses)),
            "issue_us": host_issue_us(lambda: pg.retract(dl, info,
                                                         graph.poses)),
            "cusolver_ms": _queued_ms(torch, factor_solve, reps=5),
            **_pg_bound(K * (24 + 64 + 64 + 24) + 4, K * PG_RETRACT_OPS)}
    k13c["least_ms"] = max(k13c["bound_ms"], floor_ms)
    k13a["dense"]["cusolver_ms"] = k13c["cusolver_ms"]
    out["pg_retract"] = k13c

    # optimize against the plain versions on the card
    a, info_a = pg.optimize(graph, kcfg)
    b, _ = pg.optimize(graph, kcfg)
    ref, info_r = pg.optimize_reference(graph, kcfg)
    torch.cuda.synchronize()
    out["optimize"] = {
        "ba_iters": kcfg.ba_iters,
        "max_pose_diff_vs_plain": float((a.poses - ref.poses).abs().max()),
        "two_runs_equal_bits": bool(torch.equal(a.poses, b.poses)),
        "chi2": [float(info_a.chi2_initial), float(info_a.chi2_final)],
        "chi2_plain": float(info_r.chi2_final),
        "ms": median_ms(torch, lambda: pg.optimize(graph, kcfg), reps=5),
        "plain_ms": median_ms(torch, lambda: pg.optimize_reference(
            graph, kcfg), reps=1),
        "host_syncs": count_syncs(torch, lambda: pg.optimize(graph, kcfg)),
        "returns_before_device": returns_before_device(
            torch, lambda: pg.optimize(graph, kcfg)),
    }
    del flush
    worst = max(e["rel_err"] for c in k13a.values()
                for e in c["errors"].values())
    _require(worst <= PG_RTOL, f"K13a within {PG_RTOL} of its plain version "
                               f"({name})")
    _require(k13b["iterations"] == k13b["iterations_plain"]
             and max(e["max_abs_err"] for e in k13b["errors"].values())
             <= PG_POSE_ATOL, f"K13b == its plain CG within {PG_POSE_ATOL}, "
                              f"same iterations ({name})")
    _require(max(e["rel_err"] for e in k13c["errors"].values()) <= PG_RTOL,
             f"K13c within {PG_RTOL} of its plain version ({name})")
    o = out["optimize"]
    _require(o["max_pose_diff_vs_plain"] <= PG_POSE_ATOL,
             f"optimize within {PG_POSE_ATOL} of optimize_reference on the "
             f"card ({name})")
    _require(o["two_runs_equal_bits"], f"optimize repeats bit for bit "
                                       f"({name})")
    _require(o["host_syncs"] == 0 and o["returns_before_device"],
             f"optimize makes no host sync ({name})")
    return out


def pg_summary(cases: dict, main: str) -> dict:
    """The kernels-line fields of K13a-c: ``main``'s case (K13a in its
    solver's mode), every case under ``cases``."""
    out = {}
    for kname in PG_KERNELS:
        per = {}
        for cname, c in cases.items():
            k = c[kname]
            if kname == "pg_edge_blocks":
                k = k[c["solver"]]
            per[cname] = k
        m = per[main]
        out[kname] = {
            "case": main, "K": cases[main]["K"], "E": cases[main]["E"],
            "max_abs_err": max(e["max_abs_err"] for c in per.values()
                               for e in c["errors"].values()),
            "ms": m["ms"], "cold_ms": m["cold_ms"], "plain_ms": m["plain_ms"],
            "issue_us": m["issue_us"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "least_ms": m["least_ms"],
            "library_ms": None,
            "cusolver_ms": cases[main]["pg_retract"]["cusolver_ms"],
            "cases": {n: {k: v for k, v in c.items() if k != "errors"}
                      for n, c in per.items() if n != main},
        }
    return out


def phase_backend_ba(torch, floor_ms: float, barrier_ms: dict) -> dict:
    """``optimize`` on a seeded ring graph at K = 64 (dense) and K = 512
    (CG): the card against the port on the CPU (poses within 1e-4), and
    two runs on the card equal bit for bit; K13a-c against their plain
    versions on each graph (``pg_case``)."""
    from voxelhashing_demo_tpu_torch.config import KeyframeConfig
    from voxelhashing_demo_tpu_torch.ops import pose_graph

    out = {}
    for name, real, cap, solver in (("K64_dense", 64, 64, "dense"),
                                    ("K512_cg", 128, 512, "cg")):
        kcfg = KeyframeConfig(ba_iters=10, ba_solver=solver)
        args = (real, cap, 7, solver == "cg")
        cpu, _ = pose_graph.optimize(ring_graph(torch, *args, "cpu"), kcfg)
        g = ring_graph(torch, *args, "cuda")
        set_pg_launches()
        a, info = pose_graph.optimize(g, kcfg)
        counts = pg_launches()
        PG_RING_PATHS[f"backend_ba_{name}"] = counts
        n = kcfg.ba_iters
        _require(counts == ([n + 2, n, 0] if solver == "cg"
                            else [n + 2, 0, n]),
                 f"optimize {name}: K13a each iteration and twice for "
                 f"chi2, K13b or K13c each iteration")
        b, _ = pose_graph.optimize(g, kcfg)
        torch.cuda.synchronize()
        diff = float((a.poses.cpu() - cpu.poses).abs().max())
        same = bool(torch.equal(a.poses, b.poses))
        out[name] = {
            "poses": real, "capacity": cap, "solver": solver,
            "ba_iters": kcfg.ba_iters,
            "max_pose_diff_vs_cpu": diff, "two_runs_equal_bits": same,
            "chi2_initial": float(info.chi2_initial),
            "chi2_final": float(info.chi2_final),
            "solve_ms": median_ms(
                torch, lambda: pose_graph.optimize(g, kcfg), reps=3),
            "host_syncs": count_syncs(
                torch, lambda: pose_graph.optimize(g, kcfg)),
        }
        _require(diff <= 1e-4, f"optimize {name}: card within 1e-4 of CPU")
        _require(same, f"optimize {name}: two card runs equal bit for bit")
        _require(out[name]["chi2_final"] < out[name]["chi2_initial"],
                 f"optimize {name}: chi2 went down")
        _require(out[name]["host_syncs"] == 0,
                 f"optimize {name}: no host sync")
        out[name]["kernels"] = pg_case(torch, name, g, kcfg, floor_ms,
                                       barrier_ms)
    return out


def phase_backend(torch, card: str):
    """KeyframeSLAM at the flagship gather width on the injected-drift
    room sweep; see the module docstring."""
    from voxelhashing_demo_tpu_torch.models import hash_slam, keyframe_slam
    from voxelhashing_demo_tpu_torch.ops import hash_ops, pose_graph
    from voxelhashing_demo_tpu_torch.utils import metrics, synthetic

    cfg = backend_config()
    kcfg = cfg.keyframes
    depths, gt = synthetic.make_room_sweep(
        cfg.camera, N_BACKEND, sweep_deg=BACKEND_SWEEP_DEG, noise_seed=1)

    # the same injected run without the backend
    front = hash_slam.HashSLAM(cfg)
    backend_drive(torch, front, depths)
    ate_front = metrics.ate_rmse(front.trajectory, gt, align=False) * 1e3
    del front

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    slam = keyframe_slam.KeyframeSLAM(cfg)
    slam.warm_compile(depths[0])
    state_untouched = (slam._frame_idx == 0 and not slam.keyframes
                       and slam.graph.num_poses == 0
                       and int(slam.state.hmap.free_top)
                       == cfg.hash.num_blocks)
    zero_k7_window()
    frame_ms = backend_drive(torch, slam, depths)
    traj = slam.trajectory()                  # lands all deferred work
    launches = k7_window()
    pg_main = pg_launches()                   # the checks below not counted
    peak = int(torch.cuda.max_memory_allocated())

    events = slam.ba_events
    updates = [e for e in events if e["map_rebuilt"]]
    n_e = slam.graph.num_edges
    edges = slam.graph.edges_ij[:n_e].cpu().numpy().tolist()
    loop_edges = [e for e in edges if e[1] - e[0] > 1]
    fused = sum(e["keyframes"] for e in updates
                if e["rebuild_mode"] == "full")
    moves = sum(e["keyframes_reintegrated"] for e in updates)
    expected = len(depths) + fused + 2 * moves
    tracked = [bool(i.tracked) for i in slam.infos]
    ate = metrics.ate_rmse(traj, gt, align=False) * 1e3
    kf_frames = [r.frame_index for r in slam.keyframes]
    insert_ms = [1e3 * sum(t.values()) for t in slam._kf_insert_s]

    # K7 on one de-integration call: the rows a ledgered keyframe's depth
    # sees at its map_pose, sign -1, gated at its frame
    rec = next(r for r in slam.keyframes if r.map_pose is not None)
    deint = k7_check(slam, rec.depth_dev, torch.as_tensor(
        rec.map_pose, device=slam.device), sign=-1,
        max_born=int(rec.frame_index))
    deint_exact = deint["bit_exact"] and deint["rows"] > 0

    # ledger check: a map fused from scratch from the ledgered keyframes
    # and ring entries at their final poses renders like the incrementally
    # maintained one
    fuse = keyframe_slam.make_fuse_only(cfg)
    reint = keyframe_slam.make_reintegrate(cfg)
    render = keyframe_slam.make_render_model(cfg)
    poses = slam._poses_np
    contributions = [
        (r.depth_dev, poses[r.index], r.frame_index)
        for r in slam.keyframes if r.map_pose is not None
    ] + [(e.depth, (poses[e.kf] @ e.rel).astype(np.float32), e.frame_index)
         for e in slam._ring]
    ref_map = hash_ops.create(cfg.hash)
    fuse_ms = []
    for depth, pose, idx in contributions:
        T = torch.as_tensor(pose, device=slam.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref_map = fuse(ref_map, depth, T, idx)
        torch.cuda.synchronize()
        fuse_ms.append((time.perf_counter() - t0) * 1e3)
    da = render(slam.state.hmap, slam.state.pose).depth.cpu().numpy()
    db = render(ref_map, slam.state.pose).depth.cpu().numpy()
    both = (da > 0) & (db > 0)
    ledger = {
        "contributions": len(contributions),
        "both_frac": float(both.mean()),
        "median_abs_diff_m": float(np.median(np.abs(da - db)[both])),
        "coverage_maintained": float((da > 0).mean()),
        "coverage_from_scratch": float((db > 0).mean()),
    }

    # component times and host syncs, on the scratch map and the final
    # graph (the instance's own map is not touched)
    depth, pose, idx = contributions[0]
    T = torch.as_tensor(pose, device=slam.device)
    last, cands = slam.keyframes[-1], slam.keyframes[-5:-1]
    inits = [np.linalg.inv(poses[c.index]) @ poses[last.index]
             for c in cands]

    def pair_batch():
        slam._run_batch("fwd", last.frame, [c.frame for c in cands], inits)

    def ba_solve():
        slam._fetch_ba(pose_graph.optimize(slam.graph, kcfg)[1])

    def one_move():
        reint(ref_map, depth, T, T, idx)

    def one_fuse():
        fuse(ref_map, depth, T, idx)

    def one_insert_pre():
        slam._kf_pre(last.depth_dev)

    times = {
        "pair_icp_batch_ms": median_ms(torch, pair_batch),
        "pair_icp_batch_candidates": len(cands),
        "ba_solve_ms": median_ms(torch, ba_solve),
        "ba_capacity": int(slam.graph.poses.shape[0]),
        "rebuild_fuse_ms": float(np.median(fuse_ms)),
        "move_ms": median_ms(torch, one_move),
        "keyframe_insert_ms_p50": float(np.median(insert_ms)),
        "keyframe_insert_ms_max": float(np.max(insert_ms)),
        "event_ba_ms_p50": float(np.median([e["ba_s"] for e in events])
                                 * 1e3),
        "event_map_update_ms": [round(e["rebuild_s"] * 1e3, 1)
                                for e in updates],
        "frame_ms_p50": float(np.percentile(frame_ms, 50)),
        "frame_ms_max": float(np.max(frame_ms)),
    }
    syncs = {
        "pair_icp_batch": count_syncs(torch, pair_batch),
        "keyframe_preprocess": count_syncs(torch, one_insert_pre),
        "ba_solve_and_fetch": count_syncs(torch, ba_solve),
        "rebuild_fuse": count_syncs(torch, one_fuse),
        "move": count_syncs(torch, one_move),
        "render_model": count_syncs(
            torch, lambda: render(ref_map, slam.state.pose)),
    }
    syncs["optimize"] = count_syncs(
        torch, lambda: pose_graph.optimize(slam.graph, kcfg))
    syncs["ba_solve_and_fetch_sites"] = sync_sites(torch, ba_solve)
    syncs["rebuild_fuse_sites"] = sync_sites(torch, one_fuse)
    syncs["per_keyframe_insert"] = (syncs["keyframe_preprocess"]
                                    + syncs["pair_icp_batch"])
    syncs["per_ba_event_plus_map_update"] = (
        f"{syncs['ba_solve_and_fetch']} + {syncs['rebuild_fuse']} x "
        f"keyframes (full) or {syncs['move']} x moves + 1 (incremental)"
        f" + {syncs['render_model']} (render)")

    # one relocalization attempt, last: it resets the live pose and model.
    # Frame 24 against the last 16 keyframes, each from a raced Procrustes
    # seed; the recovered pose is held against that frame's trajectory pose
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    found = slam._relocalize(hash_slam.depth_tensor(depths[24], slam.device))
    torch.cuda.synchronize()
    reloc = {
        "ms": (time.perf_counter() - t0) * 1e3,
        "candidates": min(len(slam.keyframes), kcfg.reloc_max_candidates),
        "recovered": found is not None,
        "dist_to_trajectory_m": (
            float(np.linalg.norm(found[:3, 3] - traj[24][:3, 3]))
            if found is not None else None),
    }

    from voxelhashing_demo_tpu_torch import kernels
    from voxelhashing_demo_tpu_torch.tools import probe

    floor_ms, barrier_ms = probe.launch_floor_ms(), {}
    final = pg_case(torch, "backend", slam.graph, kcfg, floor_ms, barrier_ms)
    ba = phase_backend_ba(torch, floor_ms, barrier_ms)
    pg_cases = {"backend": final, **{n: c["kernels"] for n, c in ba.items()}}
    PG_SUMMARY.update(pg_summary(pg_cases, "backend"))
    PG_SUMMARY["ptxas"] = kernels.ptxas_report("pose_graph")
    set_pg_launches(pg_main)
    _emit({
        "phase": "backend", "card": card, "H": H, "W": W,
        "frames": len(depths),
        "sweep_deg": BACKEND_SWEEP_DEG, "inject": BACKEND_INJECT,
        "keyframe_settings": BACKEND_KEYFRAMES,
        "warm_compile_left_state_alone": state_untouched,
        "tracked": sum(tracked), "keyframes": len(kf_frames),
        "keyframe_frames": kf_frames, "edges": n_e,
        "loop_edges": len(loop_edges),
        "ba_events": len(events),
        "ba_frames": [e["frame"] for e in events],
        "ba_modes": [e["rebuild_mode"] for e in events],
        "keyframes_reintegrated": [e["keyframes_reintegrated"]
                                   for e in events],
        "saturated": any(e.get("reintegration_saturated") for e in events),
        "ring_overflow": bool(slam._ring_overflow),
        "capacity_events": slam.capacity_events,
        "ate_mm": ate, "ate_frontend_only_mm": ate_front,
        "kernel_launches": launches,
        "kernel_launches_expected": expected,
        "launches_formula": f"{len(depths)} frames + {fused} keyframes "
                            f"fused by full rebuilds + 2 x {moves} moves",
        "deintegration_rows": deint["rows"],
        "deintegration_k7_bit_exact": deint_exact,
        "ledger": ledger, "times": times, "host_syncs": syncs,
        "relocalize": reloc,
        "optimize": ba, "pose_graph_final": final,
        "floor_ms": floor_ms, "barrier_floor_ms": barrier_ms,
        "pg_launches": pg_main, "peak_mem_bytes": peak,
        "jax_reference": JAX_REFERENCE_BACKEND,
    })
    _require(syncs["optimize"] == 0, "optimize alone makes no host sync")
    _require(syncs["ba_solve_and_fetch"] == 1,
             "a BA solve and its fetch make one host sync (_fetch_ba)")
    _require(state_untouched, "warm_compile leaves the instance's state")
    _require(len(loop_edges) >= 1, ">= 1 accepted loop edge")
    _require(len(events) >= 2, ">= 2 BA events")
    _require(bool(updates) and updates[0]["rebuild_mode"] == "full",
             "the first map update is a full rebuild")
    _require(any(e["rebuild_mode"] == "incremental"
                 and e["keyframes_reintegrated"] > 0 for e in updates[1:]),
             "a later map update is incremental and moves something")
    _require(not any(e.get("reintegration_saturated") for e in events),
             "no reintegration saturated")
    _require(not slam._ring_overflow, "no ring overflow")
    _require(all(tracked[1:]), "every frame but frame 0 tracked")
    _require(all(np.isfinite(T).all() for T in traj), "finite trajectory")
    _require(ate < ate_front,
             "unaligned ATE with the backend below the frontend-only ATE")
    _require(ate < 2.0 * JAX_REFERENCE_BACKEND["ate_mm"],
             "unaligned ATE < 2x the JAX figure")
    _require(launches == expected, "K7 (window gather) launches == frames "
             "+ rebuild fuses + 2 x moves")
    _require(deint_exact, "K7 == plain integrate on de-integration rows")
    _require(reloc["recovered"] and reloc["dist_to_trajectory_m"] < 0.05,
             "relocalization recovers frame 24's pose within 5 cm")
    _require(ledger["both_frac"] > 0.5, "ledger check: renders overlap")
    _require(ledger["median_abs_diff_m"] < cfg.fusion.voxel_size,
             "ledger check: median depth difference < 1 voxel")
    ca, cb = ledger["coverage_maintained"], ledger["coverage_from_scratch"]
    _require(ca > 0.9 * cb and cb > 0.9 * ca,
             "ledger check: coverage agrees")
    return launches


def stream_config(stream: dict, keyframes: dict | None = None):
    """flagship_gather_config() cut to the streaming phases' hash, with
    ``stream`` (and keyframe settings on top of the flagship's)."""
    from voxelhashing_demo_tpu_torch.config import flagship_gather_config

    cfg = flagship_gather_config()
    cfg = dataclasses.replace(
        cfg, hash=dataclasses.replace(cfg.hash, **STREAM_HASH),
        stream=dataclasses.replace(cfg.stream, **stream))
    if keyframes is not None:
        cfg = dataclasses.replace(
            cfg, keyframes=dataclasses.replace(cfg.keyframes, **keyframes))
    return cfg


def out_and_back(cam):
    """The streaming phases' frames: the noisy sweep forward, then back."""
    from voxelhashing_demo_tpu_torch.utils import synthetic

    fwd, gt = synthetic.make_room_sweep(cam, N_STREAM_HALF,
                                        sweep_deg=STREAM_SWEEP_DEG,
                                        noise_seed=1)
    return fwd + fwd[-2::-1], gt + gt[-2::-1]


class StreamTimers:
    """CUDA-event timers around ``hash_ops.evict_stale`` and
    ``restore_blocks`` while installed (the streaming cycle calls them by
    module attribute); ``ms()`` reads them after a synchronize."""

    def __init__(self, torch, hash_ops):
        self.torch, self.ops = torch, hash_ops
        self.events = {"evict_stale": [], "restore_blocks": []}
        self.real = {k: getattr(hash_ops, k) for k in self.events}

    def __enter__(self):
        torch = self.torch

        def timed(name):
            fn = self.real[name]

            def wrapper(*a, **k):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*a, **k)
                end.record()
                self.events[name].append((start, end))
                return out
            return wrapper

        for k in self.events:
            setattr(self.ops, k, timed(k))
        return self

    def __exit__(self, *exc):
        for k, fn in self.real.items():
            setattr(self.ops, k, fn)

    def ms(self) -> dict:
        self.torch.cuda.synchronize()
        return {k: [s.elapsed_time(e) for s, e in v]
                for k, v in self.events.items()}


def _pcts(xs) -> dict:
    if not len(xs):
        return {"n": 0}
    return {"n": len(xs), "p50": float(np.percentile(xs, 50)),
            "p99": float(np.percentile(xs, 99)), "max": float(np.max(xs))}


def stream_drive(torch, slam, inner, depths):
    """Process ``depths`` through ``slam`` (HashSLAM or KeyframeSLAM whose
    streaming HashSLAM is ``inner``); per-frame host ms (to the card's idle
    after the frame) by class: the frame whose process() runs the cycle's
    dispatch, the one that runs its completion, and the rest."""
    s = inner.config.stream
    by_class = {"dispatch": [], "completion": [], "plain": []}
    for d in depths:
        i = len(inner.trajectory) % s.interval
        cls = ("dispatch" if i == 0 else
               "completion" if i == max(s.interval // 2, 1) else "plain")
        t0 = time.perf_counter()
        slam.process(d)
        torch.cuda.synchronize()
        by_class[cls].append((time.perf_counter() - t0) * 1e3)
    return by_class


def stream_report(torch, inner, last_depth, by_class, timers,
                  launches) -> dict:
    """The cycle's costs, transfers, syncs, memory and K7 on the rows of
    the run's last frame, after the run (``inner`` is the streaming
    HashSLAM)."""
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    s = inner.config.stream
    log = inner._xfer.log
    xfer = {}
    for direction in ("d2h", "h2d"):
        rows = [(b, ms) for d, b, ms in log if d == direction]
        xfer[direction] = {
            "batches": len(rows),
            "bytes_per_batch_mean": (float(np.mean([b for b, _ in rows]))
                                     if rows else 0.0),
            "us_per_batch": _pcts([1e3 * ms for _, ms in rows]),
            "bytes_total": int(sum(b for b, _ in rows)),
        }
    # host syncs: the eviction scan and a restore alone (on clones of the
    # map), then one more dispatch and completion of the live cycle
    hm = hash_ops.HashMap(*(t.clone() for t in inner.state.hmap))
    keys = np.asarray(sorted(inner.store._index)[: s.max_restore],
                      np.int32)
    rows = [torch.as_tensor(a, device=inner.device)
            for a in (keys,) + inner.store.rows_for(keys)]
    with uncounted_maint():
        evict = sync_sites(torch, lambda: hash_ops.evict_stale(
            hm, inner.config.hash, inner.state.frame_idx + 1, s.max_age,
            s.max_evict))
        restore = sync_sites(torch, lambda: hash_ops.restore_blocks(
            hm, inner.config.hash, rows[0], rows[1], rows[2],
            inner.state.frame_idx, max_weight=inner.config.fusion.max_weight,
            born_rows=rows[3]))
    inner._cycle_complete()
    dispatch = sync_sites(torch, inner._cycle_dispatch)
    complete = sync_sites(torch, inner._cycle_complete)
    # K7 against the plain integrate on the last frame's rows of this run
    check = k7_check(inner, last_depth)
    return {
        "frame_ms": {k: _pcts(v) for k, v in by_class.items()},
        "cycles": len(by_class["dispatch"]),
        # evict_ms counts a rebuild's spill evictions too
        "evict_ms": _pcts(timers["evict_stale"]),
        "restore_ms": _pcts(timers["restore_blocks"]),
        "transfers": xfer,
        "host_syncs": {"evict_stale": evict, "restore_blocks": restore,
                       "cycle_dispatch": dispatch,
                       "cycle_completion": complete,
                       "event_waits_per_cycle": 1},
        "peak_mem_bytes": int(torch.cuda.max_memory_allocated()),
        "pinned_host_bytes": inner._xfer.pinned_bytes(),
        "k7_window_launches": launches,
        "k7_rows": check["rows"],
        "k7_bit_exact": check["bit_exact"],
    }


class CallRecorder:
    """While installed, every call of ``evict_stale`` and
    ``restore_blocks`` (called by module attribute) is kept: its map
    copied and its tensor arguments cloned before the call, outside any
    timer installed before this."""

    NAMES = ("evict_stale", "restore_blocks")

    def __init__(self, torch, hash_ops):
        self.torch, self.ops = torch, hash_ops
        self.calls = {k: [] for k in self.NAMES}

    def __enter__(self):
        from voxelhashing_demo_tpu_torch.tools import probe

        torch = self.torch
        self.real = {k: getattr(self.ops, k) for k in self.NAMES}

        def clone(x):
            return x.clone() if torch.is_tensor(x) else x

        def recorded(name):
            fn = self.real[name]

            def wrapper(hmap, *a, **k):
                self.calls[name].append((
                    probe.map_copy(hmap), tuple(clone(x) for x in a),
                    {key: clone(v) for key, v in k.items()}))
                return fn(hmap, *a, **k)
            return wrapper

        for k in self.NAMES:
            setattr(self.ops, k, recorded(k))
        return self

    def __exit__(self, *exc):
        for k, fn in self.real.items():
            setattr(self.ops, k, fn)


def _evict_bytes(hcfg, base, after, n: int, max_evict: int) -> int:
    """The bytes K14 must move: every slot's key and ptr and the live
    rows' last_seen read; the evicted rows' tsdf, weight and born read;
    max_evict output rows (keys, born, tsdf, weight, padding included),
    the fills, the changed slots and the pushed stack entries written."""
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    V = hcfg.voxels_per_block
    live = int((base.ptrs != hash_ops.FREE_PTR).sum())
    changed = _changed_slots(base, after)
    return (8 * base.keys.numel() + 4 * live + n * (8 * V + 4)
            + max_evict * (8 * V + 8) + 4 * hcfg.num_buckets + 8 * changed
            + 4 * n + 8)


def _restore_bytes(hcfg, keys, found: int, inserted: int, born) -> int:
    """The bytes K15 must move: the R keys; each key's bucket (slots,
    ptrs, fill); the input rows of the found and inserted keys (tsdf,
    weight, born); each found row read and written with its band_min and
    born; each inserted row, its last_seen, band_min, born, key, ptr and
    fill written; accepted."""
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    V, S = hcfg.voxels_per_block, hcfg.bucket_size
    R = keys.numel()
    K = int((keys != hash_ops.EMPTY_KEY).sum())
    row_in = 8 * V + (4 if born is not None else 0)
    return (4 * R + K * 4 * (2 * S + 1) + (found + inserted) * row_in
            + found * (16 * V + 8) + inserted * (8 * V + 24) + R + 8)


def _maint_stream_checks(torch, rec: CallRecorder, floor_ms: float) -> dict:
    """K14 and K15 against ``evict_stale_reference`` and
    ``restore_blocks_reference``, bit for bit (every map field and every
    output), on every call the streaming run made, each on copies of the
    call's own map and batch; then the kernel on the call that evicted
    the most rows (K14) and the batch that restored the most (K15):
    warm and L2-cold (a CUDA graph of 8 and 32 launches on copies of the
    map, restored before each replay; the kernel's own µs by the
    profiler), wrapper host ms and µs to issue, the plain version's ms,
    the bound from that call's data and the least (the launch floor and
    one status exchange or arrival, a grid barrier's cost).  Returns
    {kernel: its kernels-line fields}."""
    from voxelhashing_demo_tpu_torch import kernels
    from voxelhashing_demo_tpu_torch.ops import hash_ops
    from voxelhashing_demo_tpu_torch.tools import probe

    out = {}
    cases = []
    for m, a, k in rec.calls["evict_stale"]:
        got, want = probe.map_copy(m), probe.map_copy(m)
        res = hash_ops.evict_stale(got, *a, **k)
        ref = hash_ops.evict_stale_reference(want, *a, **k)
        ok = all(_maps_equal(torch, got, want).values()) and all(
            bool(torch.equal(x, y)) for x, y in zip(res[1:], ref[1:]))
        cases.append({"n": int(ref[-1]), "bit_exact": ok, "after": want})
    i_ev = int(np.argmax([c["n"] for c in cases]))
    ev = {"calls": len(cases), "bit_exact": all(c["bit_exact"]
                                                for c in cases),
          "evicted_per_call": [c["n"] for c in cases]}
    re_cases = []
    for m, a, k in rec.calls["restore_blocks"]:
        got, want = probe.map_copy(m), probe.map_copy(m)
        _, acc = hash_ops.restore_blocks(got, *a, **k)
        _, ref = hash_ops.restore_blocks_reference(want, *a, **k)
        ok = all(_maps_equal(torch, got, want).values()) and bool(
            torch.equal(acc, ref))
        _, found = hash_ops.lookup_keys(m, a[0], a[1])
        re_cases.append({"R": int(a[1].numel()),
                         "keys": int((a[1] != hash_ops.EMPTY_KEY).sum()),
                         "found": int(found.sum()),
                         "accepted": int(ref.sum()), "bit_exact": ok})
    i_re = int(np.argmax([c["accepted"] for c in re_cases]))
    rs = {"calls": len(re_cases), "bit_exact": all(c["bit_exact"]
                                                   for c in re_cases),
          "accepted_per_call": [c["accepted"] for c in re_cases]}
    for name, summary, call, kern in (
            ("evict_free", ev, rec.calls["evict_stale"][i_ev],
             "free_kernel"),
            ("restore_rows", rs, rec.calls["restore_blocks"][i_re],
             "restore_rows")):
        m, a, k = call
        fn = getattr(hash_ops, "evict_stale" if name == "evict_free"
                     else "restore_blocks")
        plain = getattr(hash_ops, "evict_stale_reference"
                        if name == "evict_free"
                        else "restore_blocks_reference")
        fields = GC_FIELDS if name == "evict_free" else m._fields
        graphs = {n: _k5b_graph(torch, lambda mm: fn(mm, *a, **k), m, m,
                                n, probe.WARM_CALLS // 2 if n < 32 else 5,
                                fields, kern)
                  for n in (1, ALLOC_WARM_COPIES, ALLOC_COLD_COPIES)}
        want = probe.map_copy(m, fields)
        plain(want, *a, **k)
        work = probe.map_copy(m)

        def prep(work=work, m=m):
            _restore(work, m, m._fields)

        summary.update({
            "case": "largest_call", "ms": graphs[ALLOC_WARM_COPIES]["ms"],
            "cold_ms": graphs[ALLOC_COLD_COPIES]["ms"],
            "graph_copies": {str(n): {key: g[key] for key in (
                "ms", "kernel_us", "eager_kernel_us")}
                for n, g in graphs.items()},
            "graph_replay_bit_exact": all(
                all(_maps_equal(torch, g["replayed"], want).values())
                for g in graphs.values()),
            "wrapper_ms": probe.host_ms(lambda: fn(work, *a, **k)),
            "host_issue_us": host_issue_us(lambda: fn(work, *a, **k),
                                           reps=WRAPPER_REPS),
            "plain_ms": _prepped_ms(torch, lambda: plain(work, *a, **k),
                                    prep)})
        prep()
        if name == "evict_free":
            c = cases[i_ev]
            nbytes = _evict_bytes(a[0], m, c["after"], c["n"], a[3])
            ops = MAINT_SLOT_OPS * m.keys.numel()
            ctas = max(-(-a[0].num_buckets // hash_ops.MAINTAIN_TILE),
                       hash_ops.EVICT_MIN_TILES)
            summary["evicted"] = c["n"]
        else:
            c = re_cases[i_re]
            born = k.get("born_rows", a[7] if len(a) > 7 else None)
            nbytes = _restore_bytes(a[0], a[1], c["found"],
                                    c["accepted"] - c["found"], born)
            ops = 40 * c["keys"] + 8 * a[0].voxels_per_block * c["found"]
            ctas = min(-(-c["R"] // 32), torch.cuda.get_device_properties(
                torch.cuda.current_device()).multi_processor_count)
            summary.update({k2: c[k2] for k2 in ("R", "keys", "found",
                                                 "accepted")})
        summary["bound_bytes"] = nbytes
        summary["bound_ms"], summary["bound_by"] = _probe_bound(nbytes, ops)
        summary["barrier_floor_ms"] = barrier_floor_ms(torch, kernels, ctas)
        summary["floor_ms"] = floor_ms
        summary["least_ms"] = max(summary["bound_ms"],
                                  floor_ms + summary["barrier_floor_ms"])
        out[name] = summary
    for c in cases:
        del c["after"]
    return out


def phase_stream(torch, card: str):
    """The streaming HashSLAM on the 201-frame out-and-back (BASELINE
    config 5, bench.py ``_streaming_run``), and its non-streaming twin."""
    from voxelhashing_demo_tpu_torch.models import hash_slam
    from voxelhashing_demo_tpu_torch.ops import hash_ops
    from voxelhashing_demo_tpu_torch.utils import metrics

    cfg = stream_config(STREAM)
    depths, gt = out_and_back(cfg.camera)

    warm = hash_slam.HashSLAM(cfg)
    warm.warm_stream()
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    slam = hash_slam.HashSLAM(cfg)
    zero_k7_window()
    with StreamTimers(torch, hash_ops) as timers:
        with CallRecorder(torch, hash_ops) as rec:
            by_class = stream_drive(torch, slam, slam, depths)
        launches = k7_window()
        slam.stream_sync()
        times = timers.ms()
    ate = metrics.ate_rmse(slam.trajectory, gt, align=False) * 1e3
    tracked = sum(bool(i.tracked) for i in slam.infos)
    store = slam.store
    counters = {"evicted": store.total_evicted,
                "restored": store.total_restored,
                "store_blocks": len(store)}
    dev = {int(k) for k in slam.state.hmap.keys.cpu().numpy()
           if k != hash_ops.EMPTY_KEY}
    distinct = len(dev | set(store._index))
    report = stream_report(torch, slam, depths[-1], by_class, times,
                           launches)
    del slam
    from voxelhashing_demo_tpu_torch.tools import probe

    with uncounted_maint():
        maint = _maint_stream_checks(torch, rec, probe.launch_floor_ms())
    del rec

    twin_cfg = dataclasses.replace(
        cfg, stream=dataclasses.replace(cfg.stream, enabled=False))
    twin = hash_slam.HashSLAM(twin_cfg)
    for d in depths:
        twin.process(d)
    ate_twin = metrics.ate_rmse(twin.trajectory, gt, align=False) * 1e3
    twin_free = min(int(i.free_blocks) for i in twin.infos)
    twin_tracked = sum(bool(i.tracked) for i in twin.infos)
    del twin

    n = len(depths)
    _emit({"phase": "stream", "card": card, "H": H, "W": W, "frames": n,
           "hash": STREAM_HASH, "stream": STREAM, "tracked": tracked,
           "ate_mm": ate, **counters, "distinct_blocks": distinct,
           **report, "twin": {"ate_mm": ate_twin, "tracked": twin_tracked,
                              "min_free_blocks": twin_free,
                              "tracks_worse": ate_twin > ate},
           "evict_free": maint["evict_free"],
           "restore_rows": maint["restore_rows"],
           "jax_reference": JAX_REFERENCE_STREAM})
    _require(tracked >= JAX_REFERENCE_STREAM["tracked"] - 2,
             "tracked frames within 2 of the JAX run's")
    _require(ate < 2.0 * JAX_REFERENCE_STREAM["ate_mm"],
             "unaligned ATE < 2x the JAX figure")
    _require(counters["evicted"] > cfg.hash.num_blocks,
             "evicted more blocks than the device map holds")
    _require(counters["restored"] > 100, "> 100 blocks restored")
    _require(distinct > cfg.hash.num_blocks,
             "device + store hold more distinct blocks than the map")
    _require(twin_free == 0, "the non-streaming twin exhausts the heap")
    _require(ate_twin < 2.0 * JAX_REFERENCE_STREAM["twin_ate_mm"],
             "the twin's ATE < 2x the JAX twin's")
    _require(launches == n,
             "K7 (window gather) launched once per streamed frame")
    _require(report["k7_bit_exact"], "K7 == plain integrate on this run")
    _require(maint["evict_free"]["bit_exact"]
             and maint["restore_rows"]["bit_exact"],
             "K14 and K15 == their plain versions bit for bit on every "
             "call of the run")
    _require(maint["evict_free"]["evicted"] > 0
             and maint["restore_rows"]["accepted"] > 0,
             "the run's largest eviction and restore move rows")
    _require(maint["evict_free"]["graph_replay_bit_exact"]
             and maint["restore_rows"]["graph_replay_bit_exact"],
             "K14 and K15 replayed from a CUDA graph == their plain versions")
    _require(not report["host_syncs"]["evict_stale"]
             and not report["host_syncs"]["restore_blocks"],
             "evict_stale and restore_blocks read nothing on the host")
    return launches, ate, {
        k: {"case": v.pop("case"), **v, "max_abs_err": 0.0,
            "library_ms": None} for k, v in maint.items()}


def phase_stream_backend(torch, card: str, ate_stream: float):
    """The streaming KeyframeSLAM on the same frames (BASELINE config 5,
    bench.py ``_streaming_backend_run``)."""
    from voxelhashing_demo_tpu_torch.models import keyframe_slam
    from voxelhashing_demo_tpu_torch.ops import hash_ops
    from voxelhashing_demo_tpu_torch.utils import metrics

    cfg = stream_config(STREAM_BACKEND, STREAM_BACKEND_KEYFRAMES)
    depths, gt = out_and_back(cfg.camera)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    slam = keyframe_slam.KeyframeSLAM(cfg)
    slam.warm_compile(depths[0])
    d = slam._inner
    zero_k7_window()
    with StreamTimers(torch, hash_ops) as timers:
        by_class = stream_drive(torch, slam, d, depths)
        slam.flush()
        traj = slam.trajectory()
        d.stream_sync()
        launches = k7_window()
        times = timers.ms()
    ate = metrics.ate_rmse(traj, gt, align=False) * 1e3
    events = slam.ba_events
    updates = [e for e in events if e["map_rebuilt"]]
    full = [e for e in updates if e["rebuild_mode"] == "full"]
    fused = sum(e["keyframes"] for e in full)
    moves = sum(e["keyframes_reintegrated"] for e in updates)
    expected = len(depths) + fused + 2 * moves
    swapped = [e for e in full
               if "stream_sync_s" in e.get("rebuild_detail", {})]
    n_e = slam.graph.num_edges
    edges = slam.graph.edges_ij[:n_e].cpu().numpy().tolist()
    decisions = {
        "keyframe_frames": [r.frame_index for r in slam.keyframes],
        "edges": n_e,
        "loop_edges": [e for e in edges if e[1] - e[0] > 1],
        "ba_frames": [e["frame"] for e in events],
        "ba_modes": [e["rebuild_mode"] for e in events],
        "keyframes_reintegrated": [e["keyframes_reintegrated"]
                                   for e in events],
    }
    ref = JAX_REFERENCE_STREAM_BACKEND
    kf_diff = len(set(decisions["keyframe_frames"])
                  ^ set(ref["keyframe_frames"]))
    same = {k: decisions[k] == ref[k] for k in decisions}
    store = d.store
    counters = {"evicted": store.total_evicted,
                "restored": store.total_restored,
                "store_blocks": len(store)}
    saturated = any(e.get("reintegration_saturated") for e in events)
    overflow = [e for e in slam.capacity_events
                if e["kind"] == "rebuild_spill_overflow"]
    report = stream_report(torch, d, depths[-1], by_class, times,
                           launches)
    # a full rebuild into a fresh store on the map the run left: the run's
    # own, or, when its BA corrections stayed under the rebuild
    # thresholds, one asked for here (K7 once per keyframe)
    forced = None
    if not swapped:
        old_store = d.store
        restored_before = old_store.total_restored
        zero_k7_window()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slam._rebuild_map()
        d.stream_sync()
        torch.cuda.synchronize()
        forced = {"ms": (time.perf_counter() - t0) * 1e3,
                  "keyframes": len(slam.keyframes),
                  "k7_window_launches": k7_window(),
                  "fresh_store": d.store is not old_store,
                  "store_blocks": len(d.store),
                  "evicted": d.store.total_evicted,
                  "restored": d.store.total_restored,
                  "counters_carried": d.store.total_restored
                  >= restored_before,
                  "laps_s": slam._last_rebuild_detail}
        overflow = [e for e in slam.capacity_events
                    if e["kind"] == "rebuild_spill_overflow"]
    _emit({"phase": "stream_backend", "card": card, "H": H, "W": W,
           "frames": len(depths), "hash": STREAM_HASH,
           "stream": STREAM_BACKEND,
           "keyframe_settings": STREAM_BACKEND_KEYFRAMES,
           "tracked": sum(bool(i.tracked) for i in slam.infos),
           "ate_mm": ate, "ate_stream_phase_mm": ate_stream, **counters,
           **decisions, "decisions_equal_jax": same,
           "keyframes_differing_from_jax": kf_diff,
           "ba_corrections_m_deg": [(e["correction_trans_m"],
                                     e["correction_rot_deg"])
                                    for e in events],
           "full_rebuilds_streaming": len(swapped),
           "rebuild_details": [e.get("rebuild_detail") for e in full],
           "rebuild_after_run": forced,
           "saturated": saturated, "capacity_events": slam.capacity_events,
           "kernel_launches_expected": expected,
           "launches_formula": f"{len(depths)} frames + {fused} keyframes "
                               f"fused by full rebuilds + 2 x {moves} moves",
           **report, "jax_reference": ref})
    _require(ate < ate_stream, "ATE below the stream phase's")
    _require(ate < 2.0 * ref["ate_mm"], "unaligned ATE < 2x the JAX figure")
    _require(len(swapped) >= 1 or (
        forced["fresh_store"] and forced["counters_carried"]
        and forced["store_blocks"] > 0
        and forced["k7_window_launches"] == forced["keyframes"]),
        ">= 1 full rebuild into a fresh store (streaming mode)")
    _require(not overflow, "no rebuild_spill_overflow")
    _require(counters["restored"] > 0, "restore counters carried")
    _require(not saturated, "no reintegration saturated")
    _require(kf_diff <= 1, "keyframes within one of the JAX run's")
    _require(launches == expected, "K7 (window gather) launches == frames "
             "+ rebuild fuses + 2 x moves")
    _require(report["k7_bit_exact"], "K7 == plain integrate on this run")
    return launches


@contextlib.contextmanager
def _wrapped(obj, name: str, make):
    """``obj.name`` replaced by ``make(real)`` while the block runs."""
    real = getattr(obj, name)
    setattr(obj, name, make(real))
    try:
        yield
    finally:
        setattr(obj, name, real)


def _recorded(last: list):
    """A ``make`` for ``_wrapped``: the real function, with the arguments
    of its last call kept in ``last``."""
    def make(real):
        def fn(*a, **k):
            last[:] = a
            return real(*a, **k)
        return fn
    return make


def _counted(calls: dict, key: str):
    def make(real):
        def fn(*a, **k):
            calls[key] += 1
            return real(*a, **k)
        return fn
    return make


def cli_json(cli, argv) -> dict:
    """``cli.main(argv)`` in this process; its one JSON line."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _int_state_equal(a: dict, b: dict) -> bool:
    """Two ``convert.state_to_numpy`` dicts: the map's integer fields and
    the frame counter equal."""
    keys = [f"hmap.{f}" for f in ("keys", "ptrs", "bucket_fill",
                                  "free_list", "free_top", "last_seen",
                                  "born")] + ["frame_idx"]
    return all(np.array_equal(a[k], b[k]) for k in keys)


def phase_cli(torch, card: str):
    """The application layer on the card: the out-and-back frames as a TUM
    directory, the first N_CLI_LIBRARY through FramePipeline into
    KeyframeSLAM (the CLI's default configuration with the window gather)
    and saved, then ``run --resume`` through the CLI, ``render``, ``info``
    and ``evaluate`` on its outputs, the hash backend over the real PNG16
    fixture and ``demo`` on two of its files."""
    import tempfile

    from voxelhashing_demo_tpu_torch import cli, convert
    from voxelhashing_demo_tpu_torch.config import CameraConfig
    from voxelhashing_demo_tpu_torch.models import keyframe_slam
    from voxelhashing_demo_tpu_torch.utils import checkpoint
    from voxelhashing_demo_tpu_torch.utils import io as depth_io
    from voxelhashing_demo_tpu_torch.utils import (pointcloud, profiling,
                                                   stream, tum)

    ref = JAX_REFERENCE_CLI
    depths, gt = out_and_back(CameraConfig())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    codec = {"batch": 0, "native": 0, "python": 0}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as root, \
            _wrapped(depth_io, "read_depth_batch",
                     _counted(codec, "batch")), \
            _wrapped(depth_io, "_native_decode",
                     _counted(codec, "native")), \
            _wrapped(depth_io, "_py_decode", _counted(codec, "python")):
        data = os.path.join(root, "tum")
        t0 = time.perf_counter()
        tum.export_sequence(data, depths, gt)
        export_s = time.perf_counter() - t0
        paths = [os.path.join(data, rel)
                 for _, rel, _ in tum.TUMSequence(data).entries]

        # the library: pipeline -> KeyframeSLAM -> checkpoint
        cfg = cli._default_config(cli.build_parser().parse_args(["run"]))
        cfg = dataclasses.replace(
            cfg, hash=dataclasses.replace(cfg.hash, use_pallas_gather=True))
        slam = keyframe_slam.KeyframeSLAM(cfg)
        zero_k7_window()
        pipe = stream.FramePipeline(paths[:N_CLI_LIBRARY], W, H)
        for d in pipe:
            slam.process(d)
        library = {"frames": N_CLI_LIBRARY,
                   "k7_window_launches": k7_window(),
                   "consumer_waits": pipe.consumer_waits}
        ck = os.path.join(root, "library.npz")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save_keyframe_slam(ck, slam)
        library["save_s"] = time.perf_counter() - t0
        saved = convert.state_to_numpy(slam.state)
        library.update(keyframes=len(slam.keyframes),
                       ba_events=len(slam.ba_events),
                       checkpoint_bytes=os.path.getsize(ck))
        t0 = time.perf_counter()
        back = checkpoint.load_keyframe_slam(ck)
        torch.cuda.synchronize()
        library["load_s"] = time.perf_counter() - t0
        library["reload_int_state_exact"] = _int_state_equal(
            saved, convert.state_to_numpy(back.state))
        n_lib_events = library["ba_events"]
        del slam, back, pipe

        # run --resume through the CLI, K7 counted from 0
        out = os.path.join(root, "run")
        timer = profiling.StageTimer()
        pipes, finals = [], []

        def timed(real):
            def process(self, d):
                with timer.stage("process"):
                    return real(self, d)
            return process

        def recorded(real):
            def init(self, *a, **k):
                real(self, *a, **k)
                pipes.append(self)
            return init

        def snapshot(real):
            def save(path, kslam, *a, **k):
                real(path, kslam, *a, **k)
                finals.append((path, convert.state_to_numpy(kslam.state),
                               list(kslam.ba_events)))
            return save

        zero_k7_window()
        with _wrapped(keyframe_slam.KeyframeSLAM, "process", timed), \
                _wrapped(stream.FramePipeline, "__init__", recorded), \
                _wrapped(checkpoint, "save_keyframe_slam", snapshot):
            result = cli_json(cli, [
                "run", "--dataset", data, "--backend", "keyframe",
                "--resume", ck, "--render-last", "--render-every",
                str(CLI_RENDER_EVERY), "--out", out])
        launches = k7_window()
        timer.summary()
        frame_ms = [1e3 * t for t in timer.records["process"]]
        run_events = finals[-1][2][n_lib_events:]
        updates = [e for e in run_events if e["map_rebuilt"]]
        fused = sum(e["keyframes"] for e in updates
                    if e["rebuild_mode"] == "full")
        moves = sum(e["keyframes_reintegrated"] for e in updates)
        expected = result["frames"] + fused + 2 * moves
        map_npz = os.path.join(out, "map.npz")
        with np.load(map_npz) as z:
            n_e = int(z["graph.num_edges"])
            loop_edges = sum(1 for i, j in z["graph.edges_ij"][:n_e]
                             if j - i > 1)
            kf_frames = z["extra.kf_frame_indices"].tolist()
        t0 = time.perf_counter()
        reloaded, graph = checkpoint.load_slam(map_npz)
        torch.cuda.synchronize()
        run_load_s = time.perf_counter() - t0
        reload_exact = _int_state_equal(
            finals[-1][1], convert.state_to_numpy(reloaded.state))
        del reloaded

        # render / info / evaluate on the run's outputs
        rdir = os.path.join(root, "render")
        render = cli_json(cli, ["render", "--checkpoint", map_npz,
                                "--orbit", "3", "--ply", "pts.ply",
                                "--mesh", "mesh.ply", "--out", rdir])
        pts = pointcloud.load_ply_points(os.path.join(rdir, "pts.ply"))
        verts = pointcloud.load_ply_points(os.path.join(rdir, "mesh.ply"))
        pngs = [os.path.getsize(os.path.join(rdir, f))
                for f in render["frames"]]
        info = cli_json(cli, ["info", "--checkpoint", map_npz])
        ev = cli_json(cli, ["evaluate", "--est",
                            os.path.join(out, "trajectory.txt"), "--gt",
                            os.path.join(data, "groundtruth.txt")])

        # the real PNG16 fixture through the hash backend, and demo
        before = dict(codec)
        fix = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "fixtures", "kinect_png16")
        fixture = cli_json(cli, ["run", "--dataset", fix, "--render-last",
                                 "--out", os.path.join(root, "fixture")])
        fix_traj = np.loadtxt(os.path.join(root, "fixture",
                                           "trajectory.txt"))
        names = sorted(os.listdir(os.path.join(fix, "depth")))[:2]
        demo = cli_json(cli, ["demo", *(os.path.join(fix, "depth", n)
                                        for n in names),
                              "--out", os.path.join(root, "demo")])
        fixture_codec = {k: codec[k] - before[k] for k in codec}
        ck_bytes = os.path.getsize(map_npz)
    peak = int(torch.cuda.max_memory_allocated())

    ate = result["ate_rmse_unaligned_m"] * 1e3
    kf_diff = result["keyframes"] - ref["keyframes"]
    _emit({
        "phase": "cli", "card": card, "H": H, "W": W,
        "frames": len(depths), "export_s": export_s, "library": library,
        "result": result, "fps": result["fps"],
        "frame_ms": _pcts(frame_ms),
        # (resumed frame, ms) of the three slowest, and each BA event's
        # frame, solve and map-update seconds (host clock)
        "slowest_frames": sorted(enumerate(frame_ms),
                                 key=lambda e: -e[1])[:3],
        "ba_events_s": [(e["frame"], e["ba_s"], e["rebuild_s"])
                        for e in run_events],
        "consumer_waits": [p.consumer_waits for p in pipes],
        "pipeline_frames": [len(p) for p in pipes],
        "k7_window_launches": launches,
        "kernel_launches_expected": expected,
        "launches_formula": f"{result['frames']} resumed frames + {fused} "
                            f"keyframes fused by full rebuilds + 2 x "
                            f"{moves} moves",
        "ba_modes": [e["rebuild_mode"] for e in run_events],
        "keyframe_frames": kf_frames, "loop_edges": loop_edges,
        "checkpoint": {"library_bytes": library["checkpoint_bytes"],
                       "library_save_s": library["save_s"],
                       "library_load_s": library["load_s"],
                       "run_bytes": ck_bytes, "run_load_s": run_load_s,
                       "reload_int_state_exact": reload_exact},
        "render": render, "ply_points": len(pts), "mesh_vertices": len(verts),
        "info": {k: v for k, v in info.items() if k != "config"},
        "evaluate": ev, "fixture": fixture, "demo": demo,
        "codec_calls": codec, "fixture_codec_calls": fixture_codec,
        "peak_mem_bytes": peak, "jax_reference": ref,
        "jax_reference_fixture": JAX_REFERENCE_FIXTURE,
    })
    _require(library["reload_int_state_exact"],
             "library checkpoint reloads bit-exact")
    _require(sorted(result) == sorted(ref["result_keys"]),
             "run JSON keys equal the JAX CLI's")
    _require(result["frames"] == ref["resumed_frames"],
             "the run resumed after the library's frames")
    _require(result["tracked_frames"] >= result["frames"] - 1,
             "tracked >= all but 1")
    _require(ate < 2.0 * ref["ate_mm"], "unaligned ATE < 2x the JAX figure")
    _require(abs(kf_diff) <= 1, "keyframes within one of the JAX run's")
    _require(abs(loop_edges - ref["loop_edges"])
             <= CLI_LOOP_EDGE_SLACK * max(abs(kf_diff), 1),
             "loop edges within one keyframe's batch of the JAX run's")
    _require(launches == expected, "K7 (window gather) launches == resumed "
             "frames + rebuild fuses + 2 x moves")
    _require(result.get("live_frames") == ref["live_frames"], "live views")
    _require(reload_exact, "the run's checkpoint reloads bit-exact")
    _require(len(render["frames"]) == 3 and min(pngs) > 0, "orbit renders")
    _require(render["ply"]["points"] == len(pts) > 0
             and np.isfinite(pts).all(), "point cloud non-empty, finite")
    _require(render["mesh"]["faces"] > 0 and len(verts) > 0
             and np.isfinite(verts).all(), "mesh non-empty, finite")
    _require(info["frames_processed"] == len(depths)
             and info["graph"]["keyframes"] == result["keyframes"],
             "info reads the run's checkpoint")
    # the trajectory and ground-truth files hold six decimals; the run's
    # JSON rounds to five
    _require(ev["pairs"] == len(depths) and abs(
        ev["ate_rmse_unaligned_m"] - result["ate_rmse_unaligned_m"])
        < 2e-5, "evaluate's ATE equals the run's")
    fref = JAX_REFERENCE_FIXTURE
    _require(sorted(fixture) == sorted(fref["result_keys"])
             and fixture["frames"] == 8
             and fixture["tracked_frames"] >= fref["tracked"]
             and np.isfinite(fix_traj).all()
             and fixture["ate_rmse_m"] * 1e3 < 2.0 * fref["ate_aligned_mm"],
             "fixture run tracks as the JAX CLI (aligned ATE < 2x)")
    # demo: the ICP of two real frames within 1 mm of the JAX package's,
    # the fused map within 1 % of its blocks
    _require(abs(demo["occupied_blocks"] - fref["demo_occupied_blocks"])
             <= 0.01 * fref["demo_occupied_blocks"]
             and np.allclose(demo["relative_translation_m"],
                             fref["demo_translation_m"], atol=1e-3),
             "demo on two fixture files as the JAX CLI")
    _require(fixture_codec["batch"] >= 1 and fixture_codec["native"] >= 2
             and codec["python"] == 0,
             "the native codec decoded every frame")
    # more ranks than cards over NCCL: refused, naming both counts
    cards = torch.cuda.device_count()
    try:
        cli.main(["run", "--synthetic", "2", "--devices", str(cards + 1)])
        refused = ""
    except SystemExit as e:
        refused = str(e)
    _emit({"phase": "cli_devices", "cards": cards, "message": refused})
    _require(f"need {cards + 1} CUDA cards" in refused
             and f"{cards} present" in refused,
             "run --devices N > cards exits naming both counts")
    return launches


def _bench_checks(name: str, out: dict, ref: dict | None) -> dict:
    """A section's line against its key set and the JAX run on the same
    frames: {check: bool}, and the decisions outside their slack."""
    fps = {k: v for k, v in out.items() if k.startswith("fps")}
    ates = {k: v for k, v in out.items() if k.startswith("ate_")}
    checks = {
        "keys": set(out) == BENCH_KEYS[name],
        "fps": all(np.isfinite(v) and v > 0 for v in fps.values()),
        "ate_finite": all(np.isfinite(v) for v in ates.values()),
    }
    off = {}
    if ref is not None:
        for k, want in ref.items():
            if k.startswith("ate_"):
                continue
            got = out[k]
            if isinstance(want, bool) or not isinstance(want, (int, float)):
                same = got == want
            else:
                tol = BENCH_SLACK.get(k, 0)
                if k in BENCH_BLOCK_COUNTS:
                    tol = BENCH_BLOCK_RTOL * want
                same = abs(got - want) <= tol
            if not same:
                off[k] = [got, want]
        checks["decisions"] = not off
        checks["ate_below_2x_jax"] = all(
            ates[k] < 2.0 * ref[k] for k in ates if k in ref)
    return {"checks": checks, "decisions_off": off}


def phase_bench(torch, card: str) -> int:
    """The benchmark twin on the card: ``cli.main(["bench", "--quick"])``
    in this process, every section of voxelhashing_demo_tpu_torch/bench.py
    at ``BENCH_SECTIONS``' cut frame counts (full 640x480 width), then
    ``_long_run`` at ``BENCH_GATHER`` under flagship_gather_config() with
    K7's window-gather launches counted from 0.  Returns those launches."""
    from voxelhashing_demo_tpu_torch import bench, cli
    from voxelhashing_demo_tpu_torch.config import (flagship_config,
                                                    flagship_gather_config)
    from voxelhashing_demo_tpu_torch.models import hash_slam
    from voxelhashing_demo_tpu_torch.ops import hash_ops
    from voxelhashing_demo_tpu_torch.tools.probe import integrate_check
    from voxelhashing_demo_tpu_torch.utils import metrics, synthetic

    t0 = time.perf_counter()
    quick = cli_json(cli, ["bench", "--quick"])
    quick_s = time.perf_counter() - t0
    failed = []
    if not (set(quick) == BENCH_KEYS["quick"] | {"detail"}
            and quick["detail"] == {"device": card} and quick["value"] > 0):
        failed.append("quick")

    cfg = flagship_config()
    sections = {}
    for name, (fn, kw) in BENCH_SECTIONS.items():
        args = (cfg, hash_slam, synthetic) + (
            () if fn == "_stage_breakdown" else (metrics,))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = getattr(bench, fn)(*args, **kw)
        ref = None if name == "stages" else JAX_REFERENCE_BENCH[name]
        sections[name] = {
            "args": kw, "out": out,
            "seconds": time.perf_counter() - t0,
            "peak_mem_bytes": int(torch.cuda.max_memory_allocated()),
            "jax_reference": ref, **_bench_checks(name, out, ref)}
        if name == "stages" and not all(v >= 0 for v in out.values()):
            sections[name]["checks"]["stages_nonnegative"] = False
        if not all(sections[name]["checks"].values()):
            failed.append(name)

    # the gather run: K7 in the window mode on every step, counted from 0,
    # and against the plain integrate on the depth and pose of the last
    # call (the last frame's integrate)
    calls = {"step": 0}
    last = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    zero_k7_window()
    with _wrapped(hash_slam, "step", _counted(calls, "step")), \
            _wrapped(hash_ops, "integrate", _recorded(last)):
        out = bench._long_run(flagship_gather_config(), hash_slam,
                              synthetic, metrics, **BENCH_GATHER)
    launches = k7_window()
    seconds = time.perf_counter() - t0
    n = BENCH_GATHER["num_frames"]
    expected = 2 * n + 1 + BENCH_GATHER["chunk"]
    hmap, _, hcfg, depth, pose, cam, fusion = last
    check = integrate_check(hmap, hcfg, cam, fusion, depth, pose)
    gather = {
        "args": BENCH_GATHER, "out": out, "seconds": seconds,
        "peak_mem_bytes": int(torch.cuda.max_memory_allocated()),
        "steps": calls["step"], "k7_window_launches": launches,
        "launches_formula": f"2 x {n} frames + 1 + {BENCH_GATHER['chunk']}"
                            " (per-frame run, warm chunk, chunked run)",
        "k7_rows": check["rows"], "k7_bit_exact": check["bit_exact"],
        "jax_reference": JAX_REFERENCE_BENCH["gather"],
        **_bench_checks("long_run", out, JAX_REFERENCE_BENCH["gather"])}
    _emit({"phase": "bench", "card": card, "H": H, "W": W,
           "quick": quick, "quick_s": quick_s, "sections": sections,
           "gather": gather, "failed": failed})
    _require(not failed, f"bench sections {failed}: keys, fps > 0, finite "
             "ATE, decisions and ATE < 2x the JAX run's")
    _require(all(gather["checks"].values()),
             "bench gather run: keys, fps, decisions and ATE vs JAX")
    _require(calls["step"] == expected and launches == expected,
             "K7 (window gather) launched once per frame step of the "
             "gather run")
    _require(gather["k7_bit_exact"] and check["rows"] > 0,
             "K7 == plain integrate on the last call's rows")
    return launches


# The entry points of entry.py and the speed-of-light tools (tools/).
N_ENTRY = 3          # entry()'s zero frame, then the first sweep frames


def _all_finite(values) -> bool:
    return all(isinstance(v, float) and np.isfinite(v) for v in values)


def phase_entry(torch, card: str, sweep) -> None:
    """``entry()`` on the card: its ``fn`` on the zero frame it returns,
    then the first sweep frames, each step timed (host clock, the card
    synchronised)."""
    from voxelhashing_demo_tpu_torch import entry

    fn, (state, depth) = entry.entry()
    frames = [depth] + [torch.from_numpy(d.astype(np.int32)).cuda()
                        for d in sweep[:N_ENTRY - 1]]
    steps = []
    for d in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, info = fn(state, d)
        torch.cuda.synchronize()
        steps.append({"ms": (time.perf_counter() - t0) * 1e3,
                      "pose_finite": bool(torch.isfinite(info.pose).all()),
                      "blocks_allocated": int(info.blocks_allocated),
                      "tracked": bool(info.tracked)})
    _emit({"phase": "entry", "card": card, "device": str(depth.device),
           "depth_dtype": str(depth.dtype), "steps": steps,
           "frame_idx": state.frame_idx})
    _require(depth.is_cuda and not bool(depth.any()),
             "entry() gives a zero frame on the card")
    _require(all(s["pose_finite"] for s in steps), "entry poses finite")
    _require(all(s["blocks_allocated"] > 0 for s in steps[1:]),
             "entry's fn allocates blocks on the sweep frames")
    _require(state.frame_idx == N_ENTRY, "entry's fn counts its frames")


def phase_dryrun(torch, card: str) -> None:
    """``dryrun_multichip(1)`` on one NCCL rank, then
    ``dryrun_multichip(2, backend="gloo")`` with both ranks on the card;
    each raises if a check fails or the ranks disagree."""
    from voxelhashing_demo_tpu_torch import entry

    runs = {}
    for name, n, backend in (("nccl_1", 1, None), ("gloo_2", 2, "gloo")):
        t0 = time.perf_counter()
        outs = entry.dryrun_multichip(n, backend=backend)
        runs[name] = {"ranks": n, "result": outs[0],
                      "seconds": time.perf_counter() - t0}
    _emit({"phase": "dryrun", "card": card, **runs})


def _roofline_ok(result: dict) -> bool:
    from voxelhashing_demo_tpu_torch.tools import roofline

    return (tuple(result["stages_ms"]) == roofline.STAGES
            and result["n_active_blocks"] > 0
            and _all_finite(result["primitives"].values())
            and _all_finite(result["stages_ms"].values())
            and _all_finite(result["bounds_ms"].values())
            and all(v > 0 for v in result["stages_ms"].values()))


def _roofline_hbm(roofline, config, result: dict) -> dict:
    """The roofline model's data volumes at the card's HBM rate (its
    ``bounds_model`` fed HBM_BYTES_PER_S in place of the eager primitives'
    rates: a gathered element 4 bytes, a scattered one 8, value and
    index), and each stage's % of that bound."""
    gbps = HBM_BYTES_PER_S / 1e9
    elem_ns = 4 / gbps
    prim = {"gather_random_ns_per_elem": elem_ns,
            "gather_image_ns_per_elem": elem_ns,
            "gather_rows_GBps": gbps, "elementwise_GBps": gbps,
            "scatter_min_256k_ms": (1 << 18) * 8 / HBM_BYTES_PER_S * 1e3}
    bounds = roofline.bounds_model(config, prim, result["n_active_blocks"])
    stages = result["stages_ms"]
    return {"hbm_bounds_ms": bounds,
            "pct_of_hbm_bound": {k: 100 * b / stages[k]
                                 for k, b in bounds.items()}}


def phase_roofline(torch, card: str) -> int:
    """``roofline.main()`` under flagship_config() (the window gather off,
    as the JAX tool), then under flagship_gather_config(), K7's
    window-gather launches counted from 0 in each, and K7 against the
    plain integrate on the depth and pose of the second run's last call
    (the last full step's integrate).  Returns the second run's
    launches."""
    from voxelhashing_demo_tpu_torch.config import (flagship_config,
                                                    flagship_gather_config)
    from voxelhashing_demo_tpu_torch.ops import hash_ops
    from voxelhashing_demo_tpu_torch.tools import roofline
    from voxelhashing_demo_tpu_torch.tools.probe import integrate_check

    runs, launches, last = {}, {}, []
    t0 = time.perf_counter()
    for name, cfg in (("flagship", flagship_config()),
                      ("flagship_gather", flagship_gather_config())):
        zero_k7_window()
        with contextlib.redirect_stdout(io.StringIO()), \
                _wrapped(hash_ops, "integrate", _recorded(last)):
            runs[name] = roofline.main(config=cfg)
        launches[name] = k7_window()
        runs[name].update(_roofline_hbm(roofline, cfg, runs[name]))
    seconds = time.perf_counter() - t0
    _require(last, "integrate called on the gather roofline")
    hmap, _, hcfg, depth, pose, cam, fusion = last
    check = integrate_check(hmap, hcfg, cam, fusion, depth, pose)
    n = roofline.N_CALLS
    expected = roofline.SWEEP_FRAMES + 2 * (n + 1)
    _emit({"phase": "roofline", "card": card, **runs,
           "k7_window_launches": launches,
           "k7_expected": f"{expected} = {roofline.SWEEP_FRAMES} sweep "
                          f"frames + {n + 1} integrate + {n + 1} full_step",
           "k7_rows": check["rows"], "k7_bit_exact": check["bit_exact"],
           "seconds": seconds})
    _require(all(_roofline_ok(r) for r in runs.values()),
             "roofline: the seven stages, finite primitives and bounds")
    _require(launches["flagship"] == 0
             and launches["flagship_gather"] == expected,
             "K7 (window gather) on every integrate of the gather "
             "roofline, never without")
    _require(check["bit_exact"] and check["rows"] > 0,
             "K7 == plain integrate on the roofline's last call")
    return launches["flagship_gather"]


def phase_bench_micro(torch, card: str) -> None:
    """``bench_micro.measure()``: the sixteen primitives, host ms and
    device ms (CUDA-graph replay)."""
    from voxelhashing_demo_tpu_torch.tools import bench_micro

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out = bench_micro.measure()
    _emit({"phase": "bench_micro", "card": card, "ops": out,
           "seconds": time.perf_counter() - t0})
    _require(len(out) == 16 and _all_finite(
        [v["ms"] for v in out.values()]
        + [v["device_ms"] for v in out.values()]),
        "bench_micro: sixteen ops, finite host and device ms")


def phase_scaling(torch, card: str) -> None:
    """``scaling_bench`` at 640x480 over the cards present (NCCL, a card
    per rank); with one card, two Gloo ranks on it as a line of its own,
    marked as sharing the card."""
    from voxelhashing_demo_tpu_torch.tools import scaling_bench

    cards = torch.cuda.device_count()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        lines = scaling_bench.main(["--max-devices", str(cards)])
    if cards == 1:
        fps = scaling_bench.run_count(2, backend="gloo")
        lines.append({"devices": 2, "fps": fps,
                      "efficiency_vs_1": fps / (lines[0]["fps"] * 2),
                      "backend": "gloo", "shared_card": True})
    _emit({"phase": "scaling", "card": card, "cards": cards,
           "lines": lines, "seconds": time.perf_counter() - t0})
    _require(lines and lines[0]["devices"] == 1
             and all(ln["fps"] > 0 for ln in lines),
             "scaling: a line per count, fps > 0")


# The multi-device phases.  One card: two ranks share it over Gloo (each
# collective's CUDA tensors cross the host), and a one-rank NCCL
# group runs the same step as the reference partition.  Why the reference
# is a one-rank mesh and not the single-card HashSLAM: the sharded step
# (the JAX package's parallel/sharded.py) pools the coarse ICP source by
# its minimum where the single-device step averages, and recomputes the
# target normals from the gathered model depth, so it is not the
# single-device step; the single-card run is printed beside it.
SHARDED_TIMEOUT_S = 600
SHARDED_POSE_ATOL_M = 5e-4
N_SHARDED_BACKEND = 24


def _rank_ms(outs, key="frame_ms") -> list:
    return [{"p50": float(np.percentile(o[key], 50)),
             "max": float(np.max(o[key]))} for o in outs]


def _key_set(keys) -> set:
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    keys = np.asarray(keys)
    return set(keys[keys != int(hash_ops.EMPTY_KEY)].tolist())


def _collectives_ok(outs) -> bool:
    """``ranks.collectives`` of every rank against numpy: exact."""
    xs = [o["x"] for o in outs]
    rows = np.concatenate([o["rows"] for o in outs])
    n = len(outs)
    return all(
        np.array_equal(o["psum"], sum(xs[1:], xs[0]))
        and np.array_equal(o["psum_int"],
                           sum((p["ints"] for p in outs[1:]), outs[0]["ints"]))
        and np.array_equal(o["pmin"], np.minimum.reduce(xs))
        and np.array_equal(o["tiled"], np.concatenate(xs))
        and np.array_equal(o["fetch"], np.concatenate(xs))
        and np.array_equal(o["stacked"], np.stack(xs))
        and np.array_equal(o["gather_concat"], rows)
        and np.array_equal(o["gather_many"]["a"], rows)
        and o["psum_host"] == sum(r + 7 for r in range(n))
        and np.array_equal(o["owner_mask"],
                           np.arange(2 * n) % n == o["rank"])
        for o in outs)


def phase_nccl(torch, frames) -> dict:
    """One rank over NCCL: the collective helpers, then ShardedHashSLAM on
    the slice's frames (the reference partition of ``sharded``)."""
    from voxelhashing_demo_tpu_torch.config import flagship_gather_config
    from voxelhashing_demo_tpu_torch.parallel import launch, ranks

    (coll,) = launch.spawn(ranks.collectives, 1, "nccl", "cuda",
                           SHARDED_TIMEOUT_S, 5)
    helpers_ok = _collectives_ok([coll]) and coll["host_bytes"] == 0
    (one,) = launch.spawn(ranks.run_slam, 1, "nccl", "cuda",
                          SHARDED_TIMEOUT_S, flagship_gather_config(),
                          frames, None, (), True)
    _emit({"phase": "nccl", "backend": coll["backend"],
           "helpers_ok": helpers_ok, "frames": len(one["infos"]),
           "frame_ms": _rank_ms([one])[0],
           "collectives_per_frame": one["collectives_per_frame"],
           "launches": sum(one["launches"]),
           "icp_launches": one["icp_launches"],
           "fuse_launches": one["fuse_launches"],
           "alloc_launches": one["alloc_launches"],
           "peak_mem_bytes": one["peak_mem_bytes"]})
    _require(coll["backend"] == "nccl" and helpers_ok,
             "NCCL group initializes; its collective helpers agree")
    _require(all(k > 0 for k in one["launches"]),
             "K7 (window gather) launched on every frame over NCCL")
    _require(one["icp_launches"][1] > 0,
             "K4s launched over NCCL (the sharded level's systems)")
    _require(min(one["splat_launches"]) > 0, "K8 and K9 launched over NCCL")
    _require(min(one["fuse_launches"]) > 0, "K6 and K7 launched over NCCL")
    _require(min(one["alloc_launches"]) > 0, "K5a and K5b launched over "
                                             "NCCL")
    return one


def phase_sharded(torch, card: str, frames, gt, one) -> tuple:
    """Two ranks on the one card over Gloo at flagship_gather_config():
    see the module docstring.  Returns rank 0's K7 window-gather launches
    and its [K4, K4s, K3a, K3b, K8, K9, K6, K7] launches."""
    from voxelhashing_demo_tpu_torch.config import flagship_gather_config
    from voxelhashing_demo_tpu_torch.models import hash_slam
    from voxelhashing_demo_tpu_torch.parallel import launch, ranks
    from voxelhashing_demo_tpu_torch.utils import metrics

    cfg = flagship_gather_config()
    coll = launch.spawn(ranks.collectives, 2, "gloo", "cuda",
                        SHARDED_TIMEOUT_S, 5)
    two = launch.spawn(ranks.run_slam, 2, "gloo", "cuda", SHARDED_TIMEOUT_S,
                       cfg, frames, None, (), True)
    single = hash_slam.HashSLAM(cfg)
    for d in frames:
        single.process(d)
    s_poses = [p.cpu().numpy() for p in single.trajectory]
    s_keys = _key_set(single.state.hmap.keys.cpu().numpy())
    a = two[0]
    poses = [i["pose"] for i in a["infos"]]
    counts = {k: [[int(i[k]) for i in o["infos"]] for o in (a, one)]
              for k in ("blocks_allocated", "blocks_active")}
    same_counts = all(c[0] == c[1] for c in counts.values())
    pose_diff = max(float(np.abs(p[:3, 3] - i["pose"][:3, 3]).max())
                    for p, i in zip(poses, one["infos"]))
    single_diff = max(float(np.abs(p[:3, 3] - q[:3, 3]).max())
                      for p, q in zip(poses, s_poses))
    replicated = all(np.array_equal(x["pose"], y["pose"])
                     for x, y in zip(a["infos"], two[1]["infos"]))
    sets = [_key_set(o["state"]["hmap.keys"]) for o in two]
    one_keys = _key_set(one["state"]["hmap.keys"])
    hit = float(np.concatenate([o["hit_rows"] for o in two]).mean())
    ate = metrics.ate_rmse(poses, gt, align=False) * 1e3
    ate_single = metrics.ate_rmse(s_poses, gt, align=False) * 1e3
    launches = [sum(o["launches"]) for o in two]
    helpers_ok = _collectives_ok(coll) and all(o["host_bytes"] > 0
                                               for o in coll)
    _emit({"phase": "sharded", "ranks": 2, "backend": "gloo",
           "collective_helpers_ok": helpers_ok,
           "note": "two ranks share one card; Gloo moves each "
                   "collective's CUDA tensors through host memory",
           "card": card,
           "frames": len(frames), "tracked": sum(bool(i["tracked"])
                                                 for i in a["infos"]),
           "ate_mm": ate, "ate_single_card_mm": ate_single,
           "ate_nccl_one_rank_mm": metrics.ate_rmse(
               [i["pose"] for i in one["infos"]], gt, align=False) * 1e3,
           "counts_equal_one_rank": same_counts,
           "counts": counts["blocks_allocated"][0],
           "counts_single_card": [int(i.blocks_allocated)
                                  for i in single.infos],
           "max_pose_diff_one_rank_m": pose_diff,
           "max_pose_diff_single_card_m": single_diff,
           "replicated_bit_identical": replicated,
           "keys_per_rank": [len(x) for x in sets],
           "keys_single_card": len(s_keys),
           "hit_frac": hit, "launches_per_rank": launches,
           "icp_launches_per_rank": [o["icp_launches"] for o in two],
           "fuse_launches_per_rank": [o["fuse_launches"] for o in two],
           "alloc_launches_per_rank": [o["alloc_launches"] for o in two],
           "kernel_check": [o["kernel"] for o in two],
           "frame_ms_per_rank": _rank_ms(two),
           "collective_host_bytes_per_frame":
               [o["collective_host_bytes_per_frame"] for o in two],
           "collectives_per_frame": [o["collectives_per_frame"]
                                     for o in two],
           "peak_mem_bytes_per_rank": [o["peak_mem_bytes"] for o in two]})
    _require(helpers_ok, "Gloo collective helpers on CUDA tensors exact")
    _require(same_counts, "per-frame allocated / active blocks equal to "
                          "the one-rank run's")
    _require(pose_diff <= SHARDED_POSE_ATOL_M,
             "poses within 5e-4 m of the one-rank run's")
    _require(replicated, "replicated poses bit-identical on both ranks")
    _require(ate < ATE_BOUND_MM, f"unaligned ATE < {ATE_BOUND_MM} mm")
    _require(not (sets[0] & sets[1]) and sets[0] | sets[1] == one_keys,
             "rank key sets disjoint, union == the one-rank map's")
    _require(hit > HIT_BOUND, f"render hit fraction > {HIT_BOUND}")
    _require(launches == [len(frames)] * 2
             and all(o["launches"] == [1] * len(frames) for o in two),
             "K7 (window gather) launched once per frame on each rank")
    _require(all(o["kernel"]["bit_exact"] and o["kernel"]["rows"] > 0
                 for o in two),
             "K7 bit-exact against the plain integrate on each rank's own "
             "rows")
    _require(all(o["icp_launches"][1] > 0 for o in two),
             "K4s launched on each rank (the sharded level's systems)")
    _require(all(min(o["splat_launches"]) > 0 for o in two),
             "K8 and K9 launched on each rank")
    _require(all(min(o["fuse_launches"]) > 0 for o in two),
             "K6 and K7 launched on each rank")
    _require(all(min(o["alloc_launches"]) > 0 for o in two),
             "K5a and K5b launched on each rank")
    return (launches[0], a["icp_launches"] + a["k3_launches"]
            + a["splat_launches"] + a["fuse_launches"]
            + a["alloc_launches"] + a["maint_launches"]
            + a["march_launches"] + a["dense_launches"])


def phase_sharded_backend(torch, card: str) -> tuple:
    """KeyframeSLAM(mesh) on two Gloo ranks over the first
    N_SHARDED_BACKEND frames of the backend scenario (the drift before
    frame 18), against a one-rank NCCL mesh and the single-card backend.
    Returns rank 0's K7 window-gather launches and its [K4, K4s, K3a,
    K3b, K8, K9, K6, K7] launches."""
    from voxelhashing_demo_tpu_torch.geometry import se3
    from voxelhashing_demo_tpu_torch.models import keyframe_slam
    from voxelhashing_demo_tpu_torch.parallel import launch, ranks
    from voxelhashing_demo_tpu_torch.utils import metrics, synthetic

    cfg = backend_config()
    depths, gt = synthetic.make_room_sweep(
        cfg.camera, N_BACKEND, sweep_deg=BACKEND_SWEEP_DEG, noise_seed=1)
    depths = [np.asarray(d) for d in depths[:N_SHARDED_BACKEND]]
    gt = gt[:N_SHARDED_BACKEND]
    inject = {}
    for i, tw in BACKEND_INJECT.items():
        if i < N_SHARDED_BACKEND:
            tw = np.array(tw, np.float32)
            tw[3:] = np.deg2rad(tw[3:])
            inject[i] = se3.exp(torch.as_tensor(tw)).numpy()
    two = launch.spawn(ranks.run_keyframe, 2, "gloo", "cuda",
                       SHARDED_TIMEOUT_S, cfg, depths, inject, True)
    (one,) = launch.spawn(ranks.run_keyframe, 1, "nccl", "cuda",
                          SHARDED_TIMEOUT_S, cfg, depths, inject, True)
    single = keyframe_slam.KeyframeSLAM(cfg)
    backend_drive(torch, single, depths)
    s_traj = single.trajectory()
    a = two[0]
    decisions = ("keyframe_frames", "edges", "ba_frames", "ba_modes",
                 "moved", "tracked", "capacity", "saturated")
    same = {k: a[k] == one[k] == two[1][k] for k in decisions}
    ate = metrics.ate_rmse(list(a["trajectory"]), gt, align=False) * 1e3
    ate_single = metrics.ate_rmse(s_traj, gt, align=False) * 1e3
    expected = [len(depths) + o["rebuild_fuses"] + 2 * sum(o["moved"])
                for o in two]
    ba_ms = [1e3 * t for t in a["ba_s"]]
    _emit({"phase": "sharded_backend", "ranks": 2, "backend": "gloo",
           "card": card, "frames": len(depths),
           "decisions_equal_one_rank": same,
           "keyframes": len(a["keyframe_frames"]),
           "keyframes_single_card": len(single.keyframes),
           "edges": len(a["edges"]),
           "loop_edges": sum(1 for e in a["edges"] if e[1] - e[0] > 1),
           "ba_modes": a["ba_modes"], "moved": a["moved"],
           "ba_modes_single_card": [e["rebuild_mode"]
                                    for e in single.ba_events],
           "ate_mm": ate, "ate_single_card_mm": ate_single,
           "launches_per_rank": [o["launches"] for o in two],
           "launches_expected": expected,
           "icp_launches_per_rank": [o["icp_launches"] for o in two],
           "fuse_launches_per_rank": [o["fuse_launches"] for o in two],
           "alloc_launches_per_rank": [o["alloc_launches"] for o in two],
           "pg_launches_per_rank": [o["pg_launches"] for o in two],
           "ba_ms_per_solve": ba_ms,
           "collective_host_bytes_per_frame":
               [o["collective_host_bytes_per_frame"] for o in two]})
    _require(all(same.values()),
             "decisions equal on both ranks and to the one-rank NCCL run")
    _require(ate < 2.0 * ate_single, "ATE below twice the single card's")
    _require([o["launches"] for o in two] == expected,
             "K7 (window gather) launches == frames + rebuild fuses + 2 x "
             "moves per rank")
    _require(all(n > 0 for o in two for n in o["icp_launches"]),
             "K4 (pair-ICP batches) and K4s (the sharded level) launched "
             "on each rank")
    _require(all(min(o["splat_launches"]) > 0 for o in two),
             "K8 and K9 launched on each rank")
    _require(all(min(o["fuse_launches"]) > 0 for o in two),
             "K6 and K7 launched on each rank")
    _require(all(min(o["alloc_launches"]) > 0 for o in two),
             "K5a and K5b launched on each rank")
    _require(all(o["pg_launches"][0] > 0 and o["pg_launches"][2] > 0
                 for o in two),
             "K13a and K13c launched on each rank (the sharded BA)")
    _require(all(o["maint_launches"][0] > 0 for o in two),
             "K10 launched on each rank (GC at frame 15)")
    return (a["launches"], a["icp_launches"] + a["k3_launches"]
            + a["splat_launches"] + a["fuse_launches"]
            + a["alloc_launches"] + a["maint_launches"]
            + a["march_launches"] + a["dense_launches"], a["pg_launches"])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; none is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from voxelhashing_demo_tpu_torch import kernels
    from voxelhashing_demo_tpu_torch.ops import hash_ops
    from voxelhashing_demo_tpu_torch.ops import window_gather as wg

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _emit({"phase": "device", "name": name, "nvidia_smi": smi,
           "count": torch.cuda.device_count(),
           "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    built = kernels.build_all()
    for lib in kernels.KERNELS:
        kernels.function(lib)
    _emit({"phase": "build", "kernels": sorted(built),
           "seconds": time.perf_counter() - t0})

    from voxelhashing_demo_tpu_torch.config import flagship_gather_config

    march_cfg, sweep, sweep_gt = room_sweep()
    rows, worst = phase_kernel(torch, wg, step_rows(
        flagship_gather_config(), sweep[:N_STEP_FRAMES]))
    probe_launches, probes = phase_probes(torch, wg)
    icp_summary = phase_icp(torch, smi, sweep)
    k3_summary = phase_preprocess(torch, smi, sweep)
    splat_summary = phase_splat(torch, smi, sweep)
    fuse_summary = phase_fuse(torch, smi, sweep)
    alloc_summary = phase_alloc(torch, smi, sweep)
    # launches per path, each counted from 0 by the phase that drives it;
    # "launches" in the summary is the last path's count.  K1 runs on no
    # frame path since K7 took over its work: the frame paths' window
    # gathers are K7's window-mode launches (``window_by_path``)
    by_path = {k: {"probes": n} for k, n in probe_launches.items()}
    step_kernels = (ICP_KERNELS + K3_KERNELS + SPLAT_KERNELS + FUSE_KERNELS
                    + ALLOC_KERNELS + MAINT_KERNELS + MARCH_KERNELS
                    + DENSE_KERNELS)
    by_path.update({k: {} for k in step_kernels + PG_KERNELS})
    window_by_path = {}

    def k4(path: str, run):
        """``run()`` with the ICP, K3, splat, fuse and allocation kernels'
        counts from 0, recorded under ``path``; the frame step
        preprocesses, its pyramid tracks, it allocates and it fuses on
        every path, so K4, K3a, K3b, K5a, K5b, K6 and K7 must launch (K4s
        serves only the sharded level), and K8 and K9 on every path that
        predicts by splatting (all but ``march``, where neither may);
        K11 and K12 on ``march`` and on no other path.  The dense step
        (``dense``) preprocesses, packs its model (K3b), tracks (K4),
        fuses (K20) and raycasts (K11): K5a-K10 and K12-K15 must not
        launch there, and K20 on no other path."""
        zero_icp_launches()
        zero_k3_launches()
        zero_splat_launches()
        zero_fuse_launches()
        zero_alloc_launches()
        zero_maint_launches()
        set_march_launches()
        set_dense_launches()
        set_pg_launches()
        with MaintCalls(hash_ops) as calls:
            out = run()
        counts = (icp_launches() + k3_launches() + splat_launches()
                  + fuse_launches() + alloc_launches() + maint_launches()
                  + march_launches() + dense_launches())
        for kname, n in zip(step_kernels, counts):
            by_path[kname][path] = n
        pg = pg_launches()
        for kname, n in zip(PG_KERNELS, pg):
            by_path[kname][path] = n
        if path in BA_PATHS:
            _require(pg[0] > 0 and pg[1] + pg[2] > 0,
                     f"K13a and K13b or K13c launched on {path}")
        elif path in NO_BA_PATHS:
            _require(pg == [0, 0, 0], f"no K13 launch on {path}")
        _require(counts[0] > 0, f"K4 launched on {path}")
        _require(counts[2] > 0 and counts[3] > 0,
                 f"K3a and K3b launched on {path}")
        if path == "dense":
            _require(counts[4:13] == [0] * 9 and counts[14] == 0,
                     "no K5a-K10 or K12-K15 launch on dense (no hash map)")
            _require(counts[13] > 0 and counts[15] > 0,
                     "K11 and K20 launched on dense")
            return out
        _require(counts[15] == 0, f"no K20 launch on {path}")
        if path == "march":
            _require(counts[4:6] == [0, 0], "no K8 / K9 launch on march")
            _require(min(counts[13:15]) > 0, "K11 and K12 launched on march")
        else:
            _require(min(counts[4:6]) > 0, f"K8 and K9 launched on {path}")
            _require(counts[13:15] == [0, 0],
                     f"no K11 / K12 launch on {path} (splat mode)")
        _require(min(counts[6:8]) > 0, f"K6 and K7 launched on {path}")
        _require(min(counts[8:10]) > 0, f"K5a and K5b launched on {path}")
        _require(counts[10:13] == calls.list(),
                 f"K10, K14 and K15 once a garbage_collect, evict_stale "
                 f"and restore_blocks call on the card on {path}")
        for kname, n in zip(MAINT_KERNELS, counts[10:13]):
            if path in MAINT_REQUIRED[kname]:
                _require(n > 0, f"{kname} launched on {path}")
        return out

    k4("parity", lambda: phase_parity(torch))
    window_by_path["slice"] = k4("slice", lambda: phase_slice(torch))
    slam, last_depth, march_window = k4("march", lambda: phase_march(
        torch, smi, march_cfg, sweep, sweep_gt))
    window_by_path["march"] = march_window
    by_path["gather_depth_window_streamed"]["streamed_entry"] = (
        phase_streamed_entry(torch, wg, slam, last_depth))
    del slam
    k4("dense", lambda: phase_dense(torch, smi, sweep, sweep_gt))
    window_by_path["backend"] = k4("backend",
                                   lambda: phase_backend(torch, smi))
    for path, counts in PG_RING_PATHS.items():
        for kname, n in zip(PG_KERNELS, counts):
            by_path[kname][path] = n
    launches, ate_stream, maint_summary = k4(
        "stream", lambda: phase_stream(torch, smi))
    window_by_path["stream"] = launches
    window_by_path["stream_backend"] = k4(
        "stream_backend",
        lambda: phase_stream_backend(torch, smi, ate_stream))
    window_by_path["cli"] = k4("cli", lambda: phase_cli(torch, smi))
    window_by_path["bench"] = k4("bench", lambda: phase_bench(torch, smi))
    k4("entry", lambda: phase_entry(torch, smi, sweep))
    phase_dryrun(torch, smi)
    window_by_path["roofline"] = k4("roofline",
                                    lambda: phase_roofline(torch, smi))
    phase_bench_micro(torch, smi)
    phase_scaling(torch, smi)
    from voxelhashing_demo_tpu_torch.utils import synthetic

    frames, gt = synthetic.make_sequence(
        flagship_gather_config().camera, JAX_REFERENCE["frames"],
        trans_amp=0.05, rot_amp_deg=2.5)
    frames, gt = [np.asarray(d) for d in frames[:N_FRAMES]], gt[:N_FRAMES]
    # rank 0's counts on the multi-rank paths
    one = phase_nccl(torch, frames)
    window_by_path["nccl"] = sum(one["launches"])
    k4_ranks = {"nccl": one["icp_launches"] + one["k3_launches"]
                + one["splat_launches"] + one["fuse_launches"]
                + one["alloc_launches"] + one["maint_launches"]
                + one["march_launches"] + one["dense_launches"]}
    (window_by_path["sharded_backend"], k4_ranks["sharded_backend"],
     pg_sharded) = phase_sharded_backend(torch, smi)
    for kname, n in zip(PG_KERNELS, pg_sharded):
        by_path[kname]["sharded_backend"] = n
    # the slice's main path, last: "launches" is rank 0's count
    window_by_path["sharded"], k4_ranks["sharded"] = (
        phase_sharded(torch, smi, frames, gt, one))
    for path, counts in k4_ranks.items():
        for kname, n in zip(step_kernels, counts):
            by_path[kname][path] = n
        _require(counts[2] > 0 and counts[3] > 0,
                 f"K3a and K3b launched on {path} (rank 0)")
        _require(min(counts[4:6]) > 0, f"K8 and K9 launched on {path} "
                                       f"(rank 0)")
        _require(min(counts[6:8]) > 0, f"K6 and K7 launched on {path} "
                                       f"(rank 0)")
        _require(min(counts[8:10]) > 0, f"K5a and K5b launched on {path} "
                                        f"(rank 0)")
        _require(counts[13:15] == [0, 0], f"no K11 / K12 launch on {path} "
                                          f"(rank 0, splat mode)")
        _require(counts[15] == 0, f"no K20 launch on {path} (rank 0)")

    full = rows["step_rows"]      # the shape the main path gives them
    _emit({"kernels": [{
        "name": kname, **meta,
        "launches": list(by_path[kname].values())[-1],
        "launches_by_path": by_path[kname],
        "max_abs_err": worst[kname],
        "case": full["case"], "C": full["C"], "V": full["V"],
        "ms": full[kname]["ms"],
        "cold_ms": full[kname]["cold_ms"],
        "wrapper_ms": full[kname]["wrapper_ms"],
        "plain_ms": full[kname]["plain_ms"],
        "bound_ms": full["bound_ms"],
        "bound_by": full["bound_by"],
        "library_ms": None,
    } for kname, meta in ((k, KERNEL_META[k]) for k in WINDOW_KERNELS)] + [{
        "name": kname, **KERNEL_META[kname],
        "launches": by_path[kname]["probes"],
        "launches_by_path": by_path[kname],
        **probes[kname],
    } for kname in PROBE_TAGS] + [{
        "name": kname, **ICP_META[kname],
        "launches": [n for n in by_path[kname].values() if n][-1],
        "launches_by_path": by_path[kname],
        **icp_summary[kname],
    } for kname in ICP_KERNELS] + [{
        "name": kname, **K3_META[kname],
        "launches": list(by_path[kname].values())[-1],
        "launches_by_path": by_path[kname],
        **k3_summary[kname],
    } for kname in K3_KERNELS] + [{
        "name": kname, **SPLAT_META[kname],
        "launches": list(by_path[kname].values())[-1],
        "launches_by_path": by_path[kname],
        **splat_summary[kname],
    } for kname in SPLAT_KERNELS] + [{
        "name": kname, **FUSE_META[kname],
        "launches": list(by_path[kname].values())[-1],
        "launches_by_path": by_path[kname],
        **({"launches_window_by_path": window_by_path}
           if kname == "integrate_rows" else {}),
        **fuse_summary[kname],
    } for kname in FUSE_KERNELS] + [{
        "name": kname, **ALLOC_META[kname],
        "launches": list(by_path[kname].values())[-1],
        "launches_by_path": by_path[kname],
        **alloc_summary[kname],
    } for kname in ALLOC_KERNELS] + [{
        "name": kname, **MAINT_META[kname],
        "launches": by_path[kname]["stream"],
        "launches_by_path": by_path[kname],
        **(alloc_summary if kname == "gc_free" else maint_summary)[kname],
    } for kname in MAINT_KERNELS] + [{
        "name": kname, **PG_META[kname],
        "launches": by_path[kname][PG_MAIN_PATH[kname]],
        "launches_by_path": by_path[kname],
        "ptxas": {k: v for k, v in PG_SUMMARY["ptxas"].items()
                  if any(part in k for part in PG_PTXAS[kname])},
        **PG_SUMMARY[kname],
    } for kname in PG_KERNELS] + [{
        "name": kname, **MARCH_META[kname],
        "launches": by_path[kname]["march"],
        "launches_by_path": by_path[kname],
        **MARCH_SUMMARY[kname],
    } for kname in MARCH_KERNELS] + [{
        "name": kname, **DENSE_META[kname],
        "launches": by_path[kname]["dense"],
        "launches_by_path": by_path[kname],
        **DENSE_SUMMARY[kname],
    } for kname in DENSE_KERNELS]})
    _emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
