"""Smoke test of the PyTorch port on one CUDA GPU (an H100 for sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each of which must pass:

1. environment: the card (nvidia-smi name and power limit), torch and CUDA
   versions, and the build of the hand-written kernels from
   toyslam_torch/csrc, one nvcc each, started together (build times and
   ptxas reports);
2. the resident kernel (B1) vs plain PyTorch on the card: one chunk launch
   from the same state at (dp=3, Np=192, Mw=768, L=8), the same with L=0,
   the same with a coarse level (nc=3), at Np=2048 and at multi-loop-1k's
   Np=1088 (L=11, and with a coarse level nc=17 at L=11 and at L=0: the
   bench_fused entry point's coarse variants), each a fresh and a carried
   chunk — ``it`` and ``stop``
   equal, x within 1e-4 of max|x|, r_true and rr within 1e-4 of max|rhs|
   and ||rhs||^2, and a second launch from the same state giving the same
   bits (see compare_chunks) — and both timed;
3. the main path: the 150-pose seeded simulation, the graph build and
   ``GaussNewton(...).optimize`` on the card through B1, checked against
   the reference values of the JAX package (ATE 0.7552 within 2e-3,
   dead-reckoning ATE 6.5673, chi^2 first 228733.5 at rtol 1e-4 and final
   27524.9 at rtol 1e-3) with the launch counts;
4. timing, fenced with torch.cuda.synchronize(): GN-iter/s as the median of
   3 rounds x 20 optimize() calls (cut from 5 with phase 31; phase 29's
   headline times the same path); the time of each layer of one GN
   iteration; one chunk of B1 vs the plain version and its bound (CUDA
   events), on a cluster of 8 and of 16 blocks, and B1's per-phase
   clock64 split;
5. a shape check at robot_steps=2000 (Np=2048): chi^2 decreases and the
   optimized ATE beats dead reckoning, through B1;
6. the band kernel (B2) vs plain PyTorch on the card, a fresh and a
   carried chunk each, held as in phase 2, on seeded systems built so CG
   is far from converged after a chunk: one on the 10k-pose scale path's
   layout and shapes (tile stack [39, 2, 3, 512, 512], one wide landmark,
   L=14, coarse nc=64) and a small one (K=3, wide columns, L=0); B2 and
   its plain version timed on the scale path's own iteration-0 operands
   and on the small system; B2's bound (the stack read on every trip), its
   plan, its per-phase clock64 split, the bytes a trip reads and the
   stack's TB/s and the cost of one grid barrier alone (line
   ``band_phase_split``); and every instantiation's registers and local
   memory, which must be none (line ``band_kernel_attrs``);
7. the scale path: ``make_large_problem(10_000, 10_000, 6, seed=0)`` and
   ``GaussNewton(...).optimize`` with the JAX package's band-10k-cg160
   config on the card through B2 (B1 launched no time), checked against
   the JAX package's f32 plain-PCG values (chi^2 first 10942542 at rtol
   1e-4; final chi^2 6649.81 and ATE 8.7954 within 1 %; dead-reckoning ATE
   53.9930; 80 PCG iterations in each of 15 GN iterations, 120 launches);
8. its timing: GN-iter/s as the median of 2 optimize() rounds, the ms of
   each layer, the host set-up seconds and the device time;
9. both kernels at dp=6 (SE(3) BA) vs their plain versions, held as in
   phase 2 on seeded systems of the BA paths' shapes: B1 at (Np=128,
   Mw=1536, L=7) and (Np=64, Mw=768, L=6), B2 on the band layout of the
   512 x 4096 graph; each timed against its plain version and its bound,
   with the per-phase clock64 split (lines ``ba_b1_phase_split``,
   ``ba_band_phase_split``);
10. the BA path: ``make_ba_problem(128, 512, 24, seed=0)`` with the bench
   suite's fused row through B1, and ``python -m toyslam_torch ba3d`` at
   its defaults (in process, U in shared memory), checked against the JAX
   package's f32 plain-PCG values (``BA_REF``);
11. its timing: GN-iter/s as the median of 3 optimize() rounds, the ms of
   each layer and the device time;
12. the BA scale path: ``make_ba_problem(512, 4096, 24, seed=0)`` with the
   exp_ba512 fused row and its matched-budget row through B2 (B1 launched
   no time), checked against ``BA_REF``;
13. their timing, as in phase 11 but one round (cut from 3 when the
   sharded phases 24-27 lengthened the smoke, and from 2 with phase 31);
14. the plain PCG loop (``pcg_backend="xla"``) on the main path (PCG
   iterations 35, 35, 34, 33, 33, 32, 32, 32, 31, 31 and the phase-3
   values), the 10k scale path (the phase-7 values: they are the JAX
   package's plain-loop ones) and the ba128 BA row (``BA_REF``), each with
   no PCG kernel launch and its GN-iter/s (one timed optimize() each, cut
   from 3 and 2 rounds with phases 24-27) beside the kernel path's;
15. ``python -m toyslam_torch run --solver dense`` in process (ATE 0.7552,
   chi^2 228733.53 -> 27524.9, no launch) and the dense GN-iter/s;
16. the bench suite's two 10k ``schur_grid`` rows (``GRID_CASES``), each
   under pcg_backend "auto" (the gate's decision printed), "fused" (B2
   launched, B1 not) and "xla" (no PCG kernel launch), held to the JAX
   package's
   plain-loop values (``GRID_REF``) and timed;
17. B2 on the grid path: timed on the 10k row's own operands (coarse level
   nc=320) against its plain version and its bound, with its per-phase
   split, and held against its plain version on a seeded system of that
   layout and shapes (fresh, carried, rerun bits); the same at a chunk of
   16 (the plateau-10k rows' chunk);
18. the data of the band-vs-grid cost model (line ``grid_gate_fit``): the
   band operator's build, B2's cost per trip and the plain grid loop's per
   iteration at three layouts, beside the model's prediction (the 100k
   layout's points: phases 22 and 23);
19. the serving path at full width, in this process: ``PyGraphServer`` and
   then ``native_server(backend="torch")`` on a free port with
   ``device="cuda"``; one ``GraphClient`` connection sends the 150-pose graph
   three times and the 2000-pose graph once (each 150-pose answer within
   phase 3's ATE gate, the first two bit-identical, the remote poses equal
   to a local optimize of the decoded graph at 1e-5, 25 B1 launches and no
   plain-version call per request, ``server.error`` None; wall, codec,
   layout and solve ms per request on the lines ``serve_request``), then
   two clients at once, then ``python -m toyslam_torch run --remote`` in
   process against the open port ("remote") and a closed one ("local");
   B1's chunk timed against its plain version and its bound on the decoded
   150-pose and 2000-pose requests' own operands (line ``serve_kernel``);
20. ``run --snapshot --profile`` in process, then ``load_snapshot`` and
   one more optimize of the loaded graph on the card;
21. ``run --live --optimize-every 50 --save-plot`` at 150 steps in process:
   ATE below dead reckoning's, the PNG written (where matplotlib is
   installed), kernel launches > 0, frames/s;
22. the 100k row: the JAX package's ``band-100k-jacobi-cg128``
   (scripts/exp_band100k.py) through ``schur_grid`` and B2 at nc=784, held
   to its recorded chi^2 (``BAND100K_REF``: first at rtol 1e-4, final
   within 1 %, 60 PCG iterations in each of 10 GN iterations), with the
   gate's decision, ``band_device_bytes``, the host set-up seconds,
   GN-iter/s beside the plain grid loop's (medians of 3 rounds),
   ``auto``'s decision held to agree with them where they part by more
   than 10 %, and B2 at that layout timed against its plain version
   and its bound with its per-phase split, plan sweep, the stack's TB/s at
   each chunk and B2's device memory beside the stack (line
   ``band100k_phase_split``), the cost model's data (line
   ``band100k_gate_fit``), and held against its plain version on a seeded
   system of the same shapes; the same (timed, bound, held) at chunks of 10
   and 20 (exp_band100k's cap20 and cap40 rows);
23. the JAX package's plateau-100k-revisit-incr-init row
   (scripts/bench_plateau.py::run_100k_incr, without its chaining): the
   default-noise 100k graph put inside the Gauss-Newton basin by
   ``incremental_init(window=4096, iters_per_prefix=5)`` and optimized
   with 80 ``schur_grid`` iterations under ``pcg_backend="auto"`` (the
   plain grid loop at this stack), held to 1.5 times the JAX package's
   recorded final chi^2; then B2 on that path (``tridiag+coarse``: L=17,
   nc=1568) for 40 iterations twice: at a chunk of 15, held to 1.5 times
   the plain loop's chi^2 at that iteration, and at the config's chunk of
   16 (the route ``auto`` declines), held to end more than 10 % above
   it; one launch timed against its plain version and its bound, the cost
   model's data with tridiag+coarse (line ``incr100k_gate_fit``), and the
   kernel held against its plain version on a seeded system of that
   layout and those shapes.

24. ``dist_edge``: the edge-sharded solve (``toyslam_torch.parallel``)
   through ``python -m toyslam_torch.parallel.launch`` in a subprocess (one
   start of the ranks runs both solves, for this phase and the next), the
   150-pose main path with the JAX package's dryrun_multichip config
   (``DIST_CFG``), at 4 ranks sharing cuda:0 (gloo) and at 1 rank (NCCL):
   every pose within 5e-3 of the single-device plain loop's, ATE 0.7552
   within 2e-3, every rank's bits equal, no PCG kernel launched in any
   rank;
25. ``dist_partition``: the same through the state-partitioned solve;
26. ``dist_partition3d``: the partitioned SE(3) solve at 4 ranks on
   ``make_ba_problem(48, 160, 16, seed=1)`` (``DIST3D_*``): chi^2 within
   1e-4 and dx within 5e-2 of max|dx| of the single-device plain loop in
   float32 on the card, within 1e-8 in float64, and the float64 GN below
   0.3 of the initial ATE, both on the CPU (the SE(3) edges' kernels take
   float32 alone);
27. ``dist_scale``: the partitioned path at full width, the 2048-pose
   workload of SCALING.json (``DIST_SCALE_*``), at 4 ranks, held to the
   single-device plain loop and to the JAX package's partitioned run
   (``PART_REF``), with the boundary fractions and the collectives per PCG
   iteration.
28. ``slab_band_matvec``: the slab band matvec (B3) against its plain
   version on the card at ``Np=10240`` and (W, B) = (64, 256), (320, 512),
   (320, 1024), (576, 512), (576, 1024): within 1e-5 of max|want|, the
   same bits on a rerun, each timed against its plain version and its
   bound, with its share of the bound, the slab GB/s and the device ms of
   its tile launch and of its partial sum;
   then its entry point, ``python -m
   toyslam_torch.scripts.exp_band_kernel``, in process (``main``): the
   correctness check against the numpy oracle and the timing sweep, every
   launch B3's; then the wrapper's host time per call
   (``band_matvec_host``, line ``slab_band_host``).
29. ``bench``: the port's benchmark entry points in process: ``python -m
   toyslam_torch.bench --reps 2 --rounds 2`` (the headline: ATE 0.7552
   within 2e-3 through B1, the card's name and power limit) and ``python
   -m toyslam_torch.scripts.bench_suite --quick`` (the JAX suite's eight
   rows, one timed optimize each: every row's gate and launch expectation,
   multi-loop-1k through B1 and the 10k rows through B2 under ``auto``);
   then B1 on multi-loop-1k's own GN-iteration-0 system (Np=1088, Mw=768,
   L=11, U from L2): the operator within 1e-5 and the chunked solve within
   1e-3 of the plain version's, one chunk timed against its plain version
   and its bound.
30. ``scale_entry``: the port's scale entry points in process, each row
   held to its gate and its launches: ``python -m
   toyslam_torch.scripts.bench_plateau 10k`` (plateau-10k and
   plateau-10k-revisit at full depth through B2), ``bench_huge --rounds
   1`` (100k poses x 100k landmarks at full width, the plain grid loop),
   ``exp_band100k``'s cap20 and cap40 rows on phase 22's graph (B2 at
   chunks 10 and 20), ``bench_fused --reps 1 --rounds 1`` (both workloads,
   all five variants, B1 with and without the coarse level),
   ``exp_ba512``'s fused row (B2 at dp=6) and ``measure_native_baseline
   --rounds 1``; then B1 with the coarse level (nc=3 at Np=192, nc=17 at
   Np=1088, L=8/11 and L=0) on the fused rows' own GN-iteration-0 systems:
   the operator within 1e-5, the solve within 1e-3, one chunk timed
   against its plain version and its bound.
31. ``b1_layouts``: B1 at each of its paths' layouts (``B1_LAYOUTS``: the
   main path, the ba3d defaults and bench row at dp=6, multi-loop-1k, the
   2000-pose request) on a seeded system of that shape, on every schedule
   of its plan that fits (``fused_pcg.B1_SCHEDULES``: the one
   replicated cluster, the split state on one cluster, the card-wide
   grid): each held against its plain version as in
   phase 2, timed in turns against the others and its bound, with its
   clock64 split, its barriers a trip and their floor (line
   ``b1_layout``); the cost of one cluster, grid and block barrier alone
   (line ``b1_barriers``); every instantiation's registers and local
   memory, which must be none but for the cluster schedule at dp=3, held to
   its 8 bytes (line ``b1_kernel_attrs``); and one
   optimize of multi-loop-1k, every launch on the card-wide schedule, held
   to the suite's gate (line ``b1_multi_loop_path``).
32. ``pcr_factor``: the PCR build's kernel (``ops/pcr.py``) on the
   GN-iteration-0 S diagonal and chain coupling of the main path (dp=3,
   Np=192), of the 10k scale path and of the ba128 BA row (dp=6, Np=128),
   and on seeded chains of the multi-loop-1k (Np=1088) and ba3d-defaults
   (dp=6, Np=64) layouts: each held against its plain version in float64
   (within 1e-5 of max|plain| for the alphas, the gammas and binv each),
   the same bits on a rerun, one launch a build (line ``pcr_check``); the
   paths' three timed, device ms (CUDA events, launches queued behind a
   sleeping kernel) and host ms, against the plain version's float32 build
   on the card and the bound (line ``pcr_factor``).
33. ``edges3d``: the SE(3) edges' kernels (``ops/edges3d_kernel.py``) on
   the ba512 rows' graph, with four intrinsics and with the benchmark
   configuration's near plane, at the start and off it: the per-edge
   blocks (the relative-pose edges' with the exact Jacobians and with
   ``A = -I, B = I``) within 1e-5 of the float64 plain version's largest
   entry, the
   relative-pose Jacobians within 1e-5 of each edge's largest against
   ``jacfwd``, the summed robust chi^2 within 1.5e-7, the same bits on a
   rerun, two launches an assembly and a chi^2 (line ``edges3d_check``);
   each launch timed (device ms) against its bound and the plain version's
   float32 evaluation on the card, the registers and local memory of each
   instantiation (line ``edges3d``).
Every path that builds a tridiagonal preconditioner on the card, the plain
PCG loop and the sharded ranks included, builds it with the PCR kernel,
one launch a build: the paths' checks count those launches apart from the
PCG kernels' (``solve_launches``, ``pcr_builds``).  Every SE(3) solve on
the card evaluates its edges with the edges3d kernels, two launches an
assembly and two a chi^2 of the step rejection: the BA paths (phases 10,
12 and 14) hold them to that (``edges3d_launches``).
Each of phases 24-27 prints a ``dist_timing`` line (GN-iter/s at 4 and 1
ranks beside the single-device plain loop, ms per collective) with the
card's name and power limit: ranks that share one card take turns on it,
so none of these is a scaling number.

``python3 chip_smoke.py --only incr100k_diag`` (development, in no default
run) takes the initialised state of phase 23 through 80 iterations six
ways: B2 with a chunk of 16 and of 15, its plain version in its place with
both chunks, the plain grid loop, and B2 with every launch also run through
its plain version from the same state (line ``incr100k_diag_trace``); where
the two x part by more than 1e-3 of max|x|, the plain version runs that
launch again in float64, and each f32 x's distance to it is printed (line
``incr100k_diag_f64``).

``python3 chip_smoke.py --only serve,snapshot`` runs the named phases alone
(the names are those of the ``phase <name>: ok`` lines) for development; it
prints no result line.

The line before the last is ``{"kernels": [...]}`` (per kernel: launches on
its path, largest difference from the plain version, ms, plain_ms,
bound_ms, bound_by, library_ms; the same for B1 and B2 at dp=6, for B2 on
the grid path, at 100k and on the incrementally initialised 100k graph,
for B1 on the serving path at both request sizes and at multi-loop-1k's
Np=1088, for the PCR build at its three layouts under ``by_layout``, with
the launches of each benchmark entry point's row under
``bench`` and of each scale entry point's row under ``scale_entry`` with
the new shapes' times, B1 by schedule under ``schedules`` with each
schedule's launches and its times at the layouts it serves, and for B3 at
each of its five shapes); the last line is
``{"ok": true, "device": {...}}``, printed only when every phase passed.
Without a CUDA device the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNELS = {
    "fused_pcg_chunk": {
        "name": "fused_pcg_chunk",
        "route": "cuda",
        "source": "toyslam_torch/csrc/fused_pcg_chunk.cu",
        "replaces": "toyslam_tpu/ops/fused_pcg.py:344",
    },
    "band_fused_pcg_chunk": {
        "name": "band_fused_pcg_chunk",
        "route": "cuda",
        "source": "toyslam_torch/csrc/band_fused_pcg_chunk.cu",
        "replaces": "toyslam_tpu/ops/fused_pcg.py:524",
    },
    "slab_band_matvec": {
        "name": "slab_band_matvec",
        "route": "cuda",
        "source": "toyslam_torch/csrc/slab_band_matvec.cu",
        "replaces": "scripts/exp_band_kernel.py:36",
    },
    "pcr_factor": {
        "name": "pcr_factor",
        "route": "cuda",
        "source": "toyslam_torch/csrc/pcr_factor.cu",
        "replaces": "none: toyslam_torch/ops/schur.py::build_tridiag_planes_ref",
    },
    "edges3d": {
        "name": "edges3d",
        "route": "cuda",
        "source": "toyslam_torch/csrc/edges3d.cu",
        "replaces": "none: toyslam_torch/ops/residuals3d.py, "
                    "edge_blocks3d.py (eval_odom3d_edges, odom3d_edge_blocks,"
                    " reproj_edge_blocks, eval_reproj_edges)",
    },
}
REL_TOL = 1e-4
# H100 SXM peaks (NVIDIA's data sheet, at 700 W): HBM3 bytes/s and f32
# FLOP/s outside the tensor cores
PEAK_BYTES_S, PEAK_F32_FLOPS = 3.35e12, 67e12
ATE_REF, ATE_TOL = 0.7552, 2e-3
ATE_DR_REF = 6.5673
CHI2_FIRST, CHI2_FINAL = 228733.5, 27524.9
# the scale path: the JAX package's f32 plain-PCG (pcg_backend="xla") run of
# the same config on the same seeded graph.  1 % on the final chi^2 and the
# ATE: truncated PCG (tol 1e-2, cap 80) carries f32 summation-order
# differences into the steps
SCALE_CHI2_FIRST = 10942542.0
SCALE_CHI2_FINAL, SCALE_ATE, SCALE_REL = 6649.81, 8.7954, 1e-2
SCALE_ATE_DR = 53.9930
SCALE_GN_ITERS, SCALE_PCG_ITERS, SCALE_LAUNCHES = 15, 80, 120

# The SE(3) BA paths: (poses, landmarks, OptimizerConfig fields), 24
# observations per pose, seed 0.  "ba3d_defaults" is the ba3d subcommand's
# config; "ba128" the bench suite's fused row (scripts/bench_suite.py);
# "ba512_policy" and "ba512_matched" the rows of scripts/exp_ba512.py.
_BA_BENCH = dict(
    iterations=20, lr=1.0, solver="schur3d", exact_odom_jacobians=True,
    huber_delta=4.0, pcg_tol=1e-6, pcg_max_iters=200, convergence_eps=1e-8,
    reject_worse_steps=True, pcg_precond="tridiag", pcg_fused_chunk=16,
)
BA_CASES = {
    "ba3d_defaults": (64, 256, dict(
        iterations=25, lr=1.0, solver="schur3d", exact_odom_jacobians=True,
        huber_delta=1e9, pcg_tol=1e-8, pcg_max_iters=400,
        convergence_eps=1e-8, reject_worse_steps=True)),
    "ba128": (128, 512, _BA_BENCH),
    "ba512_policy": (512, 4096, _BA_BENCH),
    "ba512_matched": (512, 4096, dict(
        _BA_BENCH, pcg_tol=0.0, pcg_max_iters=64, pcg_restart_every=64)),
}
# Their references: the JAX package's f32 plain-PCG (pcg_backend="xla") run
# of each on the CPU (``python tests/test_torch_ba.py``): chi^2 at GN
# iteration 0 and at the last, ATE before and after (the JAX package's
# fused path on the CPU beside it where measured).  These runs are chaotic
# in f32: the JAX package's own fused and plain paths differ by up to 76 %
# in chi^2 per iteration on ba3d_defaults, and the end states sit in a flat
# valley (on ba3d_defaults their float64 cost agrees to 1e-6 while the ATE
# spans 0.27-0.39; at 512 x 4096 the port's own CPU runs end at ATE
# 0.40-3.10 with final chi^2 within 1.3 %).  So the port is held to chi^2
# at iteration 0 (rtol 1e-4: the same graph), chi^2 never rising (LM step
# rejection), the final chi^2 (rtol ``final_rtol``: 1e-4 where the JAX
# package's two paths agree to 1e-6, 2 % at 512 x 4096) and, where the
# valley allows it, an ATE below half the initial one.
BA_REF = {
    "ba3d_defaults": dict(chi2=(9062292.0, 2295.708984375),
                          ate_initial=1.2834193706512451,
                          ate_final=0.28841283917427063,
                          fused_chi2_final=2295.70654296875,
                          fused_ate_final=0.27208057045936584,
                          final_rtol=1e-4, ate_below=1.2834193706512451 / 2),
    "ba128": dict(chi2=(1744823.875, 4624.5419921875),
                  ate_initial=1.5134034156799316,
                  ate_final=0.16697615385055542,
                  fused_chi2_final=4624.5380859375,
                  fused_ate_final=0.14810003340244293,
                  final_rtol=1e-4, ate_below=1.5134034156799316 / 2),
    "ba512_policy": dict(chi2=(20788476.0, 13488.2568359375),
                         ate_initial=3.9674267768859863,
                         ate_final=0.9365894198417664, final_rtol=2e-2),
    "ba512_matched": dict(chi2=(20788476.0, 13470.5),
                          ate_initial=3.9674267768859863,
                          ate_final=0.4009546637535095, final_rtol=2e-2),
}


# The plain PCG loop on the main path: the JAX package's iteration counts
# (pcg_backend="xla", the same as its fused path's)
MAIN_PCG_ITERS = [35, 35, 34, 33, 33, 32, 32, 32, 31, 31]
DENSE_CHI2_FIRST, DENSE_CHI2_FINAL = 228733.53, 27524.9

# The bench suite's two 10k grid rows (scripts/bench_suite.py:274-325):
# make_large_problem's arguments and the OptimizerConfig fields over
# GRID_BENCH.  Each runs under pcg_backend "auto", "fused" and "xla".
GRID_BENCH = dict(
    iterations=15, lr=1.0, solver="schur_grid", exact_odom_jacobians=True,
    pcg_tol=1e-2, pcg_max_iters=15, pcg_restart_every=15,
    pcg_precond="tridiag+coarse", pcg_coarse_group=32, pcg_precond_refresh=5,
    pcg_backend="auto", pcg_fused_chunk=15,
)
GRID_CASES = {
    "large-sparse-10k": (dict(num_poses=10_000, num_landmarks=10_000,
                              obs_per_pose=6, seed=0), {}),
    "large-sparse-10k-revisit": (dict(num_poses=10_000, num_landmarks=5_000,
                                      obs_per_pose=6, seed=0, laps=2),
                                 dict(iterations=20)),
}
# Their references: the JAX package's f32 schur_grid run with
# pcg_backend="xla" on the CPU (``python tests/test_torch_grid_schur.py``):
# chi^2 at the first and last GN iteration, the final and the
# dead-reckoning ATE; 15 PCG iterations (the cap) in every GN iteration.
# Held: chi^2 first at rtol 1e-4, final chi^2 within 1 %, the ATE within
# 5 % on the revisit row (the row without revisits has no observable
# ATE: it drifts with the map).
GRID_REF = {
    "large-sparse-10k": dict(chi2=(10942544.0, 6652.3388671875),
                             ate=10.063098907470703,
                             ate_dr=53.99301528930664),
    "large-sparse-10k-revisit": dict(chi2=(27641242.0, 6861.9853515625),
                                     ate=1.4336570501327515,
                                     ate_dr=40.60987854003906),
}


# The 100k row: scripts/exp_band100k.py's band-100k-jacobi-cg128
# (make_large_problem's arguments, the low-noise model, the OptimizerConfig
# fields) and the JAX package's recorded algorithmic values for it
# (BENCH_BAND100K.json: chi^2 and PCG iteration counts; not speeds).
BAND100K_GRAPH = dict(num_poses=100_000, num_landmarks=50_000, obs_per_pose=6,
                      seed=0, laps=2, pose_bucket=1024, landmark_bucket=1024,
                      edge_bucket=8192)
BAND100K_NOISE = dict(position_std=0.05, orientation_std=math.radians(0.2))
BAND100K_CFG = dict(
    iterations=10, lr=1.0, solver="schur_grid", exact_odom_jacobians=True,
    pcg_tol=1e-3, pcg_max_iters=60, pcg_restart_every=30,
    pcg_precond="jacobi+coarse", pcg_coarse_group=128, pcg_precond_refresh=5,
    pcg_backend="fused", pcg_fused_chunk=15,
)
BAND100K_REF = dict(chi2_first=4245268.0, chi2_final=23301.2, pcg_iters=60,
                    final_rtol=1e-2)


def log(msg: str) -> None:
    print(msg, flush=True)


# --- phase 2: the kernel against its plain version ----------------------


def synthetic_system(np_, mw, nlevels, nc, eps, seed, device, dp=3):
    """A seeded SPD system in the kernel's layout whose CG is slow.

    ``T`` is a diagonally dominant block chain with block Cholesky factor
    ``F`` (``T = F F^T``, ``F`` block lower bidiagonal), and ``V = F W``
    with ``W`` Gaussian scaled to ``||W|| = sqrt(1 - eps)``.  Then
    ``S = T - V V^T = F (I - W W^T) F^T`` is SPD, and against a
    preconditioner exact on ``T`` its spectrum spreads over ``[eps, 1]``,
    so a 16-iteration chunk ends well short of the tolerance.  The
    preconditioner is PCR on ``T`` (or its block diagonal); the coarse
    level is the exact Galerkin inverse of ``S`` over groups of Np/nc
    poses.
    """
    import numpy as np
    import torch

    from toyslam_torch.ops import fused_pcg as fp
    from toyslam_torch.ops import schur

    rng = np.random.default_rng(seed)
    upper = -np.eye(dp)[None] + 0.05 * rng.normal(size=(np_, dp, dp))
    upper[-1] = 0.0
    up_norm = np.linalg.norm(upper, 2, axis=(1, 2))
    diag = np.zeros((np_, dp, dp))
    for p in range(np_):
        a = rng.normal(size=(dp, dp)) * 0.05
        near = up_norm[p] + (up_norm[p - 1] if p else 0.0)
        diag[p] = (near + 0.5) * np.eye(dp) + a @ a.T
    lower = np.concatenate([np.zeros((1, dp, dp)),
                            upper[:-1].transpose(0, 2, 1)])
    f_diag = np.zeros_like(diag)     # F[p, p]
    f_sub = np.zeros_like(diag)      # F[p, p-1]
    for p in range(np_):
        f_diag[p] = np.linalg.cholesky(
            diag[p] - (f_sub[p] @ f_sub[p].T if p else 0.0))
        if p + 1 < np_:
            f_sub[p + 1] = np.linalg.solve(f_diag[p], upper[p]).T
    w = rng.normal(size=(np_, dp, mw))
    w *= math.sqrt(1.0 - eps) / np.linalg.norm(w.reshape(np_ * dp, mw), 2)
    vb = np.einsum("pab,pbm->pam", f_diag, w)
    vb[1:] += np.einsum("pab,pbm->pam", f_sub[1:], w[:-1])
    u = vb.transpose(1, 0, 2)                        # [dp, Np, Mw]
    v = u.reshape(dp * np_, mw)

    def t32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=device)

    op = fp.FusedOperator(
        u=t32(u), tdiag=t32(diag.transpose(1, 2, 0)),
        tupper=t32(upper.transpose(1, 2, 0)),
        tlower=t32(lower.transpose(1, 2, 0)),
    )
    if nlevels:
        al, ga, binv = schur.build_tridiag_planes(
            torch.as_tensor(diag.transpose(1, 2, 0)),
            torch.as_tensor(upper.transpose(1, 2, 0)),
        )
        al, ga, binv = al[:nlevels], ga[:nlevels], binv
    else:
        al = ga = torch.zeros((0, dp, dp, np_), dtype=torch.float64)
        binv = torch.as_tensor(np.linalg.inv(diag).transpose(1, 2, 0))
    cinv = rmat = None
    if nc:
        dense = np.zeros((dp * np_, dp * np_))
        idx = np.arange(np_)
        for a in range(dp):
            for b in range(dp):
                dense[a * np_ + idx, b * np_ + idx] = diag[:, a, b]
                dense[a * np_ + idx[:-1], b * np_ + idx[:-1] + 1] = \
                    upper[:-1, a, b]
                dense[b * np_ + idx[:-1] + 1, a * np_ + idx[:-1]] = \
                    upper[:-1, a, b]
        s = dense - v @ v.T
        r = (idx[:, None] // (np_ // nc) == np.arange(nc)[None]).astype(float)
        rk = np.kron(np.eye(dp), r)                      # [dp*Np, dp*nc]
        sc_inv = np.linalg.inv(rk.T @ s @ rk)
        cinv = t32(sc_inv.reshape(dp, nc, dp, nc).transpose(0, 2, 1, 3))
        rmat = t32(r)
    pre = fp.FusedPrecond(t32(al.numpy()), t32(ga.numpy()),
                          t32(binv.numpy()), cinv, rmat)
    rhs = t32(rng.normal(size=(dp, np_)))
    return op, pre, rhs


def fresh_state(rhs):
    import torch

    from toyslam_torch.ops import fused_pcg as fp

    z = torch.zeros_like(rhs)
    return fp.ChunkState(
        x=z, r=z, p=z, rt=rhs.clone(),
        it=torch.zeros(1, dtype=torch.int32, device=rhs.device),
        rz=torch.zeros(1, device=rhs.device),
        stop=torch.zeros(1, dtype=torch.int32, device=rhs.device),
        rr=(rhs * rhs).sum().reshape(1),
    )


def chunk_fns(kernel, schedule=None):
    """(kernel wrapper, plain version) of a kernel's chunk; ``schedule``
    forces one of B1's (``fused_pcg.B1_SCHEDULES``)."""
    from toyslam_torch.ops import fused_pcg as fp

    if schedule is not None:
        def forced(*args):
            return fp._launch(*args, schedule=schedule)
        return forced, fp.fused_pcg_chunk_ref
    return {
        "fused_pcg_chunk": (fp.fused_pcg_chunk, fp.fused_pcg_chunk_ref),
        "band_fused_pcg_chunk": (fp.band_fused_pcg_chunk,
                                 fp.band_fused_pcg_chunk_ref),
    }[kernel]


def reset_counts():
    from toyslam_torch.ops import band_matvec as bmv
    from toyslam_torch.ops import edges3d_kernel as k3
    from toyslam_torch.ops import fused_pcg as fp
    from toyslam_torch.ops import pcr

    fp.fused_pcg_chunk.launches = 0
    fp.fused_pcg_chunk.schedule_launches = dict.fromkeys(fp.B1_SCHEDULES, 0)
    fp.band_fused_pcg_chunk.launches = 0
    bmv.slab_band_matvec.launches = 0
    pcr.pcr_factor.launches = 0
    k3.launches = 0


def read_counts():
    from toyslam_torch.ops import band_matvec as bmv
    from toyslam_torch.ops import edges3d_kernel as k3
    from toyslam_torch.ops import fused_pcg as fp
    from toyslam_torch.ops import pcr

    return {"fused_pcg_chunk": fp.fused_pcg_chunk.launches,
            "band_fused_pcg_chunk": fp.band_fused_pcg_chunk.launches,
            "slab_band_matvec": bmv.slab_band_matvec.launches,
            "pcr_factor": pcr.pcr_factor.launches,
            "edges3d": k3.launches}


def solve_launches(counts):
    """The launches of :func:`read_counts` but the PCR build's and the SE(3)
    edges': the PCG kernels and B3.  The plain PCG loop, the dense solver
    and the sharded ranks make none of them; every solve that builds a
    tridiagonal preconditioner on the card launches the PCR kernel
    (``pcr_factor``), every SE(3) solve there the edges' kernels
    (``edges3d``, :func:`edges3d_launches`)."""
    return sum(v for k, v in counts.items()
               if k not in ("pcr_factor", "edges3d"))


def edges3d_launches(cfg, iterations_run):
    """The SE(3) edges' launches of one optimize() on the card: two an
    assembly (one a GN iteration) and two a chi^2 of the step rejection
    (one a GN iteration where it rejects worse steps)."""
    return iterations_run * (2 + 2 * cfg.reject_worse_steps)


def pcr_builds(cfg, iterations_run):
    """The PCR kernel's launches of one optimize() on the card: one per
    preconditioner build, every ``pcg_precond_refresh`` GN iterations,
    where the local preconditioner is tridiagonal."""
    if cfg.pcg_precond.partition("+")[0] != "tridiag":
        return 0
    return -(-iterations_run // cfg.pcg_precond_refresh)


def read_b1_schedules():
    """B1's launches by schedule since the last :func:`reset_counts`."""
    from toyslam_torch.ops import fused_pcg as fp

    return dict(fp.fused_pcg_chunk.schedule_launches)


def compare_chunks(case, op, pre, rhs, chunk=16, maxit=200, tol=1e-6,
                   kernel="fused_pcg_chunk", schedule=None):
    """Kernel vs plain version from the same state: a fresh first chunk
    (restart) and a second chunk carrying the recurrence (no restart).
    Each kernel launch is repeated from the same state and must give the
    same bits.

    ``x`` is compared at its own scale.  ``r_true = rhs - S x`` and ``rr``
    are compared at the scale of ``rhs`` and ``||rhs||^2``: near the f32
    floor ``r_true`` is rounding noise of that size, so its own scale
    would compare noise with noise.  Both readings are printed."""
    import torch

    from toyslam_torch.ops import fused_pcg as fp

    ker_fn, ref_fn = chunk_fns(kernel, schedule)
    rhs2 = float((rhs * rhs).sum())
    rhs_max = float(rhs.abs().max())
    atol2 = ((tol ** 2) * (rhs * rhs).sum()).reshape(1)
    st = fresh_state(rhs)
    results = []
    for restart in (True, False):
        ref = ref_fn(op, pre, rhs, st, atol2, maxit, restart, chunk)
        ker = ker_fn(op, pre, rhs, st, atol2, maxit, restart, chunk)
        again = ker_fn(op, pre, rhs, st, atol2, maxit, restart, chunk)
        torch.cuda.synchronize()
        rerun_same = all(torch.equal(getattr(ker, f), getattr(again, f))
                         for f in fp.ChunkState._fields)
        dx = float((ker.x - ref.x).abs().max())
        drt = float((ker.rt - ref.rt).abs().max())
        drr = abs(float(ker.rr) - float(ref.rr))
        errs = {
            "x": dx / float(ref.x.abs().max()),
            "r_true": drt / rhs_max,
            "rr": drr / rhs2,
        }
        own = {
            "r_true": drt / float(ref.rt.abs().max()),
            "rr": drr / float(ref.rr),
        }
        same = (int(ker.it) == int(ref.it)) and \
            (int(ker.stop) == int(ref.stop))
        ok = same and rerun_same and all(
            e <= REL_TOL for e in errs.values()) and all(
            bool(torch.isfinite(t).all()) for t in (ker.x, ker.rt, ker.rr)
        )
        results.append({
            "case": case, "restart": restart, "ok": ok,
            "it": [int(ker.it), int(ref.it)],
            "stop": [int(ker.stop), int(ref.stop)],
            "rerun_identical": rerun_same, "rel": errs,
            "rel_own_scale": own, "max_abs_err": max(dx, drt),
            "rr_over_rhs2": float(ref.rr) / rhs2,
        })
        st = ref
    return results


def phase_kernels(device):
    # (name, Np, Mw, PCR levels, coarse groups, eps): eps sets how slowly CG
    # converges; the Np=2048 system is kept better conditioned because its
    # V^T x sums run over 6144 terms
    cases = [
        ("Np192_Mw768_L8", 192, 768, 8, 0, 1e-2),
        ("Np192_Mw768_jacobi", 192, 768, 0, 0, 1e-2),
        ("Np192_Mw768_L8_coarse3", 192, 768, 8, 3, 1e-2),
        ("Np2048_Mw768_L11", 2048, 768, 11, 0, 1e-1),
        ("Np1088_Mw768_L11", 1088, 768, 11, 0, 1e-1),
        ("Np1088_Mw768_L11_coarse17", 1088, 768, 11, 17, 1e-1),
        ("Np1088_Mw768_jacobi_coarse17", 1088, 768, 0, 17, 1e-1),
    ]
    out, times = [], {}
    for i, (name, np_, mw, nl, nc, eps) in enumerate(cases):
        op, pre, rhs = synthetic_system(np_, mw, nl, nc, eps, seed=i,
                                        device=device)
        out += compare_chunks(name, op, pre, rhs)
        times[name] = chunk_times(op, pre, rhs)
    for r in out:
        log("kernel_check " + json.dumps(r))
    log("kernel_chunk_ms " + json.dumps(times))
    bad = [r for r in out if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with plain version: {bad}")
    return max(r["max_abs_err"] for r in out)


# B1's layouts on the paths: (name, dp, Np, Mw, PCR levels, eps); the
# main path, the ba3d defaults, the ba3d bench row, multi-loop-1k and the
# 2000-pose request (Np padded to 2048), each at a chunk of 16
B1_LAYOUTS = [
    ("main_dp3_Np192", 3, 192, 768, 8, 1e-2),
    ("ba3d_dp6_Np64", 6, 64, 768, 6, 1e-2),
    ("ba128_dp6_Np128", 6, 128, 1536, 7, 1e-2),
    ("multiloop_dp3_Np1088", 3, 1088, 768, 11, 1e-1),
    ("serve2000_dp3_Np2048", 3, 2048, 768, 11, 1e-1),
]
# local memory a thread of the cluster schedule at dp=3 keeps (ptxas, sm_90a:
# 8 bytes of spilled registers at 96 registers a thread)
B1_DP3_CLUSTER_LOCAL = 8
# launch shapes whose barriers are timed alone: (clusters, cluster size,
# threads a block)
B1_BARRIER_SHAPES = {"one_cluster_16x576": (1, 16, 576),
                     "grid_7x16x384": (7, 16, 384),
                     "grid_15x8x384": (15, 8, 384)}


def b1_barrier_costs(device, smem_bytes=200 * 1024, iters=4000):
    """The cost of one barrier alone (us, CUDA events over ``iters``) of
    each kind (cluster, grid, block) on each of ``B1_BARRIER_SHAPES`` at
    one block an SM."""
    from toyslam_torch.ops import fused_pcg as fp

    out = {}
    for name, (ncl, c, th) in B1_BARRIER_SHAPES.items():
        out[name] = {kind: cuda_ms(lambda: fp.b1_barrier_probe(
            device, iters, kind, ncl, c, th, smem_bytes), 3) / iters * 1e3
            for kind in fp.B1_BARRIERS}
    return out


def b1_barriers_per_trip(plan, nlevels, coarse):
    """Cluster and grid barriers one CG trip of a B1 plan waits at: the
    "cluster" schedule's two in its matvec; the split schedules' L - K + 3
    (+1 with the coarse level; K local PCR levels), and a grid barrier on a
    grid of clusters (the kernel's comment in csrc/fused_pcg_chunk.cu)."""
    if not plan.split:
        return {"cluster": 2, "grid": 0}
    return {"cluster": nlevels - plan.local_levels + 3 + int(coarse),
            "grid": int(plan.clusters > 1)}


def b1_schedule_times(op, pre, rhs, chunk, schedules, reps=50):
    """One fresh B1 chunk on each of ``schedules`` in turns (forward, then
    backward), CUDA events."""
    from toyslam_torch.ops import fused_pcg as fp

    st = fresh_state(rhs)
    atol2 = ((1e-6 ** 2) * (rhs * rhs).sum()).reshape(1)
    ms = {sch: [] for sch in schedules}

    def launch(sch):
        return lambda: fp._launch(op, pre, rhs, st, atol2, 200, True, chunk,
                                  schedule=sch)

    for sch in schedules:   # warm-up, not kept (a first turn read 2.6x)
        cuda_ms(launch(sch), 5)
    for sch in list(schedules) + list(reversed(schedules)):
        ms[sch].append(cuda_ms(launch(sch), reps))
    return ms


def phase_b1_layouts(device):
    """B1 at every layout of ``B1_LAYOUTS`` on a seeded system of its
    shape, on each schedule that fits it: the "cluster" schedule, "split"
    (one cluster) and "grid" (the card-wide split schedule); the parent
    checkout's own kernel is timed by ``toyslam_torch/scripts/bench_b1.py``
    run from that checkout.  Each held against its plain version (fresh
    and carried chunks, rerun bits), timed in turns against the others and
    against its bound, with its per-phase split, its barriers a trip and
    their floor from the measured cost of one barrier alone (line
    ``b1_barriers``); and every instantiation's registers and local memory,
    which must be none but ``B1_DP3_CLUSTER_LOCAL`` bytes for the cluster
    schedule at dp=3."""
    import torch

    from toyslam_torch.ops import fused_pcg as fp

    barriers = b1_barrier_costs(device)
    log("b1_barriers " + json.dumps(barriers))
    attrs = {f"dp{dp}_{'split' if sp else 'cluster'}":
             fp.b1_kernel_attrs(dp, sp)
             for dp in fp.KERNEL_DPS for sp in (False, True)}
    log("b1_kernel_attrs " + json.dumps(attrs))
    out = {}
    for i, (name, dp, np_, mw, nl, eps) in enumerate(B1_LAYOUTS):
        op, pre, rhs = synthetic_system(np_, mw, nl, 0, eps, seed=20 + i,
                                        device=device, dp=dp)
        plans = {}
        for sch in fp.B1_SCHEDULES:
            try:
                plans[sch] = b1_plan_of(op, pre, rhs, sch)
            except ValueError:    # the forced schedule does not fit
                continue
        chosen = b1_plan_of(op, pre, rhs).schedule
        m = {"chosen": chosen, "bound": chunk_bound(op, pre, rhs, 16),
             "ms": b1_schedule_times(op, pre, rhs, 16, list(plans)),
             "plain_ms": chunk_times(op, pre, rhs, reps=5)["plain"],
             "schedules": {}}
        for sch, plan in plans.items():
            per = b1_barriers_per_trip(plan, nl, False)
            cost = barriers["grid_7x16x384" if plan.split
                            else "one_cluster_16x576"]
            floor_us = 17 * (per["cluster"] * cost["cluster"]
                             + per["grid"] * cost["grid"])
            m["schedules"][sch] = {
                "plan": plan._asdict(),
                "checks": compare_chunks(name, op, pre, rhs, schedule=sch),
                "phase_split": b1_phase_split(
                    op, pre, rhs, 16, statistics.mean(m["ms"][sch]), sch),
                "barriers_per_trip": per, "barrier_floor_ms": floor_us / 1e3}
        log("b1_layout " + json.dumps({name: m}))
        out[name] = m
        del op, pre, rhs
        torch.cuda.empty_cache()
    path = multi_loop_path(device)
    bad = [c for m in out.values() for s in m["schedules"].values()
           for c in s["checks"] if not c["ok"]]
    if bad:
        raise AssertionError(f"B1 disagrees with its plain version: {bad}")
    # the cluster schedule at dp=3 (576 threads, 96 registers each) keeps 8
    # bytes of spilled registers (PERF.md); every
    # other instantiation holds none
    spilled = {k: a for k, a in attrs.items()
               if a["local_bytes"] and k != "dp3_cluster"}
    if spilled or attrs["dp3_cluster"]["local_bytes"] > B1_DP3_CLUSTER_LOCAL:
        raise AssertionError(f"B1 instantiations spill: {attrs}")
    failed = [k for k, ok in path["checks"].items() if not ok]
    if failed:
        raise AssertionError(f"multi-loop-1k through B1: {failed}")
    return {"layouts": out, "barriers_us": barriers, "attrs": attrs,
            "multi_loop_path": path}


def multi_loop_path(device):
    """One optimize of the suite's multi-loop-1k row through B1 (its
    layout takes the card-wide schedule), with the launch counts set to 0
    just before and read just after, held to the row's chi^2 and ATE
    (``bench_suite.SIM_REF``) (line ``b1_multi_loop_path``)."""
    import numpy as np
    import torch

    from toyslam_torch.optimizer import GaussNewton
    from toyslam_torch.scripts import bench_suite
    from toyslam_torch.sim import frontend

    name = "multi-loop-1k"
    cfg = bench_suite.optimizer_config(name)
    graph, gt, n_real = bench_suite.row_graph(name)
    gn = GaussNewton(cfg)
    gdev = gn._prepare(graph).to(device)
    reset_counts()
    res = gn.optimize(gdev)
    torch.cuda.synchronize()
    launches = read_counts()
    b1_schedules = read_b1_schedules()
    it = res.iterations_run
    chi2 = res.errors.cpu().numpy()[:it]
    est = res.graph.poses.cpu().numpy()
    ref = bench_suite.SIM_REF[name]
    ate = frontend.ate_rmse(est[:n_real], gt)
    m = {"chi2": [float(chi2[0]), float(chi2[-1])], "ate": ate,
         "pcg_iters": res.pcg_iters[:it].tolist(),
         "kernel_launches": launches, "b1_schedule_launches": b1_schedules}
    m["checks"] = {
        "B1 only, card-wide": launches["fused_pcg_chunk"] > 0
        and b1_schedules["grid"] == launches["fused_pcg_chunk"]
        and launches["band_fused_pcg_chunk"] == 0,
        "finite": bool(np.isfinite(est).all() and np.isfinite(chi2).all()),
        "chi2 first": math.isclose(chi2[0], ref["chi2"][0], rel_tol=1e-4),
        "chi2 final": math.isclose(chi2[-1], ref["chi2"][1], rel_tol=1e-3),
        "ate": abs(ate - ref["ate"]) <= 2e-3,
    }
    log("b1_multi_loop_path " + json.dumps(m))
    return m


L2_BYTES = 50 * 2**20    # the H100's L2 cache


def chunk_bound(op, pre, rhs, chunk, restart=True):
    """The least time the card could take for one chunk launch on these
    operands: every input read once and every output written once at the
    HBM rate, or the f32 operations of the plain version (chunk + 1
    matvecs, one preconditioner apply per iteration plus the restart's,
    dot products) at the f32 peak, whichever is larger.  A band stack, or
    B1's U, larger than the L2 is read on each of the chunk + 1 matvec
    trips: each trip's matvec needs the one before it, so none can share
    a read (``stream_bytes``, counted chunk + 1 times).  B2 takes the
    coarse level's restriction as consecutive groups (the wrapper checks
    ``rmat`` once per tensor, not per launch): it reads no ``rmat``, and
    restricting and prolonging cost an add per pose component each; B1
    reads ``rmat`` and multiplies by it."""
    import torch

    from toyslam_torch.ops import fused_pcg as fp

    dp, n = rhs.shape
    band = isinstance(op, fp.BandOperator)
    skip = pre.rmat if band else None
    tensors = [t for t in (*op, *pre, rhs)
               if torch.is_tensor(t) and t is not skip]
    vec = rhs.numel() * rhs.element_size()
    nbytes = sum(t.numel() * t.element_size() for t in tensors) \
        + 8 * vec + 32   # x r p rt in and out, four scalars each way
    if band:
        mv = 4 * op.tiles.numel() + (0 if op.u is None else 4 * op.u.numel())
        stream = 4 * op.tiles.numel()
    else:
        mv = 4 * op.u.numel()
        stream = 4 * op.u.numel()
    if stream <= L2_BYTES:
        stream = 0
    nbytes += chunk * stream
    mv += 6 * dp * dp * n
    pc = (4 * pre.alphas.shape[0] + 2) * dp * dp * n
    if pre.cinv is not None:
        nc = pre.cinv.shape[-1]
        pc += (2 * dp * n if band else 4 * dp * n * nc) + 2 * (dp * nc) ** 2
    flops = (chunk + 1) * (mv + 10 * dp * n) + (chunk + int(restart)) * pc
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOPS
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops, "stream_bytes": stream}


# --- phase 3: the main path ---------------------------------------------


def main_config(steps=150, **change):
    from toyslam_torch.config import OptimizerConfig, SimConfig, SlamConfig

    return SlamConfig(
        sim=SimConfig(robot_steps=steps, seed=0),
        optimizer=OptimizerConfig(**dict(
            dict(iterations=10, lr=0.2, solver="schur",
                 pcg_precond="tridiag"), **change)),
    )


def run_path(steps, device, **change):
    """The main path's simulation, graph and optimize() on the card with
    the launch counts set to 0 just before and read just after; ``change``
    overrides OptimizerConfig fields."""
    import numpy as np

    from toyslam_torch.optimizer import GaussNewton
    from toyslam_torch.sim import frontend

    cfg = main_config(steps, **change)
    t0 = time.perf_counter()
    sim = frontend.simulate(cfg.sim)
    graph, _ = frontend.build_graph(sim, cfg)
    host_s = time.perf_counter() - t0
    gn = GaussNewton(cfg.optimizer)
    gdev = graph.to(device)
    reset_counts()
    res = gn.optimize(gdev)
    est = res.graph.poses.cpu().numpy()
    launches = read_counts()
    b1_schedules = read_b1_schedules()
    n = sim.poses_gt.shape[0]
    errors = res.errors.cpu().numpy()[: res.iterations_run]
    metrics = {
        "steps": steps,
        "poses_padded": graph.num_poses,
        "landmarks": int(graph.lm_mask.sum()),
        "lm_edges": int(graph.lm_edges.mask.sum()),
        "host_sim_build_s": host_s,
        "iterations_run": res.iterations_run,
        "chi2": errors.tolist(),
        "pcg_iters": res.pcg_iters[: res.iterations_run].tolist(),
        "ate_rmse": frontend.ate_rmse(est[:n], sim.poses_gt),
        "ate_dead_reckoning": frontend.ate_rmse(sim.poses_dr, sim.poses_gt),
        "kernel_launches": launches,
        "b1_schedule_launches": b1_schedules,
        "finite": bool(np.isfinite(est).all() and np.isfinite(errors).all()),
    }
    # the start state with the gather plan optimize() attached, for timing
    return metrics, gn, res.graph.with_state(gdev.poses, gdev.landmarks)


def phase_main_path(device):
    m, gn, gdev = run_path(150, device)
    log("main_path " + json.dumps(m))
    checks = {
        "B1 launches > 0": m["kernel_launches"]["fused_pcg_chunk"] > 0,
        "B2 not launched": m["kernel_launches"]["band_fused_pcg_chunk"] == 0,
        "PCR kernel once a build": m["kernel_launches"]["pcr_factor"]
        == pcr_builds(gn.config, m["iterations_run"]),
        "finite": m["finite"],
        "ate": abs(m["ate_rmse"] - ATE_REF) <= ATE_TOL,
        "ate_dr": abs(m["ate_dead_reckoning"] - ATE_DR_REF) <= 1e-4,
        "chi2_first": math.isclose(m["chi2"][0], CHI2_FIRST, rel_tol=1e-4),
        "chi2_final": math.isclose(m["chi2"][-1], CHI2_FINAL, rel_tol=1e-3),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"main path checks failed: {failed}")
    return m, gn, gdev


# --- phase 4: timing ------------------------------------------------------


def layer_system(gn, graph, mode="resident"):
    """The GN-iteration-0 solve of a path split into its layers: the main
    path, or (``solver="schur3d"``) a BA path through the resident or the
    band operator."""
    import torch

    from toyslam_torch.ops import blockmath as bm
    from toyslam_torch.ops import fused_pcg as fp
    from toyslam_torch.ops import schur, schur3d

    cfg = gn.config
    lam = torch.tensor(cfg.lambda_init, device=graph.device)
    plan = graph.plan
    state = {}
    band = mode == "band"

    def assemble():
        if cfg.solver == "schur3d":
            state["sys"] = schur3d.assemble_blocks_3d(
                graph, cfg.huber_delta, cfg.fixed_prior,
                exact_odom_jacobians=cfg.exact_odom_jacobians)
        else:
            state["sys"] = schur.assemble_blocks(
                graph, cfg.huber_delta, cfg.fixed_prior,
                exact_odom_jacobians=cfg.exact_odom_jacobians)

    def eliminate():
        d = schur.damp(state["sys"], lam)
        hll_inv = schur.inv_blocks(d.hll)
        rhs = -d.bp + schur.hpl_matvec(d, graph.lm_edges.lm,
                                       bm.mv(hll_inv, d.bl), plan)
        state.update(d=d, hll_inv=hll_inv, rhs2=rhs.T.contiguous(),
                     s_diag=schur.schur_s_diag(d, hll_inv, graph))

    def precond():
        state["pre"] = fp.build_fused_precond(
            state["d"], state["hll_inv"], graph, state["s_diag"],
            cfg.pcg_precond, cfg.pcg_coarse_group)

    def operator():
        build = fp.build_band_operator if band else fp.build_fused_operator
        state["op"] = build(state["d"], state["hll_inv"], graph)

    def pcg():
        run = fp.band_fused_pcg if band else fp.fused_pcg
        state["res"] = run(state["op"], state["pre"], state["rhs2"],
                           cfg.pcg_tol, cfg.pcg_max_iters,
                           cfg.pcg_fused_chunk, cfg.pcg_restart_every)

    def backsub():
        d = state["d"]
        u = schur.hlp_matvec(d, graph.lm_edges.pose, state["res"].x.T, plan)
        state["dx_l"] = bm.mv(state["hll_inv"], -d.bl - u)

    return state, [("assemble_blocks", assemble),
                   ("damp_eliminate_rhs_sdiag", eliminate),
                   ("build_fused_precond", precond),
                   ("build_band_operator" if band else "build_fused_operator",
                    operator),
                   ("band_fused_pcg" if band else "fused_pcg", pcg),
                   ("back_substitution", backsub)]


def cuda_ms(fn, reps):
    import torch

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


def chunk_times(op, pre, rhs, chunk=16, kernel="fused_pcg_chunk", reps=50,
                schedule=None):
    """One fresh chunk, kernel and plain version in turns (plain, kernel,
    kernel, plain), CUDA events."""
    ker_fn, ref_fn = chunk_fns(kernel, schedule)
    st = fresh_state(rhs)
    atol2 = ((1e-6 ** 2) * (rhs * rhs).sum()).reshape(1)

    def ker():
        ker_fn(op, pre, rhs, st, atol2, 200, True, chunk)

    def plain():
        ref_fn(op, pre, rhs, st, atol2, 200, True, chunk)

    p1, k1, k2, p2 = (cuda_ms(plain, max(1, reps // 5)), cuda_ms(ker, reps),
                      cuda_ms(ker, reps), cuda_ms(plain, max(1, reps // 5)))
    return {"kernel": [k1, k2], "plain": [p1, p2]}


def cluster_times(op, pre, rhs, chunk, reps=50):
    """One fresh B1 chunk on a cluster of 8 (portable) and of 16 blocks, in
    turns (8, 16, 16, 8), CUDA events."""
    from toyslam_torch.ops import fused_pcg as fp

    st = fresh_state(rhs)
    atol2 = ((1e-6 ** 2) * (rhs * rhs).sum()).reshape(1)
    ms = {8: [], 16: []}
    for c in (8, 16, 16, 8):
        ms[c].append(cuda_ms(lambda: fp._launch(
            op, pre, rhs, st, atol2, 200, True, chunk, schedule="cluster",
            cluster=c), reps))
    return {f"cluster{c}": v for c, v in ms.items()} | {
        "resident_at_16": b1_plan_of(op, pre, rhs, "cluster").resident}


def b1_plan_of(op, pre, rhs, schedule=None):
    """B1's plan on the card for these operands (``schedule`` forces one)."""
    from toyslam_torch.ops import fused_pcg as fp

    return fp.b1_schedule(
        rhs.device.index or 0, *rhs.shape, op.u.shape[-1],
        0 if pre.cinv is None else pre.cinv.shape[-1], pre.alphas.shape[0],
        schedule)


def b1_phase_split(op, pre, rhs, chunk, chunk_ms, schedule=None):
    """Where one B1 chunk's time goes: block 0's clock64 cycles per phase
    kind (``B1_TIMERS``: its V^T v columns, its partial V urow, the cluster
    exchange with its cluster barriers, the grid exchange, the
    preconditioner, the rest) as shares of the launch, scaled by the
    measured chunk time."""
    import torch

    from toyslam_torch.ops import fused_pcg as fp

    timing = torch.zeros(len(fp.B1_TIMERS), dtype=torch.int64,
                         device=rhs.device)
    st = fresh_state(rhs)
    atol2 = ((1e-6 ** 2) * (rhs * rhs).sum()).reshape(1)
    fp._launch(op, pre, rhs, st, atol2, 200, True, chunk, schedule=schedule,
               timing=timing)
    torch.cuda.synchronize()
    cycles = dict(zip(fp.B1_TIMERS, timing.tolist()))
    total = sum(cycles.values())
    return {"cycles": cycles,
            "share": {k: v / total for k, v in cycles.items()},
            "ms": {k: chunk_ms * v / total for k, v in cycles.items()}}


def phase_timing(gn, gdev):
    import torch

    out = {}
    iters = gn.optimize(gdev).iterations_run
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            r = gn.optimize(gdev)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / 20)
    out["optimize_s_rounds"] = times
    out["optimize_s_median"] = statistics.median(times)
    out["gn_iter_per_s"] = iters / statistics.median(times)
    out["iterations_run"] = r.iterations_run

    state, layers = layer_system(gn, gdev)
    out["layer_ms"] = {name: cuda_ms(fn, 20) for name, fn in layers}
    out["pcg_iters_iter0"] = int(state["res"].iterations)

    chunk = gn.config.pcg_fused_chunk
    out["chunk_ms"] = chunk_times(state["op"], state["pre"], state["rhs2"],
                                  chunk)
    out["chunk_bound"] = chunk_bound(state["op"], state["pre"],
                                     state["rhs2"], chunk)
    out["cluster_ms"] = cluster_times(state["op"], state["pre"],
                                      state["rhs2"], chunk)
    out["phase_split"] = b1_phase_split(
        state["op"], state["pre"], state["rhs2"], chunk,
        statistics.mean(out["chunk_ms"]["kernel"]))
    out["device"] = device_time(gn, gdev)
    return out


def device_time(gn, gdev, reps=5):
    """Kernel time on the card per optimize() from torch.profiler, by
    kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            gn.optimize(gdev)
        torch.cuda.synchronize()
    per_kernel = {}
    for e in prof.key_averages():
        # the program's spans are mirrored on the device's timeline as
        # user annotations; they are not kernels
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation):
            per_kernel[e.key] = e.self_device_time_total / reps / 1e3  # ms
    busy_ms = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {
        "kernel_ms_per_optimize": busy_ms,
        "kernels_launched": len(per_kernel),
        "top_ms": dict(top),
    }


# --- phase 5: shape check -------------------------------------------------


def phase_shape(device):
    m, gn, _ = run_path(2000, device)
    log("shape_check " + json.dumps(m))
    checks = {
        "B1 launches > 0": m["kernel_launches"]["fused_pcg_chunk"] > 0,
        "B2 not launched": m["kernel_launches"]["band_fused_pcg_chunk"] == 0,
        "PCR kernel once a build": m["kernel_launches"]["pcr_factor"]
        == pcr_builds(gn.config, m["iterations_run"]),
        "finite": m["finite"],
        "chi2 decreases": m["chi2"][-1] < m["chi2"][0],
        "ate < dead reckoning": m["ate_rmse"] < m["ate_dead_reckoning"],
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"shape check failed: {failed}")
    return m


# --- phases 6-8: the band kernel and the scale path -----------------------


def scale_config():
    """The JAX package's band-10k-cg160 config (scripts/exp_band10k.py)."""
    from toyslam_torch.config import OptimizerConfig

    return OptimizerConfig(
        solver="schur", pcg_backend="auto", iterations=SCALE_GN_ITERS,
        lr=1.0, exact_odom_jacobians=True, pcg_tol=1e-2,
        pcg_max_iters=SCALE_PCG_ITERS, pcg_restart_every=40,
        pcg_precond="tridiag+coarse", pcg_coarse_group=160,
        pcg_precond_refresh=5, pcg_fused_chunk=10,
    )


def random_windows(np_, n_chunks, k_win, seed):
    """Window anchors at random multiples of 128, the last one at the last
    multiple below Np, so a window runs past the end of the graph."""
    import numpy as np

    anchors = np.arange(0, np_, 128)
    win_off = np.random.default_rng(seed).choice(anchors,
                                                 size=(n_chunks, k_win))
    win_off[-1, -1] = anchors[-1]
    return win_off.astype(np.int32)


def synthetic_band_system(np_, win_off, w_row, b_dl, mw, nlevels, group,
                          eps, seed, device, dp=3, galerkin=True):
    """A seeded SPD system in the band kernel's layout whose CG is slow.

    ``T`` is a diagonally dominant block chain.  ``V`` is a tile stack on
    the windows ``win_off`` (zero on rows past Np) whose columns are
    orthonormal within each chunk with norms spread so that the
    eigenvalues of ``T^-1 V V^T`` spread, plus ``mw`` Gaussian wide
    columns, scaled so that the largest is ``(1 - eps) / 1.02`` (power
    iteration).  Then ``S = T - V V^T`` is SPD,
    and against a preconditioner exact on ``T`` its spectrum spreads over
    ``[~eps, 1]``, so a chunk ends well short of the tolerance.  The
    preconditioner is ``nlevels`` PCR levels on ``T`` (L=0: its block
    diagonal) and, with ``group``, the exact Galerkin coarse level of ``S``
    over groups of ``group`` poses (``R^T S R`` from one float64 plain
    matvec per coarse column) or, with ``galerkin=False``, that of ``T``
    alone (``R^T T R`` in closed form: still SPD, and cheap where the
    stack is GBs and the coarse level has hundreds of groups)."""
    import numpy as np
    import torch

    from toyslam_torch.ops import band_plan
    from toyslam_torch.ops import fused_pcg as fp
    from toyslam_torch.ops import schur

    rng = np.random.default_rng(seed)
    upper = 0.05 * rng.normal(size=(np_, dp, dp))
    upper[-1] = 0.0
    up_norm = np.linalg.norm(upper, 2, axis=(1, 2))
    a = rng.normal(size=(np_, dp, dp)) * 0.05
    near = up_norm + np.concatenate([[0.0], up_norm[:-1]])
    diag = (near + 1.0)[:, None, None] * np.eye(dp) + a @ a.transpose(0, 2, 1)
    lower = np.concatenate([np.zeros((1, dp, dp)),
                            upper[:-1].transpose(0, 2, 1)])
    n_chunks, k_win = win_off.shape
    cover = band_plan._window_cover(win_off, np_, w_row, dp)

    def dev_t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), device=device,
                               dtype=dtype)

    # each chunk's columns orthonormal (QR of a Gaussian block, zero on
    # rows past Np), then scaled so that the eigenvalues of V V^T spread
    # evenly over [0, 1]: CG has many distinct eigenvalues of S to resolve
    shape = (n_chunks, k_win, dp, w_row, b_dl)
    live = dev_t((win_off[..., None] + np.arange(w_row)) < np_,
                 torch.float64)[:, :, None, :, None]
    g = dev_t(rng.standard_normal(size=shape, dtype=np.float32),
              torch.float64) * live
    q = torch.linalg.qr(g.reshape(n_chunks, -1, b_dl))[0].reshape(shape)
    col = torch.linspace(1.0, 1e-3, b_dl, dtype=torch.float64,
                         device=device)
    tiles = (q * live * col.sqrt()).float().contiguous()
    del g, q
    u = rng.standard_normal(size=(dp, mw, np_))
    u *= np.sqrt(0.5) / np.linalg.norm(u, axis=(0, 2), keepdims=True)

    tplanes = [dev_t(b.transpose(1, 2, 0)) for b in (diag, upper, lower)]
    al, ga, binv = schur.build_tridiag_planes(
        torch.as_tensor(diag.transpose(1, 2, 0)),
        torch.as_tensor(upper.transpose(1, 2, 0)),
    )
    tinv = fp.FusedPrecond(dev_t(al), dev_t(ga), dev_t(binv), None, None)
    zero = dev_t(np.zeros((dp, dp, np_)))
    vop = fp.BandOperator(tiles, dev_t(win_off, torch.int32),
                          dev_t(cover, torch.int32), dev_t(u),
                          zero, zero, zero)           # x -> -V V^T x
    # power iteration on T^-1 V V^T (PCR with all levels is T^-1) with the
    # Rayleigh quotient x^T V V^T x / x^T T x: its top eigenvalue
    x = dev_t(rng.normal(size=(dp, np_)))
    lam = 1.0
    for _ in range(300):
        ax = -fp.band_matvec_ref(vop, x)
        tx = (fp._bmv(tplanes[0], x) + fp._bmv(tplanes[1], fp._shift(x, -1))
              + fp._bmv(tplanes[2], fp._shift(x, 1)))
        lam = float((x * ax).sum() / (x * tx).sum())
        x = fp._precond_ref(tinv, ax)
        x = x / x.norm()
    scale = math.sqrt((1.0 - eps) / (1.02 * lam))
    op = fp.BandOperator(
        tiles=vop.tiles * scale, win_off=vop.win_off, cover=vop.cover,
        u=vop.u * scale, tdiag=tplanes[0], tupper=tplanes[1],
        tlower=tplanes[2],
    )
    del vop, tinv
    if nlevels:
        al, ga = al[:nlevels], ga[:nlevels]
    else:
        al = ga = torch.zeros((0, dp, dp, np_), dtype=torch.float64)
        binv = torch.as_tensor(np.linalg.inv(diag).transpose(1, 2, 0))
    cinv = rmat = None
    if group:
        nc = -(-np_ // group)
        gid = torch.arange(np_, device=device) // group
        rmat64 = (gid[:, None] == torch.arange(nc, device=device)).double()
        sc = torch.zeros((dp, nc, dp, nc), dtype=torch.float64,
                         device=device)
        if galerkin:
            op64 = op._replace(**{f: getattr(op, f).double() for f in (
                "tiles", "u", "tdiag", "tupper", "tlower")})
            for b in range(dp):
                for g in range(nc):
                    e = torch.zeros((dp, np_), dtype=torch.float64,
                                    device=device)
                    e[b] = rmat64[:, g]
                    sc[:, :, b, g] = fp.band_matvec_ref(op64, e) @ rmat64
            del op64
        else:
            gidn = np.arange(np_) // group
            inner = gidn[:-1] == gidn[1:]        # p and p+1 in one group
            blocks = np.zeros((nc, dp, dp))
            np.add.at(blocks, gidn, diag)
            np.add.at(blocks, gidn[:-1][inner],
                      upper[:-1][inner]
                      + upper[:-1][inner].transpose(0, 2, 1))
            edge = np.nonzero(~inner)[0]         # last pose of groups 0..nc-2
            gi = torch.arange(nc, device=device)
            sc[:, gi, :, gi] = dev_t(blocks, torch.float64)
            up = dev_t(upper[edge], torch.float64)
            sc[:, gi[:-1], :, gi[1:]] = up
            sc[:, gi[1:], :, gi[:-1]] = up.transpose(1, 2)
        sc_inv = torch.linalg.inv(sc.reshape(dp * nc, dp * nc))
        cinv = sc_inv.reshape(dp, nc, dp, nc).permute(0, 2, 1, 3).float()
        cinv, rmat = cinv.contiguous(), rmat64.float()
    pre = fp.FusedPrecond(dev_t(al), dev_t(ga), dev_t(binv), cinv, rmat)
    rhs = dev_t(rng.normal(size=(dp, np_)))
    return op, pre, rhs


def scale_layer_system(gn, graph):
    """The GN-iteration-0 solve of the scale path split into its layers."""
    import torch

    from toyslam_torch.ops import blockmath as bm
    from toyslam_torch.ops import fused_pcg as fp
    from toyslam_torch.ops import schur

    cfg = gn.config
    lam = torch.tensor(cfg.lambda_init, device=graph.device)
    plan = graph.plan
    state = {}

    def assemble():
        state["sys"] = schur.assemble_blocks(
            graph, cfg.huber_delta, cfg.fixed_prior,
            exact_odom_jacobians=cfg.exact_odom_jacobians)

    def eliminate():
        d = schur.damp(state["sys"], lam)
        hll_inv = schur.inv_blocks(d.hll)
        rhs = -d.bp + schur.hpl_matvec(d, graph.lm_edges.lm,
                                       bm.mv(hll_inv, d.bl), plan)
        state.update(d=d, hll_inv=hll_inv, rhs2=rhs.T.contiguous(),
                     s_diag=schur.schur_s_diag(d, hll_inv, graph))

    def coarse():
        state["cinv"] = schur.build_coarse_precond(
            state["d"], state["hll_inv"], graph, cfg.pcg_coarse_group)

    def pcr():
        state["pcr"] = fp.build_fused_precond(
            state["d"], state["hll_inv"], graph, state["s_diag"],
            cfg.pcg_precond.partition("+")[0], cfg.pcg_coarse_group)

    def operator():
        state["op"] = fp.build_band_operator(state["d"], state["hll_inv"],
                                             graph)

    def pcg():
        state["res"] = fp.band_fused_pcg(
            state["op"], state["pre"], state["rhs2"], cfg.pcg_tol,
            cfg.pcg_max_iters, cfg.pcg_fused_chunk, cfg.pcg_restart_every)

    def backsub():
        d = state["d"]
        u = schur.hlp_matvec(d, graph.lm_edges.pose, state["res"].x.T, plan)
        state["dx_l"] = bm.mv(state["hll_inv"], -d.bl - u)

    def full_precond():
        state["pre"] = fp.build_fused_precond(
            state["d"], state["hll_inv"], graph, state["s_diag"],
            cfg.pcg_precond, cfg.pcg_coarse_group)

    layers = [("assemble_blocks", assemble),
              ("damp_eliminate_rhs_sdiag", eliminate),
              ("build_coarse_precond", coarse),
              ("pcr_build", pcr),
              ("build_band_operator", operator),
              ("band_fused_pcg", pcg),
              ("back_substitution", backsub)]
    return state, layers, full_precond


def phase_scale_path(device):
    import numpy as np

    from toyslam_torch.ops.gather_plan import attach_plan
    from toyslam_torch.optimizer import GaussNewton
    from toyslam_torch.sim import frontend, synthetic

    t0 = time.perf_counter()
    graph, poses_gt, _ = synthetic.make_large_problem(
        num_poses=10_000, num_landmarks=10_000, obs_per_pose=6, seed=0)
    t1 = time.perf_counter()
    graph = attach_plan(graph)
    t2 = time.perf_counter()
    band = graph.plan.band
    gn = GaussNewton(scale_config())
    gdev = graph.to(device)
    reset_counts()
    t3 = time.perf_counter()
    res = gn.optimize(gdev)
    est = res.graph.poses.cpu().numpy()
    optimize_s = time.perf_counter() - t3
    launches = read_counts()
    n = poses_gt.shape[0]
    errors = res.errors.cpu().numpy()[: res.iterations_run]
    pcg = res.pcg_iters[: res.iterations_run].tolist()
    m = {
        "poses_padded": graph.num_poses,
        "landmarks_padded": graph.num_landmarks,
        "lm_edges": int(graph.lm_edges.mask.sum()),
        "layout": {"chunk_b": band.chunk_b, "k_windows": band.k_windows,
                   "w_row": band.w_row, "n_chunks": band.n_chunks,
                   "n_wide": band.n_wide, "tile_bytes": band.tile_bytes,
                   "cover_cap": int(band.cover.shape[-1])},
        "host_graph_build_s": t1 - t0,
        "host_band_search_s": t2 - t1,
        "first_optimize_s": optimize_s,
        "iterations_run": res.iterations_run,
        "chi2": errors.tolist(),
        "pcg_iters": pcg,
        "ate_rmse": frontend.ate_rmse(est[:n], poses_gt),
        "ate_dead_reckoning": frontend.ate_rmse(graph.poses[:n], poses_gt),
        "kernel_launches": launches,
        "finite": bool(np.isfinite(est).all() and np.isfinite(errors).all()),
    }
    log("scale_path " + json.dumps(m))
    checks = {
        "B2 launches": launches["band_fused_pcg_chunk"] == SCALE_LAUNCHES,
        "B1 not launched": launches["fused_pcg_chunk"] == 0,
        "PCR kernel once a build": launches["pcr_factor"]
        == pcr_builds(gn.config, m["iterations_run"]),
        "finite": m["finite"],
        "iterations": m["iterations_run"] == SCALE_GN_ITERS,
        "pcg iterations": pcg == [SCALE_PCG_ITERS] * SCALE_GN_ITERS,
        "chi2_first": math.isclose(m["chi2"][0], SCALE_CHI2_FIRST,
                                   rel_tol=1e-4),
        "chi2_final": math.isclose(m["chi2"][-1], SCALE_CHI2_FINAL,
                                   rel_tol=SCALE_REL),
        "ate": math.isclose(m["ate_rmse"], SCALE_ATE, rel_tol=SCALE_REL),
        "ate_dr": abs(m["ate_dead_reckoning"] - SCALE_ATE_DR) <= 1e-4,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"scale path checks failed: {failed}")
    return m, gn, gdev, poses_gt


def phase_band_kernels(gn, gdev):
    """B2 against its plain version at the scale path's shapes and on a
    small synthetic layout with K=3, wide columns and L=0."""
    import torch

    from toyslam_torch.ops import fused_pcg as fp

    cfg = gn.config
    chunk = cfg.pcg_fused_chunk
    # timed on the scale path's own iteration-0 operands
    state, layers, full_precond = scale_layer_system(gn, gdev)
    for name, fn in layers[:2] + layers[4:5]:
        fn()
    full_precond()
    op, pre, rhs2 = state["op"], state["pre"], state["rhs2"]
    shapes = {"tiles": list(op.tiles.shape), "u": list(op.u.shape),
              "pcr_levels": pre.alphas.shape[0], "nc": pre.cinv.shape[-1]}
    log("band_kernel_shapes " + json.dumps(shapes))
    times = {"scale10k_L14_coarse64": chunk_times(
        op, pre, rhs2, chunk, kernel="band_fused_pcg_chunk", reps=10)}
    bound = chunk_bound(op, pre, rhs2, chunk)
    split = band_phase_split(op, pre, rhs2, chunk,
                             statistics.mean(
                                 times["scale10k_L14_coarse64"]["kernel"]))
    split["bound"] = bound
    log("band_phase_split " + json.dumps(split))
    # every instantiation as the card compiled it: no spilled register
    attrs = {f"dp{dp}_cols{c}": fp.band_kernel_attrs(dp, c)
             for dp in fp.KERNEL_DPS for c in fp.BAND_COLS[dp]}
    attrs.update({f"dp{dp}_slab": fp.band_kernel_attrs(dp, 16, slab=True)
                  for dp in fp.KERNEL_DPS})
    log("band_kernel_attrs " + json.dumps(attrs))
    if any(a["local_bytes"] for a in attrs.values()):
        raise AssertionError(f"band kernel spills registers: {attrs}")
    # held against the plain version on systems of the same shapes built
    # so that CG is far from converged after a chunk: the scale path's
    # own system carries the 1e6 gauge prior of pose 0, where r_true is
    # 1e6 times an f32 difference of x
    band = gdev.plan.band
    win_off = band.win_off.cpu().numpy()
    del state, op, pre
    sop, spre, srhs = synthetic_band_system(
        gdev.num_poses, win_off, band.w_row, band.chunk_b * 2,
        2 * band.n_wide, shapes["pcr_levels"], cfg.pcg_coarse_group, 2e-2,
        seed=4, device=gdev.device)
    assert (list(sop.tiles.shape), spre.cinv.shape[-1]) == \
        (shapes["tiles"], shapes["nc"])
    out = compare_chunks("scale10k_L14_coarse64", sop, spre, srhs,
                         chunk=chunk, kernel="band_fused_pcg_chunk")
    del sop, spre, srhs
    torch.cuda.empty_cache()
    sop, spre, srhs = synthetic_band_system(
        1000, random_windows(1000, 6, 3, seed=5), 256, 128, 4, 0, 0, 2e-2,
        seed=5, device=gdev.device)
    out += compare_chunks("synthetic_K3_wide4_jacobi", sop, spre, srhs,
                          kernel="band_fused_pcg_chunk")
    times["synthetic_K3_wide4_jacobi"] = chunk_times(
        sop, spre, srhs, kernel="band_fused_pcg_chunk")
    for r in out:
        log("band_kernel_check " + json.dumps(r))
    log("band_kernel_chunk_ms " + json.dumps(times))
    bad = [r for r in out if not r["ok"]]
    if bad:
        raise AssertionError(
            f"band kernel disagrees with plain version: {bad}")
    return {"max_abs": max(r["max_abs_err"] for r in out),
            "chunk_ms": times["scale10k_L14_coarse64"], "bound": bound,
            "split": split}


def band_phase_split(op, pre, rhs, chunk, chunk_ms, probe_iters=2000):
    """Where one B2 chunk's time goes: the blocks' mean clock64 cycles (and
    their min and max) per kind (``BAND_TIMERS``: the band phase's steps,
    the cluster's t exchange, the gather, preconditioner work, grid
    barriers including the wait for the slowest block, the rest) as shares
    of the launch, scaled by the measured chunk time; the plan; the bytes a
    trip must read (the stack, the state values at the window rows, and
    the w partials written and gathered) and the stack's effective TB/s
    over the launch; and the cost of one grid barrier alone on the same
    grid (``probe_iters`` barriers, CUDA events)."""
    import torch

    from toyslam_torch.ops import fused_pcg as fp

    dev = rhs.device
    mw = 0 if op.u is None else op.u.shape[1]
    plan = fp.band_schedule(dev.index or 0, *op.tiles.shape[:2],
                            rhs.shape[0], *op.tiles.shape[3:], mw)
    timing = torch.zeros((plan.grid, len(fp.BAND_TIMERS)), dtype=torch.int64,
                         device=dev)
    st = fresh_state(rhs)
    atol2 = ((1e-6 ** 2) * (rhs * rhs).sum()).reshape(1)
    fp._band_launch(op, pre, rhs, st, atol2, 200, True, chunk, timing=timing)
    torch.cuda.synchronize()
    per_block = timing.double()
    mean = per_block.mean(0).tolist()
    cycles = dict(zip(fp.BAND_TIMERS, mean))
    spread = {k: [float(per_block[:, i].min()), float(per_block[:, i].max())]
              for i, k in enumerate(fp.BAND_TIMERS)}
    total = sum(cycles.values())
    sync_ms = cuda_ms(lambda: fp.band_grid_sync_probe(dev, probe_iters, plan),
                      3)
    # the kernel's precond_phases: two PCR levels per phase
    nph = max(-(-pre.alphas.shape[0] // 2), 4 if pre.cinv is not None else 1)
    stack = 4 * op.tiles.numel()
    n_chunks = op.tiles.shape[0]
    trip = {"stack": stack,
            "xs": 4 * n_chunks * plan.segments * plan.rows,
            "w_partials": 2 * 4 * n_chunks * plan.segments * plan.rows}
    return {
        "plan": plan._asdict() | {"grid": plan.grid},
        "grid_sync_us": sync_ms / probe_iters * 1e3,
        "barriers_per_trip": 3 + nph,
        "trip_bytes": trip, "trip_bytes_total": sum(trip.values()),
        "stack_tb_per_s": (chunk + 1) * stack / (chunk_ms * 1e-3) / 1e12,
        "cycles": cycles, "cycles_min_max_over_blocks": spread,
        "share": {k: v / total for k, v in cycles.items()},
        "ms": {k: chunk_ms * v / total for k, v in cycles.items()},
    }


def band_plan_times(op, pre, rhs, chunk, sizes, reps=3):
    """B2 at forced schedules, cluster sizes and band widths on the same
    operands (``sizes``: (cluster, cols) pairs, cluster "slab" for the slab
    schedule; the plan's own first), in turns forward and back, CUDA
    events: ms per launch for each, with the plan's clusters on the card
    (cudaOccupancyMaxActiveClusters) and ring slots."""
    from toyslam_torch.ops import fused_pcg as fp

    st = fresh_state(rhs)
    atol2 = ((1e-6 ** 2) * (rhs * rhs).sum()).reshape(1)
    args = (rhs.device.index or 0, *op.tiles.shape[:2], rhs.shape[0],
            *op.tiles.shape[3:], 0 if op.u is None else op.u.shape[1])

    def forced(r, c):
        return (dict(slab=True, cols=c) if r == "slab"
                else dict(slab=False, cluster=r, cols=c))

    out = {}
    for r, c in sizes:
        plan = fp.band_schedule(*args, **forced(r, c))
        out[f"{'slab' if r == 'slab' else f'R{r}'}_c{c}"] = {
            "ms": [], "clusters": plan.clusters, "slots": plan.slots}
    for r, c in list(sizes) + list(reversed(sizes)):
        out[f"{'slab' if r == 'slab' else f'R{r}'}_c{c}"]["ms"].append(
            cuda_ms(lambda: fp._band_launch(op, pre, rhs, st, atol2, 200,
                                            True, chunk, **forced(r, c)),
                    reps))
    return out


def cluster_sizes(op, rhs):
    """(cluster, cols) of B2's plan on the card for these operands (cluster
    "slab" on the slab schedule), then the slab schedule at its widest and
    every cluster size and band width that fits."""
    from toyslam_torch.ops import fused_pcg as fp

    args = (rhs.device.index or 0, *op.tiles.shape[:2], rhs.shape[0],
            *op.tiles.shape[3:], 0 if op.u is None else op.u.shape[1])
    own = fp.band_schedule(*args)
    sizes = [("slab" if own.slab else own.cluster, own.cols)]
    try:
        widest = fp.band_schedule(*args, slab=True)
        if ("slab", widest.cols) not in sizes:
            sizes.append(("slab", widest.cols))
    except ValueError:
        pass
    for r in fp.BAND_CLUSTER_SIZES:
        for cols in fp.BAND_COLS[rhs.shape[0]]:
            try:
                fp.band_schedule(*args, r, cols, False)
            except ValueError:
                continue
            if (r, cols) not in sizes:
                sizes.append((r, cols))
    return sizes


def phase_scale_timing(gn, gdev):
    # 2 rounds (3 before the BA phases lengthened the smoke)
    out = gn_rate(gn, gdev, 2)
    state, layers, full_precond = scale_layer_system(gn, gdev)
    for name, fn in layers[:2]:
        fn()
    full_precond()
    out["layer_ms"] = {name: cuda_ms(fn, 3) for name, fn in layers}
    out["pcg_iters_iter0"] = int(state["res"].iterations)
    out["device"] = device_time(gn, gdev, reps=1)
    return out



# --- phases 9-13: the SE(3) BA paths at dp=6 -------------------------------


def phase_ba_kernels(device):
    """B1 and B2 at dp=6 against their plain versions on the card, on
    seeded systems of the BA paths' shapes where CG is far from converged
    after a chunk: B1 at (Np=128, Mw=1536, L=7), the bench row, and at
    (Np=64, Mw=768, L=6), the ba3d defaults; B2 on the tile-stack layout
    that the band search gives the 512-pose, 4096-point graph.  Each a
    fresh and a carried chunk, held as in phase 2; each timed against its
    plain version and its bound."""
    import torch

    from toyslam_torch.ops import fused_pcg as fp
    from toyslam_torch.ops.gather_plan import attach_plan
    from toyslam_torch.sim import synthetic3d

    out, times, bounds = [], {}, {}
    for i, (name, np_, mw, nl) in enumerate([
            ("dp6_Np128_Mw1536_L7", 128, 1536, 7),
            ("dp6_Np64_Mw768_L6", 64, 768, 6)]):
        op, pre, rhs = synthetic_system(np_, mw, nl, 0, 1e-2, seed=10 + i,
                                        device=device, dp=6)
        out += compare_chunks(name, op, pre, rhs)
        times[name] = chunk_times(op, pre, rhs)
        bounds[name] = chunk_bound(op, pre, rhs, 16)
        plan = b1_plan_of(op, pre, rhs)
        times[name]["resident"] = plan.resident
        times[name]["schedule"] = plan.schedule
        log("ba_b1_phase_split " + json.dumps({name: b1_phase_split(
            op, pre, rhs, 16, statistics.mean(times[name]["kernel"]))}))
    graph = attach_plan(synthetic3d.make_ba_problem(512, 4096, 24,
                                                    seed=0)[0])
    band = graph.plan.band
    nlevels = max(1, (graph.num_poses - 1).bit_length())
    sop, spre, srhs = synthetic_band_system(
        graph.num_poses, band.win_off.cpu().numpy(), band.w_row,
        band.chunk_b * 3, 3 * band.n_wide, nlevels, 0, 2e-2, seed=12,
        device=device, dp=6)
    name = "dp6_ba512_band"
    out += compare_chunks(name, sop, spre, srhs, kernel="band_fused_pcg_chunk")
    times[name] = chunk_times(sop, spre, srhs, kernel="band_fused_pcg_chunk",
                              reps=10)
    bounds[name] = chunk_bound(sop, spre, srhs, 16)
    plan = fp.band_schedule(device.index or 0, *sop.tiles.shape[:2], 6,
                            *sop.tiles.shape[3:],
                            0 if sop.u is None else sop.u.shape[1])
    # where a dp=6 chunk's time goes: B2's blocks, B1's block 0
    split = band_phase_split(sop, spre, srhs, 16,
                             statistics.mean(times[name]["kernel"]))
    split["bound"] = bounds[name]
    log("ba_band_phase_split " + json.dumps(split))
    shapes = {"tiles": list(sop.tiles.shape), "n_wide": band.n_wide,
              "pcr_levels": nlevels, "plan": plan._asdict(),
              "grid": plan.grid}
    del sop, spre, srhs
    torch.cuda.empty_cache()
    for r in out:
        log("ba_kernel_check " + json.dumps(r))
    log("ba_band_layout " + json.dumps(shapes))
    log("ba_kernel_chunk_ms " + json.dumps(times))
    log("ba_kernel_bound " + json.dumps(bounds))
    bad = [r for r in out if not r["ok"]]
    if bad:
        raise AssertionError(f"dp=6 kernel disagrees with plain version: {bad}")
    b1 = [r["max_abs_err"] for r in out if r["case"].startswith("dp6_Np")]
    b2 = [r["max_abs_err"] for r in out if r["case"] == name]
    return {"b1_max_abs": max(b1), "b2_max_abs": max(b2), "ms": times,
            "bound": bounds}


def ba_optimize(case, device, **change):
    """One BA path: the seeded graph, ``GaussNewton(...).optimize`` on the
    card with the launch counts set to 0 just before and read just after,
    and its metrics; ``change`` overrides OptimizerConfig fields (mode None:
    the plain PCG loop, no launch)."""
    import numpy as np

    from toyslam_torch.config import OptimizerConfig
    from toyslam_torch.ops import fused_pcg as fp
    from toyslam_torch.optimizer import GaussNewton
    from toyslam_torch.sim import synthetic3d

    poses, landmarks, kw = BA_CASES[case]
    t0 = time.perf_counter()
    graph, gt, _ = synthetic3d.make_ba_problem(poses, landmarks, 24, seed=0)
    gn = GaussNewton(OptimizerConfig(**dict(kw, **change)))
    graph = gn._prepare(graph)          # gather tables and band layout
    host_s = time.perf_counter() - t0
    gdev = graph.to(device)
    mode = fp.fused_mode(gn.config, gdev)
    reset_counts()
    t1 = time.perf_counter()
    res = gn.optimize(gdev)
    est = res.graph.poses.cpu().numpy()
    first_s = time.perf_counter() - t1
    launches = read_counts()
    b1_schedules = read_b1_schedules()
    it = res.iterations_run
    errors = res.errors.cpu().numpy()[:it]
    ref = BA_REF[case]
    m = {
        "case": case, "mode": mode, "poses_padded": graph.num_poses,
        "landmarks": int(graph.lm_mask.sum()),
        "reproj_edges": int(graph.lm_edges.mask.sum()),
        "host_graph_plan_s": host_s, "first_optimize_s": first_s,
        "iterations_run": it, "chi2": errors.tolist(),
        "pcg_iters": res.pcg_iters[:it].tolist(),
        "ate_initial": synthetic3d.pose_ate_rmse(
            graph.poses[:poses].numpy(), gt),
        "ate_final": synthetic3d.pose_ate_rmse(est[:poses], gt),
        "kernel_launches": launches,
        "b1_schedule_launches": b1_schedules,
        "finite": bool(np.isfinite(est).all() and np.isfinite(errors).all()),
        "reference": ref,
    }
    b1, b2 = (launches["fused_pcg_chunk"], launches["band_fused_pcg_chunk"])
    checks = {
        "kernel": (b1 > 0 and b2 == 0) if mode == "resident"
        else (b2 > 0 and b1 == 0) if mode == "band" else b1 == b2 == 0,
        "edges3d: 2 an assembly, 2 a chi^2":
            launches["edges3d"] == edges3d_launches(gn.config, it),
        "finite": m["finite"],
        "chi2_first": math.isclose(errors[0], ref["chi2"][0], rel_tol=1e-4),
        # LM with step rejection: chi^2 never rises
        "chi2 non-increasing": bool(np.all(np.diff(errors) <= 0.0)),
        "chi2_final": math.isclose(errors[-1], ref["chi2"][-1],
                                   rel_tol=ref["final_rtol"]),
    }
    if "ate_below" in ref:
        checks["ate_final"] = m["ate_final"] < ref["ate_below"]
    m["checks"] = checks
    log("ba_path " + json.dumps(m))
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"BA path {case} checks failed: {failed}")
    return m, gn, res.graph.with_state(gdev.poses, gdev.landmarks)


def phase_ba_path(device):
    """The bench row at 128 x 512 through B1, and ``python -m toyslam_torch
    ba3d`` at its defaults, in process, through B1 with U in shared
    memory."""
    import contextlib
    import io

    from toyslam_torch import app
    from toyslam_torch.ops import fused_pcg as fp

    m, gn, gdev = ba_optimize("ba128", device)
    assert m["mode"] == "resident"
    reset_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = app.main(["ba3d"])
    launches = read_counts()
    cli = json.loads(buf.getvalue().strip().splitlines()[-1])
    ref = BA_REF["ba3d_defaults"]
    cli["kernel_launches_by_kernel"] = launches
    cli["b1_schedule_launches"] = read_b1_schedules()
    plan = fp.b1_schedule(device.index or 0, 6, 64, 3 * cli["landmarks"],
                          0, 6)
    cli["resident_u_in_smem"] = plan.resident
    cli["b1_schedule"] = plan.schedule
    checks = {
        "exit 0": code == 0,
        "device": cli["device"] == "cuda",
        "B1 only": launches["fused_pcg_chunk"] == cli["kernel_launches"] > 0
        and launches["band_fused_pcg_chunk"] == 0,
        # the CLI's schedule rejects worse steps
        "edges3d: 2 an assembly, 2 a chi^2":
            launches["edges3d"] == 4 * cli["iterations_run"],
        "U in shared memory": cli["resident_u_in_smem"],
        "chi2_first": math.isclose(cli["chi2_first"], ref["chi2"][0],
                                   rel_tol=1e-4),
        "chi2_final": math.isclose(cli["chi2_final"], ref["chi2"][-1],
                                   rel_tol=ref["final_rtol"]),
        "ate_initial": abs(cli["ate_initial"] - ref["ate_initial"]) <= 1e-4,
        "ate_final": cli["ate_final"] < ref["ate_below"],
    }
    cli["checks"] = checks
    log("ba3d_cli " + json.dumps(cli))
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"ba3d CLI checks failed: {failed}")
    return {"ba128": m, "ba3d_defaults": cli}, gn, gdev


def phase_ba_scale_path(device):
    """512 poses x 4096 points through B2 (B1 at zero launches): the
    exp_ba512 fused row and its matched-budget row."""
    out = {}
    for case in ("ba512_policy", "ba512_matched"):
        m, gn, gdev = ba_optimize(case, device)
        assert m["mode"] == "band"
        out[case] = (m, gn, gdev)
    return out


def path_timing(gn, gdev, mode, rounds=3):
    """GN-iter/s as the median of ``rounds`` optimize() calls fenced with
    torch.cuda.synchronize(), the ms of each layer of the GN-iteration-0
    solve (CUDA events), and the device time from torch.profiler."""
    out = gn_rate(gn, gdev, rounds)
    state, layers = layer_system(gn, gdev, mode)
    out["layer_ms"] = {name: cuda_ms(fn, 3) for name, fn in layers}
    out["pcg_iters_iter0"] = int(state["res"].iterations)
    out["device"] = device_time(gn, gdev, reps=1)
    return out


# --- phases 14-18: the plain PCG loop, the dense solver, schur_grid -------


def gn_rate(gn, gdev, rounds):
    """GN-iter/s: GN iterations over the median of ``rounds`` optimize()
    calls fenced with torch.cuda.synchronize()."""
    import torch

    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = gn.optimize(gdev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return {"optimize_s_rounds": times,
            "optimize_s_median": statistics.median(times),
            "gn_iter_per_s": r.iterations_run / statistics.median(times),
            "iterations_run": r.iterations_run}


def failed_checks(name, checks):
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{name} checks failed: {failed}")


def phase_plain_loop(device, state):
    """The plain PCG loop (pcg_backend="xla") on the main path, the 10k
    scale path and the ba128 BA row, each held to its reference values with
    no PCG kernel launch, and its GN-iter/s beside the kernel path's of the
    same call.  The plain loop's tridiagonal preconditioner is built by the
    PCR kernel on the card as the kernel path's is: one launch a build."""
    import dataclasses

    from toyslam_torch.optimizer import GaussNewton
    from toyslam_torch.sim import frontend

    out = {}
    m, gn, gdev = run_path(150, device, pcg_backend="xla")
    checks = {
        "no PCG kernel launch": solve_launches(m["kernel_launches"]) == 0,
        "PCR kernel once a build": m["kernel_launches"]["pcr_factor"]
        == pcr_builds(gn.config, m["iterations_run"]),
        "finite": m["finite"],
        "pcg iterations": m["pcg_iters"] == MAIN_PCG_ITERS,
        "ate": abs(m["ate_rmse"] - ATE_REF) <= ATE_TOL,
        "chi2_first": math.isclose(m["chi2"][0], CHI2_FIRST, rel_tol=1e-4),
        "chi2_final": math.isclose(m["chi2"][-1], CHI2_FINAL, rel_tol=1e-3),
    }
    m["rate"] = gn_rate(gn, gdev, 1)
    m["kernel_path_gn_iter_per_s"] = state["timing"]["gn_iter_per_s"]
    log("plain_main_path " + json.dumps(m))
    failed_checks("plain-loop main path", checks)
    out["main"] = m

    gn = GaussNewton(dataclasses.replace(scale_config(), pcg_backend="xla"))
    gdev = state["sgdev"]
    reset_counts()
    res = gn.optimize(gdev)
    est = res.graph.poses.cpu().numpy()
    launches = read_counts()
    it = res.iterations_run
    errors = res.errors.cpu().numpy()[:it]
    poses_gt = state["sgt"]
    n = poses_gt.shape[0]
    m = {"chi2": errors.tolist(), "pcg_iters": res.pcg_iters[:it].tolist(),
         "ate_rmse": frontend.ate_rmse(est[:n], poses_gt),
         "kernel_launches": launches}
    checks = {
        "no PCG kernel launch": solve_launches(launches) == 0,
        "PCR kernel once a build": launches["pcr_factor"]
        == pcr_builds(gn.config, it),
        "iterations": it == SCALE_GN_ITERS,
        "pcg iterations": m["pcg_iters"] == [SCALE_PCG_ITERS] * SCALE_GN_ITERS,
        "chi2_first": math.isclose(errors[0], SCALE_CHI2_FIRST, rel_tol=1e-4),
        "chi2_final": math.isclose(errors[-1], SCALE_CHI2_FINAL,
                                   rel_tol=SCALE_REL),
        "ate": math.isclose(m["ate_rmse"], SCALE_ATE, rel_tol=SCALE_REL),
    }
    m["rate"] = gn_rate(gn, gdev, 1)
    m["kernel_path_gn_iter_per_s"] = state["scale_timing"]["gn_iter_per_s"]
    log("plain_scale_path " + json.dumps(m))
    failed_checks("plain-loop scale path", checks)
    out["scale"] = m

    m, gn, gdev = ba_optimize("ba128", device, pcg_backend="xla")
    assert m["mode"] is None
    m["rate"] = gn_rate(gn, gdev, 1)      # ~10 s an optimize() here
    m["kernel_path_gn_iter_per_s"] = state["ba_timing"]["gn_iter_per_s"]
    log("plain_ba128 " + json.dumps(m))
    out["ba128"] = m
    return out


def phase_dense(device, state):
    """``python -m toyslam_torch run --solver dense`` in process, held to
    the JAX package's dense values, and the dense GN-iter/s."""
    import contextlib
    import io

    from toyslam_torch import app
    from toyslam_torch.optimizer import GaussNewton
    from toyslam_torch.sim import frontend

    reset_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = app.main(["run", "--solver", "dense"])
    launches = read_counts()
    cli = json.loads(buf.getvalue().strip().splitlines()[-1])
    checks = {
        "exit 0": code == 0,
        "device": cli["device"] == "cuda",
        "no launch": cli["kernel_launches"] == 0
        and sum(launches.values()) == 0,
        "direct solves": cli["pcg_iters"] == [0] * cli["iterations_run"],
        "ate": abs(cli["ate_rmse"] - ATE_REF) <= ATE_TOL,
        "chi2_first": math.isclose(cli["chi2_first"], DENSE_CHI2_FIRST,
                                   rel_tol=1e-4),
        "chi2_final": math.isclose(cli["chi2_final"], DENSE_CHI2_FINAL,
                                   rel_tol=1e-3),
    }
    cfg = main_config(solver="dense")
    graph, _ = frontend.build_graph(frontend.simulate(cfg.sim), cfg)
    cli["rate"] = gn_rate(GaussNewton(cfg.optimizer), graph.to(device), 5)
    cli["kernel_path_gn_iter_per_s"] = state["timing"]["gn_iter_per_s"]
    log("dense_cli " + json.dumps(cli))
    failed_checks("dense", checks)
    return cli


def grid_config(case, backend):
    from toyslam_torch.config import OptimizerConfig

    return OptimizerConfig(**dict(GRID_BENCH, **GRID_CASES[case][1],
                                  pcg_backend=backend))


def phase_grid_paths(device):
    """The bench suite's two 10k rows through ``solver="schur_grid"``, each
    under pcg_backend "auto" (the gate's decision printed), "fused" (B2
    launched, B1 not) and "xla" (no launch), held to ``GRID_REF``; each
    timed (GN-iter/s, median of 2 rounds)."""
    import numpy as np

    from toyslam_torch.ops import grid_schur
    from toyslam_torch.optimizer import GaussNewton
    from toyslam_torch.sim import frontend, synthetic

    out, graphs = {}, {}
    for case, (graph_kw, _) in GRID_CASES.items():
        ref = GRID_REF[case]
        t0 = time.perf_counter()
        graph, poses_gt, _ = synthetic.make_large_problem(**graph_kw)
        t1 = time.perf_counter()
        graph = GaussNewton(grid_config(case, "fused"))._prepare(graph)
        t2 = time.perf_counter()
        gdev = graph.to(device)
        band = gdev.plan.band
        n = poses_gt.shape[0]
        decision = grid_schur._band_mode(grid_config(case, "auto"),
                                         gdev.plan, gdev.num_poses)
        row = {"poses_padded": gdev.num_poses,
               "landmarks_padded": gdev.num_landmarks,
               "kl_kp": [gdev.plan.L_pose.shape[0] // gdev.num_landmarks,
                         gdev.plan.P_pose.shape[0] // gdev.num_poses],
               "layout": {"chunk_b": band.chunk_b,
                          "k_windows": band.k_windows, "w_row": band.w_row,
                          "n_chunks": band.n_chunks, "n_wide": band.n_wide,
                          "tile_bytes": band.tile_bytes,
                          "cover_cap": int(band.cover.shape[-1])},
               "host_graph_build_s": t1 - t0, "host_grid_plan_s": t2 - t1,
               "auto_takes_band": decision, "runs": {}}
        failed = []
        for backend in ("auto", "fused", "xla"):
            gn = GaussNewton(grid_config(case, backend))
            reset_counts()
            res = gn.optimize(gdev)
            est = res.graph.poses.cpu().numpy()
            launches = read_counts()
            it = res.iterations_run
            errors = res.errors.cpu().numpy()[:it]
            b2 = launches["band_fused_pcg_chunk"]
            band_run = backend == "fused" or (backend == "auto" and decision)
            m = {"chi2": errors.tolist(),
                 "pcg_iters": res.pcg_iters[:it].tolist(),
                 "ate_rmse": frontend.ate_rmse(est[:n], poses_gt),
                 "ate_dead_reckoning": frontend.ate_rmse(
                     graph.poses[:n].numpy(), poses_gt),
                 "kernel_launches": launches}
            checks = {
                "launches": launches["fused_pcg_chunk"] == 0
                and ((b2 > 0) if band_run else (b2 == 0)),
                "PCR kernel once a build": launches["pcr_factor"]
                == pcr_builds(gn.config, it),
                "finite": bool(np.isfinite(est).all()
                               and np.isfinite(errors).all()),
                "iterations": it == gn.config.iterations,
                "chi2_first": math.isclose(errors[0], ref["chi2"][0],
                                           rel_tol=1e-4),
                "chi2_final": math.isclose(errors[-1], ref["chi2"][-1],
                                           rel_tol=1e-2),
                "ate_dr": abs(m["ate_dead_reckoning"] - ref["ate_dr"]) <= 1e-4,
            }
            if case.endswith("revisit"):
                checks["ate"] = math.isclose(m["ate_rmse"], ref["ate"],
                                             rel_tol=5e-2)
            m["rate"] = gn_rate(gn, gdev, 3)
            m["checks"] = checks
            row["runs"][backend] = m
            failed += [f"{backend}: {k}" for k, ok in checks.items() if not ok]
        log("grid_path " + json.dumps({case: row}))
        out[case] = row
        graphs[case] = gdev
        if failed:
            raise AssertionError(f"grid row {case} checks failed: {failed}")
    return out, graphs


def grid_operands(gdev, cfg):
    """The grid solve's GN-iteration-0 operands: the preconditioner of
    ``cfg`` (a FusedPrecond in band mode, else ``(local, coarse)``), the
    band operator, the right-hand side (``[dp, Np]`` and ``[Np, dp]``),
    the plain loop's matvec and preconditioner apply, and a function that
    builds the band operator."""
    import torch

    from toyslam_torch.ops import blockmath as bm
    from toyslam_torch.ops import fused_pcg as fp
    from toyslam_torch.ops import grid_schur as gs
    from toyslam_torch.ops import schur

    gp, n, m = gdev.plan, gdev.num_poses, gdev.num_landmarks
    lam = torch.tensor(cfg.lambda_init, device=gdev.device)
    d = gs._damp(gs._assemble(gdev, gp, cfg), lam)
    hll_inv = schur.inv_blocks(d.hll)
    matvec, s_diag = gs._matvec_factory(d, hll_inv, gp, n, m)
    lm_p = gp.P_lm.reshape(n, d.kp)
    rhs = -d.bp + bm.mv(d.hpl_P, bm.mv(hll_inv, d.bl)[lm_p]).sum(1)
    pre = gs._build_precond(cfg, d, hll_inv, s_diag(), gdev, gp)

    def build():
        return fp.build_band_operator_grid(
            d.hll, d.hpl_P, lm_p, d.hpp_diag,
            d.tupper * gp.C_mask[:, None, None], gp.band, n)

    return dict(pre=pre, op=build(), rhs2=rhs.T.contiguous(), rhs=rhs,
                matvec=matvec, build=build, d=d)


def phase_grid_kernel(graphs):
    """B2 on the grid path: timed on the 10k row's own iteration-0
    operands (coarse level nc=320) against its plain version and its
    bound, with its per-phase split; held against its plain version
    (fresh, carried, rerun bits) on a seeded system of the same layout
    and shapes."""
    import torch

    gdev = graphs["large-sparse-10k"]
    cfg = grid_config("large-sparse-10k", "fused")
    chunk = cfg.pcg_fused_chunk
    ops = grid_operands(gdev, cfg)
    op, pre, rhs2 = ops["op"], ops["pre"], ops["rhs2"]
    shapes = {"tiles": list(op.tiles.shape), "u": list(op.u.shape),
              "pcr_levels": pre.alphas.shape[0], "nc": pre.cinv.shape[-1],
              "rmat": list(pre.rmat.shape), "cinv": list(pre.cinv.shape)}
    times = chunk_times(op, pre, rhs2, chunk, kernel="band_fused_pcg_chunk",
                        reps=10)
    bound = chunk_bound(op, pre, rhs2, chunk)
    chunk16 = {"chunk_ms": chunk_times(op, pre, rhs2, 16, reps=10,
                                       kernel="band_fused_pcg_chunk"),
               "bound": chunk_bound(op, pre, rhs2, 16)}
    split = band_phase_split(op, pre, rhs2, chunk,
                             statistics.mean(times["kernel"]))
    split["bound"] = bound
    log("grid_band_phase_split " + json.dumps(split))
    band = gdev.plan.band
    win_off = band.win_off.cpu().numpy()
    del ops, op, pre
    torch.cuda.empty_cache()
    sop, spre, srhs = synthetic_band_system(
        gdev.num_poses, win_off, band.w_row, band.chunk_b * 2,
        2 * band.n_wide, shapes["pcr_levels"], cfg.pcg_coarse_group, 2e-2,
        seed=6, device=gdev.device)
    assert (list(sop.tiles.shape), spre.cinv.shape[-1]) == \
        (shapes["tiles"], shapes["nc"])
    out = compare_chunks("grid10k_L14_coarse320", sop, spre, srhs,
                         chunk=chunk, kernel="band_fused_pcg_chunk")
    # the plateau-10k rows' chunk (the default 16) on the same layout
    out += compare_chunks("grid10k_L14_coarse320_chunk16", sop, spre, srhs,
                          chunk=16, kernel="band_fused_pcg_chunk")
    del sop, spre, srhs
    torch.cuda.empty_cache()
    for r in out:
        log("grid_band_kernel_check " + json.dumps(r))
    log("grid_band_kernel " + json.dumps({"shapes": shapes,
                                          "chunk_ms": times,
                                          "bound": bound,
                                          "chunk16": chunk16}))
    bad = [r for r in out if not r["ok"]]
    if bad:
        raise AssertionError(
            f"band kernel disagrees with plain version on the grid layout: "
            f"{bad}")
    return {"max_abs": max(r["max_abs_err"] for r in out),
            "chunk_ms": times, "bound": bound, "split": split,
            "chunk16": chunk16}


def gate_fit_point(gdev, cfg):
    """One layout's data for the band-vs-grid cost model
    (grid_schur._band_cost_wins): per GN iteration the band operator's
    build (the tile write, and the slab-major copy on the slab schedule),
    B2's cost per launch at chunks of 15 and 5
    iterations and so per PCG trip, and the plain grid loop's cost per PCG
    iteration (15 and 5 iterations); the model's prediction and decision
    beside the measured costs."""
    import dataclasses

    import torch

    from toyslam_torch.ops import fused_pcg as fp
    from toyslam_torch.ops import grid_schur as gs
    from toyslam_torch.ops import schur

    gp, n = gdev.plan, gdev.num_poses
    band = gp.band
    fused = grid_operands(gdev, dataclasses.replace(cfg, pcg_backend="fused"))
    plain = grid_operands(gdev, dataclasses.replace(cfg, pcg_backend="xla"))
    op, pre, rhs2 = fused["op"], fused["pre"], fused["rhs2"]
    st = fresh_state(rhs2)
    atol2 = torch.zeros(1, device=rhs2.device)

    def launch(k):
        return lambda: fp.band_fused_pcg_chunk(op, pre, rhs2, st, atol2,
                                               200, True, k)

    papply = gs._precond_apply(cfg, plain["pre"])

    def loop(k):
        return lambda: schur.pcg(plain["matvec"], papply, plain["rhs"],
                                 0.0, k, k)

    b15, b5 = cuda_ms(launch(15), 5), cuda_ms(launch(5), 5)
    g15, g5 = cuda_ms(loop(15), 3), cuda_ms(loop(5), 3)
    # the tile write, and on the slab schedule the slab-major copy
    plan = fp.band_schedule(rhs2.device.index or 0, band.n_chunks,
                            band.k_windows, 3, band.w_row, band.chunk_b * 2,
                            0 if op.u is None else op.u.shape[1])
    build = cuda_ms(lambda: fp._slab_major(fused["build"]().tiles, plan.cols)
                    if plan.slab else fused["build"](), 3)
    rows = gp.L_pose.shape[0] + gp.P_pose.shape[0]
    fit_cfg = dataclasses.replace(cfg, pcg_max_iters=15)
    model = dict(zip(("band_s", "grid_s"), gs._cost_model(fit_cfg, gp)))
    out = {
        "n": n, "rows": rows, "stack_bytes": band.tile_bytes,
        "windows": band.n_chunks * band.k_windows,
        "band_build_ms": build, "b2_chunk15_ms": b15, "b2_chunk5_ms": b5,
        "b2_trip_ms": (b15 - b5) / 10,
        "grid_pcg15_ms": g15, "grid_pcg5_ms": g5,
        "grid_iter_ms": (g15 - g5) / 10,
        "measured_band_ms": build + b15, "measured_grid_ms": g15,
        "model": model,
        "model_takes_band": gs._band_cost_wins(fit_cfg, gp, n),
        "plan": plan._asdict(),
    }
    del fused, plain, op, pre
    torch.cuda.empty_cache()
    return out


def phase_grid_gate_fit(graphs, device):
    """The data of the band-vs-grid cost model at three layouts (the two
    10k rows and a 4096-pose graph; the 100k layout's point is phase
    band100k's), :func:`gate_fit_point` each (line ``grid_gate_fit``)."""
    from toyslam_torch.optimizer import GaussNewton
    from toyslam_torch.sim import synthetic

    small, _, _ = synthetic.make_large_problem(
        num_poses=4096, num_landmarks=4096, obs_per_pose=6, seed=0)
    cfg = grid_config("large-sparse-10k", "fused")
    layouts = dict(graphs)
    layouts["large-sparse-4k"] = GaussNewton(cfg)._prepare(small).to(device)
    out = {name: gate_fit_point(gdev, cfg) for name, gdev in layouts.items()}
    log("grid_gate_fit " + json.dumps(out))
    return out

# --- phases 19-21: the serving path, snapshots, the live loop -------------


class PlainCalls:
    """Counts calls of the kernels' plain versions and of the plain PCG
    loop while active: the serving path on the card must make none."""

    NAMES = (("fused_pcg", "fused_pcg_chunk_ref"),
             ("fused_pcg", "band_fused_pcg_chunk_ref"), ("schur", "pcg"),
             ("schur", "build_tridiag_planes_ref"))

    def __enter__(self):
        import functools
        import importlib

        self.count = 0
        self._saved = []
        for mod_name, name in self.NAMES:
            mod = importlib.import_module("toyslam_torch.ops." + mod_name)
            fn = getattr(mod, name)

            @functools.wraps(fn)
            def counted(*args, _fn=fn, **kw):
                self.count += 1
                return _fn(*args, **kw)

            self._saved.append((mod, name, fn))
            setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def cli_json(argv):
    """``python -m toyslam_torch <argv>`` in process: (exit code, the JSON
    line it printed)."""
    import contextlib
    import io

    from toyslam_torch import app

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = app.main(argv)
    lines = buf.getvalue().strip().splitlines()
    return code, (json.loads(lines[-1]) if lines else {})


def serve_connection(port, requests):
    """One ``GraphClient`` connection: each graph of ``requests`` sent in turn.
    Returns per request the answer, the wall ms and the launch counts."""
    import asyncio

    from toyslam_torch.io.client import GraphClient

    async def go():
        client = GraphClient("127.0.0.1", port)
        await client.connect()
        out = []
        try:
            for graph in requests:
                reset_counts()
                t0 = time.perf_counter()
                answer = await client.optimize(graph)
                out.append((answer, (time.perf_counter() - t0) * 1e3,
                            read_counts()))
        finally:
            await client.close()
        return out

    return asyncio.run(go())


def serve_concurrent(port, requests):
    """One client per graph of ``requests``, all in flight at once."""
    import asyncio

    from toyslam_torch.io.client import GraphClient

    async def one(graph):
        client = GraphClient("127.0.0.1", port)
        await client.connect()
        try:
            return await client.optimize(graph)
        finally:
            await client.close()

    async def go():
        return await asyncio.gather(*(one(g) for g in requests))

    return asyncio.run(go())


def serve_chunk(gn, gdev):
    """One fresh B1 chunk on the iteration-0 operands of a decoded request:
    its shapes, the kernel's and the plain version's time, the bound."""
    state, layers = layer_system(gn, gn._prepare(gdev))
    for _, fn in layers[:4]:        # assemble, eliminate, precond, operator
        fn()
    op, pre, rhs2 = state["op"], state["pre"], state["rhs2"]
    chunk = gn.config.pcg_fused_chunk
    return {"shapes": {"np": rhs2.shape[1], "mw": op.u.shape[-1],
                       "pcr_levels": pre.alphas.shape[0]},
            "chunk_ms": chunk_times(op, pre, rhs2, chunk, reps=20),
            "bound": chunk_bound(op, pre, rhs2, chunk)}


def phase_serve(device):
    """The serving path: both servers answer a client connection, two clients
    at once and the CLI's ``run --remote`` through B1 on the card."""
    import numpy as np
    import torch

    from toyslam_torch.io import codec
    from toyslam_torch.io.server import (
        PyGraphServer,
        native_server,
        torch_optimize_fn,
    )
    from toyslam_torch.optimizer import GaussNewton
    from toyslam_torch.sim import frontend

    cfg = main_config()
    sims = {n: frontend.simulate(main_config(n).sim) for n in (150, 2000)}
    graphs = {n: frontend.build_graph(sim, cfg)[0] for n, sim in sims.items()}
    # what a server must answer: a local optimize of the decoded graph
    gn = GaussNewton(cfg.optimizer)
    t0 = time.perf_counter()
    wire = codec.graph_to_bytes(graphs[150])
    t1 = time.perf_counter()
    decoded = codec.bytes_to_graph(wire)
    t2 = time.perf_counter()
    res_local = gn.optimize(decoded.to(device))
    local = res_local.graph.poses.cpu()
    # the PCR kernel's launches a 150-pose request makes: one a GN iteration
    builds150 = pcr_builds(cfg.optimizer, res_local.iterations_run)
    host = {"wire_bytes_150": len(wire), "encode_ms_150": (t1 - t0) * 1e3,
            "decode_ms_150": (t2 - t1) * 1e3}
    log("serve_codec " + json.dumps(host))
    real = graphs[150].pose_mask > 0.5

    def ate(answer, n):
        gt = sims[n].poses_gt
        return frontend.ate_rmse(answer.poses[: gt.shape[0]].numpy(), gt)

    ate_dr_2000 = frontend.ate_rmse(sims[2000].poses_dr, sims[2000].poses_gt)
    out, failed = {}, []
    servers = {
        "python": lambda: PyGraphServer(
            torch_optimize_fn(cfg.optimizer, device), port=0),
        "native": lambda: native_server(
            backend="torch", cfg=cfg.optimizer, port=0, device=device),
    }
    for kind, make in servers.items():
        with make() as server, PlainCalls() as plain:
            timings = server.optimize_fn.timings
            answers = serve_connection(
                server.port, [graphs[150]] * 3 + [graphs[2000]])
            error_after_connection = server.error
            rows = []
            for (answer, wall_ms, launches), t, n in zip(
                    answers, list(timings), (150, 150, 150, 2000)):
                rows.append({
                    "server": kind, "poses": n, "wall_ms": wall_ms,
                    "to_device_ms": t["to_device_ms"],
                    "serve_layout_ms": t["layout_ms"],
                    "solve_ms": t["solve_ms"],
                    "codec_transport_ms": wall_ms - sum(t.values()),
                    "ate_rmse": ate(answer, n), "kernel_launches": launches})
                log("serve_request " + json.dumps(rows[-1]))
            a150 = [r[0] for r in answers[:3]]
            both = serve_concurrent(server.port, [graphs[150], graphs[2000]])
            error_after_concurrent = server.error
            reset_counts()
            code, cli = cli_json(["run", "--remote",
                                  f"127.0.0.1:{server.port}"])
            cli_launches = read_counts()
            plain_calls = plain.count
        checks = {
            "server.error is None": error_after_connection is None
            and error_after_concurrent is None and server.error is None,
            "150-pose ATE": all(
                abs(r["ate_rmse"] - ATE_REF) <= ATE_TOL for r in rows[:3]),
            "2000-pose ATE below dead reckoning":
                rows[3]["ate_rmse"] < ate_dr_2000,
            "first and second answers bit-identical":
                torch.equal(a150[0].poses, a150[1].poses)
                and torch.equal(a150[0].landmarks, a150[1].landmarks),
            "remote equals local at 1e-5": bool(np.allclose(
                a150[0].poses[real].numpy(), local[real].numpy(),
                rtol=1e-5, atol=1e-5)),
            "25 B1 launches and one PCR launch a build per 150-pose request":
                all(r["kernel_launches"] == {"fused_pcg_chunk": 25,
                                             "band_fused_pcg_chunk": 0,
                                             "slab_band_matvec": 0,
                                             "pcr_factor": builds150,
                                             "edges3d": 0}
                    for r in rows[:3]),
            "2000-pose request through B1":
                rows[3]["kernel_launches"]["fused_pcg_chunk"] > 0
                and rows[3]["kernel_launches"]["band_fused_pcg_chunk"] == 0,
            "no plain-version call": plain_calls == 0,
            "concurrent clients: each its own answer":
                torch.equal(both[0].poses, a150[0].poses)
                and torch.equal(both[1].poses, answers[3][0].poses),
            "run --remote": code == 0 and cli.get("backend") == "remote"
            and abs(cli["ate_rmse"] - ATE_REF) <= ATE_TOL
            and cli["kernel_launches"] == 25
            and cli_launches["fused_pcg_chunk"] == 25
            and cli_launches["pcr_factor"] == builds150,
        }
        out[kind] = {"requests": rows, "checks": checks,
                     "remote_cli": cli, "plain_calls": plain_calls}
        failed += [f"{kind}: {k}" for k, ok in checks.items() if not ok]
    # B1's chunk on what a request's solve gives it: the decoded 150-pose
    # and 2000-pose graphs, laid out as the callback lays them out
    out["chunk"] = {
        150: serve_chunk(gn, decoded.to(device)),
        2000: serve_chunk(gn, codec.bytes_to_graph(
            codec.graph_to_bytes(graphs[2000])).to(device))}
    log("serve_kernel " + json.dumps(out["chunk"]))
    # nothing listens on port 1: the CLI falls back to the local optimizer
    reset_counts()
    code, cli = cli_json(["run", "--remote", "127.0.0.1:1"])
    launches = read_counts()
    checks = {
        "fallback": code == 0 and cli.get("backend") == "local"
        and cli["device"] == "cuda"
        and abs(cli["ate_rmse"] - ATE_REF) <= ATE_TOL
        and cli["kernel_launches"] == 25
        and launches["fused_pcg_chunk"] == 25,
    }
    out["fallback_cli"] = cli
    failed += [k for k, ok in checks.items() if not ok]
    log("serve " + json.dumps({
        "checks": {k: out[k]["checks"] for k in servers},
        "plain_calls": {k: out[k]["plain_calls"] for k in servers},
        "remote_cli": {k: out[k]["remote_cli"] for k in servers},
        "fallback_cli": cli}))
    if failed:
        raise AssertionError(f"serving path checks failed: {failed}")
    return out


def phase_snapshot(device):
    """``run --snapshot --profile`` in process (the trace holds CUDA
    activities), then ``load_snapshot`` and one more optimize of the loaded
    graph on the card (it continues the descent)."""
    import tempfile

    import torch

    from toyslam_torch.io.snapshot import load_snapshot
    from toyslam_torch.optimizer import GaussNewton

    with tempfile.TemporaryDirectory() as tmp:
        path, trace = str(Path(tmp) / "run.npz"), Path(tmp) / "trace"
        reset_counts()
        code, cli = cli_json(["run", "--snapshot", path,
                              "--profile", str(trace)])
        first = read_counts()
        graph, meta = load_snapshot(path)
        trace_bytes = sum(f.stat().st_size for f in trace.iterdir())
    reset_counts()
    res = GaussNewton(main_config().optimizer).optimize(graph.to(device))
    errors = res.errors.cpu().numpy()[: res.iterations_run]
    second = read_counts()
    out = {"cli": cli, "resumed_chi2": errors.tolist(),
           "trace_bytes": trace_bytes, "kernel_launches": [first, second]}
    checks = {
        "exit 0": code == 0 and cli.get("snapshot") == path,
        "profile trace written": trace_bytes > 10_000
        and cli.get("profile_trace") == str(trace),
        "metadata": meta["metrics"]["chi2_final"] == cli["chi2_final"],
        "ate": abs(cli["ate_rmse"] - ATE_REF) <= ATE_TOL,
        "the loaded graph is the optimized one":
            int(graph.pose_mask.sum()) == 150 and graph.plan is None
            and errors[0] < cli["chi2_final"],
        "descent continues": errors[-1] < errors[0]
        and bool(torch.isfinite(res.graph.poses).all()),
        "B1 launched both times": first["fused_pcg_chunk"] == 25
        and second["fused_pcg_chunk"] > 0,
    }
    log("snapshot " + json.dumps(out))
    failed_checks("snapshot", checks)
    return out


def phase_live(device):
    """``run --live --optimize-every 50 --save-plot`` at 150 steps in
    process, on the card.  matplotlib is an optional dependency: on a
    machine without it the loop runs without ``--save-plot`` (the line
    ``live`` says so) and the PNG check is left to the CPU tests."""
    import importlib.util
    import tempfile

    plot = importlib.util.find_spec("matplotlib") is not None
    with tempfile.TemporaryDirectory() as tmp:
        png = Path(tmp) / "live.png"
        reset_counts()
        code, cli = cli_json(
            ["run", "--live", "--optimize-every", "50", "--steps", "150"]
            + (["--save-plot", str(png)] if plot else []))
        launches = read_counts()
        png_bytes = png.stat().st_size if png.exists() else 0
    out = {"cli": cli, "matplotlib": plot, "png_bytes": png_bytes,
           "kernel_launches": launches}
    if not plot:
        log("live: matplotlib is not installed here, so --save-plot and the "
            "PNG check were left out of this run")
    checks = {
        "exit 0": code == 0 and cli.get("device") == "cuda",
        "frames": cli["frames"] == 149 and cli["optimizations"] == 3,
        "ate below dead reckoning":
            cli["ate_rmse"] < cli["ate_dead_reckoning"],
        "png written": png_bytes > 5000 or not plot,
        "launches": cli["kernel_launches"] > 0
        and cli["kernel_launches"] == launches["fused_pcg_chunk"],
    }
    log("live " + json.dumps(out))
    failed_checks("live", checks)
    return out


# --- phase 22: the 100k row ------------------------------------------------


def phase_band100k(device):
    """The JAX package's band-100k-jacobi-cg128 row through ``schur_grid``
    and B2 (coarse level nc=784), held to ``BAND100K_REF``; then B2 at that
    layout: timed on the row's own iteration-0 operands against its plain
    version and its bound, with its per-phase split, and held against its
    plain version on a seeded system of the same shapes."""
    import numpy as np
    import torch

    from toyslam_torch.config import NoiseConfig, OptimizerConfig
    from toyslam_torch.ops import fused_pcg as fp
    from toyslam_torch.ops import grid_schur
    from toyslam_torch.optimizer import GaussNewton
    from toyslam_torch.sim import frontend, synthetic

    import dataclasses

    cfg = OptimizerConfig(**BAND100K_CFG)
    gn = GaussNewton(cfg)
    t0 = time.perf_counter()
    graph, poses_gt, _ = synthetic.make_large_problem(
        noise=NoiseConfig(**BAND100K_NOISE), **BAND100K_GRAPH)
    t1 = time.perf_counter()
    graph = gn._prepare(graph)          # the grid plan and the band search
    t2 = time.perf_counter()
    gdev = graph.to(device)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    band, n_pad = gdev.plan.band, gdev.num_poses
    nc = n_pad // cfg.pcg_coarse_group
    m = {
        "poses_padded": n_pad, "landmarks_padded": gdev.num_landmarks,
        "lm_edges": int(graph.lm_edges.mask.sum()),
        "layout": {"chunk_b": band.chunk_b, "k_windows": band.k_windows,
                   "w_row": band.w_row, "n_chunks": band.n_chunks,
                   "n_wide": band.n_wide, "tile_bytes": band.tile_bytes,
                   "cover_cap": int(band.cover.shape[-1])},
        "nc": nc,
        "gate_takes_band": grid_schur._band_mode(cfg, gdev.plan, n_pad),
        "band_device_bytes": fp.band_device_bytes(
            3, n_pad, band, 2 * band.n_wide, 0, nc),
        "band_budget_bytes": fp.BAND_BUDGET_BYTES,
        "host_graph_build_s": t1 - t0, "host_grid_plan_s": t2 - t1,
        "to_device_s": t3 - t2,
    }
    log("band100k_setup " + json.dumps(m))
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t4 = time.perf_counter()
    res = gn.optimize(gdev)
    est = res.graph.poses.cpu().numpy()
    m["first_optimize_s"] = time.perf_counter() - t4
    launches = read_counts()
    it = res.iterations_run
    errors = res.errors.cpu().numpy()[:it]
    n = poses_gt.shape[0]
    m.update({
        "iterations_run": it, "chi2": errors.tolist(),
        "pcg_iters": res.pcg_iters[:it].tolist(),
        "ate_rmse": frontend.ate_rmse(est[:n], poses_gt),
        "ate_dead_reckoning": frontend.ate_rmse(graph.poses[:n].numpy(),
                                                poses_gt),
        "kernel_launches": launches,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
    })
    ref = BAND100K_REF
    checks = {
        "gate": m["gate_takes_band"],
        "launches": launches["band_fused_pcg_chunk"] > 0
        and launches["fused_pcg_chunk"] == 0,
        "finite": bool(np.isfinite(est).all() and np.isfinite(errors).all()),
        "iterations": it == cfg.iterations,
        "pcg iterations": m["pcg_iters"] == [ref["pcg_iters"]] * it,
        "chi2_first": math.isclose(errors[0], ref["chi2_first"],
                                   rel_tol=1e-4),
        "chi2_final": math.isclose(errors[-1], ref["chi2_final"],
                                   rel_tol=ref["final_rtol"]),
        "ate below dead reckoning":
            m["ate_rmse"] < m["ate_dead_reckoning"],
    }
    m["rate"] = gn_rate(gn, gdev, 3)
    # the same row through the plain grid loop (the JAX script's
    # grid-100k-jacobi-cg128 row, recorded with the same chi^2), and what
    # the cost model of pcg_backend="auto" would take
    m["auto_takes_band"] = grid_schur._band_mode(
        dataclasses.replace(cfg, pcg_backend="auto"), gdev.plan, n_pad)
    gn_plain = GaussNewton(dataclasses.replace(cfg, pcg_backend="xla"))
    reset_counts()
    res_p = gn_plain.optimize(gdev)
    errors_p = res_p.errors.cpu().numpy()[: res_p.iterations_run]
    plain_launches = read_counts()
    m["plain_loop"] = {
        "chi2": errors_p.tolist(),
        "pcg_iters": res_p.pcg_iters[: res_p.iterations_run].tolist(),
        "ate_rmse": frontend.ate_rmse(
            res_p.graph.poses[:n].cpu().numpy(), poses_gt),
        "kernel_launches": plain_launches,
        "rate": gn_rate(gn_plain, gdev, 3),
    }
    # auto's decision against the two routes' rates in this call: both
    # are host-timed (up to 2x between calls, PERF.md §7), so it must
    # agree wherever they part by more than 10 %
    band_s, plain_s = (m["rate"]["gn_iter_per_s"],
                       m["plain_loop"]["rate"]["gn_iter_per_s"])
    checks.update({
        "auto takes the faster route":
            abs(band_s - plain_s) <= 0.1 * max(band_s, plain_s)
            or m["auto_takes_band"] == (band_s > plain_s),
        "plain loop: no launch": sum(plain_launches.values()) == 0,
        "plain loop: chi2_first": math.isclose(
            errors_p[0], ref["chi2_first"], rel_tol=1e-4),
        "plain loop: chi2_final": math.isclose(
            errors_p[-1], ref["chi2_final"], rel_tol=ref["final_rtol"]),
    })
    del res_p
    m["checks"] = checks
    log("band100k_path " + json.dumps(m))
    failed_checks("100k row", checks)

    # B2 at this layout, on the row's own iteration-0 operands
    chunk = cfg.pcg_fused_chunk
    ops = grid_operands(gdev, cfg)
    op, pre, rhs2 = ops["op"], ops["pre"], ops["rhs2"]
    shapes = {"tiles": list(op.tiles.shape),
              "u": None if op.u is None else list(op.u.shape),
              "pcr_levels": pre.alphas.shape[0], "nc": pre.cinv.shape[-1],
              "rmat": list(pre.rmat.shape), "cinv": list(pre.cinv.shape)}
    times = chunk_times(op, pre, rhs2, chunk, kernel="band_fused_pcg_chunk",
                        reps=5)
    bound = chunk_bound(op, pre, rhs2, chunk)
    # exp_band100k's budget scan: chunk 10 (cap20) and 20 (cap40)
    by_chunk = {c: {"chunk_ms": chunk_times(op, pre, rhs2, c, reps=3,
                                            kernel="band_fused_pcg_chunk"),
                    "bound": chunk_bound(op, pre, rhs2, c)}
                for c in (10, 20)}
    split = band_phase_split(op, pre, rhs2, chunk,
                             statistics.mean(times["kernel"]))
    split["bound"] = bound
    split["by_cluster"] = band_plan_times(op, pre, rhs2, chunk,
                                          cluster_sizes(op, rhs2))
    for c, v in by_chunk.items():
        split[f"chunk{c}_stack_tb_per_s"] = (c + 1) * split["trip_bytes"][
            "stack"] / (statistics.mean(v["chunk_ms"]["kernel"]) * 1e-3) / 1e12
    # B2's device memory beside its operands: one launch's workspace and
    # outputs (the stack is read where it was built)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fp.band_fused_pcg_chunk(op, pre, rhs2, fresh_state(rhs2), torch.zeros(
        1, device=device), 200, True, chunk)
    torch.cuda.synchronize()
    split["launch_extra_bytes"] = torch.cuda.max_memory_allocated() - base
    split["stack_bytes"] = 4 * op.tiles.numel()
    log("band100k_phase_split " + json.dumps(split))
    log("band100k_kernel " + json.dumps({"shapes": shapes, "chunk_ms": times,
                                         "bound": bound,
                                         "by_chunk": by_chunk}))
    del ops, op, pre, rhs2
    torch.cuda.empty_cache()
    # the cost model's data at this layout (the other three: phase
    # grid_gate_fit)
    fit = gate_fit_point(gdev, cfg)
    log("band100k_gate_fit " + json.dumps(fit))
    win_off = band.win_off.cpu().numpy()
    w_row, b_dl, n_wide = band.w_row, band.chunk_b * 2, band.n_wide
    del gdev, res
    torch.cuda.empty_cache()
    sop, spre, srhs = synthetic_band_system(
        n_pad, win_off, w_row, b_dl, 2 * n_wide, 0, cfg.pcg_coarse_group,
        2e-2, seed=7, device=device, galerkin=False)
    assert (list(sop.tiles.shape), spre.cinv.shape[-1]) == \
        (shapes["tiles"], shapes["nc"])
    out = compare_chunks("grid100k_jacobi_coarse784", sop, spre, srhs,
                         chunk=chunk, kernel="band_fused_pcg_chunk")
    for c in by_chunk:
        out += compare_chunks(f"grid100k_jacobi_coarse784_chunk{c}", sop,
                              spre, srhs, chunk=c,
                              kernel="band_fused_pcg_chunk")
    del sop, spre, srhs
    torch.cuda.empty_cache()
    for r in out:
        log("band100k_kernel_check " + json.dumps(r))
    bad = [r for r in out if not r["ok"]]
    if bad:
        raise AssertionError(
            f"band kernel disagrees with plain version at 100k: {bad}")
    # the laid-out host graph, for exp_band100k's row in phase scale_entry
    return {"path": m, "max_abs": max(r["max_abs_err"] for r in out),
            "chunk_ms": times, "bound": bound, "split": split,
            "by_chunk": by_chunk, "gate_fit": fit,
            "graph": (graph, poses_gt, None)}


INCR100K_JAX = {"chi2_dead_reckoning": 5302700032.0,
                "chi2_after_init": 10811690.0, "chi2_final": 233443.7}


def incr100k_start(device):
    """The default-noise 100k graph on the card and the state that
    ``incremental_init(window=4096, iters_per_prefix=5)`` leaves
    (scripts/bench_plateau.py::run_100k_incr), laid out once for the
    ``schur_grid`` optimize that follows."""
    import dataclasses

    import torch

    from toyslam_torch.config import OptimizerConfig
    from toyslam_torch.ops import assemble
    from toyslam_torch.optimizer import GaussNewton
    from toyslam_torch.optimizer.coarse_init import incremental_init
    from toyslam_torch.sim import frontend, synthetic

    base = OptimizerConfig(
        iterations=80, lr=1.0, solver="schur_grid",
        exact_odom_jacobians=True, pcg_tol=1e-3, pcg_max_iters=60,
        pcg_restart_every=30, pcg_precond="tridiag+coarse",
        pcg_coarse_group=64, pcg_precond_refresh=5, convergence_eps=1e-4,
    )
    graph, poses_gt, _ = synthetic.make_large_problem(**BAND100K_GRAPH)
    n = poses_gt.shape[0]
    gdev = graph.to(device)

    def chi2(g):
        return float(assemble.total_error(
            g, huber_delta=base.huber_delta, exact_odom_jacobians=True))

    def ate(g):
        return frontend.ate_rmse(g.poses[:n].cpu().numpy(), poses_gt)

    m = {"chi2_dead_reckoning": chi2(gdev), "ate_dead_reckoning": ate(gdev),
         "jax_recorded": INCR100K_JAX}
    reset_counts()
    t0 = time.perf_counter()
    g_init = incremental_init(
        gdev, window=4096, iters_per_prefix=5,
        solver_cfg=dataclasses.replace(
            base, pcg_max_iters=30, pcg_restart_every=30,
            pcg_precond_refresh=0))
    torch.cuda.synchronize()
    m["init_s"] = time.perf_counter() - t0
    m["init_gn_iterations"] = 5 * -(-n // 4096)
    m["init_launches"] = read_counts()
    m["chi2_after_init"], m["ate_after_init"] = chi2(g_init), ate(g_init)
    del gdev
    return base, GaussNewton(base)._prepare(g_init), chi2, ate, m


def incr100k_optimize(cfg, gprep, chi2, ate):
    """One optimize from the initialised state; its record."""
    from toyslam_torch.optimizer import GaussNewton

    reset_counts()
    t0 = time.perf_counter()
    res = GaussNewton(cfg).optimize(gprep)
    final = chi2(res.graph)
    seconds = time.perf_counter() - t0
    it = res.iterations_run
    errors = res.errors.cpu().numpy()[:it]
    return {
        "optimize_s": seconds, "iterations_run": it,
        "diverged": bool(res.diverged), "chi2": errors.tolist(),
        "chi2_rises": int((errors[1:] > errors[:-1]).sum()),
        "pcg_iters_total": int(res.pcg_iters[:it].sum()),
        "chi2_final": final, "ate_rmse": ate(res.graph),
        "kernel_launches": read_counts()}


def as_float64(tup):
    """A NamedTuple of tensors (operator, preconditioner, chunk state) with
    every floating tensor in float64."""
    import torch

    return type(tup)(*(t.double() if torch.is_tensor(t)
                       and t.is_floating_point() else t for t in tup))


class ChunkTrace:
    """Stands in for ``fused_pcg.band_fused_pcg_chunk`` during an optimize:
    every launch also runs the plain version from the same state, and the
    differences are kept per launch (scaled as in :func:`compare_chunks`);
    the solve goes on with the kernel's result.  Where the two x part by
    more than ``F64_ABOVE`` of max|x|, the plain version runs that launch
    again in float64 on the same operands and state, and each f32 x's
    distance to its x is kept (``f64``, scaled by its max|x|)."""

    F64_ABOVE = 1e-3

    def __init__(self, kernel_fn, ref_fn):
        self.kernel_fn, self.ref_fn = kernel_fn, ref_fn
        self.rows = []
        self._f64_operands = (None, None, None, None)

    @property
    def launches(self):
        return self.kernel_fn.launches

    @launches.setter
    def launches(self, v):
        self.kernel_fn.launches = v

    def __call__(self, op, pre, rhs, st, atol2, maxit, restart, chunk):
        ker = self.kernel_fn(op, pre, rhs, st, atol2, maxit, restart, chunk)
        ref = self.ref_fn(op, pre, rhs, st, atol2, maxit, restart, chunk)
        rhs_max = float(rhs.abs().max())
        row = {
            "it_in": int(st.it), "restart": bool(restart),
            "it": [int(ker.it), int(ref.it)],
            "stop": [int(ker.stop), int(ref.stop)],
            "x": float((ker.x - ref.x).abs().max() / ref.x.abs().max()),
            "r_true": float((ker.rt - ref.rt).abs().max()) / rhs_max,
            "rr": abs(float(ker.rr) - float(ref.rr))
            / float((rhs * rhs).sum()),
            "rr_over_rhs2": float(ref.rr) / float((rhs * rhs).sum()),
        }
        if row["x"] > self.F64_ABOVE:
            if (self._f64_operands[0] is not op
                    or self._f64_operands[1] is not pre):
                # once per operator and preconditioner (per GN iteration)
                self._f64_operands = (None, None, None, None)
                self._f64_operands = (op, pre, as_float64(op),
                                      as_float64(pre))
            op64, pre64 = self._f64_operands[2:]
            r64 = self.ref_fn(op64, pre64, rhs.double(), as_float64(st),
                              atol2.double(), maxit, restart, chunk)
            scale = float(r64.x.abs().max())
            row["f64"] = {
                "kernel_x": float((ker.x - r64.x).abs().max()) / scale,
                "plain_x": float((ref.x - r64.x).abs().max()) / scale,
                "it": int(r64.it), "stop": int(r64.stop)}
        self.rows.append(row)
        return ker


def phase_incr100k_diag(device):
    """Development (``--only incr100k_diag``): where the band kernel's
    optimize and the plain grid loop's part on the initialised 100k
    default-noise graph.  From one initialised state: the kernel held
    against its plain version on a seeded system of this layout (17 PCR
    levels, nc=1568) and at every launch of an 80-iteration optimize on
    the row's own operands, and at each launch where their x part by more
    than 1e-3 of max|x|, both held against the plain version run in
    float64 (line ``incr100k_diag_f64``); then the same optimize with the
    kernel's plain version in its place, with a chunk of 15 (a direction
    restart every 30 iterations, as the plain loop's, where 16 restarts
    every 16), and through the plain grid loop."""
    import dataclasses

    import torch

    from toyslam_torch.ops import fused_pcg as fp

    base, gprep, chi2, ate, m = incr100k_start(device)
    plain_cfg = dataclasses.replace(base, pcg_backend="xla")
    base = dataclasses.replace(base, pcg_backend="fused")
    log("incr100k_diag_init " + json.dumps(m))
    band, n_pad = gprep.plan.band, gprep.num_poses
    nl = max(1, (n_pad - 1).bit_length())
    sop, spre, srhs = synthetic_band_system(
        n_pad, band.win_off.cpu().numpy(), band.w_row, band.chunk_b * 2,
        2 * band.n_wide, nl, base.pcg_coarse_group, 2e-2, seed=8,
        device=device, galerkin=False)
    out = compare_chunks(f"grid100k_L{nl}_coarse{spre.cinv.shape[-1]}",
                         sop, spre, srhs, chunk=base.pcg_fused_chunk,
                         kernel="band_fused_pcg_chunk")
    del sop, spre, srhs
    torch.cuda.empty_cache()
    for r in out:
        log("incr100k_diag_kernel_check " + json.dumps(r))

    runs = {}
    kernel_fn, ref_fn = fp.band_fused_pcg_chunk, fp.band_fused_pcg_chunk_ref
    trace = ChunkTrace(kernel_fn, ref_fn)

    def plain_chunk(*args):
        plain_chunk.launches += 1     # shown under the kernel's key
        return ref_fn(*args)

    plain_chunk.launches = 0
    try:
        fp.band_fused_pcg_chunk = trace
        runs["kernel_chunk16_traced"] = incr100k_optimize(
            base, gprep, chi2, ate)
        fp.band_fused_pcg_chunk = plain_chunk
        runs["plain_chunk16"] = incr100k_optimize(base, gprep, chi2, ate)
        runs["plain_chunk15"] = incr100k_optimize(
            dataclasses.replace(base, pcg_fused_chunk=15), gprep, chi2, ate)
    finally:
        fp.band_fused_pcg_chunk = kernel_fn
    runs["kernel_chunk15"] = incr100k_optimize(
        dataclasses.replace(base, pcg_fused_chunk=15), gprep, chi2, ate)
    runs["kernel_chunk16"] = incr100k_optimize(base, gprep, chi2, ate)
    runs["plain_loop"] = incr100k_optimize(plain_cfg, gprep, chi2, ate)
    rows = trace.rows
    worst = {k: max(r[k] for r in rows) for k in ("x", "r_true", "rr")}
    # per GN iteration (a solve starts where it_in is 0): the worst x
    per_gn = []
    for r in rows:
        if r["it_in"] == 0:
            per_gn.append(0.0)
        per_gn[-1] = max(per_gn[-1], r["x"])
    log("incr100k_diag_trace " + json.dumps({
        "launches": len(rows), "worst": worst,
        "it_or_stop_differ": sum(r["it"][0] != r["it"][1]
                                 or r["stop"][0] != r["stop"][1]
                                 for r in rows),
        "stops": sum(r["stop"][0] for r in rows),
        "worst_x_per_gn_iteration": per_gn,
        "first_launches": rows[:12]}))
    # which f32 x lies nearer the float64 plain version's, where they part
    f64 = [dict(r["f64"], x=r["x"], it_in=r["it_in"]) for r in rows
           if "f64" in r]
    if f64:
        log("incr100k_diag_f64 " + json.dumps({
            "launches": len(f64),
            "kernel_nearer": sum(r["kernel_x"] < r["plain_x"] for r in f64),
            "worst": {k: max(r[k] for r in f64)
                      for k in ("x", "kernel_x", "plain_x")},
            "median": {k: statistics.median(r[k] for r in f64)
                       for k in ("x", "kernel_x", "plain_x")},
            "rows": f64}))
    for name, r in runs.items():
        log("incr100k_diag_run " + json.dumps({name: r}))
    bad = [r for r in out if not r["ok"]]
    if bad:
        raise AssertionError(
            f"band kernel disagrees with plain version at the incr100k "
            f"layout: {bad}")
    return runs


def phase_incr100k(device):
    """The JAX package's plateau-100k-revisit-incr-init row
    (scripts/bench_plateau.py::run_100k_incr): the default-noise 100k
    graph, whose dead-reckoned start lies outside the Gauss-Newton basin,
    put inside it by ``incremental_init(window=4096, iters_per_prefix=5)``
    and then optimized once with 80 ``schur_grid`` iterations, all under
    ``pcg_backend="auto"``, which at this stack takes the plain grid loop.
    Truncated PCG makes such runs chaotic, so the JAX package's recorded
    values (``INCR100K_JAX``) are printed beside the run, which is held to:
    the initialisation puts chi^2 below 1 % of the dead-reckoned one and
    the optimize ends below 1.5 times the JAX package's final chi^2.

    Then B2 on this path (``pcg_backend="fused"``, ``tridiag+coarse``: 17
    PCR levels, nc=1568), 40 iterations from the same state twice: with a
    chunk of 15, so that the direction restarts every 30 iterations as the
    plain loop's does, held to 1.5 times the plain loop's chi^2 at that
    iteration; and with the config's own chunk of 16, the route ``auto``
    would take (a restart at every chunk), which it declines because that
    route ends above the plain loop for all its GN iterations a second:
    held to end more than 10 % above the loop's chi^2 at that iteration.
    Then one launch timed on the state's own operands against its plain
    version and its bound, and the kernel held against its plain version
    on a seeded system of this layout and these shapes."""
    import dataclasses

    import torch

    base, gprep, chi2, ate, m = incr100k_start(device)
    m.update(incr100k_optimize(base, gprep, chi2, ate))
    checks = {
        "init inside the basin":
            m["chi2_after_init"] < 1e-2 * m["chi2_dead_reckoning"],
        "auto takes the plain loop":
            solve_launches(m["init_launches"]) == 0
            and solve_launches(m["kernel_launches"]) == 0,
        "final chi2 within 1.5x of the JAX package's":
            m["chi2_final"] < 1.5 * INCR100K_JAX["chi2_final"],
    }
    fused = dataclasses.replace(base, pcg_backend="fused", pcg_fused_chunk=15,
                                iterations=40)
    runs = {c: incr100k_optimize(dataclasses.replace(
        fused, pcg_fused_chunk=c), gprep, chi2, ate)
        for c in (15, base.pcg_fused_chunk)}
    b2, b16 = runs[15], runs[base.pcg_fused_chunk]
    plain_at = m["chi2"][39] if m["iterations_run"] >= 40 else math.inf
    checks.update({
        "B2 launched": all(
            r["kernel_launches"]["band_fused_pcg_chunk"] > 0
            and r["kernel_launches"]["fused_pcg_chunk"] == 0
            for r in runs.values()),
        "B2 within 1.5x of the plain loop at its last iteration":
            b2["iterations_run"] == 40 and b2["chi2"][-1] < 1.5 * plain_at,
        "the route auto declines ends above the plain loop":
            b16["iterations_run"] == 40
            and 1.1 * plain_at < b16["chi2"][-1] < math.inf,
    })
    m["b2"] = dict(b2, plain_loop_chi2_at_last_iteration=plain_at)
    m["b2_config_chunk"] = dict(
        b16, gn_iter_per_s=b16["iterations_run"] / b16["optimize_s"])
    m["gn_iter_per_s"] = m["iterations_run"] / m["optimize_s"]
    m["checks"] = checks
    log("incr100k " + json.dumps(m))
    failed_checks("100k incremental initialisation", checks)

    chunk = fused.pcg_fused_chunk
    ops = grid_operands(gprep, fused)
    op, pre, rhs2 = ops["op"], ops["pre"], ops["rhs2"]
    shapes = {"tiles": list(op.tiles.shape),
              "pcr_levels": pre.alphas.shape[0], "nc": pre.cinv.shape[-1]}
    times = chunk_times(op, pre, rhs2, chunk, kernel="band_fused_pcg_chunk",
                        reps=3)
    bound = chunk_bound(op, pre, rhs2, chunk)
    log("incr100k_kernel " + json.dumps({"shapes": shapes, "chunk_ms": times,
                                         "bound": bound}))
    band, n_pad = gprep.plan.band, gprep.num_poses
    win_off = band.win_off.cpu().numpy()
    del ops, op, pre, rhs2
    torch.cuda.empty_cache()
    # the cost model's data at this layout with tridiag+coarse
    fit = gate_fit_point(gprep, base)
    log("incr100k_gate_fit " + json.dumps(fit))
    del gprep
    torch.cuda.empty_cache()
    sop, spre, srhs = synthetic_band_system(
        n_pad, win_off, band.w_row, band.chunk_b * 2, 2 * band.n_wide,
        shapes["pcr_levels"], base.pcg_coarse_group, 2e-2, seed=8,
        device=device, galerkin=False)
    assert (list(sop.tiles.shape), spre.cinv.shape[-1]) == \
        (shapes["tiles"], shapes["nc"])
    out = compare_chunks(
        f"grid100k_L{shapes['pcr_levels']}_coarse{shapes['nc']}", sop, spre,
        srhs, chunk=chunk, kernel="band_fused_pcg_chunk")
    del sop, spre, srhs
    torch.cuda.empty_cache()
    for r in out:
        log("incr100k_kernel_check " + json.dumps(r))
    bad = [r for r in out if not r["ok"]]
    if bad:
        raise AssertionError(
            f"band kernel disagrees with plain version at the incr100k "
            f"layout: {bad}")
    return {"path": m, "max_abs": max(r["max_abs_err"] for r in out),
            "chunk_ms": times, "bound": bound, "gate_fit": fit}


# --- phases 24-27: the sharded solves (toyslam_torch.parallel) ------------

# The launcher's config (python -m toyslam_torch.parallel.launch), that of
# the JAX package's dryrun_multichip modes 1 and 2 (__graft_entry__.py:113)
DIST_CFG = dict(iterations=10, solver="schur", pcg_tol=1e-8,
                pcg_max_iters=400)
DIST_NOTE = ("ranks sharing one card over gloo take turns on it: "
             "not a scaling number")
# dryrun_multichip mode 3 (__graft_entry__.py:166-174): the SE(3) graph and
# its config, with the JAX tests' pcg_chunk=8 and pcg_coarse_group=8
# (tests/test_partition3d.py), which only set the partition's alignment:
# with the defaults (64) all 48 poses fall on rank 0.  The float64 pin is
# the JAX test's chunk+coarse solve at tol 1e-14; GN runs in float64 with
# full steps (tests/test_torch_partition3d.py says why the ATE gate needs
# them).
DIST3D_GRAPH = dict(num_poses=48, num_landmarks=160, obs_per_pose=16,
                    seed=1)
DIST3D_CFG = dict(iterations=10, solver="schur3d", exact_odom_jacobians=True,
                  pcg_tol=1e-8, pcg_max_iters=600, pcg_precond="jacobi",
                  reject_worse_steps=True, huber_delta=4.0, pcg_chunk=8,
                  pcg_coarse_group=8, pcg_backend="xla")
DIST3D_F64 = dict(DIST3D_CFG, pcg_precond="chunk+coarse", pcg_tol=1e-14,
                  pcg_max_iters=2000)
DIST3D_GN = dict(DIST3D_CFG, iterations=6, lr=1.0,
                 pcg_precond="chunk+coarse")
# The partitioned path at full width: the workload of SCALING.json
# (scripts/bench_scaling_phases.py:47-53) with the coarse hierarchy of
# scripts/bench_scaling_v4.py:55-59, 10 GN iterations and a PCG cap of
# DIST_SCALE_CFG["pcg_max_iters"]
DIST_SCALE_GRAPH = dict(num_poses=2048, num_landmarks=2048, obs_per_pose=6,
                        seed=0, pose_bucket=256, landmark_bucket=256,
                        edge_bucket=1024)
DIST_SCALE_CFG = dict(iterations=10, lr=1.0, solver="schur",
                      exact_odom_jacobians=True,
                      pcg_precond="tridiag+coarse", pcg_coarse_group=64,
                      pcg_coarse_group2=4, pcg_tol=1e-6, pcg_max_iters=100,
                      pcg_backend="xla")
# The JAX package's partitioned run of DIST_SCALE on 4 fake CPU devices
# (JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_partition.py):
# chi^2 at the first and last GN iteration, PCG iterations per GN
# iteration, and the partition's boundary fractions
PART_REF = dict(chi2=(805616.0625, 1384.701416015625),
                pcg_iters=[100] * 10, boundary_pose_frac=0.00146484375,
                boundary_lm_frac=0.16859587317564168)


def dist_launch(procs):
    """``python -m toyslam_torch.parallel.launch`` in a subprocess on the
    card, both solves in one start of the ranks; its JSON object (with
    rank 0's trajectories) from ``--out``."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "launch.json"
        subprocess.run(
            [sys.executable, "-m", "toyslam_torch.parallel.launch",
             "--procs", str(procs), "--steps", "150",
             "--iterations", str(DIST_CFG["iterations"]), "--reps", "0",
             "--solve", "edge", "partition", "--device", "cuda",
             "--out", str(out)],
            cwd=ROOT, check=True, timeout=600, stdout=subprocess.DEVNULL)
        artifact = json.loads(out.read_text())
    artifact["launcher_s"] = time.perf_counter() - t0
    return artifact


def dist_single(device):
    """The single-device plain loop (pcg_backend="xla") on the launcher's
    graph and config, in this process: its poses and its GN-iter/s from
    that one optimize() fenced with torch.cuda.synchronize() (the plain
    loop compiles nothing)."""
    import torch

    from toyslam_torch.config import OptimizerConfig
    from toyslam_torch.optimizer import GaussNewton
    from toyslam_torch.sim import frontend

    cfg = main_config(150)
    graph, _ = frontend.build_graph(frontend.simulate(cfg.sim), cfg)
    gn = GaussNewton(OptimizerConfig(**dict(DIST_CFG, pcg_backend="xla")))
    gdev = gn._prepare(graph.to(device))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = gn.optimize(gdev)
    torch.cuda.synchronize()
    return {"poses": res.graph.poses.cpu().numpy()[:150],
            "gn_iter_per_s": res.iterations_run / (time.perf_counter() - t0)}


def phase_dist(device, solve, smi, state):
    """Phases 24-25: the launcher at 4 ranks on cuda:0 (gloo) and at 1 rank
    (NCCL), held to the single-device plain loop (run once for both
    phases) and the main path's ATE, with every rank's bits equal, no PCG
    kernel launched in any rank and one PCR launch a preconditioner build
    in each."""
    import numpy as np

    from toyslam_torch.config import OptimizerConfig

    if "dist_single" not in state:
        state["dist_single"] = dist_single(device)
    single = state["dist_single"]
    out = {}
    for procs, backend in ((4, "gloo"), (1, "nccl")):
        if procs not in state.setdefault("dist_launch", {}):
            state["dist_launch"][procs] = dist_launch(procs)
        launched = state["dist_launch"][procs]
        a = dict(launched["runs"][solve], num_processes=procs,
                 backend=launched["backend"],
                 device_rule=launched["device_rule"],
                 shared_card=launched["shared_card"],
                 launcher_s=launched["launcher_s"])
        r = a["result"]
        dev = float(np.abs(np.asarray(a.pop("trajectory")) -
                           single["poses"]).max())
        checks = {
            "ok": a["ok"],
            "backend": a["backend"] == backend,
            "bitwise across ranks": a["bitwise_agreement_across_processes"],
            "no PCG kernel launch in any rank": all(
                solve_launches(k) == 0 for k in a["kernel_launches"]),
            "PCR kernel once a build in every rank": all(
                k["pcr_factor"] == pcr_builds(
                    OptimizerConfig(**DIST_CFG), r["iterations_run"])
                for k in a["kernel_launches"]),
            "pose vs single-device": dev < 5e-3,
            "ate": abs(r["ate_rmse"] - ATE_REF) <= ATE_TOL,
            "iterations": r["iterations_run"] == DIST_CFG["iterations"],
        }
        a["max_pose_dev_vs_single"] = dev
        log(f"dist_{solve}_{procs} " + json.dumps(a))
        failed_checks(f"dist {solve} at {procs} ranks", checks)
        out[procs] = a
    log("dist_timing " + json.dumps({
        "mode": solve, "card": smi, "note": DIST_NOTE,
        "gn_iter_per_s": {"ranks_4": out[4]["result"]["gn_iters_per_s"],
                          "ranks_1": out[1]["result"]["gn_iters_per_s"],
                          "single_plain": single["gn_iter_per_s"]},
        "collective_ms": {"ranks_4": out[4]["result"]["collective_ms"],
                          "ranks_1": out[1]["result"]["collective_ms"]},
        "collectives_per_gn_iter": out[4]["result"][
            "collectives_per_gn_iter"],
    }))
    return out


def _dist3d_rank(mesh, graph):
    """One rank of phase 26: the f32 solve, partitioned, on the card (and
    its launches); on the CPU (``mesh.device``) the float64 pin and the
    float64 GN instead: the SE(3) edges' kernels take float32 alone."""
    import torch

    from toyslam_torch.config import OptimizerConfig
    from toyslam_torch.ops.collective import all_reduce
    from toyslam_torch.optimizer import GaussNewton
    from toyslam_torch.parallel import (
        gather_result,
        partitioned_linearize_solve,
    )

    reset_counts()
    all_reduce.calls = 0
    out = {}
    on_card = mesh.device.type == "cuda"
    name, kw, dt = (("f32", DIST3D_CFG, torch.float32) if on_card
                    else ("f64", DIST3D_F64, torch.float64))
    solve = partitioned_linearize_solve(OptimizerConfig(**kw), mesh)
    g = solve.prepare(graph.astype(dt))
    dxp, _, err, st = solve(g, torch.tensor(1e-3, dtype=dt,
                                            device=mesh.device))
    out[name] = {"dxp": dxp.cpu().numpy(), "err": float(err),
                 "pcg_iters": int(st.pcg_iters)}
    if not on_card:
        cfg = OptimizerConfig(**DIST3D_GN)
        solve = partitioned_linearize_solve(cfg, mesh)
        t0 = time.perf_counter()
        res = GaussNewton(cfg, solve=solve).optimize(
            graph.astype(torch.float64))
        poses, _ = gather_result(res, solve.meta, mesh)
        it = res.iterations_run
        out["gn"] = {"poses": poses.numpy(), "iterations_run": it,
                     "chi2": res.errors[:it].tolist(),
                     "seconds": time.perf_counter() - t0}
    out["launches"] = read_counts()
    out["collectives"] = all_reduce.calls
    return out


def phase_dist_partition3d(device, smi):
    """Phase 26: the partitioned SE(3) solve at 4 ranks against the
    single-device plain loop: chi^2 within 1e-4 and dx within 5e-2 of
    max|dx| in float32 on cuda:0; dx within 1e-8 in float64 and the
    float64 GN below 0.3 of the initial ATE on the CPU (the SE(3) edges'
    kernels take float32 alone and refuse float64 on the card)."""
    import numpy as np
    import torch

    from toyslam_torch.config import OptimizerConfig
    from toyslam_torch.optimizer import GaussNewton
    from toyslam_torch.ops.schur3d import schur3d_linearize_solve
    from toyslam_torch.parallel.launch import run_ranks
    from toyslam_torch.sim import synthetic3d

    graph, gt, _ = synthetic3d.make_ba_problem(**DIST3D_GRAPH)
    n = DIST3D_GRAPH["num_poses"]
    single = {}
    for name, kw, dt, dev in (("f32", DIST3D_CFG, torch.float32, device),
                              ("f64", DIST3D_F64, torch.float64, "cpu")):
        cfg = OptimizerConfig(**kw)
        g = GaussNewton(cfg)._prepare(graph).astype(dt).to(dev)
        dxp, _, err, _ = schur3d_linearize_solve(cfg)(
            g, torch.tensor(1e-3, dtype=dt, device=dev))
        single[name] = (dxp.cpu().numpy()[:n], float(err))
    gn = GaussNewton(OptimizerConfig(**DIST3D_GN))
    g64 = gn._prepare(graph).astype(torch.float64)
    t0 = time.perf_counter()
    single_gn = gn.optimize(g64)
    single_rate = single_gn.iterations_run / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    ranks = run_ranks(_dist3d_rank, 4, "cuda", (graph,))
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks64 = run_ranks(_dist3d_rank, 4, "cpu", (graph,))
    m = {"ranks": 4, "backend": "gloo", "run_ranks_s": wall,
         "run_ranks_cpu_s": time.perf_counter() - t0}
    for name, rs in (("f32", ranks), ("f64", ranks64)):
        dxp = np.concatenate([r[name]["dxp"] for r in rs])[:n]
        ref, err = single[name]
        m[name] = {"rel_dev": float(np.abs(dxp - ref).max()
                                    / np.abs(ref).max()),
                   "err": rs[0][name]["err"], "err_single": err,
                   "pcg_iters": rs[0][name]["pcg_iters"]}
    ate0 = synthetic3d.pose_ate_rmse(graph.poses.numpy()[:n], gt)
    gn = ranks64[0]["gn"]
    m["gn"] = {"ate_initial": ate0,
               "ate_final": synthetic3d.pose_ate_rmse(gn["poses"][:n], gt),
               "chi2": gn["chi2"], "seconds": gn["seconds"],
               "gn_iter_per_s": gn["iterations_run"] / gn["seconds"]}
    m["launches"] = [r["launches"] for r in ranks]
    m["collectives"] = {"f32": ranks[0]["collectives"],
                        "f64_and_gn": ranks64[0]["collectives"]}
    checks = {
        "err f32": abs(m["f32"]["err"] - m["f32"]["err_single"])
        < 1e-4 * m["f32"]["err_single"],
        "dx f32": m["f32"]["rel_dev"] < 5e-2,
        "dx f64": m["f64"]["rel_dev"] < 1e-8,
        "ate": m["gn"]["ate_final"] < 0.3 * ate0,
        "same trajectory on every rank": all(
            np.array_equal(r["gn"]["poses"], gn["poses"]) for r in ranks64),
        # no PCG, B3 or PCR kernel; each rank's float32 solve assembles
        # its edges once, through the SE(3) edges' kernels (two launches);
        # the float64 ranks run on the CPU and launch nothing
        "no launch in any rank": all(
            solve_launches(k) == 0 and k["pcr_factor"] == 0
            for k in m["launches"]),
        "no launch in any CPU rank": all(
            not any(r["launches"].values()) for r in ranks64),
        "edges3d: 2 in each rank's float32 assembly": all(
            k["edges3d"] == 2 for k in m["launches"]),
    }
    log("dist_partition3d " + json.dumps(m))
    failed_checks("dist partition3d", checks)
    log("dist_timing " + json.dumps({
        "mode": "partition3d", "card": smi, "note": DIST_NOTE,
        "gn_iter_per_s": {"ranks_4_f64_cpu": m["gn"]["gn_iter_per_s"],
                          "single_plain_f64_cpu": single_rate}}))
    return m


def _dist_scale_rank(mesh, graph):
    """One rank of phase 27: the partitioned GN of DIST_SCALE."""
    import torch

    from toyslam_torch.config import OptimizerConfig
    from toyslam_torch.ops.collective import all_reduce
    from toyslam_torch.optimizer import GaussNewton
    from toyslam_torch.parallel import (
        gather_result,
        partitioned_linearize_solve,
    )
    from toyslam_torch.parallel.launch import collective_ms

    cfg = OptimizerConfig(**DIST_SCALE_CFG)
    solve = partitioned_linearize_solve(cfg, mesh)
    g = solve.prepare(graph)
    reset_counts()
    all_reduce.calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = GaussNewton(cfg, solve=solve).optimize(g)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    poses, _ = gather_result(res, solve.meta, mesh)
    it = res.iterations_run
    return {"poses": poses.cpu().numpy(), "iterations_run": it,
            "chi2": res.errors[:it].tolist(),
            "pcg_iters": res.pcg_iters[:it].tolist(),
            "seconds": seconds, "collectives": all_reduce.calls,
            "collective_ms": collective_ms(mesh),
            "launches": read_counts(),
            "boundary_pose_frac": solve.meta.boundary_pose_frac,
            "boundary_lm_frac": solve.meta.boundary_lm_frac}


def phase_dist_scale(device, smi):
    """Phase 27: the partitioned path at full width (DIST_SCALE) at 4 ranks
    on cuda:0, held to the single-device plain loop (chi^2 first at rtol
    1e-4, final at 1e-3) and to the JAX package's partitioned run
    (PART_REF).  The poses are held to the single-device run only as far as
    the truncated PCG fixes them: the f32 solves stop at the cap short of
    the tolerance, and the graph's map drifts along weakly observed modes,
    so the single-device run's poses themselves move between caps of 100
    and 200 iterations; the partitioned run's may differ from the
    single-device run's by no more than that."""
    import dataclasses

    import numpy as np
    import torch

    from toyslam_torch.config import OptimizerConfig
    from toyslam_torch.optimizer import GaussNewton
    from toyslam_torch.parallel.launch import run_ranks
    from toyslam_torch.sim import synthetic

    graph, _, _ = synthetic.make_large_problem(**DIST_SCALE_GRAPH)
    n = DIST_SCALE_GRAPH["num_poses"]
    cfg = OptimizerConfig(**DIST_SCALE_CFG)
    gn = GaussNewton(cfg)
    gdev = gn._prepare(graph.to(device))
    t0 = time.perf_counter()
    ref = gn.optimize(gdev)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    it = ref.iterations_run
    ref_chi2 = ref.errors[:it].tolist()
    ref_poses = ref.graph.poses.cpu().numpy()[:n]
    deeper = GaussNewton(dataclasses.replace(
        cfg, pcg_max_iters=2 * cfg.pcg_max_iters)).optimize(gdev)
    floor = float(np.abs(deeper.graph.poses.cpu().numpy()[:n]
                         - ref_poses).max())
    ranks = run_ranks(_dist_scale_rank, 4, "cuda", (graph,))
    r = ranks[0]
    dev = float(np.abs(r["poses"][:n] - ref_poses).max())
    pcg_total = sum(r["pcg_iters"])
    m = {k: v for k, v in r.items() if k != "poses"}
    m.update(ranks=4, backend="gloo", max_pose_dev_vs_single=dev,
             single_pose_dev_cap_x2=floor, single_chi2=ref_chi2,
             single_pcg_iters=ref.pcg_iters[:it].tolist(),
             collectives_per_pcg_iter=r["collectives"] / max(pcg_total, 1),
             part_ref=PART_REF)
    checks = {
        "chi2_first": math.isclose(r["chi2"][0], ref_chi2[0], rel_tol=1e-4),
        "chi2_final": math.isclose(r["chi2"][-1], ref_chi2[-1],
                                   rel_tol=1e-3),
        "poses within the truncation's own spread": dev <= floor,
        "chi2_first vs JAX": math.isclose(r["chi2"][0], PART_REF["chi2"][0],
                                          rel_tol=1e-4),
        "chi2_final vs JAX": math.isclose(r["chi2"][-1], PART_REF["chi2"][1],
                                          rel_tol=1e-3),
        "boundary as JAX's": (r["boundary_pose_frac"],
                              r["boundary_lm_frac"]) == (
            PART_REF["boundary_pose_frac"], PART_REF["boundary_lm_frac"]),
        "same trajectory on every rank": all(
            np.array_equal(x["poses"], r["poses"]) for x in ranks),
        "no PCG kernel launch in any rank": all(
            solve_launches(x["launches"]) == 0 for x in ranks),
        "PCR kernel once a build in every rank": all(
            x["launches"]["pcr_factor"] == pcr_builds(
                OptimizerConfig(**DIST_SCALE_CFG), x["iterations_run"])
            for x in ranks),
    }
    log("dist_scale " + json.dumps(m))
    failed_checks("dist scale", checks)
    log("dist_timing " + json.dumps({
        "mode": "partition_scale", "card": smi, "note": DIST_NOTE,
        "gn_iter_per_s": {"ranks_4": it / r["seconds"],
                          "single_plain": it / single_s},
        "collective_ms": {"ranks_4": r["collective_ms"]},
        "collectives_per_pcg_iter": m["collectives_per_pcg_iter"]}))
    return m


# --- phase 28: the slab band matvec (B3) and its entry point -------------


def slab_pass_split(x, slab, W, B):
    """B3's device ms per tile launch and per partial sum over 20 matvecs
    launched back to back (``band_matvec.pass_ms``: CUDA events between
    the two), and the slab GB/s the tile launch reaches."""
    from toyslam_torch.ops import band_matvec as bmv

    main_ms, sum_ms = bmv.pass_ms(x, slab, W, B)
    return {"main": main_ms, "sum": sum_ms,
            "sum_share": sum_ms / (main_ms + sum_ms),
            "main_slab_gb_s": slab.numel() * 4 / (main_ms * 1e-3) / 1e9}


def graph_ms(fn, reps=20, rounds=3):
    """Device ms per call of ``fn`` with no host in the way: ``reps`` calls
    captured in one CUDA graph, replayed ``rounds`` times between CUDA
    events (after one replay to warm up); the least round."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return min(out)


def phase_slab_band_matvec(device):
    """Phase 28: B3 against its plain version on the card at the entry
    point's correctness shape and its four sweep shapes (Np=10240), on
    seeded inputs: within 1e-5 of max|want| (the JAX script's own bound),
    finite, of shape [3, Np], and the same bits on a second launch; each
    shape timed against its plain version (CUDA events, plain, kernel,
    kernel, plain) beside its bound, with the achieved slab GB/s, the share
    of the bound, its device time with no host in the way (graph_ms), each
    launch's device time (slab_pass_split) and its plan.  Then the entry
    point itself, ``toyslam_torch.scripts.exp_band_kernel.main(["--device",
    "cuda"])``, in process with the counts set to 0 just before it: every
    launch of its check and its sweep is B3's, none is B1's or B2's.  Last,
    the wrapper's host time per call at W=64 (``band_matvec_host``)."""
    import dataclasses

    import torch

    from toyslam_torch.ops import band_matvec as bmv
    from toyslam_torch.scripts import band_matvec_host
    from toyslam_torch.scripts import exp_band_kernel as ebk

    np_ = ebk.NP
    gen = torch.Generator(device=device).manual_seed(28)
    rows = {}
    for W, B in [ebk.CHECK, *ebk.SWEEP]:
        x = torch.randn(3, np_, generator=gen, device=device)
        slab = torch.randn(np_ // B, W, 6, B, generator=gen, device=device)
        want = bmv.slab_band_matvec_ref(x, slab, W, B)
        got = bmv.slab_band_matvec(x, slab, W, B)
        again = bmv.slab_band_matvec(x, slab, W, B)
        torch.cuda.synchronize()
        max_abs = float((got - want).abs().max())
        rel = max_abs / float(want.abs().max())
        same = torch.equal(got, again)

        def ker(x=x, slab=slab, W=W, B=B):
            bmv.slab_band_matvec(x, slab, W, B)

        def plain(x=x, slab=slab, W=W, B=B):
            bmv.slab_band_matvec_ref(x, slab, W, B)

        p1, k1, k2, p2 = (cuda_ms(plain, 5), cuda_ms(ker, 50),
                          cuda_ms(ker, 50), cuda_ms(plain, 5))
        b = bmv.bound(np_, W, B)
        per = (k1 + k2) / 2
        dev_ms = graph_ms(ker)
        rows[f"W{W}_B{B}"] = {
            "device_ms": dev_ms,
            "device_share_of_bound": b["bound_ms"] / dev_ms,
            "pass_ms": slab_pass_split(x, slab, W, B),
            "W": W, "B": B, "ok": bool(
                rel <= ebk.REL_TOL and same and tuple(got.shape) == (3, np_)
                and bool(torch.isfinite(got).all())),
            "rel": rel, "max_abs_err": max_abs, "rerun_identical": same,
            "ms": {"kernel": [k1, k2], "plain": [p1, p2]},
            "slab_gb_s": slab.numel() * 4 / (per * 1e-3) / 1e9,
            "share_of_bound": b["bound_ms"] / per,
            "plan": dataclasses.asdict(bmv.slab_plan(W, B)),
            **b}
        log("slab_band_check " + json.dumps(rows[f"W{W}_B{B}"]))
    bad = [k for k, r in rows.items() if not r["ok"]]
    if bad:
        raise AssertionError(f"B3 disagrees with its plain version: {bad}")

    reset_counts()
    entry = ebk.main(["--device", "cuda"])
    launches = read_counts()
    want_launches = 1 + len(ebk.SWEEP) * (1 + ebk.REPS * ebk.ROUNDS)
    host = band_matvec_host.host_us()
    m = {"shapes": rows, "entry_point": entry, "launches": launches,
         "host": host}
    log("slab_band_matvec " + json.dumps(
        {"entry_point": entry, "launches": launches}))
    log("slab_band_host " + json.dumps(host))
    failed_checks("slab band matvec", {
        "every shape checked": len(rows) == 1 + len(ebk.SWEEP),
        "entry point on the card": entry["device"] == "cuda"
        and len(entry["sweep"]) == len(ebk.SWEEP),
        "entry point through B3 only":
            launches["slab_band_matvec"] == want_launches
            and launches["fused_pcg_chunk"] == 0
            and launches["band_fused_pcg_chunk"] == 0,
        "entry point's check": entry["check"]["rel"] < ebk.REL_TOL,
    })
    return m


# --- phase 29: the benchmark entry points --------------------------------


def entry_lines(main_fn, argv):
    """An entry point's ``main(argv)`` (or any function of one argument) in
    process: what it returns (an exit code) and the JSON lines it
    printed."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = main_fn(argv)
    return code, [json.loads(line) for line in buf.getvalue().splitlines()
                  if line.startswith("{")]


def b1_on_system(device, cfg, graph):
    """B1 on a path's own GN-iteration-0 system (``cfg`` on ``graph``, laid
    out here): the operator (the ``r_true = rhs - S x`` of one kernel chunk
    against the plain operator on the same x, within 1e-5 of max|S x|), the
    solve (the chunked PCG through the kernel against the same loop through
    the plain version, at the config's tolerance and cap, within 1e-3 of
    max|x|), and one chunk timed against its plain version and its bound.
    The real system's gauge prior makes r_true an f32 difference x 1e6
    (phase 2 holds the chunk itself on seeded systems), so these are B1's
    acceptance bounds on the solve, not the chunk bounds of phase 2."""
    import torch

    from toyslam_torch.ops import fused_pcg as fp
    from toyslam_torch.optimizer import GaussNewton

    gn = GaussNewton(cfg)
    gdev = gn._prepare(graph).to(device)
    state, layers = layer_system(gn, gdev)
    for _, build in layers[:4]:       # assemble ... build_fused_operator
        build()
    op, pre, rhs = state["op"], state["pre"], state["rhs2"]
    chunk = cfg.pcg_fused_chunk
    atol2 = ((cfg.pcg_tol ** 2) * (rhs * rhs).sum()).reshape(1)
    ker = fp.fused_pcg_chunk(op, pre, rhs, fresh_state(rhs), atol2,
                             cfg.pcg_max_iters, True, chunk)
    sx = fp.fused_matvec_ref(op, ker.x)
    args = (op, pre, rhs, cfg.pcg_tol, cfg.pcg_max_iters, chunk,
            cfg.pcg_restart_every)
    xk = fp._chunked_pcg(fp.fused_pcg_chunk, *args)
    xr = fp._chunked_pcg(fp.fused_pcg_chunk_ref, *args)
    torch.cuda.synchronize()
    return {"shapes": {"np": rhs.shape[1], "mw": op.u.shape[-1],
                       "pcr_levels": pre.alphas.shape[0],
                       "nc": 0 if pre.cinv is None
                       else pre.cinv.shape[-1]},
            "operator_rel": float((ker.rt - (rhs - sx)).abs().max()
                                  / sx.abs().max()),
            "solve_rel": float((xk.x - xr.x).abs().max()
                               / xr.x.abs().max()),
            "solve_max_abs_err": float((xk.x - xr.x).abs().max()),
            "pcg_iters": [int(xk.iterations), int(xr.iterations)],
            "chunk_ms": chunk_times(op, pre, rhs, chunk),
            "bound": chunk_bound(op, pre, rhs, chunk),
            "u_bytes": op.u.numel() * 4,
            "resident_u_in_smem": b1_plan_of(op, pre, rhs).resident,
            "b1_plan": b1_plan_of(op, pre, rhs)._asdict()}


def multi_loop_b1(device):
    """B1 at multi-loop-1k's shape on that row's GN-iteration-0 system
    (:func:`b1_on_system`)."""
    from toyslam_torch.scripts import bench_suite

    name = "multi-loop-1k"
    m = b1_on_system(device, bench_suite.optimizer_config(name),
                     bench_suite.row_graph(name)[0])
    log("multi_loop_b1 " + json.dumps(m))
    return m


def phase_bench(device, smi):
    """Phase 29: the port's benchmark entry points in process.  ``python -m
    toyslam_torch.bench --reps 2 --rounds 2``: exit 0, the ATE within 2e-3
    of 0.7552, B1 launched and B2 not, the card's name and power limit;
    ``python -m toyslam_torch.scripts.bench_suite --quick``: exit 0, the
    eight rows in order, each row's gate (its accuracy and its kernel's
    launches, counted from 0 over its first optimize), multi-loop-1k
    through B1 and the 10k rows through B2 under ``auto``; then B1 at
    multi-loop-1k's shape on that row's own system (:func:`multi_loop_b1`:
    Np=1088, Mw=768, L=11)."""
    from toyslam_torch import bench
    from toyslam_torch.scripts import bench_suite

    code, (head,) = entry_lines(bench.main, ["--reps", "2", "--rounds", "2"])
    log("bench_headline " + json.dumps(head))
    suite_code, lines = entry_lines(bench_suite.main, ["--quick"])
    rows = {r["config"]: r for r in lines}
    for r in lines:
        log("bench_row " + json.dumps(r))
    ml = multi_loop_b1(device)
    failed_checks("bench", {
        "headline exit 0": code == 0,
        "headline ATE": abs(head["ate_rmse"] - ATE_REF) <= ATE_TOL,
        "headline through B1": head["kernel_launches"]["fused_pcg_chunk"] > 0
        and head["kernel_launches"]["band_fused_pcg_chunk"] == 0,
        "headline card": head["card"] == smi,
        "suite exit 0": suite_code == 0,
        "every row": tuple(rows) == bench_suite.ROWS,
        "every gate": all(r["gate"]["ok"] for r in lines),
        "multi-loop-1k resident":
            rows["multi-loop-1k"]["solver_mode"] == "resident",
        "10k rows band": all(
            rows[n]["solver_mode"] == "band"
            for n in ("large-sparse-10k", "large-sparse-10k-revisit")),
        "multi-loop B1 shape": ml["shapes"] == {
            "np": 1088, "mw": 768, "pcr_levels": 11, "nc": 0},
        "multi-loop operator": ml["operator_rel"] <= 1e-5,
        "multi-loop solve": ml["solve_rel"] <= 1e-3,
    })
    return {"headline": head, "rows": rows, "multi_loop": ml}


def phase_scale_entry(device, state):
    """Phase 30: the port's scale entry points in process, each held to its
    gate and its launches.  ``bench_plateau 10k`` at full depth (the two
    10k rows to their plateau through B2); ``bench_huge --rounds 1``
    (100k x 100k at full width: the plain grid loop); ``exp_band100k``'s
    cap20 and cap40 rows (B2 at chunks 10 and 20) on phase band100k's graph;
    ``bench_fused --reps 1 --rounds 1`` (both workloads, all five variants:
    B1 with and without the coarse level); ``exp_ba512``'s fused row (B2
    at dp=6); ``measure_native_baseline --rounds 1``.  Then B1 with the
    coarse level on the fused rows' own GN-iteration-0 systems at Np=192
    and Np=1088 (:func:`b1_on_system`)."""
    from toyslam_torch.scripts import (
        bench_fused,
        bench_huge,
        bench_plateau,
        bench_suite,
        exp_ba512,
        exp_band100k,
        measure_native_baseline,
    )

    out, checks = {}, {}

    def b_launches(row, kernel):
        return row["kernel_launches"][kernel]

    code, rows = entry_lines(bench_plateau.main, ["10k"])
    for r in rows:
        log("scale_plateau " + json.dumps(r))
    out["plateau"] = {r["config"]: r for r in rows}
    checks["plateau exit 0"] = code == 0
    checks["plateau rows"] = tuple(out["plateau"]) == bench_plateau.SUBSETS[
        "10k"]
    checks["plateau through B2"] = all(
        r["gate"]["ok"] and r["solver_mode"] == "band"
        and b_launches(r, "band_fused_pcg_chunk") > 0 for r in rows)

    code, rows = entry_lines(bench_huge.main, ["--rounds", "1"])
    (huge,) = rows
    log("scale_huge " + json.dumps(huge))
    out["huge"] = huge
    checks["huge exit 0 and gate"] = code == 0 and huge["gate"]["ok"]

    names = ("band-100k-jacobi-cg128-cap20", "band-100k-jacobi-cg128-cap40")
    summary, rows = entry_lines(
        lambda _: exp_band100k.run(device, names, reps=1, rounds=1,
                                   graph=state["band100k"]["graph"]), None)
    for r in rows:
        log("scale_band100k " + json.dumps(r))
    out["band100k"] = {r["config"]: r for r in rows if "config" in r}
    checks["band100k rows through B2"] = summary["ok"] and tuple(
        out["band100k"]) == names and all(
        b_launches(r, "band_fused_pcg_chunk") > 0
        for r in out["band100k"].values())

    code, rows = entry_lines(bench_fused.main, ["--reps", "1", "--rounds",
                                                "1"])
    for r in rows:
        log("scale_fused " + json.dumps(r))
    out["fused"] = {f"{r['config']}/{r['solver']}": r for r in rows}
    checks["fused exit 0"] = code == 0
    checks["fused every variant"] = len(rows) == 2 * len(bench_fused.VARIANTS)
    checks["fused variants through B1"] = all(
        b_launches(r, "fused_pcg_chunk") > 0 for r in rows
        if "-fused-" in r["solver"])

    code, rows = entry_lines(exp_ba512.main, [
        "--rows", "ba3d-512x4096-fused", "--reps", "1", "--rounds", "1"])
    for r in rows:
        log("scale_ba512 " + json.dumps(r))
    (ba,) = [r for r in rows if "config" in r]
    out["ba512"] = ba
    checks["ba512 fused row through B2"] = code == 0 and ba["gate"]["ok"] \
        and b_launches(ba, "band_fused_pcg_chunk") > 0

    code, rows = entry_lines(measure_native_baseline.main, ["--rounds", "1"])
    (native,) = [r["native_cpu"] for r in rows if "native_cpu" in r]
    log("scale_native " + json.dumps(native))
    out["native"] = native
    checks["native exit 0"] = code == 0

    # B1 with the coarse level on the fused rows' own systems
    coarse = {}
    for workload in bench_fused.WORKLOADS:
        graph = bench_suite.row_graph(workload)[0]
        for variant in ("schur-fused-tridiag+coarse",
                        "schur-fused-jacobi+coarse"):
            m = b1_on_system(device, bench_fused.optimizer_config(
                workload, variant), graph)
            m["launches"] = b_launches(out["fused"][f"{workload}/{variant}"],
                                       "fused_pcg_chunk")
            log("scale_b1_coarse " + json.dumps(
                dict(m, workload=workload, variant=variant)))
            coarse[f"{workload}/{variant}"] = m
    out["b1_coarse"] = coarse
    checks["B1 coarse shapes"] = sorted(
        (m["shapes"]["np"], m["shapes"]["nc"]) for m in coarse.values()) == [
        (192, 3), (192, 3), (1088, 17), (1088, 17)]
    checks["B1 coarse operator"] = all(m["operator_rel"] <= 1e-5
                                       for m in coarse.values())
    checks["B1 coarse solve"] = all(m["solve_rel"] <= 1e-3
                                    for m in coarse.values())
    out["checks"] = checks
    failed_checks("scale entry points", checks)
    return out


# --- phase 32: the PCR build's kernel ----------------------------------------

# The PCR kernel held against its plain version in float64 from the same
# float32 blocks: max |kernel - plain| within PCR_REL_TOL of max |plain|, for
# the alphas, the gammas and binv each (tests/test_torch_pcr_factor.py)
PCR_REL_TOL = 1e-5
# f32 operations a pose of one block inverse: the adjugate at dp=3 (27 for
# the cofactors, 5 for the determinant, a division, 9 scalings),
# Gauss-Jordan at dp=6
PCR_INVERSE_FLOPS = {3: 42, 6: 2 * 6 ** 3 + 6 ** 2}


def pcr_bound(dp, n):
    """The least time of one PCR build of ``n`` poses: the blocks read and
    the factors written once at the HBM rate, or the plain version's f32
    operations at the f32 peak (a level a pose: six dp x dp products, two
    block sums, two negations and an inverse; one inverse more at the
    start), whichever is larger."""
    levels = max(1, (n - 1).bit_length())
    nbytes = 4 * dp * dp * n * (2 + 2 * levels + 1)
    inv = PCR_INVERSE_FLOPS[dp]
    flops = n * (levels * (12 * dp ** 3 + 4 * dp ** 2 + inv) + inv)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOPS
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def pcr_path_chain(gn, gdev, mode="resident"):
    """A path's GN-iteration-0 S diagonal and chain coupling, block layout
    ``[N, dp, dp]``: what its preconditioner's PCR build reads."""
    from toyslam_torch.ops import schur

    state, layers = layer_system(gn, gdev, mode)
    for _, fn in layers[:2]:          # assemble; damp, eliminate, S diagonal
        fn()
    upper = schur.chain_upper(state["d"], gdev.odom.i, gdev.odom.j,
                              gdev.num_poses)
    return state["s_diag"].contiguous(), upper.contiguous()


def pcr_seeded_chain(n, dp, seed, device):
    """A seeded chain whose SPD diagonal blocks dominate their couplings
    (tests/test_torch_pcr_factor.py::_chain)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, dp, dp))
    diag = a @ a.transpose(0, 2, 1) / dp + 2.0 * np.eye(dp)
    upper = rng.normal(0.0, 0.3 * (3 / dp) ** 0.5, size=(n, dp, dp))
    upper[-1] = 0.0
    return (torch.tensor(diag, dtype=torch.float32, device=device),
            torch.tensor(upper, dtype=torch.float32, device=device))


def pcr_check(case, diag, upper):
    """The dispatch's factors (one kernel launch) against the plain version
    in float64 from the same blocks, and a second launch's bits."""
    import torch

    from toyslam_torch.ops import pcr, schur

    n, dp = diag.shape[0], diag.shape[1]
    before = pcr.pcr_factor.launches
    got = schur.build_tridiag_planes(diag.permute(1, 2, 0),
                                     upper.permute(1, 2, 0))
    again = schur.build_tridiag_planes(diag.permute(1, 2, 0),
                                       upper.permute(1, 2, 0))
    torch.cuda.synchronize()
    launches = pcr.pcr_factor.launches - before
    want = schur.build_tridiag_planes_ref(diag.double().permute(1, 2, 0),
                                          upper.double().permute(1, 2, 0))
    rel, max_abs = {}, 0.0
    for name, g, w in zip(("alphas", "gammas", "binv"), got, want):
        err = float((g.double() - w).abs().max())
        rel[name] = err / float(w.abs().max())
        max_abs = max(max_abs, err)
    same = all(torch.equal(g, a) for g, a in zip(got, again))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    return {"case": case, "poses": n, "dp": dp,
            "levels": pcr.pcr_levels(n), "launches": launches,
            "rel": rel, "max_abs_err": max_abs, "rerun_identical": same,
            "ok": launches == 2 and same and finite
            and all(e <= PCR_REL_TOL for e in rel.values())}


def queued_ms(fn, reps):
    """Mean device ms of ``fn``'s launch: CUDA events around each of
    ``reps`` calls queued behind a sleeping kernel, so the host's enqueue
    is not in them."""
    import torch

    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(int(2e5) * reps)   # ~0.1 ms of the card's clock a call
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.fmean(s.elapsed_time(e) for s, e in events)


def host_ms(fn, reps, sync):
    """Mean host ms of a call (``sync``: a call and a synchronize)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        if sync:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def pcr_times(diag, upper, reps=50):
    """One build through the kernel and through its plain version (float32
    on the card, the build before the kernel) in turns (plain, kernel,
    kernel, plain): the kernel's device ms, its host ms a call (enqueue
    only) and a call and a synchronize; the plain version's ms a call and a
    synchronize."""
    from toyslam_torch.ops import schur

    dp_, up_ = diag.permute(1, 2, 0), upper.permute(1, 2, 0)

    def kernel():
        schur.build_tridiag_planes(dp_, up_)

    def plain():
        schur.build_tridiag_planes_ref(dp_, up_)

    out = {"plain": [host_ms(plain, max(1, reps // 5), True)]}
    for _ in range(2):
        out.setdefault("kernel", []).append(queued_ms(kernel, reps))
        out.setdefault("kernel_host", []).append(host_ms(kernel, reps, False))
        out.setdefault("kernel_wall", []).append(host_ms(kernel, reps, True))
    out["plain"].append(host_ms(plain, max(1, reps // 5), True))
    return out


def phase_pcr_factor(device, state):
    """The PCR build's kernel (``ops/pcr.py``, ``pcr_factor_kernel``) on
    the paths' own operands, the GN-iteration-0 S diagonal and chain
    coupling of the main path (dp=3, Np=192), of the 10k scale path and of
    the ba128 BA row (dp=6, Np=128), and on seeded chains of the
    multi-loop-1k and ba3d-defaults layouts: each held against its plain
    version in float64 (``PCR_REL_TOL``, the same bits on a rerun, one
    launch a build), and the paths' three timed against the plain version
    and the bound (line ``pcr_factor``)."""
    import torch

    from toyslam_torch.ops import pcr

    chains = {
        "main_dp3": pcr_path_chain(state["gn"], state["gdev"]),
        "scale10k_dp3": pcr_path_chain(state["sgn"], state["sgdev"], "band"),
        "ba128_dp6": pcr_path_chain(state["bgn"], state["bgdev"]),
        "multiloop_dp3_seeded": pcr_seeded_chain(1088, 3, 11, device),
        "ba3d_dp6_seeded": pcr_seeded_chain(64, 6, 12, device),
    }
    checks = [pcr_check(case, *chain) for case, chain in chains.items()]
    for r in checks:
        log("pcr_check " + json.dumps(r))
    layouts = {}
    for case in ("main_dp3", "scale10k_dp3", "ba128_dp6"):
        diag, upper = chains[case]
        n, dp = diag.shape[0], diag.shape[1]
        layouts[case] = dict(
            poses=n, dp=dp, levels=pcr.pcr_levels(n),
            ms=pcr_times(diag, upper), bound=pcr_bound(dp, n),
            attrs=pcr.pcr_kernel_attrs(dp))
    torch.cuda.synchronize()
    out = {"checks": checks, "layouts": layouts,
           "max_abs": max(r["max_abs_err"] for r in checks)}
    log("pcr_factor " + json.dumps(layouts))
    bad = [r for r in checks if not r["ok"]]
    if bad:
        raise AssertionError(f"PCR kernel disagrees with plain version: "
                             f"{bad}")
    return out


# SE(3) edges: the largest error of the kernel's per-edge blocks over the
# largest entry of the float64 plain version's (each tensor), of its
# Jacobians per edge, and of the summed robust chi^2
EDGES3D_REL_TOL = {"blocks": 1e-5, "jacobians": 1e-5, "chi2": 1.5e-7}
# floating-point operations an edge, counted from csrc/edges3d.cu's
# arithmetic: the relative-pose residual, its 12 forward-mode directions
# and blocks / the residual alone; the reprojection with blocks / alone
EDGES3D_FLOPS = {"odom_blocks": 3500, "odom_residuals": 250,
                 "reproj_blocks": 400, "reproj_residuals": 45}


def edges3d_graph(device, near=None, moved=0.0):
    """The ba512 rows' graph (512 cameras, 4,096 points, seed 0) on the
    card, with ``near`` as a fifth intrinsic (the benchmark configuration's
    near plane) and its state moved by ``moved`` (cameras' rotations and
    translations, points) from a fixed seed: off the start, where the
    relative-pose residuals are rounding alone."""
    import dataclasses

    import numpy as np
    import torch

    from toyslam_torch.ops import se3
    from toyslam_torch.ops.gather_plan import attach_plan
    from toyslam_torch.sim import synthetic3d

    graph, _, _ = synthetic3d.make_ba_problem(512, 4096, 24, seed=0)
    graph = attach_plan(graph, want_band=False)
    if near is not None:
        graph = dataclasses.replace(graph, intrinsics=torch.cat(
            [graph.intrinsics, torch.tensor([near])]))
    rng = np.random.default_rng(7)
    step = torch.as_tensor(rng.normal(0.0, moved, graph.poses.shape[:1] + (6,)),
                           dtype=torch.float32)
    lm = torch.as_tensor(rng.normal(0.0, moved, graph.landmarks.shape),
                         dtype=torch.float32)
    graph = graph.with_state(se3.retract(graph.poses, step),
                             graph.landmarks + lm)
    return graph.to(device)


def edges3d_check(case, graph, start):
    """The dispatch's blocks (the relative-pose edges with the exact
    Jacobians and with ``A = -I, B = I``) and chi^2 on the card (two
    launches each) against the plain version in float64 on the CPU from the
    same float32 state, the kernel's relative-pose Jacobians against
    ``jacfwd``'s in float64, and a rerun's bits.  At the ``start`` the
    relative-pose residuals are float32 rounding alone (the initial
    cameras integrate them), and so are their gradients ``b_a``, ``b_b`` in
    either float32 version: reported, not held."""
    import torch

    from toyslam_torch.ops import edges3d_kernel as k3
    from toyslam_torch.ops import residuals3d as res3
    from toyslam_torch.ops import schur3d

    g64 = graph.astype(torch.float64).to("cpu")
    args = (graph.poses, graph.landmarks, graph.intrinsics, graph.odom,
            graph.lm_edges, 4.0)
    args64 = (g64.poses, g64.landmarks, g64.intrinsics, g64.odom,
              g64.lm_edges, 4.0)
    before = k3.launches
    got = schur3d.edge_blocks_3d(*args, exact=True)
    again = schur3d.edge_blocks_3d(*args, exact=True)
    fixed = schur3d.edge_blocks_3d(*args, exact=False)[0]
    blocks_launches = (k3.launches - before) // 3
    before = k3.launches
    chi2 = schur3d.total_error_3d(graph, 4.0)
    chi2_again = schur3d.total_error_3d(graph, 4.0)
    chi2_launches = (k3.launches - before) // 2
    ja, jb = k3.odom_jacobians(graph.poses, graph.odom, 4.0)
    torch.cuda.synchronize()
    want = schur3d.edge_blocks_3d(*args64, exact=True)
    want_fixed = schur3d.edge_blocks_3d(*args64, exact=False)[0]
    od = res3.eval_odom3d_edges(g64.poses, g64.odom.i, g64.odom.j,
                                g64.odom.meas, g64.odom.info, g64.odom.mask,
                                4.0, exact=True)
    chi2_64 = float(schur3d.total_error_3d(g64, 4.0))
    rel = {}
    for part, g, w in zip(("odom", "reproj", "odom_fixed"),
                          got + (fixed,), want + (want_fixed,)):
        for name, a, b in zip(w._fields, g, w):
            if name in ("robust_err", "chi2"):
                continue
            rel[f"{part}.{name}"] = float((a.cpu().double() - b).abs().max()
                                          / b.abs().max())
    jrel = {}
    for name, a, b in (("JA", ja, od.JA), ("JB", jb, od.JB)):
        err = (a.cpu().double() - b).abs().flatten(1).max(1).values
        jrel[name] = float((err / b.abs().flatten(1).max(1).values).max())
    chi2_rel = abs(float(chi2) - chi2_64) / chi2_64
    same = (all(torch.equal(a, b) for x, y in zip(got, again)
                for a, b in zip(x, y))
            and torch.equal(chi2, chi2_again))
    r = got[1]
    n_out = int((r.chi2 > 16.0).sum())
    tol = EDGES3D_REL_TOL
    held = {k: v for k, v in rel.items()
            if not (start and k.partition(".")[2] in ("b_a", "b_b")
                    and k.startswith("odom"))}
    ok = (max(held.values()) <= tol["blocks"]
          and max(jrel.values()) <= tol["jacobians"]
          and chi2_rel <= tol["chi2"] and same
          and blocks_launches == chi2_launches == 2)
    return {"case": case, "blocks_rel": rel, "jacobians_rel": jrel,
            "chi2_rel": chi2_rel, "huber_outliers": n_out,
            "launches_per_assembly": blocks_launches,
            "launches_per_chi2": chi2_launches, "same_bits": same, "ok": ok}


def edges3d_bound(graph, blocks):
    """The least time of one launch of each kernel at ``graph``'s sizes:
    its inputs read and outputs written once at the HBM rate, or its
    operations (``EDGES3D_FLOPS``) at the f32 peak."""
    n, m = graph.num_poses, graph.landmarks.shape[0]
    e1, e2 = graph.odom.count, graph.lm_edges.count
    poses = 4 * 12 * n
    out = {}
    for kernel, nbytes, flops in (
        ("odom", poses + e1 * (16 + 4 * (12 + 36 + 1))
         + 4 * e1 * ((3 * 36 + 2 * 6 + 1) if blocks else 1),
         e1 * EDGES3D_FLOPS["odom_blocks" if blocks else "odom_residuals"]),
        ("reproj", poses + 4 * 3 * m + 4 * graph.intrinsics.shape[0]
         + e2 * (16 + 4 * (2 + 4 + 1))
         + 4 * e2 * ((36 + 9 + 18 + 6 + 3 + 2) if blocks else 1),
         e2 * EDGES3D_FLOPS["reproj_blocks" if blocks else
                            "reproj_residuals"]),
    ):
        t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOPS
        out[kernel] = {"bound_ms": max(t_bytes, t_ops) * 1e3,
                       "bound_by": "bytes" if t_bytes >= t_ops
                       else "operations", "bytes": nbytes, "flops": flops}
    return out


def edges3d_times(graph, reps=200):
    """Each kernel's launch alone through its entry point (device ms,
    queued behind a sleep), the assembly's and the chi^2's pair through
    the dispatch (host ms a call, and a call and a synchronize), and the
    plain version's float32 on the card (ms a call and a synchronize), in
    turns (plain, kernel, kernel, plain)."""
    from toyslam_torch.ops import edge_blocks3d as eb3
    from toyslam_torch.ops import edges3d_kernel as k3
    from toyslam_torch.ops import residuals3d as res3
    from toyslam_torch.ops import schur3d

    g = graph
    args = (g.poses, g.landmarks, g.intrinsics, g.odom, g.lm_edges, 4.0)
    reproj = (g.poses, g.landmarks, g.intrinsics, g.lm_edges, 4.0)
    launch = {
        "odom_blocks": lambda: k3.odom_blocks(g.poses, g.odom, 4.0,
                                              exact=True),
        "reproj_blocks": lambda: k3.reproj_blocks(*reproj),
        "odom_residuals": lambda: k3.odom_errors(g.poses, g.odom, 4.0),
        "reproj_residuals": lambda: k3.reproj_errors(*reproj),
    }

    def assembly():
        schur3d.edge_blocks_3d(*args, exact=True)

    def chi2():
        schur3d.total_error_3d(g, 4.0)

    def plain_assembly():
        eb3.odom3d_edge_blocks(g.poses, g.odom.i, g.odom.j, g.odom.meas,
                               g.odom.info, g.odom.mask, 4.0, exact=True)
        eb3.reproj_edge_blocks(g.poses, g.landmarks, g.intrinsics,
                               g.lm_edges.pose, g.lm_edges.lm,
                               g.lm_edges.meas, g.lm_edges.info,
                               g.lm_edges.mask, 4.0)

    def plain_chi2():
        (res3.eval_odom3d_edges(g.poses, g.odom.i, g.odom.j, g.odom.meas,
                                g.odom.info, g.odom.mask, 4.0).robust_err.sum()
         + res3.eval_reproj_edges(
             g.poses, g.landmarks, g.intrinsics, g.lm_edges.pose,
             g.lm_edges.lm, g.lm_edges.meas, g.lm_edges.info,
             g.lm_edges.mask, 4.0).robust_err.sum())

    out = {"plain_assembly": [host_ms(plain_assembly, 5, True)],
           "plain_chi2": [host_ms(plain_chi2, 5, True)]}
    for _ in range(2):
        for name, fn in launch.items():
            out.setdefault(name, []).append(queued_ms(fn, reps))
        for name, fn in (("assembly", assembly), ("chi2", chi2)):
            out.setdefault(f"{name}_host", []).append(
                host_ms(fn, reps, False))
            out.setdefault(f"{name}_wall", []).append(host_ms(fn, reps, True))
    out["plain_assembly"].append(host_ms(plain_assembly, 5, True))
    out["plain_chi2"].append(host_ms(plain_chi2, 5, True))
    return out


def phase_edges3d(device, state):
    """The SE(3) edges' kernels (``ops/edges3d_kernel.py``,
    ``csrc/edges3d.cu``) at 512 cameras x 4,096 points: held against the
    plain version in float64 (``EDGES3D_REL_TOL``) at the start and off
    it, with four intrinsics and with the benchmark configuration's near
    plane, two launches an assembly and a chi^2, the same bits on a rerun,
    no spilled register; each launch timed against its bound and the plain
    version (line ``edges3d``)."""
    import torch

    from toyslam_torch.ops import edges3d_kernel as k3

    cases = {"ba512_start": edges3d_graph(device),
             "ba512_moved": edges3d_graph(device, moved=0.02),
             "ba512_near_start": edges3d_graph(device, near=0.5),
             "ba512_near_moved": edges3d_graph(device, near=0.5, moved=0.02)}
    checks = [edges3d_check(case, g, case.endswith("start"))
              for case, g in cases.items()]
    for r in checks:
        log("edges3d_check " + json.dumps(r))
    g = cases["ba512_near_moved"]
    attrs = k3.kernel_attrs()
    out = {"checks": checks, "attrs": attrs,
           "ms": edges3d_times(g),
           "bound": {"blocks": edges3d_bound(g, True),
                     "residuals": edges3d_bound(g, False)},
           "edges": {"odom": g.odom.count, "reproj": g.lm_edges.count}}
    torch.cuda.synchronize()
    log("edges3d " + json.dumps({k: v for k, v in out.items()
                                 if k != "checks"}))
    bad = [r["case"] for r in checks if not r["ok"]]
    spilled = [k for k, a in attrs.items() if a["local_bytes"]]
    if bad or spilled:
        raise AssertionError(f"edges3d kernels: checks failed {bad}, "
                             f"local memory in {spilled}")
    return out


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--only", metavar="PHASES", default=None,
        help="comma-separated phase names to run alone (development; "
             "prints no result line)")
    only = parser.parse_args(argv).only
    if not (ROOT / "toyslam_torch" / "csrc" / "fused_pcg_chunk.cu").exists():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(toyslam_torch/ not found beside it)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this smoke test runs only on "
              "the GPU", file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log("env " + json.dumps({
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "device": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }))

    from toyslam_torch import kernels

    t0 = time.perf_counter()
    libs = kernels.load_all(tuple(KERNELS))   # one nvcc each, in parallel
    load_s = time.perf_counter() - t0
    for name, kl in libs.items():
        log("build " + json.dumps({
            "kernel": name,
            "library": str(kl.path.relative_to(ROOT)),
            "nvcc_s": kl.build_seconds,
            "load_all_s": load_s,
        }))
        for line in kl.ptxas_log.splitlines():
            log("ptxas " + line.strip())

    failures = []
    state = {}
    phases = [
        ("kernels", lambda: state.update(max_abs=phase_kernels(device))),
        ("main_path", lambda: state.update(
            zip(("main", "gn", "gdev"), phase_main_path(device)))),
        ("timing", lambda: state.update(
            timing=phase_timing(state["gn"], state["gdev"]))),
        ("shape", lambda: state.update(shape=phase_shape(device))),
        ("scale_path", lambda: state.update(
            zip(("scale", "sgn", "sgdev", "sgt"), phase_scale_path(device)))),
        ("band_kernels", lambda: state.update(
            band=phase_band_kernels(state["sgn"], state["sgdev"]))),
        ("scale_timing", lambda: state.update(
            scale_timing=phase_scale_timing(state["sgn"], state["sgdev"]))),
        ("ba_kernels", lambda: state.update(
            ba_kernels=phase_ba_kernels(device))),
        ("ba_path", lambda: state.update(
            zip(("ba", "bgn", "bgdev"), phase_ba_path(device)))),
        ("ba_timing", lambda: state.update(ba_timing=path_timing(
            state["bgn"], state["bgdev"], "resident"))),
        ("ba_scale_path", lambda: state.update(
            ba_scale=phase_ba_scale_path(device))),
        ("ba_scale_timing", lambda: state.update(ba_scale_timing={
            case: path_timing(gn, gdev, "band", rounds=1)
            for case, (_, gn, gdev) in state["ba_scale"].items()})),
        ("plain_loop", lambda: state.update(
            plain=phase_plain_loop(device, state))),
        ("dense", lambda: state.update(dense=phase_dense(device, state))),
        ("grid_paths", lambda: state.update(
            zip(("grid", "ggraphs"), phase_grid_paths(device)))),
        ("grid_kernel", lambda: state.update(
            grid_kernel=phase_grid_kernel(state["ggraphs"]))),
        ("grid_gate_fit", lambda: state.update(
            grid_fit=phase_grid_gate_fit(state["ggraphs"], device))),
        ("serve", lambda: state.update(serve=phase_serve(device))),
        ("snapshot", lambda: state.update(snapshot=phase_snapshot(device))),
        ("live", lambda: state.update(live=phase_live(device))),
        ("band100k", lambda: state.update(
            band100k=phase_band100k(device))),
        ("incr100k", lambda: state.update(
            incr100k=phase_incr100k(device))),
        ("dist_edge", lambda: state.update(
            dist_edge=phase_dist(device, "edge", smi, state))),
        ("dist_partition", lambda: state.update(
            dist_partition=phase_dist(device, "partition", smi, state))),
        ("dist_partition3d", lambda: state.update(
            dist3d=phase_dist_partition3d(device, smi))),
        ("dist_scale", lambda: state.update(
            dist_scale=phase_dist_scale(device, smi))),
        ("slab_band_matvec", lambda: state.update(
            slab=phase_slab_band_matvec(device))),
        ("bench", lambda: state.update(bench=phase_bench(device, smi))),
        ("scale_entry", lambda: state.update(
            scale_entry=phase_scale_entry(device, state))),
        ("b1_layouts", lambda: state.update(
            b1_layouts=phase_b1_layouts(device))),
        ("pcr_factor", lambda: state.update(
            pcr=phase_pcr_factor(device, state))),
        ("edges3d", lambda: state.update(
            edges3d=phase_edges3d(device, state))),
    ]
    extra = {"incr100k_diag": lambda: phase_incr100k_diag(device)}
    if only is not None:
        wanted = only.split(",")
        phases = [(name, fn) for name, fn in phases + list(extra.items())
                  if name in wanted]
        unknown = sorted(set(wanted) - {name for name, _ in phases})
        if unknown:
            parser.error(f"unknown phases: {unknown}")
    for name, fn in phases:
        t0 = time.perf_counter()
        if name.startswith("dist_"):
            # the ranks are processes of their own on this card
            torch.cuda.empty_cache()
        try:
            fn()
            log(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)")
        except Exception:  # report every phase, then fail as a whole
            failures.append(name)
            log(f"phase {name}: FAILED\n{traceback.format_exc()}")
    for key in ("timing", "scale_timing", "ba_timing", "ba_scale_timing"):
        if key in state:
            log(f"{key} " + json.dumps(state[key]))
    if failures:
        print(f"chip_smoke.py: failed phases: {failures}", file=sys.stderr)
        return 1
    if only is not None:
        log(f"partial run ({only}): every phase passed; no result line")
        return 0

    # library_ms: no single PyTorch call computes a PCG chunk
    b1 = dict(KERNELS["fused_pcg_chunk"])
    b1.update(
        launches=state["main"]["kernel_launches"]["fused_pcg_chunk"],
        max_abs_err=state["max_abs"],
        ms=statistics.mean(state["timing"]["chunk_ms"]["kernel"]),
        plain_ms=statistics.mean(state["timing"]["chunk_ms"]["plain"]),
        bound_ms=state["timing"]["chunk_bound"]["bound_ms"],
        bound_by=state["timing"]["chunk_bound"]["bound_by"],
        library_ms=None,
    )
    b2 = dict(KERNELS["band_fused_pcg_chunk"])
    b2.update(
        launches=state["scale"]["kernel_launches"]["band_fused_pcg_chunk"],
        max_abs_err=state["band"]["max_abs"],
        ms=statistics.mean(state["band"]["chunk_ms"]["kernel"]),
        plain_ms=statistics.mean(state["band"]["chunk_ms"]["plain"]),
        bound_ms=state["band"]["bound"]["bound_ms"],
        bound_by=state["band"]["bound"]["bound_by"],
        library_ms=None,
    )
    # the dp=6 instances, on the BA paths: B1 on the bench row (128 x 512)
    # and the ba3d defaults, B2 on the two 512 x 4096 rows; timed at the
    # bench row's and at the 512 x 4096 layout's shapes
    bk = state["ba_kernels"]
    b1_case, b2_case = "dp6_Np128_Mw1536_L7", "dp6_ba512_band"
    ba_b1 = {"ba128": state["ba"]["ba128"]["kernel_launches"][
        "fused_pcg_chunk"],
        "ba3d_defaults": state["ba"]["ba3d_defaults"]["kernel_launches"]}
    ba_b2 = {case: m["kernel_launches"]["band_fused_pcg_chunk"]
             for case, (m, _, _) in state["ba_scale"].items()}
    b1["dp6"] = dict(
        launches=sum(ba_b1.values()), launches_by_path=ba_b1,
        max_abs_err=bk["b1_max_abs"],
        ms=statistics.mean(bk["ms"][b1_case]["kernel"]),
        plain_ms=statistics.mean(bk["ms"][b1_case]["plain"]),
        bound_ms=bk["bound"][b1_case]["bound_ms"],
        bound_by=bk["bound"][b1_case]["bound_by"], library_ms=None)
    b2["dp6"] = dict(
        launches=sum(ba_b2.values()), launches_by_path=ba_b2,
        max_abs_err=bk["b2_max_abs"],
        ms=statistics.mean(bk["ms"][b2_case]["kernel"]),
        plain_ms=statistics.mean(bk["ms"][b2_case]["plain"]),
        bound_ms=bk["bound"][b2_case]["bound_ms"],
        bound_by=bk["bound"][b2_case]["bound_by"], library_ms=None)
    # B2 on the schur_grid path: the launches of the "fused" and "auto" runs
    # of both 10k rows, timed on the 10k row's operands (nc=320)
    gk = state["grid_kernel"]
    b2["grid"] = dict(
        launches=sum(row["runs"][b]["kernel_launches"]["band_fused_pcg_chunk"]
                     for row in state["grid"].values()
                     for b in ("auto", "fused")),
        launches_by_path={
            f"{case}/{b}": row["runs"][b]["kernel_launches"][
                "band_fused_pcg_chunk"]
            for case, row in state["grid"].items() for b in ("auto", "fused")},
        max_abs_err=gk["max_abs"],
        ms=statistics.mean(gk["chunk_ms"]["kernel"]),
        plain_ms=statistics.mean(gk["chunk_ms"]["plain"]),
        bound_ms=gk["bound"]["bound_ms"], bound_by=gk["bound"]["bound_by"],
        library_ms=None)
    # B2 at 100k (schur_grid, nc=784) and B1 on the serving path: the
    # launches of the 100k row's first optimize, and of every request the
    # two servers answered over their client connections
    bk100 = state["band100k"]
    b2["grid100k"] = dict(
        launches=bk100["path"]["kernel_launches"]["band_fused_pcg_chunk"],
        max_abs_err=bk100["max_abs"],
        ms=statistics.mean(bk100["chunk_ms"]["kernel"]),
        plain_ms=statistics.mean(bk100["chunk_ms"]["plain"]),
        bound_ms=bk100["bound"]["bound_ms"],
        bound_by=bk100["bound"]["bound_by"], library_ms=None)
    # B2 on the 100k default-noise graph after incremental_init (17 PCR
    # levels, nc=1568): the launches of that path's two 40-iteration
    # optimizes, at chunks of 15 and 16
    bi = state["incr100k"]
    incr_b2 = {k: bi["path"][k]["kernel_launches"]["band_fused_pcg_chunk"]
               for k in ("b2", "b2_config_chunk")}
    b2["grid100k_incr"] = dict(
        launches=sum(incr_b2.values()), launches_by_path=incr_b2,
        max_abs_err=bi["max_abs"],
        ms=statistics.mean(bi["chunk_ms"]["kernel"]),
        plain_ms=statistics.mean(bi["chunk_ms"]["plain"]),
        bound_ms=bi["bound"]["bound_ms"],
        bound_by=bi["bound"]["bound_by"], library_ms=None)
    serve_b1 = {f"{kind}/{i}:{r['poses']}": r["kernel_launches"][
        "fused_pcg_chunk"]
        for kind in ("python", "native")
        for i, r in enumerate(state["serve"][kind]["requests"])}
    # timed and bound on the decoded requests' own operands; held against
    # the plain version in phase 2 at both requests' shapes (asserted)
    sk = state["serve"]["chunk"]
    assert [sk[n]["shapes"] for n in (150, 2000)] == [
        {"np": 192, "mw": 768, "pcr_levels": 8},
        {"np": 2048, "mw": 768, "pcr_levels": 11}], sk

    def serve_times(n):
        return dict(
            ms=statistics.mean(sk[n]["chunk_ms"]["kernel"]),
            plain_ms=statistics.mean(sk[n]["chunk_ms"]["plain"]),
            bound_ms=sk[n]["bound"]["bound_ms"],
            bound_by=sk[n]["bound"]["bound_by"])

    b1["serve"] = dict(
        launches=sum(serve_b1.values()), launches_by_path=serve_b1,
        max_abs_err=state["max_abs"], **serve_times(150),
        poses2000=serve_times(2000), library_ms=None)
    # B1 and B2 on the benchmark entry points (phase 29): the launches of
    # the headline's and of each suite row's first optimize; B1 timed and
    # bound on multi-loop-1k's own GN-iteration-0 system (Np=1088)
    bn = state["bench"]
    bench_launches = {"headline": bn["headline"]["kernel_launches"]} | {
        name: r["kernel_launches"] for name, r in bn["rows"].items()}
    ml = bn["multi_loop"]
    b1["bench"] = dict(
        launches=sum(c["fused_pcg_chunk"] for c in bench_launches.values()),
        launches_by_path={k: c["fused_pcg_chunk"]
                          for k, c in bench_launches.items()})
    b1["multi_loop_1k"] = dict(
        launches=bn["rows"]["multi-loop-1k"]["kernel_launches"][
            "fused_pcg_chunk"],
        shapes=ml["shapes"], max_abs_err=ml["solve_max_abs_err"],
        operator_rel=ml["operator_rel"], solve_rel=ml["solve_rel"],
        ms=statistics.mean(ml["chunk_ms"]["kernel"]),
        plain_ms=statistics.mean(ml["chunk_ms"]["plain"]),
        bound_ms=ml["bound"]["bound_ms"], bound_by=ml["bound"]["bound_by"],
        library_ms=None)
    b2["bench"] = dict(
        launches=sum(c["band_fused_pcg_chunk"]
                     for c in bench_launches.values()),
        launches_by_path={k: c["band_fused_pcg_chunk"]
                          for k, c in bench_launches.items()})
    # B1 and B2 on the scale entry points (phase 30): the launches of each
    # row's first optimize; the new shapes timed and bound on their rows'
    # own GN-iteration-0 operands: B1 with the coarse level (Np=192 nc=3,
    # Np=1088 nc=17), B2 on the 10k grid layout at the plateau rows' chunk
    # 16 (phase grid_kernel) and at 100k at chunks 10 and 20 (phase
    # band100k)
    se = state["scale_entry"]
    se_rows = {**{f"plateau/{k}": r for k, r in se["plateau"].items()},
               "huge-100k": se["huge"],
               **{f"band100k/{k}": r for k, r in se["band100k"].items()},
               **{f"fused/{k}": r for k, r in se["fused"].items()},
               "ba512/fused": se["ba512"]}

    def timed(ms, bound, launches):
        return dict(launches=launches,
                    ms=statistics.mean(ms["kernel"]),
                    plain_ms=statistics.mean(ms["plain"]),
                    bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                    library_ms=None)

    b1["scale_entry"] = dict(
        launches=sum(r["kernel_launches"]["fused_pcg_chunk"]
                     for r in se_rows.values()),
        launches_by_path={k: r["kernel_launches"]["fused_pcg_chunk"]
                          for k, r in se_rows.items()},
        coarse={k: dict(timed(m["chunk_ms"], m["bound"], m["launches"]),
                        shapes=m["shapes"], max_abs_err=m["solve_max_abs_err"],
                        operator_rel=m["operator_rel"],
                        solve_rel=m["solve_rel"])
                for k, m in se["b1_coarse"].items()})
    gk16 = state["grid_kernel"]["chunk16"]
    b2["scale_entry"] = dict(
        launches=sum(r["kernel_launches"]["band_fused_pcg_chunk"]
                     for r in se_rows.values()),
        launches_by_path={k: r["kernel_launches"]["band_fused_pcg_chunk"]
                          for k, r in se_rows.items()},
        plateau10k_chunk16=dict(timed(
            gk16["chunk_ms"], gk16["bound"],
            sum(r["kernel_launches"]["band_fused_pcg_chunk"]
                for r in se["plateau"].values())),
            max_abs_err=state["grid_kernel"]["max_abs"]),
        **{f"grid100k_chunk{c}": dict(timed(
            bk100["by_chunk"][c]["chunk_ms"], bk100["by_chunk"][c]["bound"],
            se["band100k"][f"band-100k-jacobi-cg128-cap{2 * c}"][
                "kernel_launches"]["band_fused_pcg_chunk"]),
            max_abs_err=bk100["max_abs"]) for c in (10, 20)})
    # B1 by schedule (phase 31): each schedule's launches on the paths
    # whose layouts take it (the main path and the ba3d defaults: the
    # one-cluster schedule; the 2000-pose shape check, the ba3d bench row and
    # multi-loop-1k: the card-wide grid), and its times at the layouts it
    # serves against its plain version, its bound and the cluster schedule
    bl = state["b1_layouts"]
    sched_paths = {
        "main_path": state["main"]["b1_schedule_launches"],
        "shape_2000": state["shape"]["b1_schedule_launches"],
        "ba128": state["ba"]["ba128"]["b1_schedule_launches"],
        "ba3d_defaults": state["ba"]["ba3d_defaults"]["b1_schedule_launches"],
        "multi-loop-1k": bl["multi_loop_path"]["b1_schedule_launches"],
    }
    b1["schedules"] = {}
    for sch in ("cluster", "split", "grid"):
        by_path = {k: c[sch] for k, c in sched_paths.items() if c[sch]}
        if not by_path:
            continue
        b1["schedules"][sch] = dict(
            launches=sum(by_path.values()), launches_by_path=by_path,
            layouts={name: dict(
                ms=statistics.mean(m["ms"][sch]),
                plain_ms=statistics.mean(m["plain_ms"]),
                bound_ms=m["bound"]["bound_ms"],
                bound_by=m["bound"]["bound_by"],
                max_abs_err=max(c["max_abs_err"]
                                for c in m["schedules"][sch]["checks"]),
                barrier_floor_ms=m["schedules"][sch]["barrier_floor_ms"],
                cluster_schedule_ms=statistics.mean(m["ms"]["cluster"]),
                library_ms=None)
                for name, m in bl["layouts"].items() if m["chosen"] == sch})
    # B3 on its entry point's run; headline numbers at W=576, B=512 (the
    # window the JAX script's docstring gives for the 10k workload), every
    # shape under by_shape.  library_ms: no single PyTorch call computes
    # this banded V V^T matvec (a dense V V^T product is other work)
    sl = state["slab"]["shapes"]

    def slab_times(r):
        return dict(ms=statistics.mean(r["ms"]["kernel"]),
                    plain_ms=statistics.mean(r["ms"]["plain"]),
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    share_of_bound=r["share_of_bound"],
                    device_ms=r["device_ms"])

    b3 = dict(KERNELS["slab_band_matvec"])
    b3.update(
        launches=state["slab"]["launches"]["slab_band_matvec"],
        max_abs_err=max(r["max_abs_err"] for r in sl.values()),
        **slab_times(sl["W576_B512"]), library_ms=None,
        by_shape={k: slab_times(r) for k, r in sl.items()})
    # the PCR build (phase 32): its launches on the paths, one a build;
    # timed on the main path's, the 10k scale path's and the ba128 row's own
    # GN-iteration-0 operands.  library_ms: no single PyTorch call factors
    # a block-tridiagonal chain
    pk = state["pcr"]
    pcr_paths = {
        "main_path": state["main"]["kernel_launches"]["pcr_factor"],
        "shape_2000": state["shape"]["kernel_launches"]["pcr_factor"],
        "scale_path": state["scale"]["kernel_launches"]["pcr_factor"],
        "ba128": state["ba"]["ba128"]["kernel_launches"]["pcr_factor"],
        "plain_loop_main": state["plain"]["main"]["kernel_launches"][
            "pcr_factor"],
    }

    def pcr_timed(lay):
        return dict(poses=lay["poses"], dp=lay["dp"], levels=lay["levels"],
                    ms=statistics.mean(lay["ms"]["kernel"]),
                    host_ms=statistics.mean(lay["ms"]["kernel_host"]),
                    wall_ms=statistics.mean(lay["ms"]["kernel_wall"]),
                    plain_ms=statistics.mean(lay["ms"]["plain"]),
                    bound_ms=lay["bound"]["bound_ms"],
                    bound_by=lay["bound"]["bound_by"], attrs=lay["attrs"],
                    library_ms=None)

    pf = dict(KERNELS["pcr_factor"])
    pf.update(launches=pcr_paths["main_path"], launches_by_path=pcr_paths,
              max_abs_err=pk["max_abs"],
              **pcr_timed(pk["layouts"]["main_dp3"]),
              by_layout={k: pcr_timed(v) for k, v in pk["layouts"].items()})
    # the SE(3) edges (phase 33): their launches on the BA paths, two an
    # assembly and two a chi^2; each kernel timed alone at 512 x 4096 with
    # the benchmark configuration's near plane, the launch of the assembly's
    # blocks as the headline.  library_ms: no single PyTorch call
    # evaluates these edges
    ek = state["edges3d"]
    e3_paths = {"ba128": state["ba"]["ba128"]["kernel_launches"]["edges3d"],
                "ba3d_defaults": state["ba"]["ba3d_defaults"][
                    "kernel_launches_by_kernel"]["edges3d"]}
    e3_paths.update({case: m["kernel_launches"]["edges3d"]
                     for case, (m, _, _) in state["ba_scale"].items()})

    def e3_timed(name, kind, blocks):
        ms = statistics.mean(ek["ms"][name])
        bound = ek["bound"]["blocks" if blocks else "residuals"][kind]
        return dict(ms=ms, bound_ms=bound["bound_ms"],
                    bound_by=bound["bound_by"],
                    share_of_bound=bound["bound_ms"] / ms, library_ms=None)

    e3 = dict(KERNELS["edges3d"])
    e3.update(
        launches=sum(e3_paths.values()), launches_by_path=e3_paths,
        **e3_timed("odom_blocks", "odom", True),
        by_launch={name: e3_timed(name, name.split("_")[0],
                                  name.endswith("blocks"))
                   for name in ("odom_blocks", "reproj_blocks",
                                "odom_residuals", "reproj_residuals")},
        plain_ms={k: statistics.mean(ek["ms"][f"plain_{k}"])
                  for k in ("assembly", "chi2")},
        max_rel_err=max(max(r["blocks_rel"].values()) for r in ek["checks"]
                        if not r["case"].endswith("start")),
        attrs=ek["attrs"])
    log(json.dumps({"kernels": [b1, b2, b3, pf, e3]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
