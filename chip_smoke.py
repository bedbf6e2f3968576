"""Drive the PyTorch port (conex_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. the card: name and power limit from nvidia-smi; no CUDA card fails;
2. build: the three sources (csrc/schur.cu, csrc/fused_socp.cu, once per
   working type, and csrc/schur_probes.cu) with nvcc, with the build time
   and ptxas's registers, shared memory, stack frame and spills for every
   entry (K2: one per TEAM, 8 and 32, route and type);
3. Schur kernel against plain: the CUDA Schur kernel (K1) against
   schur_plain on the card, in f64 (relative Frobenius error <= 1e-12) and
   in f32 against an f64 oracle (<= 1e-4), at four shapes (S, Bc, m, n): a
   small one (3, 2, 4, 13), many cones (2, 64, 20, 100), m + 1 above one
   Gram tile with a ragged n (3, 2, 70, 130), and the benchmark shape
   (256, 1, 50, 100); two kernel calls at the benchmark shape must give
   the same bits; CUDA-event times of both there, in turns;
3b. fused SOCP kernel against plain: the CUDA kernel against
   solve_socp_plain on the card, every field of FusedSOCPResult: iteration
   counts and status flags identical, the floating fields (y, y_kkt, w, k,
   the scalings, stats_k, stats_dinf) within a relative limit.  In f64
   (limit 1e-8: the two take every sum in the same order and agree to the
   bit; a change of order alone grows tenfold per iteration where k climbs
   fast) on small batches that reach every branch (feasible, infeasible, a
   factorization failure, refinement, the stall detector, dual recovery, a
   poisoned warmstart) and on a batch of 64 scenarios of 4 cones of dim 250
   and m = 16 whose working set (301 KB each) takes the global route, each
   under TEAM 32 and TEAM 8, and at the bench_socp shape (S = 1,000, 30
   fixed iterations).  In f32 at the
   bench_socp shape at S = 1,000, 10,000 and 100,000 (limit 1e-6, ten
   ulps: see F32_LIMIT); every call prints the plan it ran under
   (parallel/fused_socp.py::socp_plan: route, TEAM, scenarios per block,
   shared bytes); as an extra check, f32
   against an f64 oracle
   at S = 10,000: 30 iterations and no failure in both, median relative
   stats_k difference over iterations 1-2 <= 1e-3.  CUDA-event times of
   both at the three sizes;
3c. the probe kernels K3-K6 against their plain versions on the card (K3
   and K6 run K1's kernels, csrc/schur.cu, under K1's plan at S = 1, Bc =
   B, each record with that plan; K4 and K5 csrc/schur_probes.cu's), on
   the probes' inputs (seed 0): in f64 (relative
   Frobenius error <= 1e-12) at two small shapes (one with two tiles of
   the Gram matrix) and at the probe shape
   (B=256, m=50, n=100), in f32 against the f64 plain version (<= 1e-4) at
   the probe shape, where two f32 calls of each must give the same bits;
   on nonsymmetric inputs (uniform A, W, C) at (3, 5, 13) and (2, 70, 130)
   in f64 (<= 1e-12), with each variant's distance from einsum_schur
   beside it (K4 and K5 compute tr(A_v W A_u^T W^T), which leaves the
   oracle there); K4 and K5 print their plan (dev_pallas_probe.py::
   probe_at_plan); K1 on the same inputs as one program of 256 cones
   (S=1, Bc=256) against the same f64 oracle, with the same limits, and
   two of its f32 calls must give the same bits;
   CUDA-event times at the probe shape in f32 of each kernel and its plain
   version, and of the einsum_schur twin against K1 at S=1, in turns;
4. the SDP main path: bench.py's workload (B=256 dense SDPs, n=100, m=50,
   f32, 30 fixed Newton iterations) through conex_tpu_torch.solve_scenarios:
   every scenario must run exactly 30 iterations without a factorization
   failure, through the Schur kernel once per iteration; Newton it/s as the
   best of 3 runs; then a small f64 instance of the same configuration on
   the card against the same solve on the CPU (the plain path);
4b. the SOCP main path: `bench.py socp`'s workload (nc=1, n=20, m=10, f32,
   30 fixed iterations) through parallel.fused_socp.solve_socp_fused at
   S = 1,000, 10,000, 100,000: 30 iterations and no failure in every
   scenario, one kernel launch per call, Newton it/s as the best of 3 runs,
   and the plan of each size;
   the same workload at S = 10,000 through solve_scenarios with SOCCone
   (the general path), its it/s and its agreement with the fused path;
4c. the LP path (no kernel: K1 and K2 must not launch on it):
   benchmarks/bench_accuracy.py's dense LP (200 variables, 400
   inequalities, f64, seed 0, mu target 1e-8) through
   Program(device="cuda"), and a batch of 64 of them (scenario s drawn
   with seed s, A of 41 MB) through solve_scenarios, each in both mu
   modes (divergence and line search): every solve solved, relative gap
   <= 1e-7 and dual residual <= 1e-10 (bench_accuracy.py's measures), y
   within 1e-8 relative of the same solve on the CPU in as many
   iterations; the wall per solve (best of 3) and Newton it/s;
4d. the equality-constrained SDP through K1 and the LDLT: bench.py's SDP
   shape (S = 256 scenarios, one LMI each, n = 100, m = 50) plus p = 10
   equality rows per scenario (tests/test_equality.py::
   test_equality_with_sdp's recipe at n = 100, scenario s drawn with seed
   s), f64, kkt_solver LDLT (n_kkt = 60), at most 100 iterations, through
   solve_scenarios: every scenario solved, ||Aeq y - beq||_inf <= 1e-8 (1
   + ||beq||_inf), lambda_min(C - sum y_i A_i) >= -1e-7, scenarios 0-3
   solved again on the CPU with b'y within 1e-7 relative and iteration
   counts within the final-centering steps, and K1 launched once per loop
   pass; the wall per solve (best of 3), Newton it/s, the launches of one
   LDLT factor and of one profiled solve and the device's busy share;
4e. QPs at the LP path's width: tests/test_qp.py::qp_with_solution at
   n = 200 and 400 inequalities, f64, its QP_CONFIG with QP_ITERATIONS
   iterations, as one Program (seed 0) against the CPU (y to 1e-7
   relative, the iteration count within 5 of the range the CPU spans
   under one or two roundings of b; y within
   1e-5 of the known x_opt, the slack within 1e-4 of its known value) and
   as a batch of 64 (seeds 0-63) through solve_scenarios: every solve
   solved, y and slack within QP_BATCH_Y_LIMIT and QP_BATCH_SLACK_LIMIT
   (the JAX package reaches 1.7e-5 and 1.3e-4 on seed 11); seed 0 again through
   add_quadratic_cost_epigraph as Program(201) (a Q-weighted Lorentz cone,
   tests/test_quadratic_cone.py's configuration with 100 iterations
   allowed, EPIGRAPH_ITERATIONS), y within 1e-7 of x_opt;
   the walls, Newton it/s, the batch's launches and busy share; K1 and K2
   must not launch;
4f. the Hermitian path (no kernel of its own: K1 and K2 must not launch
   on it): benchmarks/bench_hermitian.py's batch (S = 32 scenarios, one
   complex (d = 2) LMI each, n = 64, m = 16, f32, 30 fixed iterations,
   scaled-k cap 100, seed 0) through solve_scenarios with HermitianCone:
   every scenario must run 30 iterations with no factorization failure;
   Newton it/s as the best of 3 runs with the warm eigenvector seeds and
   with the cold estimator forced (cones/hermitian.py FORCE_COLD), the same
   workload at d = 4 (quaternions, the same gate), the launches per
   iteration and the busy share of one profiled warm solve; then a small
   f64 batch on the card against the CPU (HERM_K_LIMIT, HERM_Y_LIMIT);
4g. the supernodal KKT path (Program with variable subsets; K1 once per
   LMI clique per assembly): which clique ordering ran (the native one,
   built with g++ from native/clique_ordering.cc, or the Python one);
   tests/test_compressed.py's two chain LPs (32 and 28 blocks, the second
   with equality rows: the LDLT) through Program(device="cuda") in f64 on
   the compressed structure, the sparse and the dense program's y within
   1e-6 and the sparse one within SPARSE_CPU_LIMIT of the CPU's;
   tests/test_interface.py's sparse Conex instance (solved, y as on the
   CPU); tests/test_failure_corpus.py's MPC case (finite, solved as on the
   CPU); a short f64 LMI chain (N = 8, nc = 4) on the unrolled and the
   compressed structure against the CPU (SPARSE_K_LIMIT, SPARSE_Y_LIMIT,
   printed beside what the CPU alone moves under one rounding of b); two
   compressed factors of one buffer giving the same bits; then
   benchmarks/bench_sparse.py's workload (chain_program: N LMI cliques of
   order 8 over 6-variable windows, one instance, f32, 30 fixed
   iterations, its SolverConfig) at SPARSE_RUNS, the structure switched
   through program.SCAN_CLIQUE_THRESHOLD as that script does: every run
   30 iterations without failure and K1 launched once per clique per
   iteration; per run Newton it/s and the wall of a solve, the launches
   per iteration, per KKT factor and the busy share of a profiled solve of
   SPARSE_PROFILE_ITERATIONS iterations; K1's time at the chain's shape
   (1, 1, 6, 8) against its plain version;
4h. multi-device execution (parallel/sharded.py) on the one card, every
   rank on it (NCCL allows one rank per device, so the multi-rank runs use
   gloo over CUDA tensors; no time here is a scaling figure): 4h-a, one
   program of SHARDED_SHAPE's 256 LMI cones (m = 50, n = 100, f32, the
   bench's 30 fixed iterations, built feasible as
   benchmarks/weak_scaling.py does, on the card from a seed) through the
   unsharded solve, then solve_cone_sharded on a one-rank NCCL mesh (y
   within SHARDED_Y_LIMIT of the unsharded solve) and on two and four gloo
   ranks spawned by parallel/launch.py (each runs K1 at (1, 256 / tp, 50,
   100)): 30 iterations, no failure and K1 30 times in every rank, the
   ranks' y equal to the bit; 4h-b, tests/test_distributed.py's sparse SOC
   chain at SHARDED_CHAIN (40 cliques, B = 4, f64) on four gloo ranks with
   both distributed structures, y within SHARDED_CHAIN_LIMIT of the
   unsharded supernodal solve on the card and on the CPU; 4h-c,
   solve_scenarios_cone_sharded on a (2, 2) mesh at SHARDED_GRID (f64),
   y within SHARDED_GRID_LIMIT of the per-scenario solves; each run prints
   its wall, Newton it/s, launches per iteration and its all-reduces
   (count and host time, from the profiler); K1 at one rank's shape
   (1, 64, 50, 100) against its plain version; 4h-d, utils/profiling.py's
   phase_timings of one 100 x 100 LMI program with m = 50 (f32);
5. a known answer: a small f64 SDP through Program(device="cuda"), against
   lambda_min(C) and the CPU solve;
5b. a known SOC answer through Program(device="cuda"): max b'y s.t.
   (1, y) in the Lorentz cone, y = b/|b|, and its dual, against the CPU;
5c. the LP known answer of the repository's verify notes (maximize
   y1 + 2 y2, optimum (1, 3), b'y = 7) on the card against the CPU, then
   a warmstart resume after save_state / load_state (at most 3
   iterations, as on the CPU);
5d. the equality, QR and QP-guard tests of the JAX package on the card:
   tests/test_equality.py's known optimum (against the CPU) and its KKT
   instance (stationarity through get_dual_variable and get_equality_dual,
   ||A'x + Aeq'lambda - b|| <= 1e-5), tests/test_failure_corpus.py's
   rank-deficient LP (LLT fails, QR solves), and tests/test_qp.py's guard
   (a quadratic cost without line search raises);
5e. the Hermitian known answers and the front ends on the card against
   the CPU: tests/test_interface.py's tridiagonal Hermitian LMI (y = -1)
   for d = 1, 2, 4, 8 through interface.Conex(device="cuda") (at d = 1 a
   dense LMI: K1 launches once per KKT assembly; at d > 1 it must not),
   tests/test_hermitian.py's octonion SDP (solved, mu falling, y and the
   iteration count as on the CPU), bench_accuracy.py's complex and
   quaternion Hermitian SDPs in f64 (solved, b'y within HERM_OBJ_LIMIT of
   the CPU's), and tests/test_sedumi.py's all-cone-types problem through
   sedumi.solve_sedumi(device="cuda") (its own assertions, and y as on the
   CPU);
5f. the C ABI, the MATLAB shim's sequence and the example on the card
   (conex_tpu_torch/interfaces, examples/performance_plots.py): the
   library built with cc (its build time and the libpython it links);
   tests/test_c_abi.py's six programs through it by ctypes in this process
   on the card (the LP with duals and iteration stats, box inequalities
   under LDLT, the sparse LMI, the quadratic cost, the incremental QP and
   LMI), each equal to the bit to the Python interface.Conex on the card
   and within ABI_CPU_LIMIT of the same program on the CPU; bench.py's
   scenario 0 at B = 1 in f64 (n = 100, m = 50) through
   CONEX_AddDenseLMIConstraint: solved, K1 once per KKT assembly, its
   100 x 100 dual read back through CONEX_GetDualVariable with <A_i, X> =
   b_i, y within ABI_WIDTH_CPU_LIMIT of the CPU's or within what one
   rounding of b moves the CPU alone; K1 at that shape against its plain
   version, with times; the same program from abi_host, a separate C
   process that starts with no interpreter, built dense and incrementally
   (252,500 CONEX_UpdateLinearOperator calls): both solved, y equal to the
   in-process y to ABI_HOST_LIMIT, its process and solve walls; the MATLAB
   shim's call sequence (interfaces/matlab/conex_tpu_torch.m) through
   ctypes at K.l = 100, K.s = [100], m = 50, y and the reassembled x held to
   sedumi.solve_sedumi on the card; the example's main on the card: every
   program solved, K1 on the mixed one only; the phase's time;
6. the probe entry points: benchmarks/dev_pallas_probe.py's main at
   256,50,100 and dev_tpu_probe2.py's part2 through their twins in
   conex_tpu_torch/benchmarks, on the card in f32: each variant's kernel
   must launch, and K1's main-path entry and K2 must not; then one K4
   call must hold no more device memory than its plan's scratch (no At
   copy of A), and one K3 call no more than its plan's panel scratch and
   partials.

The last lines are the whole run's time, the kernels' JSON record (K2's
and K3-K6's with their plans, K1's with its launches on phases 4, 4d, 4g,
4h (every rank's), 5e and 5f (this process's); with each kernel's bound:
the larger of its operations over the peak rate of the units that do
them and its bytes over 3.35 TB/s; every Schur kernel's products run on
the tensor cores, three TF32 passes per f32 product at 495 TFLOP/s), the
card's name and power limit, and {"ok": true, "device": {...}}.  Imports
nothing of JAX.
"""

import json
import subprocess
import sys
import time

SCHUR_SOURCE = "conex_tpu_torch/csrc/schur.cu"
SCHUR_REPLACES = "conex_tpu/cones/psd_pallas.py:48"
FUSED_SOURCE = "conex_tpu_torch/csrc/fused_socp.cu"
FUSED_REPLACES = "conex_tpu/parallel/fused_socp.py:234"
PROBE_SOURCE = "conex_tpu_torch/csrc/schur_probes.cu"
# (variant, its module in conex_tpu_torch/benchmarks, the TPU kernel, the
# CUDA source its kernels are in: K3 and K6 run K1's)
PROBES = (("fused_a", "dev_pallas_probe", "benchmarks/dev_pallas_probe.py:37",
           SCHUR_SOURCE),
          ("fused_b", "dev_pallas_probe", "benchmarks/dev_pallas_probe.py:69",
           PROBE_SOURCE),
          ("fused_b2", "dev_tpu_probe2", "benchmarks/dev_tpu_probe2.py:104",
           PROBE_SOURCE),
          ("fused_a2", "dev_tpu_probe2", "benchmarks/dev_tpu_probe2.py:180",
           SCHUR_SOURCE))
PROBE_SHAPE = (256, 50, 100)  # B, m, n: dev_pallas_probe.py:208
AT_LAYOUT = ("fused_b", "fused_b2")  # K4 and K5: tr(A_v W A_u^T W^T)
# The LP path: benchmarks/bench_accuracy.py:53-90's dense LP (m variables,
# n inequalities, f64, solved to mu = 1e-8), once through Program and as a
# batch of LP_BATCH scenarios (scenario s drawn with seed s) through
# solve_scenarios, in both mu modes.  Limits: the relative gap and dual
# residual of bench_accuracy.py:46-50 (the JAX package reaches 2.07e-8 and
# 1.98e-14 there, BENCH_ACCURACY.json), and a single solve's y within
# LP_Y_LIMIT relative of the same solve on the CPU with the same iteration
# count.
#
# Every scenario of the batch is held to the gap and the dual residual, and
# to the CPU by its objective (two solves within LP_GAP_LIMIT of the
# optimum lie within it of each other) and its iteration count (within
# the five final-centering steps of SolverConfig); the batch's median y to
# LP_Y_LIMIT.  Not every scenario's y to LP_Y_LIMIT in as many iterations:
# at this target the f64 iteration is as sensitive as that to one rounding.
# On an H100 the CPU alone, with b moved by 2^-52, moved y by up to 1.1e-5
# and the iteration count in 6 of 64 scenarios, as the card did (up to
# 1.0e-5, in 3), while each y lies up to 1.6e-4 from its exact vertex
# (this phase prints all three, every run).
LP_SHAPE = (200, 400)  # m, n
LP_BATCH = 64
LP_GAP_LIMIT = 1e-7
LP_DUAL_LIMIT = 1e-10
LP_Y_LIMIT = 1e-8
LP_CENTERING_SPREAD = 5
# The indefinite-KKT path (phases 4d, 4e, 5d).  4d: bench.py's SDP shape
# (S scenarios, one LMI of order n over m variables) plus p equality rows
# per scenario, tests/test_equality.py::test_equality_with_sdp's recipe at
# order n (eq_sdp_instance), f64, LDLT; scenarios 0 to EQ_SDP_CPU - 1
# solved again on the CPU.  4e: tests/test_qp.py's qp_with_solution at
# bench_accuracy's size (n variables, num_ineqs inequalities), f64, its
# QP_CONFIG with 100 iterations (qp_config), as one Program and as a
# batch of QP_BATCH (scenario s drawn with seed s).
EQ_SDP_SHAPE = (256, 100, 50, 10)  # S, n, m, p
EQ_SDP_CPU = 4
EQ_SDP_ITERATIONS = 100
EQ_FEAS_LIMIT = 1e-8  # ||Aeq y - beq||_inf / (1 + ||beq||_inf)
EQ_PSD_LIMIT = -1e-7  # lambda_min(C - sum_i y_i A_i)
EQ_OBJ_LIMIT = 1e-7  # b'y, card against CPU, relative
QP_SHAPE = (200, 400)  # n, num_ineqs
QP_BATCH = 64
# The JAX package on the CPU (tools/reference_runs.py qp) leaves seeds
# unsolved at 100 and 200 iterations (4 and 2 of 64) and none at 300, and
# reaches 1.651e-5 in y and 1.266e-4 in the slack on seed 11 (solved in 59
# iterations); seed 0, the Program's, 6.5e-7 at most.  So the batch runs
# 300 iterations and is held 6x above the reference's worst.
QP_ITERATIONS = 300
QP_Y_LIMIT = 1e-5  # the Program (seed 0): y against the known x_opt
QP_SLACK_LIMIT = 1e-4  # the Program: A y + b against the known slack
QP_BATCH_Y_LIMIT = 1e-4
QP_BATCH_SLACK_LIMIT = 1e-3
QP_CPU_LIMIT = 1e-7  # the Program's y, card against CPU, relative
QP_EPIGRAPH_LIMIT = 1e-7  # the epigraph solve's y against x_opt
# tests/test_quadratic_cone.py's epigraph solve allows 60 iterations.  At
# n = 200 its count and accuracy move with one rounding of b: the JAX
# package takes 43-50 iterations and ends 3.4e-10 to 6.1e-8 from x_opt
# with b moved by up to 2 units of 2^-52 (tools/reference_runs.py qp).  So
# 60 leaves little room, and the phase allows 100.
EPIGRAPH_ITERATIONS = 100
# The Hermitian path (phases 4f, 5e).  4f: benchmarks/bench_hermitian.py's
# batch, HERM_SHAPE = (S, d, n, m), f32, HERM_ITERATIONS fixed iterations;
# its small f64 batch on the card is held to the CPU by y at HERM_Y_LIMIT
# and by stats_k at HERM_K_LIMIT: the warm estimator's f32 sweep rounds
# differently on the card, and the CPU alone moves that batch's stats_k by
# 1.5e-6 to 3.5e-6 (y by 1.4e-12 at most) with its warm seeds rounded once
# more in f32 (tests/test_torch_hermitian.py::
# test_one_f32_rounding_of_the_warm_seeds_moves_stats_k).  5e:
# the known answers; a model with an LMI or Hermitian block of d <= 4 is
# held to the CPU at HERM_CPU_LIMIT, an octonion one at HERM_EXACT_LIMIT
# (f64 with no f32 stage; the JAX package alone moves the d = 8
# trajectory by 5.4e-8 under one rounding of b,
# tests/test_torch_hermitian.py).  bench_accuracy's complex and quaternion
# SDPs: b'y within HERM_OBJ_LIMIT of the CPU; the JAX package moves it by
# at most 1.9e-15 under one or two roundings of b (tools/reference_runs.py
# herm), and the port's CPU lies 3e-16 from it.
HERM_SHAPE = (32, 2, 64, 16)  # S, d, n, m: bench_hermitian.py:107
HERM_ITERATIONS = 30
HERM_K_LIMIT = 1e-5
HERM_Y_LIMIT = 1e-9
HERM_CPU_LIMIT = 1e-6
HERM_EXACT_LIMIT = 1e-7
HERM_OBJ_LIMIT = 1e-12
# 5f: the C ABI (conex_tpu_torch/interfaces).  tests/test_c_abi.py's six
# programs through the library on the card must give the Python Conex's
# bits on the card (the same calls in the same process), and are held to
# the same programs on the CPU as 5e holds Conex (HERM_CPU_LIMIT).  Then
# bench.py's scenario 0 at B = 1 in f64 (ABI_WIDTH: m, n) through
# CONEX_AddDenseLMIConstraint: its dual X read back through the ABI must
# satisfy <A_i, X> = b_i to ABI_DUAL_LIMIT of max |b|, and its y lie within
# ABI_WIDTH_CPU_LIMIT of the CPU's, or within what one rounding of b (up or
# down) moves the CPU alone where that is more: on an H100 the card lay
# 4.7e-8 from the CPU and one rounding moved the CPU 7.4e-8 (its endgame at
# inv_sqrt_mu_max 1e3, 40 iterations).  abi_host, a separate C process, must give that y
# to ABI_HOST_LIMIT (K1 gives the same bits twice).  The MATLAB shim's
# sequence at MATLAB_SHAPE (m, K.l, K.s) is held to solve_sedumi on the
# card as tests/test_matlab_twin.py holds it (absolute).
ABI_CPU_LIMIT = HERM_CPU_LIMIT
ABI_WIDTH = (50, 100)  # m, n: bench.py:73
ABI_DUAL_LIMIT = 1e-6
ABI_WIDTH_CPU_LIMIT = 1e-8
ABI_HOST_LIMIT = 1e-12
MATLAB_SHAPE = (50, 100, 100)  # m, K.l, K.s
# interfaces/matlab/conex_tpu.m's options block (the constructor's
# prepare_dual_variables included), set on CONEX_SetDefaultOptions's.
MATLAB_OPTIONS = dict(prepare_dual_variables=1, inv_sqrt_mu_max=1000,
                      infeasibility_threshold=1e3, max_iterations=25,
                      divergence_upper_bound=1, final_centering_steps=5)
MATLAB_LIMIT = 1e-8
MATLAB_FEAS_LIMIT = 1e-6
ABI_PHASE_BUDGET = 60.0  # seconds, the build included: printed beside the phase
# 4g: benchmarks/bench_sparse.py's chain (N LMI cliques of order nc, each
# over a 6-variable window, overlap 3; one instance, f32, 30 fixed
# iterations), as (N, nc, structure) runs.  Depth N is the only cut
# allowed: bench_sparse's N = 200 took 3.78 s per iteration on an H100
# (113.5 s per solve) and N = 100 2.55 s (PERF.md), so the long run is cut
# to N = 60.
SPARSE_RUNS = ((40, 8, "unrolled"), (40, 8, "compressed"), (60, 8, "compressed"))
SPARSE_ITERATIONS = 30
SPARSE_PROFILE_ITERATIONS = 2  # the profiled solve of each run
SPARSE_SMALL = (8, 4)  # N, nc of the f64 chain held to the CPU
# The f64 chain's limits, card against CPU.  Under one rounding of b the
# CPU alone moves its stats_k by 3.3e-15 and its y by 3.0e-12 (relative,
# either structure).  The warm estimator's eigenvector sweep runs in f32 on
# f64 inputs, and one f32 rounding of its seeds moves the CPU's stats_k by
# 4.6e-10 (y 3.5e-12); the card's f32 sweep rounds each of its steps
# otherwise, so stats_k is held as phase 4's small f64 instance of this
# configuration is (1e-6; a first limit of 1e-8 missed at 2.6e-8, PERF.md),
# y to 1e-8.
SPARSE_K_LIMIT = 1e-6
SPARSE_Y_LIMIT = 1e-8
# tests/test_compressed.py's chain LPs: the sparse and the dense program's
# y on the card, as that test holds them; and the sparse program on the
# card against the CPU (under one rounding of b the CPU alone moves y by
# 1.5e-10 and 3.9e-12 of its largest entry).
SPARSE_DENSE_LIMIT = 1e-6
SPARSE_CPU_LIMIT = 1e-8
# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# float32 outside the tensor cores, TF32 and float64 on the tensor cores,
# and device memory.
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
F64_TENSOR_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
LIBRARY_NOTE = ("library_ms is null for every kernel: no single PyTorch call "
                "computes the five Schur outputs (K1, K3-K6) or the SOCP "
                "solve (K2)")
SOCP_SIZES = (1_000, 10_000, 100_000)
SOCP_FLAGS = ("num_iterations", "solved", "fail", "primal_infeasible",
              "dual_infeasible", "mu_stalled", "warmstart_aborted")
SOCP_FLOATS = ("y", "y_kkt", "w", "k", "b_scaling", "c_scaling", "stats_k",
               "stats_dinf")
SOCP_PER_SCENARIO = ("y", "y_kkt", "w")
# Kernel against plain, relative.  The two round every operation alike and
# measure equal to the bit in both precisions on an H100.  f64 allows for
# sums taken in another order, amplified over up to 60 iterations.  In f32
# a change of rounding is not bounded that way: FMA contraction alone moves
# the bench_socp trajectory by a median 0.19 over 30 iterations (iterations
# 1-2: 1.2e-7), so the limit admits ten float32 ulps and nothing more.
F64_LIMIT = 1e-8
F32_LIMIT = 1e-6


def bound(ops, nbytes, flops=F32_FLOPS):
    """The least time the card could take: operations over the peak rate
    ``flops`` of the units that do them, or bytes over the memory rate,
    whichever is larger."""
    t_ops, t_bytes = ops / flops, nbytes / HBM_BYTES_PER_S
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def schur_bound(cones, programs, m, n, itemsize=4, tensor_cores=False,
                at_layout=False):
    """K1, K3, K6: per cone the m+1 panels Op_v W (C W as operator m),
    2 (m+1) n^3, and one triangle of the extended Gram matrix over them,
    2 (m+1)(m+2)/2 n^2 (it is symmetric for any inputs: a trace is unchanged
    by cycling its factors).  ``at_layout``: K4 and K5's function, whose G,
    tr(A_v W A_u^T W^T), is not symmetric unless W is: two n^3 products per
    operator, 4 (m+1) n^3, and every one of the m^2 + 2m + 2 outputs as a
    sum of depth n^2.  A, W and C read once, G, AW, AQc, wc, cqc of each
    program written once.  ``tensor_cores``: the products run there, as in
    K1, K4, K5: three TF32 passes per f32 product at TF32's rate, or
    float64 at the DMMA rate; else on CUDA cores at float32's rate."""
    if at_layout:
        ops = (4 * cones * (m + 1) * n**3
               + 2 * cones * (m * m + 2 * m + 2) * n**2)
    else:
        ops = (2 * cones * (m + 1) * n**3
               + 2 * cones * ((m + 1) * (m + 2) // 2) * n**2)
    nbytes = itemsize * (cones * (m + 2) * n * n + programs * (m * m + 2 * m + 2))
    if not tensor_cores:
        return bound(ops, nbytes)
    if itemsize == 4:
        return bound(3 * ops, nbytes, TF32_FLOPS)
    return bound(ops, nbytes, F64_TENSOR_FLOPS)


def socp_bound(S, nc, n1, m, iterations, T, refine, itemsize=4):
    """K2, counted from csrc/fused_socp.cu for the Newton iterations this
    run took: per iteration the panel Q(w^1/2) A and the AW dots (7 nc n1
    m), one triangle of the Gram sum G (nc n1 m (m+1)), AQc (2 nc n1 m),
    two slack products (4 nc n1 m), the Cholesky (m^3 / 3) and two KKT
    solves with their refinement (4 m^2 (1 + 2 refine)); the O(n1) cone
    arithmetic is left out.  Bytes: the seven inputs read once, the
    outputs (y, w, six scalars and five int32 flags per scenario, and the
    T x S statistics) written once."""
    per_iteration = (nc * n1 * (13 * m + m * (m + 1)) + m**3 / 3
                     + 4 * m * m * (1 + 2 * refine))
    nbytes = (itemsize * S * (nc * n1 * m + 2 * nc * n1 + m + 3)
              + itemsize * S * (m + nc * n1 + 6 + 2 * T) + 4 * 5 * S)
    return bound(iterations * per_iteration, nbytes)


def log(msg):
    print(msg, flush=True)


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


def card_name_and_power_limit():
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except FileNotFoundError:
        return "nvidia-smi not found"
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        return f"nvidia-smi failed ({proc.returncode}): {proc.stderr.strip()}"
    return lines[0].strip()


def rel_err(got, want):
    """Largest relative Frobenius error over matching output tuples; NaN
    where any output holds a NaN, so that no limit passes it."""
    import torch

    errs = []
    for g, w in zip(got, want):
        w = w.double()
        den = max(float(torch.linalg.vector_norm(w)), 1e-300)
        errs.append(float(torch.linalg.vector_norm(g.double() - w)) / den)
    return float("nan") if any(e != e for e in errs) else max(errs)  # NaN fails


def schur_inputs(S, Bc, m, n, seed, device):
    """Symmetric A, C near I and an SPD-ish W, made on the card from a seed."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    kw = dict(dtype=torch.float64, device=device, generator=g)

    def sym(*shape):
        X = torch.rand(*shape, **kw) * 2 - 1
        return 0.5 * (X + X.transpose(-2, -1))

    eye = torch.eye(n, dtype=torch.float64, device=device)
    A = sym(S, Bc, m, n, n)
    C = (eye + 0.1 * sym(S, Bc, n, n)).contiguous()
    W = (eye + 0.05 * sym(S, Bc, n, n)).contiguous()
    return A, W, C


def time_ms(fn, reps):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernel(device):
    import torch

    from conex_tpu_torch.cones import psd_schur

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record = {}
    for label, shape in (("small", (3, 2, 4, 13)), ("many cones", (2, 64, 20, 100)),
                         ("two tiles", (3, 2, 70, 130)), ("bench", (256, 1, 50, 100))):
        A, W, C = schur_inputs(*shape, seed=1, device=device)
        got64 = psd_schur.schur_kernel(A, W, C)
        want64 = psd_schur.schur_plain(A, W, C)
        torch.cuda.synchronize()
        e64 = rel_err(got64, want64)
        A32, W32, C32 = (x.float() for x in (A, W, C))
        got32 = psd_schur.schur_kernel(A32, W32, C32)
        plain32 = psd_schur.schur_plain(A32, W32, C32)
        oracle = psd_schur.schur_plain(*(x.double() for x in (A32, W32, C32)))
        torch.cuda.synchronize()
        e32 = rel_err(got32, oracle)
        e32_plain = rel_err(plain32, oracle)
        max_abs = max(float((g - p).abs().max()) for g, p in zip(got32, plain32))
        log(f"[3 kernel] {label} S,Bc,m,n={shape}: f64 rel err {e64:.3e} "
            f"(limit 1e-12); f32 rel err vs f64 oracle {e32:.3e} (limit 1e-4; "
            f"plain f32 {e32_plain:.3e}); f32 max |kernel - plain| {max_abs:.3e}")
        if not e64 <= 1e-12:
            fail(f"f64 kernel disagrees with schur_plain at {label}: {e64}")
        if not e32 <= 1e-4:
            fail(f"f32 kernel disagrees with the f64 oracle at {label}: {e32}")
        record = dict(max_abs_err=max_abs)
        del got64, want64, oracle
    again = psd_schur.schur_kernel(A32, W32, C32)
    torch.cuda.synchronize()
    same = all(torch.equal(g, a) for g, a in zip(got32, again))
    log(f"[3 kernel] bench shape f32: two kernel calls give the same bits: {same}")
    if not same:
        fail("two kernel calls at the bench shape differ")
    # Time both at the benchmark shape, in turns: plain, kernel, kernel, plain.
    ms = {"plain": [], "kernel": []}
    fns = {"plain": lambda: psd_schur.schur_plain(A32, W32, C32),
           "kernel": lambda: psd_schur.schur_kernel(A32, W32, C32)}
    for name in ("plain", "kernel", "kernel", "plain"):
        ms[name].append(time_ms(fns[name], 10))
    tensor = schur_bound(256, 256, 50, 100, tensor_cores=True)
    log(f"[3 kernel] bench shape f32 ms per call: kernel {ms['kernel']}, "
        f"plain {ms['plain']} (CUDA events, 10 calls each); bound on the "
        f"tensor cores {tensor}, on CUDA cores {schur_bound(256, 256, 50, 100)}")
    record.update(ms=min(ms["kernel"]), plain_ms=min(ms["plain"]), **tensor)
    return record


def bench_workload(device):
    """bench.py:73-102, with the port's tensors on ``device``."""
    import numpy as np
    import torch

    from conex_tpu_torch.cones.psd import DenseLMICone, make_psd_state

    B, n, m = 256, 100, 50
    iters = 30
    dtype = np.float32
    rng = np.random.default_rng(0)
    A = rng.uniform(-1, 1, (B, 1, m, n, n)).astype(dtype)
    A = 0.5 * (A + np.swapaxes(A, 3, 4))
    C = np.broadcast_to(np.eye(n, dtype=dtype), (B, 1, n, n)).copy()
    X0 = rng.uniform(-1, 1, (B, 1, n, n)).astype(dtype)
    X0 = np.einsum("sbij,sbkj->sbik", X0, X0) + 0.1 * np.eye(n, dtype=dtype)
    b = np.einsum("sbvij,sbij->sv", A, X0).astype(dtype)

    blk = DenseLMICone(A=torch.from_numpy(A).to(device),
                       C=torch.from_numpy(C).to(device))
    eye = torch.eye(n, dtype=torch.float32, device=device)
    init_ws = (make_psd_state(eye.expand(B, 1, n, n).contiguous()),)
    scalars = dict(
        k=torch.zeros((B,), dtype=torch.float32, device=device),
        b_scaling=torch.ones((B,), dtype=torch.float32, device=device),
        c_scaling=torch.ones((B,), dtype=torch.float32, device=device),
    )
    return blk, torch.from_numpy(b).to(device), init_ws, scalars, bench_config(iters)


def bench_config(iters):
    """bench.py's configuration: fixed iterations, scaled-k cap 100."""
    from conex_tpu_torch import SolverConfig

    return SolverConfig(max_iterations=iters, final_centering_steps=0,
                        inv_sqrt_mu_max=1e15, fixed_iterations=True,
                        inv_sqrt_mu_cap_scaled=100.0)


def first_failure_report(blk, b, init_ws, scalars, config, res, s):
    """The first invalid scenario's f32 trajectory beside an f64 run of it."""
    import dataclasses

    from conex_tpu_torch import solve_scenarios

    pick = lambda x: x[s:s + 1].double()  # noqa: E731
    blk64 = dataclasses.replace(blk, A=pick(blk.A), C=pick(blk.C))
    ws64 = tuple(type(w)(*map(pick, w)) for w in init_ws)
    r64 = solve_scenarios((blk64,), (), pick(b), ws64,
                          {k: pick(v) for k, v in scalars.items()}, config)
    log(f"[4 main path] scenario {s}: f32 iters {int(res.num_iterations[s])} "
        f"fail {bool(res.fail[s])}; f64 iters {int(r64.num_iterations[0])} "
        f"fail {bool(r64.fail[0])}")
    log(f"  f32 stats_k {res.stats_k[s].tolist()}")
    log(f"  f64 stats_k {r64.stats_k[0].tolist()}")
    log(f"  f32 stats_dinf {res.stats_dinf[s].tolist()}")
    log(f"  f64 stats_dinf {r64.stats_dinf[0].tolist()}")


def phase_main_path(device):
    import torch

    from conex_tpu_torch import solve_scenarios
    from conex_tpu_torch.utils.profiling import counters

    t0 = time.perf_counter()
    blk, b, init_ws, scalars, config = bench_workload(device)
    log(f"[4 main path] workload built in {time.perf_counter() - t0:.2f} s")

    def run(bv):
        res = solve_scenarios((blk,), (), bv, init_ws, scalars, config)
        torch.cuda.synchronize()
        return res

    counters["schur.calls"] = 0
    counters["socp.calls"] = 0
    t0 = time.perf_counter()
    res = run(b)
    launches = counters["schur.calls"]
    if counters["socp.calls"]:
        fail("the fused SOCP kernel ran on the SDP path")
    log(f"[4 main path] first run {time.perf_counter() - t0:.3f} s, "
        f"Schur kernel launches {launches}")
    n_iters = res.num_iterations.cpu()
    fails = res.fail.cpu()
    iters = config.max_iterations
    log(f"[4 main path] iterations min {int(n_iters.min())} max "
        f"{int(n_iters.max())}, failures {int(fails.sum())}/{len(fails)}")
    bad = (n_iters != iters) | fails
    if bad.any():
        first_failure_report(blk, b, init_ws, scalars, config, res,
                             int(bad.nonzero()[0, 0]))
        fail("bench validity rule: every scenario must run exactly "
             f"{iters} iterations with no factorization failure")
    if launches != iters:
        fail(f"Schur kernel launched {launches} times in {iters} iterations")
    if res.y.shape != b.shape or not torch.isfinite(res.y).all():
        fail(f"y is not finite of shape {tuple(b.shape)}")
    total = int(n_iters.sum())
    best = float("inf")
    for rep in range(3):
        bv = b * (1.0 + 1e-6 * (rep + 1))
        t0 = time.perf_counter()
        run(bv)
        dt = time.perf_counter() - t0
        best = min(best, dt)
        log(f"[4 main path] rep {rep}: {dt:.4f} s")
    log(f"[4 main path] Newton it/s {total / best:.2f} "
        f"({total} iterations, best of 3: {best:.4f} s)")
    return launches


def phase_small_vs_cpu(device):
    """The bench configuration at a small size in f64: card against CPU."""
    import numpy as np
    import torch

    from conex_tpu_torch import SolverConfig, convert, solve_scenarios
    from conex_tpu_torch.cones.psd import make_psd_state

    S, n, m = 4, 12, 5
    rng = np.random.default_rng(3)
    A = rng.uniform(-1, 1, (S, 1, m, n, n))
    A = 0.5 * (A + np.swapaxes(A, 3, 4))
    C = np.broadcast_to(np.eye(n), (S, 1, n, n)).copy()
    X0 = rng.uniform(-1, 1, (S, 1, n, n))
    X0 = np.einsum("sbij,sbkj->sbik", X0, X0) + 0.1 * np.eye(n)
    b = np.einsum("sbvij,sbij->sv", A, X0)
    config = SolverConfig(max_iterations=30, final_centering_steps=0,
                          inv_sqrt_mu_max=1e15, fixed_iterations=True,
                          inv_sqrt_mu_cap_scaled=100.0)
    out = []
    for dev in (device, "cpu"):
        ws = make_psd_state(convert.tensor(
            np.broadcast_to(np.eye(n), (S, 1, n, n)), dev))
        scal = convert.scalars(dict(k=np.zeros(S), b_scaling=np.ones(S),
                                    c_scaling=np.ones(S)), dev)
        res = solve_scenarios((convert.lmi_cone(A, C, dev),), (),
                              convert.tensor(b, dev), (ws,), scal, config)
        out.append(convert.to_numpy(res))
    g, c = out
    dk = float(np.max(np.abs(g.stats_k - c.stats_k) / np.abs(c.stats_k)))
    dy = float(np.max(np.abs(g.y - c.y) / (np.abs(c.y) + 1e-9)))
    log(f"[4 main path] small f64 card vs CPU: max rel diff stats_k {dk:.3e}, "
        f"y {dy:.3e} (limit 1e-6)")
    if not (g.num_iterations == c.num_iterations).all() or g.fail.any():
        fail("small f64 run: card and CPU disagree on iterations or failures")
    if not (dk <= 1e-6 and dy <= 1e-6):
        fail("small f64 run: card and CPU trajectories disagree")


def phase_known_answer(device):
    import numpy as np

    from conex_tpu_torch import Program, SolverConfig

    n = 6
    rng = np.random.default_rng(5)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    ev = np.linspace(0.5, 3.0, n)
    C = Q @ np.diag(ev) @ Q.T
    C = 0.5 * (C + C.T)
    config = SolverConfig(prepare_dual_variables=True, inv_sqrt_mu_max=1e4,
                          max_iterations=60)
    ys = []
    for dev in (device, "cpu"):
        prog = Program(1, device=dev)
        prog.add_lmi_constraint(np.eye(n)[None], C)
        res = prog.solve(np.ones(1), config)
        if not res.solved:
            fail(f"known-answer SDP not solved on {dev}")
        ys.append(float(res.y[0]))
    y_card, y_cpu = ys
    log(f"[5 known answer] max y s.t. C - y I PSD: card {y_card!r}, "
        f"CPU {y_cpu!r}, lambda_min(C) {ev[0]!r}")
    if abs(y_card - ev[0]) > 1e-6:
        fail("card objective is not lambda_min(C)")
    if abs(y_card - y_cpu) > 1e-8:
        fail("card and CPU objectives differ by more than 1e-8")


# ---------------------------------------------------------------------------
# The fused batched-SOCP solver (kernel K2)
# ---------------------------------------------------------------------------


def random_socp(rng, S, nc, n, m, feasible=True):
    """tests/test_fused_socp.py:22-40: S programs of nc Lorentz cones of
    dim n+1 over m variables; a feasible one has b = A(x) for an interior
    dual point x, an infeasible one a random b."""
    import numpy as np

    A = rng.standard_normal((S, nc, n + 1, m))
    if feasible:
        x = rng.standard_normal((S, nc, n + 1))
        x[..., 0] = np.linalg.norm(x[..., 1:], axis=-1) + rng.uniform(
            0.5, 1.5, (S, nc))
        b = 2.0 * np.einsum("scnv,scn->sv", A, x)
    else:
        b = rng.standard_normal((S, m))
    c = rng.standard_normal((S, nc, n + 1))
    c[..., 0] = np.linalg.norm(c[..., 1:], axis=-1) + rng.uniform(
        0.5, 2.0, (S, nc))
    return A, c, b


def socp_workload(S, n=20, m=10):
    """benchmarks/bench_socp.py:28-36 (seed 0): S single-cone SOCPs, f32."""
    import numpy as np

    dtype = np.float32
    rng = np.random.default_rng(0)
    A = rng.standard_normal((S, 1, n + 1, m)).astype(dtype)
    x = rng.standard_normal((S, 1, n + 1)).astype(dtype)
    x[..., 0] = np.linalg.norm(x[..., 1:], axis=-1) + 1.0
    b = 2.0 * np.einsum("scnv,scn->sv", A, x).astype(dtype)
    c = rng.standard_normal((S, 1, n + 1)).astype(dtype)
    c[..., 0] = np.linalg.norm(c[..., 1:], axis=-1) + 1.0
    return A, c, b


def socp_config(iters=30):
    """benchmarks/bench_socp.py:66-73's cfg(iters)."""
    from conex_tpu_torch import SolverConfig

    return SolverConfig(max_iterations=iters, final_centering_steps=0,
                        inv_sqrt_mu_max=1e15, kkt_error_tolerance=1e45,
                        fixed_iterations=True)


def fused_inputs(A, c, b, dtype, device, init_w=None, init_k=None):
    """The kernel's seven inputs (A, c, b, w0, k0, b and c scalings) as
    contiguous tensors; the defaults of solve_socp_fused."""
    import numpy as np
    import torch

    S, nc, n1, _ = A.shape
    if init_w is None:
        init_w = np.zeros((S, nc, n1))
        init_w[..., 0] = 1.0
    if init_k is None:
        init_k = np.zeros(S)
    return tuple(
        torch.as_tensor(np.asarray(x), dtype=dtype, device=device).contiguous()
        for x in (A, c, b, init_w, init_k, np.ones(S), np.ones(S)))


def _same(g, w):
    """Where two tensors hold the same value (NaN and inf included)."""
    return (g == w) | (g.isnan() & w.isnan())


def stats_rel(got, want):
    """Entrywise |got - want| / |want|; 0 where the two are equal."""
    import torch

    g, w = got.double(), want.double()
    return torch.where(_same(g, w), 0.0, (g - w).abs() / w.abs().clamp_min(1e-300))


def per_scenario_rel(got, want):
    """Each scenario's |got - want| / |want| in the 2-norm; 0 where the two
    are equal."""
    import torch

    S = want.shape[0]
    g, w = got.double().reshape(S, -1), want.double().reshape(S, -1)
    num = torch.linalg.vector_norm(g - w, dim=1)
    rel = num / torch.linalg.vector_norm(w, dim=1).clamp_min(1e-300)
    return torch.where(_same(g, w).all(1), 0.0, rel)


def max_abs_diff(got, want):
    import torch

    g, w = got.double(), want.double()
    return float(torch.where(_same(g, w), 0.0, (g - w).abs()).max())


def unbounded_and_infeasible(rng, A, c, b, unbounded, infeasible):
    """In place: make the objective of the ``unbounded`` scenarios grow
    without bound along y_0 (-A e_0 inside every cone, b_0 > 0), and the
    ``infeasible`` ones infeasible (cone 0 reads c_0 = -1 whatever y is)."""
    import numpy as np

    idx = list(unbounded)
    x = rng.standard_normal((len(idx),) + A.shape[1:3])
    x[..., 0] = np.linalg.norm(x[..., 1:], axis=-1) + 0.5
    A[idx, :, :, 0] = -x
    b[idx, 0] = np.abs(b[idx, 0]) + 1.0
    idx = list(infeasible)
    A[idx, 0, 0, :] = 0.0
    c[idx, 0, 0] = -1.0


def fused_plan(args, config, **kw):
    """socp_plan of a kernel call on ``args`` (the seven inputs)."""
    from conex_tpu_torch.parallel import fused_socp

    A = args[0]
    return fused_socp.socp_plan(*A.shape, A.element_size(), config.max_iterations, **kw)


def check_fused(label, args, config, limit, teams=(None,)):
    """Kernel against plain on the same inputs, once under the plan of each
    of ``teams`` (None: socp_plan's pick), every field of FusedSOCPResult:
    iteration counts and flags identical; the floating fields within
    ``limit`` relative (in each scenario's 2-norm for y, y_kkt and w,
    entrywise for the rest).  Returns the plain version's counts of each
    flag and the largest |kernel - plain| over the floating fields."""
    import torch

    from conex_tpu_torch.parallel import fused_socp

    want = fused_socp.epilogue(fused_socp.solve_socp_plain(*args, config), config)
    counts = {name: int(getattr(want, name).to(torch.int64).sum()) for name in SOCP_FLAGS}
    counts["aborted at iteration 1"] = int((want.stats_dinf[:, 0] >= 2.0).sum())
    log(f"[3b fused kernel] {label}: S={args[0].shape[0]}, plain version's counts {counts}")
    max_abs = 0.0
    for team in teams:
        plan = fused_plan(args, config, team=team)
        got = fused_socp.epilogue(fused_socp.solve_socp_kernel(*args, config, plan=plan),
                                  config)
        torch.cuda.synchronize()
        log(f"[3b fused kernel] {label}: plan: {plan.describe()}")
        for name in SOCP_FLAGS:
            g, w = getattr(got, name), getattr(want, name)
            if not torch.equal(g, w):
                bad = (g != w).nonzero()[:5, 0].tolist()
                fail(f"{label}, TEAM {plan.team}: {name} differs from the plain version "
                     f"in scenarios {bad}: kernel {g[bad].tolist()} plain {w[bad].tolist()}")
        rel = {name: float((per_scenario_rel if name in SOCP_PER_SCENARIO else stats_rel)(
            getattr(got, name), getattr(want, name)).max()) for name in SOCP_FLOATS}
        diff = max(max_abs_diff(getattr(got, f), getattr(want, f)) for f in SOCP_FLOATS)
        max_abs = max(max_abs, diff)
        log(f"[3b fused kernel] {label}, TEAM {plan.team}: flags identical; max relative "
            f"difference {rel} (limit {limit:g}); max |kernel - plain| {diff:.3e}")
        if not all(v <= limit for v in rel.values()):
            s = int(stats_rel(got.stats_k, want.stats_k).amax(1).argmax())
            log(f"  scenario {s}: kernel stats_k {got.stats_k[s].tolist()}")
            log(f"  scenario {s}: plain  stats_k {want.stats_k[s].tolist()}")
            fail(f"{label}, TEAM {plan.team}: kernel and plain version disagree beyond "
                 f"{limit:g}: {rel}")
    return counts, max_abs


def phase_fused_kernel(device):
    """Returns the kernel's record: max |kernel - plain| over the f32
    comparisons at the main path's shapes, and the CUDA-event times of both
    at the largest."""
    import numpy as np
    import torch

    from conex_tpu_torch import WARMSTART, SolverConfig
    from conex_tpu_torch.parallel import fused_socp

    f64 = torch.float64
    # Cold: feasible scenarios of 3 cones, random objectives (40 of them
    # made unbounded or infeasible on purpose), and one whose A has an
    # all-zero column (its factorization fails at iteration 0).
    rng = np.random.default_rng(11)
    feas = random_socp(rng, 200, 3, 4, 3)
    rand = random_socp(rng, 100, 3, 4, 3, feasible=False)
    A, c, b = (np.concatenate(pair) for pair in zip(feas, rand))
    unbounded_and_infeasible(rng, A, c, b, range(200, 220), range(220, 240))
    A[5, :, :, 1] = 0.0
    cold = SolverConfig(max_iterations=60, prepare_dual_variables=True,
                        iterative_refinement_iterations=1, mu_stall_iterations=4)
    # The cold, warm and global-route batches run under both of the
    # library's TEAM sizes: 32 (one team per warp) and 8 (four teams share
    # a warp, each with its own mask), so every branch runs under both.
    teams = fused_socp.TEAMS
    counts, max_abs = check_fused("f64 cold", fused_inputs(A, c, b, f64, device),
                                  cold, F64_LIMIT, teams)
    if not (counts["fail"] >= 1 and counts["solved"] >= 1
            and counts["mu_stalled"] >= 1):
        fail(f"f64 cold batch misses a branch: {counts}")
    # Warm from a poisoned iterate (w0 = 1e6 e) in half the scenarios; one
    # with a zero column resets at its first iteration and fails at the
    # next; ten unbounded ones run out of iterations.
    rng = np.random.default_rng(12)
    A, c, b = random_socp(rng, 200, 2, 4, 3)
    unbounded_and_infeasible(rng, A, c, b, range(150, 160), ())
    A[7, :, :, 0] = 0.0
    w0 = np.zeros((200, 2, 5))
    w0[..., 0] = 1.0
    w0[:100, :, 0] = 1e6
    warm = SolverConfig(max_iterations=40, initialization_mode=WARMSTART,
                        warmstart_abort_threshold=2.0)
    counts, abs_warm = check_fused(
        "f64 warm", fused_inputs(A, c, b, f64, device, w0, np.ones(200)), warm,
        F64_LIMIT, teams)
    if not (counts["aborted at iteration 1"] >= 100 and counts["fail"] >= 1
            and counts["solved"] <= 200 - 11):
        fail(f"f64 warm batch misses the abort, the failure or the "
             f"unsolved: {counts}")
    # f64 on the global route: one scenario's working set (nc = 4 cones of
    # dim 250, m = 16: 301 KB) exceeds a block's shared memory.
    rng = np.random.default_rng(13)
    args = fused_inputs(*random_socp(rng, 64, 4, 249, 16), f64, device)
    big = SolverConfig(max_iterations=40, prepare_dual_variables=True,
                       iterative_refinement_iterations=1)
    if fused_plan(args, big).route != "global":
        fail(f"the large batch does not take the global route: {fused_plan(args, big)}")
    counts, abs_global = check_fused("f64 global route", args, big, F64_LIMIT, teams)
    if counts["solved"] < 1:
        fail(f"f64 global-route batch solves nothing: {counts}")
    max_abs = max(max_abs, abs_global)
    del args
    # f64 at the bench_socp shape (30 fixed iterations), the same rule.
    config = socp_config()
    counts, abs_bench = check_fused(
        "f64 bench shape", fused_inputs(*socp_workload(1_000), f64, device),
        config, F64_LIMIT)
    if counts["num_iterations"] != 30 * 1_000 or counts["fail"]:
        fail(f"f64 bench shape: not 30 iterations without failure: {counts}")
    log(f"[3b fused kernel] f64 max |kernel - plain|: {max(max_abs, abs_warm, abs_bench):.3e}")

    # f32 at the bench_socp shape against an f64 oracle (an extra check of
    # the f32 arithmetic: the kernel is held to its plain twin below).
    A, c, b = socp_workload(10_000)
    got = fused_socp.epilogue(fused_socp.solve_socp_kernel(
        *fused_inputs(A, c, b, torch.float32, device), config), config)
    want = fused_socp.epilogue(fused_socp.solve_socp_plain(
        *fused_inputs(A, c, b, f64, device), config), config)
    torch.cuda.synchronize()
    for name, r in (("kernel f32", got), ("f64 oracle", want)):
        if not ((r.num_iterations == 30).all() and not r.fail.any()):
            fail(f"bench shape: {name} did not run 30 iterations in every "
                 f"scenario without failure")
    rel = stats_rel(got.stats_k, want.stats_k)
    med12 = float(rel[:, :2].median())
    log(f"[3b fused kernel] f32 bench shape S=10000: stats_k vs f64 oracle, "
        f"iterations 1-2 median {med12:.3e} (limit 1e-3); whole trajectory "
        f"median {float(rel.median()):.3e}, p99 "
        f"{float(rel.flatten().quantile(0.99)):.3e}, max {float(rel.max()):.3e}")
    if not med12 <= 1e-3:
        fail(f"f32 kernel drifts from the f64 oracle at iterations 1-2: {med12}")

    # At the main path's three sizes in f32: kernel against plain on the
    # same inputs, every field; then CUDA-event times, in turns: plain,
    # kernel, kernel, plain.
    times, max_abs = {}, 0.0
    for S in SOCP_SIZES:
        args = fused_inputs(*socp_workload(S), torch.float32, device)
        counts, abs_s = check_fused(f"f32 S={S}", args, config, F32_LIMIT)
        max_abs = max(max_abs, abs_s)
        fns = {"plain": lambda: fused_socp.solve_socp_plain(*args, config),
               "kernel": lambda: fused_socp.solve_socp_kernel(*args, config)}
        ms = {"plain": [], "kernel": []}
        for name in ("plain", "kernel", "kernel", "plain"):
            ms[name].append(time_ms(fns[name], 3))
        times[S] = (min(ms["kernel"]), min(ms["plain"]))
        log(f"[3b fused kernel] S={S} f32, 30 iterations, ms per call: kernel "
            f"{ms['kernel']}, plain {ms['plain']} (CUDA events, 3 calls each)")
        _, nc, n1, m = args[0].shape
        del args, fns
    kernel_ms, plain_ms = times[SOCP_SIZES[-1]]
    plan = fused_socp.socp_plan(SOCP_SIZES[-1], nc, n1, m, 4, config.max_iterations)
    traffic = plan.traffic_bytes(counts["num_iterations"])
    log(f"[3b fused kernel] S={SOCP_SIZES[-1]} f32: device-memory traffic from the "
        f"plan {traffic / 1e9:.4f} GB, {1e3 * traffic / HBM_BYTES_PER_S:.4f} ms at "
        f"3.35 TB/s")
    return dict(max_abs_err=max_abs, ms=kernel_ms, plain_ms=plain_ms,
                plan=dict(route=plan.route, team=plan.team,
                          scenarios_per_block=plan.per_block,
                          shared_bytes=plan.shared_bytes),
                **socp_bound(SOCP_SIZES[-1], nc, n1, m, counts["num_iterations"],
                             config.max_iterations,
                             config.iterative_refinement_iterations))


def phase_socp_main_path(device):
    import torch

    from conex_tpu_torch import solve_scenarios
    from conex_tpu_torch.cones.soc import SOCCone
    from conex_tpu_torch.parallel import fused_socp
    from conex_tpu_torch.parallel.fused_socp import solve_socp_fused
    from conex_tpu_torch.utils.profiling import counters

    config = socp_config()
    iters = config.max_iterations
    counters["schur.calls"] = 0
    counters["socp.calls"] = 0
    for S in SOCP_SIZES:
        A, c, b = (torch.from_numpy(x).to(device) for x in socp_workload(S))

        def run(bv):
            before = counters["socp.calls"]
            out = solve_socp_fused(A, c, bv, config)
            torch.cuda.synchronize()
            if counters["socp.calls"] != before + 1:
                fail(f"S={S}: {counters['socp.calls'] - before} kernel launches in one call")
            return out

        out = run(b)
        total = int(out.num_iterations.sum())
        n_fail = int(out.fail.sum())
        plan = fused_socp.socp_plan(*A.shape, A.element_size(), iters)
        log(f"[4b socp main path] S={S}: plan: {plan.describe()}")
        log(f"[4b socp main path] S={S}: iterations {total} (want {iters * S}), "
            f"failures {n_fail}")
        if total != iters * S or n_fail:
            fail(f"S={S}: bench_socp validity rule: every scenario must run "
                 f"{iters} iterations without failure")
        if out.y.shape != b.shape or not torch.isfinite(out.y).all():
            fail(f"S={S}: y is not finite of shape {tuple(b.shape)}")
        best = float("inf")
        for rep in range(3):
            t0 = time.perf_counter()
            run(b * (1.0 + 1e-6 * (rep + 1)))
            best = min(best, time.perf_counter() - t0)
        log(f"[4b socp main path] S={S}: fused Newton it/s {total / best:.2f} "
            f"(best of 3: {best * 1e3:.3f} ms)")
        if S == 10_000:
            general_inputs = (A, c, b, out)
    launches = counters["socp.calls"]
    log(f"[4b socp main path] fused kernel launches {launches}, Schur kernel "
        f"launches {counters['schur.calls']}")
    if counters["schur.calls"]:
        fail("the Schur kernel ran on the SOCP path")

    # The general path at S = 10,000: the solve loop with SOCCone blocks.
    A, c, b, fused = general_inputs
    S, nc, n1, _ = A.shape
    w0 = torch.zeros((S, nc, n1), dtype=A.dtype, device=device)
    w0[..., 0] = 1.0
    scalars = dict(k=torch.zeros((S,), dtype=A.dtype, device=device),
                   b_scaling=torch.ones((S,), dtype=A.dtype, device=device),
                   c_scaling=torch.ones((S,), dtype=A.dtype, device=device))

    def run_general(bv):
        res = solve_scenarios((SOCCone(A=A, c=c),), (), bv, (w0,), scalars, config)
        torch.cuda.synchronize()
        return res

    res = run_general(b)
    total = int(res.num_iterations.sum())
    best = float("inf")
    for rep in range(3):
        t0 = time.perf_counter()
        run_general(b * (1.0 + 1e-6 * (rep + 1)))
        best = min(best, time.perf_counter() - t0)
    rel = stats_rel(fused.stats_k[:, :2], res.stats_k[:, :2])
    med = float(rel.median())
    log(f"[4b socp main path] general path S={S}: iterations {total}, failures "
        f"{int(res.fail.sum())}, Newton it/s {total / best:.2f} (best of 3: "
        f"{best * 1e3:.3f} ms); stats_k iterations 1-2 fused vs general: median "
        f"{med:.3e} p99 {float(rel.flatten().quantile(0.99)):.3e} max "
        f"{float(rel.max()):.3e} (limit on the median 1e-3)")
    if not torch.isfinite(res.k).all() or not med <= 1e-3:
        fail("the general SOCP path disagrees with the fused path")
    if counters["socp.calls"] != launches:
        fail("the general SOCP path launched the fused kernel")
    return launches


def phase_soc_known_answer(device):
    """max b'y s.t. (1, y) in Q^{m+1}: y = b/|b|, dual x = (|b|, -b)."""
    import numpy as np

    from conex_tpu_torch import Program, SolverConfig

    m = 4
    b = np.random.default_rng(6).standard_normal(m)
    A = np.vstack([np.zeros((1, m)), -np.eye(m)])
    c = np.zeros(m + 1)
    c[0] = 1.0
    config = SolverConfig(prepare_dual_variables=True, max_iterations=60)
    out = {}
    for dev in ("card", "cpu"):
        prog = Program(m, device=device if dev == "card" else "cpu")
        prog.add_soc_constraint(A, c)
        res = prog.solve(b, config)
        if not res.solved:
            fail(f"known-answer SOCP not solved on the {dev}")
        out[dev] = (res.y, prog.get_dual_variable(0))
    (y_card, x_card), (y_cpu, x_cpu) = out["card"], out["cpu"]
    e_ans = float(np.abs(y_card - b / np.linalg.norm(b)).max())
    e_cpu = float(np.abs(y_card - y_cpu).max())
    e_dual = float(np.linalg.norm(x_card - x_cpu) / np.linalg.norm(x_cpu))
    e_kkt = float(np.abs(A.T @ x_card - b).max())
    log(f"[5b soc known answer] y on the card {y_card.tolist()}: max |y - b/|b||"
        f" {e_ans:.3e} (limit 1e-6), max |card - CPU| {e_cpu:.3e} (limit 1e-8); "
        f"dual card vs CPU relative {e_dual:.3e} (limit 1e-8), max |A'x - b| "
        f"{e_kkt:.3e} (limit 1e-6)")
    if not (e_ans <= 1e-6 and e_cpu <= 1e-8 and e_dual <= 1e-8 and e_kkt <= 1e-6):
        fail("the SOC known answer does not hold on the card")


# ---------------------------------------------------------------------------
# The LP path (no kernel: the LP cone is elementwise work and two products)
# ---------------------------------------------------------------------------


def gap_stats(by, cx, b, Ax):
    """Relative duality gap and dual-feasibility residual
    (benchmarks/bench_accuracy.py:46-50)."""
    import numpy as np

    rel_gap = abs(cx - by) / (1.0 + abs(by))
    dual_res = float(np.linalg.norm(Ax - b) / (1.0 + np.linalg.norm(b)))
    return rel_gap, dual_res


def lp_instance(seed):
    """benchmarks/bench_accuracy.py:58-63's dense LP from a seed: A (n, m),
    b (m,), c (n,)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    m, n = LP_SHAPE
    A = rng.uniform(-1, 1, (n, m))
    x0 = rng.uniform(0.5, 1.5, n)
    b = A.T @ x0
    c = rng.uniform(0.5, 1.5, n)
    return A, b, c


def eq_sdp_instance(seed, n, m, p):
    """tests/test_equality.py::test_equality_with_sdp's program at order n,
    drawn from default_rng(seed): A_i = sym(U(-1,1)^{n x n}), C =
    sym(U)/sqrt(n) + 3 I, X0 = U U^T / n + 0.1 I, Aeq = U(-1,1)^{p x m},
    beq = Aeq (0.05 U(-1,1)^m / sqrt(m)), b = <A_i, X0> + Aeq^T U(-1,1)^p.
    Returns As (m, n, n), C (n, n), Aeq (p, m), beq (p,), b (m,)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    M = rng.uniform(-1, 1, (m, n, n))
    As = 0.5 * (M + np.swapaxes(M, 1, 2))
    M = rng.uniform(-1, 1, (n, n))
    C = 0.5 * (M + M.T) / np.sqrt(n) + 3.0 * np.eye(n)
    X0 = rng.uniform(-1, 1, (n, n))
    X0 = X0 @ X0.T / n + 0.1 * np.eye(n)
    Aeq = rng.uniform(-1, 1, (p, m))
    beq = Aeq @ (0.05 * rng.uniform(-1, 1, m) / np.sqrt(m))
    b = np.einsum("vij,ij->v", As, X0) + Aeq.T @ rng.uniform(-1, 1, p)
    return As, C, Aeq, beq, b


def eq_sdp_config():
    from conex_tpu_torch import KKT_SOLVER_LDLT, SolverConfig

    return SolverConfig(kkt_solver=KKT_SOLVER_LDLT, max_iterations=EQ_SDP_ITERATIONS)


def qp_with_solution(n, num_ineqs, rng):
    """tests/test_qp.py::qp_with_solution (reference
    quadratic_objective_test.cc:88-115): min 1/2 x'Wx + c'x s.t.
    Ax + b >= 0, with the first n rows active.  Returns W, A, b, c, x_opt,
    slack_opt."""
    import numpy as np

    size_active = n
    optimal_slack = np.zeros(num_ineqs)
    optimal_lambda = np.zeros(num_ineqs)
    optimal_lambda[:size_active] = np.linspace(1, size_active, size_active)
    optimal_slack[size_active:] = 1.0
    optimal_x = rng.uniform(-1, 1, n)
    W = np.eye(n)
    A = rng.uniform(-1, 1, (num_ineqs, n))
    b = optimal_slack - A @ optimal_x
    c = A.T @ optimal_lambda - W @ optimal_x
    return W, A, b, c, optimal_x, optimal_slack


# tests/test_qp.py's QP_CONFIG with QP_ITERATIONS iterations (its 30
# leave seed 0 unsolved at this size; see QP_ITERATIONS), as SolverConfig
# fields, which both packages take.
QP_CONFIG_FIELDS = dict(
    enable_line_search=True, enable_rescaling=False,
    initial_centering_steps_coldstart=0, inv_sqrt_mu_max=2e5,
    max_iterations=QP_ITERATIONS, final_centering_tolerance=1.05,
    final_centering_steps=0, kkt_error_tolerance=1e45, dinf_upper_bound=1.0,
    prepare_dual_variables=True,
)


def qp_config():
    from conex_tpu_torch import SolverConfig

    return SolverConfig(**QP_CONFIG_FIELDS)


def lp_config(line_search):
    """bench_accuracy.py:66-70, in either mu mode."""
    from conex_tpu_torch import SolverConfig

    return SolverConfig(max_iterations=100, inv_sqrt_mu_max=1e4,
                        prepare_dual_variables=True,
                        enable_line_search=line_search)


def check_lp(label, A, b, c, card, cpu, batch=False):
    """Whether the card's solution meets the LP path's limits, logging what
    breaks them and, beside it, the tail of both trajectories; and its
    (rel_gap, dual_res, y's relative distance from the CPU's).  ``card``
    and ``cpu``: (y, x, iterations, stats_k, stats_dinf) of one solve.

    Always: the relative gap and the dual residual.  A single solve: y
    within LP_Y_LIMIT of the CPU's in as many iterations.  A scenario of
    the batch: its objective within LP_GAP_LIMIT of the CPU's and its
    iteration count within LP_CENTERING_SPREAD of it (see LP_Y_LIMIT)."""
    import numpy as np

    y, x, iters, k, dinf = card
    y_cpu, _, iters_cpu, k_cpu, dinf_cpu = cpu
    rel_gap, dual_res = gap_stats(float(b @ y), float(c @ x), b, A.T @ x)
    e_cpu = float(np.linalg.norm(y - y_cpu) / np.linalg.norm(y_cpu))
    e_obj = abs(float(b @ (y - y_cpu))) / (1.0 + abs(float(b @ y_cpu)))
    ok = rel_gap <= LP_GAP_LIMIT and dual_res <= LP_DUAL_LIMIT
    if batch:
        ok = (ok and e_obj <= LP_GAP_LIMIT
              and abs(iters - iters_cpu) <= LP_CENTERING_SPREAD)
    else:
        ok = ok and e_cpu <= LP_Y_LIMIT and iters == iters_cpu
    if not ok:
        last = max(iters, iters_cpu)
        log(f"LP {label}: {iters} iterations (CPU {iters_cpu}), relative gap "
            f"{rel_gap:.3e} (limit {LP_GAP_LIMIT}), dual residual {dual_res:.3e} "
            f"(limit {LP_DUAL_LIMIT}), y vs CPU {e_cpu:.3e}, objective vs CPU "
            f"{e_obj:.3e}, least slack {float((c - A @ y).min()):.3e}")
        for name, card_t, cpu_t in (("stats_k", k, k_cpu), ("stats_dinf", dinf, dinf_cpu)):
            log(f"  {name} of iterations {last - 4}-{last - 1}: card "
                f"{[float(v) for v in card_t[last - 4:last]]}, CPU "
                f"{[float(v) for v in cpu_t[last - 4:last]]}")
    return ok, (rel_gap, dual_res, e_cpu)


def lp_vertex(A, c, y):
    """The vertex y* of the m inequalities tightest at y: A_act y* = c_act,
    the exact optimum of a nondegenerate LP whose solve ended at y."""
    import numpy as np

    act = np.argsort(c - A @ y)[:A.shape[1]]
    return np.linalg.solve(A[act], c[act])


def program_solution(prog, res):
    """(y, x, iterations, stats_k, stats_dinf) of a Program's LP solve."""
    raw = res._raw
    return (res.y, prog.get_dual_variable(0), res.num_iterations, raw.stats_k,
            raw.stats_dinf)


def batch_solution(r, s):
    """The same of scenario s of a batched solve (numpy SolveResult); x as
    Program.get_dual_variable forms it."""
    x = r.ws[0][s] / (r.k[s] * r.b_scaling[s])
    return (r.y[s], x, int(r.num_iterations[s]), r.stats_k[s], r.stats_dinf[s])


def phase_lp_path(device):
    """The LP path on the card: bench_accuracy's LP through Program, then
    LP_BATCH of them through solve_scenarios, in both mu modes, each held
    to its limits and to the same solve on the CPU.  No kernel runs on it:
    K1 and K2 must not launch."""
    import numpy as np
    import torch

    from conex_tpu_torch import Program, convert, solve_scenarios
    from conex_tpu_torch.utils.profiling import counters

    kernels = ("schur.calls", "socp.calls")
    for kernel in kernels:
        counters[kernel] = 0
    m, n = LP_SHAPE
    A, b, c = lp_instance(0)
    for line_search in (False, True):
        mode = "line search" if line_search else "divergence"
        config = lp_config(line_search)
        out = {}
        for where in ("card", "cpu"):
            prog = Program(m, device=device if where == "card" else "cpu")
            prog.add_linear_constraint(A, c)
            res = prog.solve(b, config)
            if not res.solved:
                fail(f"LP {m} x {n} ({mode}) not solved on the {where}")
            out[where] = (prog, res)
        prog, res = out["card"]
        ok, (gap, dual, e_cpu) = check_lp(
            f"{m} x {n} ({mode})", A, b, c,
            *(program_solution(*out[where]) for where in ("card", "cpu")))
        if not ok:
            fail(f"the LP {m} x {n} ({mode}) breaks the limits on the card")
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            prog.solve(b, config)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        log(f"[4c lp path] Program, {m} vars x {n} inequalities, f64, {mode}: "
            f"solved in {res.num_iterations} iterations (CPU "
            f"{out['cpu'][1].num_iterations}), relative gap {gap:.3e} (limit "
            f"{LP_GAP_LIMIT}), dual residual {dual:.3e} (limit {LP_DUAL_LIMIT}), "
            f"least slack {float((c - A @ res.y).min()):.3e}, y vs CPU {e_cpu:.3e} "
            f"(limit {LP_Y_LIMIT}); wall per solve {best * 1e3:.3f} ms (best of 3), "
            f"Newton it/s {res.num_iterations / best:.2f}")

    # The batch: scenario s drawn with seed s, as one solve.
    S = LP_BATCH
    As, bs, cs = map(np.stack, zip(*(lp_instance(s) for s in range(S))))
    broken = {}
    for line_search in (False, True):
        mode = "line search" if line_search else "divergence"
        config = lp_config(line_search)

        def run(bv, dev):
            blk = convert.linear_cone(As, cs, dev)
            return solve_scenarios(
                (blk,), (), convert.tensor(bv, dev),
                (torch.ones((S, n), dtype=torch.float64, device=dev),),
                convert.scalars(dict(k=np.zeros(S), b_scaling=np.ones(S),
                                     c_scaling=np.ones(S)), dev), config)

        t0 = time.perf_counter()
        r = convert.to_numpy(run(bs, device))
        first = time.perf_counter() - t0
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            run(bs, device)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        r_cpu = convert.to_numpy(run(bs, torch.device("cpu")))
        # The CPU's own sensitivity to one rounding: b moved by 2^-52.
        r_ulp = convert.to_numpy(run(bs * (1 + 2.0**-52), torch.device("cpu")))
        rel = lambda u, v: np.linalg.norm(u - v, axis=1) / np.linalg.norm(v, axis=1)  # noqa: E731
        vertex = np.stack([lp_vertex(As[s], cs[s], r_cpu.y[s]) for s in range(S)])
        log(f"[4c lp path] batch ({mode}): y card vs CPU max {rel(r.y, r_cpu.y).max():.3e} "
            f"median {np.median(rel(r.y, r_cpu.y)):.3e}, iterations differ in "
            f"{int((r.num_iterations != r_cpu.num_iterations).sum())}; CPU with b "
            f"moved by 2^-52 vs CPU: y max {rel(r_ulp.y, r_cpu.y).max():.3e} median "
            f"{np.median(rel(r_ulp.y, r_cpu.y)):.3e}, iterations differ in "
            f"{int((r_ulp.num_iterations != r_cpu.num_iterations).sum())}; distance "
            f"from the optimal vertex: card max {rel(r.y, vertex).max():.3e}, CPU max "
            f"{rel(r_cpu.y, vertex).max():.3e}, CPU moved max {rel(r_ulp.y, vertex).max():.3e}")
        if not r.solved.all():
            fail(f"LP batch ({mode}): scenarios {np.flatnonzero(~r.solved).tolist()} "
                 "not solved on the card")
        worst, bad = np.zeros(3), []
        for s in range(S):
            ok, errs = check_lp(f"batch scenario {s} ({mode})", As[s], bs[s], cs[s],
                                batch_solution(r, s), batch_solution(r_cpu, s),
                                batch=True)
            worst = np.maximum(worst, errs)
            if not ok:
                bad.append(s)
        total = int(r.num_iterations.sum())
        log(f"[4c lp path] batch of {S} scenarios (seeds 0-{S - 1}), f64, {mode}: "
            f"all solved in {int(r.num_iterations.min())}-{int(r.num_iterations.max())} "
            f"iterations; worst relative gap {worst[0]:.3e}, "
            f"dual residual {worst[1]:.3e}, y vs CPU {worst[2]:.3e}; wall per solve "
            f"{best * 1e3:.3f} ms (best of 3; first {first * 1e3:.3f} ms), Newton "
            f"it/s {total / best:.2f} ({total} iterations)")
        median = float(np.median(rel(r.y, r_cpu.y)))
        if median > LP_Y_LIMIT:
            log(f"LP batch ({mode}): the median y vs CPU {median:.3e} exceeds "
                f"{LP_Y_LIMIT}")
            bad.append("median")
        if bad:
            broken[mode] = bad
    if broken:
        fail(f"LP batch: scenarios break the limits on the card: {broken}")
    if any(counters[kernel] for kernel in kernels):
        fail("K1 or K2 launched on the LP path")


def phase_lp_known_answer(device):
    """The verify skill's LP known answer on the card against the CPU, then
    a warmstart resume after save_state / load_state."""
    import numpy as np

    from conex_tpu_torch import WARMSTART, Program, SolverConfig

    # maximize y1 + 2 y2  s.t.  y1 <= 2, y2 <= 3, y1 + y2 <= 4: optimum (1, 3)
    A = np.array([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    c = np.array([2.0, 3.0, 4.0])
    b = np.array([1.0, 2.0])
    config = SolverConfig(prepare_dual_variables=True, inv_sqrt_mu_max=1e4,
                          max_iterations=50)
    warm = config.replace(initialization_mode=WARMSTART)
    out = {}
    for where in ("card", "cpu"):
        dev = device if where == "card" else "cpu"
        prog = Program(2, device=dev)
        prog.add_linear_constraint(A, c)
        res = prog.solve(b, config)
        x = prog.get_dual_variable(0)
        resumed = Program(2, device=dev)
        resumed.add_linear_constraint(A, c)
        resumed.load_state(prog.save_state())
        res2 = resumed.solve(b, warm)
        out[where] = (res, x, res2)
    (res, x, res2), (res_cpu, x_cpu, res2_cpu) = out["card"], out["cpu"]
    e_obj = abs(float(b @ res.y) - 7.0)
    e_cpu = float(np.abs(res.y - res_cpu.y).max())
    e_dual = float(np.abs(x - x_cpu).max())
    e_kkt = float(np.abs(A.T @ x - b).max())
    e_warm = float(np.abs(res2.y - res2_cpu.y).max())
    log(f"[5c lp known answer] y on the card {res.y.tolist()} in "
        f"{res.num_iterations} iterations: |b'y - 7| {e_obj:.3e} (limit 1e-6), "
        f"max |card - CPU| {e_cpu:.3e} (limit 1e-8), dual max |card - CPU| "
        f"{e_dual:.3e} (limit 1e-8), max |A'x - b| {e_kkt:.3e} (limit 1e-6); "
        f"warmstart after save_state/load_state: solved {res2.solved} in "
        f"{res2.num_iterations} iterations (limit 3, CPU {res2_cpu.num_iterations}), "
        f"max |card - CPU| {e_warm:.3e} (limit 1e-8)")
    if not (res.solved and res_cpu.solved and e_obj <= 1e-6 and e_cpu <= 1e-8
            and e_dual <= 1e-8 and e_kkt <= 1e-6):
        fail("the LP known answer does not hold on the card")
    if not (res2.solved and res2.num_iterations <= 3
            and res2.num_iterations == res2_cpu.num_iterations and e_warm <= 1e-8):
        fail("the warmstart resume after save_state/load_state does not hold")


# ---------------------------------------------------------------------------
# The indefinite-KKT path: equality rows, quadratic costs and cones, LDLT, QR
# ---------------------------------------------------------------------------

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")
DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_profile(fn):
    """One call of ``fn`` under torch.profiler: (device-kernel ms, kernel
    launch calls, [(ms, count, name)] of the device kernels, largest
    first).  The trace is read from its Chrome-trace export (the device's
    kernel, copy and set events, as key_averages() counts them; launch
    calls by their runtime and driver API events), which takes a third of
    the time key_averages() takes on a trace of 10^5 launches.  A spin kernel goes first and is left out of
    every count (the trace may miss the first kernel launched in its
    window); a trace that holds fewer kernels than launch calls is taken
    again, up to three times."""
    import collections
    import json
    import os
    import tempfile

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda._sleep(1_000_000)
            fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        kernels = collections.defaultdict(lambda: [0.0, 0])
        launches = -1  # the spin kernel's
        for e in events:
            cat, name = e.get("cat"), e.get("name", "")
            if cat in DEVICE_EVENTS and "spin_kernel" not in name:
                kernels[name][0] += e.get("dur", 0.0) / 1e3
                kernels[name][1] += 1
            elif cat in ("cuda_runtime", "cuda_driver") and name in LAUNCH_CALLS:
                launches += 1
        del events
        if sum(count for _, count in kernels.values()) >= launches:
            break
        log(f"[profile] the trace holds fewer kernels than the {launches} launch "
            "calls; tracing again")
    if launches <= 0 or not kernels:
        fail(f"the profiler's trace holds {launches} launch calls and "
             f"{len(kernels)} kernels")
    device_ms = sum(ms for ms, _ in kernels.values())
    top = sorted(((ms, count, name) for name, (ms, count) in kernels.items()),
                 reverse=True)
    return device_ms, launches, top


def best_wall(fn, reps=3):
    """The least host wall time of ``reps`` calls, each ended by a
    synchronize."""
    import torch

    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def eq_sdp_batch(seeds, n, m, p, device):
    """solve_scenarios' arguments for the programs of eq_sdp_instance at
    ``seeds`` on ``device``, and their numpy data (As, C, Aeq, beq, b)."""
    import numpy as np

    from conex_tpu_torch import convert
    from conex_tpu_torch.cones.psd import make_psd_state

    data = tuple(map(np.stack, zip(*(eq_sdp_instance(s, n, m, p) for s in seeds))))
    As, C, Aeq, beq, b = data
    S = len(seeds)
    ws = make_psd_state(convert.tensor(np.broadcast_to(np.eye(n), (S, 1, n, n)), device))
    args = ((convert.lmi_cone(As[:, None], C[:, None], device),),
            (convert.equality_block(Aeq, beq, device),), convert.tensor(b, device),
            (ws,), convert.scalars(dict(k=np.zeros(S), b_scaling=np.ones(S),
                                        c_scaling=np.ones(S)), device))
    return args, data


def phase_eq_sdp(device):
    """4d: S equality-constrained SDPs at bench.py's width through K1 and the
    LDLT, f64; returns K1's launches in the solve."""
    from unittest import mock

    import numpy as np
    import torch

    from conex_tpu_torch import solve_scenarios
    from conex_tpu_torch.solver import kkt
    from conex_tpu_torch.utils.profiling import counters

    S, n, m, p = EQ_SDP_SHAPE
    config = eq_sdp_config()
    t0 = time.perf_counter()
    args, (As, C, Aeq, beq, b) = eq_sdp_batch(range(S), n, m, p, device)
    log(f"[4d eq sdp] {S} programs (n={n}, m={m}, p={p}, f64) built in "
        f"{time.perf_counter() - t0:.2f} s; n_kkt = {m + p}")
    counters["schur.calls"] = 0
    counters["socp.calls"] = 0
    t0 = time.perf_counter()
    # One KKT factor per loop pass: the passes the loop ran.
    with mock.patch.object(kkt, "factor", wraps=kkt.factor) as factor:
        res = solve_scenarios(*args, config)
        torch.cuda.synchronize()
    passes = factor.call_count
    first = time.perf_counter() - t0
    launches = counters["schur.calls"]
    iters = res.num_iterations.cpu().numpy()
    log(f"[4d eq sdp] first solve {first:.3f} s: iterations {iters.min()}-{iters.max()} "
        f"(median {np.median(iters):.0f}), loop passes {passes}, K1 launches "
        f"{launches}, K2 launches {counters['socp.calls']}")
    if counters["socp.calls"]:
        fail("the fused SOCP kernel ran on the equality SDP path")
    if not (launches == passes and iters.max() <= launches <= iters.max() + 1):
        fail(f"K1 launched {launches} times in {passes} loop passes "
             f"(most iterations {iters.max()}): not once per iteration")
    solved = res.solved.cpu().numpy()
    if not solved.all():
        fail(f"4d: scenarios {np.flatnonzero(~solved).tolist()} not solved")
    y = res.y.cpu().numpy()
    feas = (np.abs(np.einsum("spm,sm->sp", Aeq, y) - beq).max(axis=1)
            / (1.0 + np.abs(beq).max(axis=1)))
    Ct = torch.from_numpy(C).to(device)
    slack = Ct - torch.einsum("sv,svij->sij", res.y, torch.from_numpy(As).to(device))
    lam = torch.linalg.eigvalsh(slack)[:, 0].cpu().numpy()
    log(f"[4d eq sdp] all {S} solved; worst ||Aeq y - beq||_inf / (1 + ||beq||_inf) "
        f"{feas.max():.3e} (limit {EQ_FEAS_LIMIT}), least lambda_min(C - sum y_i A_i) "
        f"{lam.min():.3e} (limit {EQ_PSD_LIMIT})")
    if not (feas.max() <= EQ_FEAS_LIMIT and lam.min() >= EQ_PSD_LIMIT):
        fail("4d: an equality row or the LMI is broken at the solution")

    # Scenarios 0 to EQ_SDP_CPU - 1 again on the CPU (the plain path).
    cpu_args, _ = eq_sdp_batch(range(EQ_SDP_CPU), n, m, p, torch.device("cpu"))
    t0 = time.perf_counter()
    cpu = solve_scenarios(*cpu_args, config)
    cpu_s = time.perf_counter() - t0
    by = np.einsum("sm,sm->s", b[:EQ_SDP_CPU], y[:EQ_SDP_CPU])
    by_cpu = np.einsum("sm,sm->s", b[:EQ_SDP_CPU], cpu.y.numpy())
    d_obj = np.abs(by - by_cpu) / np.abs(by_cpu)
    d_it = np.abs(iters[:EQ_SDP_CPU] - cpu.num_iterations.numpy())
    log(f"[4d eq sdp] scenarios 0-{EQ_SDP_CPU - 1} on the CPU ({cpu_s:.1f} s): "
        f"b'y card {by.tolist()}, CPU {by_cpu.tolist()}, relative differences "
        f"{d_obj.tolist()} (limit {EQ_OBJ_LIMIT}); iterations card "
        f"{iters[:EQ_SDP_CPU].tolist()}, CPU {cpu.num_iterations.tolist()} (spread "
        f"limit {config.final_centering_steps})")
    if not (cpu.solved.all() and d_obj.max() <= EQ_OBJ_LIMIT
            and d_it.max() <= config.final_centering_steps):
        fail("4d: the card and the CPU disagree")

    wall = best_wall(lambda: solve_scenarios(*args, config))
    total = int(iters.sum())
    log(f"[4d eq sdp] wall per solve {wall * 1e3:.3f} ms (best of 3), Newton it/s "
        f"{total / wall:.2f} ({total} iterations in {passes} passes)")
    K = torch.zeros((S, m + p, m + p), dtype=torch.float64, device=device)
    K[:, :m, :m] = torch.eye(m, dtype=torch.float64, device=device)
    K[:, m:, :m] = torch.from_numpy(Aeq).to(device)
    K[:, :m, m:] = K[:, m:, :m].transpose(1, 2)
    ldlt_ms, ldlt_launches, _ = device_profile(lambda: kkt.factor(K, config.kkt_solver))
    device_ms, solve_launches, top = device_profile(lambda: solve_scenarios(*args, config))
    log(f"[4d eq sdp] one LDLT factor of the ({S}, {m + p}, {m + p}) KKT matrices: "
        f"{ldlt_launches} launches, {ldlt_ms:.3f} ms of device time; one profiled "
        f"solve: {solve_launches} launches ({solve_launches / passes:.1f} per "
        f"pass), device-kernel time {device_ms:.3f} ms, busy "
        f"{100 * device_ms / (wall * 1e3):.1f}% of the unprofiled wall")
    for ms, count, key in top[:5]:
        log(f"[4d eq sdp]   {ms:9.3f} ms x{count:<6} {key[:90]}")
    return launches


def qp_program(n, W, A, b, device, epigraph=False):
    """The QP min 1/2 x'Wx + c'x s.t. Ax + b >= 0 as a Program on ``device``
    (maximize -c'y - 1/2 y'Wy): a quadratic cost, or with ``epigraph`` the
    cost's epigraph t >= 1/2 x'Wx over y = (x, t)."""
    import numpy as np

    from conex_tpu_torch import Program

    if not epigraph:
        prog = Program(n, device=device)
        prog.add_quadratic_cost(W)
        prog.add_linear_constraint(-A, b)
        return prog
    prog = Program(n + 1, device=device)
    prog.add_quadratic_cost_epigraph(W, range(n), n)
    prog.add_linear_constraint(np.hstack([-A, np.zeros((A.shape[0], 1))]), b)
    return prog


def phase_qp(device):
    """4e: QPs at the LP path's width, f64: one Program against the CPU,
    a batch of QP_BATCH, and the epigraph form of seed 0."""
    import numpy as np
    import torch

    from conex_tpu_torch import SolverConfig, convert, solve_scenarios
    from conex_tpu_torch.utils.profiling import counters

    kernels = ("schur.calls", "socp.calls")
    for kernel in kernels:
        counters[kernel] = 0
    n, ni = QP_SHAPE
    config = qp_config()
    W, A, b, c, x_opt, slack_opt = qp_with_solution(n, ni, np.random.default_rng(0))
    out = {}
    for where in ("card", "cpu"):
        prog = qp_program(n, W, A, b, device if where == "card" else "cpu")
        out[where] = (prog, prog.solve(-c, config))
    (prog, res), (_, res_cpu) = out["card"], out["cpu"]
    # The iteration count of this solve moves with one rounding: the CPU
    # itself, with b moved by 1 or 2 units of 2^-52, ends anywhere in
    # 36-57 iterations (tools/reference_runs.py qp shows the JAX package do
    # the same).  So the card's count is held to the range of the CPU's
    # under those roundings, widened by the five final-centering steps of
    # the default configuration (LP_CENTERING_SPREAD).
    cpu_counts = [res_cpu.num_iterations] + [
        qp_program(n, W, A, b, "cpu").solve(-c * (1 + e * 2.0**-52), config).num_iterations
        for e in (1, -1, 2, -2)]
    low = min(cpu_counts) - LP_CENTERING_SPREAD
    high = max(cpu_counts) + LP_CENTERING_SPREAD
    e_y = float(np.abs(res.y - x_opt).max())
    e_s = float(np.abs(A @ res.y + b - slack_opt).max())
    e_cpu = float(np.linalg.norm(res.y - res_cpu.y) / np.linalg.norm(res_cpu.y))
    wall = best_wall(lambda: prog.solve(-c, config))
    log(f"[4e qp] Program, {n} vars x {ni} inequalities, f64: solved {res.solved} in "
        f"{res.num_iterations} iterations (CPU {res_cpu.num_iterations}, solved "
        f"{res_cpu.solved}; the CPU with b moved by 1, -1, 2, -2 units of 2^-52: "
        f"{cpu_counts[1:]}, so a limit of {low}-{high}); |y - x_opt|_inf {e_y:.3e} "
        f"(limit {QP_Y_LIMIT}), slack {e_s:.3e} (limit {QP_SLACK_LIMIT}), y vs CPU "
        f"{e_cpu:.3e} (limit {QP_CPU_LIMIT}); wall per solve {wall * 1e3:.3f} ms (best "
        f"of 3), Newton it/s {res.num_iterations / wall:.2f}")
    if not (res.solved and res_cpu.solved and e_y <= QP_Y_LIMIT and e_s <= QP_SLACK_LIMIT
            and e_cpu <= QP_CPU_LIMIT and low <= res.num_iterations <= high):
        fail("4e: the QP Program breaks its limits on the card")

    S = QP_BATCH
    Ws, As, bs, cs, xs, ss = map(np.stack, zip(*(
        qp_with_solution(n, ni, np.random.default_rng(s)) for s in range(S))))
    args = ((convert.quadratic_cost(Ws, device), convert.linear_cone(-As, bs, device)), (),
            convert.tensor(-cs, device),
            (torch.zeros((S, 0), dtype=torch.float64, device=device),
             torch.ones((S, ni), dtype=torch.float64, device=device)),
            convert.scalars(dict(k=np.zeros(S), b_scaling=np.ones(S),
                                 c_scaling=np.ones(S)), device))
    r = convert.to_numpy(solve_scenarios(*args, config))
    e_y = np.abs(r.y - xs).max(axis=1)
    e_s = np.abs(np.einsum("sij,sj->si", As, r.y) + bs - ss).max(axis=1)
    wall = best_wall(lambda: solve_scenarios(*args, config))
    total = int(r.num_iterations.sum())
    device_ms, launches, top = device_profile(lambda: solve_scenarios(*args, config))
    passes = int(r.num_iterations.max())
    log(f"[4e qp] batch of {S} (seeds 0-{S - 1}), f64: solved {int(r.solved.sum())}/{S} "
        f"in {int(r.num_iterations.min())}-{passes} iterations; worst |y - x_opt|_inf "
        f"{e_y.max():.3e} (seed {int(np.argmax(e_y))}, limit {QP_BATCH_Y_LIMIT}), worst "
        f"slack {e_s.max():.3e} (limit {QP_BATCH_SLACK_LIMIT}); wall per solve {wall * 1e3:.3f} ms (best of 3), Newton "
        f"it/s {total / wall:.2f} ({total} iterations); one profiled solve: {launches} "
        f"launches (about {launches / passes:.1f} per pass), device-kernel time "
        f"{device_ms:.3f} ms, busy {100 * device_ms / (wall * 1e3):.1f}% of the wall")
    for ms, count, key in top[:5]:
        log(f"[4e qp]   {ms:9.3f} ms x{count:<6} {key[:90]}")
    if not (r.solved.all() and e_y.max() <= QP_BATCH_Y_LIMIT
            and e_s.max() <= QP_BATCH_SLACK_LIMIT):
        fail(f"4e: the QP batch breaks its limits (unsolved "
             f"{np.flatnonzero(~r.solved).tolist()})")

    # The epigraph form of seed 0: y = (x, t), t >= 1/2 x'Wx through a
    # Q-weighted Lorentz cone (tests/test_quadratic_cone.py's configuration,
    # with EPIGRAPH_ITERATIONS).
    epi_config = SolverConfig(max_iterations=EPIGRAPH_ITERATIONS, inv_sqrt_mu_max=1e5)
    epi = qp_program(n, W, A, b, device, epigraph=True)
    obj = np.concatenate([-c, [-1.0]])
    res = epi.solve(obj, epi_config)
    e_y = float(np.abs(res.y[:n] - x_opt).max())
    e_t = abs(float(res.y[n]) - 0.5 * float(res.y[:n] @ W @ res.y[:n]))
    wall = best_wall(lambda: epi.solve(obj, epi_config))
    log(f"[4e qp] epigraph form, Program({n + 1}): solved {res.solved} in "
        f"{res.num_iterations} iterations, |y - x_opt|_inf {e_y:.3e} (limit "
        f"{QP_EPIGRAPH_LIMIT}), |t - x'Wx/2| {e_t:.3e}; wall per solve "
        f"{wall * 1e3:.3f} ms (best of 3), Newton it/s {res.num_iterations / wall:.2f}")
    if not (res.solved and e_y <= QP_EPIGRAPH_LIMIT):
        fail("4e: the epigraph QP breaks its limit on the card")
    if any(counters[kernel] for kernel in kernels):
        fail("K1 or K2 launched on the QP path")


def eq_lp_instance(rng, m=5, n=8, p=2):
    """tests/test_equality.py::build_instance: an LP of n rows over m
    variables with p equality rows.  Returns A, c, Aeq, beq, b."""
    import numpy as np

    A = rng.uniform(-1, 1, (n, m))
    c = np.abs(rng.uniform(-1, 1, n)) + 0.5
    Aeq = rng.uniform(-1, 1, (p, m))
    beq = Aeq @ (0.1 * rng.uniform(-1, 1, m))
    b = A.T @ np.abs(rng.uniform(-1, 1, n)) + Aeq.T @ rng.uniform(-1, 1, p)
    return A, c, Aeq, beq, b


def phase_eq_known_answers(device):
    """5d: the JAX package's equality, QR and QP-guard tests on the card."""
    import numpy as np

    from conex_tpu_torch import KKT_SOLVER_LLT, KKT_SOLVER_QR, Program, SolverConfig

    # tests/test_equality.py::test_equality_known_optimum: maximize y1 + y2
    # s.t. y1 + y2 + y3 = 1, 0 <= y <= 1: optimum 1.
    m = 3
    ys = {}
    for where in ("card", "cpu"):
        prog = Program(m, device=device if where == "card" else "cpu")
        prog.add_linear_constraint(np.vstack([np.eye(m), -np.eye(m)]),
                                   np.concatenate([np.ones(m), np.zeros(m)]))
        prog.add_equality_constraint(np.ones((1, m)), np.array([1.0]))
        res = prog.solve(np.array([1.0, 1.0, 0.0]), SolverConfig(max_iterations=60))
        if not res.solved:
            fail(f"5d: the equality known optimum is not solved on the {where}")
        ys[where] = res.y
    e_obj = abs(ys["card"][0] + ys["card"][1] - 1.0)
    e_eq = abs(ys["card"].sum() - 1.0)
    e_cpu = float(np.abs(ys["card"] - ys["cpu"]).max())
    log(f"[5d eq known answers] max y1 + y2 s.t. y1 + y2 + y3 = 1, 0 <= y <= 1: y "
        f"{ys['card'].tolist()}, |b'y - 1| {e_obj:.3e} (limit 1e-6), |sum y - 1| "
        f"{e_eq:.3e} (limit 1e-8), max |card - CPU| {e_cpu:.3e} (limit 1e-8)")
    if not (e_obj <= 1e-6 and e_eq <= 1e-8 and e_cpu <= 1e-8):
        fail("5d: the equality known optimum does not hold on the card")

    # tests/test_equality.py::test_equality_kkt: stationarity through the
    # cone and equality duals.
    A, c, Aeq, beq, b = eq_lp_instance(np.random.default_rng(0))
    prog = Program(5, device=device)
    prog.add_linear_constraint(A, c)
    prog.add_equality_constraint(Aeq, beq)
    res = prog.solve(b, SolverConfig(max_iterations=60, prepare_dual_variables=True))
    x, lam = prog.get_dual_variable(0), prog.get_equality_dual(0)
    e_stat = float(np.linalg.norm(A.T @ x + Aeq.T @ lam - b))
    e_feas = float(np.linalg.norm(Aeq @ res.y - beq))
    log(f"[5d eq known answers] equality KKT instance: solved {res.solved} in "
        f"{res.num_iterations} iterations, ||A'x + Aeq'lambda - b|| {e_stat:.3e} "
        f"(limit 1e-5), ||Aeq y - beq|| {e_feas:.3e} (limit 1e-8), min x "
        f"{float(x.min()):.3e}")
    if not (res.solved and e_stat <= 1e-5 and e_feas <= 1e-8 and x.min() >= -1e-9):
        fail("5d: the equality duals are not stationary on the card")

    # tests/test_failure_corpus.py::test_qr_succeeds_where_llt_fails.
    rng = np.random.default_rng(1)
    row = rng.uniform(-1, 1, 4)
    A = np.vstack([row, row, rng.uniform(-1, 1, 4)])
    c = np.abs(rng.uniform(0.5, 1.5, 3))
    c[1] = c[0]
    b = A.T @ np.array([1.0, 1.0, 0.5])
    out = {}
    for mode in (KKT_SOLVER_LLT, KKT_SOLVER_QR):
        prog = Program(4, device=device)
        prog.add_linear_constraint(A, c)
        out[mode] = prog.solve(b, SolverConfig(max_iterations=30, kkt_solver=mode))
    llt, qr = out[KKT_SOLVER_LLT], out[KKT_SOLVER_QR]
    least = float((c - A @ qr.y).min())
    log(f"[5d eq known answers] rank-deficient LP: LLT solved {llt.solved} (fail "
        f"{bool(llt._raw.fail)}), QR solved {qr.solved} in {qr.num_iterations} "
        f"iterations, least slack {least:.3e} (limit -1e-6)")
    if llt.solved or not bool(llt._raw.fail) or not qr.solved or least < -1e-6:
        fail("5d: LLT must fail and QR solve the rank-deficient LP on the card")

    # tests/test_qp.py::test_qp_requires_line_search.
    prog = Program(2, device=device)
    prog.add_quadratic_cost(np.eye(2))
    prog.add_linear_constraint(np.eye(2), np.ones(2))
    try:
        prog.solve(np.ones(2))
    except ValueError as err:
        if "line_search" not in str(err):
            fail(f"5d: the quadratic-cost guard raised {err!r}")
        log(f"[5d eq known answers] quadratic cost without line search: {err}")
    else:
        fail("5d: a quadratic cost without line search was solved")


# ---------------------------------------------------------------------------
# The Hermitian cones (phase 4f) and the front ends (phase 5e)
# ---------------------------------------------------------------------------


def rand_hermitian(d, n, rng):
    """benchmarks/bench_hermitian.py's and bench_accuracy.py's element:
    component 0 symmetric, the others skew, entries uniform in [-1, 1]."""
    x = rng.uniform(-1, 1, (d, n, n))
    x[0] = 0.5 * (x[0] + x[0].T)
    for k in range(1, d):
        x[k] = 0.5 * (x[k] - x[k].T)
    return x


def herm_workload(S, d, n, m, seed=0, dtype="float32"):
    """benchmarks/bench_hermitian.py:27-46 (_herm_workload): S scenarios,
    each one Hermitian LMI of cone-batch 1, A (S, 1, m, d, n, n), C
    (S, 1, d, n, n) = I, b (S, m) = A(0.3 I)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    A = np.stack([[[rand_hermitian(d, n, rng) for _ in range(m)]]
                  for _ in range(S)]).astype(dtype)
    C = np.zeros((S, 1, d, n, n), dtype)
    C[:, :, 0] = np.eye(n, dtype=dtype)
    X0 = np.zeros((S, 1, d, n, n), dtype)
    X0[:, :, 0] = 0.3 * np.eye(n, dtype=dtype)
    b = np.einsum("sbvdij,sbdij->sv", A, X0).astype(dtype)
    return A, C, b


def herm_config():
    """bench_hermitian.py:67-74: 30 fixed iterations, the scaled-k cap 100."""
    from conex_tpu_torch import SolverConfig

    return SolverConfig(max_iterations=HERM_ITERATIONS, final_centering_steps=0,
                        inv_sqrt_mu_max=1e15, fixed_iterations=True,
                        inv_sqrt_mu_cap_scaled=100.0, minimum_mu=1e-15)


def herm_args(A, C, b, device):
    """solve_scenarios' arguments for a Hermitian batch on ``device``,
    from the identity (HermState with the cold sentinel)."""
    import numpy as np

    from conex_tpu_torch import convert
    from conex_tpu_torch.cones.hermitian import make_herm_state

    S = A.shape[0]
    e = np.zeros(C.shape, A.dtype)
    e[:, :, 0] = np.eye(A.shape[-1], dtype=A.dtype)
    ws = convert.tensor(e, device)
    ws = ws if A.shape[3] == 8 else make_herm_state(ws)
    one = np.ones(S, A.dtype)
    return ((convert.hermitian_cone(A, C, device),), (), convert.tensor(b, device),
            (ws,), convert.scalars(dict(k=0 * one, b_scaling=one, c_scaling=one), device))


def herm_batch(label, args, config, cold=False):
    """One Hermitian batch: the bench validity rule (every scenario runs
    the configured iterations with no factorization failure, y finite) and
    Newton it/s, best of 3 (b moved a little each time, as bench.py does);
    ``cold`` forces the cold estimator (cones/hermitian.py FORCE_COLD)."""
    import torch

    from conex_tpu_torch import solve_scenarios
    from conex_tpu_torch.cones import hermitian

    blocks, eqs, b, ws, scalars = args
    hermitian.FORCE_COLD = cold
    try:
        t0 = time.perf_counter()
        res = solve_scenarios(blocks, eqs, b, ws, scalars, config)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        iters = res.num_iterations.cpu()
        fails = int(res.fail.sum())
        if not ((iters == config.max_iterations).all() and fails == 0):
            fail(f"4f {label}: iterations {iters.min()}-{iters.max()}, failures "
                 f"{fails}: the bench validity rule needs {config.max_iterations} "
                 "iterations and no failure in every scenario")
        if res.y.shape != b.shape or not torch.isfinite(res.y).all():
            fail(f"4f {label}: y is not finite of shape {tuple(b.shape)}")
        best = float("inf")
        for rep in range(3):
            bv = b * (1.0 + 1e-6 * (rep + 1))
            t0 = time.perf_counter()
            solve_scenarios(blocks, eqs, bv, ws, scalars, config)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
    finally:
        hermitian.FORCE_COLD = False
    total = int(iters.sum())
    log(f"[4f hermitian] {label}: all {len(iters)} scenarios ran {config.max_iterations} "
        f"iterations, no failure; first solve {first:.3f} s; Newton it/s "
        f"{total / best:.2f} (best of 3: {best * 1e3:.3f} ms)")
    return best, total


def phase_herm(device):
    """4f: bench_hermitian.py's batch (S = 32 complex LMIs, n = 64, m = 16,
    f32, 30 fixed iterations) warm and cold, the same at d = 4, launches per
    iteration and busy share; then a small f64 batch, card against CPU."""
    import numpy as np

    from conex_tpu_torch import convert, solve_scenarios
    from conex_tpu_torch.utils.profiling import counters

    start = time.perf_counter()
    S, d, n, m = HERM_SHAPE
    config = herm_config()
    t0 = time.perf_counter()
    args = herm_args(*herm_workload(S, d, n, m), device)
    log(f"[4f hermitian] S={S} Hermitian LMIs over d={d} (n={n}, m={m}, f32) built in "
        f"{time.perf_counter() - t0:.2f} s")
    counters["schur.calls"] = 0
    counters["socp.calls"] = 0
    warm, total = herm_batch("warm (HermState seeds)", args, config)
    if counters["schur.calls"] or counters["socp.calls"]:
        fail("4f: K1 or K2 launched on the Hermitian path")
    cold, _ = herm_batch("cold (FORCE_COLD)", args, config, cold=True)
    log(f"[4f hermitian] warm over cold: {cold / warm:.3f}x")
    quat, _ = herm_batch("d=4 (quaternions), warm", herm_args(
        *herm_workload(S, 4, n, m), device), config)
    device_ms, launches, top = device_profile(lambda: solve_scenarios(*args, config))
    log(f"[4f hermitian] one profiled warm solve: {launches} launches "
        f"({launches / config.max_iterations:.1f} per iteration), device-kernel time "
        f"{device_ms:.3f} ms, busy {100 * device_ms / (warm * 1e3):.1f}% of the "
        "unprofiled wall")
    for ms, count, key in top[:5]:
        log(f"[4f hermitian]   {ms:9.3f} ms x{count:<6} {key[:90]}")

    # A small f64 batch on the card against the CPU (the same config).
    A, C, b = herm_workload(4, d, 8, 4, seed=1, dtype="float64")
    out = [convert.to_numpy(solve_scenarios(*herm_args(A, C, b, dev), config))
           for dev in (device, "cpu")]
    g, c = out
    dk = float(np.max(np.abs(g.stats_k - c.stats_k) / np.abs(c.stats_k)))
    dy = float(np.max(np.abs(g.y - c.y) / (np.abs(c.y) + 1e-9)))
    log(f"[4f hermitian] small f64 batch (S=4, d={d}, n=8, m=4) card vs CPU: max rel "
        f"diff stats_k {dk:.3e} (limit {HERM_K_LIMIT}), y {dy:.3e} (limit "
        f"{HERM_Y_LIMIT})")
    if not (g.num_iterations == c.num_iterations).all() or g.fail.any():
        fail("4f small f64 run: card and CPU disagree on iterations or failures")
    if not (dk <= HERM_K_LIMIT and dy <= HERM_Y_LIMIT):
        fail("4f small f64 run: card and CPU trajectories disagree")
    log(f"[4f hermitian] phase {time.perf_counter() - start:.1f} s")


def tridiagonal_lmi(d, device):
    """tests/test_interface.py::test_solve_hermitian_lmi_known_solution
    through Conex: a tridiagonal Hermitian LMI of order 3 whose optimum is
    y = -1."""
    import numpy as np

    from conex_tpu_torch.interface import Conex

    order = 3
    prog = Conex(order - 1, device=device)
    con = prog.NewLinearMatrixInequality(order, d)
    for i in range(order - 1):
        prog.UpdateLinearOperator(con, -1.0, i, i + 1, i, d - 1)
    for i in range(order):
        prog.UpdateAffineTerm(con, 2.0 if i == 1 else 1.0, i, i, 0)
    return prog, prog.Maximize(-np.ones(order - 1))


def octonion_program(device):
    """tests/test_hermitian.py::test_octonion_sdp_solves (seed 4, n = 3,
    m = 2) as a Program on ``device``, and its objective."""
    import numpy as np

    from conex_tpu_torch import Program

    rng = np.random.default_rng(4)
    n, m = 3, 2
    A = np.stack([rand_hermitian(8, n, rng) for _ in range(m)])
    C = np.zeros((8, n, n))
    C[0] = np.eye(n) * 10.0
    X0 = np.zeros((8, n, n))
    X0[0] = np.eye(n)
    prog = Program(m, device=device)
    prog.add_hermitian_constraint(A, C)
    return prog, np.einsum("vdij,dij->v", A, X0)


def herm_accuracy_program(dim, device):
    """bench_accuracy.py:204-245 (run_hermitian): one Hermitian LMI over
    the algebra of dimension ``dim`` (seed 10 + dim, n = 16, m = 8, C = I)
    as a Program on ``device``, b = its feasible objective, and the
    configuration (mu target 1e-8, 100 iterations)."""
    import numpy as np

    from conex_tpu_torch import Program, SolverConfig

    rng = np.random.default_rng(10 + dim)
    n, m = 16, 8
    A = np.stack([rand_hermitian(dim, n, rng) for _ in range(m)])
    C = np.zeros((dim, n, n))
    C[0] = np.eye(n)
    prog = Program(m, device=device)
    prog.add_hermitian_constraint(A, C)
    config = SolverConfig(max_iterations=100, inv_sqrt_mu_max=1.0 / np.sqrt(1e-8))
    return prog, prog.get_feasible_objective(), config


def phase_front_ends(device):
    """5e: the Hermitian known answers and the front ends on the card
    against the CPU; returns K1's launches on the d = 1 LMI."""
    from unittest import mock

    import numpy as np

    from conex_tpu_torch import SolverConfig
    from conex_tpu_torch.sedumi import solve_sedumi
    from conex_tpu_torch.solver import kkt
    from conex_tpu_torch.utils.profiling import counters

    start = time.perf_counter()
    k1 = 0
    for d in (1, 2, 4, 8):
        counters["schur.calls"] = 0
        with mock.patch.object(kkt, "factor", wraps=kkt.factor) as factor:
            prog, sol = tridiagonal_lmi(d, device)
        launches, passes = counters["schur.calls"], factor.call_count
        _, cpu = tridiagonal_lmi(d, "cpu")
        e_ans = float(np.linalg.norm(sol.y + 1.0))
        e_cpu = float(np.abs(sol.y - cpu.y).max())
        limit = HERM_CPU_LIMIT if d < 8 else HERM_EXACT_LIMIT
        log(f"[5e front ends] Conex tridiagonal Hermitian LMI, d={d}: solved "
            f"{sol.status} in {prog._result.num_iterations} iterations, |y + 1| "
            f"{e_ans:.3e} (limit 1e-5), max |card - CPU| {e_cpu:.3e} (limit {limit}); "
            f"K1 launches {launches} in {passes} KKT factors")
        if not (sol.status and cpu.status and e_ans <= 1e-5 and e_cpu <= limit):
            fail(f"5e: the d = {d} tridiagonal LMI is not y = -1 on the card")
        if d == 1 and not (launches == passes and launches >= prog._result.num_iterations):
            fail("5e: K1 did not launch once per KKT assembly on the d = 1 LMI")
        if d > 1 and launches:
            fail("5e: K1 launched on a Hermitian LMI")
        k1 += launches

    ys = {}
    for where in ("card", "cpu"):
        prog, b = octonion_program(device if where == "card" else "cpu")
        res = prog.solve(b, SolverConfig(max_iterations=60))
        mu = 1.0 / res.stats_inv_sqrt_mu ** 2
        if not (res.solved and np.all(np.diff(mu) <= 1e-9)):
            fail(f"5e: the octonion SDP is not solved with a falling mu on the {where}")
        ys[where] = (res.y, res.num_iterations)
    e_oct = float(np.abs(ys["card"][0] - ys["cpu"][0]).max() / np.abs(ys["cpu"][0]).max())
    log(f"[5e front ends] octonion SDP (n=3, m=2): solved in {ys['card'][1]} iterations "
        f"(CPU {ys['cpu'][1]}), y {ys['card'][0].tolist()}, relative |card - CPU| "
        f"{e_oct:.3e} (limit {HERM_EXACT_LIMIT})")
    if not (e_oct <= HERM_EXACT_LIMIT and ys["card"][1] == ys["cpu"][1]):
        fail("5e: the octonion SDP differs between card and CPU")

    for dim, name in ((2, "complex"), (4, "quaternion")):
        out = {}
        for where in ("card", "cpu"):
            prog, b, config = herm_accuracy_program(dim, device if where == "card" else "cpu")
            t0 = time.perf_counter()
            res = prog.solve(b, config)
            wall = time.perf_counter() - t0
            if not res.solved:
                fail(f"5e: bench_accuracy's {name} Hermitian SDP is not solved on the {where}")
            out[where] = (float(b @ res.y), res.num_iterations, wall,
                          float(1.0 / res.stats_inv_sqrt_mu[-1] ** 2))
        by, by_cpu = out["card"][0], out["cpu"][0]
        d_obj = abs(by - by_cpu) / abs(by_cpu)
        log(f"[5e front ends] bench_accuracy {name} (n=16, m=8, f64, mu target 1e-8): "
            f"card {out['card'][1]} iterations in {out['card'][2] * 1e3:.1f} ms, final mu "
            f"{out['card'][3]:.3e}; b'y card {by!r}, CPU {by_cpu!r} ({out['cpu'][1]} "
            f"iterations), relative difference {d_obj:.3e} (limit {HERM_OBJ_LIMIT})")
        if not d_obj <= HERM_OBJ_LIMIT:
            fail(f"5e: bench_accuracy's {name} SDP: card and CPU objectives differ")

    A, b, c, K = sedumi_all_cone_types()
    got = {}
    for where in ("card", "cpu"):
        x, y, info = solve_sedumi(A, b, c, K, device=device if where == "card" else "cpu")
        got[where] = (x, y, info)
    x, y, info = got["card"]
    X = x[-9:].reshape(3, 3)
    e_feas = float(np.linalg.norm(A @ x - b))
    e_gap = float(abs(c @ x - b @ y))
    lam = float(np.linalg.eigvalsh(0.5 * (X + X.T)).min())
    e_cpu = float(np.abs(y - got["cpu"][1]).max() / np.abs(got["cpu"][1]).max())
    log(f"[5e front ends] solve_sedumi f + l + q + q + s: {info}; ||Ax - b|| {e_feas:.3e} "
        f"(limit 1e-4), |c'x - b'y| {e_gap:.3e} (limit 1e-3), lambda_min(X) {lam:.3e} "
        f"(limit -1e-6), y relative |card - CPU| {e_cpu:.3e} (limit {HERM_CPU_LIMIT})")
    if not (info["solved"] and info == got["cpu"][2] and e_feas < 1e-4 and e_gap < 1e-3
            and lam >= -1e-6 and e_cpu <= HERM_CPU_LIMIT):
        fail("5e: solve_sedumi's all-cone-types problem does not hold on the card")
    log(f"[5e front ends] phase {time.perf_counter() - start:.1f} s")
    return k1


def sedumi_all_cone_types():
    """tests/test_sedumi.py::test_sedumi_all_cone_types_combined's problem:
    (A, b, c, K) with f + l + two q blocks + an s block."""
    import numpy as np

    rng = np.random.default_rng(3)
    m = 4
    nf, nl, q1, q2, ns = 1, 3, 3, 4, 3
    A = rng.uniform(-1, 1, (m, nf + nl + q1 + q2 + ns * ns))
    xf = rng.uniform(-1, 1, nf)
    xl = np.abs(rng.uniform(0.2, 1, nl))
    xq1 = np.concatenate([[1.0], rng.uniform(-0.2, 0.2, q1 - 1)])
    xq2 = np.concatenate([[1.0], rng.uniform(-0.2, 0.2, q2 - 1)])
    Xs = rng.uniform(-1, 1, (ns, ns))
    Xs = Xs @ Xs.T + 0.2 * np.eye(ns)
    b = A @ np.concatenate([xf, xl, xq1, xq2, Xs.reshape(-1)])
    yref = rng.uniform(-0.5, 0.5, m)
    sl = np.concatenate([
        np.zeros(nf),
        np.abs(rng.uniform(0.2, 1, nl)),
        np.concatenate([[1.2], rng.uniform(-0.2, 0.2, q1 - 1)]),
        np.concatenate([[1.2], rng.uniform(-0.2, 0.2, q2 - 1)]),
        (2.0 * np.eye(ns)).reshape(-1),
    ])
    return A, b, A.T @ yref + sl, dict(f=nf, l=nl, q=[q1, q2], s=[ns])


# ---------------------------------------------------------------------------
# 5f: the C ABI, the MATLAB shim's sequence and the example
# ---------------------------------------------------------------------------


def abi_programs():
    """tests/test_c_abi.py's six programs, as {name: (m, ops, b, config)}:
    ops is the build sequence (run by abi_run through the C ABI and by
    conex_run through interface.Conex), b the cost of CONEX_Maximize (None:
    CONEX_Solve with the accumulated cost), config the fields set on the
    default options."""
    import numpy as np

    def sym_stack(rng, m, order):
        return np.stack([0.5 * (M + M.T) for M in rng.uniform(-1, 1, (m, order, order))])

    out = {}
    rng = np.random.default_rng(5)
    m, n = 4, 8
    A = rng.uniform(-1, 1, (n, m))
    b = A.T @ rng.uniform(0.5, 1.5, n)
    out["lp"] = (m, [("linear", A, rng.uniform(0.5, 1.5, n))], b,
                 dict(max_iterations=100, prepare_dual_variables=1))

    rng = np.random.default_rng(7)
    m, rows = 3, 4
    A = rng.uniform(-1, 1, (rows, m))
    lb, ub = np.array([-1.0, -2.0, 0.5, -1.5]), np.array([1.0, 2.0, 0.5, 1.5])
    out["box_ldlt"] = (m, [("box", A, lb, ub)], rng.uniform(-0.2, 0.2, m),
                       dict(max_iterations=100, kkt_solver=1))

    rng = np.random.default_rng(8)
    As = sym_stack(rng, 2, 3)
    ops = [("sparse_lmi", As, np.eye(3), [1, 3]),
           ("linear", np.vstack([np.eye(4), -np.eye(4)]), np.ones(8))]
    out["sparse_lmi"] = (4, ops, rng.uniform(-0.3, 0.3, 4), dict(max_iterations=100))

    rng = np.random.default_rng(9)
    n = 4
    M = rng.uniform(-1, 1, (n, n))
    ops = [("qcost", M @ M.T + n * np.eye(n)),
           ("linear", np.vstack([np.eye(n), -np.eye(n)]), np.full(2 * n, 10.0))]
    out["quadratic_cost"] = (n, ops, rng.uniform(-0.1, 0.1, n), dict(
        max_iterations=100, enable_line_search=1, enable_rescaling=0,
        inv_sqrt_mu_max=2e5))

    ops = [("new_qcost", [(1.0, i, i) for i in range(n)]),
           ("new_linear", 1, [(1.0, i, 0, 0) for i in range(n)], [(1.0, 0, 0)])]
    out["incremental_qp"] = (n, ops, None, dict(
        max_iterations=100, enable_line_search=1, enable_rescaling=0))

    rng = np.random.default_rng(6)
    m, order = 3, 4
    As = sym_stack(rng, m, order)
    entries = [(As[v, i, j], v, i, j, 0) for v in range(m) for i in range(order)
               for j in range(i + 1)]
    ops = [("new_lmi", order, 1, entries, [(1.0, i, i, 0) for i in range(order)])]
    out["incremental_lmi"] = (m, ops, np.einsum("vij,ij->v", As, 0.5 * np.eye(order)),
                              dict(max_iterations=100))
    return out


def abi_defaults(lib):
    """CONEX_SetDefaultOptions's fields, as SolverConfig keywords."""
    import ctypes

    from conex_tpu_torch import interfaces

    cfg = interfaces.SolverConfiguration()
    lib.CONEX_SetDefaultOptions(ctypes.byref(cfg))
    return cfg.fields()


def abi_run(lib, device, m, ops, b, config):
    """Build and solve one program through the C ABI (lib: interfaces.
    load()) on `device`, as a C caller does: matrices column-major, LMI
    operators as m consecutive blocks.  Returns {solved, y, duals (every
    constraint with a dual, where config prepares them), mu (the last
    iteration's, CONEX_GetIterationStats), iterations}."""
    import ctypes

    import numpy as np

    from conex_tpu_torch import interfaces

    def ptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    def check(status, what):
        if status != 0:
            raise RuntimeError(f"{what} failed ({status})")

    keep = []  # every buffer the library read, alive until the solve

    def buf(a):
        keep.append(np.ascontiguousarray(a, np.float64))
        return ptr(keep[-1])

    prog = lib.CONEX_CreateConeProgramOnDevice(str(device).encode())
    if not prog:
        raise RuntimeError(f"CONEX_CreateConeProgramOnDevice({device!r}) failed")
    try:
        check(lib.CONEX_SetNumberOfVariables(prog, m), "CONEX_SetNumberOfVariables")
        ids = []
        for op in ops:
            kind, args = op[0], op[1:]
            if kind == "linear":
                A, c = args
                ids.append(lib.CONEX_AddDenseLinearConstraint(
                    prog, buf(colmajor(A)), A.shape[0], A.shape[1], buf(c), len(c)))
            elif kind == "box":
                A, lb, ub = args
                rows, cols = A.shape
                if lib.CONEX_AddLinearInequalities(prog, buf(colmajor(A)), rows, cols,
                                                   buf(lb), rows, buf(ub), rows) != -1:
                    raise RuntimeError("CONEX_AddLinearInequalities failed")
            elif kind in ("dense_lmi", "sparse_lmi"):
                As, C = args[:2]
                k, n = As.shape[:2]
                if kind == "dense_lmi":
                    ids.append(lib.CONEX_AddDenseLMIConstraint(
                        prog, buf(colmajor(*As)), n, n, k, buf(colmajor(C)), n, n))
                else:
                    vars_ = np.asarray(args[2], np.int64)
                    keep.append(vars_)
                    ids.append(lib.CONEX_AddSparseLMIConstraint(
                        prog, buf(colmajor(*As)), n, n, k, buf(colmajor(C)), n, n,
                        vars_.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), k))
            elif kind == "qcost":
                (Q,) = args
                check(lib.CONEX_AddQuadraticCost(prog, buf(colmajor(Q)), *Q.shape),
                      "CONEX_AddQuadraticCost")
            elif kind == "new_qcost":
                cid = ctypes.c_int(-1)
                check(lib.CONEX_NewQuadraticCost(prog, ctypes.byref(cid)),
                      "CONEX_NewQuadraticCost")
                for value, row, col in args[0]:
                    check(lib.CONEX_UpdateQuadraticCostMatrix(prog, cid.value, value, row, col),
                          "CONEX_UpdateQuadraticCostMatrix")
            else:  # "new_linear" (rows, operator, affine), "new_lmi" (order, d, ...)
                cid = ctypes.c_int(-1)
                if kind == "new_linear":
                    check(lib.CONEX_NewLinearInequality(prog, args[0], ctypes.byref(cid)),
                          "CONEX_NewLinearInequality")
                    operator = [e + (0,) for e in args[1]]
                    affine = [e + (0,) for e in args[2]]
                else:
                    check(lib.CONEX_NewLinearMatrixInequality(
                        prog, args[0], args[1], ctypes.byref(cid)),
                        "CONEX_NewLinearMatrixInequality")
                    operator, affine = args[2], args[3]
                for value, var, row, col, dim in operator:
                    check(lib.CONEX_UpdateLinearOperator(prog, cid.value, value, var, row,
                                                         col, dim), "CONEX_UpdateLinearOperator")
                for value, row, col, dim in affine:
                    check(lib.CONEX_UpdateAffineTerm(prog, cid.value, value, row, col, dim),
                          "CONEX_UpdateAffineTerm")
                ids.append(cid.value)
        cfg = interfaces.SolverConfiguration()
        lib.CONEX_SetDefaultOptions(ctypes.byref(cfg))
        for name, value in config.items():
            setattr(cfg, name, value)
        y = np.zeros(m)
        if b is None:
            solved = lib.CONEX_Solve(prog, ctypes.byref(cfg), ptr(y), m)
        else:
            solved = lib.CONEX_Maximize(prog, buf(b), m, ctypes.byref(cfg), ptr(y), m)
        duals = []
        for cid in ids if cfg.prepare_dual_variables else ():
            size = lib.CONEX_GetDualVariableSize(prog, cid)
            if size < 0:
                raise RuntimeError(f"CONEX_GetDualVariableSize({cid}) failed")
            x = np.zeros(size)
            lib.CONEX_GetDualVariable(prog, cid, ptr(x), size, 1)
            duals.append(x)
        stats = interfaces.IterationStats()
        lib.CONEX_GetIterationStats(prog, ctypes.byref(stats), -1)
        return dict(solved=solved, y=y, duals=duals, mu=stats.mu,
                    iterations=stats.iteration_number + 1)
    finally:
        lib.CONEX_DeleteConeProgram(prog)


def conex_run(conex, config_cls, defaults, m, ops, b, config):
    """The same program through a Python Conex (conex(m) -> a Conex of
    either package; config_cls its SolverConfig), with the configuration
    the library builds: defaults (abi_defaults) updated by config.
    Returns (Conex, Solution)."""
    import numpy as np

    prog = conex(m)
    prog.SetNumberOfVariables(m)
    for op in ops:
        kind, args = op[0], op[1:]
        if kind == "linear":
            prog.AddLinearInequality(*args)
        elif kind == "box":
            prog.AddLinearInequalities(*args)
        elif kind == "dense_lmi":
            prog.AddDenseLMIConstraint(*args)
        elif kind == "sparse_lmi":
            prog.AddSparseLMIConstraint(args[0], args[1], list(args[2]))
        elif kind == "qcost":
            prog.AddQuadraticCost(*args)
        elif kind == "new_qcost":
            cid = prog.NewQuadraticCost()
            for value, row, col in args[0]:
                prog.UpdateQuadraticCostMatrix(cid, value, row, col)
        else:
            if kind == "new_linear":
                cid = prog.NewLinearInequality(args[0])
                operator = [e + (0,) for e in args[1]]
                affine = [e + (0,) for e in args[2]]
            else:
                cid = prog.NewLinearMatrixInequality(args[0], args[1])
                operator, affine = args[2], args[3]
            for value, var, row, col, dim in operator:
                prog.UpdateLinearOperator(cid, value, var, row, col, dim)
            for value, row, col, dim in affine:
                prog.UpdateAffineTerm(cid, value, row, col, dim)
    cfg = config_cls(**{**defaults, **config})
    sol = prog.Solve(cfg) if b is None else prog.Maximize(np.asarray(b, np.float64), cfg)
    return prog, sol


def colmajor(*mats):
    """The matrices' entries column-major, one after the other (the ABI's
    layout of a matrix and of an LMI operator's blocks)."""
    import numpy as np

    return np.concatenate([np.asarray(M, np.float64).ravel(order="F") for M in mats])


def bench_lmi(m, n, seed=0):
    """bench.py:77-83's scenario 0 at B = 1 in f64: (A (m, n, n), C = I, b
    from X0)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    A = rng.uniform(-1, 1, (1, 1, m, n, n))
    A = 0.5 * (A + np.swapaxes(A, 3, 4))
    X0 = rng.uniform(-1, 1, (1, 1, n, n))
    X0 = np.einsum("sbij,sbkj->sbik", X0, X0) + 0.1 * np.eye(n)
    b = np.einsum("sbvij,sbij->sv", A, X0)
    return A[0, 0], np.eye(n), b[0]


def sedumi_lmi_instance(m, nl, ns, seed=0):
    """tests/test_matlab_twin.py::_sedumi_instance at m variables, K.l = nl
    and K.s = [ns] (the test's is (3, 4, 5)): (A, b, c, K)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    N = nl + ns * ns
    A = np.zeros((m, N))
    A[:, :nl] = rng.uniform(-1, 1, (m, nl))
    for j in range(m):
        M = rng.uniform(-1, 1, (ns, ns))
        A[j, nl:] = (0.5 * (M + M.T)).ravel()
    x0 = np.zeros(N)
    x0[:nl] = rng.uniform(0.5, 1.5, nl)
    X = rng.uniform(-1, 1, (ns, ns))
    x0[nl:] = (X @ X.T / ns + 0.1 * np.eye(ns)).ravel()
    cvec = np.zeros(N)
    cvec[:nl] = rng.uniform(0.5, 1.5, nl)
    C = rng.uniform(-0.1, 0.1, (ns, ns))
    cvec[nl:] = (0.5 * (C + C.T) + np.eye(ns)).ravel()
    return A, A @ x0, cvec, {"l": nl, "s": [ns]}


def matlab_program(A, b, c, K):
    """conex_tpu_torch.m's build sequence for a SeDuMi instance with K.l and
    K.s blocks (its ConexTpuTorchProgram calls), as an abi_run program
    (m, ops, b, config): the l block as CONEX_AddDenseLinearConstraint of
    A(:, 1:K.l)', each s block as CONEX_AddDenseLMIConstraint of its
    symmetrized operator matrices, and the .m files' options block."""
    import numpy as np

    m = A.shape[0]
    ops, offset = [], 0
    if K.get("l", 0):
        nl = K["l"]
        ops.append(("linear", np.ascontiguousarray(A[:, :nl].T), c[:nl].copy()))
        offset = nl
    for n in K.get("s", []):
        cols = slice(offset, offset + n * n)
        blocks = A[:, cols].reshape(m, n, n)
        Cm = c[cols].reshape(n, n)
        ops.append(("dense_lmi", 0.5 * (blocks + blocks.transpose(0, 2, 1)),
                    0.5 * (Cm + Cm.T)))
        offset += n * n
    return m, ops, b, MATLAB_OPTIONS


def phase_abi(device):
    """5f: the C ABI, the MATLAB shim's sequence and the example on the
    card; returns K1's launches on their card runs."""
    import json
    import os
    import subprocess
    import tempfile
    from unittest import mock

    import numpy as np

    from conex_tpu_torch import SolverConfig, interfaces
    from conex_tpu_torch.cones import psd_schur
    from conex_tpu_torch.examples import performance_plots
    from conex_tpu_torch.interface import Conex
    from conex_tpu_torch.sedumi import solve_sedumi
    from conex_tpu_torch.solver import kkt
    from conex_tpu_torch.utils.profiling import counters

    def rel(got, want):
        return float(np.linalg.norm(got - want) / np.linalg.norm(want))

    start = time.perf_counter()
    dev = str(device)
    library = interfaces.build()
    host = interfaces.build_host()
    lib = interfaces.load()
    _, libpython, _ = interfaces.python_link()
    log(f"[5f C ABI] cc: {library.name} and {host.name} in "
        f"{time.perf_counter() - start:.2f} s, linked to {libpython}; stable copy "
        f"{interfaces.STABLE_LIBRARY}")

    k1 = 0
    defaults = abi_defaults(lib)
    for name, (m, ops, b, config) in abi_programs().items():
        counters["schur.calls"] = 0
        card = abi_run(lib, dev, m, ops, b, config)
        launches = counters["schur.calls"]
        k1 += launches
        prog, sol = conex_run(lambda m: Conex(m, device=dev), SolverConfig, defaults,
                              m, ops, b, config)
        cpu = abi_run(lib, "cpu", m, ops, b, config)
        duals = prog.GetDualVariables() if config.get("prepare_dual_variables") else []
        same = (np.array_equal(card["y"], sol.y)
                and card["mu"] == prog.GetIterationNumberStats(-1).mu
                and len(card["duals"]) == len(duals)
                and all(np.array_equal(x, np.ravel(p, order="F"))
                        for x, p in zip(card["duals"], duals)))
        e_cpu = rel(card["y"], cpu["y"])
        log(f"[5f C ABI] {name}: solved {card['solved']} in {card['iterations']} "
            f"iterations, K1 launches {launches}; y, duals and mu equal to the Python "
            f"Conex on the card: {same}; y relative |card - CPU| {e_cpu:.3e} (limit "
            f"{ABI_CPU_LIMIT})")
        if not (card["solved"] == 1 == cpu["solved"] and sol.status and same
                and e_cpu <= ABI_CPU_LIMIT):
            fail(f"5f: the C ABI's {name} program on the card")

    m, n = ABI_WIDTH
    A, C, b = bench_lmi(m, n)
    ops, config = [("dense_lmi", A, C)], dict(max_iterations=100, prepare_dual_variables=1)
    counters["schur.calls"] = 0
    t0 = time.perf_counter()
    with mock.patch.object(kkt, "factor", wraps=kkt.factor) as factor:
        card = abi_run(lib, dev, m, ops, b, config)
    wall = time.perf_counter() - t0
    launches, passes = counters["schur.calls"], factor.call_count
    k1 += launches
    cpu, up, down = (abi_run(lib, "cpu", m, ops, bb, config)
                     for bb in (b, np.nextafter(b, np.inf), np.nextafter(b, -np.inf)))
    X = card["duals"][0].reshape(n, n, order="F")
    e_dual = float(np.abs(np.einsum("vij,ij->v", A, X) - b).max() / np.abs(b).max())
    e_cpu = rel(card["y"], cpu["y"])
    e_moved = max(rel(up["y"], cpu["y"]), rel(down["y"], cpu["y"]))
    limit = max(ABI_WIDTH_CPU_LIMIT, e_moved)
    log(f"[5f C ABI] bench.py's scenario 0 (n={n}, m={m}, f64) through "
        f"CONEX_AddDenseLMIConstraint: solved {card['solved']} in {card['iterations']} "
        f"iterations, {wall:.3f} s; K1 launches {launches} in {passes} KKT factors; "
        f"max |<A_i, X> - b_i| / max |b| {e_dual:.3e} (limit {ABI_DUAL_LIMIT}); y "
        f"relative |card - CPU| {e_cpu:.3e}; the CPU alone under one rounding of b "
        f"either way: {e_moved:.3e} (limit the larger, {limit:.3e}, and "
        f"{ABI_WIDTH_CPU_LIMIT})")
    if not (card["solved"] == 1 == cpu["solved"] and launches == passes
            and launches >= card["iterations"] and e_dual <= ABI_DUAL_LIMIT
            and e_cpu <= limit):
        fail("5f: the full-width LMI through the C ABI")

    # K1 at this program's shape (S = 1, Bc = 1, m = 50, n = 100), f64.
    A1, W1, C1 = schur_inputs(1, 1, m, n, seed=3, device=device)
    err = rel_err(psd_schur.schur_kernel(A1, W1, C1), psd_schur.schur_plain(A1, W1, C1))
    ms = {"plain": [], "kernel": []}
    fns = {"plain": lambda: psd_schur.schur_plain(A1, W1, C1),
           "kernel": lambda: psd_schur.schur_kernel(A1, W1, C1)}
    for name in ("plain", "kernel", "kernel", "plain"):
        ms[name].append(time_ms(fns[name], 100))
    log(f"[5f C ABI] K1 at the program's shape (1, 1, {m}, {n}), f64: rel err vs plain "
        f"{err:.3e} (limit 1e-12); ms per call: kernel {ms['kernel']}, plain "
        f"{ms['plain']} (CUDA events, 100 calls each); bound "
        f"{schur_bound(1, 1, m, n, itemsize=8, tensor_cores=True)}")
    if not err <= 1e-12:
        fail("5f: K1 disagrees with its plain version at the program's shape")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "program.bin")
        np.concatenate([[m, n], colmajor(*A), colmajor(C), b]).tofile(path)
        for build in ("dense", "incremental"):
            t0 = time.perf_counter()
            proc = subprocess.run([str(host), path, build, dev], capture_output=True,
                                  text=True, env=interfaces.host_environment(), timeout=600)
            wall = time.perf_counter() - t0
            if proc.returncode != 0:
                fail(f"5f: abi_host ({build}) exited {proc.returncode}:\n"
                     f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
            out = json.loads(proc.stdout.strip().splitlines()[-1])
            e_host = rel(np.asarray(out["y"]), card["y"])
            log(f"[5f C ABI] abi_host ({build}, a C process with no interpreter at its "
                f"start): solved {out['solved']}, process {wall:.3f} s, of it create "
                f"{out['create_s']:.3f} s (interpreter, imports), build "
                f"{out['build_s']:.3f} s, solve {out['solve_s']:.3f} s; y relative to "
                f"the in-process y {e_host:.3e} (limit {ABI_HOST_LIMIT})")
            if not (out["solved"] == 1 and e_host <= ABI_HOST_LIMIT):
                fail(f"5f: abi_host ({build}) does not give the in-process y")

    A, b, c, K = sedumi_lmi_instance(*MATLAB_SHAPE)
    counters["schur.calls"] = 0
    card = abi_run(lib, dev, *matlab_program(A, b, c, K))
    launches = counters["schur.calls"]
    k1 += launches
    x = np.concatenate(card["duals"])
    x_ref, y_ref, info = solve_sedumi(A, b, c, K, device=dev)
    e_y = float(np.abs(card["y"] - y_ref).max())
    e_x = float(np.abs(x - x_ref).max())
    e_feas = float(np.abs(A @ x - b).max())
    log(f"[5f MATLAB] conex_tpu_torch.m's sequence at m={A.shape[0]}, K.l={K['l']}, "
        f"K.s={K['s']}: solved {card['solved']} in {card['iterations']} iterations, K1 "
        f"launches {launches}; against solve_sedumi on the card ({info['solved']}): "
        f"max |y - y_ref| {e_y:.3e}, max |x - x_ref| {e_x:.3e} (limit {MATLAB_LIMIT}); "
        f"max |A x - b| {e_feas:.3e} (limit {MATLAB_FEAS_LIMIT})")
    if not (card["solved"] == 1 and info["solved"] and e_y <= MATLAB_LIMIT
            and e_x <= MATLAB_LIMIT and e_feas <= MATLAB_FEAS_LIMIT):
        fail("5f: the MATLAB shim's sequence at width")

    walls = []

    def counted(fn):
        def run(*args, **kwargs):
            counters["schur.calls"] = 0
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            walls.append((time.perf_counter() - t0, counters["schur.calls"]))
            return out
        return run

    with tempfile.TemporaryDirectory() as tmp:
        with mock.patch.object(performance_plots, "mu_trajectory_hermitian",
                               counted(performance_plots.mu_trajectory_hermitian)), \
                mock.patch.object(performance_plots, "mu_trajectory_mixed",
                                  counted(performance_plots.mu_trajectory_mixed)):
            runs = performance_plots.main([tmp, "--device", dev])
        csvs = sorted(f for f in os.listdir(tmp) if f.endswith(".csv"))
    for (name, (mus, res)), (wall, launches) in zip(runs.items(), walls):
        k1 += launches
        log(f"[5f example] {name}: {res.num_iterations} iterations, final mu "
            f"{mus[-1]:.3e}, solved {res.solved}, {wall:.3f} s, K1 launches {launches}")
        if not res.solved or (launches > 0) != (name == "mixed"):
            fail(f"5f: the example's {name} program (solved, K1 on the mixed one only)")
    if not len(csvs) == len(runs) == 5:
        fail(f"5f: the example wrote {csvs}")
    log(f"[5f C ABI] phase {time.perf_counter() - start:.1f} s, the build included "
        f"(budget {ABI_PHASE_BUDGET:.0f} s)")
    return k1


# ---------------------------------------------------------------------------
# The Schur-phase probes (kernels K3-K6)
# ---------------------------------------------------------------------------


def nonsymmetric_inputs(B, m, n, seed, device):
    """A, W and C uniform on [-1, 1], float32, made on the card from a
    seed: no symmetry anywhere."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.rand(*shape, generator=g, device=device) * 2 - 1
                 for shape in ((B, m, n, n), (B, n, n), (B, n, n)))


def a_plan_record(plan, itemsize):
    """What a K3/K6 call runs under: K1's plan at S = 1, Bc = B, with its
    scratch (the panels of a chunk and the partials) in bytes."""
    import math

    return dict(cones_per_chunk=plan.cones_per_chunk, chunks=plan.chunks,
                depth_chunks=plan.depth_chunks, launches=plan.launches,
                scratch_bytes=itemsize * (math.prod(plan.scratch_shape)
                                          + math.prod(plan.partial_shape)))


def probe_variants():
    """{variant: (its plain version, its kernel wrapper)} of PROBES."""
    import importlib

    out = {}
    for name, module, _, _ in PROBES:
        mod = importlib.import_module(f"conex_tpu_torch.benchmarks.{module}")
        out[name] = (getattr(mod, f"{name}_plain"), getattr(mod, f"{name}_kernel"))
    return out


def phase_probe_kernels(device):
    """Returns each probe kernel's record: max |kernel - plain| in f32 at
    the probe shape, and the CUDA-event times of both there."""
    import torch

    from conex_tpu_torch.benchmarks import dev_pallas_probe
    from conex_tpu_torch.cones import psd_schur

    variants = probe_variants()
    records = {name: {} for name in variants}
    B, m, n = PROBE_SHAPE
    for name in AT_LAYOUT:
        plan = dev_pallas_probe.probe_at_plan(B, m, n, 4)
        records[name]["plan"] = dict(route=plan.route, cones_per_chunk=plan.cones_per_chunk,
                                     operators_per_block=plan.operators_per_block,
                                     depth_chunks=plan.depth_chunks,
                                     slabs_per_chunk=plan.slabs_per_chunk,
                                     shared_bytes=plan.shared_bytes,
                                     scratch_bytes=plan.scratch_bytes)
        log(f"[3c probe kernels] {name} probe shape f32 plan: {plan.describe()}; "
            f"design traffic, counted from the plan, "
            f"{plan.traffic_bytes() / 1e9:.4f} GB, "
            f"{1e3 * plan.traffic_bytes() / HBM_BYTES_PER_S:.4f} ms at 3.35 TB/s")
    for name in variants:
        if name not in AT_LAYOUT:
            records[name]["plan"] = a_plan_record(
                dev_pallas_probe.probe_a_plan(B, m, n, 4), 4)
            log(f"[3c probe kernels] {name} probe shape f32 plan (K1's, S=1, "
                f"Bc={B}): {records[name]['plan']}")
    # m + 1 = 71 at the second shape: two 64-row tiles of the Gram matrix.
    # Nonsymmetric inputs tell K4/K5's function from the oracle's, and hold
    # every f32 fragment path to a transposed read or store: with symmetric
    # A, W and C, M_v, N and W are symmetric too.  The symmetric probe shape
    # comes last: K1's check and the times below use its inputs.
    for label, shape in (("small", (3, 5, 13)), ("two tiles", (2, 70, 130)),
                         ("nonsymmetric small", (3, 5, 13)),
                         ("nonsymmetric two tiles", (2, 70, 130)),
                         ("nonsymmetric probe", PROBE_SHAPE),
                         ("probe", PROBE_SHAPE)):
        nonsymmetric = label.startswith("nonsymmetric")
        if nonsymmetric:
            A, w, C = nonsymmetric_inputs(*shape, seed=7, device=device)
        else:
            A, w, C = dev_pallas_probe.probe_inputs(*shape, device)
        A64, w64, C64 = (x.double() for x in (A, w, C))
        oracle = dev_pallas_probe.einsum_schur(A64, w64, C64)
        for name, (plain, kernel) in variants.items():
            want64 = plain(A64, w64, C64)
            got64 = kernel(A64, w64, C64)
            torch.cuda.synchronize()
            e64 = rel_err(got64, want64)
            msg = (f"[3c probe kernels] {name} {label} B,m,n={shape}: f64 rel err {e64:.3e} "
                   f"(limit 1e-12); G's distance from einsum_schur "
                   f"{rel_err(got64[:1], oracle[:1]):.3e}")
            if not e64 <= 1e-12:
                fail(f"{name}: f64 kernel disagrees with its plain version at {label}: {e64}")
            if nonsymmetric or label == "probe":
                got32, plain32 = kernel(A, w, C), plain(A, w, C)
                again = kernel(A, w, C)
                torch.cuda.synchronize()
                e32 = rel_err(got32, want64)
                same = all(torch.equal(g, a) for g, a in zip(got32, again))
                max_abs = max(float((g - p).abs().max()) for g, p in zip(got32, plain32))
                msg += (f"; f32 rel err vs f64 plain {e32:.3e} (limit 1e-4; plain f32 "
                        f"{rel_err(plain32, want64):.3e}); f32 max |kernel - plain| "
                        f"{max_abs:.3e}; two f32 calls give the same bits: {same}")
                if not e32 <= 1e-4:
                    fail(f"{name}: f32 kernel disagrees with the f64 plain version "
                         f"at {label}: {e32}")
                if not same:
                    fail(f"{name}: two f32 calls at {label} differ")
                if label == "probe":
                    records[name]["max_abs_err"] = max_abs
                del got32, plain32, again
            log(msg)
        del oracle
    del got64

    # K1 on the same inputs, as one program of B cones (S = 1, Bc = B).
    def as_one_program(A, w, C):
        return A.view(1, B, m, n, n), w.view(1, B, n, n), C.view(1, B, n, n)

    k1_args = as_one_program(A, w, C)
    e64 = rel_err([x[0] for x in psd_schur.schur_kernel(
        *as_one_program(A64, w64, C64))], want64)
    got32, again = (psd_schur.schur_kernel(*k1_args) for _ in range(2))
    torch.cuda.synchronize()
    e32 = rel_err([x[0] for x in got32], want64)
    same = all(torch.equal(g, a) for g, a in zip(got32, again))
    log(f"[3c probe kernels] K1 at S=1, Bc={B}: f64 rel err {e64:.3e} (limit "
        f"1e-12); f32 rel err vs f64 oracle {e32:.3e} (limit 1e-4); two f32 "
        f"calls give the same bits: {same}")
    if not (e64 <= 1e-12 and e32 <= 1e-4 and same):
        fail(f"K1 at S=1 disagrees with the f64 oracle or with itself: "
             f"{e64}, {e32}, same bits {same}")
    del got32, again
    del A64, w64, C64, want64

    # CUDA-event times at the probe shape in f32, each kernel and its plain
    # version in turns (plain, kernel, kernel, plain), 10 calls each.
    for name, (plain, kernel) in variants.items():
        ms = {"plain": [], "kernel": []}
        fns = {"plain": lambda: plain(A, w, C), "kernel": lambda: kernel(A, w, C)}
        for which in ("plain", "kernel", "kernel", "plain"):
            ms[which].append(time_ms(fns[which], 10))
        log(f"[3c probe kernels] {name} probe shape f32 ms per call: kernel "
            f"{ms['kernel']}, plain {ms['plain']} (CUDA events, 10 calls each)")
        records[name].update(ms=min(ms["kernel"]), plain_ms=min(ms["plain"]),
                             **schur_bound(B, 1, m, n, tensor_cores=True,
                                           at_layout=name in AT_LAYOUT))
    ms = {"einsum_schur": [], "K1": []}
    fns = {"einsum_schur": lambda: dev_pallas_probe.einsum_schur(A, w, C),
           "K1": lambda: psd_schur.schur_kernel(*k1_args)}
    for which in ("einsum_schur", "K1", "K1", "einsum_schur"):
        ms[which].append(time_ms(fns[which], 10))
    log(f"[3c probe kernels] probe shape f32 ms per call: einsum_schur "
        f"{ms['einsum_schur']}, K1 at S=1, Bc={B} {ms['K1']} (CUDA events, 10 "
        f"calls each); K1's bound {schur_bound(B, 1, m, n, tensor_cores=True)}")
    return records


def sparse_chain(N, nc, seed=0, dtype="float32"):
    """benchmarks/bench_sparse.py:35-50's chain_program at one instance:
    N LMI cliques of order nc, clique i over the 6-variable window from 3i
    (overlap 3); (A (N, 1, 6, nc, nc), b, number of variables)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    B, w = 1, 6
    n_vars = 3 * N + w - 3
    A = rng.uniform(-1, 1, (N, B, w, nc, nc)).astype(dtype)
    A = 0.5 * (A + np.swapaxes(A, 3, 4))
    X0 = rng.uniform(-1, 1, (N, B, nc, nc)).astype(dtype)
    X0 = (np.einsum("sbij,sbkj->sbik", X0, X0) / nc
          + 0.1 * np.eye(nc, dtype=dtype))
    b = np.zeros((B, n_vars), dtype)
    for i in range(N):
        b[:, 3 * i:3 * i + w] += np.einsum("bvij,bij->bv", A[i], X0[i])
    return A, b[0], n_vars


def sparse_chain_program(A, n_vars, device, dtype):
    import numpy as np

    from conex_tpu_torch import Program

    N, _, w, nc, _ = A.shape
    prog = Program(n_vars, dtype=dtype, device=device)
    for i in range(N):
        prog.add_lmi_constraint(A[i], np.eye(nc)[None],
                                variables=list(range(3 * i, 3 * i + w)))
    return prog


def sparse_config(iterations=SPARSE_ITERATIONS):
    """benchmarks/bench_sparse.py:79-83."""
    from conex_tpu_torch import SolverConfig

    return SolverConfig(max_iterations=iterations, final_centering_steps=0,
                        inv_sqrt_mu_max=1e15, fixed_iterations=True,
                        inv_sqrt_mu_cap_scaled=100.0)


class clique_threshold:
    """Program's structure switch, set on the module as bench_sparse.py
    does: the compressed structure at any clique count, or never."""

    def __init__(self, structure):
        self.value = 0 if structure == "compressed" else 10 ** 9

    def __enter__(self):
        from conex_tpu_torch import program

        self.saved, program.SCAN_CLIQUE_THRESHOLD = (program.SCAN_CLIQUE_THRESHOLD,
                                                     self.value)

    def __exit__(self, *exc):
        from conex_tpu_torch import program

        program.SCAN_CLIQUE_THRESHOLD = self.saved


def chain_lp(seed, n_blocks, with_equality, device):
    """tests/test_compressed.py:157-231's chain LP: 3 rows per block over
    variables (i, i + 1), with 2 equality rows over variables 0-2 or
    none; (the sparse Program, the dense one, b)."""
    import numpy as np

    from conex_tpu_torch import Program

    rng = np.random.default_rng(seed)
    num_vars, rows = n_blocks + 1, 3
    Af = np.zeros((rows * n_blocks, num_vars))
    cf = np.zeros(rows * n_blocks)
    sparse = Program(num_vars, device=device)
    for i in range(n_blocks):
        Ai = rng.uniform(-1, 1, (rows, 2))
        ci = np.abs(rng.uniform(-1, 1, rows)) + 0.1
        sparse.add_linear_constraint(Ai, ci, variables=[i, i + 1])
        Af[rows * i:rows * (i + 1), i:i + 2] = Ai
        cf[rows * i:rows * (i + 1)] = ci
    dense = Program(num_vars, device=device)
    dense.add_linear_constraint(Af, cf)
    Aeq = rng.uniform(-1, 1, (2, 3)) if with_equality else None
    x0 = np.abs(rng.uniform(-1, 1, rows * n_blocks))
    x0 *= 0.1 / np.linalg.norm(x0)
    b = Af.T @ x0
    if with_equality:
        for prog in (sparse, dense):
            prog.add_equality_constraint(Aeq, Aeq @ b[:3], variables=[0, 1, 2])
    return sparse, dense, b


def mpc_program(device):
    """tests/test_failure_corpus.py:268's T = 3 MPC chain (every block on
    a variable subset), its b and its configuration."""
    import numpy as np

    from conex_tpu_torch import KKT_SOLVER_LDLT, Program, SolverConfig

    rng = np.random.default_rng(5)
    T, nu, nx = 3, 1, 2
    Ai = rng.uniform(-1, 1, (nx, nx))
    Bi = rng.uniform(-1, 1, (nx, nu))
    f = rng.uniform(-1, 1, nx)
    Hxu = rng.uniform(-1, 1, (2, nu))
    gxu = rng.uniform(-1, 1, 2)

    def input_vars(i):
        return list(range(T * nx + i * nu, T * nx + (i + 1) * nu))

    def state_vars(i):
        return list(range((i - 1) * nx, i * nx))

    prog = Program(T * (nu + nx + 2), device=device)
    epigraph = T * (nu + nx)
    for i in range(T):
        stage = (state_vars(i) if i > 0 else []) + input_vars(i) + state_vars(i + 1)
        D = np.hstack([Ai, Bi, -np.eye(nx)] if i > 0 else [Bi, -np.eye(nx)])
        prog.add_equality_constraint(D, f, variables=stage)
        if 0 < i < T - 1:
            prog.add_linear_constraint(Hxu, gxu, variables=input_vars(i))
        prog.add_quadratic_cost_epigraph(np.eye(nu), input_vars(i), epigraph)
        prog.add_quadratic_cost_epigraph(np.eye(nx), state_vars(i + 1), epigraph + 1)
        epigraph += 2
    config = SolverConfig(
        prepare_dual_variables=True, inv_sqrt_mu_max=100.0,
        final_centering_tolerance=1.0, infeasibility_threshold=2e6,
        final_centering_steps=5, kkt_solver=KKT_SOLVER_LDLT,
        iterative_refinement_iterations=2, max_iterations=60)
    return prog, -np.ones(T * (nu + nx + 2)), config


def sparse_conex(device):
    """tests/test_interface.py:53's sparse instance through Conex."""
    import numpy as np

    from conex_tpu_torch.interface import Conex

    rng = np.random.default_rng(1)
    n = 4

    def randsym():
        M = rng.normal(size=(n, n))
        return 0.5 * (M + M.T)

    prog = Conex(3, device=device)
    prog.AddSparseLinearMatrixInequality(np.stack([randsym(), randsym()]), np.eye(n),
                                         np.arange(0, 2))
    prog.AddSparseLinearMatrixInequality(np.stack([randsym(), randsym()]), np.eye(n),
                                         np.arange(1, 3))
    return prog.Maximize(np.ones(3))


def phase_sparse_known_answers(device):
    """4g, first half: the JAX package's sparse tests on the card against
    the CPU, the f64 LMI chain on both structures, and the compressed
    factor's determinism."""
    import numpy as np
    import torch

    from unittest import mock

    from conex_tpu_torch import native
    from conex_tpu_torch.algebra import sym
    from conex_tpu_torch.solver import kkt
    from conex_tpu_torch.solver.loop import assemble
    from conex_tpu_torch.supernodal import compressed

    t0 = time.perf_counter()
    route = ("native: g++ built native/clique_ordering.cc into "
             f"{native.library_path().name}" if native.available()
             else "Python: no g++, so the Python version of the same algorithm")
    log(f"[4g sparse] clique ordering {route} ({time.perf_counter() - t0:.2f} s)")
    for seed, n_blocks, eq in ((6, 32, False), (7, 28, True)):
        label = f"chain LP, {n_blocks} blocks{', 2 equality rows (LDLT)' if eq else ''}"
        sparse, dense, b = chain_lp(seed, n_blocks, eq, device)
        structure = type(sparse._kkt_structure()).__name__
        route = "native" if native.available() else "Python"
        rs, rd = sparse.solve(b), dense.solve(b)
        cpu, _, _ = chain_lp(seed, n_blocks, eq, "cpu")
        rc = cpu.solve(b)
        d_dense = float(np.abs(rs.y - rd.y).max())
        d_cpu = float(np.abs(rs.y - rc.y).max() / np.abs(rc.y).max())
        log(f"[4g sparse] {label}: {structure} ({route} ordering), sparse / dense / CPU "
            f"solved {rs.solved} / {rd.solved} / {rc.solved} in {rs.num_iterations} / "
            f"{rd.num_iterations} / {rc.num_iterations} iterations; max |y sparse - y "
            f"dense| {d_dense:.3e} (limit {SPARSE_DENSE_LIMIT}), y card vs CPU "
            f"{d_cpu:.3e} of its largest entry (limit {SPARSE_CPU_LIMIT})")
        if structure != "CompressedSupernodalStructure":
            fail(f"4g: the {label} is not on the compressed structure")
        if not (rs.solved and rd.solved and rc.solved
                and rs.num_iterations == rc.num_iterations
                and d_dense <= SPARSE_DENSE_LIMIT and d_cpu <= SPARSE_CPU_LIMIT):
            fail(f"4g: the {label} disagrees")

    sol, cpu = sparse_conex(device), sparse_conex("cpu")
    d = float(np.abs(sol.y - cpu.y).max())
    log(f"[4g sparse] Conex sparse instance: status {sol.status} (CPU {cpu.status}), "
        f"max |y card - y CPU| {d:.3e} (limit 1e-6)")
    if not (sol.status and cpu.status and d <= 1e-6):
        fail("4g: the sparse Conex instance")

    prog, b, config = mpc_program(device)
    res = prog.solve(b, config)
    cres = mpc_program("cpu")[0].solve(b, config)
    log(f"[4g sparse] MPC failure case ({type(prog._kkt_structure()).__name__}, LDLT): "
        f"y finite {bool(np.isfinite(res.y).all())}, solved {res.solved} (CPU "
        f"{cres.solved}) in {res.num_iterations} iterations (CPU {cres.num_iterations})")
    if not (np.isfinite(res.y).all() and res.solved == cres.solved):
        fail("4g: the MPC failure case is not finite or disagrees with the CPU")

    N, nc = SPARSE_SMALL
    A, b, n_vars = sparse_chain(N, nc, seed=1, dtype="float64")
    config = sparse_config()
    warm = sym.extreme_eigenvalues_warm

    def seeds_rounded_once(*args, **kwargs):
        # One more float32 rounding of the sweep's eigenvector seeds.
        lo, hi, seeds, lam = warm(*args, **kwargs)
        return lo, hi, tuple(x * (1 + 2.0 ** -23) for x in seeds), lam

    def diffs(x, y):
        return (float(np.max(np.abs(x.stats_inv_sqrt_mu - y.stats_inv_sqrt_mu)
                             / np.abs(y.stats_inv_sqrt_mu))),
                float(np.abs(x.y - y.y).max() / np.abs(y.y).max()))

    for structure in ("unrolled", "compressed"):
        with clique_threshold(structure):
            g, c, c1 = (sparse_chain_program(A, n_vars, dev, torch.float64).solve(bb, config)
                        for dev, bb in ((device, b), ("cpu", b),
                                        ("cpu", np.nextafter(b, np.inf))))
            with mock.patch.object(sym, "extreme_eigenvalues_warm", seeds_rounded_once):
                c2 = sparse_chain_program(A, n_vars, "cpu", torch.float64).solve(b, config)
        dk, dy = diffs(g, c)
        bk, by = diffs(c1, c)
        sk, sy = diffs(c2, c)
        log(f"[4g sparse] f64 LMI chain (N={N}, nc={nc}) on the {structure} structure: "
            f"card vs CPU stats_k {dk:.3e} (limit {SPARSE_K_LIMIT}), y {dy:.3e} (limit "
            f"{SPARSE_Y_LIMIT}); the CPU alone under one rounding of b: stats_k "
            f"{bk:.3e}, y {by:.3e}; of the f32 warm seeds: stats_k {sk:.3e}, y {sy:.3e}")
        if not (g.num_iterations == c.num_iterations == SPARSE_ITERATIONS
                and not g._raw.fail and dk <= SPARSE_K_LIMIT and dy <= SPARSE_Y_LIMIT):
            fail(f"4g: the f64 LMI chain on the {structure} structure disagrees")

    N, nc, _ = SPARSE_RUNS[0]
    A, _, n_vars = sparse_chain(N, nc)
    with clique_threshold("compressed"):
        prog = sparse_chain_program(A, n_vars, device, torch.float32)
        structure = prog._kkt_structure()
    ws = tuple(blk.identity_state(torch.float32) for blk in prog._blocks)
    buf = assemble(tuple(prog._blocks), (), ws, n_vars, n_vars, torch.float32,
                   structure)[0]
    same = True
    for mode in (kkt.KKT_SOLVER_LLT, kkt.KKT_SOLVER_LDLT):
        fn = compressed.factor_llt if mode == kkt.KKT_SOLVER_LLT else compressed.factor_ldlt
        one, two = fn(buf, structure), fn(buf, structure)
        same &= all(torch.equal(x, y) for x, y in zip(one[0] + (one[1],),
                                                         two[0] + (two[1],)))
    log(f"[4g sparse] two compressed factors (LLT and LDLT) of one buffer (N={N}, "
        f"{structure.buf_size} entries) give the same bits: {same}")
    if not same:
        fail("4g: the compressed factor is not deterministic")


def phase_sparse(device):
    """4g: the supernodal KKT path on the card.  Returns K1's launches in
    the bench_sparse workload's solves."""
    import torch

    from conex_tpu_torch.cones import psd_schur
    from conex_tpu_torch.solver import kkt
    from conex_tpu_torch.solver.loop import assemble
    from conex_tpu_torch import native
    from conex_tpu_torch.utils.profiling import counters

    start = time.perf_counter()
    phase_sparse_known_answers(device)
    log(f"[4g sparse] known answers {time.perf_counter() - start:.1f} s")
    config = sparse_config()
    short = sparse_config(SPARSE_PROFILE_ITERATIONS)
    k1_total = 0
    for N, nc, structure in SPARSE_RUNS:
        t0 = time.perf_counter()
        A, b, n_vars = sparse_chain(N, nc)
        with clique_threshold(structure):
            prog = sparse_chain_program(A, n_vars, device, torch.float32)
            kkt_structure = prog._kkt_structure()
            route = "native" if native.available() else "Python"
            label = (f"N={N}, nc={nc}, {structure} ({len(kkt_structure.blocks)} "
                     f"cliques, n={n_vars}, {route} ordering)")
            if (type(kkt_structure).__name__ == "CompressedSupernodalStructure") != (
                    structure == "compressed"):
                fail(f"4g: {label} picked {type(kkt_structure).__name__}")
            build_s = time.perf_counter() - t0
            wall_short = best_wall(lambda: prog.solve(b, short), reps=1)
            counters["schur.calls"] = 0
            counters["socp.calls"] = 0
            t0 = time.perf_counter()
            res = prog.solve(b, config)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            k1 = counters["schur.calls"]
            k1_total += k1
            if (res.num_iterations != SPARSE_ITERATIONS or bool(res._raw.fail)
                    or counters["socp.calls"]):
                fail(f"4g: {label}: {res.num_iterations} iterations, fail "
                     f"{bool(res._raw.fail)}, K2 launches "
                     f"{counters['socp.calls']}")
            if k1 != N * SPARSE_ITERATIONS:
                fail(f"4g: {label}: K1 launched {k1} times, not once per clique per "
                     f"iteration ({N * SPARSE_ITERATIONS})")
            device_ms, launches, top = device_profile(lambda: prog.solve(b, short))
            ws = tuple(blk.identity_state(torch.float32) for blk in prog._blocks)
            G = assemble(tuple(prog._blocks), (), ws, n_vars, n_vars, torch.float32,
                         kkt_structure)[0]
            factor_ms, factor_launches, _ = device_profile(
                lambda: kkt.factor(G, kkt.KKT_SOLVER_LLT, kkt_structure))
        log(f"[4g sparse] {label}: built in {build_s:.2f} s; 30 iterations, fail False; "
            f"wall {wall:.3f} s, {SPARSE_ITERATIONS / wall:.2f} Newton it/s, "
            f"{wall / SPARSE_ITERATIONS:.4f} s per iteration; K1 launches {k1} "
            f"({k1 // SPARSE_ITERATIONS} per iteration)")
        log(f"[4g sparse] {label}: one profiled solve of {SPARSE_PROFILE_ITERATIONS} "
            f"iterations: {launches} launches ({launches / SPARSE_PROFILE_ITERATIONS:.1f} "
            f"per iteration), device-kernel time {device_ms:.3f} ms, busy "
            f"{100 * device_ms / (wall_short * 1e3):.1f}% of its unprofiled wall "
            f"{wall_short:.3f} s; one KKT factor: {factor_launches} launches, "
            f"{factor_ms:.3f} ms of device time")
        for ms, count, key in top[:4]:
            log(f"[4g sparse]   {ms:9.3f} ms x{count:<6} {key[:90]}")

    # K1 at the chain's shape (S = 1, Bc = 1, m = 6, n = 8), f32.
    A, W, C = (x.float() for x in schur_inputs(1, 1, 6, 8, seed=2, device=device))
    got = psd_schur.schur_kernel(A, W, C)
    plain = psd_schur.schur_plain(A, W, C)
    oracle = psd_schur.schur_plain(*(x.double() for x in (A, W, C)))
    err = rel_err(got, oracle)
    ms = {"plain": [], "kernel": []}
    fns = {"plain": lambda: psd_schur.schur_plain(A, W, C),
           "kernel": lambda: psd_schur.schur_kernel(A, W, C)}
    for name in ("plain", "kernel", "kernel", "plain"):
        ms[name].append(time_ms(fns[name], 100))
    log(f"[4g sparse] K1 at the chain's shape (1, 1, 6, 8), f32: rel err vs the f64 "
        f"oracle {err:.3e} (limit 1e-4), max |kernel - plain| "
        f"{max(float((g - p).abs().max()) for g, p in zip(got, plain)):.3e}; ms per "
        f"call: kernel {ms['kernel']}, plain {ms['plain']} (CUDA events, 100 calls "
        f"each); bound {schur_bound(1, 1, 6, 8, tensor_cores=True)}")
    if not err <= 1e-4:
        fail("4g: K1 disagrees with the f64 oracle at the chain's shape")
    log(f"[4g sparse] phase {time.perf_counter() - start:.1f} s")
    return k1_total


# ---------------------------------------------------------------------------
# 4h: multi-device execution (parallel/sharded.py) on one card
# ---------------------------------------------------------------------------

SHARDED_SHAPE = (256, 50, 100)  # B cones, m, n: dev_pallas_probe.py:207-217
SHARDED_ITERATIONS = 30
SHARDED_RANKS = (2, 4)  # gloo ranks spawned on the one card
# y against the unsharded solve, relative: one NCCL rank gives the same bits;
# gloo's sums in another order moved f32 y by 4.1e-7 and 4.8e-7 at tp = 2
# and 4 on an H100.
SHARDED_Y_LIMIT = 1e-5
# tests/test_distributed.py:149-211's sparse SOC chain at 40 cliques, B = 4,
# f64: the distributed solves against the unsharded supernodal one (the JAX
# test's own bound), and the unsharded one on the card against the CPU.
SHARDED_CHAIN = (40, 4, 3)  # blocks (cliques), cones per block, cone dim
SHARDED_CHAIN_ITERATIONS = 40
SHARDED_CHAIN_LIMIT = 1e-8
SHARDED_GRID = (2, 4, 5, 3)  # S, B, n, m: tests/test_parallel.py's 2D case
SHARDED_GRID_ITERATIONS = 25
SHARDED_GRID_LIMIT = 1e-9  # y against the per-scenario solves (JAX's bound)
SHARDED_PROFILE_ITERATIONS = 2  # the profiled solve of each run
PHASE_TIMINGS_SHAPE = (50, 100)  # m, n of 4h-d's LMI program
RANK_TIMEOUT = 300.0


def sharded_lmi(device):
    """4h-a's program: SHARDED_SHAPE's B LMI cones in f32, built feasible as
    benchmarks/weak_scaling.py:41-50 does (C = I, b from a PSD X0), made on
    the card from a seed, so that every process on it makes the same one;
    with the bench's fixed-iteration configuration (bench_config)."""
    import torch

    from conex_tpu_torch import DenseLMICone
    from conex_tpu_torch.cones.psd import make_psd_state

    B, m, n = SHARDED_SHAPE
    g = torch.Generator(device=device).manual_seed(0)
    kw = dict(dtype=torch.float32, device=device)
    A = torch.rand(B, m, n, n, generator=g, **kw) * 2 - 1
    A = 0.5 * (A + A.transpose(-2, -1))
    X0 = torch.rand(B, n, n, generator=g, **kw) * 2 - 1
    eye = torch.eye(n, **kw)
    X0 = X0 @ X0.transpose(-2, -1) + 0.1 * eye
    b = torch.einsum("bvij,bij->v", A, X0)
    C = eye.expand(B, n, n).contiguous()
    scalars = dict(k=torch.zeros((), **kw), b_scaling=torch.ones((), **kw),
                   c_scaling=torch.ones((), **kw))
    config = bench_config(SHARDED_ITERATIONS)
    return (DenseLMICone(A=A, C=C),), b, (make_psd_state(C.clone()),), scalars, config


def soc_chain_blocks(device):
    """4h-b's program: tests/test_distributed.py:149-211's sparse SOC chain
    (block i: B Lorentz cones of dimension dim + 1 on the variables
    {i, i+1, i+2}, a feasible objective) at SHARDED_CHAIN, f64, seed 7;
    (blocks, init ws, b, cliques), one program without the scenario axis."""
    import numpy as np
    import torch

    from conex_tpu_torch import SOCCone

    n_blocks, B, dim = SHARDED_CHAIN
    rng = np.random.default_rng(7)
    blocks, ws, cliques = [], [], []
    b = np.zeros(n_blocks + 2)
    for i in range(n_blocks):
        vars_ = (i, i + 1, i + 2)
        A = rng.uniform(-1, 1, (B, dim + 1, len(vars_)))
        x0 = np.concatenate([np.full((B, 1), 2.0),
                             rng.uniform(-0.5, 0.5, (B, dim))], axis=1)
        blocks.append(SOCCone(A=torch.tensor(A, device=device),
                              c=torch.tensor(x0, device=device), vars_=vars_))
        e = torch.zeros((B, dim + 1), dtype=torch.float64, device=device)
        e[:, 0] = 1.0
        ws.append(e)
        cliques.append(list(vars_))
        b[list(vars_)] += 0.5 * A[:, 0, :].sum(axis=0)
    return tuple(blocks), tuple(ws), torch.tensor(b, device=device), cliques


def grid_lmi(device):
    """4h-c's scenarios: tests/test_parallel.py's 2D case (seed 2) at
    SHARDED_GRID, f64: (A (S, B, m, n, n), C (S, B, n, n), b (S, m))."""
    import numpy as np
    import torch

    S, B, n, m = SHARDED_GRID
    rng = np.random.default_rng(2)
    As, Cs, bs = [], [], []
    for _ in range(S):
        A = rng.uniform(-1, 1, (B, m, n, n))
        A = 0.5 * (A + np.swapaxes(A, 2, 3))
        X0 = rng.uniform(-1, 1, (B, n, n))
        X0 = np.einsum("bij,bkj->bik", X0, X0) + 0.1 * np.eye(n)
        As.append(A)
        Cs.append(np.broadcast_to(np.eye(n), (B, n, n)).copy())
        bs.append(np.einsum("bvij,bij->v", A, X0))
    return tuple(torch.tensor(np.stack(x), device=device) for x in (As, Cs, bs))


def collective_profile(fn):
    """One call of ``fn`` under torch.profiler: (kernel launch calls,
    device-kernel ms, all-reduce count, their host ms, the device ms of
    NCCL kernels).  The all-reduces are the port's ALL_REDUCE_SPAN spans
    (parallel/collectives.py): each covers one blocking all-reduce."""
    import json
    import os
    import tempfile

    import torch

    from conex_tpu_torch.parallel.collectives import ALL_REDUCE_SPAN

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    launches, device_ms, spans, span_ms, nccl_ms = 0, 0.0, 0, 0.0, 0.0
    for e in events:
        cat, name, ms = e.get("cat"), e.get("name", ""), e.get("dur", 0.0) / 1e3
        if cat in DEVICE_EVENTS:
            device_ms += ms
            if "nccl" in name.lower():
                nccl_ms += ms
        elif cat in ("cuda_runtime", "cuda_driver") and name in LAUNCH_CALLS:
            launches += 1
        elif cat == "user_annotation" and name == ALL_REDUCE_SPAN:
            spans += 1
            span_ms += ms
    return launches, device_ms, spans, span_ms, nccl_ms


def sharded_record(label, run, config, reps):
    """Drive ``run(config)`` (a solve that ends in a synchronize) once with
    K1's count set to 0, time ``reps`` more runs (none: the first run's
    wall), and profile a solve of SHARDED_PROFILE_ITERATIONS iterations;
    the record of this rank, its profile per iteration."""
    from conex_tpu_torch.utils.profiling import counters

    counters["schur.calls"] = 0
    t0 = time.perf_counter()
    res = run(config)
    first = time.perf_counter() - t0
    k1 = counters["schur.calls"]
    wall = best_wall(lambda: run(config), reps) if reps else first
    its = SHARDED_PROFILE_ITERATIONS
    launches, device_ms, spans, span_ms, nccl_ms = collective_profile(
        lambda: run(config.replace(max_iterations=its)))
    return dict(label=label, y=res.y.cpu(), iterations=int(res.num_iterations.max()),
                fail=bool(res.fail.any()), solved=res.solved.cpu(), k1=k1,
                first=first, wall=wall, launches=launches / its,
                device_ms=device_ms / its, spans=spans / its, span_ms=span_ms / its,
                nccl_ms=nccl_ms / its)


def sharded_cone_run(mesh, device):
    """4h-a in this rank: the program cone-sharded over the mesh's "tp"."""
    import torch

    from conex_tpu_torch.parallel.sharded import solve_cone_sharded

    blocks, b, ws, scalars, config = sharded_lmi(device)

    def run(config):
        res = solve_cone_sharded(blocks, (), b, ws, scalars, config, mesh)
        torch.cuda.synchronize()
        return res

    return sharded_record(f"tp={mesh.size()}", run, config, reps=1)


def sharded_chain_runs(mesh, device):
    """4h-b in this rank: the SOC chain on both distributed structures."""
    import torch

    from conex_tpu_torch import SolverConfig
    from conex_tpu_torch.parallel.sharded import solve_cone_sharded
    from conex_tpu_torch.supernodal.dist_compressed import DistributedCompressedStructure
    from conex_tpu_torch.supernodal.distributed import DistributedSupernodalStructure

    blocks, ws, b, cliques = soc_chain_blocks(device)
    scalars = dict(k=torch.zeros((), dtype=torch.float64, device=device),
                   b_scaling=torch.ones((), dtype=torch.float64, device=device),
                   c_scaling=torch.ones((), dtype=torch.float64, device=device))
    config = SolverConfig(max_iterations=SHARDED_CHAIN_ITERATIONS)
    out = {}
    for kind in (DistributedSupernodalStructure, DistributedCompressedStructure):
        structure = kind.from_cliques(cliques, len(b), mesh.size())

        def run(config):
            res = solve_cone_sharded(blocks, (), b, ws, scalars, config, mesh,
                                     kkt_structure=structure)
            torch.cuda.synchronize()
            return res

        out[kind.__name__] = sharded_record(kind.__name__, run, config, reps=0)
    return out


def sharded_grid_run(mesh, device):
    """4h-c in this rank: the scenarios x cones solve on the (2, 2) mesh."""
    import torch

    from conex_tpu_torch import DenseLMICone, SolverConfig
    from conex_tpu_torch.cones.psd import make_psd_state
    from conex_tpu_torch.parallel.sharded import solve_scenarios_cone_sharded

    A, C, b = grid_lmi(device)
    S, B, n, m = SHARDED_GRID
    scalars = dict(k=torch.zeros((S,), dtype=torch.float64, device=device),
                   b_scaling=torch.ones((S,), dtype=torch.float64, device=device),
                   c_scaling=torch.ones((S,), dtype=torch.float64, device=device))

    def run(config):
        res = solve_scenarios_cone_sharded(
            (DenseLMICone(A=A, C=C),), (), b, (make_psd_state(C.clone()),), scalars,
            config, mesh, total_rank=B * n)
        torch.cuda.synchronize()
        return res

    return sharded_record("dp=2 x tp=2", run,
                          SolverConfig(max_iterations=SHARDED_GRID_ITERATIONS), reps=0)


def sharded_rank(rank, world):
    """The work of one gloo rank on the card (spawned by phase_sharded):
    4h-a at tp = world and, on four ranks, 4h-b and 4h-c."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    device = torch.device(torch.cuda.current_device())  # the card launch.py set
    tp = init_device_mesh("cuda", (world,), mesh_dim_names=("tp",))
    out = {"a": sharded_cone_run(tp, device)}
    if world == 4:
        out["b"] = sharded_chain_runs(tp, device)
        out["c"] = sharded_grid_run(init_device_mesh("cuda", (2, 2),
                                                     mesh_dim_names=("dp", "tp")), device)
    return out


def log_run(label, r, card):
    log(f"[4h sharded] {label} {r['label']}: {r['iterations']} iterations, fail "
        f"{r['fail']}; wall {r['wall']:.4f} s (first {r['first']:.3f} s), "
        f"{r['iterations'] / r['wall']:.2f} Newton it/s; per iteration of a profiled "
        f"solve of {SHARDED_PROFILE_ITERATIONS}: {r['launches']:.1f} launches, "
        f"{r['device_ms']:.3f} ms of device-kernel time, {r['spans']:.1f} all-reduces "
        f"taking {r['span_ms']:.3f} ms on the host (NCCL kernels {r['nccl_ms']:.3f} "
        f"ms); K1 launches {r['k1']}; {card}")


def phase_sharded(device):
    """4h: multi-device execution on the one card.  Returns K1's launches
    in 4h's cone-sharded solves (every rank's)."""
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from conex_tpu_torch import DenseLMICone, Program, SolverConfig
    from conex_tpu_torch.cones import psd_schur
    from conex_tpu_torch.cones.psd import make_psd_state
    from conex_tpu_torch.parallel.launch import run_ranks
    from conex_tpu_torch.solver.loop import _add_scenario, _solve_impl, _strip_scenario, solve
    from conex_tpu_torch.supernodal.solver import SupernodalStructure
    from conex_tpu_torch.utils.profiling import phase_timings

    start = time.perf_counter()
    card = card_name_and_power_limit()
    log(f"[4h sharded] {card}; every rank below shares this one card: no time "
        "here is a scaling figure")

    # 4h-a: the unsharded solve, then one NCCL rank.
    blocks, b, ws, scalars, config = sharded_lmi(device)
    ref = solve(blocks, (), b, ws, scalars, config)
    torch.cuda.synchronize()
    wall = best_wall(lambda: solve(blocks, (), b, ws, scalars, config), reps=1)
    log(f"[4h sharded] 4h-a unsharded solve of {SHARDED_SHAPE[0]} cones (m, n = "
        f"{SHARDED_SHAPE[1:]}, f32): {int(ref.num_iterations)} iterations, fail "
        f"{bool(ref.fail)}, wall {wall:.4f} s, "
        f"{SHARDED_ITERATIONS / wall:.2f} Newton it/s; {card}")
    del blocks, ws
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(f"{tmp}/store", 1),
                                rank=0, world_size=1,
                                device_id=torch.device(torch.cuda.current_device()))
        try:
            nccl = sharded_cone_run(init_device_mesh("cuda", (1,), mesh_dim_names=("tp",)),
                                    device)
        finally:
            dist.destroy_process_group()
    log_run("4h-a NCCL", nccl, card)
    err = float((nccl["y"] - ref.y.cpu()).abs().max() / ref.y.abs().max().cpu())
    log(f"[4h sharded] 4h-a one NCCL rank against the unsharded solve: y rel err "
        f"{err:.3e} (limit {SHARDED_Y_LIMIT})")
    if (nccl["iterations"] != SHARDED_ITERATIONS or nccl["fail"] or bool(ref.fail)
            or not err <= SHARDED_Y_LIMIT or nccl["k1"] != SHARDED_ITERATIONS):
        fail(f"4h-a: the NCCL rank's solve is not the unsharded one (K1 launches "
             f"{nccl['k1']})")
    k1_total = nccl["k1"]
    records = {}
    for world in SHARDED_RANKS:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            records[world] = run_ranks(sharded_rank, world, workdir=tmp,
                                       timeout=RANK_TIMEOUT)
        log(f"[4h sharded] {world} gloo ranks spawned and joined in "
            f"{time.perf_counter() - t0:.1f} s")
    y_ref = ref.y.cpu()
    for world, ranks in records.items():
        for rank, out in enumerate(ranks):
            r = out["a"]
            log_run(f"4h-a gloo rank {rank}/{world}", r, card)
            err = float((r["y"] - y_ref).abs().max() / y_ref.abs().max())
            log(f"[4h sharded] 4h-a gloo rank {rank}/{world}: y rel err against the "
                f"unsharded solve {err:.3e} (limit {SHARDED_Y_LIMIT}); K1 at (1, "
                f"{SHARDED_SHAPE[0] // world}, {SHARDED_SHAPE[1]}, {SHARDED_SHAPE[2]})")
            if (r["iterations"] != SHARDED_ITERATIONS or r["fail"]
                    or not err <= SHARDED_Y_LIMIT or r["k1"] != SHARDED_ITERATIONS):
                fail(f"4h-a: rank {rank} of {world}: {r['iterations']} iterations, "
                     f"fail {r['fail']}, y rel err {err}, K1 launches {r['k1']}")
            if not torch.equal(r["y"], ranks[0]["a"]["y"]):
                fail(f"4h-a: the ranks of {world} return different y")
            k1_total += r["k1"]

    # 4h-b: the distributed KKT against the unsharded supernodal solve.
    four = records[4]
    chain_ref = {}
    for key, where in (("card", device), ("CPU", torch.device("cpu"))):
        blocks, ws, b, cliques = soc_chain_blocks(where)
        scalars = dict(k=torch.zeros((1,), dtype=torch.float64, device=where),
                       b_scaling=torch.ones((1,), dtype=torch.float64, device=where),
                       c_scaling=torch.ones((1,), dtype=torch.float64, device=where))
        config = SolverConfig(max_iterations=SHARDED_CHAIN_ITERATIONS)
        t0 = time.perf_counter()
        res = _strip_scenario(_solve_impl(
            _add_scenario(blocks), (), b[None], _add_scenario(ws), scalars, config,
            kkt_structure=SupernodalStructure.from_cliques(cliques, len(b))))
        chain_ref[key] = res
        log(f"[4h sharded] 4h-b unsharded supernodal solve on the {key}: "
            f"{int(res.num_iterations)} iterations, solved {bool(res.solved)}, "
            f"wall {time.perf_counter() - t0:.3f} s")
    y_card, y_cpu = chain_ref["card"].y.cpu(), chain_ref["CPU"].y
    err = float((y_card - y_cpu).abs().max())
    log(f"[4h sharded] 4h-b unsharded: card against CPU max |dy| {err:.3e} "
        f"(limit {SHARDED_CHAIN_LIMIT})")
    if not (err <= SHARDED_CHAIN_LIMIT and bool(chain_ref["card"].solved)):
        fail("4h-b: the unsharded chain on the card is not the CPU's")
    for rank, out in enumerate(four):
        for name, r in out["b"].items():
            log_run(f"4h-b gloo rank {rank}/4", r, card)
            errs = [float((r["y"] - y).abs().max()) for y in (y_card, y_cpu)]
            log(f"[4h sharded] 4h-b {name} rank {rank}/4: max |dy| against the "
                f"unsharded solve on the card {errs[0]:.3e}, on the CPU {errs[1]:.3e} "
                f"(limit {SHARDED_CHAIN_LIMIT})")
            if r["fail"] or not bool(r["solved"].all()) or not max(errs) <= SHARDED_CHAIN_LIMIT:
                fail(f"4h-b: {name} on rank {rank} is not the unsharded solve")

    # 4h-c: the 2D mesh against the per-scenario solves on the card.
    A, C, b = grid_lmi(device)
    one = {k: torch.tensor(v, dtype=torch.float64, device=device)
           for k, v in (("k", 0.0), ("b_scaling", 1.0), ("c_scaling", 1.0))}
    ys = torch.stack([solve((DenseLMICone(A=A[s], C=C[s]),), (), b[s],
                            (make_psd_state(C[s].clone()),), one,
                            SolverConfig(max_iterations=SHARDED_GRID_ITERATIONS)).y
                      for s in range(SHARDED_GRID[0])]).cpu()
    for rank, out in enumerate(four):
        r = out["c"]
        log_run(f"4h-c gloo rank {rank}/4", r, card)
        err = float((r["y"] - ys).abs().max())
        log(f"[4h sharded] 4h-c rank {rank}/4 (S, B, n, m = {SHARDED_GRID}, f64): "
            f"max |dy| against the per-scenario solves {err:.3e} (limit "
            f"{SHARDED_GRID_LIMIT})")
        if r["fail"] or not err <= SHARDED_GRID_LIMIT or not r["k1"]:
            fail(f"4h-c: rank {rank}'s 2D solve is not the per-scenario solves")
        k1_total += r["k1"]

    # K1 at one rank's shape on four ranks, against its plain version.
    shape = (1, SHARDED_SHAPE[0] // 4, *SHARDED_SHAPE[1:])
    A, W, C = (x.float() for x in schur_inputs(*shape, seed=3, device=device))
    got = psd_schur.schur_kernel(A, W, C)
    plain = psd_schur.schur_plain(A, W, C)
    err = rel_err(got, psd_schur.schur_plain(*(x.double() for x in (A, W, C))))
    ms = {"plain": [], "kernel": []}
    fns = {"plain": lambda: psd_schur.schur_plain(A, W, C),
           "kernel": lambda: psd_schur.schur_kernel(A, W, C)}
    for name in ("plain", "kernel", "kernel", "plain"):
        ms[name].append(time_ms(fns[name], 20))
    log(f"[4h sharded] K1 at {shape} f32: rel err vs the f64 oracle {err:.3e} "
        f"(limit 1e-4), max |kernel - plain| "
        f"{max(float((g - p).abs().max()) for g, p in zip(got, plain)):.3e}; ms per "
        f"call: kernel {ms['kernel']}, plain {ms['plain']} (CUDA events, 20 calls "
        f"each); bound {schur_bound(shape[1], 1, *shape[2:], tensor_cores=True)}; {card}")
    if not err <= 1e-4:
        fail("4h: K1 disagrees with the f64 oracle at one rank's shape")

    # 4h-d: the phase timers on the card.
    import numpy as np

    m, n = PHASE_TIMINGS_SHAPE
    rng = np.random.default_rng(0)
    As = rng.uniform(-1, 1, (m, n, n))
    prog = Program(m, dtype=torch.float32, device=device)
    prog.add_lmi_constraint(0.5 * (As + np.swapaxes(As, 1, 2)), 3.0 * np.eye(n))
    phases = phase_timings(prog, reps=10)
    log(f"[4h sharded] 4h-d phase_timings of one {n} x {n} LMI program, m = {m}, "
        f"f32: " + ", ".join(f"{k} {1e3 * v:.4f} ms" for k, v in phases.items())
        + f"; {card}")
    if set(phases) != {"assemble", "factor", "solve", "update"} or not all(
            v > 0 for v in phases.values()):
        fail(f"4h-d: phase_timings gave {phases}")
    log(f"[4h sharded] phase {time.perf_counter() - start:.1f} s")
    return k1_total


def phase_probe_entry_points():
    """The two probe harnesses on the card; returns each variant's kernel
    launches in this phase."""
    from conex_tpu_torch.benchmarks import dev_pallas_probe, dev_tpu_probe2
    from conex_tpu_torch.utils.profiling import counters

    kernels = {name: kernel for name, (_, kernel) in probe_variants().items()}
    others = ("schur.calls", "socp.calls")
    for kernel in kernels.values():
        kernel.launches = 0
    for key in others:
        counters[key] = 0
    t0 = time.perf_counter()
    dev_pallas_probe.main([",".join(map(str, PROBE_SHAPE))])
    dev_tpu_probe2.part2()
    launches = {name: kernel.launches for name, kernel in kernels.items()}
    log(f"[6 probe entry points] {time.perf_counter() - t0:.2f} s, kernel "
        f"launches {launches}")
    if not all(launches.values()):
        fail(f"a probe variant did not launch its kernel: {launches}")
    if any(counters[key] for key in others):
        fail("the probes launched K1 or K2")

    # K4 reads A in place: a call holds its plan's scratch and outputs, and
    # no At copy of A.
    import torch

    A, w, C = dev_pallas_probe.probe_inputs(*PROBE_SHAPE, "cuda")
    plan = dev_pallas_probe.probe_at_plan(*PROBE_SHAPE, A.element_size())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    dev_pallas_probe.fused_b_kernel(A, w, C)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - held
    log(f"[6 probe entry points] one K4 call: peak device memory above what it "
        f"was given {extra} bytes; its plan's scratch {plan.scratch_bytes} bytes; "
        f"A {A.numel() * A.element_size()} bytes")
    if extra > plan.scratch_bytes + (1 << 20):
        fail("K4's call holds more than its plan's scratch: a copy of A?")

    # K3 runs K1's kernels on views: a call holds K1's panel scratch and
    # partials under its plan, and no copy of A.
    a_plan = a_plan_record(dev_pallas_probe.probe_a_plan(*PROBE_SHAPE, A.element_size()),
                           A.element_size())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    dev_pallas_probe.fused_a_kernel(A, w, C)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - held
    log(f"[6 probe entry points] one K3 call: peak device memory above what it "
        f"was given {extra} bytes; its plan's panel scratch and partials "
        f"{a_plan['scratch_bytes']} bytes")
    if extra > a_plan["scratch_bytes"] + (1 << 20):
        fail("K3's call holds more than its plan's scratch: a copy of A?")
    return launches


def main():
    start = time.perf_counter()
    card = card_name_and_power_limit()
    log(f"[1 card] {card}")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"[1 card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{kind}, {count} visible")

    from conex_tpu_torch import _build

    build = _build.build(force=True)
    log(f"[2 build] nvcc {build.seconds:.2f} s -> {build.path.name}")
    for line in build.log.splitlines():
        if ("ptxas info" in line and ("Used" in line or "entry" in line)
                or "stack frame" in line):
            log(f"[2 build] {line.strip()}")

    schur = phase_kernel(device)
    fused = phase_fused_kernel(device)
    probes = phase_probe_kernels(device)
    schur["launches"] = phase_main_path(device)
    phase_small_vs_cpu(device)
    fused["launches"] = phase_socp_main_path(device)
    phase_lp_path(device)
    schur["path_launches"] = {"4": schur["launches"], "4d": phase_eq_sdp(device)}
    phase_qp(device)
    phase_herm(device)
    schur["path_launches"]["4g"] = phase_sparse(device)
    schur["path_launches"]["4h"] = phase_sharded(device)
    phase_known_answer(device)
    phase_soc_known_answer(device)
    phase_lp_known_answer(device)
    phase_eq_known_answers(device)
    schur["path_launches"]["5e"] = phase_front_ends(device)
    schur["path_launches"]["5f"] = phase_abi(device)
    for name, n in phase_probe_entry_points().items():
        probes[name]["launches"] = n

    kernels = [
        dict(name="schur", route="cuda", source=SCHUR_SOURCE,
             replaces=SCHUR_REPLACES, library_ms=None, **schur),
        dict(name="fused_socp", route="cuda", source=FUSED_SOURCE,
             replaces=FUSED_REPLACES, library_ms=None, **fused),
    ] + [dict(name=name, route="cuda", source=source, replaces=replaces,
              library_ms=None, **probes[name])
         for name, _, replaces, source in PROBES]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "plan",
            "path_launches")
    optional = ("plan", "path_launches")
    log(LIBRARY_NOTE)
    log(f"[end] every phase passed in {time.perf_counter() - start:.1f} s, the build "
        "included")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys
                                   if k not in optional or k in kern}
                                  for kern in kernels]}), flush=True)
    print(card_name_and_power_limit(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
