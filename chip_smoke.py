#!/usr/bin/env python3
"""Smoke run of su2_tpu_torch on one NVIDIA GPU: build, check, drive.

Sizes: SIZES names the channel's three, the 9,072-node flagship class,
the 142,317-node scaling point and TIER_N (263,900) nodes of the
>= 200k-node tier; the 3D boxes and tet boxes are BOX_* and TET_*.
Below, "the tier" is that size.

Phases (one line each; any failure exits nonzero):
  1 device   the card's name and power limit, CUDA and nvcc versions
  2 build    nvcc builds the kernels from su2_tpu_torch/csrc (one nvcc per
             source, all started together)
  3 kernels  T1-T4 against their plain torch versions on the card, at the
             9,072-node case's shapes, in float64 and float32, with times;
             T4 also at its other instances (the case cut to 3 species,
             compiled, and to 5, the run-time instance) on the primitive
             rows' column views, one CUDA launch a call; K7 (WLS and
             GG, beside torch.sparse.mm of the same operator; its window
             form, and forced to its streamed form; a 3D box's 6 offsets,
             streamed, and 8 2D offsets, the run-time-K instance, one
             CUDA launch a call) and K8 (beside T3 + the
             roll-subtract) at the TIER_N-node case's shapes, K9 on a
             batch the size of that case's inlet (377 vertices), in
             float64 and float32
  4 stencil  K5 (sweep + matvec, sweep only, matvec only) and K6 (one
             FGMRES(10) cycle) against their plain versions, in float64,
             float32 and mixed (bf16 sweep blocks): on the SST systems
             (v = 2) the port assembles at 9,072 and 142,317 nodes, on the
             implicit LU_SGS case's flow systems (v = 13: K6 at 9,072 nodes,
             K5 at 142,317) and on band systems (v = 2, 3, 7) with
             round-robin (not proper) colorings; at TIER_N nodes K5 in
             the main path's mixed tier on the SST and the flow systems
             (and its matvec in float32); K5 and K6 read the layout
             StencilSolveOps makes (color-major bf16 sweep blocks in the
             mixed tier; K6 over the node order at v = 7, 13); K6 at
             v = 2, 3 also on band systems at the one-launch tier's cap
             (12,288 nodes); times, bounds, K6's cooperative grid (v = 7,
             13) or cluster (v = 2, 3),
             torch.sparse.mm on the matvec as BSR (or what it raised)
  5 step     (first, after 2: step_checks) 5 coupled iterations of the
             9,072-node case in float64 on the card (kernels, K6 for the
             SST solve) and on the CPU (plain versions) from one state,
             the CPU's in CPU_WORKERS worker processes beside the card's
             phases, compared with the card's before 6 (finish_steps,
             which prints the lines); again with the >= 200k-node tier
             forced on both sides (K7 and K8 against their plain versions
             inside the step), and with a TOTAL_CONDITIONS inlet (K9); the
             implicit-flow case (EULER_IMPLICIT, MUSCL + Venkatakrishnan:
             K10 once per iteration) the same way with JACOBI, with JACOBI
             and the tier forced (K7's rows feeding K10), and with LU_SGS
             (the flow's 13 x 13 system through K5 past the full-precision
             gate, the SST's through K6); and the f64 checks the phases
             below name
  graph      (between 5 and 6) every path of the kernel table through the
             step's captured CUDA graph (Simulation.run's chunks are
             replays of it): explicit LU_SGS at 9,072 (T1-T4, K6 as a
             cluster), 142,317 (K5 at v = 2) and TIER_N nodes (K7, K8),
             implicit LU_SGS at 9,072 (K10, K6 cooperative at v = 13) and
             142,317 (K5 at v = 13), laminar implicit LU_SGS (K11), the
             triangle channel (K13), a TOTAL_CONDITIONS inlet (K9) and the
             fused SST assembly (K12), float32: 2 replays against 2 eager
             iterations from one state, bit for bit in the state and the
             history rows; one eager step under
             torch.cuda.set_sync_debug_mode("error"); the captured launches
             per replay against the eager step's; the su2k kernels of the
             replays on the card (torch.profiler) against the eager
             step's; capture seconds (graph_check)
  6 slice    Simulation.run (replays of the captured graph, chunks of 25),
             then the same iterations through the eager step (ms/iter of
             both side by side): 9,072 nodes x 10, 142,317 nodes x 5 and
             the tier x 3 (K7 twice and K8 once per iteration, T3 never)
             in float32 with LU_SGS; 142,317 nodes x 3 in float64 (K5 at
             full precision in the Krylov loop);
             finite residuals, kernel launch counts (K6 once per iteration
             at 9,072 nodes, K5 ten times per iteration at the larger
             sizes), ms/iter and Mcell-updates/s; 9,072 nodes x 10 with a
             TOTAL_CONDITIONS inlet (K9 once per iteration, profiled);
             at every size LINEAR_SOLVER_PREC= JACOBI (the path that
             bypasses K5/K6) before LU_SGS; each timed
             and then profiled over an eager iteration (torch.profiler: CUDA
             launches, CUDA API calls and device-busy ms per iteration, the
             launches per stage of the step, step_groups) and a replay
             (device kernels, CUDA API calls and device-busy ms per
             iteration, profile_run); the launch counts of a run are the
             graph's replays' (each replay adds the launches its capture
             recorded), checked equal to the eager step's; the implicit-flow case in
             float32, timed and profiled (K10 and T2 twice per iteration,
             T3, K8 and T4 never): with JACOBI at 9,072 x 5, 142,317 x 3
             and the tier x 2 (K5 and K6 never), with LU_SGS at 9,072 x 10
             (K6 twice per iteration: the flow's mixed one-launch tier and
             the SST's, K5 never), 142,317 x 5 and the tier x 3 (K5 twenty
             times per iteration, K6 never)
  K10 phase  (between 4 and 5) K10 (compiled for 9 and 3 species) against
             its plain version at 9,072 nodes
             in float64 and float32 for the four (MUSCL, limiter) variants
             and at 142,317 and TIER_N nodes in float32 (the latter's
             stack from K7's gradient rows, as the tier's ns_assemble builds
             it), per output row, with times
  K11 phase  (after K10) K11 (the AUSM+-up flux and both Jacobians) against
             its plain version on the laminar implicit case's family slots
             (limited MUSCL face states): 9,072 nodes in float64 and
             float32, the tier in float32, feature-major (the main path) and
             edge-major, per output row, pad slots exactly 0, with times;
             the step checks hold 5 laminar (KIND_TURB_MODEL= NONE) f64
             iterations card vs CPU at 9,072 nodes: explicit (T4),
             implicit LU_SGS (K11, the flow's solve), implicit JACOBI
             with the tier forced (K7)
  laminar    (at the end of 6) the laminar implicit LU_SGS case at 9,072 x
             10 (K11 and K6 once per iteration) and the tier x 3 (K11 once,
             K5 ten times, K7 once per iteration) and the laminar explicit
             case at 9,072 x 10 (T4 once per iteration, K11 never), each
             timed and profiled
  K12 phase  (after K11) K12 (the fused SST assembly) against its plain
             version on the SST inputs of the explicit LU_SGS case's third
             iteration, with its wall rows: 9,072 nodes in float64 and
             float32, the tier in float32, per output row, with times;
             the step checks hold 5 f64 iterations card vs CPU with the
             fused SST assembly (K12 once per iteration), explicit LU_SGS
             and implicit LU_SGS
  fused      (in 6) SU2_TPU_SST_ASSEMBLE=pallas through Simulation: explicit
             LU_SGS at 9,072 x 10, 142,317 x 5 and the tier x 3 (the
             larger two: the SST's solve in fused_sst_solve_tier's
             per-iteration K5 tier) and implicit LU_SGS at 9,072 x 10, K12
             once per iteration and the SST
             solve's K5/K6 in stencil_solve.fused_sst_solve_tier's tier,
             timed and profiled, each printed beside the unfused run of
             its size; every other run asserts K12 never launched
  K13 phase  (after K12) K13 (the explicit edge terms over an edge list,
             summed per node) on the scrambled triangle channel
             (cases.tri_channel_mesh, no static stencil: the gather path)
             at 9,072 nodes in float64 and float32 and at 142,317 in
             float32, the stack node-major: the edge pass and the call
             (edge pass + node sums) against their plain versions per
             output row, the node sums scatter_edges_mixed's bit for
             bit, with times, the call's device operations, bounds and
             torch.sparse.mm beside the sums; the step checks hold 5 f64
             iterations of the explicit LU_SGS step on the 9,072-node
             triangle channel card vs CPU (K13 once per iteration, the SST
             solve in torch gather ops: K5/K6 never)
  shapes     (after K13) T2 (full and lite) at 5 and 16 species (its
             run-time-count instance) on the 9,072-node channel's node
             count, T3, K8 and K13 at the (dimension, species)
             shapes (2, 5), (2, 1) and (3, 16), K10 at 5 and 3 species and
             K11 at 3 and 5 species (every shape outside the compiled
             lists runs a kernel's run-time-count instance) against their
             plain versions on cases.shape_inputs (9,072-node channel and
             box), float64 and float32, per output row at the compiled
             shapes' tolerances, with float32 times
  tri        (at the end of 6) Simulation.run on the triangle channel in
             float32: 9,072 x 10 and 142,317 x 10 with LU_SGS and with
             JACOBI, each timed and profiled (K13 once per iteration; T3,
             K8, K5, K6, K7 and K12 never); every stencil-mesh run asserts
             K13 never launched
  gather     (after the K13 phase) meshes without a static stencil,
             implicit and laminar: K11 against its plain version on the
             implicit triangle channel's edge rows (MUSCL +
             Venkatakrishnan; 9,072 nodes in float64 and float32, 142,317
             in float32), K13 on the 136,161-node tet box (cases.
             tet_box_mesh(81, 41, 41), (3, 9)) in float32; the step
             checks hold 5 f64 iterations card vs CPU of the 9,072-node
             implicit triangle channel with LU_SGS and with LINELET (K11
             once per iteration, the solves in torch gather ops), its
             laminar implicit JACOBI step and the explicit LU_SGS step
             of the 19,844-node tet box; in the graph phase the implicit
             triangle channel (LU_SGS, LINELET), its laminar implicit
             case and the 19,844-node tet box; at the end of 6 their
             slices, float32, timed and profiled with the device ms of
             each stage (device_ms_by_group): implicit LU_SGS and JACOBI
             at 9,072 x 10 and 142,317 x 3, laminar explicit and implicit
             JACOBI at 9,072 x 10, the tet box at 136,161 x 5
  3D         (after the gather phases) the 3D implicit flow (MUSCL +
             Venkatakrishnan, box_mesh with cases.with_box_markers'
             walls, box_phase): K10 at (3, 9) against its plain version
             on the 8,000-node box (float64 and float32, the four
             variants) and at 136,161 and 262,701 nodes (float32, the
             latter's stack from K7's rows), at (3, 3) on the 3-species
             case (cases.SPECIES_3) at 8,000 and 136,161; K11 in 3D on the
             laminar box's family slots (8,000 float64 and float32,
             136,161 float32) and on the implicit tet box's edge rows
             (19,844 nodes, float64 and float32); K5 and K6 at v = 14 and
             8 on the box's flow systems (K6 at 8,000 nodes, where the
             one-launch tier holds, K5 at 136,161) and on band systems
             with 6 offsets, in float64, float32 and mixed; the step
             checks hold 5 f64 iterations card vs CPU of the implicit
             RANS and laminar LU_SGS steps on the 10,260-node box and of
             the implicit LU_SGS step of the 19,844-node tet box; in the
             graph phase
             the box's RANS, 3-species and laminar steps at 8,000 nodes,
             its RANS step at 136,161 and the 19,844-node tet box's
             implicit step; at
             the end of 6 the box slices (BOX_SLICES: implicit LU_SGS at
             8,000 x 20, 136,161 x 10 and 262,701 x 3, JACOBI at 136,161 x
             5, the 3-species and laminar boxes at 136,161), float32,
             timed and profiled with the device ms of each stage
  widths     (after 3D) K5 and K6 at every block width from 4 to 21 that
             kernels.STENCIL_WIDTHS does not compile, through the
             run-time kernels (RUNTIME_WIDTHS, widths_phase; each line
             with the width's class, K6's form; K6 on the flow
             systems also in its streamed form; every class's registers
             and spills from this run's ptxas):
             K5's three modes and K6 against their plain versions on band
             systems (band_offsets) and on the flow systems of the
             5-species cases (MIXTURE_PATHS: v = 9 on the channel, K6 at
             SIZES["flagship"], K5 at SIZES["scaling"]; v = 10 on the box,
             K6 at BOX_KERNELS, K5 at BOX_SCALING), f64, f32 and mixed,
             times at RUNTIME_TIMED's widths and on the flow systems; the
             run-time kernels at 8 and 13 against the compiled ones (K5
             bit for bit, K6 within its pins; both times); the step
             checks hold 5 f64 iterations card vs CPU of the 5-species
             implicit LU_SGS channel (SIZES["flagship"]) and box
             (BOX_STEP); in the graph phase every path of MIXTURE_PATHS
             (the channel with LU_SGS at each size of SIZES, with ILU0,
             BCGSTAB, LINELET and laminar at SIZES["flagship"]; the box at
             BOX_KERNELS and BOX_SCALING); at the end of 6 their slices,
             float32, timed and profiled with the device ms of each stage
             (mixture_slices)
  output     (after 6) Simulation.run(50, chunk=25) of the 9,072-node
             explicit LU_SGS case in float32 through the captured graph
             with WRT_SOL_FREQ= 25 (the writes between chunks: one T2
             launch each beside the replays): the restart, history,
             surface and volume files (TECPLOT, TECPLOT_BINARY, PARAVIEW,
             FIELDVIEW), the restart read back through RESTART_SOL= YES to
             the run's final u and q bit for bit; from that restart in
             float64, card vs CPU: the recomputed mu_t, grad_k, sigma_k
             and 5 iterations, then monitor_forces over both walls and
             forces_breakdown.dat; one line of times with the card's name
             and power limit: write_solution at 9,072 and TIER_N nodes,
             ms/iter of 20 iterations with MARKER_MONITORING (chunk 1)
             beside chunk 25 without (output_phase).  CGNS (OUTPUT_FORMAT=
             CGNS_SOL, MESH_FORMAT= CGNS) needs h5py, an optional
             dependency this script does not take on:
             tests/test_torch_output.py holds it on the CPU
  options    (before graph) the slice's options (OPTION_PATHS) at 9,072
             nodes in float64, card vs CPU through the entry points a
             user calls: dual time BDF2 explicit and BDF1 implicit
             LU_SGS (run_unsteady, 2 physical steps of 2 inner
             iterations), explicit MUSCL on the channel and the triangle
             channel (T1 on the face rows), CLIPPING_TEMPRATURE (T2),
             BCGSTAB on the implicit LU_SGS case (the flow's and the
             SST's solves through K5's sweep-only and matvec-only forms,
             counted exactly) and LINELET on the implicit case (3
             iterations of run from 10 card iterations); each then
             through graph_check (options_phase); T2 with the clip
             against its plain version in phase 3
The line before the last is the JSON kernel report; the last line is
{"ok": true, "device": {...}}.

Run from the repository root:  python3 chip_smoke.py

    python3 chip_smoke.py --time-kernels [--root DIR] [--only K7,T4]
    python3 chip_smoke.py --bitwise DIR

times T1, T2, K5, K6, K7, K8, K9, K10, K11, T4, K12 and K13 (or those
--only names) of the
su2_tpu_torch in DIR (default: this
checkout; another checkout, such as a parent commit unpacked with git
archive, for an A/B comparison run in the order A B B A on one card) and
prints, after the card's line, the SASS instructions and local loads (LDL)
and stores (STL) of each kernel of SASS_SOURCES (T2's node_state.cu among
them), the barriers K6 is built from timed alone (BARRIER_BENCH_CU:
cluster.sync() and K6's cluster reduction on 8 and 16 CTAs, grid.sync()
on 36 and 132 blocks), then one JSON line: T2 full and lite
(kernels.node_state) at 9,072 and TIER_N nodes on kernel_inputs' state,
and the full pass again built from DIR's node_state.cu with
T2_APPROX_FLAGS (approximate division and square root), guessed at the
converged T and with no secant step (every node bisects);
K5 as the Krylov loop calls it (StencilSolveOps.precond_matvec in the
tier solve_tier picks) on the systems of the third coupled step, the implicit
LU_SGS case's flow system (v = 13) and the explicit case's SST system
(v = 2), at 142,317 and TIER_N nodes; K6 as a one-launch solve calls it
(StencilSolveOps.fgmres, one FGMRES(10) cycle at tol 1e-6) on those
systems at 9,072 nodes: the flow's in the mixed tier (bf16 sweep blocks)
and at full precision, the SST's in its tier (and in clusters of 8 and
16 CTAs where DIR's kernels.stencil_fgmres takes cluster); K10
(kernels.edge_implicit, MUSCL + Venkatakrishnan, both families) at 9,072
and TIER_N nodes on k10_inputs' state; K8 and T3 + the roll-subtract at
TIER_N nodes on kernel_inputs' state; K7 and T4 as time_k7_t4 says
(K7's sweeps at TIER_N nodes, also with every offset 0 and, where DIR's
source caps its offset loop, built with the cap at the mesh's K; T4 at
9,072 and TIER_N nodes on the step's column views); K13 as time_k13
says (the edge pass and the whole call on the 9,072- and 142,317-node
triangle channel; K8's slot pass at TIER_N nodes, the same per-edge
body); T1, K9 and K12 as time_t1_k9_k12 says (T1 on a boundary batch
and on the TIER_N-node case's MUSCL face rows with its bound, K9 on the
TIER_N-node case's inlet, K12 at 9,072 and TIER_N nodes with its
bound); K11 as time_k11 says (feature-major, the laminar implicit
case's family slots at 9,072 and TIER_N nodes, with its bound); K5 and
K6 at the widths with no compiled instance as time_runtime_widths says
(the 5-species flow systems: K5 mixed and its f32 matvec at 142,317 and
136,161 nodes, K6 mixed at 9,072 and 8,000; RUNTIME_TIMED's band
systems in f64, f32 and mixed; the run-time kernels at 8 and 13 beside
the compiled ones, with device ms and bounds);
float32, cuda_time's median ms (host work included) and, for T1, T2, K6,
K7, K9, K11, T4, K12 and K13, device_ms (the kernels alone,
torch.profiler; T1, K7, K9, K11, T4, K12 and K13 also every device
operation of the call by name and its CUDA launches, time_call).  The
default run prints no device ms: profiler windows late in a long process
lose device events (PERF.md).

    python3 chip_smoke.py --run-loop [--gather | --box] [--root DIR]

times the run loop of the su2_tpu_torch in DIR (default: this checkout)
on RUN_LOOP_PATHS (9,072 nodes explicit and implicit LU_SGS, TIER_N
implicit LU_SGS; with --gather GATHER_RUN_LOOP_PATHS instead: the
implicit triangle channel with LU_SGS and JACOBI at 9,072 and 142,317
nodes, its laminar explicit and implicit cases at 9,072, the 136,161-node
tet box; with --box BOX_RUN_LOOP_PATHS: the 3D implicit box at 8,000
and 136,161 nodes, its 3-species and laminar cases, the implicit tet box;
float32, the default SST assembly), after a 2-iteration
warm-up: where DIR's Simulation has a captured graph, eager (A: the step
from the host, eager_iterations) against graph (B: run(niter, chunk=25))
in the order A B B A, the eager step's profile (CUDA launches, API calls,
busy ms per iteration, device ms by stage), the peak memory of one eager
step and of the capture (memory_mb) and the capture seconds; without one (a parent checkout) run(niter, chunk=25)
twice; for both the run's profile over one chunk of 3 iterations
(profile_run: device kernels, su2k kernels, busy ms, CUDA API calls per
iteration).  One JSON line per path, then one for all.

    python3 chip_smoke.py --time-options

times the slice's options in float32 (options_time_main): the explicit
LU_SGS case first order and with MUSCL at 9,072 and TIER_N nodes, the
implicit LU_SGS case with FGMRES, BCGSTAB and LINELET at 9,072, dual time
per physical step, T1 on the TIER_N-node MUSCL face rows; one JSON line.

    python3 chip_smoke.py --bitwise DIR

holds T2 (CLIPPING_TEMPRATURE off), K7 and T4 of this checkout against
those of the checkout DIR bit
for bit on the TIER_N-node case's inputs, K13's per-edge outputs and
node sums on the 9,072- and 142,317-node triangle channel, and K10 (every
variant; 9, 3 and 5 species) and K11 (both layouts) in 2D, in float32
and float64, and compares the SASS of each 2D instance of K10 and K11
with DIR's (bitwise_main, sass_2d_diff); then K5 and K6 as below.

    python3 chip_smoke.py --bitwise-stencil DIR

holds K5 (its three modes) and K6 at every compiled width
(kernels.STENCIL_WIDTHS) on band systems, in float64, float32 and mixed,
against DIR's bit for bit, K5's three modes through the run-time kernels
at every width of RUNTIME_WIDTHS (and 8, 13) against DIR's run-time
instance, and compares the SASS of every compiled K5/K6 instance with
DIR's (stencil_bitwise, sass_same_names).
"""

from __future__ import annotations

import functools
import inspect
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# kernel name -> (source in the repo, TPU kernel it replaces)
KERNELS = {
    "mixture_enthalpy": ("su2_tpu_torch/csrc/thermo.cu",
                         "su2_tpu/pallas/thermo.py:66"),
    "node_state": ("su2_tpu_torch/csrc/node_state.cu",
                   "su2_tpu/pallas/node_state.py:183"),
    "edge_flux": ("su2_tpu_torch/csrc/edge_flux.cu",
                  "su2_tpu/pallas/edge_fused.py:161"),
    "chem_source": ("su2_tpu_torch/csrc/chem_source.cu",
                    "su2_tpu/pallas/chem_source.py:62"),
    "stencil_sgs_matvec": ("su2_tpu_torch/csrc/stencil_solve.cu",
                           "su2_tpu/pallas/stencil_solve.py:178,206,251,273,"
                           "554,643,741"),
    "stencil_fgmres": ("su2_tpu_torch/csrc/stencil_solve.cu",
                       "su2_tpu/pallas/stencil_solve.py:381,434"),
    # the same kernels' run-time-width instance (every width from 4 to 21
    # outside kernels.STENCIL_WIDTHS), counted apart
    "stencil_runtime_sgs_matvec": ("su2_tpu_torch/csrc/stencil_solve.cu",
                                   "su2_tpu/pallas/stencil_solve.py:178,206,"
                                   "251,273,554,643,741"),
    "stencil_runtime_fgmres": ("su2_tpu_torch/csrc/stencil_solve.cu",
                               "su2_tpu/pallas/stencil_solve.py:381,434"),
    "gradient_rows": ("su2_tpu_torch/csrc/gradients_tiled.cu",
                      "su2_tpu/pallas/gradients_tiled.py:55"),
    "edge_win": ("su2_tpu_torch/csrc/edge_win.cu",
                 "su2_tpu/pallas/edge_fused.py:346"),
    "inlet_tc": ("su2_tpu_torch/csrc/inlet_tc.cu",
                 "su2_tpu/pallas/inlet_tc.py:74"),
    "edge_implicit": ("su2_tpu_torch/csrc/edge_implicit.cuh",
                      "su2_tpu/pallas/edge_fused.py:721"),
    "ausm_flux_jac": ("su2_tpu_torch/csrc/ausm_jac.cu",
                      "su2_tpu/pallas/edge_kernels.py:34,91"),
    "sst_assemble": ("su2_tpu_torch/csrc/sst_assemble.cu",
                     "su2_tpu/pallas/sst_assemble.py:168,235"),
    "edge_list_flux": ("su2_tpu_torch/csrc/edge_list.cu",
                       "su2_tpu/pallas/edge_fused.py:494"),
}
# tolerances per kernel and dtype: |kernel - plain| <= rtol * |plain|
# + atol_frac * max|plain| (T3: per flux row, atol only, the row's max)
TOL = {
    ("mixture_enthalpy", "float64"): (1e-12, 1e-12),
    ("mixture_enthalpy", "float32"): (1e-5, 1e-5),
    ("node_state", "float64"): (1e-10, 1e-12),
    ("node_state", "float32"): (2e-4, 1e-6),
    ("edge_flux", "float64"): (0.0, 1e-10),
    ("edge_flux", "float32"): (0.0, 1e-4),
    ("chem_source", "float64"): (1e-9, 1e-12),
    ("chem_source", "float32"): (5e-3, 2e-5),
    # K5: f64 at the JAX package's own sweep/matvec pin (tests/test_stencil
    # .py:166-167); f32 and mixed: f32 rounding, fused multiply-adds in the
    # kernel, none in the plain version
    ("stencil_sgs_matvec", "float64"): (1e-11, 1e-13),
    ("stencil_sgs_matvec", "float32"): (1e-5, 1e-6),
    ("stencil_sgs_matvec", "mixed"): (1e-5, 1e-6),
    # K7: f64 at the JAX package's tiled-sweep pin (tests/test_gradients_
    # tiled.py:49-50); f32 as K5 (fused multiply-adds in the kernel only)
    ("gradient_rows", "float64"): (1e-11, 1e-13),
    ("gradient_rows", "float32"): (1e-5, 1e-6),
    # K8: as T3, per residual row against the row's max
    ("edge_win", "float64"): (0.0, 1e-10),
    ("edge_win", "float32"): (0.0, 1e-4),
    # K9: as T1 (built without fused multiply-adds: the plain operations)
    ("inlet_tc", "float64"): (1e-12, 1e-12),
    ("inlet_tc", "float32"): (1e-5, 1e-5),
    # K10: as T3, per output row (flux, j_i, j_j rows of each family)
    # against the row's max
    ("edge_implicit", "float64"): (0.0, 1e-10),
    ("edge_implicit", "float32"): (0.0, 1e-4),
    # K11: as K10, per output row (flux rows, Jacobian entries)
    ("ausm_flux_jac", "float64"): (0.0, 1e-10),
    ("ausm_flux_jac", "float32"): (0.0, 1e-4),
    # K12: per output row against the row's max (built without fused
    # multiply-adds: the plain version's roundings)
    ("sst_assemble", "float64"): (0.0, 1e-12),
    ("sst_assemble", "float32"): (0.0, 1e-5),
    # K13: as T3 (the same edge_side), per output row against its max
    ("edge_list_flux", "float64"): (0.0, 1e-10),
    ("edge_list_flux", "float32"): (0.0, 1e-4),
}
# the (MUSCL, limiter) variants of the implicit case (cases.with_implicit_
# flow); the main path is the first
IMPLICIT_VARIANTS = {"venkatakrishnan": (True, "VENKATAKRISHNAN"),
                     "muscl": (True, None), "first_order": (False, None),
                     "barth_jespersen": (True, "BARTH_JESPERSEN")}
# the 9,072-node flagship class, the 142,317-node scaling point and a
# size of the >= 200k-node tier, TIER_N nodes: the same solve tiers and
# K7/K8 tier as larger sizes, at a build and run time the whole script's
# limit holds
SIZES = {"flagship": (189, 48), "scaling": (753, 189), "tier": (700, 377)}
TIER_N = SIZES["tier"][0] * SIZES["tier"][1]
# the triangle-channel runs (cases.tri_channel_mesh of the same node grids:
# 9,072 nodes / 26,743 edges and 142,317 / 425,068): iterations per size
TRI_NITERS = {"flagship": 10, "scaling": 10}
TC_T_TOT = 600.0        # T_tot of cases.with_total_conditions
# The H100 SXM's published peaks (NVIDIA data sheet, at 700 W): HBM bytes/s
# and non-tensor FLOP/s per type, for the bound of each kernel
HBM_BPS = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12, "mixed": 67e12}
KRYLOV_M = 10           # LINEAR_SOLVER_ITER of the case (the cfg default)
K6_CAP = 12288          # the one-launch tier's largest field at KRYLOV_M
                        # (linalg/stencil_solve._fgmres_cap)
# iterations of the implicit-flow slice runs per size: JACOBI, and LU_SGS
IMPLICIT_NITERS = {"flagship": 5, "scaling": 3, "tier": 2}
LUSGS_NITERS = {"flagship": 10, "scaling": 5, "tier": 3}
# iterations of the laminar implicit LU_SGS slice runs (the explicit one
# at 9,072 nodes runs the flagship's count too)
LAMINAR_NITERS = {"flagship": 10, "tier": 3}
# meshes without a static stencil, implicit and laminar: the
# implicit triangle channel's slice iterations per size (LU_SGS and
# JACOBI; the laminar runs take the flagship's), and the tet box
# (cases.tet_box_mesh, 9 species) of the f64 step checks and the graph
# checks (19,844 nodes) and of the slice (136,161 nodes, TET_NITER
# iterations)
TRI_IMPLICIT_NITERS = {"flagship": 10, "scaling": 3}
TET_STEP = (41, 22, 22)
TET_SLICE = (81, 41, 41)
TET_NITER = 5
# the 3D implicit flow (MUSCL + Venkatakrishnan) on geometry.structured.
# box_mesh with cases.with_box_markers' walls: the box of the f64 step
# checks (10,260 nodes), the kernel phases' box (8,000 nodes: the flow's
# one-launch K6 tier in f32 at v = 14 ends at ~8,300 nodes with the box's
# 6 offsets, solve_tier), and the slices (BOX_SLICES: label -> box,
# make_case keywords, iterations): the 9-species case with LU_SGS at
# 8,000, 136,161 and 262,701 nodes (K7's >= 200k-node tier), with JACOBI
# at 136,161, the 3-species case (cases.SPECIES_3, v = 8) and the laminar
# case (K11) at 136,161
BOX_STEP = (27, 20, 19)
BOX_KERNELS = (20, 20, 20)
BOX_SCALING = (81, 41, 41)
BOX_TIER = (101, 51, 51)
BOX_SLICES = (
    ("8000 box implicit LU_SGS", BOX_KERNELS, {}, 20),
    ("136161 box implicit LU_SGS", BOX_SCALING, {}, 10),
    ("136161 box implicit JACOBI", BOX_SCALING, dict(prec="JACOBI"), 5),
    ("262701 box implicit LU_SGS", BOX_TIER, {}, 3),
    ("136161 box 3 species implicit LU_SGS", BOX_SCALING,
     dict(species="3"), 5),
    ("136161 box laminar implicit LU_SGS", BOX_SCALING,
     dict(laminar=True), 3))


# the block widths K5 and K6 run through their run-time-width instance
# (the flow's nDim + nSpecies + 2 from 4 to 21 but the compiled 7, 8, 13,
# 14), their band systems' offsets (the channel's 4 at odd widths, the
# box's 6 at even ones, 8 at 21: the f64 staging past the 48 KB a launch
# gets unasked) and the widths whose times the widths phase takes
RUNTIME_WIDTHS = tuple(v for v in range(4, 22) if v not in (7, 8, 13, 14))
RUNTIME_TIMED = ("band9", "band10", "band21")
BOX_BAND = (-400, -20, -1, 1, 20, 400)


def band_offsets(v):
    if v == 21:
        return (-9, -8, -7, -1, 1, 7, 8, 9)
    return BOX_BAND if v % 2 == 0 else (-9, -1, 1, 9)


# the implicit flow (MUSCL + Venkatakrishnan) at 5 species (make_case's
# species "5": the flow's v = 9 on the channel and 10 on the box, K5/K6
# through their run-time-width instance) in su2_tpu's tiers: label ->
# (SIZES key or box_mesh shape, make_case keywords, slice iterations, K5/K6
# launches per iteration where stencil_per_iter does not give them); the
# channel with LU_SGS at each size (K6's mixed one-launch cycle at 9,072,
# K5's mixed sweep past it, K7 at TIER_N), with ILU0, BCGSTAB (K5's
# sweep-only and matvec-only forms, both systems: 2 (2m + 2m + 1)) and
# LINELET (the flow's matvec, the SST's K6) and laminar at 9,072; the box
# at 8,000 (K6) and 136,161 (K5)
MIXTURE_PATHS = (
    ("5 species implicit LU_SGS", "flagship", {}, 5, None),
    ("5 species implicit ILU0", "flagship",
     dict(settings=dict(LINEAR_SOLVER_PREC="ILU0")), 3, None),
    ("5 species implicit BCGSTAB", "flagship",
     dict(settings=dict(LINEAR_SOLVER="BCGSTAB")), 3,
     {"stencil_fgmres": 0, "stencil_sgs_matvec": 2 * (4 * KRYLOV_M + 1)}),
    ("5 species implicit LINELET", "flagship",
     dict(settings=dict(LINEAR_SOLVER_PREC="LINELET")), 3,
     {"stencil_fgmres": 1, "stencil_sgs_matvec": KRYLOV_M}),
    ("5 species laminar implicit LU_SGS", "flagship", dict(laminar=True), 5,
     None),
    ("5 species implicit LU_SGS", "scaling", {}, 3, None),
    ("5 species implicit LU_SGS", "tier", {}, 2, None),
    ("3D box 5 species implicit LU_SGS", BOX_KERNELS, {}, 5, None),
    ("3D box 5 species implicit LU_SGS", BOX_SCALING, {}, 3, None))


T_START = time.perf_counter()
T_START_WALL = time.time()


def phase(name, msg):
    """One line of a phase, with the seconds since the script started."""
    print(f"[{name}] {msg} [+{time.perf_counter() - T_START:.1f} s]",
          flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


def demangle(sym):
    """su2k::name<args> of a mangled kernel symbol (float, double, bf16,
    integer and bool template arguments)."""
    m = re.match(r"_ZN4su2k(\d+)", sym)
    if not m:
        return sym
    i = m.end() + int(m.group(1))
    name, args = sym[m.end():i], []
    if sym[i:i + 1] == "I":
        i += 1
        while i < len(sym) and sym[i] != "E":
            if sym[i] in "fd":
                args.append("float" if sym[i] == "f" else "double")
                i += 1
            elif sym[i] == "L":
                j = sym.index("E", i)
                lit = sym[i + 1:j]
                if lit[0] != "b":
                    args.append(lit[1:])
                elif name == "node_state_kernel":
                    args.append("lite" if lit == "b1" else "full")
                else:
                    args.append("true" if lit == "b1" else "false")
                i = j + 1
            else:
                d = re.match(r"\d+", sym[i:]).group(0)
                k = i + len(d)
                args.append(sym[k:k + int(d)].replace("__nv_bfloat16",
                                                      "bf16"))
                i = k + int(d)
    return f"{name}<{', '.join(args)}>"


def ptxas_summary(log):
    """One line per compiled kernel: registers, and the stack frame and
    spill bytes (ptxas -v prints them before the registers)."""
    out, name, frame = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name, frame = demangle(line.split("'")[1]), ""
        elif "bytes stack frame" in line and name:
            frame = line.strip()
        elif "Used" in line and "registers" in line and name:
            regs, tail = line.split("Used")[1].split("registers", 1)
            out.append(f"{name}: {regs.strip()} registers, "
                       f"{tail.strip(', ')}" + (f"; {frame}" if frame else ""))
            name = None
    return out


# ptxas -v's line of each kernel in this run's build (main's; empty where
# the library had been built before)
PTXAS = {}
RT_TYPES = {"float64": ("double", "double"), "float32": ("float", "float"),
            "mixed": ("float", "bf16")}


def rt_kernel_lines(v, var):
    """The run-time kernels width v runs in tier var (its class's
    instances) with the registers, stack and spills ptxas gave them."""
    from su2_tpu_torch import kernels
    vb = kernels.stencil_instance(v, runtime=True)[1]
    t, s = RT_TYPES[var]
    names = (f"sgs_pass_rt_kernel<{t}, {s}, {vb}>",
             f"matvec_rt_kernel<{t}, {vb}>",
             f"fgmres_rt_kernel<{t}, {s}, {vb}>")
    return "; ".join(PTXAS.get(k, f"{k}: not in this run's build log")
                     for k in names)


def k5_form(v):
    """K5's run-time instance at width v as words."""
    from su2_tpu_torch import kernels
    return f"class {kernels.stencil_instance(v, runtime=True)[1]}"


def k6_form(plan):
    """K6's run-time plan as words (kernels.k6_plan)."""
    return (f"class {plan.vb}, {plan.form}"
            + (f" ({plan.gpb} groups a block)" if plan.res else "")
            + f", grid {plan.grid}, {plan.smem} B shared")


def cuda_time(fn, reps=20, warm=3):
    """Median milliseconds of fn() over reps launches (CUDA events)."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def compare(name, dt, got, want, per_row=False):
    """(max abs error, max error relative to its field's max|plain|) of
    got vs want within TOL; raises if outside."""
    import torch
    rtol, afrac = TOL[(name, dt)]
    worst = scaled = 0.0
    for g, w in zip(got, want):
        if w.dtype == torch.bool or g.dtype == torch.bool:
            if not torch.equal(g, w):
                raise AssertionError(f"{name} {dt}: nonphys flags differ")
            continue
        g = g.double()
        w = w.double()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name} {dt}: non-finite kernel output")
        err = (g - w).abs()
        if per_row:
            scale = w.abs().flatten(1).amax(1).clamp(min=1e-300)
            bound = afrac * scale.reshape((-1,) + (1,) * (w.ndim - 1))
        else:
            bound = rtol * w.abs() + afrac * w.abs().max()
        if not bool((err <= bound).all()):
            raise AssertionError(
                f"{name} {dt}: max err {err.max().item():.3e} outside "
                f"rtol {rtol} atol {afrac}*scale")
        worst = max(worst, err.max().item())
        scaled = max(scaled, err.max().item()
                     / max(w.abs().max().item(), 1e-300))
    return worst, scaled


def make_case(tmp, nx, ny, dtype, device, prec="LU_SGS",
              total_conditions=False, implicit=None, laminar=False,
              tri=False, settings=None, nz=None, box=False, species=None):
    """The synthetic case on channel_mesh(nx, ny); implicit: (muscl,
    limiter) of the implicit-flow variant, whose flow and SST systems are
    solved with prec as well; laminar: KIND_TURB_MODEL= NONE; tri: on
    cases.tri_channel_mesh(nx, ny) (triangles, scrambled node order, no
    static stencil); nz: on cases.tet_box_mesh(nx, ny, nz) (tetrahedra,
    scrambled, no static stencil), with box on geometry.structured.
    box_mesh(nx, ny, nz) (hexahedra, a static stencil of 6 offsets), with
    cases.with_box_markers' walls; species "3": the 3-species mixture
    cases.SPECIES_3, "5": the case's first 5 species (both reactions;
    K10's run-time count), each in its own library directory; settings:
    {cfg key: value} lines added last."""
    from su2_tpu_torch import cases
    from su2_tpu_torch.config import Config
    from su2_tpu_torch.driver import Simulation
    from su2_tpu_torch.geometry.structured import box_mesh, channel_mesh
    mixture = {None: cases.SPECIES, "3": cases.SPECIES_3,
               "5": cases.SPECIES[:5]}[species]
    if species is not None:
        tmp = os.path.join(tmp, f"species{species}")
    text = cases.write_case(tmp, species=mixture).replace(
        "LINEAR_SOLVER_PREC= LU_SGS", f"LINEAR_SOLVER_PREC= {prec}")
    if total_conditions:
        text = cases.with_total_conditions(text)
    if implicit is not None:
        text = cases.with_implicit_flow(text, *implicit, prec=prec)
    if laminar:
        text = cases.with_laminar(text)
    text += "".join(f"\n{k}= {v}" for k, v in (settings or {}).items())
    raw = cases.tri_channel_mesh(nx, ny) if tri else channel_mesh(nx, ny)
    if nz is not None:
        text = cases.with_box_markers(text)
        raw = box_mesh(nx, ny, nz) if box else cases.tet_box_mesh(nx, ny, nz)
    return Simulation(Config(text=text), raw_mesh=raw, dtype=dtype,
                      device=device)


def kernel_inputs(sim, seed=0):
    """A mixed, reacting state at the case's shapes (numpy seed -> card):
    random T, P, velocity and composition, and random SST fields."""
    return state_inputs(sim.lib, sim.lay, sim.mesh.npoint, sim.dtype,
                        sim.tparams, seed)


def state_inputs(lib, lay, n, dtype, tparams, seed=0):
    """kernel_inputs for the library lib on the card at the layout lay and
    n nodes (tparams: the temperature bounds)."""
    import numpy as np
    import torch
    from su2_tpu_torch import state as st
    from su2_tpu_torch.chemistry import library as cl
    rng = np.random.default_rng(seed)
    kw = dict(dtype=dtype, device="cuda")
    t = torch.as_tensor(rng.uniform(500.0, 2500.0, n)).to(**kw)
    p = torch.as_tensor(rng.uniform(0.9e5, 1.2e5, n)).to(**kw)
    vel = torch.as_tensor(rng.normal(0.0, 20.0, (n, lay.ndim))).to(**kw)
    ys = torch.as_tensor(rng.dirichlet(np.full(lay.ns, 0.5), n)).to(**kw)
    rho = p / (cl.mixture_rgas(lib, ys) * t)
    e = cl.mixture_enthalpy_plain(lib, t, ys) - cl.mixture_rgas(lib, ys) * t
    u = torch.cat([rho[:, None], rho[:, None] * vel,
                   (rho * (e + 0.5 * (vel * vel).sum(1)))[:, None],
                   rho[:, None] * ys], dim=1)
    u[7, lay.RHOS] = -1e-4 * rho[7]          # flagged: negative rho_s
    t_guess = t * torch.as_tensor(1.0 + 0.02 * rng.standard_normal(n)).to(**kw)
    tke = torch.as_tensor(rng.uniform(0.0, 5.0, n)).to(**kw)
    omt = torch.as_tensor(rng.uniform(1.0, 1e4, n)).to(**kw)
    mu_t = torch.as_tensor(rng.uniform(1e-5, 1e-3, n)).to(**kw)
    grad_tke = torch.as_tensor(rng.normal(0.0, 10.0, (n, lay.ndim))).to(**kw)
    sigma_k = torch.as_tensor(rng.uniform(0.85, 1.0, n)).to(**kw)
    return dict(u=u, t_guess=t_guess, tke=tke, omt=omt, mu_t=mu_t,
                grad_tke=grad_tke, sigma_k=sigma_k,
                p=st.TSolveParams(tmin=tparams.tmin, tmax=tparams.tmax))


def kernel_phase(tmp, dtype_name, report):
    import torch
    from su2_tpu_torch import kernels, state as st
    from su2_tpu_torch.chemistry import library as cl
    from su2_tpu_torch.ops import edge_flux as ef, viscous as vis
    from su2_tpu_torch.solvers import euler as es
    dtype = getattr(torch, dtype_name)
    sim = make_case(tmp, *SIZES["flagship"], dtype, "cuda")
    lib, lay, mesh, prm = sim.lib, sim.lay, sim.mesh, sim.params
    x = kernel_inputs(sim)
    p = x["p"]
    nsd = st.node_state_plain(lib, lay, x["u"], x["t_guess"], p, x["tke"])
    v = nsd.v
    tt, rho, ys = v[:, lay.T], v[:, lay.PRHO], v[:, lay.YS:lay.YS + lay.ns]
    nb = sim.bcs[-1].nodes.shape[0]     # a flux-BC marker's batch (T1)
    tb, yb = tt[:nb].contiguous(), ys[:nb].contiguous()
    grad = es.compute_gradients(mesh, prm,
                                vis.ns_gradient_vars(lib, lay, v, nsd.xs))
    turb = vis.TurbFlowData(tke=x["tke"], mu_t=x["mu_t"],
                            grad_tke=x["grad_tke"], sigma_k=x["sigma_k"])
    f_all = ef.stack_inputs(lay, v, grad, vis.Transport(nsd.mu, nsd.kappa),
                            turb, x["sigma_k"], nsd.dpdu[:, lay.RHOE])
    sc = ef.species_consts_of(lib)
    consts = (prm.m_infty, prm.prandtl_lam, prm.prandtl_turb, prm.lewis_turb)
    eargs = (lib, lay, sc, consts, f_all, mesh.fam_offsets, mesh.fam_normal,
             mesh.fam_evec)
    # inputs each call reads (the tables included), for the bytes bound
    node_tab = list(kernels._node_tables(lib))
    chem_tab = list(kernels._chem_tables(lib))
    inputs = {
        "mixture_enthalpy": [tb, yb, lib.h_y, lib.h_y2, lib.mm],
        "node_state": 2 * [x["u"], x["t_guess"], x["tke"]] + 2 * node_tab,
        "edge_flux": [f_all, mesh.fam_normal, mesh.fam_evec, lib.h_y,
                      lib.h_y2, lib.cp_y, lib.cp_y2, lib.mm, sc.sm_den],
        "chem_source": [tt, rho, ys, x["omt"], tt, rho, ys] + 2 * chem_tab,
    }
    # operations: conservative per-element counts read off the kernels'
    # sources (a lower bound, like the byte count)
    n, kh = mesh.npoint, len(mesh.fam_offsets)
    flops = {"mixture_enthalpy": 12 * lib.nspecies * nb,
             "node_state": 2 * 500 * n, "edge_flux": 2000 * kh * n,
             "chem_source": 2 * 600 * n}
    calls = {
        "mixture_enthalpy": (
            lambda: [kernels.mixture_enthalpy(lib, tb, yb)],
            lambda: [cl.mixture_enthalpy_plain(lib, tb, yb)], False),
        "node_state": (
            lambda: list(kernels.node_state(lib, lay, p, x["u"],
                                            x["t_guess"], x["tke"]))
            + list(kernels.node_state(lib, lay, p, x["u"], x["t_guess"],
                                      x["tke"], lite=True)),
            lambda: list(vars(st.node_state_plain(
                lib, lay, x["u"], x["t_guess"], p, x["tke"])).values())
            + list(vars(st.node_state_lite_plain(
                lib, lay, x["u"], x["t_guess"], p, x["tke"])).values()),
            False),
        "edge_flux": (lambda: list(kernels.edge_flux(*eargs)),
                      lambda: list(ef.edge_flux_plain(*eargs)), True),
        "chem_source": (
            lambda: [kernels.chem_source(lib, prm, tt, rho, ys, x["omt"]),
                     kernels.chem_source(lib, prm, tt, rho, ys, None)],
            lambda: [es.chemistry_source_plain(lib, prm, tt, rho, ys,
                                               x["omt"]),
                     es.chemistry_source_plain(lib, prm, tt, rho, ys, None)],
            False),
    }
    for name, (kfn, pfn, per_row) in calls.items():
        got, want = kfn(), pfn()
        torch.cuda.synchronize()
        if name == "edge_flux":
            got = [got[0].flatten(0, 1), got[1], got[2]]
            want = [want[0].flatten(0, 1), want[1], want[2]]
        err, scaled = compare(name, dtype_name, got, want, per_row)
        ms = cuda_time(kfn)
        plain_ms = cuda_time(pfn)
        bound = bound_of(nbytes(inputs[name] + got), flops[name], dtype_name)
        phase("kernels", f"{name} {dtype_name}: max_abs_err {err:.3e} "
              f"({scaled:.2e} of its field's max) kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} ms bound {bound[0]:.4f} ms "
              f"({bound[1]})")
        report.setdefault(name, {})[dtype_name] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
            bound_by=bound[1], library_ms=None)
    # T4's instances (kernels.CHEM_SHAPES): the case (9 species, above),
    # the case cut to 3 species (compiled) and to 5 (the run-time
    # instance), each on the primitive-row views and omega_t as a column
    # of a turbulence state, as the step passes them, PaSR on and off; the
    # wrapper puts one operation on the card (no copies)
    from su2_tpu_torch import cases
    turb = torch.stack([x["tke"], x["omt"]], dim=1)
    for ns in (lay.ns, 3, 5):
        libc = lib if ns == lay.ns else cases.species_cut(lib, ns)
        layc = st.Layout(lay.ndim, ns)
        rows = torch.zeros((n, layc.nprim), dtype=dtype, device="cuda")
        yc = ys[:, :ns] / ys[:, :ns].sum(dim=1, keepdim=True)
        rows[:, layc.T], rows[:, layc.PRHO], rows[:, layc.YS:] = tt, rho, yc
        views = (rows[:, layc.T], rows[:, layc.PRHO], rows[:, layc.YS:])
        kfn = lambda: [kernels.chem_source(libc, prm, *views, turb[:, 1]),
                       kernels.chem_source(libc, prm, *views, None)]
        got = kfn()
        want = [es.chemistry_source_plain(libc, prm, tt, rho, yc, x["omt"]),
                es.chemistry_source_plain(libc, prm, tt, rho, yc, None)]
        torch.cuda.synchronize()
        err, scaled = compare("chem_source", dtype_name, got, want)
        _, ops = call_profile(lambda: kernels.chem_source(
            libc, prm, *views, turb[:, 1]), reps=10)
        if ops != 1:
            raise AssertionError(f"chem_source: {ops} CUDA launches a call "
                                 "on row views, expected 1")
        report["chem_source"][f"shape {ns} species {dtype_name}"] = dict(
            max_abs_err=err, ms=cuda_time(kfn))
        inst = ("compiled" if (ns, libc.nreactions) in kernels.CHEM_SHAPES
                else "run-time")
        phase("kernels", f"chem_source {ns} species ({libc.nreactions} "
              f"reactions, {inst} instance) {dtype_name} on row views: "
              f"max_abs_err {err:.3e} "
              f"({scaled:.2e} of its field's max), {ops:.1f} CUDA "
              "launches a call")
    # bisection path and its flags (secant budget 1, far-off guess)
    if dtype_name == "float64":
        pb = st.TSolveParams(secant_iters=1, secant_tol=1e-30)
        tg = torch.full_like(x["t_guess"], 4999.0)
        got = list(kernels.node_state(lib, lay, pb, x["u"], tg, x["tke"]))
        want = list(vars(st.node_state_plain(lib, lay, x["u"], tg, pb,
                                             x["tke"])).values())
        err, scaled = compare("node_state", dtype_name, got, want)
        phase("kernels", f"node_state float64 bisection path: max_abs_err "
              f"{err:.3e} ({scaled:.2e} of its field's max)")
    # CLIPPING_TEMPRATURE: the guess 10 % off at every other node, where
    # the clip to [0.95, 1.05] t_guess binds; full and lite
    from dataclasses import replace
    pc = replace(p, clip_temp=True)
    tg = x["t_guess"] * torch.where(
        torch.arange(n, device="cuda") % 2 == 0, 1.1, 1.0).to(dtype)
    kfn = lambda: (list(kernels.node_state(lib, lay, pc, x["u"], tg,
                                           x["tke"]))
                   + list(kernels.node_state(lib, lay, pc, x["u"], tg,
                                             x["tke"], lite=True)))
    got = kfn()
    want = (list(vars(st.node_state_plain(lib, lay, x["u"], tg, pc,
                                          x["tke"])).values())
            + list(vars(st.node_state_lite_plain(lib, lay, x["u"], tg, pc,
                                                 x["tke"])).values()))
    torch.cuda.synchronize()
    err, scaled = compare("node_state", dtype_name, got, want)
    free = kernels.node_state(lib, lay, p, x["u"], tg, x["tke"])[1][:, 0]
    binds = int(((free - got[1][:, 0]).abs() > 1.0).sum())
    if not 0 < binds < n:
        raise AssertionError(f"node_state clip: binds at {binds} of {n}")
    ms = cuda_time(kfn)
    report["node_state"][f"clip {dtype_name}"] = dict(
        max_abs_err=err, ms=ms, nodes_clipped=binds)
    phase("kernels", f"node_state {dtype_name} with CLIPPING_TEMPRATURE "
          f"(binds at {binds} of {n} nodes), full + lite: max_abs_err "
          f"{err:.3e} ({scaled:.2e} of its field's max), {ms:.4f} ms")


def grad_operator(mesh, mode, dtype):
    """The gradient sweep as one (d n, n) CSR matrix (WLS, or GG with its
    boundary and volume terms folded in): row dd*n + p of A q is
    d(q)/dx_dd at p.  The yardstick of torch.sparse.mm, never called by the
    port."""
    import torch
    n, d = mesh.npoint, mesh.ndim
    gg = mode == "GG"
    coef = (mesh.gg_snormal if gg else mesh.wls_coeff).to(dtype)
    p = torch.arange(n, device=coef.device)
    inv = None
    if gg:
        vol = mesh.volume.to(dtype)
        inv = 1.0 / torch.where(vol > 0.0, vol, torch.ones_like(vol))
    diag = torch.zeros((d, n), dtype=dtype, device=coef.device)
    rows, cols, vals = [], [], []
    for k, o in enumerate(mesh.stencil_offsets):
        off = 0.5 * coef[k].T * inv if gg else coef[k].T
        diag = diag + off if gg else diag - off
        for dd in range(d):
            rows.append(dd * n + p)
            cols.append((p + int(o)) % n)
            vals.append(off[dd])
    if gg:
        diag = diag - mesh.bnd_accum_normal.to(dtype).T * inv
    for dd in range(d):
        rows.append(dd * n + p)
        cols.append(p)
        vals.append(diag[dd])
    idx = torch.stack([torch.cat(rows), torch.cat(cols)])
    return torch.sparse_coo_tensor(idx, torch.cat(vals), (d * n, n)
                                   ).coalesce().to_sparse_csr()


def tier_state(sim, dtype):
    """(mesh, lib, kernel_inputs, node state, flow gradient variables) of
    the case converted to dtype: K7's and K8's inputs."""
    from types import SimpleNamespace
    from su2_tpu_torch import state as st
    from su2_tpu_torch.ops import viscous as vis
    mesh, lib, lay = sim.mesh.to(dtype=dtype), sim.lib.to(dtype=dtype), \
        sim.lay
    x = kernel_inputs(SimpleNamespace(lib=lib, lay=lay, mesh=mesh,
                                      dtype=dtype, device=sim.device,
                                      tparams=sim.tparams))
    nsd = st.node_state(lib, lay, x["u"], x["t_guess"], x["p"],
                        turb_ke=x["tke"])
    q = vis.ns_gradient_vars(lib, lay, nsd.v, nsd.xs).contiguous()
    return mesh, lib, x, nsd, q


def edge_win_args(sim, mesh, lib, x, nsd, q):
    """kernels.edge_win's arguments (T3's too) on the tier's stack, built
    from K7's gradient rows of q."""
    from su2_tpu_torch.ops import edge_flux as ef, viscous as vis
    from su2_tpu_torch.solvers import euler as es
    lay, prm = sim.lay, sim.params
    rows = es.compute_gradient_rows(mesh, prm, q)
    turb = vis.TurbFlowData(tke=x["tke"], mu_t=x["mu_t"],
                            grad_tke=x["grad_tke"], sigma_k=x["sigma_k"])
    f_all = ef.stack_inputs(lay, nsd.v, None, vis.Transport(nsd.mu,
                                                            nsd.kappa),
                            turb, x["sigma_k"], nsd.dpdu[:, lay.RHOE],
                            grad_rows=rows)
    return (lib, lay, ef.species_consts_of(lib),
            (prm.m_infty, prm.prandtl_lam, prm.prandtl_turb, prm.lewis_turb),
            f_all, mesh.fam_offsets, mesh.fam_normal, mesh.fam_evec)


def tier_kernel_phase(sim, dtype_name, report):
    """K7 (WLS and GG), K8 and K9 against their plain versions at the
    shapes of the TIER_N-node case (its mesh and library converted to the
    dtype) on a random reacting state; K9 on a random inflow batch of the
    size of the case's inlet."""
    import numpy as np
    import torch
    from su2_tpu_torch import kernels
    from su2_tpu_torch.ops import edge_flux as ef, gradients_tiled as tg
    from su2_tpu_torch.solvers import inlet_tc as itc
    dtype = getattr(torch, dtype_name)
    mesh, lib, x, nsd, q = tier_state(sim, dtype)
    n, d, ng = mesh.npoint, mesh.ndim, q.shape[1]
    kk = len(mesh.stencil_offsets)

    def record(name, key, got, want, kfn, pfn, ins, nflop, per_row=False,
               lib_ms=None, extra=""):
        err, scaled = compare(name, dtype_name, got, want, per_row)
        ms, plain_ms = cuda_time(kfn), cuda_time(pfn)
        bound = bound_of(nbytes(ins + got), nflop, dtype_name)
        lib_txt = "" if lib_ms is None else f" library {lib_ms:.4f} ms"
        phase("kernels", f"{name} {key}: max_abs_err {err:.3e} "
              f"({scaled:.2e} of its field's max) kernel {ms:.4f} ms plain "
              f"{plain_ms:.4f} ms bound {bound[0]:.4f} ms ({bound[1]})"
              f"{lib_txt}{extra}")
        report.setdefault(name, {})[key] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
            bound_by=bound[1], library_ms=lib_ms)

    # K7: the flow gradient set's rows, both methods
    for mode in ("WLS", "GG"):
        gg = mode == "GG"
        kfn = lambda: [tg.gradient_rows(mesh, q, mode)]
        pfn = lambda: [tg.gradient_rows_plain(mesh, q, mode)]
        got, want = kfn(), pfn()
        torch.cuda.synchronize()
        op = grad_operator(mesh, mode, dtype)
        lib_ms = cuda_time(lambda: torch.sparse.mm(op, q))
        ref = torch.sparse.mm(op, q).reshape(d, n, ng).permute(2, 0, 1)
        dev = ((ref.reshape(ng * d, n) - want[0]).abs().max()
               / want[0].abs().max()).item()
        if dtype == torch.float64 and not dev < 1e-9:
            raise AssertionError(f"K7 {mode}: the sparse operator is off by "
                                 f"{dev:.2e} of the max")
        ins = [q, mesh.gg_snormal if gg else mesh.wls_coeff] + (
            [mesh.bnd_accum_normal, mesh.volume] if gg else [])
        plan = kernels.k7_plan(n, ng, mesh.stencil_offsets,
                               q.element_size())
        record("gradient_rows", f"{dtype_name} {mode}", got, want, kfn, pfn,
               ins, 3 * kk * d * ng * n + (3 * d * ng * n if gg else 0),
               lib_ms=lib_ms, extra=f" ({plan.form}, window {plan.window}; "
               f"torch.sparse.mm CSR, off by {dev:.1e} of the max)")
    # K7's other forms and instances at this node count: the channel's
    # sweep forced to the streamed form (kernels.k7_plan's keyword), a 3D
    # box's six offsets (87 x 65 x 100 nodes: no window fits, the plan
    # streams; compiled) and eight 2D offsets (the channel's and its
    # diagonals: the run-time-K instance, windowed), the latter two on
    # random coefficients, volumes and boundary normals; each wrapper call
    # one operation on the card (no transpose)
    from types import SimpleNamespace
    rng = np.random.default_rng(9)
    t = lambda a: torch.as_tensor(a).to(sim.device, dtype)

    def synth(offs, dd):
        return SimpleNamespace(
            npoint=n, ndim=dd, stencil_offsets=offs,
            wls_coeff=t(rng.standard_normal((len(offs), n, dd))),
            gg_snormal=t(rng.standard_normal((len(offs), n, dd))),
            bnd_accum_normal=t(rng.standard_normal((n, dd))),
            volume=t(rng.uniform(0.5, 2.0, n)))

    ny = int(mesh.stencil_offsets[-1])
    for label, m, window in (
            ("channel streamed", mesh, 0),
            ("3D box", synth((-6500, -100, -1, 1, 100, 6500), 3), None),
            ("8 offsets", synth((-ny - 1, -ny, -ny + 1, -1, 1, ny - 1, ny,
                                 ny + 1), 2), None)):
        dd, kk = m.ndim, len(m.stencil_offsets)
        plan = kernels.k7_plan(n, ng, m.stencil_offsets, q.element_size(),
                               window)
        for mode in ("WLS", "GG"):
            gg = mode == "GG"
            coef = m.gg_snormal if gg else m.wls_coeff
            extra = (m.bnd_accum_normal, m.volume) if gg else ()
            kfn = lambda: [kernels.gradient_rows(q, coef, m.stencil_offsets,
                                                 *extra, window=window)]
            pfn = lambda: [tg.gradient_rows_plain(m, q, mode)]
            got, want = kfn(), pfn()
            torch.cuda.synchronize()
            _, ops = call_profile(kfn, reps=10)
            if ops != 1:
                raise AssertionError(f"K7 {label}: {ops} CUDA launches a "
                                     "call, expected 1")
            record("gradient_rows", f"{dtype_name} {mode} {label}", got,
                   want, kfn, pfn, [q, coef, *extra],
                   3 * kk * dd * ng * n + (3 * dd * ng * n if gg else 0),
                   extra=f" ({plan.form}, window {plan.window}; {ops:.1f} "
                         "CUDA launches a call)")
    # K8: the stack of the tier's main path, from K7's rows
    eargs = edge_win_args(sim, mesh, lib, x, nsd, q)
    f_all, sc = eargs[4], eargs[2]
    rowwise = lambda r: [r[0], r[1][None], r[2][None]]
    kfn = lambda: rowwise(kernels.edge_win(*eargs))
    pfn = lambda: rowwise(ef.edge_win_plain(*eargs))
    got, want = kfn(), pfn()
    torch.cuda.synchronize()
    kh = len(mesh.fam_offsets)
    # K8 evaluates every family slot's edge once (T3's slot pass), then
    # sums per node; beside it T3 and the torch roll-subtract
    t3_ms = cuda_time(lambda: ef.roll_subtract(
        mesh.fam_offsets, *kernels.edge_flux(*eargs)))
    record("edge_win", dtype_name, got, want, kfn, pfn,
           [f_all, mesh.fam_normal, mesh.fam_evec, lib.h_y, lib.h_y2,
            lib.cp_y, lib.cp_y2, lib.mm, sc.sm_den], 2000 * kh * n,
           per_row=True,
           extra=f" ({kh * n} edge evaluations per call; T3 + "
                 f"roll-subtract at these shapes {t3_ms:.4f} ms)")
    report["edge_win"]["edge_evaluations_per_call"] = kh * n
    # K9 (k9_inputs), inlet-sized
    for sec in ((15, 1) if dtype == torch.float64 else (15,)):
        tcs, tcx = k9_inputs(sim, lib, mesh, dtype, sec)
        nv = tcx[0].shape[0]
        kfn = lambda: [itc.solve(tcs, *tcx)]
        pfn = lambda: [itc.solve_plain(tcs, *tcx)]
        got, want = kfn(), pfn()
        torch.cuda.synchronize()
        # operations: a lower bound of two spline evaluations (~30
        # operations each) per vertex; the iterations depend on the data
        record("inlet_tc", dtype_name if sec == 15
               else f"{dtype_name} bisection path", got, want, kfn, pfn,
               tcx + [tcs.y, tcs.y2], 60 * nv,
               extra=f" ({nv} vertices, secant budget {sec})")


def k9_inputs(sim, lib, mesh, dtype, sec):
    """K9's arguments (itc.solve's): the TOTAL_CONDITIONS inlet at TC_T_TOT
    of the first species with a secant budget of sec, and a random inflow
    batch (Riemann invariant, gamma, flow angle) about the 600 K fuel
    stream (the distribution of tests/test_torch_inlet_tc.py), one value
    for each vertex of mesh's inlet."""
    import dataclasses
    import numpy as np
    import torch
    from su2_tpu_torch.solvers import inlet_tc as itc
    nv = int(mesh.markers["inlet"][0].shape[0])
    rng = np.random.default_rng(4)
    gamma = rng.uniform(1.06, 1.2, nv)
    a = np.sqrt(gamma * float(lib.ri[0]) * rng.uniform(450.0, 650.0, nv))
    rm = rng.uniform(-40.0, 0.0, nv) + 2.0 * a / (gamma - 1.0)
    rm[: nv // 4] *= rng.uniform(0.5, 1.5, nv // 4)
    al = rng.uniform(-1.0, -0.8, nv)
    tcx = [torch.as_tensor(v).to(sim.device, dtype) for v in (rm, gamma, al)]
    tc = itc.total_conditions_t(lib, np.eye(lib.nspecies)[0], TC_T_TOT)
    return dataclasses.replace(tc, sec_iters=sec), tcx


def dim_tag(lay):
    """The report keys' mark of a 3D layout, with its species count where
    it is not the case's 9 ("" in 2D, whose keys predate 3D)."""
    if lay.ndim != 3:
        return ""
    return " 3D" + ("" if lay.ns == 9 else f" {lay.ns} species")


def k10_rows_read(lay, muscl, limiter):
    """Rows of the implicit stack (edge_implicit.implicit_rows) that K10
    reads in the variant: with MUSCL not the dP/dU rows (the face state
    recomputes dP/dU), without the limiter not its rows, and at first
    order not the pressure gradient (only the reconstruction reads it)."""
    from su2_tpu_torch.ops import edge_implicit as ei
    r, nd = ei.implicit_rows(lay), lay.ndim
    rows = r["total"]
    if muscl:
        rows -= lay.nvar
    else:
        rows -= nd
    if not limiter:
        rows -= 2 + nd
    return rows


def k10_inputs(sim, dtype):
    """K10's inputs at the shapes of the implicit case sim (its mesh and
    library converted to dtype) on a random reacting state (kernel_inputs):
    (mesh, lib, species consts, whether the stack's gradients are K7's
    rows, args_of) with args_of(variant name) kernels.edge_implicit's
    arguments for that (MUSCL, limiter) variant.  In the >= 200k-node tier
    the stack's gradients are K7's rows, as ns_assemble builds it."""
    from types import SimpleNamespace
    from su2_tpu_torch import state as st
    from su2_tpu_torch.ops import edge_flux as ef, edge_implicit as ei
    from su2_tpu_torch.ops import gradients, limiters, viscous as vis
    from su2_tpu_torch.solvers import euler as es
    mesh, lib = sim.mesh.to(dtype=dtype), sim.lib.to(dtype=dtype)
    lay, prm = sim.lay, sim.params
    x = kernel_inputs(SimpleNamespace(lib=lib, lay=lay, mesh=mesh,
                                      dtype=dtype, device=sim.device,
                                      tparams=sim.tparams))
    nsd = st.node_state(lib, lay, x["u"], x["t_guess"], x["p"],
                        turb_ke=x["tke"])
    v = nsd.v
    nd = lay.ndim
    qg = vis.ns_gradient_vars(lib, lay, v, nsd.xs)
    grad = grad_rows = None
    if gradients.use_tiled(mesh):
        grad_rows = es.compute_gradient_rows(mesh, prm, qg)
        g = gradients.rows_to_grad(grad_rows[:(2 + nd) * nd], 2 + nd, nd)
    else:
        grad = es.compute_gradients(mesh, prm, qg)
        g = grad[:, :2 + nd]
    q = es.gradient_vars(lay, v)
    lims = {"VENKATAKRISHNAN": limiters.venkatakrishnan(
        mesh, q, g, prm.limiter_coeff, prm.ref_elem_length),
        "BARTH_JESPERSEN": limiters.barth_jespersen(mesh, q, g)}
    turb = vis.TurbFlowData(tke=x["tke"], mu_t=x["mu_t"],
                            grad_tke=x["grad_tke"], sigma_k=x["sigma_k"])
    trans = vis.Transport(nsd.mu, nsd.kappa)
    sc = ef.species_consts_of(lib)

    def args_of(name):
        muscl, limiter = IMPLICIT_VARIANTS[name]
        f_all = ei.stack_inputs(lay, v, grad, lims.get(limiter), trans,
                                turb, x["sigma_k"], nsd.dtdu, nsd.dpdu,
                                grad_rows=grad_rows)
        return (lib, lay, sc, (prm.m_infty, prm.prandtl_turb,
                               prm.lewis_turb), f_all, mesh.fam_offsets,
                mesh.fam_normal, mesh.fam_evec, muscl, limiter is not None)
    return mesh, lib, sc, grad is None, args_of


def implicit_kernel_phase(sim, dtype_name, report, variants,
                          plain_reps=5):
    """K10 against its plain version at the shapes of the implicit case sim
    (k10_inputs): per output row of every family, the pad slots exactly
    0; the plain version timed over plain_reps calls."""
    import torch
    from su2_tpu_torch import kernels
    from su2_tpu_torch.ops import edge_implicit as ei
    dtype = getattr(torch, dtype_name)
    mesh, lib, sc, from_rows, args_of = k10_inputs(sim, dtype)
    lay = sim.lay
    n, kh = mesh.npoint, len(mesh.fam_offsets)
    nvar, ns = lay.nvar, lay.ns
    pad = (mesh.fam_normal == 0).all(-1)                  # (Kh, N)
    # operations per slot, a lower bound read off the kernel: about 8 per
    # entry of the two Jacobian blocks, the Stefan-Maxwell Gauss-Jordan,
    # and the dJ/dr species blocks (about 8 per entry, for the species
    # rows and for the density and energy rows of both sides)
    flops = kh * n * (16 * nvar * nvar + 2 * ns * ns * (ns + 1)
                      + 64 * ns * ns)
    for name in variants:
        muscl, limiter = IMPLICIT_VARIANTS[name]
        args = args_of(name)
        f_all = args[4]
        rows = lambda out: [t.flatten(0, 1) for t in out]
        kfn = lambda: rows(kernels.edge_implicit(*args))
        pfn = lambda: rows(ei.edge_implicit_plain(*args))
        got, want = kfn(), pfn()
        torch.cuda.synchronize()
        err, scaled = compare("edge_implicit", dtype_name, got, want,
                              per_row=True)
        for t in got:
            if not bool((t.reshape(kh, -1, n).permute(1, 0, 2)[:, pad]
                         == 0).all()):
                raise AssertionError(f"K10 {name} {dtype_name}: nonzero "
                                     "output on a pad slot")
        ms, plain_ms = cuda_time(kfn), cuda_time(pfn, reps=plain_reps)
        # the stack's bytes: only the rows this variant reads
        ins = [mesh.fam_normal, mesh.fam_evec, lib.h_y, lib.h_y2,
               lib.cp_y, lib.cp_y2, lib.mm, sc.sm_den, lib.ri]
        stack = k10_rows_read(lay, muscl, limiter) * n * f_all.element_size()
        bound = bound_of(stack + nbytes(ins + got), flops, dtype_name)
        key = f"{dtype_name} {n}{dim_tag(lay)} {name}"
        phase("k10", f"edge_implicit {key}: max_abs_err {err:.3e} "
              f"({scaled:.2e} of its row's max) kernel {ms:.4f} ms plain "
              f"{plain_ms:.4f} ms bound {bound[0]:.4f} ms ({bound[1]}); "
              f"one launch for {kh} families, pad slots exactly 0"
              + ("; the stack's gradients from K7's rows" if from_rows
                 else ""))
        report.setdefault("edge_implicit", {})[key] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
            bound_by=bound[1], library_ms=None)


def k11_inputs(sim, dtype_name):
    """K11's arguments on the family-slot inputs of the laminar implicit
    case sim (its mesh and library converted to the dtype): the limited
    MUSCL face states of a random reacting state, as
    convective_system_fam builds them, feature-major (the main path);
    (lay, [v_i, v_j, normals, s_i, s_j], M_inf, family slots, operations,
    pad-slot mask)."""
    from types import SimpleNamespace
    import torch
    from su2_tpu_torch import state as st
    from su2_tpu_torch.ops import limiters, viscous as vis
    from su2_tpu_torch.solvers import euler as es
    dtype = getattr(torch, dtype_name)
    mesh, lib = sim.mesh.to(dtype=dtype), sim.lib.to(dtype=dtype)
    lay, prm = sim.lay, sim.params
    x = kernel_inputs(SimpleNamespace(lib=lib, lay=lay, mesh=mesh,
                                      dtype=dtype, device=sim.device,
                                      tparams=sim.tparams))
    nsd = st.node_state(lib, lay, x["u"], x["t_guess"], x["p"])
    nd = lay.ndim
    grad = es.compute_gradients(mesh, prm, vis.ns_gradient_vars(
        lib, lay, nsd.v, nsd.xs))[:, :2 + nd]
    lim = limiters.venkatakrishnan(mesh, es.gradient_vars(lay, nsd.v), grad,
                                   prm.limiter_coeff, prm.ref_elem_length)
    v_i, s_i, v_j, s_j = es.muscl_reconstruct_fam(
        lib, lay, mesh, prm, nsd.v, grad.permute(1, 2, 0), lim)
    ins = [v_i, v_j, mesh.fam_normal_flat.T.contiguous(), s_i, s_j]
    ne, nv = v_i.shape[1], lay.nvar
    # operations per edge, a lower bound read off the kernel: ~500 for the
    # flux and the 4 nVar column vectors, ~8 per entry of the two blocks
    flops = ne * (500 + 16 * nv * nv)
    return lay, ins, prm.m_infty, ne, flops, ~mesh.fam_valid_flat


def k11_rows(out, nv, ne):
    """K11's outputs (feature-major) as rows: the flux rows, each entry
    of the two Jacobians."""
    return [out[0], out[1].reshape(nv * nv, ne), out[2].reshape(nv * nv, ne)]


def ausm_kernel_phase(sim, dtype_name, report):
    """K11 against its plain version (ops/ausm_t.ausm_flux_t) on
    k11_inputs, in the feature-major layout of the main path
    (edge_kernels.py:91) and the edge-major one (:34); per output row,
    the pad slots exactly 0."""
    import torch
    from su2_tpu_torch import kernels
    from su2_tpu_torch.ops import ausm_t
    lay, ins, m_inf, ne, flops, pad = k11_inputs(sim, dtype_name)
    ins_e = [t.T.contiguous() for t in ins]
    rows = lambda out: k11_rows(out, lay.nvar, ne)
    want = ausm_t.ausm_flux_t(lay, *ins[:3], m_inf, *ins[3:])
    for layout, edge_major in (("feature-major", False),
                               ("edge-major", True)):
        args = ins_e if edge_major else ins
        kfn = lambda: kernels.ausm_flux_jac(lay, *args[:3], m_inf, *args[3:],
                                            edge_major=edge_major)
        out = kfn()
        if edge_major:
            out = (out[0].T, out[1].permute(1, 2, 0), out[2].permute(1, 2, 0))
        got = rows(out)
        torch.cuda.synchronize()
        err, scaled = compare("ausm_flux_jac", dtype_name, got, rows(want),
                              per_row=True)
        for t in got:
            if not bool((t[:, pad] == 0).all()):
                raise AssertionError(f"K11 {layout} {dtype_name}: nonzero "
                                     "output on a pad slot")
        ms = cuda_time(kfn)
        plain_ms = cuda_time(lambda: ausm_t.ausm_flux_t(
            lay, *ins[:3], m_inf, *ins[3:]))
        bound = bound_of(nbytes(ins + got), flops, dtype_name)
        key = f"{dtype_name} {sim.mesh.npoint}{dim_tag(lay)} {layout}"
        phase("k11", f"ausm_flux_jac {key}: max_abs_err {err:.3e} "
              f"({scaled:.2e} of its row's max) kernel {ms:.4f} ms plain "
              f"{plain_ms:.4f} ms bound {bound[0]:.4f} ms ({bound[1]}); "
              f"{ne} family slots, {int(pad.sum())} pad slots exactly 0")
        report.setdefault("ausm_flux_jac", {})[key] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
            bound_by=bound[1], library_ms=None)


def k11_edge_inputs(sim, dtype_name):
    """K11's arguments on the edge rows of the triangle channel's implicit
    case sim (no static stencil; its mesh and library converted to the
    dtype): euler.edge_faces of a random reacting state (limited MUSCL
    face states over the edge list), feature-major, as
    euler.convective_system passes them; (lay, [v_i, v_j, normals, s_i,
    s_j], M_inf, edges, operations)."""
    from types import SimpleNamespace
    import torch
    from su2_tpu_torch import state as st
    from su2_tpu_torch.ops import limiters, viscous as vis
    from su2_tpu_torch.solvers import euler as es
    dtype = getattr(torch, dtype_name)
    mesh, lib = sim.mesh.to(dtype=dtype), sim.lib.to(dtype=dtype)
    lay, prm = sim.lay, sim.params
    x = kernel_inputs(SimpleNamespace(lib=lib, lay=lay, mesh=mesh,
                                      dtype=dtype, device=sim.device,
                                      tparams=sim.tparams))
    nsd = st.node_state(lib, lay, x["u"], x["t_guess"], x["p"])
    grad = es.compute_gradients(mesh, prm, vis.ns_gradient_vars(
        lib, lay, nsd.v, nsd.xs))
    lim = limiters.venkatakrishnan(mesh, es.gradient_vars(lay, nsd.v),
                                   grad[:, :2 + lay.ndim], prm.limiter_coeff,
                                   prm.ref_elem_length)
    v_i, v_j, s_i, s_j = es.edge_faces(lib, lay, mesh, prm, nsd.v, grad, lim,
                                       nsd.dpdu)
    ins = [v_i, v_j, mesh.edge_normal.T.contiguous(), s_i.contiguous(),
           s_j.contiguous()]
    ne, nv = mesh.nedge, lay.nvar
    # operations per edge as k11_inputs counts them
    return lay, ins, prm.m_infty, ne, ne * (500 + 16 * nv * nv)


def ausm_edge_phase(sim, dtype_name, report):
    """K11 against its plain version (ops/ausm_t.ausm_flux_t) on the edge
    rows of the triangle channel's implicit case (k11_edge_inputs), the
    feature-major layout of euler.convective_system; per output row, with
    times and the bound."""
    import torch
    from su2_tpu_torch import kernels
    from su2_tpu_torch.ops import ausm_t
    lay, ins, m_inf, ne, flops = k11_edge_inputs(sim, dtype_name)
    rows = lambda out: k11_rows(out, lay.nvar, ne)
    want = ausm_t.ausm_flux_t(lay, *ins[:3], m_inf, *ins[3:])
    kfn = lambda: kernels.ausm_flux_jac(lay, *ins[:3], m_inf, *ins[3:])
    got = rows(kfn())
    torch.cuda.synchronize()
    err, scaled = compare("ausm_flux_jac", dtype_name, got, rows(want),
                          per_row=True)
    ms = cuda_time(kfn)
    plain_ms = cuda_time(lambda: ausm_t.ausm_flux_t(
        lay, *ins[:3], m_inf, *ins[3:]))
    bound = bound_of(nbytes(ins + got), flops, dtype_name)
    key = f"{dtype_name} {sim.mesh.npoint}{dim_tag(lay)} edge rows"
    shape = "triangle channel" if lay.ndim == 2 else "tet box"
    phase("k11", f"ausm_flux_jac {key} ({shape}, {ne} edges): "
          f"max_abs_err {err:.3e} ({scaled:.2e} of its row's max) kernel "
          f"{ms:.4f} ms plain {plain_ms:.4f} ms bound {bound[0]:.4f} ms "
          f"({bound[1]})")
    report.setdefault("ausm_flux_jac", {})[key] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
        bound_by=bound[1], library_ms=None)


def sst_inputs(sim, steps=3):
    """The arguments of the fused SST assembly in the steps-th coupled step
    of sim from the freestream state: the steps before it unfused, that
    one with the fused mode on."""
    from su2_tpu_torch.turbulence import sst, sst_assemble as sa
    state = (sim.u0, sim.t0) + tuple(sim.initial_turb_state())
    for _ in range(steps - 1):
        state = sim._step(*state)[:6]
    rec, orig = [], sa.sst_assemble
    sa.sst_assemble = lambda *a: rec.append(a) or orig(*a)
    sst.set_assemble_mode("fused")
    try:
        sim._step(*state)
    finally:
        sa.sst_assemble = orig
        sst.set_assemble_mode("unfused")
    return rec[0]


def sst_kernel_phase(sim, dtype_name, report):
    """K12 against its plain version (turbulence/sst_assemble.
    assemble_plain) on the SST inputs of sim's third coupled step (its
    real wall rows): per output row against the row's max, with times."""
    import torch
    from su2_tpu_torch.turbulence import sst_assemble as sa
    args = sst_inputs(sim)
    mesh, wall = args[0], args[12]
    n, k = mesh.npoint, len(mesh.stencil_offsets)
    kfn = lambda: list(sa.sst_assemble(*args))
    pfn = lambda: list(sa.assemble_plain(*args))
    got, want = kfn(), pfn()
    torch.cuda.synchronize()
    err, scaled = compare("sst_assemble", dtype_name, got, want, per_row=True)
    if not bool((got[0][:, wall] == 0).all()) \
            or not bool((got[2][:, wall] == 0).all()):
        raise AssertionError(f"K12 {dtype_name}: a wall row's residual or "
                             "off-diagonal block is not 0")
    ms, plain_ms = cuda_time(kfn), cuda_time(pfn)
    bound = k12_bound(args, got, dtype_name)
    key = f"{dtype_name} {n}"
    phase("k12", f"sst_assemble {key}: max_abs_err {err:.3e} ({scaled:.2e} "
          f"of its field's max; each row within {TOL[('sst_assemble', dtype_name)][1]}"
          f" of its max) kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
          f"{bound[0]:.4f} ms ({bound[1]}); {int(wall.sum())} wall rows, "
          f"K = {k}")
    report.setdefault("sst_assemble", {})[key] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
        bound_by=bound[1], library_ms=None)


def k12_bound(args, got, dtype_name):
    """bound_of K12 on sst_assemble's arguments args and outputs got.
    Bytes: each field as the kernel reads it (rho and the velocity are
    columns of the primitive rows: their n and n d values), the mesh's
    volume, coordinates and stencil geometry, the outputs; operations: a
    lower bound read off the kernel, ~90 per offset and ~50 per node."""
    mesh = args[0]
    n, k = mesh.npoint, len(mesh.stencil_offsets)
    ins = list(args[2:16]) + [mesh.volume, mesh.coords, mesh.gg_snormal,
                              mesh.stencil_pvec]
    return bound_of(nbytes(ins + got), n * (90 * k + 50), dtype_name)


def k13_phase(sim, dtype_name, report):
    """K13 on sim's triangle mesh from a mixed reacting state (k13_state),
    the stack node-major as the main path holds it: the edge pass
    (kernels.edge_list_flux) against edge_list_flux_plain and the call
    (kernels.edge_list_terms: the edge pass, then the node sums) against
    edge_list_terms_plain, per output row against the row's max; the node
    sums (kernels.edge_list_sums) equal to mesh.scatter_edges_mixed of the
    pass's rows bit for bit; the call's CUDA launches (2).  Times, bounds,
    and torch.sparse.mm of the signed incidence (N x E, CSR) with the flux
    rows beside the sums (device ms: --time-kernels --only K13, in a
    process of its own)."""
    import torch
    from su2_tpu_torch import kernels
    from su2_tpu_torch.ops import edge_flux as ef
    lib, lay, mesh = sim.lib, sim.lay, sim.mesh
    nv, n, ne = lay.nvar, mesh.npoint, mesh.nedge
    state = k13_state(sim)
    args = k13_args(sim, state, True)
    f_nodes = args[4].T
    call_args = args[:4] + (f_nodes, mesh)
    kernels.reset_launches()
    got = list(kernels.edge_list_flux(*args))
    want = list(ef.edge_list_flux_plain(*args))
    got_call = list(kernels.edge_list_terms(*call_args))
    want_call = list(ef.edge_list_terms_plain(*call_args))
    torch.cuda.synchronize()
    launched = (kernels.launches["edge_list_flux"],
                kernels.launches["edge_list_sum"])
    if launched != (2, 1):
        raise AssertionError(f"K13: edge pass and sums launched {launched} "
                             "times, expected (2, 1)")
    # one row each for lc and lv
    rows3 = lambda o: [o[0], o[1][None], o[2][None]]
    err_pass, _ = compare("edge_list_flux", dtype_name, rows3(got),
                          rows3(want), per_row=True)
    err, scaled = compare("edge_list_flux", dtype_name,
                          rows3([got_call[0].T] + got_call[1:]),
                          rows3([want_call[0].T] + want_call[1:]),
                          per_row=True)
    rows = torch.cat([got[0].T, got[1][:, None], got[2][:, None]], 1)
    sums = kernels.edge_list_sums(mesh, rows)
    res, lams = mesh.scatter_edges_mixed(rows[:, :nv], rows[:, nv:])
    for name, a, b in (("res", sums[0], res), ("lc", sums[1], lams[:, 0]),
                       ("lv", sums[2], lams[:, 1]),
                       ("the call", got_call[0], res)):
        if not torch.equal(a, b):
            raise AssertionError(f"K13 {dtype_name} {n}: node sums {name} "
                                 "not scatter_edges_mixed's bit for bit")
    # the signed incidence (N x E) as CSR, for torch.sparse.mm
    slots = mesh.node_edges_t.reshape(-1, n).T
    sign = mesh.node_sign_t.reshape(-1, n).T
    keep = slots < ne
    inc = torch.sparse_coo_tensor(
        torch.stack([torch.arange(n, device=slots.device)[:, None]
                     .expand_as(slots)[keep], slots[keep]]),
        sign[keep], (n, ne)).coalesce().to_sparse_csr()
    flux_rows = rows[:, :nv].contiguous()
    lib_err = ((torch.sparse.mm(inc, flux_rows) - res).abs().max()
               / res.abs().max()).item()
    t = dict(
        call=cuda_time(lambda: kernels.edge_list_terms(*call_args)),
        edge_pass=cuda_time(lambda: kernels.edge_list_flux(*args)),
        sums=cuda_time(lambda: kernels.edge_list_sums(mesh, rows)),
        plain=cuda_time(lambda: ef.edge_list_terms_plain(*call_args)),
        plain_pass=cuda_time(lambda: ef.edge_list_flux_plain(*args)),
        plain_sums=cuda_time(lambda: mesh.scatter_edges_mixed(
            rows[:, :nv], rows[:, nv:])),
        library=cuda_time(lambda: torch.sparse.mm(inc, flux_rows)))
    # the runtime's launch calls are host events, counted whole
    _, ops = call_profile(lambda: kernels.edge_list_terms(*call_args),
                          reps=10)
    if ops != 2:
        raise AssertionError(f"K13 {dtype_name} {n}: {ops} CUDA launches a "
                             "call, expected 2 (edge pass, node sums)")
    # bytes: each input read once, each output written once; operations
    # ~2,000 per edge evaluation, as T3's
    tabs = [lib.h_y, lib.h_y2, lib.cp_y, lib.cp_y2, lib.mm,
            ef.species_consts_of(lib).sm_den]
    geo = [f_nodes, mesh.edges, mesh.edge_normal, mesh.coords]
    node_slots = [mesh.node_edges_t, mesh.node_sign_t]
    b_pass = bound_of(nbytes(geo + tabs + [rows]), 2000 * ne, dtype_name)
    b_sums = bound_of(nbytes([rows] + node_slots + list(sums)), 0,
                      dtype_name)
    b_call = bound_of(nbytes(geo + tabs + node_slots + list(sums)),
                      2000 * ne, dtype_name)
    key = f"{dtype_name} {n}"
    phase("k13", f"{key} ({ne} edges): the call (edge_list_terms) "
          f"max_abs_err {err:.3e} ({scaled:.2e} of its field's max; each "
          f"row within {TOL[('edge_list_flux', dtype_name)][1]} of its "
          f"max), the edge pass {err_pass:.3e}, the node sums "
          f"scatter_edges_mixed's bit for bit; call {t['call']:.4f} ms "
          f"({ops:.0f} CUDA launches) plain {t['plain']:.4f} ms "
          f"bound {b_call[0]:.4f} ms "
          f"({b_call[1]}); edge pass {t['edge_pass']:.4f} ms plain "
          f"{t['plain_pass']:.4f} bound {b_pass[0]:.4f}; sums "
          f"{t['sums']:.4f} ms plain {t['plain_sums']:.4f} "
          f"torch.sparse.mm {t['library']:.4f} (max diff {lib_err:.2e} of "
          "the residual's max) "
          f"bound {b_sums[0]:.4f}")
    report.setdefault("edge_list_flux", {})[key] = dict(
        max_abs_err=err, ms=t["call"], plain_ms=t["plain"],
        bound_ms=b_call[0], bound_by=b_call[1], library_ms=None,
        cuda_launches_per_call=ops,
        edge_pass=dict(kernel="edge_list_kernel", max_abs_err=err_pass,
                       ms=t["edge_pass"], plain_ms=t["plain_pass"], bound_ms=b_pass[0],
                       bound_by=b_pass[1], library_ms=None),
        node_sums=dict(kernel="edge_list_sum_kernel", bitwise=True,
                       ms=t["sums"], plain_ms=t["plain_sums"], bound_ms=b_sums[0],
                       bound_by=b_sums[1], library_ms=t["library"],
                       library="torch.sparse.mm, signed incidence (CSR) "
                       "x flux rows"))


# the shapes of the shape phase outside the kernels' compiled lists: T3,
# K8 and K13 ((dimension, species)), K10 and K11 (species counts, 2D), on
# 9,072-node meshes (channel_mesh(189, 48), box_mesh(24, 21, 18))
OTHER_EDGE_SHAPES = ((2, 5), (2, 1), (3, 16))
# K10's and K11's (dimension, species count) shapes off the main path's:
# (2, 3) and (3, 3) compiled (K10) or run-time (K11), 5 run-time
OTHER_K10_SHAPES = ((2, 5), (2, 3), (3, 5))
OTHER_K11_SHAPES = ((2, 3), (2, 5), (3, 3), (3, 5))
# T2's species counts outside kernels.NODE_STATE_SPECIES (its run-time
# instance), on the 9,072-node channel's node count
OTHER_T2_SPECIES = (5, 16)


def shape_phase(tmp, report):
    """T2 (full and lite) at OTHER_T2_SPECIES on kernel_inputs' state with
    the case's library cut or cycled to that count (cases.species_cut),
    against node_state_plain / node_state_lite_plain at its tolerances;
    T3, K8 and K13 at OTHER_EDGE_SHAPES, K10 at OTHER_K10_SHAPES (5
    species runs its run-time-count instance; 3, the flat plate's air, is
    compiled, on the main path in 3D only) and K11 at OTHER_K11_SHAPES
    (its run-time-count instances), in float64 and float32, on
    cases.shape_inputs (the case's library cut to the species count, a
    random reacting state) against their plain versions at the compiled
    shapes' per-row tolerances; K8 the roll-subtract of T3's outputs bit
    for bit, K13's edge pass over the family slots' edges and its whole
    call over the mesh's edge list; pad slots exactly 0 (K10,
    K11); float32 times beside the plain versions'."""
    import torch
    from su2_tpu_torch import cases, kernels, state as st
    from su2_tpu_torch.chemistry import library as cl
    from su2_tpu_torch.geometry.structured import box_mesh, channel_mesh
    from su2_tpu_torch.ops import ausm_t, edge_flux as ef
    from su2_tpu_torch.ops import edge_implicit as ei
    meshes = {2: channel_mesh(*SIZES["flagship"]), 3: box_mesh(*BOX_KERNELS)}
    libdir = os.path.join(tmp, "shapes")

    def check(name, key, dt, kfn, pfn, rows, per_row=True):
        got, want = rows(kfn()), rows(pfn())
        torch.cuda.synchronize()
        err, scaled = compare(name, dt, got, want, per_row=per_row)
        rec = dict(max_abs_err=err)
        if dt == "float32":
            rec.update(ms=cuda_time(kfn), plain_ms=cuda_time(pfn, reps=5))
        report.setdefault(name, {})[f"shape {key} {dt}"] = rec
        times = (f"; kernel {rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} "
                 "ms") if "ms" in rec else ""
        phase("shapes", f"{name} {key} {dt}: max_abs_err {err:.3e} "
              f"({scaled:.2e} of its row's max){times}")
        return got

    for dt in ("float64", "float32"):
        dtype = getattr(torch, dt)
        n = meshes[2].npoint
        for ns in OTHER_T2_SPECIES:
            if ns in kernels.NODE_STATE_SPECIES:
                raise AssertionError(f"T2: {ns} species is a compiled count")
            lib = cases.species_cut(cl.load_library(
                cases.write_library(libdir), None, dtype), ns).to("cuda")
            lay = st.Layout(2, ns)
            x = state_inputs(lib, lay, n, dtype, st.TSolveParams())
            a = (lib, lay, x["p"], x["u"], x["t_guess"], x["tke"])
            b = (lib, lay, x["u"], x["t_guess"], x["p"], x["tke"])
            check("node_state", f"{ns} species {n}", dt,
                  lambda: list(kernels.node_state(*a))
                  + list(kernels.node_state(*a, lite=True)),
                  lambda: list(vars(st.node_state_plain(*b)).values())
                  + list(vars(st.node_state_lite_plain(*b)).values()),
                  list, per_row=False)
            del lib, x, a, b
        for nd, ns in OTHER_EDGE_SHAPES:
            x = cases.shape_inputs(nd, ns, libdir, dtype, "cuda",
                                   raw_mesh=meshes[nd])
            mesh, head, lay = x["mesh"], x["explicit"], x["lay"]
            if kernels._check_edge_shape("edge_flux", lay):
                raise AssertionError(f"({nd}, {ns}) is a compiled shape")
            n = mesh.npoint
            fam = (mesh.fam_offsets, mesh.fam_normal, mesh.fam_evec)
            ks, ps = torch.nonzero((mesh.fam_normal != 0).any(-1),
                                   as_tuple=True)
            offs = torch.tensor(mesh.fam_offsets, device="cuda")
            edges = torch.stack([ps, (ps + offs[ks]) % n], 1).contiguous()
            lst = (edges, mesh.fam_normal[ks, ps].contiguous(), mesh.coords)
            key = f"({nd}, {ns}) {n}"
            slots = lambda o: [o[0].flatten(0, 1), o[1], o[2]]
            nodes = lambda o: [o[0], o[1][None], o[2][None]]
            t3 = check("edge_flux", key, dt,
                       lambda: kernels.edge_flux(*head, *fam),
                       lambda: ef.edge_flux_plain(*head, *fam), slots)
            check("edge_win", key, dt, lambda: kernels.edge_win(*head, *fam),
                  lambda: ef.edge_win_plain(*head, *fam), nodes)
            check("edge_list_flux", key, dt,
                  lambda: kernels.edge_list_flux(*head, *lst),
                  lambda: ef.edge_list_flux_plain(*head, *lst), nodes)
            whole = head[:4] + (head[4].T.contiguous(), mesh)
            check("edge_list_flux", f"{key} call (edge list)", dt,
                  lambda: kernels.edge_list_terms(*whole),
                  lambda: ef.edge_list_terms_plain(*whole),
                  lambda o: [o[0].T, o[1][None], o[2][None]])
            flux = t3[0].reshape(len(fam[0]), lay.nvar, n)
            win = kernels.edge_win(*head, *fam)
            for g, w in zip(win, ef.roll_subtract(fam[0], flux, t3[1],
                                                  t3[2])):
                if not torch.equal(g, w):
                    raise AssertionError(f"K8 {key} {dt}: not T3's "
                                         "roll-subtract bit for bit")
            del x, head, t3, win
        for nd, ns in OTHER_K10_SHAPES:
            x = cases.shape_inputs(nd, ns, libdir, dtype, "cuda",
                                   raw_mesh=meshes[nd])
            mesh = x["mesh"]
            args = x["implicit"] + (mesh.fam_offsets, mesh.fam_normal,
                                    mesh.fam_evec, True, True)
            got = check("edge_implicit",
                        f"{ns} species {mesh.npoint}{dim_tag(x['lay'])}", dt,
                        lambda: kernels.edge_implicit(*args),
                        lambda: ei.edge_implicit_plain(*args),
                        lambda o: [t.flatten(0, 1) for t in o])
            pad = (mesh.fam_normal == 0).all(-1)
            kh = len(mesh.fam_offsets)
            for t in got:
                if not bool((t.reshape(kh, -1, mesh.npoint).permute(
                        1, 0, 2)[:, pad] == 0).all()):
                    raise AssertionError(f"K10 {ns} species {dt}: nonzero "
                                         "output on a pad slot")
            del x, args, got
        for nd, ns in OTHER_K11_SHAPES:
            x = cases.shape_inputs(nd, ns, libdir, dtype, "cuda",
                                   raw_mesh=meshes[nd])
            lay, ins = x["lay"], x["faces"]
            m_inf = 0.1
            ne, nv = ins[0].shape[1], lay.nvar
            rows = lambda o: [o[0], o[1].reshape(nv * nv, ne),
                              o[2].reshape(nv * nv, ne)]
            pfn = lambda: ausm_t.ausm_flux_t(lay, *ins[:3], m_inf, *ins[3:])
            ins_e = [t.T.contiguous() for t in ins]
            for layout, kfn in (
                    ("feature-major", lambda: kernels.ausm_flux_jac(
                        lay, *ins[:3], m_inf, *ins[3:])),
                    ("edge-major", lambda: (lambda o: (
                        o[0].T, o[1].permute(1, 2, 0), o[2].permute(
                            1, 2, 0)))(kernels.ausm_flux_jac(
                                lay, *ins_e[:3], m_inf, *ins_e[3:],
                                edge_major=True)))):
                got = check("ausm_flux_jac", f"{ns} species {ne} slots"
                            f"{dim_tag(lay)} {layout}", dt, kfn, pfn, rows)
                pad = ~x["mesh"].fam_valid_flat
                if not all(bool((t[:, pad] == 0).all()) for t in got):
                    raise AssertionError(f"K11 {ns} species {layout} {dt}: "
                                         "nonzero output on a pad slot")
            del x, ins, ins_e


def nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound_of(nbyte, nflop, variant):
    """(least ms the card could take, what sets it): the bytes that must
    move over the HBM rate against the operations over the type's peak."""
    t_bytes = nbyte / HBM_BPS * 1e3
    t_ops = nflop / PEAK_FLOPS[variant] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def capture_systems(sim, steps=3):
    """The operands (diag, sel_t, colors, rhs) of the solves of the port's
    own assembly, by block width (the SST's 2, the implicit flow's 13),
    recorded around its solver calls during the steps-th coupled step from
    the freestream state."""
    from su2_tpu_torch.linalg import blockcsr, krylov
    rec = {}
    make_ops, fgmres = blockcsr.make_solver_ops_stencil_t, krylov.fgmres

    def rec_ops(mesh, diag, sel_t, kind, colors=None, ncolor=0,
                linear_iter=5, *more, **kw):
        sys_ = rec.setdefault(diag.shape[-1], {})
        sys_.update(diag=diag, sel_t=sel_t, colors=colors, ncolor=ncolor)
        mv, pc, pm, solve = make_ops(mesh, diag, sel_t, kind, colors, ncolor,
                                     linear_iter, *more, **kw)
        if solve is None:
            return mv, pc, pm, None

        def rec_solve(b, m, tol):
            sys_["rhs"] = b
            return solve(b, m, tol)
        return mv, pc, pm, rec_solve

    def rec_fgmres(matvec, precond, b, **kw):
        rec[b.shape[1]]["rhs"] = b
        return fgmres(matvec, precond, b, **kw)

    state = (sim.u0, sim.t0) + tuple(sim.initial_turb_state())
    for _ in range(steps - 1):
        state = sim._step(*state)[:6]
    blockcsr.make_solver_ops_stencil_t = rec_ops
    krylov.fgmres = rec_fgmres
    try:
        sim._step(*state)
    finally:
        blockcsr.make_solver_ops_stencil_t, krylov.fgmres = make_ops, fgmres
    return rec


def system_operands(sim, rec, variant):
    """K5/K6 operands of a captured system in the natural lane layout (the
    plain versions read it; the mixed tier's sweep blocks rounded to
    bf16): (kwargs, unit right side, right side).  solve_layout gives
    the layouts the solve path hands the kernels."""
    import torch
    from su2_tpu_torch.linalg import blockcsr
    dtype = torch.float64 if variant == "float64" else torch.float32
    diag, sel_t = rec["diag"].to(dtype), rec["sel_t"].to(dtype).contiguous()
    n, v = diag.shape[0], diag.shape[-1]
    lanes = lambda blk: blk.permute(1, 2, 0).reshape(v * v, n).contiguous()
    b = rec["rhs"].to(dtype).contiguous()
    args = dict(selp_t=sel_t.to(torch.bfloat16) if variant == "mixed"
                else sel_t, selm_t=sel_t,
                dinv_t=lanes(blockcsr.block_diag_inv(diag)),
                diag_t=lanes(diag), colors=rec["colors"],
                offsets=tuple(int(o) for o in sim.mesh.stencil_offsets),
                ncolor=int(rec["ncolor"]))
    return args, (b / torch.linalg.vector_norm(b)).contiguous(), b


def band_operands(v, offsets, variant, n=20000, ncolor=4, seed=11):
    """A random band block system with dense v x v blocks, zero blocks for
    out-of-range neighbours and round-robin colors, which are not a proper
    coloring for these offsets: the two-buffer rule decides the numbers."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    dtype = torch.float64 if variant == "float64" else torch.float32
    k = len(offsets)
    sel = rng.standard_normal((k, v, v, n)) * 0.1
    p = np.arange(n)
    for kk, o in enumerate(offsets):
        sel[kk, :, :, (p + o < 0) | (p + o >= n)] = 0.0
    diag = rng.standard_normal((n, v, v)) * 0.1 + 3.0 * np.eye(v)
    dev = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(
        "cuda", dtype)
    lanes = lambda blk: dev(blk.transpose(1, 2, 0).reshape(v * v, n))
    sel_t = dev(sel.reshape(k * v * v, n))
    colors = torch.as_tensor((p % ncolor).astype(np.int8)).to("cuda")
    b = dev(rng.standard_normal((n, v)))
    args = dict(selp_t=sel_t.to(torch.bfloat16) if variant == "mixed"
                else sel_t, selm_t=sel_t,
                dinv_t=lanes(np.linalg.inv(diag)), diag_t=lanes(diag),
                colors=colors, offsets=tuple(offsets),
                ncolor=ncolor)
    return args, (b / torch.linalg.vector_norm(b)).contiguous(), b


def solve_layout(args, one_launch=False):
    """The sweep operands StencilSolveOps lays out on the card, for K5's
    Krylov loop or (one_launch) a K6 solve: the sweep blocks and dinv
    (color-major in the mixed tier wherever the kernel reads the node
    order: K5, and K6 at v >= 7), the order (None for K6 at v <= 3) and
    its flag; they override the natural ones of args in a kernel call."""
    from su2_tpu_torch.linalg import stencil_solve as ts
    ops = ts.StencilSolveOps.from_lanes(
        args["offsets"], args["selm_t"], args["dinv_t"], args["diag_t"],
        args["colors"], args["ncolor"], args["selp_t"].dtype,
        one_launch=one_launch)
    return dict(selp_t=ops.sel_t, dinv_t=ops.dinv_t, order=ops.order,
                color_major=ops.color_major)


def bsr_operator(args, n, v):
    """The matvec operator D + sum_k B_k shift_k as one (n v, n v) block
    sparse matrix with v x v blocks: the yardstick of torch.sparse.mm,
    never called by the port."""
    import torch
    offs = [0] + list(args["offsets"])
    blocks = [args["diag_t"]] + list(args["selm_t"].reshape(
        len(args["offsets"]), v * v, n).unbind(0))
    p = torch.arange(n, device="cuda")
    order = sorted(range(len(offs)), key=lambda i: offs[i])
    cols = torch.stack([p + offs[i] for i in order], 1)         # (n, K+1)
    vals = torch.stack([blocks[i].T.reshape(n, v, v) for i in order], 1)
    ok = (cols >= 0) & (cols < n)
    crow = torch.zeros(n + 1, dtype=torch.int64, device="cuda")
    crow[1:] = ok.sum(1).cumsum(0)
    return torch.sparse_bsr_tensor(crow, cols[ok], vals[ok].contiguous(),
                                   size=(n * v, n * v))


def k5_flops(args, n, v, sweep, matvec):
    """Multiply-adds of one K5 application as 2 operations each: a sweep
    pass updates its color's nodes (K v x v off-diagonal products, the
    subtraction and the dinv product; the first pass only dinv), the
    matvec every node."""
    k, nc = len(args["offsets"]), args["ncolor"]
    flops = 0
    if sweep:
        cnt = [int((args["colors"] == c).sum()) for c in range(nc)]
        order = list(range(nc)) + list(range(nc - 2, -1, -1))
        flops += 2 * v * v * cnt[order[0]]
        flops += sum(cnt[c] for c in order[1:]) * (2 * k * v * v + v
                                                   + 2 * v * v)
    if matvec:
        flops += n * (2 * k * v * v + 2 * v * v + v)
    return flops


def k6_flops(args, n, v, m):
    """One FGMRES(m) cycle: m sweeps and matvecs, the j + 1 Gram-Schmidt
    dots and updates and the norm of iteration j, the basis vector, and
    x = sum_j y_j z_j."""
    nv = n * v
    per = k5_flops(args, n, v, True, True)
    return m * per + sum(4 * nv * (j + 1) + 3 * nv for j in range(m)) \
        + 2 * m * nv


def k5_bound(args, lay, r, got, sweep, matvec, var):
    """bound_of one K5 call: its inputs read once (r; the sweep blocks,
    dinv, colors and order; diag and the matvec blocks where they are not
    the sweep's), its outputs got written once, k5_flops' operations."""
    n, v = r.shape
    ins = [r]
    if sweep:
        ins += [lay["selp_t"], lay["dinv_t"], args["colors"], lay["order"]]
    if matvec:
        ins.append(args["diag_t"])
        if not sweep or args["selm_t"] is not lay["selp_t"]:
            ins.append(args["selm_t"])
    return bound_of(nbytes(ins + list(got)),
                    k5_flops(args, n, v, sweep, matvec), var)


def k6_bound(args, lay, b, var):
    """bound_of one K6 cycle: its inputs read once, x and the stats
    written once, k6_flops' operations."""
    n, v = b.shape
    ins = [lay["selp_t"], lay["dinv_t"], args["diag_t"], args["colors"], b,
           None if args["selm_t"] is lay["selp_t"] else args["selm_t"],
           lay["order"]]
    outs = nbytes([b]) + 2 * b.element_size()          # x and the stats
    return bound_of(nbytes(ins) + outs, k6_flops(args, n, v, KRYLOV_M), var)


def k6_launch(v, grid):
    """K6's launch at width v with stencil_fgmres_grid's count grid
    (csrc/stencil_solve.cu), as words."""
    from su2_tpu_torch import kernels
    if v >= kernels.K6_ROWS_MIN_V:
        return (f"cooperative grid {grid} blocks of "
                f"{32 * v * kernels.k6_groups(v)} threads")
    return f"cluster of {grid} CTAs of 1024 threads"


def k6_barriers(ncolor, m):
    """Launch-wide barriers of one K6 cycle (csrc/stencil_solve.cu)."""
    return 2 + m * (2 * ncolor + 1) + m * (m - 1) // 2


def stencil_phase(sims, flow_sims, report):
    """K5 and K6 against their plain versions, in f64, f32 and mixed: the
    SST systems the port assembles at 9,072 and 142,317 nodes (v = 2), the
    implicit LU_SGS case's flow systems (v = 13: K6 at 9,072 nodes, K5 at
    142,317), and band systems with dense blocks (v = 2, 3 and 7); at
    TIER_N nodes K5 in the main path's mixed tier on the SST and the flow
    systems (and its matvec in f32, beside torch.sparse.mm).  K5 reads the
    layout StencilSolveOps makes for the Krylov loop (solve_layout)."""
    from su2_tpu_torch import kernels
    every = ("float64", "float32", "mixed")
    modes = ("sgs_matvec", "sgs", "matvec")
    tier = {"mixed": ("sgs_matvec",), "float32": ("matvec",)}
    # name -> (operands of a variant, K5's modes by variant, run K6)
    systems = {}
    for size, sim in sims.items():
        rec = capture_systems(sim)[2]
        systems[f"sst{sim.mesh.npoint}"] = (
            lambda var, sim=sim, rec=rec: system_operands(sim, rec, var),
            tier if size == "tier" else dict.fromkeys(every, modes),
            size != "tier")
    for size, sim in flow_sims.items():
        rec = capture_systems(sim)[sim.lay.nvar]
        systems[f"flow{sim.mesh.npoint}"] = (
            lambda var, sim=sim, rec=rec: system_operands(sim, rec, var),
            tier if size == "tier" else dict.fromkeys(
                every, () if size == "flagship" else modes),
            size == "flagship")
    for name, v, offsets in (("band2", 2, (-9, -8, -7, -1, 1, 7, 8, 9)),
                             ("band3", 3, (-5, -1, 1, 5)),
                             ("band7", 7, (-9, -1, 1, 9))):
        systems[name] = (lambda var, v=v, offsets=offsets: band_operands(
            v, offsets, var), dict.fromkeys(every, modes), True)
        if v < kernels.K6_ROWS_MIN_V:
            # K6's cluster at the one-launch tier's largest field
            systems[f"{name}cap"] = (
                lambda var, v=v, offsets=offsets: band_operands(
                    v, offsets, var, n=K6_CAP), {}, True)
    stencil_checks(systems, report)


def box_stencil_phase(flow_sims, report):
    """K5 and K6 at the 3D flow's block widths against their plain
    versions, in f64, f32 and mixed: the flow systems (v = 14 and, with
    cases.SPECIES_3, 8) that the box's implicit LU_SGS steps assemble
    (flow_sims: label -> (sim, whether the solve is one K6 cycle): K6 on
    those, K5's three modes on the others) and band systems of both
    widths with the box's 6 offsets and round-robin colors."""
    every = ("float64", "float32", "mixed")
    modes = ("sgs_matvec", "sgs", "matvec")
    systems = {}
    for label, (sim, one) in flow_sims.items():
        rec = capture_systems(sim)[sim.lay.nvar]
        systems[label] = (
            lambda var, sim=sim, rec=rec: system_operands(sim, rec, var),
            {} if one else dict.fromkeys(every, modes), one)
    for v in (8, 14):
        systems[f"band{v} 3D"] = (
            lambda var, v=v: band_operands(v, (-400, -20, -1, 1, 20, 400),
                                           var),
            dict.fromkeys(every, modes), True)
    stencil_checks(systems, report)


def stencil_report(name, v):
    """The report key of kernel name's numbers at width v: its own, or its
    run-time-width instance's (a width STENCIL_WIDTHS does not compile)."""
    from su2_tpu_torch import kernels
    if v in kernels.STENCIL_WIDTHS:
        return name
    return name.replace("stencil_", "stencil_runtime_")


def stencil_checks(systems, report, timed=None):
    """K5 and K6 against their plain versions on systems (name -> (the
    operands of a variant, K5's modes by variant, whether to run K6)), as
    stencil_phase describes; timed (a set of names; None: all) says whose
    times to take, the others are checked only."""
    import torch
    from su2_tpu_torch import kernels
    from su2_tpu_torch.linalg import stencil_solve as ts
    every = ("float64", "float32", "mixed")
    for sname, (make, k5_modes, run_k6) in systems.items():
        for var in every:
            if not (k5_modes.get(var) or run_k6):
                continue
            args, r, b = make(var)
            n, v = r.shape
            lay = solve_layout(args) if k5_modes.get(var) else None
            rtol, afrac = TOL[("stencil_sgs_matvec", var)]
            for mode in k5_modes.get(var, ()):
                sweep, matvec = mode != "matvec", mode != "sgs"
                if mode == "matvec" and var == "mixed":
                    continue          # the matvec never reads bf16 blocks
                kfn = lambda: [t for t in kernels.stencil_sgs_matvec(
                    **dict(args, **lay), r=r, sweep=sweep, matvec=matvec)
                    if t is not None and (sweep or t is not r)]
                pfn = lambda: [t for t in ts.sgs_matvec_plain(
                    **args, r=r, sweep=sweep, matvec=matvec)
                    if t is not None and (sweep or t is not r)]
                got, want = kfn(), pfn()
                torch.cuda.synchronize()
                err, worst = 0.0, 0.0
                for g, w in zip(got, want):
                    g, w = g.double(), w.double()
                    if not torch.isfinite(g).all():
                        raise AssertionError(f"K5 {sname} {var} {mode}: "
                                             "non-finite output")
                    e = (g - w).abs()
                    if not bool((e <= rtol * w.abs()
                                 + afrac * w.abs().max()).all()):
                        raise AssertionError(
                            f"K5 {sname} {var} {mode}: max err "
                            f"{e.max().item():.3e} outside rtol {rtol} atol "
                            f"{afrac}*max")
                    err = max(err, e.max().item())
                    worst = max(worst, e.max().item()
                                / max(w.abs().max().item(), 1e-300))
                form = ("" if v in kernels.STENCIL_WIDTHS
                        else "; " + k5_form(v))
                if timed is not None and sname not in timed:
                    phase("stencil", f"K5 {mode} {sname} {var}: max_abs_err "
                          f"{err:.3e} ({worst:.2e} of its field's max)"
                          + form)
                    continue
                ms, plain_ms = cuda_time(kfn), cuda_time(pfn)
                bound = k5_bound(args, lay, r, got, sweep, matvec, var)
                lib_ms, lib_txt = None, ""
                if mode == "matvec":
                    lib_ms, lib_txt = bsr_time(args, r, n, v)
                phase("stencil", f"K5 {mode} {sname} {var}: max_abs_err "
                      f"{err:.3e} ({worst:.2e} of its field's max) kernel "
                      f"{ms:.4f} ms plain {plain_ms:.4f} ms bound "
                      f"{bound[0]:.4f} ms ({bound[1]}){lib_txt}; sweep "
                      "blocks " + ("color-major" if lay["color_major"]
                                   else "natural") + form)
                report.setdefault(stencil_report("stencil_sgs_matvec", v),
                                  {})[(sname, var, mode)] = dict(
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound[0], bound_by=bound[1],
                        library_ms=lib_ms, library=lib_txt.strip() or None)
            if run_k6:
                k6_check(sname, var, args, r, b, report,
                         timed is None or sname in timed)


def box_phase(tmp, report):
    """The 3D implicit flow (MUSCL + Venkatakrishnan) on box_mesh and the
    tet box, float32 cases built here (returned by label for graph_phase
    and box_slices): K10 at (3, 9) against its plain version on the
    8,000-node box (f64 and f32, the four variants) and at 136,161 and
    262,701 nodes (f32, the latter's stack from K7's rows), at (3, 3) on
    the 3-species case at 8,000 (f64, f32) and 136,161 (f32); K11 in 3D
    on the laminar box's family slots (8,000 f64 and f32, 136,161 f32)
    and on the implicit tet box's edge rows (TET_STEP, f64 and f32); K5
    and K6 at v = 14 and 8 (box_stencil_phase).  (The f64 step checks of
    these paths are step_checks'.)"""
    import torch
    venk = IMPLICIT_VARIANTS["venkatakrishnan"]
    f32 = torch.float32
    sims = {}

    def build(label, shape, **kw):
        t0 = time.perf_counter()
        kw.setdefault("implicit", venk)
        sim = make_case(tmp, *shape[:2], f32, "cuda",
                        kw.pop("prec", "LU_SGS"), box=kw.pop("box", True),
                        **kw)
        phase("box", f"{label}: {sim.mesh.npoint} nodes, stencil "
              f"{sim.mesh.stencil_offsets}, {sim.ncolor} sweep colors, "
              f"built in {time.perf_counter() - t0:.1f} s")
        sims[label] = sim
        return sim

    box = build("box", BOX_KERNELS, nz=BOX_KERNELS[2])
    box3 = build("box 3 species", BOX_KERNELS, nz=BOX_KERNELS[2],
                 species="3")
    lam = build("box laminar", BOX_KERNELS, nz=BOX_KERNELS[2], laminar=True)
    tet = build("tet box", TET_STEP, nz=TET_STEP[2], box=False)
    big = build("box 136161", BOX_SCALING, nz=BOX_SCALING[2])
    big3 = build("box 136161 3 species", BOX_SCALING, nz=BOX_SCALING[2],
                 species="3")
    for dt in ("float64", "float32"):
        implicit_kernel_phase(box, dt, report, list(IMPLICIT_VARIANTS),
                              plain_reps=3)
        implicit_kernel_phase(box3, dt, report, ["venkatakrishnan"],
                              plain_reps=3)
        ausm_kernel_phase(lam, dt, report)
        ausm_edge_phase(tet, dt, report)
    for sim in (big, big3):
        implicit_kernel_phase(sim, "float32", report, ["venkatakrishnan"],
                              plain_reps=3)
    tier = build("box 262701", BOX_TIER, nz=BOX_TIER[2])
    implicit_kernel_phase(tier, "float32", report, ["venkatakrishnan"],
                          plain_reps=3)
    lam_big = build("box 136161 laminar", BOX_SCALING, nz=BOX_SCALING[2],
                    laminar=True)
    ausm_kernel_phase(lam_big, "float32", report)
    box_stencil_phase({f"flow3d{s.mesh.npoint} v{s.lay.nvar}": (
        s, flow_one_launch(s)) for s in (box, box3, big, big3)}, report)
    return sims


def box_graphs(sims):
    """(label, sim) of the 3D implicit paths for graph_phase: the box's
    RANS (K10 at (3, 9), the flow's K6 at v = 14), 3-species (K10 at
    (3, 3), K6 at v = 8), laminar (K11 in 3D) LU_SGS steps at 8,000
    nodes, the RANS step at 136,161 (K5 at v = 14) and the tet box's
    implicit LU_SGS step (K11 on the edge rows); the 5-species box (K10's
    run-time count, K5/K6's run-time width) is mixture_graphs'."""
    return tuple((f"3D {label}, implicit LU_SGS", sims[label]) for label in (
        "box", "box 3 species", "box laminar", "box 136161", "tet box"))


def box_slices(tmp, card, runs, sims):
    """BOX_SLICES through slice_phase, float32, timed and profiled (with
    the device ms of each stage); the cases box_phase built are reused
    where they match and dropped after their run."""
    import torch
    venk = IMPLICIT_VARIANTS["venkatakrishnan"]
    reuse = {"8000 box implicit LU_SGS": "box",
             "136161 box implicit LU_SGS": "box 136161",
             "262701 box implicit LU_SGS": "box 262701",
             "136161 box 3 species implicit LU_SGS": "box 136161 3 species",
             "136161 box laminar implicit LU_SGS": "box 136161 laminar"}
    for label, shape, kw, niter in BOX_SLICES:
        sim = sims.pop(reuse.get(label), None)
        if sim is None:
            sim = make_case(tmp, *shape[:2], torch.float32, "cuda",
                            kw.get("prec", "LU_SGS"), implicit=venk,
                            nz=shape[2], box=True,
                            **{k: v for k, v in kw.items() if k != "prec"})
        runs.append((label, slice_phase(
            sim, "box", niter, card, prec=kw.get("prec", "LU_SGS"),
            profile=True), niter))
        del sim
        torch.cuda.empty_cache()
    sims.clear()


def mixture_cases(tmp):
    """MIXTURE_PATHS' float32 cases on the card, built here: label with
    its node count -> (sim, slice iterations, K5/K6 launches per iteration
    of the slice)."""
    import torch
    venk = IMPLICIT_VARIANTS["venkatakrishnan"]
    out = {}
    for label, size, kw, niter, stencil in MIXTURE_PATHS:
        t0 = time.perf_counter()
        if isinstance(size, str):
            sim = make_case(tmp, *SIZES[size], torch.float32, "cuda",
                            implicit=venk, species="5", **kw)
        else:
            sim = make_case(tmp, *size[:2], torch.float32, "cuda",
                            implicit=venk, nz=size[2], box=True,
                            species="5", **kw)
        key = f"{sim.mesh.npoint} {label}"
        phase("widths", f"{key}: v = {sim.lay.nvar}, stencil "
              f"{sim.mesh.stencil_offsets}, {sim.ncolor} sweep colors, "
              f"built in {time.perf_counter() - t0:.1f} s")
        out[key] = (sim, niter, stencil)
    return out


def widths_phase(msims, report):
    """K5 and K6 through their run-time-width instance against their plain
    versions, in f64, f32 and mixed: band systems with round-robin colors
    at every width of RUNTIME_WIDTHS (band_offsets; 20,000 nodes and
    times at RUNTIME_TIMED's widths, the others 4,000 nodes, checked
    only) and the flow systems
    the 5-species cases assemble (mixture_cases: K6 where the flow's solve
    is one cycle, on the channel's 9,072 nodes and the box's 8,000, K5's
    three modes on the channel's 142,317 and the box's 136,161); then the
    run-time instance at the compiled widths 8 and 13 against the compiled
    one (runtime_vs_compiled).  K6 on the flow systems also in its
    streamed form (forced: smem_budget 0) beside the form k6_plan picks;
    each width's class and its kernels' registers and spills (this run's
    ptxas)."""
    import torch
    every = ("float64", "float32", "mixed")
    modes = ("sgs_matvec", "sgs", "matvec")
    systems = {}
    streamed = []
    for key, (sim, _, _) in msims.items():
        if not (sim.turbulent and key.endswith(" implicit LU_SGS")) \
                or sim.mesh.npoint == TIER_N:
            continue
        one = flow_one_launch(sim)
        rec = capture_systems(sim)[sim.lay.nvar]
        name = (f"flow{'3d' if sim.lay.ndim == 3 else ''}{sim.mesh.npoint} "
                f"v{sim.lay.nvar}")
        systems[name] = (
            lambda var, sim=sim, rec=rec: system_operands(sim, rec, var),
            {} if one else dict.fromkeys(every, modes), one)
        if one:
            streamed.append((name, systems[name][0]))
    for v in RUNTIME_WIDTHS:
        n = 20000 if f"band{v}" in RUNTIME_TIMED else 4000
        systems[f"band{v}"] = (
            lambda var, v=v, n=n: band_operands(v, band_offsets(v), var,
                                                n=n),
            dict.fromkeys(every, modes), True)
    stencil_checks(systems, report, timed={name for name in systems
                                           if not name.startswith("band")}
                   | set(RUNTIME_TIMED))
    for name, make in streamed:
        for var in every:
            args, r, b = make(var)
            k6_check(f"{name} streamed", var, args, r, b, report,
                     timed=var == "mixed", budget=0)
            del args, r, b
        torch.cuda.empty_cache()
    for v in sorted(set(RUNTIME_WIDTHS) | {8, 13}):
        for var in every:
            phase("widths", f"v = {v} {var}: {rt_kernel_lines(v, var)}")
    runtime_vs_compiled(report)


def runtime_vs_compiled(report):
    """The run-time-width instance (runtime=True) at the compiled widths 8
    (the box's 6 offsets) and 13 (the channel's 4) against the compiled
    instance on one band system (20,000 nodes, 4 colors) in the solve
    path's layouts, f64, f32 and mixed: K5 (z, A z) bit for bit, K6's
    FGMRES(10) cycle (tol 1e-6) with equal iterations and x within
    k6_check's pins of the compiled x; both instances' times and K6's
    grids."""
    import torch
    from su2_tpu_torch import kernels
    out = report.setdefault("runtime_vs_compiled", {})
    for v, offsets in ((8, BOX_BAND), (13, (-9, -1, 1, 9))):
        for var in ("float64", "float32", "mixed"):
            sel_bf16 = var == "mixed"
            args, _, b = band_operands(v, offsets, var)
            n = b.shape[0]
            lay = solve_layout(args)
            k5 = lambda rt: kernels.stencil_sgs_matvec(
                **dict(args, **lay), r=b, runtime=rt)
            (z0, w0), (z1, w1) = k5(False), k5(True)
            torch.cuda.synchronize()
            if not (torch.equal(z0, z1) and torch.equal(w0, w1)):
                raise AssertionError(
                    f"runtime vs compiled K5 v = {v} {var}: max difference "
                    f"{max((z0 - z1).abs().max().item(), (w0 - w1).abs().max().item()):.3e}")
            k5_ms = [cuda_time(lambda rt=rt: k5(rt)) for rt in (False, True)]
            lay1 = solve_layout(args, one_launch=True)
            k6 = lambda rt: kernels.stencil_fgmres(
                **dict(args, **lay1), b=b, m=KRYLOV_M, tol=1e-6, runtime=rt)
            (x0, _, it0), (x1, _, it1) = k6(False), k6(True)
            torch.cuda.synchronize()
            scale = max(x0.abs().max().item(), 1e-300)
            diff = (x1.double() - x0.double()).abs()
            ok = (bool((diff <= 1e-9 * x0.double().abs() + 1e-12 * scale)
                       .all()) if var == "float64"
                  else diff.max().item() <= 2e-5 * scale)
            if int(it0) != int(it1) or not ok:
                raise AssertionError(
                    f"runtime vs compiled K6 v = {v} {var}: iterations "
                    f"{int(it1)} / {int(it0)}, max difference "
                    f"{diff.max().item():.3e} (x scale {scale:.3e})")
            k6_ms = [cuda_time(lambda rt=rt: k6(rt), reps=10)
                     for rt in (False, True)]
            grids = [kernels.stencil_fgmres_grid(b.dtype, sel_bf16, v, n,
                                                 KRYLOV_M, runtime=rt)
                     for rt in (False, True)]
            plan = kernels.k6_launch_plan(
                b.dtype, sel_bf16, v, len(offsets), n, lay1["color_major"],
                KRYLOV_M)
            phase("widths", f"run-time kernels at v = {v} {var} ({n} "
                  f"nodes): K5 ({k5_form(v)}) (z, A z) bit for bit "
                  f"the compiled instance's, {k5_ms[1]:.4f} ms against "
                  f"{k5_ms[0]:.4f}; K6 {k6_form(plan)}; "
                  f"K6 {int(it1)} iterations as the compiled, x within "
                  f"{diff.max().item() / scale:.2e} of max|x|, "
                  f"{k6_ms[1]:.4f} ms against {k6_ms[0]:.4f} (grids "
                  f"{grids[1]} / {grids[0]} blocks)")
            out[f"v{v} {var}"] = dict(
                k5_ms=k5_ms[1], k5_compiled_ms=k5_ms[0], k6_ms=k6_ms[1],
                k6_compiled_ms=k6_ms[0], k6_max_rel_diff=diff.max().item()
                / scale, k6_grid=grids[1], k6_compiled_grid=grids[0],
                k6_form=plan.form)


def mixture_graphs(msims):
    """(label, sim) of MIXTURE_PATHS for graph_phase."""
    return tuple((f"5 species: {key}", sim)
                 for key, (sim, _, _) in msims.items())


def mixture_slices(card, runs, msims):
    """MIXTURE_PATHS through slice_phase, float32, timed and profiled (with
    the device ms of each stage); each case dropped after its run."""
    import torch
    for key in list(msims):
        sim, niter, stencil = msims.pop(key)
        prec = (sim.cfg.linear_solver if sim.cfg.linear_solver == "BCGSTAB"
                else sim.cfg.linear_solver_prec)
        if stencil is None:
            stencil = stencil_per_iter(sim, prec)
        runs.append((key, slice_phase(sim, key, niter, card, prec=prec,
                                      profile=True, stencil=stencil), niter))
        del sim
        torch.cuda.empty_cache()


def bsr_time(args, r, n, v):
    """(ms, label) of torch.sparse.mm on the matvec operator as a BSR
    tensor with v x v blocks, the yardstick of the matvec; (None, what it
    raised) where torch does not take that block size on the card."""
    import torch
    try:
        mat = bsr_operator(args, n, v)
        xv = r.reshape(n * v, 1)
        torch.sparse.mm(mat, xv)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as exc:
        msg = str(exc).strip().splitlines()[0][:120]
        return None, f" torch.sparse.mm (BSR, {v} x {v} blocks) raised: {msg}"
    ms = cuda_time(lambda: torch.sparse.mm(mat, xv))
    return ms, f" torch.sparse.mm (BSR) {ms:.4f} ms"


def k6_check(sname, var, args, r, b, report, timed=True, budget=None):
    """K6 against the plain FGMRES(10) over the plain sweep: equal
    iterations; f64 x within rtol 1e-9 and atol 1e-12 of max|x|, rel
    within rtol 1e-8 (atol 1e-15); f32 and mixed x within 2e-5 of max|x|
    (the JAX package's pins, tests/test_stencil.py:259-262, 315-317).
    Cases: tol 1e-6, tol 1e-12 (all iterations in f32), the unit right
    side r times 1e18 (the pow2 scaling; b itself may reach 1e21 in f32)
    and, in f64, b = 0 (in f32 the reference's 1e-300 floor rounds to 0
    and its cycle divides 0 by 0).  timed=False: the checks only; budget
    (a run-time width): kernels.stencil_fgmres's smem_budget (0: the
    streamed form)."""
    import torch
    from su2_tpu_torch import kernels
    from su2_tpu_torch.linalg import stencil_solve as ts
    n, v = b.shape
    lay = solve_layout(args, one_launch=True)
    rt = v not in kernels.STENCIL_WIDTHS
    kw = dict(smem_budget=budget) if rt else {}
    form = ("; " + k6_form(kernels.k6_launch_plan(
        b.dtype, args["selp_t"].dtype == torch.bfloat16, v,
        len(args["offsets"]), n, lay["color_major"], KRYLOV_M, budget))
        if rt else "")
    cases = [("tol 1e-6", b, 1e-6), ("tol 1e-12", b, 1e-12),
             ("r x 1e18", r * 1e18, 1e-6)]
    if var == "float64":
        cases.append(("b = 0", torch.zeros_like(b), 1e-6))
    err = err_abs = 0.0
    iters = []
    for label, bb, tol in cases:
        x, rel, it = kernels.stencil_fgmres(**dict(args, **lay), b=bb,
                                            m=KRYLOV_M, tol=tol, **kw)
        px, prel, pit = ts.fgmres_plain(**args, b=bb, m=KRYLOV_M, tol=tol)
        torch.cuda.synchronize()
        if int(it) != int(pit):
            raise AssertionError(f"K6 {sname} {var} {label}: {int(it)} "
                                 f"iterations, plain {int(pit)}")
        x, px = x.double(), px.double()
        if not torch.isfinite(x).all():
            raise AssertionError(f"K6 {sname} {var} {label}: non-finite x")
        scale = max(px.abs().max().item(), 1e-300)
        e = (x - px).abs()
        if var == "float64":
            # rel: atol 1e-15, since at tol 1e-12 it ends at rounding
            # level, where the summation orders of the dots show
            ok = bool((e <= 1e-9 * px.abs() + 1e-12 * scale).all()) and \
                abs(float(rel) - float(prel)) <= 1e-8 * abs(float(prel)) \
                + 1e-15
        else:
            ok = e.max().item() <= 2e-5 * scale
        if not ok:
            raise AssertionError(
                f"K6 {sname} {var} {label}: max err {e.max().item():.3e} "
                f"(x scale {scale:.3e}), rel {float(rel):.6e} vs plain "
                f"{float(prel):.6e}")
        err = max(err, e.max().item() / scale)
        if label == "tol 1e-6":
            err_abs = e.max().item()
        iters.append(int(it))
    grid = kernels.stencil_fgmres_grid(
        b.dtype, args["selp_t"].dtype == torch.bfloat16, v, n, KRYLOV_M)
    if not timed:
        phase("stencil", f"K6 {sname} {var}: iterations {iters} equal to the "
              f"plain version's, max error {err:.2e} of max|x|; "
              f"{k6_launch(v, grid)} (v = {v}){form}")
        return
    kfn = lambda: kernels.stencil_fgmres(**dict(args, **lay), b=b,
                                         m=KRYLOV_M, tol=1e-6, **kw)
    pfn = lambda: ts.fgmres_plain(**args, b=b, m=KRYLOV_M, tol=1e-6)
    ms, plain_ms = cuda_time(kfn, reps=10), cuda_time(pfn, reps=5)
    bound = k6_bound(args, lay, b, var)
    phase("stencil", f"K6 {sname} {var}: iterations {iters} equal to the "
          f"plain version's, max error {err:.2e} of max|x|; kernel {ms:.4f} "
          f"ms plain {plain_ms:.4f} ms bound {bound[0]:.4f} ms ({bound[1]});"
          f" {k6_barriers(args['ncolor'], KRYLOV_M)} barriers; "
          f"{k6_launch(v, grid)} (v = {v}); sweep blocks "
          + ("color-major" if lay["color_major"] else "natural") + form)
    report.setdefault(stencil_report("stencil_fgmres", v), {})[
        (sname, var)] = dict(
        max_abs_err=err_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
        bound_by=bound[1], library_ms=None,
        barriers=k6_barriers(args["ncolor"], KRYLOV_M), grid=grid,
        form=form[2:] or None)


def step_phase(tmp, tier=False, total_conditions=False, implicit=None,
               prec="JACOBI", fused=False, tri=False, tet=None, box=None,
               species=None):
    """5 coupled iterations, card vs CPU, from the state after 10 card
    iterations of the flagship-class case; tier=True forces the
    >= 200k-node tier on both sides (TILED_MIN_NODES = 0: K7 and K8, or
    K7 feeding K10, on the card), total_conditions a TOTAL_CONDITIONS
    inlet (K9), implicit the implicit-flow variant (muscl, limiter) (K10
    once per iteration) with the preconditioner prec for its flow and SST
    systems (LU_SGS in f64 at 9,072 nodes: the flow's 13 x 13 system past
    the full-precision gate, K5 once per Krylov vector, FGMRES(10); the
    SST's one K6 launch); fused the fused SST assembly on both sides (K12
    once per iteration, the SST's solve in the fused tier: one K6 launch
    in f64 at 9,072 nodes); tri the triangle channel (the gather path: K13
    once per iteration, the SST's solve in torch gather ops; implicit: the
    edge-list system, K11 once per iteration, both solves in torch gather
    ops, LINELET's lines over the edge list); tet, a shape of
    cases.tet_box_mesh (explicit: K13 at (3, 9), the 3D gather WLS;
    implicit: K11 on the edge rows, the solves in torch gather ops); box,
    a shape of box_mesh (implicit: K10 in 3D, the solves' K5/K6 at
    v = nVar and 2 in their tiers, stencil_per_iter), species "3" the
    3-species mixture (v = 8).  The card's half runs here, the CPU's in
    a worker process (_cpu_steps); the comparison and the line come in
    finish_steps."""
    from su2_tpu_torch.ops import gradients
    from su2_tpu_torch.turbulence import sst
    saved = gradients.TILED_MIN_NODES
    if tier:
        gradients.TILED_MIN_NODES = 0
    if fused:
        sst.set_assemble_mode("fused")
    try:
        compare, counts, sim = _step_compare(
            tmp, total_conditions, implicit, prec, tri=tri, tet=tet,
            box=box, species=species, tier=tier, fused=fused)
    finally:
        gradients.TILED_MIN_NODES = saved
        sst.set_assemble_mode("unfused")
    n = sim.mesh.npoint
    imp = implicit is not None
    gather = tri or tet is not None
    want = {"edge_win": 5 * (tier and not imp),
            "edge_flux": 5 * (not tier and not imp and not gather),
            "edge_list_flux": 5 * (gather and not imp),
            "edge_list_sum": 5 * (gather and not imp),
            "edge_implicit": 5 * (imp and not gather),
            "ausm_flux_jac": 5 * (imp and gather),
            "chem_source": 5 * (not imp),
            "gradient_rows": 10 * tier, "inlet_tc": 5 * total_conditions,
            "sst_assemble": 5 * fused}
    if imp:
        lusgs = prec != "JACOBI"
        want.update(stencil_fgmres=5 * lusgs,
                    stencil_sgs_matvec=5 * KRYLOV_M * lusgs)
    if box is not None:
        want.update({k: 5 * c for k, c in stencil_per_iter(sim, prec).items()})
    if gather:
        want.update(stencil_fgmres=0, stencil_sgs_matvec=0,
                    stencil_sweep_only=0, stencil_matvec_only=0)
    if fused and not imp:
        _, one = fused_sst_tier(sim)
        want.update(stencil_fgmres=5 * one,
                    stencil_sgs_matvec=5 * KRYLOV_M * (not one))
    for k, c in want.items():
        if counts[k] != c:
            raise AssertionError(f"step: {k} launched {counts[k]} times in "
                                 f"the 5 compared card iterations, "
                                 f"expected {c}")
    what = ("the >= 200k-node tier forced (K7, K8)" if tier and not imp else
            "a TOTAL_CONDITIONS inlet (K9)" if total_conditions else
            "the main path")
    if imp:
        what = ("the implicit flow (K10) with the >= 200k-node tier forced "
                "(K7 rows into K10)" if tier else "the implicit flow (K10)")
        what += f", {prec}"
    if fused:
        what += ", the fused SST assembly (K12)"
    if species is not None and box is None:
        what += (f", {sim.lay.ns} species (v = {sim.lay.nvar}: "
                 f"{stencil_per_iter(sim, prec)} per iteration)")
    if tri:
        what = ("the triangle channel (no static stencil: K13, the SST "
                "solve's LU_SGS in torch gather ops)")
        if imp:
            what = (f"the implicit flow on the triangle channel (no static "
                    f"stencil: K11 on the edge rows, {prec} over the "
                    "gathered blocks in torch ops)")
    if tet is not None:
        what = ("explicit LU_SGS on the tet box (no static stencil: K13 at "
                "(3, 9), the 3D gather WLS)")
        if imp:
            what = (f"the implicit flow on the tet box (no static stencil: "
                    f"K11 in 3D on the edge rows, {prec} over the gathered "
                    "blocks in torch ops)")
    if box is not None:
        what = (f"the implicit flow on the 3D box ({sim.lay.ns} species: "
                f"K10 at (3, {sim.lay.ns}), {prec}: "
                f"{stencil_per_iter(sim, prec)} per iteration)")
    compare(lambda worst: phase(
        "step", f"5 iterations at {n} nodes f64 with {what}, card vs CPU "
        f"within rtol 1e-9, atol 1e-12*max|field| (largest difference "
        f"{worst:.3e} of its field's max); card launches {counts}"))


def laminar_step_phase(tmp, implicit=None, prec="JACOBI", tier=False,
                       tri=False, box=None):
    """5 laminar iterations (KIND_TURB_MODEL= NONE), card vs CPU, from the
    state after 10 card iterations of the flagship-class case: explicit
    (T4 once per iteration), or implicit (muscl, limiter) with prec (K11
    once per iteration; LU_SGS: the flow's 13 x 13 solve in f64's tier);
    tier=True forces the >= 200k-node tier on both sides (K7's rows, read
    node-major by the laminar edge terms); tri the triangle channel (no
    static stencil: implicit, K11 on the edge rows and the solve in torch
    gather ops); box, a shape of box_mesh (K11 in 3D on the family
    slots).  The CPU's half and the line as in step_phase."""
    import torch
    from su2_tpu_torch.linalg import stencil_solve as sts
    from su2_tpu_torch.ops import gradients
    saved = gradients.TILED_MIN_NODES
    if tier:
        gradients.TILED_MIN_NODES = 0
    try:
        compare, counts, sim = _step_compare(tmp, False, implicit, prec,
                                             laminar=True, tri=tri, box=box,
                                             tier=tier)
    finally:
        gradients.TILED_MIN_NODES = saved
    n = sim.mesh.npoint
    imp = implicit is not None
    want = {"ausm_flux_jac": 5 * imp, "chem_source": 5 * (not imp),
            "node_state": 5, "edge_implicit": 0, "edge_flux": 0,
            "edge_win": 0, "gradient_rows": 5 * tier, "sst_assemble": 0,
            "edge_list_flux": 0, "edge_list_sum": 0}
    lusgs = imp and prec != "JACOBI" and not tri
    one = lusgs and sts.solve_tier(n, sim.mesh.stencil_offsets, sim.lay.nvar,
                                   torch.float64, sim.ncolor, KRYLOV_M)[1]
    want.update(stencil_fgmres=5 * one,
                stencil_sgs_matvec=5 * KRYLOV_M * (lusgs and not one))
    for k, c in want.items():
        if counts[k] != c:
            raise AssertionError(f"laminar step: {k} launched {counts[k]} "
                                 f"times in the 5 compared card iterations,"
                                 f" expected {c}")
    what = (f"implicit ({prec}, K11)" if imp else "explicit (T4)") \
        + (" with the >= 200k-node tier forced (K7)" if tier else "") \
        + (" on the triangle channel (K11 on the edge rows)" if tri else "") \
        + (" on the 3D box (K11 in 3D)" if box is not None else "")
    compare(lambda worst: phase(
        "step", f"5 laminar iterations at {n} nodes f64, {what}, card vs "
        f"CPU within rtol 1e-9, atol 1e-12*max|field| (largest difference "
        f"{worst:.3e} of its field's max); card launches {counts}"))


def _step_compare(tmp, total_conditions, implicit=None, prec="JACOBI",
                  laminar=False, tri=False, tet=None, box=None, species=None,
                  tier=False, fused=False):
    """The card's half of a step check: the f64 case on the card, 10
    iterations, then STEP_CHECK_ITERS compared ones, whose start goes to
    a worker for the CPU's half (_cpu_steps; tier and fused: the settings
    the caller holds for the card's, held there too).  Returns (compare,
    the card's launches over the compared iterations, the card's case):
    compare(line) queues the comparison for finish_steps, which calls
    line with the largest difference over its field's max."""
    import torch
    from su2_tpu_torch import kernels
    prec = "LU_SGS" if implicit is None and not laminar else prec
    three = tet if tet is not None else box
    shape, nz = (three[:2], three[2]) if three is not None \
        else (SIZES["flagship"], None)
    kw = dict(total_conditions=total_conditions, implicit=implicit,
              laminar=laminar, tri=tri, nz=nz, box=box is not None,
              species=species)
    gpu = make_case(tmp, *shape, torch.float64, "cuda", prec, **kw)
    ncarry = 2 if laminar else 6
    s_gpu = (gpu.u0, gpu.t0) + (() if laminar
                                else tuple(gpu.initial_turb_state()))
    for _ in range(10):
        s_gpu = gpu._step(*s_gpu)[:ncarry]
    names = (("u", "t", "rms", "rmax", "nonphys", "min_dt") if laminar else
             ("u", "t", "q", "mu_t", "grad_k", "sigma_k", "rms", "rmax",
              "turb_rms", "nonphys", "min_dt"))
    job = dict(tmp=tmp, shape=tuple(shape), prec=prec, case=kw, tier=tier,
               fused=fused, ncarry=ncarry, nout=len(names),
               start=[x.detach().cpu().numpy() for x in s_gpu])
    result = cpu_pool().apply_async(_cpu_steps, (job,))
    kernels.reset_launches()
    card = []
    for _ in range(STEP_CHECK_ITERS):
        og = gpu._step(*s_gpu)
        card.append([x.detach().cpu() for x in og[:len(names)]])
        s_gpu = tuple(og[:ncarry])
    counts = dict(kernels.launches)

    def compare(line):
        PENDING_STEPS.append((result, card, names, line))
    return compare, counts, gpu


# the f64 step checks: STEP_CHECK_ITERS compared iterations each; their
# CPU halves run in CPU_WORKERS worker processes of CPU_THREADS torch
# threads each (the card's process keeps the other cores: its case
# builds and eager steps are host-bound), beside the card's phases from
# step_checks until finish_steps (before 6), so the plain versions on
# the CPU take none of the run's time but the wait
STEP_CHECK_ITERS = 5
CPU_WORKERS, CPU_THREADS = 2, 2
PENDING_STEPS = []
_POOL = []


def cpu_pool():
    """The worker pool of the step checks' CPU halves (spawned on first
    use: no CUDA in a worker)."""
    if not _POOL:
        import multiprocessing
        _POOL.append(multiprocessing.get_context("spawn").Pool(
            CPU_WORKERS, _cpu_worker_init, (CPU_THREADS,)))
    return _POOL[0]


def stop_cpu_pool(wait):
    """End the workers: after their queue (wait) or at once."""
    while _POOL:
        pool = _POOL.pop()
        if wait:
            pool.close()
        else:
            pool.terminate()
        pool.join()


def _cpu_worker_init(threads):
    import torch
    torch.set_num_threads(threads)


def _cpu_steps(job):
    """A step check's CPU half, in a worker: the f64 case of
    _step_compare's keywords on the CPU (its case files in a directory of
    the worker's own), STEP_CHECK_ITERS steps from the card's start;
    returns each step's outputs as numpy arrays and the wall clock
    (time.time()) at its end."""
    import torch
    from su2_tpu_torch.ops import gradients
    from su2_tpu_torch.turbulence import sst
    saved = gradients.TILED_MIN_NODES
    if job["tier"]:
        gradients.TILED_MIN_NODES = 0
    if job["fused"]:
        sst.set_assemble_mode("fused")
    try:
        tmp = os.path.join(job["tmp"], f"cpu{os.getpid()}")
        os.makedirs(tmp, exist_ok=True)
        sim = make_case(tmp, *job["shape"], torch.float64, "cpu",
                        job["prec"], **job["case"])
        state = tuple(torch.from_numpy(x) for x in job["start"])
        out = []
        for _ in range(STEP_CHECK_ITERS):
            oc = sim._step(*state)
            out.append([x.detach().clone().numpy()
                        for x in oc[:job["nout"]]])
            state = tuple(oc[:job["ncarry"]])
        return out, time.time()
    finally:
        gradients.TILED_MIN_NODES = saved
        sst.set_assemble_mode("unfused")


def finish_steps():
    """Wait for the step checks' CPU halves and end the workers; hold each
    card iteration against the CPU's (rtol 1e-9, atol 1e-12*max|field|,
    every output, every iteration) and print the check's line."""
    import torch
    t0 = time.perf_counter()
    n = len(PENDING_STEPS)
    last = 0.0
    while PENDING_STEPS:
        result, card, names, line = PENDING_STEPS.pop(0)
        cpu, ended = result.get()
        last = max(last, ended)
        if len(cpu) != len(card):
            raise AssertionError(f"step: {len(cpu)} CPU iterations against "
                                 f"{len(card)} on the card")
        worst = 0.0
        for it, (og, oc) in enumerate(zip(card, cpu)):
            for nm, a, b in zip(names, og, oc):
                a = a.double()
                b = torch.from_numpy(b).double()
                if not torch.isfinite(a).all():
                    raise AssertionError(f"step {it}: non-finite {nm}")
                err = (a - b).abs()
                bound = 1e-9 * b.abs() + 1e-12 * b.abs().max()
                if not bool((err <= bound).all()):
                    raise AssertionError(
                        f"step {it} {nm}: card vs CPU max err "
                        f"{err.max().item():.3e} outside rtol 1e-9, "
                        "atol 1e-12*max|field|")
                scale = b.abs().max().item()
                if scale > 0.0:
                    worst = max(worst, err.max().item() / scale)
        line(worst)
    stop_cpu_pool(wait=True)
    phase("step", f"{n} step checks' CPU halves (in {CPU_WORKERS} worker "
          f"processes of {CPU_THREADS} threads) done, the last at "
          f"+{last - T_START_WALL:.1f} s; waited "
          f"{time.perf_counter() - t0:.1f} s for them here")


def step_checks(tmp):
    """Every f64 step check (step_phase, laminar_step_phase: the card's
    halves here), those with the longest CPU halves first: the tet box's
    implicit LU_SGS and explicit LU_SGS (TET_STEP), the triangle
    channel's implicit LU_SGS and LINELET, the 3D box's implicit RANS and
    laminar LU_SGS (BOX_STEP), the triangle channel's laminar implicit
    JACOBI and explicit LU_SGS, then the channel's (9,072 nodes); the
    5-species box's and channel's implicit LU_SGS steps (K5/K6's run-time
    width: v = 10 and 9) among them."""
    venk = IMPLICIT_VARIANTS["venkatakrishnan"]
    step_phase(tmp, implicit=venk, prec="LU_SGS", tet=TET_STEP)
    step_phase(tmp, implicit=venk, prec="LU_SGS", box=BOX_STEP, species="5")
    step_phase(tmp, implicit=venk, prec="LU_SGS", tri=True)
    step_phase(tmp, tet=TET_STEP)
    step_phase(tmp, implicit=venk, prec="LINELET", tri=True)
    step_phase(tmp, implicit=venk, prec="LU_SGS", box=BOX_STEP)
    laminar_step_phase(tmp, implicit=venk, prec="LU_SGS", box=BOX_STEP)
    laminar_step_phase(tmp, implicit=venk, prec="JACOBI", tri=True)
    step_phase(tmp, tri=True)
    step_phase(tmp, fused=True)
    step_phase(tmp, implicit=venk, prec="LU_SGS", fused=True)
    step_phase(tmp, implicit=venk, prec="LU_SGS", species="5")
    laminar_step_phase(tmp)
    laminar_step_phase(tmp, implicit=venk, prec="LU_SGS")
    laminar_step_phase(tmp, implicit=venk, tier=True)
    step_phase(tmp)
    step_phase(tmp, tier=True)
    step_phase(tmp, total_conditions=True)
    step_phase(tmp, implicit=venk)
    step_phase(tmp, tier=True, implicit=venk)
    step_phase(tmp, implicit=venk, prec="LU_SGS")


def stencil_per_iter(sim, prec):
    """The K5 and K6 launches per iteration of sim's step from its solves'
    tiers (linalg/stencil_solve.solve_tier at Krylov budget KRYLOV_M): per
    solve one K6 cycle where the tier is one launch, else KRYLOV_M K5
    (z, A z); the solves are the implicit flow's (v = nVar) and the
    unfused SST's (v = 2) with an SGS-class preconditioner on a stencil
    mesh, none with JACOBI or without a stencil."""
    from su2_tpu_torch.linalg import stencil_solve as sts
    out = {"stencil_fgmres": 0, "stencil_sgs_matvec": 0}
    if prec == "JACOBI" or sim.mesh.stencil_offsets is None:
        return out
    widths = ([sim.lay.nvar] if sim.cfg.implicit_flow else []) \
        + ([2] if sim.turbulent else [])
    for v in widths:
        one = sts.solve_tier(sim.mesh.npoint, sim.mesh.stencil_offsets, v,
                             sim.dtype, sim.ncolor, KRYLOV_M)[1]
        if one:
            out["stencil_fgmres"] += 1
        else:
            out["stencil_sgs_matvec"] += KRYLOV_M
    return out


def flow_one_launch(sim):
    """Whether the implicit flow's solve of sim (v = nVar) is one K6 cycle
    in its tier."""
    from su2_tpu_torch.linalg import stencil_solve as sts
    return sts.solve_tier(sim.mesh.npoint, sim.mesh.stencil_offsets,
                          sim.lay.nvar, sim.dtype, sim.ncolor, KRYLOV_M)[1]


def fused_sst_tier(sim):
    """(sweep block dtype, one launch) of the SST solve of sim's fused
    step (linalg/stencil_solve.fused_sst_solve_tier)."""
    from su2_tpu_torch.linalg import stencil_solve as sts
    return sts.fused_sst_solve_tier(sim.mesh.npoint, sim.mesh.stencil_offsets,
                                    sim.dtype, sim.ncolor, KRYLOV_M)


# the stencil kernels' launches per iteration with LU_SGS: the explicit
# step's SST solve, one K6 cycle at 9,072 nodes, KRYLOV_M K5 (z, A z) at
# 142,317 and TIER_N (the mixed tier); the implicit step's flow (v = 13)
# and SST (v = 2) solves, one K6 cycle each at 9,072 nodes (the mixed
# one-launch tier for the flow), KRYLOV_M K5 each at the larger sizes
STENCIL_PER_ITER = {
    "flagship": {"stencil_fgmres": 1, "stencil_sgs_matvec": 0},
    "scaling": {"stencil_fgmres": 0, "stencil_sgs_matvec": KRYLOV_M},
    "tier": {"stencil_fgmres": 0, "stencil_sgs_matvec": KRYLOV_M}}
IMPLICIT_STENCIL_PER_ITER = {
    "flagship": {"stencil_fgmres": 2, "stencil_sgs_matvec": 0},
    "scaling": {"stencil_fgmres": 0, "stencil_sgs_matvec": 2 * KRYLOV_M},
    "tier": {"stencil_fgmres": 0, "stencil_sgs_matvec": 2 * KRYLOV_M}}


# the laminar implicit step's flow solve (v = 13) with LU_SGS: the mixed
# one-launch tier at 9,072 nodes, KRYLOV_M K5 (z, A z) at the larger sizes;
# the explicit laminar step solves no system
LAMINAR_STENCIL_PER_ITER = {
    "flagship": {"stencil_fgmres": 1, "stencil_sgs_matvec": 0},
    "scaling": {"stencil_fgmres": 0, "stencil_sgs_matvec": KRYLOV_M},
    "tier": {"stencil_fgmres": 0, "stencil_sgs_matvec": KRYLOV_M}}


def step_groups():
    """(module or class, function name, group) of the step's stages whose
    CUDA launches profile_steps counts apart; each call of one is wrapped
    in a torch.profiler range named by its group while the profile runs.
    The flow's solve is the top-level FGMRES (the torch Krylov loop or the
    one-launch K6 of StencilSolveOps), the SST's sits inside "SST
    solve"."""
    from su2_tpu_torch import state as st
    from su2_tpu_torch.geometry.mesh_data import MeshArrays
    from su2_tpu_torch.linalg import blockcsr, krylov, linelet
    from su2_tpu_torch.linalg.stencil_solve import StencilSolveOps
    from su2_tpu_torch.ops import (ausm_t, edge_flux, edge_implicit,
                                   limiters, viscous_t)
    from su2_tpu_torch.solvers import euler as es, ns
    from su2_tpu_torch.turbulence import sst, sst_assemble
    return [(st, "node_state", "node state"),
            (st, "node_state_lite", "node state"),
            (ns, "viscous_lambda", "viscous spectral radius"),
            (ns, "ns_assemble", "flow assembly"),
            (es, "compute_gradients", "gradients"),
            (es, "compute_gradient_rows", "gradients"),
            (limiters, "venkatakrishnan", "limiter"),
            (limiters, "barth_jespersen", "limiter"),
            (edge_implicit, "fused_implicit_family_terms", "edge terms"),
            (edge_flux, "fused_interior_terms", "edge terms"),
            (MeshArrays, "scatter_edges_mixed", "edge-to-node sums"),
            (blockcsr, "gather_offdiag", "neighbour blocks (gather)"),
            (blockcsr, "multicolor_sgs_apply", "multicolor sweep (gather)"),
            (blockcsr, "matvec", "matvec (gather)"),
            (es, "flux_bc_batch", "flux-BC ghost states"),
            (es, "ghost_dpdu", "boundary flux and Jacobians"),
            (ausm_t, "ausm_flux_t", "boundary flux and Jacobians"),
            (viscous_t, "viscous_flux_t", "boundary flux and Jacobians"),
            (es, "convective_system_fam", "convective system"),
            (es, "convective_system", "convective system"),
            (es, "edge_faces", "edge face states"),
            (es, "convective_residual", "convective residual"),
            (ns, "_edge_viscous", "edge-list viscous flux"),
            (es, "chemistry_source_system", "chemistry source"),
            (es, "chemistry_source_residual", "chemistry source"),
            (blockcsr, "block_diag_inv", "block inverse"),
            (StencilSolveOps, "__init__", "sweep block layout"),
            (krylov, "fgmres", "FGMRES"),
            (krylov, "bcgstab", "BCGSTAB"),
            (linelet, "make_linelet_apply", "line factorisation"),
            (StencilSolveOps, "fgmres", "FGMRES"),
            (sst, "sst_step", "SST solve"),
            (sst, "blending", "SST blending"),
            (sst, "_wall_rows", "SST wall rows"),
            (sst, "_weak_bc_batch", "SST weak BCs"),
            (sst_assemble, "sst_assemble", "SST assembly (K12)"),
            (sst, "_update", "SST update")]


def _group_chain(e, groups, memo):
    """The group ranges that enclose the host event e, outer first, read
    up the profiler's host event tree (cpu_parent); memo: {id: chain} of
    the events already walked."""
    chain = memo.get(id(e))
    if chain is None:
        p = e.cpu_parent
        chain = () if p is None else _group_chain(p, groups, memo) + (
            (p,) if p.name in groups else ())
        memo[id(e)] = chain
    return chain


def _group_path(chain):
    """A chain's "/"-joined names, a group called from itself named
    once."""
    names = []
    for a in chain:
        if not names or names[-1] != a.name:
            names.append(a.name)
    return "/".join(names)


def launches_by_group(events, groups):
    """{nested group path: launches} from profiler events: each launch
    goes to the chain of group ranges that enclose it on the host (outer
    first, "/"-joined, a group called from itself named once; "other"
    outside every range).  The ranges' device-side copies are not
    used."""
    memo, counts = {}, {}
    for e in events:
        if "LaunchKernel" not in e.name \
                and "LaunchCooperativeKernel" not in e.name:
            continue
        key = _group_path(_group_chain(e, groups, memo)) or "other"
        counts[key] = counts.get(key, 0) + 1
    return counts


def device_ms_by_group(events, groups):
    """{nested group path: device ms} from profiler events: the device
    time of the kernels each group range launched outside the group
    ranges nested in it (its exclusive time; paths as launches_by_group
    names them, a group called from itself counted in its outer call),
    and "other" for the rest of the kernels' device time."""
    import torch
    cpu = torch.autograd.DeviceType.CPU

    def dev_us(e):
        for attr in ("device_time_total", "cuda_time_total"):
            v = getattr(e, attr, None)
            if v is not None:
                return v
        return 0.0

    memo = {}
    chain = lambda e: _group_chain(e, groups, memo)
    counted = lambda e: not any(a.name == e.name for a in chain(e))
    ranges = [e for e in events if e.device_type == cpu
              and e.name in groups]
    excl, path = {}, {}
    for e in ranges:
        if not counted(e):
            continue
        anc = chain(e)
        path[id(e)] = _group_path(anc + (e,))
        excl[id(e)] = excl.get(id(e), 0.0) + dev_us(e)
        # the nearest enclosing counted range loses it
        parent = next((a for a in reversed(anc) if counted(a)), None)
        if parent is not None:
            excl[id(parent)] = excl.get(id(parent), 0.0) - dev_us(e)
    out = {}
    for k, us in excl.items():
        out[path[k]] = out.get(path[k], 0.0) + us
    top = sum(dev_us(e) for e in ranges if not chain(e))
    busy = sum(e.time_range.elapsed_us() for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name not in groups)
    out["other"] = busy - top
    return {k: v / 1e3 for k, v in out.items()}


def profile_steps(sim, state, niter=3):
    """(CUDA kernel launches, device-busy ms, {su2k kernel: device ms},
    {other device op: device ms} of the three largest, {stage path:
    launches}, CUDA API calls, device span ms, {stage path: device ms})
    per iteration over niter eager steps, from torch.profiler: launches
    are the runtime's launch calls, busy the summed device time of
    kernels, copies and sets; the stages are those of step_groups (device
    ms: device_ms_by_group, each stage's own kernels); the span from the
    first of those on the device to the end of the last, the window of
    busy (idle: 1 - busy / span; the profiler's own host work, which
    slows an eager step, is in it)."""
    import functools
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    def ranged(fn, name):
        @functools.wraps(fn)
        def call(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return call

    groups = step_groups()
    ncarry = 6 if sim.turbulent else 2
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in groups]
    torch.cuda.synchronize()
    try:
        for mod, attr, name in groups:
            setattr(mod, attr, ranged(getattr(mod, attr), name))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(niter):
                state = sim._step(*state)[:ncarry]
            torch.cuda.synchronize()
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    events = prof.events()
    names = {g for _, _, g in groups}
    by_group = launches_by_group(events, names)
    ms_by_group = device_ms_by_group(events, names)
    launches, busy_us, ours, other, api = 0, 0.0, {}, {}, 0
    lo, hi = float("inf"), float("-inf")
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA \
                and _is_api(e.name):
            api += 1
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name in names:
                continue        # a range's device-side copy, not work
            us = e.time_range.elapsed_us()
            busy_us += us
            lo, hi = min(lo, e.time_range.start), max(hi, e.time_range.end)
            m = re.search(r"su2k::(\w+)_kernel", e.name)
            if m:
                ours[m.group(1)] = ours.get(m.group(1), 0.0) + us
            else:
                key = e.name[:60]
                other[key] = other.get(key, 0.0) + us
        elif "LaunchKernel" in e.name or "LaunchCooperativeKernel" in e.name:
            launches += 1
    top = sorted(other.items(), key=lambda kv: -kv[1])[:3]
    return (launches / niter, busy_us / 1e3 / niter,
            {k: round(us / 1e3 / niter, 4) for k, us in sorted(ours.items())},
            {k: round(us / 1e3 / niter, 4) for k, us in top},
            {k: c / niter for k, c in sorted(by_group.items(),
                                             key=lambda kv: -kv[1])},
            api / niter, (hi - lo) / 1e3 / niter,
            {k: round(ms / niter, 4) for k, ms in sorted(
                ms_by_group.items(), key=lambda kv: -kv[1])})


def run_state(out, lam):
    """The carry (u, T[, q, mu_t, grad_k, sigma_k]) of a run's result."""
    return (out[0], out[1]) + (() if lam else tuple(out[3]))


def eager_iterations(sim, state, niter, chunk=25, dual=None):
    """niter iterations of sim's step run eagerly (Simulation._body: sim.
    _step, each kernel launched from the host, and its history row) from
    state (dual: the (u_n, u_nm1) of dual time stepping), the rows of each
    chunk copied to the host at once: the run loop before the graph.
    Returns the final state."""
    import torch
    it = 0
    while it < niter:
        k = min(chunk, niter - it)
        rows = []
        for _ in range(k):
            state, row = sim._body(state, None, None, dual)
            rows.append(row)
        torch.stack(rows).cpu()
        it += k
    return state


def _is_api(name):
    """A CUDA runtime or driver call among the profiler's host events."""
    return re.match(r"cu(da)?[A-Z]", name) is not None


def profile_run(sim, state, niter=3):
    """One chunk of niter iterations of sim.run from state (niter replays of
    the step's graph and the chunk's copies), from torch.profiler: (device
    kernels per iteration, {su2k kernel: launches per iteration}, device
    busy ms per iteration, host CUDA API calls per iteration, {API call:
    calls per iteration}, device span ms per iteration: from the start of
    the chunk's first device operation to the end of its last, the window
    of busy)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    lam = not sim.turbulent
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sim.run(niter, u=state[0], t_guess=state[1],
                turb_state=None if lam else state[2:], quiet=True,
                chunk=niter)
        torch.cuda.synchronize()
    kernels_n, ours, busy_us, api = 0, {}, 0.0, {}
    lo, hi = float("inf"), float("-inf")
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy_us += e.time_range.elapsed_us()
            lo, hi = min(lo, e.time_range.start), max(hi, e.time_range.end)
            if not e.name.startswith(("Memcpy", "Memset")):
                kernels_n += 1
            m = re.search(r"su2k::(\w+)_kernel", e.name)
            if m:
                ours[m.group(1)] = ours.get(m.group(1), 0) + 1
        elif _is_api(e.name):
            api[e.name] = api.get(e.name, 0) + 1
    return (kernels_n / niter, {k: c / niter for k, c in sorted(ours.items())},
            busy_us / 1e3 / niter, sum(api.values()) / niter,
            {k: c / niter for k, c in sorted(api.items())},
            (hi - lo) / 1e3 / niter)


def su2k_by_name(fn):
    """{su2k kernel: device launches} of fn(), from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        m = re.search(r"su2k::(\w+)_kernel", e.name)
        if e.device_type == torch.autograd.DeviceType.CUDA and m:
            out[m.group(1)] = out.get(m.group(1), 0) + 1
    return out


def graph_check(sim, label, niter=5):
    """The main path of sim through its CUDA graph against the eager step:
    after a 2-iteration warm-up run (which captures the graph; under dual
    time stepping two inner iterations of a physical step from the
    freestream, whose state is then both u_n and u_nm1), one eager
    step under torch.cuda.set_sync_debug_mode("error") (no host sync or
    pageable copy on the step's path), then niter iterations through the
    graph (Simulation._multistep: niter replays) and niter eager
    iterations (Simulation._body: sim._step and the history row) from the
    same state, bit for bit in the state and every history row; the
    wrappers' launches of the eager iterations and the launch counts of
    the replays (no wrapper runs in a replay) each equal the graph's
    captured launches per replay times niter; on the card
    (torch.profiler), each su2k kernel launched as many times in niter
    replays as in niter eager iterations, give or take one (a profiler
    window now and then loses a device event, PERF.md §7).  Prints one
    line; returns the captured launches per replay."""
    import torch
    from su2_tpu_torch import kernels
    lam = not sim.turbulent
    dual = kw = None
    if sim.dual_order:
        start = (sim.u0, sim.t0) + tuple(sim.initial_turb_state())
        state, _ = sim._multistep(start, 2, dual=(sim.u0, sim.u0))
        dual = (state[0], state[0])
        kw = dict(u_n=dual[0], u_nm1=dual[1])
    else:
        state = run_state(sim.run(2, quiet=True), lam)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sim._step(*state, **(kw or {}))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    kernels.reset_launches()
    carry, rows = state, []
    for _ in range(niter):
        carry, row = sim._body(carry, None, None, dual)
        rows.append(row)
    eager = dict(kernels.launches)
    kernels.reset_launches()
    gcarry, block = sim._multistep(state, niter, dual=dual)
    replayed = dict(kernels.launches)
    names = ("u", "t", "q", "mu_t", "grad_k", "sigma_k")
    for name, a, b in zip(names, gcarry, carry):
        if not torch.equal(a, b):
            raise AssertionError(f"graph {label}: {name} after {niter} "
                                 "replays differs from the eager step's "
                                 f"(max {(a - b).abs().max().item():.3e})")
    if not torch.equal(block, torch.stack(rows)):
        raise AssertionError(f"graph {label}: the history rows differ from "
                             "the eager step's")
    g = sim._graph
    per = {k: c for k, c in g.per_replay.items() if c}
    for k in kernels.launches:
        if not eager[k] == replayed[k] == niter * g.per_replay[k]:
            raise AssertionError(
                f"graph {label}: {k} launched {eager[k]} times in {niter} "
                f"eager iterations, counted {replayed[k]} in {niter} "
                f"replays, {g.per_replay[k]} per replay captured")
    prof_eager = su2k_by_name(lambda: eager_iterations(sim, state, niter,
                                                       dual=dual))
    prof_graph = su2k_by_name(lambda: sim._multistep(state, niter,
                                                     dual=dual))
    off = {k: (prof_graph.get(k, 0), prof_eager.get(k, 0))
           for k in set(prof_graph) | set(prof_eager)
           if abs(prof_graph.get(k, 0) - prof_eager.get(k, 0)) > 1}
    if off:
        raise AssertionError(f"graph {label}: su2k kernels on the card "
                             f"(launches in {niter} replays, in {niter} "
                             f"eager iterations) {off}")
    phase("graph", f"{label} ({sim.mesh.npoint} nodes, "
          f"{str(sim.dtype).split('.')[-1]}): {niter} iterations through "
          f"the captured graph bit for bit the eager step's (state and "
          f"history); no host sync in an eager step; capture "
          f"{g.capture_s:.3f} s; launches per replay {per}; su2k kernels "
          f"on the card per replay (profiler) "
          f"{ {k: c / niter for k, c in sorted(prof_graph.items())} }, per "
          f"eager iteration "
          f"{ {k: c / niter for k, c in sorted(prof_eager.items())} }")
    return per


# iterations of each graph_phase check (replays against eager iterations)
GRAPH_NITER = 2


def graph_phase(tmp, sims, lusgs, lam, tri, seen, gather=()):
    """graph_check, float32, on the paths that together launch every
    kernel: explicit LU_SGS at 9,072 nodes (T1-T4, K6 as one cluster at
    v = 2), 142,317 (K5 at v = 2) and TIER_N (K7, K8), implicit LU_SGS at
    9,072 (K10, K6 cooperative at v = 13) and 142,317 (K5 at v = 13), the
    laminar implicit LU_SGS case (K11), the triangle channel (K13), a
    TOTAL_CONDITIONS inlet (K9) and the fused SST assembly (K12); then
    gather's (label, sim) pairs (the paths without a static stencil:
    implicit and laminar triangles, K11 on the edge rows; the tet box,
    K13 at (3, 9)).  seen: the launch counts options_phase's graphs
    showed (K5's sweep-only and matvec-only forms).  Fails unless every
    kernel launched inside a graph."""
    import torch
    from su2_tpu_torch import kernels
    from su2_tpu_torch.turbulence import sst
    seen = set(seen)
    for label, sim in (("explicit LU_SGS", sims["flagship"]),
                       ("implicit LU_SGS", lusgs["flagship"]),
                       ("laminar implicit LU_SGS", lam["flagship"]),
                       ("triangles, explicit LU_SGS", tri["flagship"]),
                       ("explicit LU_SGS", sims["scaling"]),
                       ("implicit LU_SGS", lusgs["scaling"]),
                       ("explicit LU_SGS, the >= 200k-node tier",
                        sims["tier"])) + tuple(gather):
        seen |= set(graph_check(sim, label, GRAPH_NITER))
        sim.drop_graph()
    seen |= set(graph_check(make_case(
        tmp, *SIZES["flagship"], torch.float32, "cuda",
        total_conditions=True), "explicit LU_SGS, TOTAL_CONDITIONS inlet",
        GRAPH_NITER))
    os.environ["SU2_TPU_SST_ASSEMBLE"] = "pallas"
    try:
        seen |= set(graph_check(make_case(
            tmp, *SIZES["flagship"], torch.float32, "cuda"),
            "explicit LU_SGS, fused SST assembly", GRAPH_NITER))
    finally:
        del os.environ["SU2_TPU_SST_ASSEMBLE"]
        sst.set_assemble_mode("unfused")
    torch.cuda.empty_cache()
    missing = sorted(set(kernels.launches) - seen)
    if missing:
        raise AssertionError(f"graph: {missing} launched in no graph")


# the slice's options (cfg lines over the case; implicit: the implicit
# LU_SGS case): label -> (implicit, triangle channel, cfg lines)
DUAL_LINES = dict(UNST_TIMESTEP="2e-5", UNST_INT_ITER="2")
MUSCL_LINES = dict(SPATIAL_ORDER_FLOW="2ND_ORDER_LIMITER",
                   SLOPE_LIMITER_FLOW="VENKATAKRISHNAN")
OPTION_PATHS = {
    "dual time BDF2, explicit": (False, False, dict(
        DUAL_LINES, UNSTEADY_SIMULATION="DUAL_TIME_STEPPING-2ND_ORDER")),
    "dual time BDF1, implicit LU_SGS": (True, False, dict(
        DUAL_LINES, UNSTEADY_SIMULATION="DUAL_TIME_STEPPING-1ST_ORDER")),
    "explicit MUSCL": (False, False, MUSCL_LINES),
    "explicit MUSCL, triangles": (False, True, MUSCL_LINES),
    "CLIPPING_TEMPRATURE": (False, False, dict(CLIPPING_TEMPRATURE="YES")),
    "BCGSTAB, implicit LU_SGS": (True, False, dict(LINEAR_SOLVER="BCGSTAB")),
    "LINELET, implicit": (True, False, dict(LINEAR_SOLVER_PREC="LINELET")),
}
OPTION_NITER = 3


def option_case(tmp, label, dtype, device, size="flagship"):
    """OPTION_PATHS[label] on the channel of SIZES[size]."""
    implicit, tri, lines = OPTION_PATHS[label]
    return make_case(tmp, *SIZES[size], dtype, device,
                     "LU_SGS", tri=tri, settings=lines,
                     implicit=IMPLICIT_VARIANTS["venkatakrishnan"]
                     if implicit else None)


def option_want(sim, niter):
    """{kernel: launches} of niter iterations of an OPTION_PATHS case that
    the card run must show (per-form K5 counts of BCGSTAB's and LINELET's
    solves exactly: BCGSTAB(m) takes 2m + 1 matvecs and 2m sweeps, FGMRES
    m matvecs), and the kernels it must not launch."""
    cfg = sim.cfg
    imp, tri = cfg.implicit_flow, sim.mesh.stencil_offsets is None
    muscl = cfg.muscl_flow and not imp
    want = {"node_state": 2 * niter, "edge_implicit": niter * imp,
            "chem_source": niter * (not imp),
            "edge_flux": niter * (not imp and not muscl and not tri),
            "edge_list_flux": 0}
    if cfg.linear_solver == "BCGSTAB":
        want.update(stencil_sweep_only=2 * 2 * KRYLOV_M * niter,
                    stencil_matvec_only=2 * (2 * KRYLOV_M + 1) * niter,
                    stencil_fgmres=0)
    elif cfg.linear_solver_prec == "LINELET":
        want.update(stencil_sweep_only=0,
                    stencil_matvec_only=KRYLOV_M * niter)
    else:
        want.update(stencil_sweep_only=0, stencil_matvec_only=0)
    return want


def options_phase(tmp, runs):
    """The slice's options (OPTION_PATHS) in float64 at 9,072 nodes, card
    against CPU through the entry points a user calls: run_unsteady (2
    physical steps of 2 inner iterations, its u and T from 10 card
    iterations of the dual-time step, the turbulence state the
    freestream's) under dual time stepping, else run (OPTION_NITER
    iterations, one chunk of graph replays) from the state of 10 card
    iterations; state, history and
    turbulence state within rtol 1e-9, atol 1e-12 max|field|; the card
    run's launches (option_want; T1 on the MUSCL face rows: at least two
    launches an iteration) appended to runs; then graph_check of the card
    case (bit for bit its eager step).  Returns the launch counts the
    graphs showed."""
    import torch
    from su2_tpu_torch import kernels
    seen = set()
    for label in OPTION_PATHS:
        t0 = time.perf_counter()
        gpu = option_case(tmp, label, torch.float64, "cuda")
        cpu = option_case(tmp, label, torch.float64, "cpu")
        if gpu.dual_order:
            niter = 2 * gpu.cfg.unst_int_iter
            # both start from the state of 10 card iterations of the
            # dual-time step (which capture its graph), as step_phase's
            # comparisons start from a developed state
            start = (gpu.u0, gpu.t0) + tuple(gpu.initial_turb_state())
            dev, _ = gpu._multistep(start, 10, dual=(gpu.u0, gpu.u0))
            gpu.u0, gpu.t0 = dev[0], dev[1]
            cpu.u0, cpu.t0 = dev[0].cpu(), dev[1].cpu()
            kernels.reset_launches()
            got = gpu.run_unsteady(2, quiet=True)
            counts = dict(kernels.launches)
            want = cpu.run_unsteady(2, quiet=True)
        else:
            niter = OPTION_NITER
            start = run_state(gpu.run(10, quiet=True), False)
            kernels.reset_launches()
            got = gpu.run(niter, u=start[0], t_guess=start[1],
                          turb_state=start[2:], quiet=True, chunk=niter)
            counts = dict(kernels.launches)
            cs = tuple(x.cpu() for x in start)
            want = cpu.run(niter, u=cs[0], t_guess=cs[1], turb_state=cs[2:],
                           quiet=True, chunk=niter)
        worst = 0.0
        names = ("u", "t", "hist", "q", "mu_t", "grad_k", "sigma_k")
        for nm, a, b in zip(names, got[:3] + tuple(got[3]),
                            want[:3] + tuple(want[3])):
            a = torch.as_tensor(a).cpu().double()
            b = torch.as_tensor(b).double()
            if not torch.isfinite(a).all():
                raise AssertionError(f"{label}: non-finite {nm}")
            err = (a - b).abs()
            if not bool((err <= 1e-9 * b.abs()
                         + 1e-12 * b.abs().max()).all()):
                raise AssertionError(f"{label} {nm}: card vs CPU max err "
                                     f"{err.max().item():.3e} outside rtol "
                                     "1e-9, atol 1e-12*max|field|")
            worst = max(worst, err.max().item()
                        / max(b.abs().max().item(), 1e-300))
        for k, c in option_want(gpu, niter).items():
            if counts[k] != c:
                raise AssertionError(f"{label}: {k} launched {counts[k]} "
                                     f"times in {niter} card iterations, "
                                     f"expected {c}")
        muscl = gpu.cfg.muscl_flow and not gpu.cfg.implicit_flow
        if muscl and counts["mixture_enthalpy"] < 2 * niter:
            raise AssertionError(f"{label}: T1 launched "
                                 f"{counts['mixture_enthalpy']} times")
        runs.append((f"{gpu.mesh.npoint} f64 {label}", counts, niter))
        phase("options", f"{label}: {niter} iterations at "
              f"{gpu.mesh.npoint} nodes f64, card vs CPU within rtol 1e-9,"
              f" atol 1e-12*max|field| (largest difference {worst:.3e} of "
              f"its field's max); card launches {counts}; "
              f"{time.perf_counter() - t0:.1f} s")
        seen |= set(graph_check(gpu, f"{label} (f64)", 3))
        del gpu, cpu
        torch.cuda.empty_cache()
    return seen


def slice_phase(sim, size, niter, card, prec="LU_SGS", profile=False,
                stats=None, prof_iters=1, stencil=None):
    """Time niter iterations of Simulation.run (chunks of 25: replays of
    the step's CUDA graph) after a 2-iteration warm-up (which captures
    it), then the same iterations through the eager step from the same
    start; check the history, the state and the launch counts (the
    replays' launches, niter times the graph's per_replay, equal to the
    eager step's), print one line; profile: also prof_iters profiled eager
    iterations and as many profiled replays (1 by default: reading a
    profile's events takes seconds, and the run's time limit holds every
    slice); stencil: the K5/K6 launches per iteration the run must show,
    where the size's table or the solves' tiers (stencil_per_iter) do not
    give them (BCGSTAB, LINELET).
    The graph is dropped at the end.  Returns the
    launch counts of the graph run; stats, a dict, receives ms/iter
    (graph and eager) and the profiles' launches, kernels, API calls and
    busy ms per iteration."""
    import numpy as np
    import torch
    from su2_tpu_torch import kernels
    from su2_tpu_torch.turbulence import sst
    n = sim.mesh.npoint
    lam = not sim.turbulent
    # the fused SST assembly, where sst_step's gate holds (LU_SGS)
    fused = not lam and prec != "JACOBI" and sst.assemble_mode() == "fused"
    # warm-up outside the counted, timed run
    start = run_state(sim.run(2, quiet=True), lam)
    u, t, ts = start[0], start[1], None if lam else start[2:]
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = sim.run(niter, u=u, t_guess=t, turb_state=ts, quiet=True,
                  chunk=25)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    u, t, hist = out[:3]
    ts = None if lam else out[3]
    counts = dict(kernels.launches)
    if counts != {k: niter * c for k, c in sim._graph.per_replay.items()}:
        raise AssertionError(f"{size}: the graph run's launches {counts} "
                             f"are not {niter} replays' "
                             f"{sim._graph.per_replay}")
    kernels.reset_launches()
    t0 = time.perf_counter()
    eager_iterations(sim, start, niter)
    torch.cuda.synchronize()
    eager_wall = time.perf_counter() - t0
    if dict(kernels.launches) != counts:
        raise AssertionError(f"{size}: the graph run's launches {counts} "
                             f"differ from the eager step's "
                             f"{dict(kernels.launches)}")
    if len(hist) != niter or not np.isfinite(hist).all() \
            or not torch.isfinite(u).all():
        raise AssertionError(f"{size}: non-finite residual history or state")
    # the tier runs K8 instead of T3 and sweeps its gradients with K7: the
    # flow sweep, plus the turbulence sweep (one merged sweep when the
    # flow and turbulence methods match, else two)
    from su2_tpu_torch.ops import gradients
    tier = gradients.use_tiled(sim.mesh)
    sweeps = 1 if lam else (
        2 if sim.scfg.grad_method == sim.cfg.num_method_grad else 3)
    n_tc = sum(bc.kind == "inlet" and bc.inlet_mode == "TOTAL_CONDITIONS"
               for bc in sim.bcs)
    # implicit flow: K10 instead of T3/K8, the source system in torch ops;
    # laminar: one node state, no fused edge kernel, implicit through K11
    imp = sim.cfg.implicit_flow
    # meshes without a static stencil (triangles, tetrahedra): K13 for T3
    # (explicit RANS), K11 for K10 (implicit), the solves in torch gather
    # ops
    tri = sim.mesh.stencil_offsets is None
    want = {"node_state": (1 if lam else 2) * niter,
            "edge_flux": 0 if tier or imp or lam or tri else niter,
            "edge_list_flux": niter if tri and not (imp or lam) else 0,
            "edge_list_sum": niter if tri and not (imp or lam) else 0,
            "edge_win": niter if tier and not (imp or lam) else 0,
            "edge_implicit": niter if imp and not (lam or tri) else 0,
            "ausm_flux_jac": niter if imp and (lam or tri) else 0,
            "gradient_rows": sweeps * niter if tier else 0,
            "chem_source": 0 if imp else niter, "inlet_tc": n_tc * niter,
            "sst_assemble": niter if fused else 0}
    for k, c in want.items():
        if counts[k] != c:
            raise AssertionError(f"{size}: {k} launched {counts[k]} times "
                                 f"in {niter} iterations, expected {c}")
    if counts["mixture_enthalpy"] < niter:
        raise AssertionError(f"{size}: mixture_enthalpy launched "
                             f"{counts['mixture_enthalpy']} < {niter}")
    table = (LAMINAR_STENCIL_PER_ITER if lam else
             IMPLICIT_STENCIL_PER_ITER if imp else STENCIL_PER_ITER)
    per = ({k: 0 for k in table["flagship"]} if tri
           else dict(stencil) if stencil is not None
           else dict(table[size]) if size in table
           else stencil_per_iter(sim, "LU_SGS"))
    if fused:
        # the SST's solve in the fused tier in place of the unfused one
        _, one = fused_sst_tier(sim)
        for k, c in STENCIL_PER_ITER[size].items():
            per[k] -= c
        per["stencil_fgmres"] += one
        per["stencil_sgs_matvec"] += KRYLOV_M * (not one)
    for k, per_iter in per.items():
        want_k = per_iter * niter if prec == "LU_SGS" or stencil is not None \
            else 0
        if counts[k] != want_k:
            raise AssertionError(f"{size} {prec}: {k} launched {counts[k]} "
                                 f"times in {niter} iterations, expected "
                                 f"{want_k}")
    # the mixing layer reacts: species production of the final state
    from su2_tpu_torch import state as st
    lay = sim.lay
    v = st.node_state(sim.lib, lay, u, t, sim.tparams,
                      turb_ke=None if lam else ts[0][:, 0]).v
    omega = kernels.chem_source(sim.lib, sim.params, v[:, lay.T],
                                v[:, lay.PRHO], v[:, lay.YS:],
                                None if lam else ts[0][:, 1])
    om_max = omega.abs().max().item()
    if not om_max > 0.0:
        raise AssertionError(f"{size}: no species production")
    ms = wall * 1e3 / niter
    eager_ms = eager_wall * 1e3 / niter
    prof = ""
    if stats is not None:
        stats.update(ms=ms, eager_ms=eager_ms)
    if profile:
        state = (u, t) + (() if lam else tuple(ts))
        (cuda_launches, busy, ours, top, by_group, api, p_ms,
         ms_by_group) = profile_steps(sim, state, prof_iters)
        g_kern, _, g_busy, g_api, g_api_by, g_ms = profile_run(sim, state,
                                                               prof_iters)
        if stats is not None:
            stats.update(launches=cuda_launches, busy=busy, api=api,
                         span=p_ms, graph_kernels=g_kern, graph_busy=g_busy,
                         graph_api=g_api, graph_span=g_ms,
                         ms_by_stage=ms_by_group)
        prof = (f", profiled: eager {cuda_launches:.1f} CUDA launches/iter "
                f"({api:.1f} CUDA API calls/iter), device busy {busy:.3f} "
                f"of a {p_ms:.3f} ms/iter device span (idle "
                f"{1 - busy / p_ms:.1%}), "
                f"su2k kernels' device ms/iter {ours}, the largest "
                f"other device ops' ms/iter {top}, CUDA launches/iter by "
                f"stage {by_group}, device ms/iter by stage (each stage's "
                f"own kernels) {ms_by_group}; graph {g_kern:.1f} device "
                "kernels per "
                f"replay, {g_api:.2f} CUDA API calls/iter {g_api_by}, "
                f"device busy {g_busy:.3f} of a {g_ms:.3f} ms/iter device "
                f"span (idle {1 - g_busy / g_ms:.1%})")
    dt = str(sim.dtype).split(".")[-1]
    if n_tc:
        prec = f"{prec}, TOTAL_CONDITIONS inlet"
    if imp:
        prec = f"implicit flow ({sim.cfg.spatial_order_flow}), {prec}"
    if lam:
        prec = f"laminar {prec if imp else 'explicit flow'}"
    if fused:
        prec = f"{prec}, fused SST assembly (K12)"
    if tri:
        kern = "K11" if imp else "K13"
        shape = "triangle channel" if sim.lay.ndim == 2 else "tet box"
        prec = f"{prec}, {shape} ({sim.mesh.nedge} edges, {kern})"
    elif sim.lay.ndim == 3:
        prec = f"{prec}, 3D box, {sim.lay.ns} species (v = {sim.lay.nvar})"
    elif sim.lay.ns != 9:
        prec = f"{prec}, {sim.lay.ns} species (v = {sim.lay.nvar})"
    phase("slice", f"{n} nodes {dt} {prec} x {niter}: graph {ms:.3f} "
          f"ms/iter, eager {eager_ms:.3f} ms/iter, {n / (ms * 1e3):.3f} "
          f"Mcell-updates/s, log10 rms[rho] {hist[0][0]:.4f} -> "
          f"{hist[-1][0]:.4f}, max|omega| {om_max:.4g} kg/(m^3 s), kernel "
          f"launches {counts}{prof} ({card})")
    sim.drop_graph()
    torch.cuda.empty_cache()
    return counts


def fused_slice(tmp, size, niter, card, implicit=None):
    """The explicit (or implicit, (muscl, limiter)) LU_SGS case built by
    Simulation with SU2_TPU_SST_ASSEMBLE=pallas (the fused SST assembly),
    timed and profiled by slice_phase; the variable and the mode reset
    afterwards.  Returns (launch counts, stats)."""
    import torch
    from su2_tpu_torch.turbulence import sst
    os.environ["SU2_TPU_SST_ASSEMBLE"] = "pallas"
    try:
        sim = make_case(tmp, *SIZES[size], torch.float32, "cuda",
                        implicit=implicit)
        if sst.assemble_mode() != "fused":
            raise AssertionError("SU2_TPU_SST_ASSEMBLE=pallas did not set "
                                 "the fused SST assembly")
        stats = {}
        counts = slice_phase(sim, size, niter, card, profile=True,
                             stats=stats)
    finally:
        del os.environ["SU2_TPU_SST_ASSEMBLE"]
        sst.set_assemble_mode("unfused")
    return counts, stats


def print_pair(label, unfused, fused):
    """One line: the unfused and the fused run of one size side by side
    (idle: 1 - busy / the profiled window's device span)."""
    def fmt(st):
        return (f"graph {st['ms']:.3f} ms/iter (device busy "
                f"{st['graph_busy']:.3f}, idle "
                f"{1 - st['graph_busy'] / st['graph_span']:.1%}), eager "
                f"{st['eager_ms']:.3f} ms/iter ({st['launches']:.1f} CUDA "
                f"launches/iter, device busy {st['busy']:.3f}, idle "
                f"{1 - st['busy'] / st['span']:.1%})")
    phase("fused", f"{label}: unfused {fmt(unfused)}; fused (K12) "
          f"{fmt(fused)}")


# the output phase: the 9,072-node explicit LU_SGS case run OUTPUT_NITER
# iterations in chunks of 25 with WRT_SOL_FREQ= OUTPUT_FREQ, the volume
# formats it writes (CGNS_SOL and MESH_FORMAT= CGNS need h5py, an
# optional dependency this script does not take on:
# tests/test_torch_output.py covers them on the CPU), the monitored
# walls, the monitoring run's iterations
OUTPUT_NITER, OUTPUT_FREQ = 50, 25
OUTPUT_FORMATS = {"TECPLOT": "flow.dat", "TECPLOT_BINARY": "flow.plt",
                  "PARAVIEW": "flow.vtk", "FIELDVIEW": "flow.uns"}
MONITORED = ("lower_wall", "upper_wall")
MONITOR_NITER = 20


def force_scale(sim):
    """The scale of sim's force coefficients over MARKER_MONITORING: the
    coefficient of the freestream pressure on every monitored vertex (the
    markers' summed |normal|, times the largest moment arm over the
    reference length where above 1).  A coefficient differences
    pressures of ~1e5 Pa down to O(1), so the state's atol 1e-12*max|p|
    carries over to it as 1e-12 times this scale."""
    import numpy as np
    cfg, grid = sim.cfg, sim.grid
    _, _, p_inf, rho_inf, vel_inf, _ = sim.freestream_primitives()
    q_dyn = 0.5 * rho_inf * float(np.dot(vel_inf, vel_inf)) \
        * (cfg.ref_area if cfg.ref_area > 0 else 1.0)
    tags = cfg.marker_monitoring
    arm = max(np.abs(grid.coords[grid.bnd_nodes[t]]
                     - cfg.ref_origin_moment_x).max() for t in tags)
    area = sum(np.abs(grid.bnd_normal[t]).sum() for t in tags)
    return p_inf * area * max(1.0, arm / cfg.ref_length) / q_dyn


def forces_leaves(forces, where="forces"):
    """[(name, value)] of monitor_forces' dict: totals, splits, per
    marker."""
    if isinstance(forces, dict):
        return [x for k in sorted(forces)
                for x in forces_leaves(forces[k], f"{where}.{k}")]
    if isinstance(forces, tuple):
        return [x for i, f in enumerate(forces)
                for x in forces_leaves(f, f"{where}[{i}]")]
    return [(where, float(forces))]


def close_f64(label, got, want, names, scale=None):
    """Card (got) against CPU (want) float64 tensors at rtol 1e-9, atol
    1e-12*max|field| (scale: max|field| given); the largest difference
    over its field's max."""
    import torch
    worst = 0.0
    for nm, a, b in zip(names, got, want):
        a, b = torch.as_tensor(a).cpu().double(), torch.as_tensor(b).double()
        sc = b.abs().max().item() if scale is None else scale
        err = (a - b).abs()
        if not bool(torch.isfinite(a).all()) or not bool(
                (err <= 1e-9 * b.abs() + 1e-12 * sc).all()):
            raise AssertionError(f"output: {label} {nm}: card vs CPU max err "
                                 f"{err.max().item():.3e} outside rtol 1e-9,"
                                 f" atol 1e-12*{sc:.3e}")
        if sc > 0.0:
            worst = max(worst, err.max().item() / sc)
    return worst


def output_phase(tmp, card, big):
    """The output phase (after 6): run(OUTPUT_NITER, chunk=25) of the
    9,072-node explicit LU_SGS case in f32 through the graph with
    WRT_SOL_FREQ= OUTPUT_FREQ (the writes between chunks, outside the
    graph: the launches are the replays' and one T2 a write), the restart,
    history and surface files and the volume file in each of
    OUTPUT_FORMATS; RESTART_SOL= YES reads the restart back to the run's
    final u and q bit for bit in file order.  In f64 from that restart,
    card vs CPU: the recomputed mu_t, grad_k, sigma_k (T2 and the gradient
    on the card) and run(5); then monitor_forces over MONITORED on the
    restarted run's state and forces_breakdown.dat.  One line of times:
    write_solution at 9,072 nodes and on big (the TIER_N-node case), and
    ms/iter of MONITOR_NITER iterations with MARKER_MONITORING (chunk 1,
    forces in every history row) beside the same at chunk 25 without."""
    import numpy as np
    import torch
    from su2_tpu_torch import kernels
    t_phase = time.perf_counter()
    out = os.path.join(tmp, "output")
    os.makedirs(out)
    flag = SIZES["flagship"]
    sim = make_case(tmp, *flag, torch.float32, "cuda",
                    settings={"WRT_SOL_FREQ": OUTPUT_FREQ})
    sim.run(1, quiet=True, chunk=25)        # captures the step's graph
    sim.enable_output(out)
    kernels.reset_launches()
    u, t, hist, turb = sim.run(OUTPUT_NITER, quiet=True, chunk=25)
    counts = dict(kernels.launches)
    want = {k: OUTPUT_NITER * c for k, c in sim._graph.per_replay.items()}
    want["node_state"] += OUTPUT_NITER // OUTPUT_FREQ
    if counts != want or not np.isfinite(hist).all():
        raise AssertionError(f"output: run({OUTPUT_NITER}) launched {counts}"
                             f", expected {want} (the replays and one T2 a "
                             "write), finite history "
                             f"{np.isfinite(hist).all()}")
    pair = (turb[0], turb[1])
    for fmt, name in OUTPUT_FORMATS.items():
        if fmt != "TECPLOT":
            sim.cfg.output_format = fmt
            sim.write_solution(u, t, pair)
    sim.cfg.output_format = "TECPLOT"
    names = ["restart_flow.dat", "history.dat", "surface_flow.dat",
             *OUTPUT_FORMATS.values()]
    sizes = {nm: os.path.getsize(os.path.join(out, nm)) for nm in names}
    if not all(sizes.values()):
        raise AssertionError(f"output: empty files {sizes}")
    restart = os.path.join(out, "restart_flow.dat")
    back = make_case(tmp, *flag, torch.float32, "cuda",
                     settings={"RESTART_SOL": "YES",
                               "SOLUTION_FLOW_FILENAME": restart})
    if not (np.array_equal(back.to_file_order(back.u0.cpu().numpy()),
                           sim.to_file_order(u.cpu().numpy()))
            and np.array_equal(
                back.to_file_order(back.initial_turb_state()[0].cpu().numpy()),
                sim.to_file_order(turb[0].cpu().numpy()))):
        raise AssertionError("output: the restart read back is not the run's"
                             " final u and q bit for bit")
    phase("output", f"run({OUTPUT_NITER}, chunk=25) at {sim.mesh.npoint} "
          f"nodes f32 with WRT_SOL_FREQ= {OUTPUT_FREQ}: launches the "
          f"replays' and one T2 a write; wrote {sizes} (bytes); RESTART_SOL "
          "reads back its final u and q bit for bit in file order")
    del back
    # f64 from that restart, card vs CPU
    rs = {"RESTART_SOL": "YES", "SOLUTION_FLOW_FILENAME": restart}
    gpu, cpu = (make_case(tmp, *flag, torch.float64, dev, settings=rs)
                for dev in ("cuda", "cpu"))
    turb_names = ("q", "mu_t", "grad_k", "sigma_k")
    w_post = close_f64("restart post-processing", gpu.initial_turb_state(),
                       cpu.initial_turb_state(), turb_names)
    og, oc = gpu.run(5, quiet=True, chunk=5), cpu.run(5, quiet=True, chunk=5)
    w_run = close_f64("5 iterations from the restart",
                      og[:3] + tuple(og[3]), oc[:3] + tuple(oc[3]),
                      ("u", "t", "hist") + turb_names)
    mon = {"MARKER_MONITORING": f"( {', '.join(MONITORED)} )"}
    gm, cm = (make_case(tmp, *flag, torch.float64, dev, settings=mon)
              for dev in ("cuda", "cpu"))
    state = (oc[0], oc[1], (oc[3][0], oc[3][1]))
    kernels.reset_launches()
    fg = gm.monitor_forces(*(x.cuda() for x in state[:2]),
                           tuple(x.cuda() for x in state[2]))
    if kernels.launches["node_state"] != 1:
        raise AssertionError("output: monitor_forces on the card ran no T2")
    fc = cm.monitor_forces(*state)
    lg, lc = forces_leaves(fg), forces_leaves(fc)
    if [k for k, _ in lg] != [k for k, _ in lc]:
        raise AssertionError("output: the card's and the CPU's forces differ "
                             "in their keys")
    w_forces = close_f64("monitor_forces", [v for _, v in lg],
                         [v for _, v in lc], [k for k, _ in lg],
                         scale=force_scale(cm))
    breakdown = os.path.join(out, "forces_breakdown.dat")
    gm.write_forces_breakdown(*(x.cuda() for x in state[:2]),
                              tuple(x.cuda() for x in state[2]),
                              path=breakdown)
    if not os.path.getsize(breakdown):
        raise AssertionError("output: empty forces_breakdown.dat")
    phase("output", f"f64 from the restart, card vs CPU within rtol 1e-9, "
          f"atol 1e-12*max|field|: recomputed mu_t, grad_k, sigma_k "
          f"(largest difference {w_post:.3e} of its field's max), 5 "
          f"iterations ({w_run:.3e}); monitor_forces over {MONITORED} "
          f"({len(lg)} coefficients, atol 1e-12 x the pressure force scale "
          f"{force_scale(cm):.3e}: {w_forces:.3e}); forces_breakdown.dat "
          f"{os.path.getsize(breakdown)} bytes")
    del gpu, cpu, gm, cm
    # times: write_solution at 9,072 and TIER_N nodes; monitoring
    times = {}
    t0 = time.perf_counter()
    sim.write_solution(u, t, pair)
    times[f"write_solution {sim.mesh.npoint} s"] = time.perf_counter() - t0
    big_out = os.path.join(tmp, "output_big")
    os.makedirs(big_out)
    big.enable_output(big_out)
    bturb = big.initial_turb_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    big.write_solution(big.u0, big.t0, (bturb[0], bturb[1]))
    times[f"write_solution {big.mesh.npoint} s"] = time.perf_counter() - t0
    big.history = big.out_dir = None
    del bturb
    shutil.rmtree(big_out)
    ms = make_case(tmp, *flag, torch.float32, "cuda",
                   settings={"MARKER_MONITORING": mon["MARKER_MONITORING"]})
    ms.run(2, quiet=True)                   # captures the step's graph
    os.makedirs(os.path.join(out, "monitored"))
    ms.enable_output(os.path.join(out, "monitored"))
    mon_ms = wall_ms(lambda: ms.run(MONITOR_NITER, quiet=True, chunk=1),
                     MONITOR_NITER)
    plain_ms = wall_ms(lambda: sim.run(MONITOR_NITER, quiet=True, chunk=25),
                       MONITOR_NITER)
    rows = [ln for ln in open(os.path.join(ms.out_dir, "history.dat"))
            if ln[:1].isdigit()]
    if len(rows) != MONITOR_NITER or float(rows[-1].split(",")[2]) <= 0.0:
        raise AssertionError("output: the monitored run's history has no "
                             "drag in its rows")
    times["monitored ms/iter (chunk 1)"] = mon_ms
    times["ms/iter (chunk 25, no monitoring)"] = plain_ms
    times["phase s"] = time.perf_counter() - t_phase
    phase("output", f"{card}: " + "; ".join(
        f"{k} {v:.4f}" for k, v in times.items()))
    print(json.dumps({"output_times": {k: round(v, 4)
                                       for k, v in times.items()},
                      "card": card}), flush=True)


# the sources whose kernels --time-kernels counts SASS instructions of, by
# the tag of the kernels they hold: the edge kernels (T3, K8, K13, K10),
# K11, K5/K6, T2, K7 and T4; K13's runs count T3's and K8's too (the
# per-edge body they share)
SASS_SOURCES = {"edge_flux.cu": {"K8", "K13"}, "edge_win.cu": {"K8", "K13"},
                "edge_list.cu": {"K8", "K13"}, "edge_implicit.cu": {"K10"},
                "edge_implicit_3d.cu": {"K10"},
                "ausm_jac.cu": {"K10", "K11"},
                "stencil_solve.cu": {"K5", "K6"},
                "node_state.cu": {"T2"}, "gradients_tiled.cu": {"K7"},
                "chem_source.cu": {"T4"}}
# the kernels --time-kernels times (--only takes a subset)
TIMED = frozenset({"T1", "T2", "K5", "K6", "K7", "K8", "K9", "K10", "K11",
                   "T4", "K12", "K13"})


def sass_counts(root, only=TIMED):
    """({kernel: [SASS instructions, LDL, STL]}, ptxas lines) of root's
    SASS_SOURCES of the kernels of only (nvcc -cubin -Xptxas -v with the
    build's flags, one nvcc per source, all started together; cuobjdump
    -sass)."""
    from su2_tpu_torch import kernels
    csrc = os.path.join(root, "su2_tpu_torch", "csrc")
    dump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    flags = [f for f in kernels.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cubin = lambda src: os.path.join(tmp, src + ".cubin")
        srcs = [src for src, tags in SASS_SOURCES.items() if tags & only]
        procs = [subprocess.Popen([kernels._nvcc(), *flags, "-Xptxas", "-v",
                                   "-cubin", "-o", cubin(src),
                                   os.path.join(csrc, src)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src in srcs]
        logs = [p.communicate()[0] for p in procs]
        if any(p.returncode for p in procs):
            raise RuntimeError("nvcc -cubin failed:\n" + "\n".join(logs))
        for src in srcs:
            text = subprocess.run([dump, "-sass", cubin(src)], check=True,
                                  capture_output=True, text=True).stdout
            name = None
            for line in text.splitlines():
                m = re.search(r"Function : (\S+)", line)
                if m:
                    name = demangle(m.group(1))
                    out[name] = [0, 0, 0]
                    continue
                m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?(\S+)",
                              line)
                if m and name:
                    op = m.group(2)
                    out[name][0] += 1
                    out[name][1] += op.startswith("LDL")
                    out[name][2] += op.startswith("STL")
    return out, [ln for log in logs for ln in ptxas_summary(log)]


def device_ms(fn, reps=20, warm=3):
    """Device milliseconds per fn() call of the su2k kernels it launches
    (torch.profiler, profiled): the kernels alone, without the host work
    that cuda_time's events include."""
    return profiled(fn, reps, warm, lambda e: "su2k::" in e.name)[0]


def profiled(fn, reps, warm, keep):
    """(device ms of the CUDA events e with keep(e), CUDA kernel launches
    of the runtime, {name: device ms} of those events by name) per fn()
    call, each the median over three torch.profiler windows of reps calls:
    a window taken after another sometimes loses device events, or holds
    some of the one before (the runtime's launch calls, host events, are
    counted whole)."""
    import statistics
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    launches, by_name = [], []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = prof.events()
        ops = {}
        for e in ev:
            if e.device_type == torch.autograd.DeviceType.CUDA and keep(e):
                ops[e.name[:96]] = ops.get(e.name[:96], 0.0) \
                    + e.time_range.elapsed_us() / 1e3 / reps
        by_name.append(ops)
        launches.append(sum("LaunchKernel" in e.name for e in ev
                            if e.device_type
                            == torch.autograd.DeviceType.CPU) / reps)
    names = sorted({k for ops in by_name for k in ops})
    return (statistics.median(sum(ops.values()) for ops in by_name),
            statistics.median(launches),
            {k: statistics.median(ops.get(k, 0.0) for ops in by_name)
             for k in names})


def call_profile(fn, reps=20, warm=3):
    """(device ms, CUDA kernel launches) per fn() call of everything fn
    puts on the card (kernels of any name, copies, sets; profiled)."""
    return profiled(fn, reps, warm, lambda e: True)[:2]


def time_call(out, label, call, **extra):
    """out[label]: event ms (host included), device_ms (the su2k kernels
    alone), and the call's device ms, CUDA launches and device operations
    by name (profiled, every device event)."""
    dev_all, ops, by_name = profiled(call, 20, 3, lambda e: True)
    out[label] = dict(ms=cuda_time(call), device_ms=device_ms(call),
                      call_device_ms=dev_all, call_launches=ops,
                      ops=by_name, **extra)


# nvcc flags T2's full pass is timed under besides the library's own (what
# sets its time, PERF.md §6): IEEE division and square root replaced by
# the approximate ones (float only; double keeps IEEE)
T2_APPROX_FLAGS = ("-prec-div=false", "-prec-sqrt=false")


def t2_approx_lib(tmp):
    """(ctypes library, ptxas line of node_state_kernel<float, 9, full>) of
    node_state.cu alone, built with the kernel library's flags and
    T2_APPROX_FLAGS, su2k_node_state bound as kernels binds it."""
    import ctypes
    from su2_tpu_torch import kernels
    so = os.path.join(tmp, "t2_approx.so")
    proc = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, *T2_APPROX_FLAGS, "-Xptxas",
         "-v", "-shared", "-o", so, os.path.join(kernels.CSRC,
                                                 "node_state.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc ({' '.join(T2_APPROX_FLAGS)}) failed:\n"
                           f"{proc.stdout}")
    lib = ctypes.CDLL(so)
    lib.su2k_node_state.argtypes = kernels._ARGTYPES["su2k_node_state"]
    lib.su2k_node_state.restype = ctypes.c_int
    return lib, [ln for ln in ptxas_summary(proc.stdout)
                 if "<float, 9, full>" in ln]


def time_kernels(tmp, only=TIMED):
    """{label: ms} of the kernels of only (tags of TIMED) as the module
    docstring's --time-kernels describes them, through the calls that this
    checkout and its parent share (kernels.node_state, StencilSolveOps,
    kernels.edge_implicit, kernels.edge_win, kernels.gradient_rows,
    kernels.chem_source, kernels.edge_list_flux,
    ops.edge_flux.fused_interior_terms, kernels.mixture_enthalpy,
    solvers.inlet_tc.solve, turbulence.sst_assemble.sst_assemble)."""
    import torch
    from su2_tpu_torch import kernels, state as st
    from su2_tpu_torch.linalg import blockcsr, stencil_solve as ts
    from su2_tpu_torch.ops import edge_flux as ef
    out = {}
    if only & {"K7", "T4"}:
        time_k7_t4(tmp, out, only)
    if "K13" in only:
        time_k13(tmp, out)
    if only & {"T1", "K9", "K12"}:
        time_t1_k9_k12(tmp, out, only)
    if "K11" in only:
        time_k11(tmp, out)
    if only & {"K5", "K6"}:
        time_runtime_widths(tmp, out, only)
    if not only & {"T2", "K5", "K6", "K8", "K10"}:
        return out
    approx = t2_approx_lib(tmp)
    for size in ("flagship", "scaling", "tier"):
        for name, implicit, v in (
                ("flow", IMPLICIT_VARIANTS["venkatakrishnan"], 13),
                ("sst", None, 2)):
            sim = make_case(tmp, *SIZES[size], torch.float32, "cuda",
                            implicit=implicit)
            rec = capture_systems(sim)[v]
            n = sim.mesh.npoint
            sel_dtype, _ = ts.solve_tier(n, sim.mesh.stencil_offsets, v,
                                         torch.float32, rec["ncolor"],
                                         KRYLOV_M)
            r = rec["rhs"] / torch.linalg.vector_norm(rec["rhs"])
            make = lambda sel, one: ts.StencilSolveOps(
                sim.mesh, rec["sel_t"], blockcsr.block_diag_inv(rec["diag"]),
                rec["diag"], rec["colors"], rec["ncolor"], sel_dtype=sel,
                one_launch=one)
            if size == "flagship":
                # K6: one FGMRES(10) cycle, the flow's mixed tier and full
                # precision, the SST's tier
                sels = (sel_dtype,) if v == 2 else (torch.bfloat16,
                                                    torch.float32)
                for sel in sels:
                    ops = make(sel, True)
                    solve = lambda: ops.fgmres(r, KRYLOV_M, 1e-6)
                    label = (f"K6 {name} v={v} {n} "
                             f"{str(sel).replace('torch.', '')}")
                    out[label] = dict(ms=cuda_time(solve, reps=10),
                                      device_ms=device_ms(solve, reps=10))
                    if v == 2 and "cluster" in inspect.signature(
                            kernels.stencil_fgmres).parameters:
                        # K6's cluster forced to 8 and to 16 CTAs
                        plain = kernels.stencil_fgmres
                        for c in (8, 16):
                            kernels.stencil_fgmres = functools.partial(
                                plain, cluster=c)
                            try:
                                out[f"{label} cluster {c}"] = dict(
                                    ms=cuda_time(solve, reps=10),
                                    device_ms=device_ms(solve, reps=10))
                            finally:
                                kernels.stencil_fgmres = plain
                    del ops
            else:
                ops = make(sel_dtype, False)
                out[f"K5 {name} v={v} {n}"] = dict(
                    ms=cuda_time(lambda: ops.precond_matvec(r)),
                    sweep_blocks=str(sel_dtype).replace("torch.", ""))
                del ops
            if name == "sst" and size != "scaling":
                # T2, full and lite, and the full pass built with
                # T2_APPROX_FLAGS
                x = kernel_inputs(sim)
                a = (sim.lib, sim.lay, x["p"], x["u"], x["t_guess"],
                     x["tke"])
                for lite in (False, True):
                    call = lambda: kernels.node_state(*a, lite=lite)
                    out[f"T2 {'lite' if lite else 'full'} {n}"] = dict(
                        ms=cuda_time(call), device_ms=device_ms(call))
                library = kernels._lib
                kernels._lib = lambda: approx[0]
                try:
                    out[f"T2 full {n} approx div/sqrt"] = dict(
                        device_ms=device_ms(lambda: kernels.node_state(*a)),
                        ptxas=approx[1])
                finally:
                    kernels._lib = library
                # the T solve's share of the full pass: guessed at the
                # converged T (the secant stops at once), and with no
                # secant step (every node bisects)
                t_conv = st.node_state_plain(*a[:2], x["u"], x["t_guess"],
                                             x["p"], x["tke"]).v[:, 0]
                bis = st.TSolveParams(tmin=x["p"].tmin, tmax=x["p"].tmax,
                                      secant_iters=0)
                for label, tg, prm in (
                        ("T converged", t_conv, x["p"]),
                        ("bisection only", x["t_guess"], bis)):
                    call = lambda: kernels.node_state(
                        *a[:2], prm, x["u"], tg.contiguous(), x["tke"])
                    out[f"T2 full {n} {label}"] = dict(
                        device_ms=device_ms(call))
                del x, a
            if name == "flow" and size != "scaling":
                # K10, MUSCL + Venkatakrishnan, both families in one launch
                args = k10_inputs(sim, torch.float32)[4]("venkatakrishnan")
                out[f"K10 {n}"] = dict(ms=cuda_time(
                    lambda: kernels.edge_implicit(*args)))
                del args
            del sim, rec, r
            torch.cuda.empty_cache()
    sim = make_case(tmp, *SIZES["tier"], torch.float32, "cuda")
    eargs = edge_win_args(sim, *tier_state(sim, torch.float32))
    n = sim.mesh.npoint
    out[f"K8 {n}"] = dict(ms=cuda_time(lambda: kernels.edge_win(*eargs)))
    out[f"T3 + roll-subtract {n}"] = dict(ms=cuda_time(
        lambda: ef.roll_subtract(eargs[5], *kernels.edge_flux(*eargs))))
    return out


def time_runtime_widths(tmp, out, only):
    """--time-kernels: K5 and K6 at the widths with no compiled instance,
    through the calls this checkout and its parent share
    (kernels.stencil_sgs_matvec, stencil_fgmres and stencil_fgmres_grid
    with runtime, StencilSolveOps' layouts): the 5-species flow systems
    (K5 mixed (z, A z) and the f32 matvec on the channel at
    SIZES["scaling"] and the box at BOX_SCALING; K6 mixed on the channel at
    SIZES["flagship"] and the box at BOX_KERNELS), the band systems of
    RUNTIME_TIMED (20,000 nodes; K5 (z, A z) and K6 in f64, f32 and
    mixed), and the run-time kernels (runtime=True) at 8 and 13 beside the
    compiled ones; event ms, device ms (the kernels alone) and the bound."""
    import torch
    from su2_tpu_torch import kernels
    venk = IMPLICIT_VARIANTS["venkatakrishnan"]

    def k5(label, args, r, var, mode="sgs_matvec", runtime=False):
        lay = solve_layout(args)
        sweep = mode != "matvec"
        fn = lambda: kernels.stencil_sgs_matvec(
            **dict(args, **lay), r=r, sweep=sweep, runtime=runtime)
        got = [t for t in fn() if t is not r]
        bound = k5_bound(args, lay, r, got, sweep, True, var)
        out[f"K5 {mode} {label} {var}"] = dict(
            ms=cuda_time(fn), device_ms=device_ms(fn), bound_ms=bound[0])

    def k6(label, args, b, var, runtime=False):
        lay = solve_layout(args, one_launch=True)
        fn = lambda: kernels.stencil_fgmres(
            **dict(args, **lay), b=b, m=KRYLOV_M, tol=1e-6, runtime=runtime)
        n, v = b.shape
        out[f"K6 {label} {var}"] = dict(
            ms=cuda_time(fn, reps=10), device_ms=device_ms(fn, reps=10),
            bound_ms=k6_bound(args, lay, b, var)[0],
            grid=kernels.stencil_fgmres_grid(
                b.dtype, var == "mixed", v, n, KRYLOV_M, runtime=runtime))

    flows = (("channel", SIZES["scaling"], "K5"), ("box", BOX_SCALING, "K5"),
             ("channel", SIZES["flagship"], "K6"),
             ("box", BOX_KERNELS, "K6"))
    for name, size, tag in flows:
        if tag not in only:
            continue
        box = dict(nz=size[2], box=True) if len(size) == 3 else {}
        sim = make_case(tmp, *size[:2], torch.float32, "cuda", implicit=venk,
                        species="5", **box)
        rec = capture_systems(sim)[sim.lay.nvar]
        label = f"{name} v={sim.lay.nvar} {sim.mesh.npoint}"
        if tag == "K5":
            args, r, _ = system_operands(sim, rec, "mixed")
            k5(label, args, r, "mixed")
            args, r, _ = system_operands(sim, rec, "float32")
            k5(label, args, r, "float32", "matvec")
        else:
            args, _, b = system_operands(sim, rec, "mixed")
            k6(label, args, b, "mixed")
        del sim, rec, args
        torch.cuda.empty_cache()
    for band in RUNTIME_TIMED:
        v = int(band[4:])
        for var in ("float64", "float32", "mixed"):
            args, r, b = band_operands(v, band_offsets(v), var)
            label = f"{band} {b.shape[0]}"
            if "K5" in only:
                k5(label, args, r, var)
            if "K6" in only:
                k6(label, args, b, var)
            del args, r, b
            torch.cuda.empty_cache()
    for v, offsets in ((8, BOX_BAND), (13, (-9, -1, 1, 9))):
        for var in ("float64", "float32", "mixed"):
            args, r, b = band_operands(v, offsets, var)
            for rt in (False, True):
                label = f"band{v} {b.shape[0]} {'run-time' if rt else 'compiled'}"
                if "K5" in only:
                    k5(label, args, r, var, runtime=rt)
                if "K6" in only:
                    k6(label, args, b, var, runtime=rt)
            del args, r, b
            torch.cuda.empty_cache()


def k13_state(sim):
    """fused_interior_terms' per-node inputs (v, grad, trans, turb,
    sigma_k, dpdu_e) on sim's mesh: kernel_inputs' mixed reacting state
    through the plain node state and gradients."""
    from su2_tpu_torch import state as st
    from su2_tpu_torch.ops import viscous as vis
    from su2_tpu_torch.solvers import euler as es
    lib, lay, mesh, prm = sim.lib, sim.lay, sim.mesh, sim.params
    x = kernel_inputs(sim)
    nsd = st.node_state_plain(lib, lay, x["u"], x["t_guess"], x["p"],
                              x["tke"])
    grad = es.compute_gradients(mesh, prm, vis.ns_gradient_vars(
        lib, lay, nsd.v, nsd.xs))
    turb = vis.TurbFlowData(tke=x["tke"], mu_t=x["mu_t"],
                            grad_tke=x["grad_tke"], sigma_k=x["sigma_k"])
    return (nsd.v, grad, vis.Transport(nsd.mu, nsd.kappa), turb,
            x["sigma_k"], nsd.dpdu[:, lay.RHOE])


def k13_args(sim, state, node_major):
    """kernels.edge_list_flux's arguments on sim's edge list from
    k13_state's inputs, the stack (R, N) node-major (a transposed view of
    ops.edge_flux.stack_nodes, as the main path holds it) or
    feature-major (stack_inputs)."""
    from su2_tpu_torch.ops import edge_flux as ef
    lay, mesh, prm = sim.lay, sim.mesh, sim.params
    f_all = (ef.stack_nodes(lay, *state).T if node_major
             else ef.stack_inputs(lay, *state))
    return (sim.lib, lay, ef.species_consts_of(sim.lib),
            (prm.m_infty, prm.prandtl_lam, prm.prandtl_turb, prm.lewis_turb),
            f_all, mesh.edges, mesh.edge_normal, mesh.coords)


def time_k13(tmp, out):
    """K13 on the triangle channel (9,072 and 142,317 nodes, f32) through
    the calls both checkouts have: kernels.edge_list_flux (the edge pass,
    on the checkout's stack form: node-major where ops.edge_flux has
    stack_nodes) and ops.edge_flux.fused_interior_terms (the call: stack,
    edge pass, node sums), each with time_call (its device operations by
    name); then K8 at TIER_N nodes: its edge_win_slot_kernel runs the
    same per-edge body over coalesced family slots (evaluations: slots
    per call)."""
    import torch
    from su2_tpu_torch import kernels
    from su2_tpu_torch.ops import edge_flux as ef
    for size in TRI_NITERS:
        sim = make_case(tmp, *SIZES[size], torch.float32, "cuda", tri=True)
        n, ne = sim.mesh.npoint, sim.mesh.nedge
        state = k13_state(sim)
        args = k13_args(sim, state, hasattr(ef, "stack_nodes"))
        time_call(out, f"K13 edge pass {n}",
                  lambda: kernels.edge_list_flux(*args), edges=ne)
        time_call(out, f"K13 call {n}", lambda: ef.fused_interior_terms(
            sim.lib, sim.lay, sim.mesh, sim.params, *state), edges=ne)
        del sim, state, args
        torch.cuda.empty_cache()
    sim = make_case(tmp, *SIZES["tier"], torch.float32, "cuda")
    eargs = edge_win_args(sim, *tier_state(sim, torch.float32))
    n = sim.mesh.npoint
    time_call(out, f"K8 {n}", lambda: kernels.edge_win(*eargs),
              evaluations=len(eargs[5]) * n)
    del sim, eargs
    torch.cuda.empty_cache()


def muscl_face_inputs(sim):
    """(T (2E,), Y (2E, S)) of the explicit MUSCL step's face rows on sim's
    edge list, both sides (the rows its T1 call reads, made contiguous):
    kernel_inputs' state through the plain node state, T reconstructed
    from the plain gradients at the edge midpoints, Y the node's.  Only
    calls both checkouts of an A/B run share."""
    import torch
    from su2_tpu_torch import state as st
    from su2_tpu_torch.solvers import euler as es
    lay, mesh = sim.lay, sim.mesh
    x = kernel_inputs(sim)
    v = st.node_state_plain(sim.lib, lay, x["u"], x["t_guess"], x["p"],
                            x["tke"]).v
    g = es.compute_gradients(mesh, sim.params, es.gradient_vars(lay, v))
    i, j = mesh.edges[:, 0], mesh.edges[:, 1]
    half = 0.5 * (mesh.coords[j] - mesh.coords[i])
    t = torch.cat([v[i, lay.T] + (g[i, 0] * half).sum(1),
                   v[j, lay.T] - (g[j, 0] * half).sum(1)])
    ys = torch.cat([v[i, lay.YS:], v[j, lay.YS:]]).contiguous()
    return t.contiguous(), ys


def time_t1_faces(sim, out):
    """T1 (kernels.mixture_enthalpy) on muscl_face_inputs' rows with
    time_call and its bound (bytes: T, Y and h once; operations: as
    kernel_phase counts them)."""
    from su2_tpu_torch import kernels
    t, ys = muscl_face_inputs(sim)
    call = lambda: kernels.mixture_enthalpy(sim.lib, t, ys)
    label = f"T1 {t.shape[0]} MUSCL face rows ({sim.mesh.npoint} nodes)"
    time_call(out, label, call)
    lib = sim.lib
    bound = bound_of(nbytes([t, ys, call(), lib.h_y, lib.h_y2, lib.mm]),
                     12 * lib.nspecies * t.shape[0],
                     str(t.dtype).split(".")[-1])
    out[label].update(bound_ms=bound[0], bound_by=bound[1],
                      device_share_of_bound=bound[0]
                      / out[label]["device_ms"])


def time_t1_k9_k12(tmp, out, only):
    """The kernels of only among T1, K9 and K12 in f32, each with
    time_call: T1 (kernels.mixture_enthalpy) on kernel_phase's boundary
    batch of the 9,072-node case and on the TIER_N-node case's MUSCL
    face rows (time_t1_faces), K9 (solvers.inlet_tc.solve) on
    k9_inputs' inflow batch of the TIER_N-node case's inlet (377
    vertices), K12 (turbulence.sst_assemble.sst_assemble) on sst_inputs'
    arguments at 9,072 and TIER_N nodes, with its bound (k12_bound)."""
    import torch
    from su2_tpu_torch import kernels, state as st
    from su2_tpu_torch.solvers import inlet_tc as itc
    from su2_tpu_torch.turbulence import sst_assemble as sa
    for size in ("flagship", "tier"):
        sim = make_case(tmp, *SIZES[size], torch.float32, "cuda")
        n = sim.mesh.npoint
        if "T1" in only and size == "flagship":
            x = kernel_inputs(sim)
            v = st.node_state_plain(sim.lib, sim.lay, x["u"], x["t_guess"],
                                    x["p"], x["tke"]).v
            nb = sim.bcs[-1].nodes.shape[0]
            tb = v[:nb, sim.lay.T].contiguous()
            yb = v[:nb, sim.lay.YS:sim.lay.YS + sim.lay.ns].contiguous()
            time_call(out, f"T1 {nb} boundary nodes",
                      lambda: kernels.mixture_enthalpy(sim.lib, tb, yb))
            del x, v
        if "T1" in only and size == "tier":
            time_t1_faces(sim, out)
        if "K9" in only and size == "tier":
            tcs, tcx = k9_inputs(sim, sim.lib, sim.mesh, torch.float32, 15)
            time_call(out, f"K9 {tcx[0].shape[0]} vertices",
                      lambda: itc.solve(tcs, *tcx))
        if "K12" in only:
            args = sst_inputs(sim)
            fn = lambda: list(sa.sst_assemble(*args))
            time_call(out, f"K12 {n}", fn)
            bound = k12_bound(args, fn(), "float32")
            out[f"K12 {n}"].update(bound_ms=bound[0], bound_by=bound[1])
            del args
        del sim
        torch.cuda.empty_cache()


def time_k11(tmp, out):
    """K11 (kernels.ausm_flux_jac, feature-major: the main path's layout)
    in f32 on k11_inputs of the laminar implicit LU_SGS case at 9,072 and
    TIER_N nodes, with time_call and its bound (bound_of: the inputs and
    the outputs once, k11_inputs' operations)."""
    import torch
    from su2_tpu_torch import kernels
    for size in ("flagship", "tier"):
        sim = make_case(tmp, *SIZES[size], torch.float32, "cuda", "LU_SGS",
                        implicit=IMPLICIT_VARIANTS["venkatakrishnan"],
                        laminar=True)
        lay, ins, m_inf, ne, flops, _ = k11_inputs(sim, "float32")
        call = lambda: kernels.ausm_flux_jac(lay, *ins[:3], m_inf, *ins[3:])
        label = f"K11 {sim.mesh.npoint}"
        time_call(out, label, call)
        bound = bound_of(nbytes(ins + k11_rows(call(), lay.nvar, ne)), flops,
                         "float32")
        out[label].update(bound_ms=bound[0], bound_by=bound[1],
                          family_slots=ne)
        del sim, ins
        torch.cuda.empty_cache()


# nvcc flags T4 is timed under besides the library's own (--time-kernels):
# approximate division, square root, exp and pow in float (double keeps
# IEEE)
T4_FAST_FLAGS = ("-use_fast_math",)


def t4_fast_lib(tmp):
    """(ctypes library, ptxas lines of its float chem_source kernels) of
    the checkout's chem_source.cu alone, built with the kernel library's
    flags and T4_FAST_FLAGS, su2k_chem_source bound as kernels binds
    it."""
    import ctypes
    from su2_tpu_torch import kernels
    so = os.path.join(tmp, "t4_fast.so")
    proc = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, *T4_FAST_FLAGS, "-Xptxas",
         "-v", "-shared", "-o", so, os.path.join(kernels.CSRC,
                                                 "chem_source.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc ({' '.join(T4_FAST_FLAGS)}) failed:\n"
                           f"{proc.stdout}")
    lib = ctypes.CDLL(so)
    lib.su2k_chem_source.argtypes = kernels._ARGTYPES["su2k_chem_source"]
    lib.su2k_chem_source.restype = ctypes.c_int
    return lib, [ln for ln in ptxas_summary(proc.stdout)
                 if "chem_source_kernel<float" in ln]


def k7_kcap_lib(tmp, k):
    """(ctypes library or None, {build: ptxas lines of grad_rows_kernel
    <float, ...>}) of the checkout's gradients_tiled.cu built alone with
    the kernel library's flags twice: as it is, and with its offset cap
    SU2K_MAXKS compiled at k (the library None where the source has no
    such cap), su2k_gradient_rows bound as kernels binds it."""
    import ctypes
    from su2_tpu_torch import kernels
    with open(os.path.join(kernels.CSRC, "gradients_tiled.cu")) as f:
        src = f.read()
    cap = "#define SU2K_MAXKS 16"
    builds = {"as is": src}
    if cap in src:
        builds[f"SU2K_MAXKS {k}"] = src.replace(cap, f"#define SU2K_MAXKS {k}")
    procs = {}
    for label, text in builds.items():
        name = "k7_" + re.sub(r"\W+", "_", label)
        with open(os.path.join(tmp, name + ".cu"), "w") as f:
            f.write(text)
        procs[label] = (os.path.join(tmp, name + ".so"), subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", kernels.CSRC,
             "-Xptxas", "-v", "-shared", "-o", os.path.join(tmp, name + ".so"),
             os.path.join(tmp, name + ".cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    lines, lib = {}, None
    for label, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc (K7 {label}) failed:\n{log}")
        lines[label] = [ln for ln in ptxas_summary(log) if "float" in ln]
        if label != "as is":
            lib = ctypes.CDLL(so)
            lib.su2k_gradient_rows.argtypes = kernels._ARGTYPES[
                "su2k_gradient_rows"]
            lib.su2k_gradient_rows.restype = ctypes.c_int
    return lib, lines


def time_k7_t4(tmp, out, only):
    """K7 (WLS) at TIER_N nodes on the step's two sweeps (nG = 13, the
    flow's gradient set; nG = 15, the set with (k, omega) of the merged
    turbulence sweep), and again with every offset 0 (every tap on the
    node itself) and, where the checkout's source has an offset cap, from
    a throwaway build with the cap at the mesh's K; T4 (PaSR on) at 9,072
    and TIER_N nodes on the primitive rows of kernel_inputs' state, its
    inputs the column views the step passes (chemistry_source_residual).
    Each: event ms (host included), device_ms (the su2k kernel alone) and
    call_profile (every device operation of the call, and its CUDA
    launches)."""
    import numpy as np
    import torch
    from su2_tpu_torch import kernels, state as st

    if "T4" in only:
        fast = t4_fast_lib(tmp)

    timed = functools.partial(time_call, out)

    for size in ("flagship", "tier"):
        sim = make_case(tmp, *SIZES[size], torch.float32, "cuda")
        n, lay, mesh = sim.mesh.npoint, sim.lay, sim.mesh
        if "T4" in only:
            x = kernel_inputs(sim)
            v = st.node_state_plain(sim.lib, lay, x["u"], x["t_guess"],
                                    x["p"], x["tke"]).v
            turb = torch.stack([x["tke"], x["omt"]], dim=1)
            cols = (v[:, lay.T], v[:, lay.PRHO], v[:, lay.YS:lay.YS + lay.ns],
                    turb[:, 1])
            call = lambda: kernels.chem_source(sim.lib, sim.params, *cols)
            timed(f"T4 {n}", call)
            # the same source built with approximate math (T4_FAST_FLAGS):
            # the share of T4's time its IEEE arithmetic takes
            library = kernels._lib
            kernels._lib = lambda: fast[0]
            try:
                out[f"T4 {n} {' '.join(T4_FAST_FLAGS)}"] = dict(
                    device_ms=device_ms(call), ptxas=fast[1])
            finally:
                kernels._lib = library
            del x, v, turb, cols
        if "K7" in only and size == "tier":
            _, _, x, _, q = tier_state(sim, torch.float32)
            rng = np.random.default_rng(7)
            kq = torch.as_tensor(rng.uniform(0.1, 10.0, (n, 2))).to(q)
            offs = list(mesh.stencil_offsets)
            k = len(offs)
            capped, ptx = k7_kcap_lib(tmp, k)
            for ng, qq in ((13, q), (15, torch.cat([q, kq], dim=1))):
                assert qq.shape[1] == ng
                a = (qq, mesh.wls_coeff, offs)
                timed(f"K7 nG={ng} {n}", lambda: kernels.gradient_rows(*a),
                      ptxas=ptx["as is"])
                timed(f"K7 nG={ng} {n} offsets 0",
                      lambda: kernels.gradient_rows(qq, mesh.wls_coeff,
                                                    [0] * k))
                if "window" in inspect.signature(
                        kernels.gradient_rows).parameters:
                    # the checkout's other forms: streamed, and a window of
                    # 1,024 nodes (256 threads) beside k7_plan's
                    plan = functools.partial(kernels.k7_plan, n, ng, offs,
                                             4)
                    for w in (0, 1024):
                        timed(f"K7 nG={ng} {n} window {w}",
                              lambda: kernels.gradient_rows(*a, window=w),
                              plan=plan(w)._asdict())
                    out[f"K7 nG={ng} {n}"]["plan"] = plan()._asdict()
                if capped is not None:
                    library = kernels._lib
                    kernels._lib = lambda: capped
                    try:
                        timed(f"K7 nG={ng} {n} SU2K_MAXKS {k}",
                              lambda: kernels.gradient_rows(*a),
                              ptxas=ptx[f"SU2K_MAXKS {k}"])
                    finally:
                        kernels._lib = library
            del x, q, kq
        del sim
        torch.cuda.empty_cache()


# The barriers K6 is built from, timed on their own (--time-kernels): us
# per barrier over NIT back-to-back barriers in one launch, for
# cluster.sync() and K6's cluster reduction (cluster_reduce in
# su2_tpu_torch/csrc/stencil_solve.cu: warp shuffles, the block's partial,
# a cluster barrier, the C partials over distributed shared memory) on one
# cluster of 8 and of 16 CTAs of 1024 threads, and grid.sync() of a
# cooperative grid of 36 (the former v = 2 grid at 9,072 nodes) and 132
# blocks of 256 threads
BARRIER_BENCH_CU = r"""
#include <cooperative_groups.h>
#include <cstdio>
#include <cstdlib>
namespace cg = cooperative_groups;
#define NIT 1000

__device__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void k_cluster_sync(float* out) {
  cg::cluster_group cl = cg::this_cluster();
  for (int i = 0; i < NIT; ++i) cl.sync();
  if (threadIdx.x == 0 && blockIdx.x == 0) out[0] = 1.f;
}

__global__ void k_cluster_reduce(float* out) {
  cg::cluster_group cl = cg::this_cluster();
  __shared__ float wsum[32], cpart[2], bc;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  float acc = threadIdx.x;
  int buf = 0;
  for (int i = 0; i < NIT; ++i) {
    float v = warp_sum(acc * 1e-3f);
    if (lane == 0) wsum[wid] = v;
    __syncthreads();
    if (wid == 0) {
      float s = lane < (int)(blockDim.x >> 5) ? wsum[lane] : 0.f;
      s = warp_sum(s);
      if (lane == 0) cpart[buf] = s;
    }
    cl.sync();
    if (wid == 0) {
      float s = lane < (int)cl.num_blocks()
                    ? *cl.map_shared_rank(cpart + buf, (unsigned)lane)
                    : 0.f;
      s = warp_sum(s);
      if (lane == 0) bc = s;
    }
    __syncthreads();
    acc += bc * 1e-9f;
    buf ^= 1;
  }
  cl.sync();
  if (threadIdx.x == 0 && blockIdx.x == 0) out[0] = acc;
}

__global__ void k_grid_sync(float* out) {
  cg::grid_group g = cg::this_grid();
  for (int i = 0; i < NIT; ++i) g.sync();
  if (threadIdx.x == 0 && blockIdx.x == 0) out[0] = 1.f;
}

static void check(cudaError_t e, const char* what) {
  if (e != cudaSuccess) {
    fprintf(stderr, "%s: %s\n", what, cudaGetErrorString(e));
    exit(1);
  }
}

// us per barrier of the second of two launches (cluster: c CTAs of 1024
// threads in one cluster; else a cooperative grid of c blocks of 256)
static float per_barrier(void (*kern)(float*), int c, bool cluster,
                         float* buf) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute at[1];
  cfg.gridDim = dim3(c);
  cfg.blockDim = dim3(cluster ? 1024 : 256);
  at[0].id = cluster ? cudaLaunchAttributeClusterDimension
                     : cudaLaunchAttributeCooperative;
  if (cluster) {
    check(cudaFuncSetAttribute(
              kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1),
          "cluster attribute");
    at[0].val.clusterDim.x = c;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
  } else {
    at[0].val.cooperative = 1;
  }
  cfg.attrs = at;
  cfg.numAttrs = 1;
  cudaEvent_t a, b;
  check(cudaEventCreate(&a), "event");
  check(cudaEventCreate(&b), "event");
  check(cudaLaunchKernelEx(&cfg, kern, buf), "launch");
  check(cudaDeviceSynchronize(), "run");
  check(cudaEventRecord(a), "event");
  check(cudaLaunchKernelEx(&cfg, kern, buf), "launch");
  check(cudaEventRecord(b), "event");
  check(cudaEventSynchronize(b), "run");
  float ms = 0.f;
  check(cudaEventElapsedTime(&ms, a, b), "event");
  return ms * 1e3f / NIT;
}

int main() {
  float* buf = nullptr;
  check(cudaMalloc(&buf, sizeof(float)), "malloc");
  for (int c : {8, 16})
    printf("cluster of %d CTAs x 1024 threads: cluster.sync %.3f us, "
           "cluster_reduce %.3f us\n", c,
           per_barrier(k_cluster_sync, c, true, buf),
           per_barrier(k_cluster_reduce, c, true, buf));
  for (int blocks : {36, 132})
    printf("cooperative grid of %d blocks x 256 threads: grid.sync %.3f "
           "us\n", blocks, per_barrier(k_grid_sync, blocks, false, buf));
  return 0;
}
"""


def barrier_lines(tmp):
    """BARRIER_BENCH_CU built with the kernel library's nvcc flags and
    run: its output lines."""
    from su2_tpu_torch import kernels
    src = os.path.join(tmp, "bench_barrier.cu")
    exe = os.path.join(tmp, "bench_barrier")
    with open(src, "w") as f:
        f.write(BARRIER_BENCH_CU)
    flags = [f for f in kernels.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    subprocess.run([kernels._nvcc(), *flags, "-o", exe, src], check=True)
    return subprocess.run([exe], check=True, capture_output=True,
                          text=True).stdout.strip().splitlines()


def bit_diff(a, b):
    """Whether a is b bit for bit, else how many values differ and the
    largest difference relative to b's max."""
    import torch
    diff = (a.double() - b.double()).abs()
    return dict(bitwise=bool(torch.equal(a, b)),
                differing=int((a != b).sum()), of=a.numel(),
                max_rel=(diff.max() / b.double().abs().max()).item())


def k13_bitwise(tmp, size, dtype, okern, result):
    """K13 of this checkout against the kernels module okern of another on
    the triangle channel of SIZES[size] (k13_state's inputs): the edge
    pass's flux, lc and lv (kernels.edge_list_flux; the other's on the
    feature-major stack), and the call's node sums (this checkout's
    fused_interior_terms; the other's edge-list branch as PRs 9-13 ran it:
    its edge_list_flux, then mesh.scatter_edges_mixed)."""
    import torch
    from su2_tpu_torch import kernels
    from su2_tpu_torch.ops import edge_flux as ef
    sim = make_case(tmp, *SIZES[size], dtype, "cuda", tri=True)
    state = k13_state(sim)
    mine = list(kernels.edge_list_flux(*k13_args(sim, state, True)))
    theirs = list(okern.edge_list_flux(*k13_args(sim, state, False)))
    mine += list(ef.fused_interior_terms(sim.lib, sim.lay, sim.mesh,
                                         sim.params, *state))
    res, lams = sim.mesh.scatter_edges_mixed(
        theirs[0].T, torch.stack(theirs[1:3], dim=1))
    theirs += [res, lams[:, 0], lams[:, 1]]
    torch.cuda.synchronize()
    tag = f"K13 {sim.mesh.npoint} {str(dtype)[6:]}"
    for name, a, b in zip(("flux", "lc", "lv", "res", "lc sums", "lv sums"),
                          mine, theirs):
        result[f"{tag} {name}"] = bit_diff(a, b)


# the sources whose kernels took a dimension template argument in front of
# the species count (the 3D implicit flow): their 2D instances are held
# against the other checkout's instances of the same arguments without it
SASS_2D_SOURCES = ("edge_implicit.cu", "ausm_jac.cu")


def sass_listings(root, srcs):
    """{kernel (demangled): its SASS instructions, each without address
    and encoding} of root's sources srcs, compiled as sass_counts
    compiles them."""
    from su2_tpu_torch import kernels
    csrc = os.path.join(root, "su2_tpu_torch", "csrc")
    dump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    flags = [f for f in kernels.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cubin = lambda src: os.path.join(tmp, src + ".cubin")
        procs = [subprocess.Popen([kernels._nvcc(), *flags, "-cubin", "-o",
                                   cubin(src), os.path.join(csrc, src)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src in srcs]
        logs = [p.communicate()[0] for p in procs]
        if any(p.returncode for p in procs):
            raise RuntimeError("nvcc -cubin failed:\n" + "\n".join(logs))
        for src in srcs:
            text = subprocess.run([dump, "-sass", cubin(src)], check=True,
                                  capture_output=True, text=True).stdout
            name = None
            for line in text.splitlines():
                m = re.search(r"Function : (\S+)", line)
                if m:
                    name = demangle(m.group(1))
                    out[name] = []
                    continue
                m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
                if m and name:
                    out[name].append(m.group(1))
    return out


def sass_rec(ins, other):
    """Whether the SASS instructions ins equal other's, their counts and,
    where they differ, the first difference [index, ins's, other's]."""
    rec = dict(identical=other == ins, instructions=len(ins),
               other=len(other))
    if other and other != ins:
        short = min(len(ins), len(other))
        i = next((k for k in range(short) if ins[k] != other[k]), short)
        at = lambda x: x[i] if i < len(x) else None
        rec["first_difference"] = [i, at(ins), at(other)]
    return rec


def sass_2d_diff(other):
    """{kernel: whether its SASS equals the other checkout's} for the 2D
    instances of SASS_2D_SOURCES: this checkout's kernel<T, 2, rest>
    against the other's kernel<T, rest> (the parent's, before the
    dimension argument), instruction by instruction."""
    mine = sass_listings(HERE, SASS_2D_SOURCES)
    theirs = sass_listings(other, SASS_2D_SOURCES)
    out = {}
    for name, ins in mine.items():
        m = re.match(r"(\w+)<(\w+), 2, (.*)>$", name)
        if not m:
            continue
        old = f"{m.group(1)}<{m.group(2)}, {m.group(3)}>"
        out[name] = sass_rec(ins, theirs.get(old, []))
    if not out or not all(r["other"] for r in out.values()):
        raise AssertionError(f"sass: 2D instances unmatched in {other}: "
                             f"{sorted(out)}")
    return out


def sass_same_names(other, srcs, keep=lambda name: True):
    """{kernel: whether its SASS equals the other checkout's kernel of the
    same name} for every kernel of srcs in the other checkout that keep
    takes (the compiled instances of both), instruction by instruction."""
    mine = sass_listings(HERE, srcs)
    return {name: sass_rec(mine.get(name, []), ins)
            for name, ins in sass_listings(other, srcs).items()
            if keep(name)}


def stencil_bitwise(other, okern, result):
    """K5 (z, A z; the sweep only; the matvec only) and K6 (one FGMRES(10)
    cycle, tol 1e-6) at every compiled width (kernels.STENCIL_WIDTHS) on
    band systems (band_operands, 20,000 nodes, band_offsets' rule; the
    solve path's layouts), f64, f32 and mixed, against the other
    checkout's (okern) bit for bit, into result; K5's three modes through
    the run-time kernels (runtime=True) at every width of RUNTIME_WIDTHS
    and at 8 and 13 (4,000 nodes) against the other's run-time instance;
    and the SASS of every compiled K5/K6 instance against the other's
    (sass_same_names; the width template argument 0 named the other's
    run-time instance)."""
    import torch
    from su2_tpu_torch import kernels
    flat = lambda out: torch.cat([t.double().flatten() for t in out
                                  if t is not None])
    for v in kernels.STENCIL_WIDTHS:
        for var in ("float64", "float32", "mixed"):
            args, _, b = band_operands(v, band_offsets(v), var)
            lay = solve_layout(args)
            for mode, sweep, matvec in (("sgs_matvec", True, True),
                                        ("sgs", True, False),
                                        ("matvec", False, True)):
                if mode == "matvec" and var == "mixed":
                    continue
                a, c = (flat(k.stencil_sgs_matvec(
                    **dict(args, **lay), r=b, sweep=sweep, matvec=matvec))
                    for k in (kernels, okern))
                result[f"K5 {mode} v{v} {var}"] = bit_diff(a, c)
            lay1 = solve_layout(args, one_launch=True)
            a, c = (flat(k.stencil_fgmres(**dict(args, **lay1), b=b,
                                          m=KRYLOV_M, tol=1e-6))
                    for k in (kernels, okern))
            result[f"K6 v{v} {var}"] = bit_diff(a, c)
    for v in sorted(set(RUNTIME_WIDTHS) | {8, 13}):
        for var in ("float64", "float32", "mixed"):
            args, _, b = band_operands(v, band_offsets(v), var, n=4000)
            lay = solve_layout(args)
            for mode, sweep, matvec in (("sgs_matvec", True, True),
                                        ("sgs", True, False),
                                        ("matvec", False, True)):
                if mode == "matvec" and var == "mixed":
                    continue
                a, c = (flat(k.stencil_sgs_matvec(
                    **dict(args, **lay), r=b, sweep=sweep, matvec=matvec,
                    runtime=True)) for k in (kernels, okern))
                result[f"K5 run-time {mode} v{v} {var}"] = bit_diff(a, c)
            del args, b, lay
    torch.cuda.synchronize()
    result["sass_stencil"] = sass_same_names(
        other, ["stencil_solve.cu"], keep=lambda name: not name.endswith(
            ", 0>"))


def stencil_bitwise_main(other):
    """--bitwise-stencil DIR: stencil_bitwise alone; one JSON line."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "other_kernels", os.path.join(other, "su2_tpu_torch", "kernels.py"))
    okern = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(okern)
    result = dict(other=other, card=card_line())
    stencil_bitwise(other, okern, result)
    print(json.dumps(result), flush=True)
    return 0


def bitwise_main(other):
    """--bitwise DIR: T2 (full and lite, CLIPPING_TEMPRATURE off), K7 (WLS
    and GG, the flow's 13 gradient variables)
    and T4 (PaSR on, the step's column views) of this checkout against
    those of the checkout DIR (its kernels.py loaded as a module of its
    own, its library built from its sources) on the TIER_N-node case's
    inputs (tier_state), K13 (k13_bitwise) on the 9,072- and
    142,317-node triangle channel, and K10 (the four variants, k10_inputs
    of the 9,072-node implicit case) and K11 (both layouts, k11_inputs of
    the 9,072-node laminar implicit case) in 2D, in float32 and float64:
    one JSON line, per output whether it is bit for bit the other's
    (bit_diff), and whether the SASS of each 2D instance of K10 and K11
    equals the other's (sass_2d_diff)."""
    import importlib.util
    import torch
    from su2_tpu_torch import kernels
    spec = importlib.util.spec_from_file_location(
        "other_kernels", os.path.join(other, "su2_tpu_torch", "kernels.py"))
    okern = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(okern)
    card = card_line()
    result = dict(other=other, card=card)
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".chip_smoke_") as tmp:
        sim = make_case(tmp, *SIZES["tier"], torch.float32, "cuda")
        for dtype in (torch.float32, torch.float64):
            mesh, lib, x, nsd, q = tier_state(sim, dtype)
            lay, v = sim.lay, nsd.v
            omt = torch.stack([x["tke"], x["omt"]], dim=1)[:, 1]
            cols = (v[:, lay.T], v[:, lay.PRHO], v[:, lay.YS:], omt)
            t2 = (lib, lay, x["p"], x["u"], x["t_guess"], x["tke"])
            calls = {
                # every output, each exactly widened to float64
                "T2 full": lambda k: torch.cat(
                    [o.double().flatten() for o in k.node_state(*t2)]),
                "T2 lite": lambda k: torch.cat(
                    [o.double().flatten()
                     for o in k.node_state(*t2, lite=True)]),
                "K7 WLS": lambda k: k.gradient_rows(q, mesh.wls_coeff,
                                                    mesh.stencil_offsets),
                "K7 GG": lambda k: k.gradient_rows(
                    q, mesh.gg_snormal, mesh.stencil_offsets,
                    mesh.bnd_accum_normal, mesh.volume),
                "T4": lambda k: k.chem_source(lib, sim.params, *cols)}
            for name, call in calls.items():
                a, b = call(kernels), call(okern)
                torch.cuda.synchronize()
                result[f"{name} {str(dtype)[6:]}"] = bit_diff(a, b)
        del sim, mesh, lib, x, nsd, q
        torch.cuda.empty_cache()
        for size in TRI_NITERS:
            for dtype in (torch.float32, torch.float64):
                k13_bitwise(tmp, size, dtype, okern, result)
        from su2_tpu_torch import cases
        from su2_tpu_torch.geometry.structured import channel_mesh
        channel = channel_mesh(*SIZES["flagship"])
        venk = IMPLICIT_VARIANTS["venkatakrishnan"]
        imp = make_case(tmp, *SIZES["flagship"], torch.float32, "cuda",
                        implicit=venk)
        lam = make_case(tmp, *SIZES["flagship"], torch.float32, "cuda",
                        implicit=venk, laminar=True)
        flat = lambda out: torch.cat([t.double().flatten() for t in out])
        for dtype in (torch.float32, torch.float64):
            dt = str(dtype)[6:]
            args_of = k10_inputs(imp, dtype)[4]
            for variant in IMPLICIT_VARIANTS:
                args = args_of(variant)
                a, b = (flat(k.edge_implicit(*args))
                        for k in (kernels, okern))
                result[f"K10 {variant} 9072 {dt}"] = bit_diff(a, b)
            # the other 2D instances: 3 species (compiled) and 5 (the
            # run-time count), every variant
            for ns in (3, 5):
                x = cases.shape_inputs(2, ns, os.path.join(tmp, "shapes"),
                                       dtype, "cuda", raw_mesh=channel)
                mesh = x["mesh"]
                fam = (mesh.fam_offsets, mesh.fam_normal, mesh.fam_evec)
                for variant, (muscl, limiter) in IMPLICIT_VARIANTS.items():
                    args = x["implicit"] + fam + (muscl, limiter is not None)
                    a, b = (flat(k.edge_implicit(*args))
                            for k in (kernels, okern))
                    result[f"K10 {variant} {ns} species {dt}"] = bit_diff(a,
                                                                          b)
            lay, ins, m_inf = k11_inputs(lam, dt)[:3]
            for em in (False, True):
                x = [t.T.contiguous() for t in ins] if em else ins
                a, b = (flat(k.ausm_flux_jac(lay, *x[:3], m_inf, *x[3:],
                                             edge_major=em))
                        for k in (kernels, okern))
                result[f"K11 {'edge' if em else 'feature'}-major 9072 "
                       f"{dt}"] = bit_diff(a, b)
    torch.cuda.synchronize()
    result["sass_2d"] = sass_2d_diff(other)
    stencil_bitwise(other, okern, result)
    print(json.dumps(result), flush=True)
    return 0


def ab_main(root, only=TIMED):
    """--time-kernels: see the module docstring."""
    from su2_tpu_torch import kernels
    card = card_line()
    print(f"card: {card}; root {root}", flush=True)
    kernels.build()
    counts, ptxas = sass_counts(root, only)
    for name, (ni, ldl, stl) in counts.items():
        print(f"sass {name}: {ni} instructions, {ldl} LDL, {stl} STL")
    for line in ptxas:
        print(f"ptxas {line}")
    with tempfile.TemporaryDirectory(dir=root, prefix=".chip_smoke_") as tmp:
        if "K6" in only:
            for line in barrier_lines(tmp):
                print(f"barrier {line}", flush=True)
        result = dict(root=root, card=card, **time_kernels(tmp, only))
    print(json.dumps(result), flush=True)
    return 0


# --run-loop: the paths the run loop is timed on (label, size, implicit
# flow, iterations), float32, LU_SGS, the default SST assembly
RUN_LOOP_PATHS = (("9072 explicit LU_SGS", "flagship", {}, 50),
                  ("9072 implicit LU_SGS", "flagship", {"implicit": True}, 20),
                  (f"{TIER_N} implicit LU_SGS", "tier", {"implicit": True},
                   10))
# --run-loop --gather: the paths without a static stencil (label, size,
# make_case keywords, implicit: the main implicit variant; iterations);
# size "tet" is TET_SLICE
GATHER_RUN_LOOP_PATHS = tuple(
    (f"{n} {label}", size, kw, niter)
    for n, size, niter in (("9072", "flagship", 20), ("142317", "scaling", 5))
    for label, kw in (
        ("triangles implicit LU_SGS", dict(implicit=True, tri=True)),
        ("triangles implicit JACOBI", dict(implicit=True, tri=True,
                                           prec="JACOBI")))) + (
    ("9072 triangles laminar explicit", "flagship",
     dict(laminar=True, tri=True, prec="JACOBI"), 20),
    ("9072 triangles laminar implicit JACOBI", "flagship",
     dict(implicit=True, laminar=True, tri=True, prec="JACOBI"), 20),
    ("136161 tetrahedra explicit LU_SGS", "tet", {}, TET_NITER))
# --run-loop --box: the 3D implicit paths on box_mesh (the size a box
# shape; LU_SGS unless prec says otherwise) and the tet box's implicit
# LU_SGS step
BOX_RUN_LOOP_PATHS = (
    ("8000 box implicit LU_SGS", BOX_KERNELS, dict(implicit=True), 20),
    ("136161 box implicit LU_SGS", BOX_SCALING, dict(implicit=True), 10),
    ("136161 box 3 species implicit LU_SGS", BOX_SCALING,
     dict(implicit=True, species="3"), 5),
    ("136161 box laminar implicit LU_SGS", BOX_SCALING,
     dict(implicit=True, laminar=True), 3),
    ("136161 tetrahedra implicit LU_SGS", "tet", dict(implicit=True), 3))


def memory_mb(fn):
    """(peak allocated MiB above the allocation before fn(), reserved MiB
    fn() added) on the card."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    res = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (round((torch.cuda.max_memory_allocated() - base) / 2 ** 20, 1),
            round((torch.cuda.memory_reserved() - res) / 2 ** 20, 1))


def wall_ms(fn, niter):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / niter


def run_loop_main(root, paths=RUN_LOOP_PATHS):
    """--run-loop: see the module docstring."""
    import torch
    from su2_tpu_torch import kernels
    from su2_tpu_torch.driver import Simulation
    card = card_line()
    print(f"card: {card}; root {root}", flush=True)
    kernels.build()
    graph = hasattr(Simulation, "rans_multistep")
    result = dict(root=root, card=card, graph=graph, paths={})
    imp = IMPLICIT_VARIANTS["venkatakrishnan"]
    with tempfile.TemporaryDirectory(dir=root, prefix=".chip_smoke_") as tmp:
        for label, size, kw, niter in paths:
            kw = dict(kw, implicit=imp if kw.get("implicit") else None)
            if size == "tet":
                sim = make_case(tmp, *TET_SLICE[:2], torch.float32, "cuda",
                                nz=TET_SLICE[2], **kw)
            elif isinstance(size, tuple):
                sim = make_case(tmp, *size[:2], torch.float32, "cuda",
                                nz=size[2], box=True, **kw)
            else:
                sim = make_case(tmp, *SIZES[size], torch.float32, "cuda",
                                **kw)
            lam = not sim.turbulent
            rec = result["paths"][label] = {"niter": niter}
            init = (sim.u0, sim.t0) + (() if lam
                                        else tuple(sim.initial_turb_state()))
            if graph:
                rec["eager_memory_mb"] = memory_mb(
                    lambda: sim._step(*init))
                rec["graph_memory_mb"] = memory_mb(
                    lambda: sim._multistep(init, 1))
                rec["capture_s"] = round(sim._graph.capture_s, 4)
            state = run_state(sim.run(2, quiet=True), lam)

            def run(state=state, sim=sim, niter=niter, lam=lam):
                sim.run(niter, u=state[0], t_guess=state[1],
                        turb_state=None if lam else state[2:], quiet=True,
                        chunk=25)
            if graph:
                def eager(state=state, sim=sim, niter=niter):
                    eager_iterations(sim, state, niter)
                ms = [wall_ms(f, niter) for f in (eager, run, run, eager)]
                rec["eager_ms"] = [round(ms[0], 4), round(ms[3], 4)]
                rec["graph_ms"] = [round(ms[1], 4), round(ms[2], 4)]
                launches, busy, ours, _, _, api, p_ms, by_stage = \
                    profile_steps(sim, state)
                rec["eager_profile"] = dict(
                    cuda_launches=launches, api_calls=api,
                    busy_ms=round(busy, 4), span_ms=round(p_ms, 4),
                    su2k_ms=ours, device_ms_by_stage=by_stage)
            else:
                rec["run_ms"] = [round(wall_ms(run, niter), 4)
                                 for _ in range(2)]
            kern, ours, busy, api, api_by, p_ms = profile_run(sim, state)
            rec["run_profile"] = dict(
                kernels=kern, su2k=ours, busy_ms=round(busy, 4),
                span_ms=round(p_ms, 4), api_calls=api, api_by_name=api_by)
            print(json.dumps({label: rec}), flush=True)
            if graph:
                sim.drop_graph()
            del sim
            torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return 0


def time_run(sim, niter):
    """ms/iter of niter iterations of sim.run (replays of the step's graph,
    chunks of 25) after a 2-iteration warm-up that captures it, and
    profile_run's device kernels per replay, device busy and span ms per
    iteration from its final state; the graph is dropped after."""
    import torch
    start = run_state(sim.run(2, quiet=True), False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sim.run(niter, u=start[0], t_guess=start[1], turb_state=start[2:],
                  quiet=True, chunk=25)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / niter
    if not torch.isfinite(out[0]).all():
        raise AssertionError("time_run: non-finite state")
    kern, ours, busy, _, _, span = profile_run(sim, run_state(out, False))
    sim.drop_graph()
    torch.cuda.empty_cache()
    return dict(ms=ms, kernels_per_iter=kern, su2k_per_iter=ours,
                busy_ms=busy, span_ms=span)


def options_time_main(root):
    """--time-options: the slice's options on the card in float32, timed
    through Simulation.run (time_run) in one call: the explicit LU_SGS
    case first order and with MUSCL (Venkatakrishnan) at 9,072 x 50 and
    TIER_N x 10; the implicit LU_SGS case (MUSCL + Venkatakrishnan) at
    9,072 x 20 with FGMRES, BCGSTAB and LINELET; dual time BDF2 on the
    explicit case at 9,072 nodes (UNST_INT_ITER 25: ms per physical step
    of run_unsteady over 4 steps, after a 1-step run that captures the
    graph); T1 on the TIER_N-node MUSCL face rows (time_t1_faces).  One
    JSON line."""
    import torch
    from su2_tpu_torch import kernels
    card = card_line()
    kernels.build()
    result = dict(root=root, card=card)
    venk = IMPLICIT_VARIANTS["venkatakrishnan"]
    with tempfile.TemporaryDirectory(dir=root, prefix=".chip_smoke_") as tmp:
        for size, niter in (("flagship", 50), ("tier", 10)):
            for label, lines in (("first order", {}),
                                 ("MUSCL", MUSCL_LINES)):
                sim = make_case(tmp, *SIZES[size], torch.float32, "cuda",
                                settings=lines)
                key = f"{sim.mesh.npoint} explicit LU_SGS {label}"
                result[key] = time_run(sim, niter)
                print(f"options {key}: {result[key]}", flush=True)
                if size == "tier" and label == "MUSCL":
                    time_t1_faces(sim, result)
                del sim
        for label, lines in (("FGMRES LU_SGS", {}),
                             ("BCGSTAB LU_SGS", dict(LINEAR_SOLVER="BCGSTAB")),
                             ("FGMRES LINELET",
                              dict(LINEAR_SOLVER_PREC="LINELET"))):
            sim = make_case(tmp, *SIZES["flagship"], torch.float32, "cuda",
                            implicit=venk, settings=lines)
            key = f"{sim.mesh.npoint} implicit {label}"
            result[key] = time_run(sim, 20)
            print(f"options {key}: {result[key]}", flush=True)
            del sim
        sim = make_case(tmp, *SIZES["flagship"], torch.float32, "cuda",
                        settings=dict(OPTION_PATHS[
                            "dual time BDF2, explicit"][2],
                            UNST_INT_ITER="25"))
        sim.run_unsteady(1, quiet=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run_unsteady(4, quiet=True)
        torch.cuda.synchronize()
        result[f"{sim.mesh.npoint} dual time BDF2 explicit, 25 inner"] = \
            dict(ms_per_physical_step=(time.perf_counter() - t0) * 1e3 / 4)
    print(json.dumps(result), flush=True)
    return 0


def main():
    import argparse
    ap = argparse.ArgumentParser(description="Smoke run of su2_tpu_torch "
                                 "on one NVIDIA GPU (see the docstring)")
    ap.add_argument("--time-kernels", action="store_true")
    ap.add_argument("--run-loop", action="store_true",
                    help="time the run loop of the checkout --root on "
                    "RUN_LOOP_PATHS (run_loop_main)")
    ap.add_argument("--gather", action="store_true",
                    help="--run-loop: on GATHER_RUN_LOOP_PATHS (the paths "
                    "without a static stencil) instead")
    ap.add_argument("--box", action="store_true",
                    help="--run-loop: on BOX_RUN_LOOP_PATHS (the 3D "
                    "implicit paths) instead")
    ap.add_argument("--time-options", action="store_true",
                    help="time the slice's options (options_time_main)")
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--bitwise", metavar="DIR",
                    help="K7, T4 and K13 against those of the checkout "
                    "DIR, bit for bit (bitwise_main)")
    ap.add_argument("--bitwise-stencil", metavar="DIR",
                    help="K5 and K6 at their compiled widths against those "
                    "of the checkout DIR, bit for bit, and their SASS "
                    "(stencil_bitwise_main)")
    ap.add_argument("--only", default=",".join(sorted(TIMED)),
                    help="--time-kernels: the kernels to time, a comma "
                    "list of " + ", ".join(sorted(TIMED)))
    opt = ap.parse_args()
    only = frozenset(opt.only.split(","))
    if not only or not only <= TIMED:
        ap.error(f"--only takes tags of {sorted(TIMED)}")
    root = os.path.abspath(opt.root)
    sys.path.insert(0, root)
    try:
        import torch
        from su2_tpu_torch import kernels
    except ImportError as exc:
        print(f"chip_smoke: cannot import the port ({exc}); run it from "
              "the repository root", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if opt.time_kernels:
        return ab_main(root, only)
    if opt.run_loop:
        return run_loop_main(root, GATHER_RUN_LOOP_PATHS if opt.gather
                             else BOX_RUN_LOOP_PATHS if opt.box
                             else RUN_LOOP_PATHS)
    if opt.time_options:
        return options_time_main(root)
    if opt.bitwise:
        return bitwise_main(os.path.abspath(opt.bitwise))
    if opt.bitwise_stencil:
        return stencil_bitwise_main(os.path.abspath(opt.bitwise_stencil))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    nvcc = subprocess.run([kernels._nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()[-1]
    phase("device", f"{card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; {nvcc}")

    t0 = time.perf_counter()
    path, log = kernels.build(verbose=True)
    phase("build", f"{os.path.relpath(path, HERE)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in ptxas_summary(log):
        phase("build", line)
        PTXAS[line.split(":", 1)[0]] = line

    report = {}
    niters = {"flagship": 10, "scaling": 5, "tier": 3}
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".chip_smoke_") as tmp:
        try:
            return smoke_phases(tmp, card, report, niters)
        finally:
            stop_cpu_pool(wait=False)


def smoke_phases(tmp, card, report, niters):
    """Phases 3-6 and the output phase (see the docstring) in tmp, then
    the kernels line and the last line; returns the exit code."""
    import torch
    # the f64 step checks: the card's halves now, the CPU's in the
    # workers beside the phases up to 6 (finish_steps)
    step_checks(tmp)
    for dt in ("float64", "float32"):
        kernel_phase(tmp, dt, report)
    sims = {}
    for size in SIZES:
        t0 = time.perf_counter()
        sims[size] = make_case(tmp, *SIZES[size], torch.float32, "cuda")
        phase("kernels", f"{sims[size].mesh.npoint}-node case built in "
              f"{time.perf_counter() - t0:.1f} s")
    for dt in ("float64", "float32"):
        tier_kernel_phase(sims["tier"], dt, report)
    # the implicit-flow case (MUSCL + Venkatakrishnan) at every size,
    # with JACOBI (K10, the flow's solve in torch ops) and with LU_SGS
    # (the flow's 13 x 13 system through K5/K6)
    main_imp = IMPLICIT_VARIANTS["venkatakrishnan"]
    imp, lusgs = {}, {}
    for size in SIZES:
        for prec, out in (("JACOBI", imp), ("LU_SGS", lusgs)):
            if prec == "JACOBI" and size not in IMPLICIT_NITERS:
                continue
            t0 = time.perf_counter()
            out[size] = make_case(tmp, *SIZES[size], torch.float32,
                                  "cuda", prec, implicit=main_imp)
            phase("k10", f"{out[size].mesh.npoint}-node implicit {prec} "
                  f"case built in {time.perf_counter() - t0:.1f} s")
    stencil_phase(sims, lusgs, report)
    for dt in ("float64", "float32"):
        implicit_kernel_phase(imp["flagship"], dt, report,
                              list(IMPLICIT_VARIANTS))
    for size in ("scaling", "tier"):
        implicit_kernel_phase(lusgs[size], "float32", report,
                              ["venkatakrishnan"])
    # the laminar implicit case (MUSCL + Venkatakrishnan, LU_SGS): K11
    # at 9,072 nodes in f64 and f32 and at TIER_N in f32
    lam = {}
    for size in ("flagship", "tier"):
        t0 = time.perf_counter()
        lam[size] = make_case(tmp, *SIZES[size], torch.float32, "cuda",
                              "LU_SGS", implicit=main_imp, laminar=True)
        phase("k11", f"{lam[size].mesh.npoint}-node laminar implicit "
              f"LU_SGS case built in {time.perf_counter() - t0:.1f} s")
    for dt in ("float64", "float32"):
        ausm_kernel_phase(lam["flagship"], dt, report)
    ausm_kernel_phase(lam["tier"], "float32", report)
    # K12 on the explicit LU_SGS case's SST inputs: 9,072 nodes in f64
    # (a case of its own) and f32, TIER_N in f32
    sst_kernel_phase(make_case(tmp, *SIZES["flagship"], torch.float64,
                               "cuda"), "float64", report)
    sst_kernel_phase(sims["flagship"], "float32", report)
    sst_kernel_phase(sims["tier"], "float32", report)
    # K13 on the scrambled triangle channel (no static stencil: the
    # gather path): 9,072 nodes in f64 (a case of its own) and f32,
    # 142,317 in f32
    tri = {}
    for size in TRI_NITERS:
        t0 = time.perf_counter()
        tri[size] = make_case(tmp, *SIZES[size], torch.float32, "cuda",
                              tri=True)
        phase("k13", f"{tri[size].mesh.npoint}-node triangle channel "
              f"({tri[size].mesh.nedge} edges, {tri[size].ncolor} sweep "
              f"colors) built in {time.perf_counter() - t0:.1f} s")
    k13_phase(make_case(tmp, *SIZES["flagship"], torch.float64, "cuda",
                        tri=True), "float64", report)
    for size in TRI_NITERS:
        k13_phase(tri[size], "float32", report)
    # meshes without a static stencil, implicit and laminar:
    # the triangle channel's implicit case (MUSCL + Venkatakrishnan)
    # with LU_SGS and JACOBI at 9,072 and 142,317 nodes (K11 on its
    # edge rows: f64 and f32 at 9,072, f32 at 142,317), its laminar
    # case explicit and implicit (JACOBI) at 9,072, the tet box at
    # 136,161 (K13 at (3, 9))
    tri_imp, lam_tri = {}, {}
    for size in TRI_IMPLICIT_NITERS:
        for prec in ("LU_SGS", "JACOBI"):
            t0 = time.perf_counter()
            tri_imp[(size, prec)] = sim = make_case(
                tmp, *SIZES[size], torch.float32, "cuda", prec,
                implicit=main_imp, tri=True)
            phase("k11", f"{sim.mesh.npoint}-node triangle channel, "
                  f"implicit {prec} case built in "
                  f"{time.perf_counter() - t0:.1f} s")
    for label, implicit in (("explicit", None), ("implicit", main_imp)):
        lam_tri[label] = make_case(tmp, *SIZES["flagship"],
                                   torch.float32, "cuda", "JACOBI",
                                   implicit=implicit, laminar=True,
                                   tri=True)
    for dt in ("float64", "float32"):
        ausm_edge_phase(tri_imp[("flagship", "LU_SGS")], dt, report)
    ausm_edge_phase(tri_imp[("scaling", "LU_SGS")], "float32", report)
    t0 = time.perf_counter()
    tet = make_case(tmp, *TET_SLICE[:2], torch.float32, "cuda",
                    nz=TET_SLICE[2])
    phase("k13", f"{tet.mesh.npoint}-node tet box ({tet.mesh.nedge} "
          f"edges, {tet.ncolor} sweep colors) built in "
          f"{time.perf_counter() - t0:.1f} s")
    k13_phase(tet, "float32", report)
    # the 3D implicit flow: K10 and K11 in 3D, K5/K6 at v = 14 and 8;
    # its cases serve the graph phase and the box slices at the end of 6
    box = box_phase(tmp, report)
    # the implicit flow at 5 species: K5/K6's run-time-width instance on
    # band systems at every width it serves and on the 5-species flow
    # systems, and against the compiled instance at 8 and 13; its cases
    # serve the graph phase and the mixture slices at the end of 6
    msims = mixture_cases(tmp)
    widths_phase(msims, report)
    # T3/K8/K13, K10 and K11 at shapes outside their compiled lists
    shape_phase(tmp, report)
    # each run: (label, launch counts, iterations)
    runs = []
    # the slice's options: dual time, explicit MUSCL, CLIPPING,
    # BCGSTAB and LINELET, card vs CPU in f64 and through the graph
    seen = options_phase(tmp, runs)
    # every path of the kernel table through its captured CUDA graph,
    # bit for bit the eager step (each kernel inside a graph)
    gather = (
        ("triangles, implicit LU_SGS", tri_imp[("flagship", "LU_SGS")]),
        ("triangles, implicit LINELET", make_case(
            tmp, *SIZES["flagship"], torch.float32, "cuda", "LINELET",
            implicit=main_imp, tri=True)),
        ("triangles, laminar implicit JACOBI", lam_tri["implicit"]),
        ("tetrahedra, explicit LU_SGS", make_case(
            tmp, *TET_STEP[:2], torch.float32, "cuda",
            nz=TET_STEP[2]))) + box_graphs(box) + mixture_graphs(msims)
    graph_phase(tmp, sims, lusgs, lam, tri, seen, gather)
    del gather
    # the step checks' CPU halves, before the timed runs
    finish_steps()
    # the TOTAL_CONDITIONS inlet on the main path: K9 once per iteration
    runs.append(("9072 TOTAL_CONDITIONS", slice_phase(
        make_case(tmp, *SIZES["flagship"], torch.float32, "cuda",
                  total_conditions=True), "flagship", 10, card,
        profile=True), 10))
    # float64 past the full-precision gate: K5 at full precision inside
    # the Krylov loop, KRYLOV_M launches per iteration
    slice_phase(make_case(tmp, *SIZES["scaling"], torch.float64, "cuda"),
                "scaling", 3, card)
    # JACOBI (the path without K5/K6) against LU_SGS in the order J, L,
    # then LU_SGS with the fused SST assembly (F: at 142,317 nodes and at
    # the tier, fused_sst_solve_tier's per-iteration K5 in place of the
    # one K6 launch of 9,072), each run profiled after its timed run
    pairs = {}
    for size, niter in niters.items():
        jac = make_case(tmp, *SIZES[size], torch.float32, "cuda",
                        prec="JACOBI")
        slice_phase(jac, size, niter, card, prec="JACOBI", profile=True)
        del jac
        unf = {}
        runs.append((str(sims[size].mesh.npoint), slice_phase(
            sims[size], size, niter, card, profile=True, stats=unf),
            niter))
        counts, fus = fused_slice(tmp, size, niter, card)
        runs.append((f"{sims[size].mesh.npoint} fused", counts, niter))
        pairs[f"{sims[size].mesh.npoint} nodes explicit LU_SGS"] = (
            unf, fus)
    # the implicit flow with JACOBI, then with LU_SGS: K10 once per
    # iteration; K6 twice per iteration at 9,072 nodes, K5 twice per
    # Krylov vector at the larger sizes; profiled
    imp_stats = {}
    for size in SIZES:
        for prec, sims_p, its in (("JACOBI", imp, IMPLICIT_NITERS),
                                  ("LU_SGS", lusgs, LUSGS_NITERS)):
            if size not in its:
                continue
            stats = imp_stats.setdefault((size, prec), {})
            runs.append((f"{sims_p[size].mesh.npoint} implicit {prec}",
                         slice_phase(sims_p[size], size, its[size], card,
                                     prec=prec, profile=True,
                                     stats=stats),
                         its[size]))
    # the implicit LU_SGS case with the fused SST assembly at 9,072
    niter = LUSGS_NITERS["flagship"]
    counts, fus = fused_slice(tmp, "flagship", niter, card,
                              implicit=main_imp)
    runs.append((f"{lusgs['flagship'].mesh.npoint} implicit LU_SGS "
                 "fused", counts, niter))
    pairs[f"{lusgs['flagship'].mesh.npoint} nodes implicit LU_SGS"] = (
        imp_stats[("flagship", "LU_SGS")], fus)
    for label, (unf, fus) in pairs.items():
        print_pair(label, unf, fus)
    # the laminar slice: implicit LU_SGS (K11 once per iteration, the
    # flow's solve K6 once at 9,072 nodes, K5 ten times at TIER_N)
    # and explicit (T4 once per iteration), timed and profiled
    for size, niter in LAMINAR_NITERS.items():
        runs.append((f"{lam[size].mesh.npoint} laminar implicit LU_SGS",
                     slice_phase(lam[size], size, niter, card,
                                 profile=True), niter))
    lam_exp = make_case(tmp, *SIZES["flagship"], torch.float32, "cuda",
                        "JACOBI", laminar=True)
    runs.append(("9072 laminar explicit", slice_phase(
        lam_exp, "flagship", LAMINAR_NITERS["flagship"], card,
        prec="JACOBI", profile=True), LAMINAR_NITERS["flagship"]))
    # the triangle channel (K13 once per iteration, the SST solve in
    # torch gather ops): JACOBI, then LU_SGS, each timed and profiled
    for size, niter in TRI_NITERS.items():
        jac = make_case(tmp, *SIZES[size], torch.float32, "cuda",
                        prec="JACOBI", tri=True)
        n = jac.mesh.npoint
        runs.append((f"{n} triangles JACOBI", slice_phase(
            jac, size, niter, card, prec="JACOBI", profile=True), niter))
        runs.append((f"{n} triangles LU_SGS", slice_phase(
            tri[size], size, niter, card, profile=True), niter))
    # meshes without a static stencil, implicit and laminar: the
    # triangle channel's implicit case (K11 once per iteration, both
    # solves in torch gather ops) with LU_SGS, then JACOBI, its
    # laminar case, the tet box (K13 at (3, 9)); each timed and
    # profiled, with the device ms of each stage
    for size, niter in TRI_IMPLICIT_NITERS.items():
        for prec in ("LU_SGS", "JACOBI"):
            sim = tri_imp.pop((size, prec))
            runs.append((f"{sim.mesh.npoint} triangles implicit {prec}",
                         slice_phase(sim, size, niter, card, prec=prec,
                                     profile=True),
                         niter))
            del sim
    for label, sim in lam_tri.items():
        runs.append((f"{sim.mesh.npoint} triangles laminar {label}",
                     slice_phase(sim, "flagship",
                                 LAMINAR_NITERS["flagship"], card,
                                 prec="JACOBI", profile=True),
                     LAMINAR_NITERS["flagship"]))
    del lam_tri
    runs.append((f"{tet.mesh.npoint} tetrahedra LU_SGS", slice_phase(
        tet, "tet", TET_NITER, card, profile=True), TET_NITER))
    del tet
    torch.cuda.empty_cache()
    # the 3D implicit flow's slices (K10 in 3D, K5/K6 at v = 14 and 8,
    # K7 at 262,701 nodes, K11 in 3D), profiled by stage
    box_slices(tmp, card, runs, box)
    # the 5-species paths (K5/K6's run-time width), profiled by stage
    mixture_slices(card, runs, msims)
    # solution output, restart and force monitoring between chunks
    output_phase(tmp, card, sims["tier"])

    # each kernel's numbers at its main-path use: T1-T4 in f32 at 9,072
    # nodes, K5 mixed on the implicit LU_SGS case's flow system at 142,317
    # nodes and K6 mixed on it at 9,072 nodes (v = 13; the SST's v = 2
    # numbers beside them), K7 (WLS, the case's method) and K8 in f32 at
    # TIER_N nodes, K9 in f32 on the 377-vertex batch, K10 f32 at 9,072
    # nodes (MUSCL + Venkatakrishnan), K11 f32 feature-major at 9,072 nodes
    # (the laminar implicit case's family slots; edge-major and TIER_N
    # nodes beside it), K12 f32 at 9,072 nodes, K13 f32 on the 9,072-node
    # triangle channel (f64 and 142,317 nodes beside it; the call: edge
    # pass and node sums, each also on its own)
    main_use = {"stencil_sgs_matvec": ("flow142317", "mixed", "sgs_matvec"),
                "stencil_fgmres": ("flow9072", "mixed"),
                "stencil_runtime_sgs_matvec": ("flow142317 v9", "mixed",
                                               "sgs_matvec"),
                "stencil_runtime_fgmres": ("flow9072 v9", "mixed"),
                "gradient_rows": "float32 WLS",
                "edge_implicit": "float32 9072 venkatakrishnan",
                "ausm_flux_jac": "float32 9072 feature-major",
                "sst_assemble": "float32 9072",
                "edge_list_flux": "float32 9072"}
    sst_use = {"stencil_sgs_matvec": ("sst142317", "mixed", "sgs_matvec"),
               "stencil_fgmres": ("sst9072", "float32")}
    from su2_tpu_torch import kernels
    rows = []
    for name, (src, repl) in KERNELS.items():
        rec = dict(report[name][main_use.get(name, "float32")])
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": repl,
               "launches": sum(c[name] for _, c, _ in runs),
               "launches_per_iter": {label: c[name] / it
                                     for label, c, it in runs}}
        row.update(rec)
        if name in sst_use:
            row["sst_v2"] = report[name][sst_use[name]]
        if name == "ausm_flux_jac":
            row["edge_major"] = report[name]["float32 9072 edge-major"]
            row["at_tier"] = report[name][f"float32 {TIER_N} feature-major"]
            # the implicit triangle channel's edge rows
            row["edge_rows"] = {k: v for k, v in report[name].items()
                                if k.endswith("edge rows")}
        if name == "sst_assemble":
            row["float64"] = report[name]["float64 9072"]
            row["at_tier"] = report[name][f"float32 {TIER_N}"]
        if name == "edge_list_flux":
            row["float64"] = report[name]["float64 9072"]
            row["at_142317"] = report[name]["float32 142317"]
            # (3, 9): the tet box of the slice
            row["tet_box"] = report[name][
                f"float32 {TET_SLICE[0] * TET_SLICE[1] * TET_SLICE[2]}"]
            # its second launch, the node sums (counted apart)
            row["node_sum_launches"] = sum(c["edge_list_sum"]
                                           for _, c, _ in runs)
        if name == "node_state":
            row["clip"] = {dt: report[name][f"clip {dt}"]
                           for dt in ("float32", "float64")}
        if name == "stencil_sgs_matvec":
            # its sweep-only and matvec-only forms (BCGSTAB's operators,
            # LINELET's matvec), counted apart as well
            for form in ("sweep_only", "matvec_only"):
                row[f"{form}_launches"] = sum(c[f"stencil_{form}"]
                                              for _, c, _ in runs)
            mv = report[name][("flow142317", "float32", "matvec")]
            row["matvec_only"] = {k: mv[k] for k in (
                "ms", "plain_ms", "bound_ms", "library_ms", "library")}
            row["at_tier"] = report[name][(f"flow{TIER_N}", "mixed",
                                             "sgs_matvec")]
            row["sst_v2_at_tier"] = report[name][(f"sst{TIER_N}", "mixed",
                                                    "sgs_matvec")]
            row["matvec_only_at_tier"] = report[name][
                (f"flow{TIER_N}", "float32", "matvec")]
        if name.startswith("stencil_"):
            row["widths"] = (list(RUNTIME_WIDTHS) if "runtime" in name
                             else list(kernels.STENCIL_WIDTHS))
        if name.startswith("stencil_runtime_"):
            # band systems (RUNTIME_TIMED's widths), the run-time instance
            # at 8 and 13 against the compiled one, and its launches in
            # the 5-species runs
            row["bands"] = {" ".join(map(str, k)): v
                            for k, v in report[name].items()
                            if str(k[0]).startswith("band")}
            row["runtime_vs_compiled"] = report["runtime_vs_compiled"]
        if name == "stencil_runtime_sgs_matvec":
            mv = report[name][("flow142317 v9", "float32", "matvec")]
            row["matvec_only"] = {k: mv[k] for k in (
                "ms", "plain_ms", "bound_ms", "library_ms", "library")}
        if name == "edge_win":
            row["edge_evaluations_per_call"] = report[name][
                "edge_evaluations_per_call"]
        other = {k: v for k, v in report[name].items()
                 if isinstance(k, str) and k.startswith("shape ")}
        if other:
            row["other_shapes"] = other
        # the 3D implicit flow's (box_phase): K10, K11, K5 and K6
        three = {" ".join(map(str, k)) if isinstance(k, tuple) else k: v
                 for k, v in report[name].items()
                 if "3D" in str(k) or "flow3d" in str(k)}
        if three:
            row["3d"] = three
        rows.append(row)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
