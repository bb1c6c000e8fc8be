#!/usr/bin/env python3
"""Drive clarabel_tpu_torch on one CUDA card and check what comes out.

Run from the root of a checkout:  python3 chip_smoke.py [--seed S] [--out FILE]

Phases:
  0. the card (name and power limit, from nvidia-smi) and the build of the
     hand-written kernels (clarabel_tpu_torch/kkt/csrc/ldl.cu and df_lu.cu,
     one nvcc each, started together) into build/;
  1. each LDLᵀ kernel against its plain PyTorch version on the card, at f64
     and f32, at the shapes the solvers give it (the batch phase's
     512 and 2048 x 96², 1024 x 129², 64 x 201² and 4 x 2001², phase 3e's
     1 x 10200², the chordal max-cut's 1 x N² and 64 and 2048 x 58² among
     them; phase 3j's f32 64 and 2048 x 58² and chordal 1 x N²), with the
     solve's backward error, the kernel's and the plain
     version's times and, as yardsticks the port never calls,
     torch.linalg.ldl_factor (pivoted, so another function; not at
     N = 10200) and torch.linalg.lu_factor; the unblocked kernel (K2/K3) bit for bit equal to its twin, also at the
     edges of its shared-memory design (N = 1, 2; N = 240, the widest f64
     triangle that fits; N = 241 and 256, which start in device memory; 264
     matrices of N = 64, more than the card's SMs; f32 N = 256, B = 8); the
     blocked kernel also at edge shapes (N = 1, 32, 33, 100: one panel, one
     row below it, a ragged last panel); plus cases where the dynamic
     regularization fires, on the blocked kernel's panel edges and around
     the unblocked kernel's switch into shared memory; and the double-float
     LU's kernels (df_lu_factor, df_lu_solve) bit for bit against their
     twins, factor, permutation, scaling and ok flag, the solve at R = 2
     and at R = 1 on its first column, at 1 x 1², 1 x 2², 1 x 512² (the one-block forms' edge), 1 x 176²
     and 512 x 208² (phase 3i's solves), 64 and 2048 x 58² with K_lo
     (phase 3j's), a zero pivot and tied candidates,
     with a K_lo and without, the factor's panel edges (1 x 7², 1 x 9²,
     3 x 19²), the solve's row blocks (2 x 33²), a batch wider than the SMs
     (133 x 40²) and four inputs whose twins spread NaN (the kernels' exact
     branches: an inf, an entry past Dekker's split, right-hand sides past
     it, a masked multiplier past f32's range), timed against their twins (the
     previous design's recorded times in brackets), the bound and the
     non-FMA floor and, as yardsticks the port never calls,
     torch.linalg.lu_factor at f32 and f64;
  2. the main path at full width: a Markowitz long-only portfolio QP over
     n = 1000 assets with a k = 50 factor covariance (KKT N = 2001, f64),
     solved with direct_solve_method="pallas" and with "auto" (pivoted LU);
  3. a risk-constrained portfolio SOCP (n = 500, k = 50, N = 1552) the same
     two ways, a small portfolio (N = 201) whose solve runs the unblocked
     kernel, checked against the same solve on the CPU, and the batched
     factor-and-solve entry point for each variant (make_ldl_factor, as the
     JAX package's bench drives its kernels);
  3b. batches through BatchSolver, each with "pallas" and "auto": the JAX
     bench's box QPs (n = 32, m = 64, B = 512 and 2048, KKT N = 96) and
     SOCPs (n = 32, one SecondOrderConeT(33), B = 1024, N = 129), and
     scenario portfolio QPs, one covariance and B draws of the expected
     returns (n = 100, B = 64, N = 201; n = 1000, B = 4, N = 2001); every
     lane Solved, the two backends agreeing, four lanes of each re-solved
     alone, one factor launch per iteration of the batch; then, as a
     yardstick, DefaultSolver looped over 16 lanes of the B = 512 box QP;
  3c. the Schur-complement KKT paths, which run no LDLᵀ kernel: the QP and
     the SOCP of phases 2-3 at f64 through "schur_diag", "schur_lr" and
     "schur" against their LU solves, and at f32 through "auto"; the box-QP
     and SOCP batches of phase 3b at f32 through "auto", every lane against
     its f64 solve, with solves/s, ms/iteration and Cholesky calls per
     iteration; the SOCP solved twice through "pallas" and twice through
     "schur_lr", bit for bit equal; the SOC segment sums timed against
     index_add_;
  3d. the exponential, power and generalized power cones through "pallas"
     and "auto": an entropy maximization (n = 500, KKT N = 2540) and a
     p-norm regression (p = 1.5, F of 300 x 100, N = 1300), both on the
     blocked kernel; a geometric-mean allocation over 16 generalized power
     cones (N = 176, the unblocked kernel, every step under dual scaling
     with the barrier backtracking); BatchSolver on B = 512 entropy
     problems (n = 40, N = 208), every lane Solved, four lanes re-solved
     alone, one factor launch per iteration; warm re-solves of phase 2's
     QP and of the entropy problem after a 1 % update of q or b, equal to
     their cold re-solves; and a termination callback that stops at
     iteration 3;
  3e. the PSD triangle cone and chordal decomposition: the max-cut SDP
     relaxation in primal form over a random graph of order 100 (one
     PSDTriangleConeT(100) and a ZeroConeT(100), KKT N = 10200, K1) through
     "pallas" and "auto" (which takes the JAX package's route: tentatively
     sparse for its PSD block, dense after the chordal analysis), within
     1e-7 and 1 iteration; the dual max-cut relaxation of a random graph of
     order 124 and average degree 3, decomposed into its cliques, through
     "pallas" (K1) and "lu", each within 1e-7 of its solve without the
     decomposition and with a completed dual PSD to 1e-7, through "auto"
     (dense or the multifrontal engine, as the card's cost model routes
     it, within 1e-7 too), and a warm re-solve through the clique transform
     after a 1 % change of q; the JAX bench's strictly complementary SDP
     batch (n = 16, NonnegativeConeT(32) + PSDTriangleConeT(4), N = 58, K2)
     at B = 64 and 2048, checked as phase 3b checks its batches, each lane's
     iterations within 4 between the backends and between a lane alone and
     in the batch (the JAX package's own spread on those lanes); every
     solve prints its device reads and every device wait the sync debug
     mode sees;
  3f. the sparse multifrontal KKT path at f64: the JAX bench's banded QP
     (bench.py:307-342: n = 20000, P banded at offsets 0, ±1, ±7,
     A = [I; -I], KKT N = 60000) through "multifrontal" and "auto" (which
     must route it there), each Solved with host-side KKT residuals from
     scipy of at most 1e-7; the same family at n = 2000 (N = 6000) through
     "multifrontal" and "lu", objectives within 1e-7, the multifrontal
     solve repeated bit for bit; the bench's banded
     SDP (bench.py:420-463: PSDTriangleConeT(250), 499 variables, 31,375
     rows) through "auto" and "multifrontal", each Solved within 1e-7 of
     "lu" on the chordally decomposed dense path, printing the route the
     card's cost model took; for each solve the iterations, ms/iteration,
     one factor and one solve timed with CUDA events, the plan (levels,
     buckets, nnzL, flops), the symbolic analysis' seconds, the cost model's
     measured constants and predictions, device reads and waits per
     iteration and the unblocked kernel's launches per factor (the fronts'
     diagonal blocks, per-matrix signs); phase 1 holds that kernel with
     [B, N] signs against its twin, bit for bit, at the fronts' shapes
     (287 x 32², the QP's widest bucket; 35 x 32², the SDP's; 7 x 1², 17²
     and 32²);
  3g. SparseBatchSolver at f64, B problems of one sparsity pattern through
     one multifrontal plan: the JAX bench's batched_sparse_qp
     (bench.py:466-500: tridiagonal P, A = [I; -I], n = 1000, KKT N = 3000)
     at B = 32, solved twice bit for bit, and at B = 512 (about 1 GB of
     fronts); NN + SOC batches (n = 500, B = 64, the rank-2 expansion and
     the assembly through Kvals: the cone slack, and the cone active as in
     the JAX package's test_sparse_batch_socp_lane, where a few lanes end
     AlmostSolved in the JAX package too); a feasible and a
     primal-infeasible lane in one batch; and the B = 32 batch warm
     re-solved after a 1 % update of q and b.  Every lane Solved
     (PrimalInfeasible for the infeasible one; Solved or AlmostSolved with
     the active cone, the Solved lanes' host KKT residuals at most 1e-7);
     four lanes of each of the QP batches and the slack NN + SOC batch
     equal DefaultSolver's "multifrontal" solve of them alone (status,
     iterations within 1, objective within 1e-7 relative, host KKT
     residuals at most 1e-7), the loop over them timed as the yardstick;
     for each batch solves/s, ms/iteration (the slowest lane), device reads
     per iteration, the unblocked kernel's launches per factor, one factor
     and one solve by CUDA events and the peak device memory; phase 1
     holds that kernel bit for bit at the batches' block shapes
     (2752 and 44032 x 32²);
  3h. the host surface: buildinfo (the native symbolic engine must have
     built); the banded QP of phase 3f (N = 60000) and the sparse batch of
     phase 3g (B = 32) set up through the native symbolic engine and through
     the Python versions, plans equal field for field, setup and symbolic
     seconds of each; the N = 60000 QP saved to JSON (O(nnz): P and A carry
     exactly the CSC's entries), loaded on the card and solved bit for bit
     as the original through "multifrontal" (K3), and the same for the
     portfolio QP of phase 2 through "pallas" (K1); a verbose solve under
     print_to_buffer, its report in the buffer and nothing on stdout; a
     profile() trace of the small QP's "pallas" solve naming the unblocked
     kernel; the C ABI (include/clarabel_tpu.h over capi/capi.cpp, built
     with g++) loaded in this process: the portfolio QP through "pallas"
     on the card (status Solved, objective within 1e-9 of DefaultSolver's,
     K1 launched), the shim's overhead per call, q updated and re-solved,
     a termination callback stopping at iteration 3, the small QP (K2);
     and the standalone C driver (capi/example_capi.c) run on the card;
  3i. dense f32, each problem solved twice on the card with
     DefaultSettings.for_float32, bit for bit equal, every problem (lane)
     Solved within 1e-3 relative of its f64 solve of an earlier phase:
     through "pallas" the portfolio QP (N = 2001, K1 at f32), the SOCP
     (N = 1552, K1; the unpivoted f32 factor overflows at its first scaled
     iteration in the JAX package too, scripts/f32_reference_status.py, so
     it is gated on that package's NumericalError), the small QP (N = 201,
     K2) and phase 3b's box-QP batch
     (B = 2048, N = 96, K2); through "auto" -> "lu" -> the double-float LU
     phase 3d's geometric means (N = 176, dual scaling) and its entropy
     batch (B = 512, N = 208), the df factor launched once per iteration for
     the whole batch (which ~3 % of lanes end short of Solved is decided
     by rounding in both packages: a lane is held to the JAX package's own
     status where that misses too, else to Solved when solved alone, the
     count to the JAX package's by a one-sided exact test at 1 %, every
     lane to its f64 objective); through "auto" -> "lu" -> the Jacobi LU the entropy
     maximization (N = 2540) and the p-norm regression (N = 1300); the
     portfolio QP through "schur" (NumericalError at f32 in the JAX
     package too: gated on that status) and "qdldl" (the plain f32 LU with
     the compensated refinement); each printing ms per iteration, refinement
     sweeps per refined solve, reads per iteration and, for batches,
     solves/s;
  3j. f32 on PSD layouts (the double-float PSD scaling: eigh-floored NT
     factors, double-float svec conversions, skron blocks and congruences,
     K_lo through the refinement, the centering recovery): phase 3e's SDP
     batch at B = 64 and 2048 (N = 58) through "auto" (the double-float LU
     with K_lo, once per iteration; solved twice, bit for bit equal) and
     "pallas" (K2 at f32), the Solved lanes' objectives within 1e-3 of
     phase 3e's f64 lanes and x within 1e-3 of the generator's x* at
     B = 64 (at B = 2048 within the distance each lane's f32 stopping point
     admits, √(2·gap/λ_min(P)): the f32 tolerances leave a few lanes 1-2e-3
     from x*, in the JAX package too);
     "auto" at B = 64 every lane Solved, as in the JAX package; the lanes
     short of Solved held to the JAX package's own count at B = 64
     (scripts/f32_reference_status.py --problem sdp64, "pallas" 6 of 64)
     or its rate (B = 2048), and through "auto" each solved alone; lane 0
     through DefaultSolver with res_primal, res_dual < 1e-5; the chordal
     max-cut at f32 through "lu" (the Jacobi LU: N = 2181 > 512) and
     "pallas" (K1), within 1e-3 of phase 3e's undecomposed f64 solve; each
     printing ms per iteration and solves/s beside phase 3e's f64 figures,
     device reads and waits per iteration (and at B = 64 the device
     operations, kernels and copies, by the profiler) and how often the
     centering recovery fired;
  3k. f32 on the sparse path (the compensated sparse refinement: the
     limb-split segment sums and the DIA products' ``.df``, the
     K-consistent Δs recovery; K3 at f32 on the fronts' diagonal blocks),
     each problem against its f64 solve in this run, with the f32 preset:
     the banded QP of phase 3f (N = 60000) through "multifrontal", solved
     twice bit for bit; the banded SDP through "auto" (chordally decomposed,
     the multifrontal engine); phase 3g's sparse QP batches at B = 32 (twice,
     bit for bit) and 512 and its NN + SOC batch (the cone active) through
     SparseBatchSolver(dtype="float32"); the JAX package's f32 expansion
     test problem at d = 300 (ZeroConeT(1) + SecondOrderConeT(300), the
     rank-2 expansion and the segment matvec), with its host primal
     residual at the f32 preset's tol_feas.  Every problem (lane) Solved
     within 1e-4 relative of its f64 objective, the unblocked kernel
     launched -- but the NN + SOC batch, whose f32 end game leaves 46 of 64
     lanes short of Solved in the JAX package too (SPARSE_F32_JAX_SHORT):
     its lanes end in the statuses the JAX package's do, the counts of
     lanes short and failed held to that package's by the one-sided exact
     test at 1 %, the lanes Solved within 1e-4 of f64; each printing ms per
     iteration at f32 and f64, refinement sweeps per iteration and the
     kernel's launches per factor; phase 1 holds the kernel at f32 with the
     f32 preset's regularization bit for bit against its twin at the fronts'
     shapes (287, 35, 2752 and 44032 x 32²);
  3l. multi-device (torch.distributed process groups and DeviceMeshes).
     (a) In this process, a world of one over NCCL: ShardedRowSolver at
     f32 on the JAX package's tall sparse problem (n = 48, ~3 nonzeros a
     row) at m = 1e5 and 1e6 (A as row-sharded ELL blocks) and on a dense
     tall problem at n = 256, m = 1e5, each Solved or AlmostSolved within
     the JAX test's host residual bounds (5e-4), x within 1e-4 of
     DefaultSolver's f32 "schur_diag" solve, no collective carrying A's
     rows, collective calls and bytes per iteration printed; phase 3e's
     SDP batch (B = 2048, "pallas", K2) through BatchSolver(mesh=) and
     phase 3g's sparse QP batch (B = 32, K3 on the fronts) through
     SparseBatchSolver(mesh=), each bit for bit its unsharded solve.
     (b) Ranks sharing the one card (gloo, carrying CUDA tensors: NCCL
     refuses two ranks on one GPU; not a scaling figure): this script
     started as a world of 2 -- the m = 1e6 problem within 1e-4 of (a)'s,
     every rank the same bits, ms per iteration beside world 1's; the SDP
     batch split 1024 + 1024 and the sparse batch 16 + 16, every lane
     Solved within 1e-7 of (a)'s objectives -- and as a world of 4 on a
     2 x 2 (batch x rows) mesh, phase 3b's f32 box-QP batch (B = 2048,
     N = 96) through "auto" with A's rows split over each row group, every
     lane Solved within 1e-4 of phase 3c's unsharded f32 solve, a row
     group's ranks the same bits.  Any rank's failure fails the phase.
     NCCL across several cards is not exercised (one card);
  3m. the double-float LU past the one-block forms' N = 512, the grid forms
     (the factor's three launches per panel over the card, the solve's
     warps looping over their row blocks): df_lu_factor and df_lu_solve bit
     for bit against their twins at 1 x 513², 1 x 1024², 1 x 2540² (the
     entropy problem's) and 8 x 1024², with K_lo and without, and at
     1 x 1300² (the p-norm's), the solve at R = 2 and at R = 1 on its first
     column (one twin solve each, as in phase 1), and the four inputs whose
     twins spread NaN (the exact branches: an inf at 1 x 600², an entry
     past Dekker's split at 1 x 530², a masked multiplier past f32's range
     at 1 x 520², right-hand sides past the split at 1 x 577²), each
     printing its times, the kernels one factor launches (as the library
     counts them, held to the form's design), bound, non-FMA floors
     (card and one SM) and torch.linalg.lu_factor at f32 and f64;
     then kkt.dense.DF_LU_MAX_DIM raised to 4096 in this process, phase
     3i's f32 entropy (n = 500, N = 2540) and p-norm (N = 1300) solves
     through "auto" on the double-float route, each Solved within 1e-3 of
     its f64 objective and repeated bit for bit, beside their Jacobi-route
     solves of phase 3i (the default gate): status, iterations, ms per
     iteration and df_ldl.factor launches.  The double-float route may miss
     Solved only where the Jacobi route does;
  4. the launch counts of phases 2-3, 3b, 3d, 3e, 3f, 3g, 3h, 3i, 3j, 3k,
     3l and 3m and one JSON line per kernel and shape.

With --deterministic the run also sets torch.use_deterministic_algorithms
(warn only) and lists each operation PyTorch reports as having no
deterministic implementation.

Every failure raises, so the exit code is not 0 and no result line prints.
The last line of standard output is {"ok": true, "device": {...}}.  Without
a CUDA device, or without the clarabel_tpu_torch package beside it, the
script fails before it prints anything.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import types
import warnings

import numpy as np
import torch

# H100 SXM peaks (NVIDIA datasheet): FP64 tensor cores, FP32 outside the
# tensor cores (no TF32 here), HBM3 bandwidth
PEAK_FLOPS = {torch.float64: 67e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# one H100 SM's FP64 and FP32 lanes: each does one operation, or one
# multiply-add, a clock
SM_LANES = {torch.float64: 64, torch.float32: 128}

# kernel-vs-plain tolerances of the blocked kernel on the card, relative to
# the plain factor's largest entry: f64 differs only by the trailing
# update's summation order and FMA contraction; f32 by the same, at f32's
# eps over N = 2001 pivots.  The unblocked kernel rounds as its twin does
# and must equal it bit for bit.
FACTOR_TOL = {torch.float64: 1e-10, torch.float32: 1e-3}
# backward error ‖Kx − r‖∞ / (‖K‖∞ ‖x‖∞) of a factor-and-solve, a few
# N·eps for these well-conditioned quasidefinite matrices
BACKWARD_TOL = {torch.float64: 1e-11, torch.float32: 1e-3}

#: phase 3d's problems -> the LDLᵀ variant and the (B, n, m) their
#: "pallas" solves factor
NONSYM_SHAPES = {
    "entropy": ("blocked", 1, 1000, 1540),
    "pnorm": ("blocked", 1, 400, 900),
    "genpow": ("unrolled", 1, 80, 96),
    "batch": ("unrolled", 512, 80, 128),
}

KERNELS = {
    "blocked": dict(name="ldl_blocked", replaces="clarabel_tpu/kkt/pallas_ldl.py:106"),
    "unrolled": dict(name="ldl_unrolled", replaces="clarabel_tpu/kkt/pallas_ldl.py:144"),
    "fori": dict(name="ldl_fori", replaces="clarabel_tpu/kkt/pallas_ldl.py:191"),
}
SOURCE = "clarabel_tpu_torch/kkt/csrc/ldl.cu"
DF_SOURCE = "clarabel_tpu_torch/kkt/csrc/df_lu.cu"
#: (B, N) of the unblocked kernel with per-matrix signs: the diagonal-block
#: batches of phase 3f's multifrontal solves (the banded QP's widest bucket,
#: 287 fronts; the banded SDP's, 35), of phase 3g's sparse batches (the
#: n = 1000 QP's widest bucket, 86 fronts, in 32 and 512 lanes) and edge
#: widths
FRONT_SHAPES = ((287, 32), (35, 32), (2752, 32), (44032, 32), (7, 1), (7, 17), (7, 32))
#: the same kernel at f32 on phase 3k's fronts, the same plans' widest
#: buckets (the banded QP's and SDP's, the sparse batches'), with the f32
#: preset's regularization
FRONT_SHAPES_F32 = ((287, 32), (35, 32), (2752, 32), (44032, 32))


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sm_clock_hz() -> float:
    """The card's maximum SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` calls after one warm-up,
    timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# -----------------------------------------------------------------
# problem data, made from the seed
# -----------------------------------------------------------------


def kkt_batch(B, n, m, dtype, seed, device):
    """Quasidefinite [[P, Aᵀ], [A, -I]] with P = MMᵀ/n + I, as the JAX
    package's bench builds them (bench.py:275-279); drawn on the device
    where n > 2000, whose n³ products numpy would take minutes over."""
    if n > 2000:
        gen = torch.Generator(device=device).manual_seed(seed)
        M = torch.randn((B, n, n), generator=gen, dtype=torch.float64, device=device) / n**0.5
        P = M @ M.mT + torch.eye(n, dtype=torch.float64, device=device)
        del M
        A = torch.randn((B, m, n), generator=gen, dtype=torch.float64, device=device)
        eye = torch.eye(m, dtype=torch.float64, device=device).expand(B, m, m)
        return torch.cat([torch.cat([P, A.mT], dim=2), torch.cat([A, -eye], dim=2)],
                         dim=1).to(dtype)
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(B, n, n)) / np.sqrt(n)
    P = np.einsum("bij,bkj->bik", M, M) + np.eye(n)
    A = rng.normal(size=(B, m, n))
    K = np.block([[P, np.transpose(A, (0, 2, 1))], [A, -np.tile(np.eye(m), (B, 1, 1))]])
    return torch.as_tensor(K, dtype=dtype, device=device)


def with_irregular_pivots(K, pivots):
    """K with each row and column of ``pivots`` decoupled, leaving the
    given pivot on its diagonal."""
    K = K.clone()
    for r, v in pivots:
        K[:, r, :] = 0.0
        K[:, :, r] = 0.0
        K[:, r, r] = v
    return K


def portfolio_qp(n, k, seed, gamma=1.0):
    """Markowitz long-only portfolio (Boyd & Vandenberghe §4.4.1; the
    portfolio class of the OSQP benchmark suite): min ½xᵀ(γΣ)x − μᵀx s.t.
    1ᵀx = 1, x ≥ 0, with Σ = F Fᵀ + D over k factors."""
    from clarabel_tpu_torch import NonnegativeConeT, ZeroConeT

    rng = np.random.default_rng(seed)
    F = rng.normal(size=(n, k)) / np.sqrt(k)
    D = rng.uniform(0.05, 0.2, size=n)
    mu = rng.normal(0.05, 0.1, size=n)
    P = gamma * (F @ F.T + np.diag(D))
    A = np.vstack([np.ones((1, n)), -np.eye(n)])
    b = np.concatenate([[1.0], np.zeros(n)])
    return P, -mu, A, b, [ZeroConeT(1), NonnegativeConeT(n)]


def portfolio_qp_batch(B, n, k, seed):
    """B scenario instances of :func:`portfolio_qp`: one covariance Σ, and
    each instance its own draw of the expected returns μ."""
    P, _, A, b, cones = portfolio_qp(n, k, seed)
    mu = np.random.default_rng(seed + 1).normal(0.05, 0.1, size=(B, n))
    tile = lambda v: np.tile(v, (B, 1, 1) if v.ndim == 2 else (B, 1))
    return tile(P), -mu, tile(A), tile(b), cones


def box_qp_batch(B, n, seed):
    """The JAX bench's batched box QP (bench.py:75-82): P = MMᵀ/n + I/2,
    -1 ≤ x ≤ 1, one NonnegativeConeT(2n)."""
    from clarabel_tpu_torch import NonnegativeConeT

    rng = np.random.default_rng(seed)
    M = rng.normal(size=(B, n, n)) / np.sqrt(n)
    P = np.einsum("bij,bkj->bik", M, M) + 0.5 * np.eye(n)
    q = rng.normal(size=(B, n))
    A = np.tile(np.vstack([np.eye(n), -np.eye(n)]), (B, 1, 1))
    return P, q, A, np.ones((B, 2 * n)), [NonnegativeConeT(2 * n)]


def socp_batch(B, n, seed):
    """The JAX bench's batched SOCP (bench.py:156-167): the box QP's data
    plus one SecondOrderConeT(n + 1) bounding ‖x‖ by 10."""
    from clarabel_tpu_torch import NonnegativeConeT, SecondOrderConeT

    P, q, A, b, _ = box_qp_batch(B, n, seed)
    dsoc = n + 1
    Asoc = np.zeros((dsoc, n))
    Asoc[1:, :n] = -np.eye(dsoc - 1)[:, :n]
    A = np.concatenate([A, np.tile(Asoc, (B, 1, 1))], axis=1)
    b = np.concatenate([b, np.tile(np.concatenate([[10.0], np.zeros(dsoc - 1)]), (B, 1))], axis=1)
    return P, q, A, b, [NonnegativeConeT(2 * n), SecondOrderConeT(dsoc)]


def portfolio_socp(n, k, seed, sigma=0.05):
    """Risk-constrained portfolio: max μᵀx s.t. 1ᵀx = 1, x ≥ 0,
    ‖[Fᵀx; D^{1/2}x]‖₂ ≤ σ (one SecondOrderConeT(1 + k + n))."""
    from clarabel_tpu_torch import NonnegativeConeT, SecondOrderConeT, ZeroConeT

    rng = np.random.default_rng(seed)
    F = rng.normal(size=(n, k)) / np.sqrt(k)
    D = rng.uniform(0.05, 0.2, size=n)
    mu = rng.normal(0.05, 0.1, size=n)
    A = np.vstack([np.ones((1, n)), -np.eye(n), np.zeros((1, n)), -F.T,
                   -np.diag(np.sqrt(D))])
    b = np.concatenate([[1.0], np.zeros(n), [sigma], np.zeros(k + n)])
    cones = [ZeroConeT(1), NonnegativeConeT(n), SecondOrderConeT(1 + k + n)]
    return np.zeros((n, n)), -mu, A, b, cones


def _svec(X):
    """svec of [..., d, d]: the upper triangle column by column, the
    off-diagonal entries times √2 (the reference's packing)."""
    d = X.shape[-1]
    return np.stack([X[..., i, j] * (1.0 if i == j else np.sqrt(2.0))
                     for j in range(d) for i in range(j + 1)], axis=-1)


def random_graph_laplacian(order, edges, rng):
    """The Laplacian of a random graph of ``order`` vertices and ``edges``
    unit-weight edges."""
    pairs = np.array([(i, j) for j in range(order) for i in range(j)])
    pick = pairs[rng.choice(len(pairs), size=edges, replace=False)]
    W = np.zeros((order, order))
    W[pick[:, 0], pick[:, 1]] = W[pick[:, 1], pick[:, 0]] = 1.0
    return np.diag(W.sum(axis=1)) - W


def maxcut_primal(order, edges, seed):
    """The max-cut SDP relaxation (Goemans-Williamson) in primal form, of
    a random graph of ``order`` vertices (SDPLIB mcp100's order: 100) and
    ``edges`` unit-weight edges: minimize <C, X> over X ⪰ 0 with diag(X) = 1, C = -L/4.  x = svec(X):
    tri(order) variables, one PSDTriangleConeT(order) on s = x and a
    ZeroConeT(order) on the diagonal.  Every entry of X is a variable, so
    the PSD cone has no sparsity to decompose."""
    from clarabel_tpu_torch import PSDTriangleConeT, ZeroConeT

    L = random_graph_laplacian(order, edges, np.random.default_rng(seed))
    tri = order * (order + 1) // 2
    diag = np.array([j * (j + 1) // 2 + j for j in range(order)])
    A_eq = np.zeros((order, tri))
    A_eq[np.arange(order), diag] = 1.0
    A = np.vstack([-np.eye(tri), A_eq])
    b = np.concatenate([np.zeros(tri), np.ones(order)])
    return (np.zeros((tri, tri)), _svec(-L / 4.0), A, b,
            [PSDTriangleConeT(order), ZeroConeT(order)])


def maxcut_dual(order, degree, seed):
    """The dual of the max-cut relaxation of a random sparse graph with
    SDPLIB mcp124's order (124) at average degree ``degree``: minimize Σ yᵢ
    subject to Diag(y) - L/4 ⪰ 0, as s = svec(Diag(y) - L/4) in one
    PSDTriangleConeT(order): b = svec(-L/4), A y = -svec(Diag(y)).  Its
    aggregate sparsity is the graph's, so chordal decomposition splits the
    cone into cliques."""
    from clarabel_tpu_torch import PSDTriangleConeT

    L = random_graph_laplacian(order, order * degree // 2, np.random.default_rng(seed))
    tri = order * (order + 1) // 2
    A = np.zeros((tri, order))
    A[[j * (j + 1) // 2 + j for j in range(order)], np.arange(order)] = -1.0
    return (np.zeros((order, order)), np.ones(order), A, _svec(-L / 4.0),
            [PSDTriangleConeT(order)])


def sdp_batch(B, n, dmat, seed, optimum=False):
    """The JAX bench's batched SDP (bench.py:194-256), B strictly
    complementary instances built from a known primal-dual optimal pair:
    interior x*, complementary s* ⊥ z* on NonnegativeConeT(2n) (a quarter
    of the rows active) and on PSDTriangleConeT(dmat) (S*, Z* PSD on
    orthogonal complements), then b = Ax* + s*, q = -(Px* + Aᵀz*).  With
    ``optimum`` returns (problem, x*)."""
    from clarabel_tpu_torch import NonnegativeConeT, PSDTriangleConeT

    tri = dmat * (dmat + 1) // 2
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(B, n, n)) / np.sqrt(n)
    P = np.einsum("bij,bkj->bik", M, M) + 0.5 * np.eye(n)
    Apsd = np.zeros((tri, n))
    Apsd[:tri, :min(tri, n)] = -np.eye(tri)[:, :min(tri, n)]
    A = np.tile(np.vstack([np.eye(n), -np.eye(n), Apsd]), (B, 1, 1))
    x_star = 0.5 * rng.normal(size=(B, n))
    s_nn = rng.uniform(0.5, 1.5, (B, 2 * n))
    z_nn = np.zeros((B, 2 * n))
    act = rng.uniform(size=(B, 2 * n)) < 0.25
    z_nn[act] = rng.uniform(0.5, 1.5, act.sum())
    s_nn[act] = 0.0
    Qo, _ = np.linalg.qr(rng.normal(size=(B, dmat, dmat)))
    k = dmat // 2
    S = np.einsum("bik,bk,bjk->bij", Qo[:, :, :k], rng.uniform(0.5, 1.5, (B, k)), Qo[:, :, :k])
    Z = np.einsum("bik,bk,bjk->bij", Qo[:, :, k:], rng.uniform(0.5, 1.5, (B, dmat - k)),
                  Qo[:, :, k:])
    s_star = np.concatenate([s_nn, _svec(S)], axis=1)
    z_star = np.concatenate([z_nn, _svec(Z)], axis=1)
    b = np.einsum("bmn,bn->bm", A, x_star) + s_star
    q = -(np.einsum("bij,bj->bi", P, x_star) + np.einsum("bmn,bm->bn", A, z_star))
    problem = P, q, A, b, [NonnegativeConeT(2 * n), PSDTriangleConeT(dmat)]
    return (problem, x_star) if optimum else problem


# -----------------------------------------------------------------
# phase 1: kernels against their plain versions
# -----------------------------------------------------------------


def bound_ms(B, N, dtype):
    """(least milliseconds, "bytes" or "operations") for B factorizations
    of N x N: N³/3 flops each (N³/6 multiply-adds, as a Cholesky
    factorization) against moving K in and the factor out once."""
    t_ops = B * (N**3 / 3.0) / PEAK_FLOPS[dtype]
    t_bytes = B * 2.0 * N * N * torch.finfo(dtype).bits / 8 / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def one_sm_ms(B, N, dtype, sm_hz):
    """Two floors of a kernel that factors each matrix on one SM, for the
    N³/3 flops of the matrices that share the busiest SM: the unblocked
    design's, whose multiplies and subtractions stay separate operations
    (its twin rounds each, and bitwise equality forbids an FMA), one a lane
    a clock at the card's maximum SM clock; and the SM's own peak, its share
    of the card's PEAK_FLOPS (at f64 the tensor cores' rate, 4x the
    design's)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flops = -(-B // sms) * N**3 / 3.0
    return dict(one_sm_nonfma_floor_ms=flops / (SM_LANES[dtype] * sm_hz) * 1e3,
                one_sm_peak_ms=flops / (PEAK_FLOPS[dtype] / sms) * 1e3)


def check_kernel(variant, B, n, m, dtype, seed, device, settings, reps, sm_hz):
    from clarabel_tpu_torch.kkt import pallas_ldl as pl

    N = n + m
    K = kkt_batch(B, n, m, dtype, seed, device)
    sign = torch.ones(N, dtype=dtype, device=device)
    sign[n:] = -1.0
    eps, delta = pl._regularization(settings)
    plain = pl.ldl_blocked_plain if variant == "blocked" else pl.ldl_unblocked_plain

    (kind, (packed, _)), ok = pl.ldl_factor(K, n, m, settings, variant)
    ref = plain(K, sign, eps, delta)
    torch.cuda.synchronize()
    assert bool(ok.all()), f"{variant}: non-finite factor"
    err = float((packed - ref).abs().max())
    scale = float(ref.abs().max())
    if variant == "blocked":
        assert err <= FACTOR_TOL[dtype] * scale, f"{variant} N={N} {dtype}: factor differs by {err:.3e}"
    else:
        assert torch.equal(packed, ref), f"{variant} B={B} N={N} {dtype}: not bitwise equal, max|Δ| {err:.3e}"

    rhs = torch.as_tensor(np.random.default_rng(seed + 1).normal(size=(B, N)),
                          dtype=dtype, device=device)
    solve = pl.ldl_solve_lower if kind == "pldl_lower" else pl.ldl_solve
    x = solve(packed, N, rhs)
    resid = torch.einsum("bij,bj->bi", K, x) - rhs
    Knorm = K.abs().sum(dim=2).amax(dim=1)
    backward = float((resid.abs().amax(dim=1) / (Knorm * x.abs().amax(dim=1))).max())
    assert backward <= BACKWARD_TOL[dtype], f"{variant} N={N}: backward error {backward:.3e}"

    row = dict(variant=variant, B=B, N=N, dtype=str(dtype).replace("torch.", ""),
               max_abs_err=err, max_abs_ref=scale, backward_error=backward)
    row["ms"] = cuda_ms(lambda: pl.ldl_factor(K, n, m, settings, variant), reps)
    row["plain_ms"] = cuda_ms(lambda: plain(K, sign, eps, delta), 1)
    # the pivoted LDLᵀ factors one matrix after another, seconds at B = 1024
    # and at N = 10200
    row["ldl_factor_ms"] = (cuda_ms(lambda: torch.linalg.ldl_factor_ex(K), reps)
                            if B <= 64 and N <= 4000 else None)
    row["lu_factor_ms"] = cuda_ms(lambda: torch.linalg.lu_factor_ex(K), reps)
    row["bound_ms"], row["bound_by"] = bound_ms(B, N, dtype)
    if variant != "blocked":
        row["switch_column"], _ = pl.unblocked_plan(N, K.element_size(), pl._smem_capacity())
        row.update(one_sm_ms(B, N, dtype, sm_hz))
    ldl_ms = "not run" if row["ldl_factor_ms"] is None else f"{row['ldl_factor_ms']:.3f} ms"
    log(f"  {variant:8s} B={B} N={N:4d} {row['dtype']}: max|Δ| {err:.2e} (of {scale:.2e}), "
        f"backward {backward:.2e}, kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, "
        f"ldl_factor {ldl_ms}, lu_factor {row['lu_factor_ms']:.3f} ms, "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})"
        + (f", one SM: non-FMA floor {row['one_sm_nonfma_floor_ms']:.4f} ms, peak "
           f"{row['one_sm_peak_ms']:.4f} ms; switch column {row['switch_column']}"
           if variant != "blocked" else ""))
    return row


def check_regularization(variant, n, pivots, device, settings):
    """The regularization replaces exactly the (row, pivot) pairs of
    ``pivots`` at n = m, in the kernel as in its twin."""
    from clarabel_tpu_torch.kkt import pallas_ldl as pl

    m = n
    K = with_irregular_pivots(kkt_batch(2, n, m, torch.float64, 3, device), pivots)
    sign = torch.ones(n + m, dtype=K.dtype, device=device)
    sign[n:] = -1.0
    eps, delta = pl._regularization(settings)
    plain = pl.ldl_blocked_plain if variant == "blocked" else pl.ldl_unblocked_plain
    (_, (packed, _)), ok = pl.ldl_factor(K, n, m, settings, variant)
    ref = plain(K, sign, eps, delta)
    d, d_ref = packed.diagonal(dim1=1, dim2=2), ref.diagonal(dim1=1, dim2=2)
    fired, fired_ref = d.abs() == delta, d_ref.abs() == delta
    assert bool(ok.all())
    expected = torch.zeros_like(fired)
    expected[:, [r for r, _ in pivots]] = True
    assert torch.equal(fired, fired_ref) and torch.equal(fired, expected), \
        f"{variant}: regularized pivots differ"
    err = float((packed - ref).abs().max())
    if variant == "blocked":
        assert err <= FACTOR_TOL[torch.float64] * float(ref.abs().max())
    else:
        assert torch.equal(packed, ref), f"{variant}: not bitwise equal, max|Δ| {err:.3e}"
    log(f"  {variant:8s} N={n + m} regularization fires on pivots "
        f"{fired[0].nonzero().flatten().tolist()} in both, max|Δ| {err:.2e}")


def front_blocks(B, N, seed, device, dtype=torch.float64):
    """B symmetric N x N blocks as the multifrontal engine hands them to the
    unblocked kernel, with their [B, N] expected signs: each block
    diagonally dominant in its own mixed signs, and two pivots that fire
    the regularization (block 0's first, tiny and decoupled; the last
    block's last, of the wrong sign)."""
    rng = np.random.default_rng(seed)
    sign = np.where(rng.random((B, N)) < 0.5, 1.0, -1.0)
    K = rng.normal(size=(B, N, N))
    K = K + np.swapaxes(K, 1, 2)
    K[:, np.arange(N), np.arange(N)] = 4.0 * N * sign
    K[0, 0, :] = K[0, :, 0] = 0.0
    K[0, 0, 0] = 1e-15 * sign[0, 0]
    K[-1, -1, -1] = -5.0 * sign[-1, -1]
    as_t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    return as_t(K), as_t(sign)


def check_front_blocks(B, N, seed, device, settings, sm_hz, reps=20, dtype=torch.float64):
    """``ldl_unblocked_kernel`` with per-matrix signs (a sign stride of N),
    the multifrontal engine's route for its diagonal blocks, against its
    plain twin on the card at ``dtype`` (with the regularization of
    ``settings``: the f32 preset's at f32): bit for bit, the regularization
    firing on the same pivots."""
    from clarabel_tpu_torch.kkt import pallas_ldl as pl
    from clarabel_tpu_torch.kkt import sparse as kkt_sparse

    K, sign = front_blocks(B, N, seed, device, dtype)
    eps, delta = kkt_sparse._regularization(settings)
    before = pl.ldl_unblocked.launches
    packed = pl.ldl_unblocked(K, sign, eps, delta)
    ref = pl.ldl_unblocked_plain(K, sign, eps, delta)
    torch.cuda.synchronize()
    assert pl.ldl_unblocked.launches == before + 1
    assert bool(torch.isfinite(packed).all()), f"front blocks {B}x{N}²: non-finite factor"
    err = float((packed - ref).abs().max())
    assert torch.equal(packed, ref), f"front blocks {B}x{N}²: not bitwise equal, max|Δ| {err:.3e}"
    d = packed.diagonal(dim1=1, dim2=2)
    fired = (d == delta * sign).nonzero().tolist()
    assert torch.equal(d == delta * sign, ref.diagonal(dim1=1, dim2=2) == delta * sign)
    assert [0, 0] in fired and [B - 1, N - 1] in fired
    name = str(dtype).replace("torch.", "")
    row = dict(variant="fori", signs="per-matrix", B=B, N=N, dtype=name, eps=eps, delta=delta,
               max_abs_err=err, max_abs_ref=float(ref.abs().max()), regularized=fired)
    row["ms"] = cuda_ms(lambda: pl.ldl_unblocked(K, sign, eps, delta), reps)
    row["plain_ms"] = cuda_ms(lambda: pl.ldl_unblocked_plain(K, sign, eps, delta), 1)
    row["lu_factor_ms"] = cuda_ms(lambda: torch.linalg.lu_factor_ex(K), reps)
    row["bound_ms"], row["bound_by"] = bound_ms(B, N, dtype)
    row.update(one_sm_ms(B, N, dtype, sm_hz))
    pl.ldl_unblocked.launches = before
    log(f"  fori     B={B} N={N:4d} {name}, [B, N] signs: bitwise equal, regularized {fired}, "
        f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.3f} ms, lu_factor "
        f"{row['lu_factor_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms ({row['bound_by']}), "
        f"one SM: non-FMA floor {row['one_sm_nonfma_floor_ms']:.5f} ms, peak "
        f"{row['one_sm_peak_ms']:.5f} ms")
    return row


def df_matrices(B, N, kind, seed, device, with_lo=True):
    """B f32 KKT-like matrices K = K_hi + K_lo [B, N, N]: ``"random"``
    quasidefinite with a 1e±3 spread on the -Hs diagonal (the df LU's
    regime, tests/test_df_lu.py's ``_quasidef``); ``"zero pivot"``, the
    same with row and column N // 3 zero, so that column stays zero and its
    pivot is replaced (and every candidate ties at 0); ``"ties"``, the
    same with column 0 zero but for three candidates: K_00 = 1 and, with
    diagonals ±2 (so that the exact scaling treats them alike), +4 in row 2
    and -4 in row N - 2, which tie as the largest (the first must win);
    ``"inf"``, an inf below the diagonal; ``"huge"``, 3e37 below the
    diagonal, past Dekker's split (2^115) once scaled; ``"masked"``, column
    0 zero below K_00 and row and column z = N // 3 zero but for K_0z = 1e18
    (~1e33 once scaled): z's pivot becomes delta and row 0's masked
    multiplier over it overflows.  These three make the twin spread NaN
    through its masked updates, ``ok`` False, and the kernels take their
    exact branches.  ``"huge rhs"`` is ``"random"``, whose right-hand sides
    check_df_lu scales past the split: the solve's iterates overflow it on
    a finite factor, and the solve takes its exact branch."""
    rng = np.random.default_rng(seed)
    n = max(N // 4, 1)
    m = N - n
    M = rng.normal(size=(B, n, n))
    K = np.zeros((B, N, N))
    K[:, :n, :n] = M @ np.swapaxes(M, 1, 2) / n + np.eye(n)
    A = rng.normal(size=(B, m, n))
    K[:, n:, :n] = A
    K[:, :n, n:] = np.swapaxes(A, 1, 2)
    K[:, np.arange(n, N), np.arange(n, N)] = -(10.0 ** rng.uniform(-3, 3, size=(B, m)))
    if kind == "zero pivot":
        K[:, N // 3, :] = K[:, :, N // 3] = 0.0
    elif kind == "ties":
        K[:, :, 0] = 0.0
        K[:, 0, 0], K[:, 2, 2], K[:, N - 2, N - 2] = 1.0, 2.0, -2.0
        K[:, 2, 0], K[:, N - 2, 0] = 4.0, -4.0
    elif kind == "inf":
        K[:, N - 2, N // 2] = np.inf
    elif kind == "huge":
        K[:, N - 1, 1] = 3e37
    elif kind == "masked":
        z = N // 3
        K[:, 1:, 0] = K[:, z, :] = K[:, :, z] = 0.0
        K[:, 0, z] = 1e18
    K_hi = K.astype(np.float32)
    with np.errstate(invalid="ignore"):
        K_lo = np.nan_to_num((K - K_hi.astype(np.float64)).astype(np.float32), nan=0.0)
    as_t = lambda v: torch.as_tensor(v, device=device)
    return as_t(K_hi), as_t(K_lo) if with_lo else None


def df_factor_work(B, N):
    """(operations, bytes) of one double-float LU of B N x N matrices, as the
    twin's order needs them: per column the pivot search (an add and an abs
    per candidate), about 30 operations per entry of the column (the
    double-float division) and 28 per entry of the trailing block (TwoProd,
    the cross terms, two TwoSums); K_hi and K_lo read once, the (hi, lo)
    factor, the permutation and the flag written once."""
    cols = sum(N - j for j in range(N))
    trailing = sum((N - 1 - j) ** 2 for j in range(N))
    ops = B * (2 * cols + 30 * cols + 28 * trailing)
    return ops, B * (N * N * 16 + N * 12 + 1)


def fmt(v, digits):
    """``v`` with ``digits`` decimals, or "—" for a figure not measured."""
    return "—" if v is None else f"{v:.{digits}f}"


def timed_once(fn, times, key):
    """``fn()``, its CUDA-event milliseconds stored in ``times[key]``."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    times[key] = start.elapsed_time(stop)
    return out


def df_factor_kernel_launches(N):
    """Kernel launches of one df_ldl.factor at order N: one (the one-block
    form) up to 512; above, the grid form's scale launch, per panel of 8
    columns a panel and a swap launch and, but for the last panel, a
    trailing one, and the finish launch (csrc/df_lu.cu's
    df_lu_factor_grid)."""
    from clarabel_tpu_torch.kkt import df_ldl

    if N <= df_ldl.BLOCK_MAX_DIM:
        return 1
    panels = -(-N // df_ldl.FACTOR_NB)
    return 1 + 2 * panels + (panels - 1) + 1


def df_solve_work(B, N, R):
    """(operations, bytes) of one double-float solve of R right-hand sides,
    the triangles' work whatever computes it: N(N - 1) updates per
    right-hand side over both sweeps (a double-float product and
    difference, 41 operations), N divisions (36) and 3 operations per entry
    in and out; the factor pair, perm, s and the right-hand sides read once,
    the solutions written once."""
    ops = B * R * (41 * N * (N - 1) + 36 * N + 3 * N)
    return ops, B * (N * N * 8 + N * 12 + 8 * N * R)


def nonfma_floor_ms(ops, B, sm_hz):
    """(card, one SM) floors of an error-free double-float kernel, whose
    adds and multiplies are separate operations (an FMA breaks TwoProd and
    bitwise equality with the twin): ``ops`` over every SM's 128 FP32 lanes
    at the card's maximum SM clock (33.5 T operations/s on the H100 SXM),
    and the ⌈B / SMs⌉ matrices of the busiest SM over its own lanes."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_sm = -(-B // sms) * (ops / max(B, 1))
    lanes = SM_LANES[torch.float32] * sm_hz
    return ops / (sms * lanes) * 1e3, per_sm / lanes * 1e3


def work_bound_ms(ops, nbytes):
    """(least milliseconds, "bytes" or "operations") at the card's FP32
    rate outside the tensor cores and its memory rate."""
    t_ops = ops / PEAK_FLOPS[torch.float32]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def same_bits(a, b):
    """Equal entry for entry, NaNs in the same places (torch.equal fails on
    any NaN)."""
    if a.dtype.is_floating_point:
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            return False
        a, b = torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0)
    return torch.equal(a, b)


#: the times the double-float LU kernels' previous design (one block walking
#: the columns, the trailing block in device memory) took in this phase on an
#: H100 80GB HBM3 at 700 W, as recorded in PERF.md, not measured here: shown
#: in brackets in this phase's log only.  (B, N, K_lo) -> (factor ms, solve
#: ms R = 1, R = 2)
DF_PREVIOUS_MS = {(1, 512, True): (14.135, 1.110, 1.342), (1, 176, True): (1.087, 0.190, 0.202),
              (1, 176, False): (1.188, 0.190, 0.202), (512, 208, False): (34.589, 0.503, 0.661)}
#: kinds whose twin factors spread NaN through the masked updates (ok False)
DF_NONFINITE = ("inf", "huge", "masked")


def check_df_lu(B, N, kind, seed, device, sm_hz, with_lo=True, reps=10, time_it=True):
    """``df_lu_factor`` and ``df_lu_solve`` against their plain twins on the
    card, bit for bit: the factor's (hi, lo) pair, permutation, scaling and
    ok flag, and the solve at R = 2 and at R = 1 (a vector), NaN positions
    included.  The R = 1 right-hand side is the first column of the R = 2
    ones, held to the first column of the twin's R = 2 solve: the twin
    computes each column on its own (every operation is elementwise over the
    right-hand sides), so that column is its R = 1 solve bit for bit, and
    one twin solve serves both.  Timed against the twins (their runs for the
    comparison, one each, not warmed up: at the grid forms' orders a twin
    factor takes seconds), the bound at the FP32 peak and the non-FMA
    floors, and, as yardsticks the port never calls,
    torch.linalg.lu_factor of the same K at f32 and f64; the kernels one
    factor launches, as the library counts the launches it issues
    (``df_lu_factor_kernels``), held to the form's design
    (:func:`df_factor_kernel_launches`).  torch.profiler is not used for
    that count: in a full run it lost a sixth of a grid factor's kernel
    records (168 and 165 of 196 at 1 x 513²)."""
    from clarabel_tpu_torch.kkt import build, df_ldl

    K_hi, K_lo = df_matrices(B, N, kind, seed, device, with_lo)
    before = (df_ldl.factor.launches, df_ldl.solve.launches)
    fac, ok = df_ldl.factor(K_hi, K_lo)
    plain = {}
    ref, ok_ref = timed_once(lambda: df_ldl.factor_plain(K_hi, K_lo), plain, "factor")
    torch.cuda.synchronize()
    label = f"df LU B={B} N={N} {kind}{'' if with_lo else ', no K_lo'}"
    for name, got, want in zip(("Ah", "Al", "perm", "s"), fac, ref):
        assert same_bits(got, want), (
            f"{label}: factor {name} not bitwise equal to its twin, max|Δ| "
            f"{float((got.double() - want.double()).abs().max()):.3e}")
    assert torch.equal(ok, ok_ref), f"{label}: ok differs from its twin"
    assert bool(ok.all()) == (kind not in DF_NONFINITE), f"{label}: ok {ok.tolist()}"
    rng = np.random.default_rng(seed + 1)
    scale = 1e36 if kind == "huge rhs" else 1.0
    rhs2 = torch.as_tensor(scale * rng.normal(size=(B, N, 2)), dtype=torch.float32,
                           device=device)
    rhs = {1: rhs2[..., 0].contiguous(), 2: rhs2}
    x_ref2 = timed_once(lambda: df_ldl.solve_plain(ref, rhs2), plain, 2)
    refs = {1: x_ref2[..., 0], 2: x_ref2}
    for R, b in rhs.items():
        x = df_ldl.solve(fac, b)
        torch.cuda.synchronize()
        assert same_bits(x, refs[R]), f"{label}: solve R={R} not bitwise equal to its twin"
        finite = bool(torch.isfinite(x).all())
        assert finite == (kind in ("random", "ties")), f"{label}: solve R={R} finite={finite}"
    if kind == "ties":
        assert bool((fac[2][:, 0] == 2).all()), f"{label}: the first tied candidate lost"
    if B == 1:
        # one matrix without a batch dimension, as DefaultSolver factors it
        fac1, ok1 = df_ldl.factor(K_hi[0], None if K_lo is None else K_lo[0])
        assert all(same_bits(a, b[0]) for a, b in zip(fac1, fac)) and bool(ok1) == bool(ok[0])
        assert same_bits(df_ldl.solve(fac1, rhs[1][0]), df_ldl.solve(fac, rhs[1])[0]), \
            f"{label}: the unbatched solve differs"
    if kind == "random":
        # forward error against an f64 solve of K_hi + K_lo
        Kd = K_hi.double() + (0.0 if K_lo is None else K_lo.double())
        x64 = torch.linalg.solve(Kd, rhs[1].double())
        x = df_ldl.solve(fac, rhs[1]).double()
        fwd = float(((x - x64).norm(dim=-1) / x64.norm(dim=-1)).max())
    else:
        fwd = None
    df_ldl.factor.launches, df_ldl.solve.launches = before
    nonfinite = int((~torch.isfinite(fac[0])).sum())
    row = dict(B=B, N=N, kind=kind, K_lo=with_lo, bitwise=True, max_abs_err=0.0,
               forward_error=fwd, pivots=fac[2][0, : min(N, 4)].tolist(),
               ok=ok.tolist()[:4], nonfinite_factor_entries=nonfinite)
    if time_it:
        row["factor_ms"] = cuda_ms(lambda: df_ldl.factor(K_hi, K_lo), reps)
        row["factor_plain_ms"] = plain["factor"]
        row["solve_ms"] = {R: cuda_ms(lambda: df_ldl.solve(fac, b), reps) for R, b in rhs.items()}
        row["solve_plain_ms"] = {1: None, 2: plain[2]}
        lib = build.library("df_lu.cu")
        first = lib.df_lu_factor_kernels()
        df_ldl.factor(K_hi, K_lo)
        kernels = lib.df_lu_factor_kernels() - first
        design = df_factor_kernel_launches(N)
        assert kernels == design, (
            f"{label}: one factor launched {kernels} kernels, its form {design}")
        row["factor_kernels"] = kernels
        row["lu_factor_f32_ms"] = cuda_ms(lambda: torch.linalg.lu_factor_ex(K_hi), reps)
        Kd = K_hi.double()
        row["lu_factor_f64_ms"] = cuda_ms(lambda: torch.linalg.lu_factor_ex(Kd), reps)
        ops, nbytes = df_factor_work(B, N)
        row["factor_bound_ms"], row["factor_bound_by"] = work_bound_ms(ops, nbytes)
        row["factor_nonfma_floor_ms"], row["factor_one_sm_nonfma_floor_ms"] = nonfma_floor_ms(
            ops, B, sm_hz)
        row["solve_bound_ms"], row["solve_bound_by"], row["solve_nonfma_floor_ms"] = {}, {}, {}
        for R in rhs:
            ops, nbytes = df_solve_work(B, N, R)
            row["solve_bound_ms"][R], row["solve_bound_by"][R] = work_bound_ms(ops, nbytes)
            row["solve_nonfma_floor_ms"][R] = nonfma_floor_ms(ops, B, sm_hz)[0]
        df_ldl.factor.launches, df_ldl.solve.launches = before
    previous = DF_PREVIOUS_MS.get((B, N, with_lo)) if time_it else None
    log(f"  {label}: bitwise equal (factor, ok {row['ok']}, solve R=1 and 2), pivots "
        f"{row['pivots']}" + (f", forward error {fwd:.2e}" if fwd is not None else "")
        + (f", {nonfinite} non-finite factor entries" if nonfinite else "")
        + (f"; factor {row['factor_ms']:.3f} ms"
           + (f" [previous design, recorded: {previous[0]:.3f}]" if previous else "")
           + f", {row['factor_kernels']} kernels a factor"
           + f" (plain {row['factor_plain_ms']:.1f}, bound {row['factor_bound_ms']:.4f} "
           f"{row['factor_bound_by']}, non-FMA floor {row['factor_nonfma_floor_ms']:.4f}, one SM "
           f"{row['factor_one_sm_nonfma_floor_ms']:.4f}), solve R=1/2 "
           f"{row['solve_ms'][1]:.3f}/{row['solve_ms'][2]:.3f} ms"
           + (f" [recorded: {previous[1]:.3f}/{previous[2]:.3f}]" if previous else "")
           + f" (plain {fmt(row['solve_plain_ms'][1], 1)}/{row['solve_plain_ms'][2]:.1f}, bound "
           f"{row['solve_bound_ms'][1]:.4f}/{row['solve_bound_ms'][2]:.4f}, non-FMA floor "
           f"{row['solve_nonfma_floor_ms'][1]:.4f}/{row['solve_nonfma_floor_ms'][2]:.4f}), "
           f"lu_factor f32 {row['lu_factor_f32_ms']:.3f} ms, f64 {row['lu_factor_f64_ms']:.3f} ms"
           if time_it else ""))
    return row


#: the double-float LU's phase 1 shapes: (B, N, kind, with K_lo, timed).
#: 1 x 1² and 1 x 2², the one-block forms' edge 1 x 512², the shapes of phase
#: 3i's solves (the geometric means' 1 x 176², the entropy batch's
#: 512 x 208²) and of phase 3j's (64 and 2048 x 58² with K_lo), a zero
#: pivot and tied candidates, with K_lo and without;
#: the factor's panel edges at its panel width 8 (1 x 7², 1 x 9², 3 x 19²),
#: the solve's 32-row blocks (2 x 33²), a batch wider than the SM count
#: (133 x 40²), and four inputs whose twins spread NaN (an inf entry; an
#: entry past Dekker's split; right-hand sides past it; a masked multiplier
#: past f32's range)
DF_SHAPES = (
    (1, 1, "random", True, False), (1, 2, "random", True, False),
    (1, 2, "random", False, False), (1, 512, "random", True, True),
    (1, 176, "random", True, True), (1, 176, "random", False, True),
    (512, 208, "random", False, True), (512, 208, "random", True, False),
    (2, 16, "zero pivot", True, False), (2, 16, "zero pivot", False, False),
    (3, 24, "ties", True, False), (3, 24, "ties", False, False),
    (1, 7, "random", True, False), (1, 9, "random", False, False),
    (3, 19, "random", True, False), (2, 33, "random", False, False),
    (133, 40, "random", True, False), (2, 35, "inf", True, False),
    (2, 37, "huge", True, False), (2, 36, "huge rhs", True, False),
    (2, 40, "masked", False, False),
    # phase 3j's SDP batches through "auto", with K_lo
    (64, 58, "random", True, True), (2048, 58, "random", True, True),
)


def df_phase1(seed, device, sm_hz):
    return [check_df_lu(B, N, kind, seed + B + N, device, sm_hz, with_lo, time_it=timed,
                        reps=3 if B > 1 else 10)
            for B, N, kind, with_lo, timed in DF_SHAPES]


#: phase 3m's grid-form shapes: (B, N, kind, with K_lo, timed).  The
#: grid forms' first order (513), 1024 alone and as a batch of 8 and the
#: entropy problem's 2540 with K_lo and without, the p-norm's 1300 as its
#: solve has it (no K_lo: phase 3m's solves have no PSD cone); the four
#: inputs whose twins spread NaN, as phase 1 has them: an inf and an entry
#: past Dekker's split (an entry ends non-finite: the first cross-launch
#: flag), a masked multiplier past f32's range (the second flag, which the
#: panel launch clears), each sending the factor to its exact branch on one
#: block, and right-hand sides past the split (the solve's exact branch)
DF_GRID_SHAPES = (
    (1, 513, "random", True, True), (1, 513, "random", False, True),
    (1, 1024, "random", True, True), (1, 1024, "random", False, True),
    (8, 1024, "random", True, True), (8, 1024, "random", False, True),
    (1, 1300, "random", False, True),
    (1, 2540, "random", True, True), (1, 2540, "random", False, True),
    (1, 600, "inf", True, False), (1, 530, "huge", True, False),
    (1, 520, "masked", False, False), (1, 577, "huge rhs", False, False),
)
#: phase 3m's solves on the double-float route: phase 3i's labels
DF_GRID_SOLVES = ("entropy n=500", "p-norm p=1.5 300x100")


def df_grid_phase(seed, device, sm_hz, report):
    """Phase 3m: the grid forms of the double-float LU against their twins,
    then phase 3i's entropy and p-norm f32 solves with the gate raised past
    their orders (the double-float route), beside phase 3i's solves of them
    on the Jacobi route (the default gate)."""
    from clarabel_tpu_torch.kkt import dense as kkt_dense

    rows = [check_df_lu(B, N, kind, seed + B + N, device, sm_hz, with_lo, time_it=timed,
                        reps=3)
            for B, N, kind, with_lo, timed in DF_GRID_SHAPES]
    problems = {label: (make, method) for label, make, method, _, _ in F32_PROBLEMS}
    f64 = {"entropy n=500": report["nonsym"]["entropy"]["obj_lu"],
           "p-norm p=1.5 300x100": report["nonsym"]["pnorm"]["obj_lu"]}
    solves = {}
    default = kkt_dense.DF_LU_MAX_DIM
    kkt_dense.DF_LU_MAX_DIM = 4096
    try:
        for label in DF_GRID_SOLVES:
            make, method = problems[label]
            jacobi = report["f32_dense"][f"{label} {method}"]
            # the double-float route must solve what the Jacobi route solves;
            # where that misses Solved, it may end as the Jacobi route did
            if jacobi["solved"] < jacobi["B"]:
                F32_REFERENCE_STATUS[f"{label} df {method}"] = (
                    ("Solved", jacobi["status"]), None)
            row = f32_solve(f"{label} df", make(seed), method, f64[label], "df")
            row["jacobi"] = {k: jacobi[k] for k in ("status", "iterations_max",
                                                    "ms_per_iteration", "counts")}
            log(f"  {label}: double-float route {row['status']} in {row['iterations_max']} "
                f"iterations, {row['ms_per_iteration']:.2f} ms/iteration, "
                f"{row['counts']['df_factor']} df_ldl.factor launches; Jacobi route "
                f"{jacobi['status']} in {jacobi['iterations_max']} iterations, "
                f"{jacobi['ms_per_iteration']:.2f} ms/iteration, "
                f"{jacobi['counts']['df_factor']} df_ldl.factor launches")
            solves[label] = row
    finally:
        kkt_dense.DF_LU_MAX_DIM = default
    return dict(kernels=rows, solves=solves)


# -----------------------------------------------------------------
# phases 2-3: the solver
# -----------------------------------------------------------------


def entropy_max(n, p, q, seed):
    """Entropy maximization (Boyd & Vandenberghe §7.2; CVXPY's entropy
    maximization example): max −Σ xᵢ log xᵢ s.t. Fx = g (p rows), Gx ≤ h
    (q rows), the data drawn around a point x₀ of the simplex.  Over
    (t, x), minimize −Σ tᵢ with one ExponentialConeT per i on (tᵢ, xᵢ, 1):
    2n variables, 3n + p + q rows."""
    from clarabel_tpu_torch import ExponentialConeT, NonnegativeConeT, ZeroConeT

    rng = np.random.default_rng(seed)
    x0 = rng.uniform(size=n)
    x0 /= x0.sum()
    F, G = rng.normal(size=(p, n)), rng.normal(size=(q, n))
    g, h = F @ x0, G @ x0 + rng.uniform(size=q)
    A_exp = np.zeros((3 * n, 2 * n))
    A_exp[0::3, :n] = -np.eye(n)
    A_exp[1::3, n:] = -np.eye(n)
    A = np.vstack([A_exp, np.hstack([np.zeros((p, n)), F]), np.hstack([np.zeros((q, n)), G])])
    b = np.concatenate([np.tile([0.0, 0.0, 1.0], n), g, h])
    cones = [ExponentialConeT()] * n + [ZeroConeT(p), NonnegativeConeT(q)]
    return np.zeros((2 * n, 2 * n)), np.concatenate([-np.ones(n), np.zeros(n)]), A, b, cones


#: how many iterations apart the JAX package's own BatchSolver puts phase
#: 3d's B = 512 entropy lanes (at --seed 0) between its LU and LDLᵀ
#: backends: lanes by |Δ| 0-6 = 175, 229, 75, 26, 4, 2, 1; a lane alone and
#: in the batch up to 3 apart (scripts/entropy_lane_spread.py, on the CPU)
ENTROPY_ITERATIONS_APART = 6
#: the same for phase 3e's B = 2048 SDP lanes (at --seed 0): LU against
#: LDLᵀ, lanes by |Δ| 0-4 = 2039, 7, 1, 0, 1; a lane alone and in the batch
#: up to 3 apart (scripts/entropy_lane_spread.py --problem sdp, on the CPU)
SDP_ITERATIONS_APART = 4


def entropy_batch(B, n, p, q, seed):
    """B entropy problems of one shape, one draw of (F, g, G, h) per lane."""
    lanes = [entropy_max(n, p, q, seed + i) for i in range(B)]
    stack = lambda j: np.stack([lane[j] for lane in lanes])
    return stack(0), stack(1), stack(2), stack(3), lanes[0][4]


def pnorm_regression(rows, n, p, seed):
    """p-norm regression: minimize Σᵢ |Fx − g|ᵢ^p over x, with one
    PowerConeT(1/p) per residual on (tᵢ, 1, rᵢ), rᵢ = (Fx − g)ᵢ, so
    tᵢ ≥ |rᵢ|^p: n + rows variables, 3 rows per residual."""
    from clarabel_tpu_torch import PowerConeT

    rng = np.random.default_rng(seed)
    F = rng.normal(size=(rows, n))
    g = F @ rng.normal(size=n) + rng.standard_t(3, size=rows)
    A = np.zeros((3 * rows, n + rows))
    A[0::3, n:] = -np.eye(rows)
    A[2::3, :n] = -F
    b = np.zeros(3 * rows)
    b[1::3] = 1.0
    b[2::3] = -g
    q = np.concatenate([np.zeros(n), np.ones(rows)])
    return np.zeros((n + rows, n + rows)), q, A, b, [PowerConeT(1.0 / p)] * rows


def geomean_allocation(k, d, budgets, seed):
    """Allocation over k geometric means: maximize Σⱼ tⱼ with tⱼ ≤
    Πᵢ x_{ji}^{αᵢ} (one GenPowerConeT(α, 1) on (x_{j1..jd}, tⱼ) per j, α
    drawn once) under ``budgets`` random price rows Gx ≤ 1: k·d + k
    variables, k(d + 1) + budgets rows."""
    from clarabel_tpu_torch import GenPowerConeT, NonnegativeConeT

    rng = np.random.default_rng(seed)
    alpha = rng.uniform(0.5, 1.5, d)
    alpha /= alpha.sum()
    n = k * d + k
    A = np.zeros((k * (d + 1), n))
    for j in range(k):
        A[j * (d + 1):(j + 1) * (d + 1), list(range(j * d, (j + 1) * d)) + [k * d + j]] = \
            -np.eye(d + 1)
    G = np.hstack([rng.uniform(0.5, 2.0, (budgets, k * d)), np.zeros((budgets, k))])
    q = np.concatenate([np.zeros(k * d), -np.ones(k)])
    cones = [GenPowerConeT(list(alpha), 1)] * k + [NonnegativeConeT(budgets)]
    return (np.zeros((n, n)), q, np.vstack([A, G]),
            np.concatenate([np.zeros(k * (d + 1)), np.ones(budgets)]), cones)


def solve(problem, method, device):
    import clarabel_tpu_torch as tt

    P, q, A, b, cones = problem
    settings = tt.DefaultSettings(verbose=False, direct_solve_method=method)
    solver = tt.DefaultSolver(P, q, A, b, cones, settings, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = solver.solve()
    seconds = time.perf_counter() - t0
    assert np.all(np.isfinite(sol.x)) and sol.x.shape == (q.shape[0],)
    return solver, sol, seconds


def compare_methods(label, problem, device, variant="blocked"):
    """Solve through "pallas" and "auto"; both Solved, the objectives within
    1e-7 relative, the iteration counts within 1, and the "pallas" solve
    through ``variant`` at least once per iteration."""
    from clarabel_tpu_torch.kkt import pallas_ldl as pl

    from clarabel_tpu_torch.timers import host_read

    before = dict(pl.ldl_factor.launches)
    host_read.count = 0
    solver, sol, secs = solve(problem, "pallas", device)
    reads = host_read.count
    blocked = pl.ldl_factor.launches[variant] - before[variant]
    host_read.count = 0
    _, sol_lu, secs_lu = solve(problem, "auto", device)
    reads_lu = host_read.count
    N = solver.info.linear_solver.dim
    for name, s, t, r in (("pallas", sol, secs, reads), ("auto", sol_lu, secs_lu, reads_lu)):
        log(f"  {label} N={N} {name}: {s.status.name}, {s.iterations} iterations, "
            f"obj {s.obj_val:.12e}, {t * 1e3:.1f} ms, {t * 1e3 / max(s.iterations, 1):.2f} ms/iter, "
            f"{r} device reads ({r / max(s.iterations, 1):.1f} per iteration)")
    assert sol.status.name == "Solved" and sol_lu.status.name == "Solved"
    assert abs(sol.obj_val - sol_lu.obj_val) <= 1e-7 * max(1.0, abs(sol_lu.obj_val))
    assert abs(sol.iterations - sol_lu.iterations) <= 1
    assert blocked >= sol.iterations, f"{label}: {blocked} {variant} factors in {sol.iterations} iterations"
    return dict(N=N, iterations=sol.iterations, iterations_lu=sol_lu.iterations,
                obj=sol.obj_val, obj_lu=sol_lu.obj_val, ms=secs * 1e3, ms_lu=secs_lu * 1e3,
                blocked_factors=blocked, variant=variant, factors=blocked,
                reads=reads, reads_lu=reads_lu)


def batched_entry(variant, B, n, m, device, settings):
    """Factor and solve a batch through make_ldl_factor, as the JAX
    package's bench drives its kernels (bench.py:283-291)."""
    from clarabel_tpu_torch.kkt import pallas_ldl as pl

    K = kkt_batch(B, n, m, torch.float64, 11, device)
    rhs = torch.ones((B, n + m), dtype=K.dtype, device=device)
    (kind, (packed, N)), ok = pl.make_ldl_factor(n, m, settings, variant=variant)(K)
    solve = pl.ldl_solve_lower if kind == "pldl_lower" else pl.ldl_solve
    x = solve(packed, N, rhs)
    resid = float((torch.einsum("bij,bj->bi", K, x) - rhs).abs().max())
    assert bool(ok.all()) and resid <= 1e-9, f"batched {variant}: residual {resid:.3e}"


# -----------------------------------------------------------------
# phase 3b: batches
# -----------------------------------------------------------------

#: label -> (the batch made from the seed, the LDLᵀ variant "pallas" runs on it)
BATCHES = {
    "box QP B=512": (lambda seed: box_qp_batch(512, 32, seed), "unrolled"),
    "box QP B=2048": (lambda seed: box_qp_batch(2048, 32, seed + 1), "unrolled"),
    "SOCP B=1024": (lambda seed: socp_batch(1024, 32, seed + 2), "unrolled"),
    "portfolio QP n=100 B=64": (lambda seed: portfolio_qp_batch(64, 100, 10, seed + 3), "unrolled"),
    "portfolio QP n=1000 B=4": (lambda seed: portfolio_qp_batch(4, 1000, 50, seed + 4), "blocked"),
}


def batch_solve(problem, method, syncs=None):
    """One BatchSolver solve on the card; (solver, solution, wall seconds,
    the LDLᵀ launches it made by variant), the counts set to 0 just before
    it.  With ``syncs`` (a dict) the solve runs under a :class:`SyncCounter`
    and ``syncs["count"]`` gets its device waits."""
    import clarabel_tpu_torch as tt
    from clarabel_tpu_torch.kkt import pallas_ldl as pl

    P, q, A, b, cones = problem
    settings = tt.DefaultSettings(verbose=False, direct_solve_method=method)
    solver = tt.BatchSolver(P, q, A, b, cones, settings, device="cuda")
    torch.cuda.synchronize()
    for v in pl.ldl_factor.launches:
        pl.ldl_factor.launches[v] = 0
    with SyncCounter() if syncs is not None else contextlib.nullcontext() as counter:
        t0 = time.perf_counter()
        sol = solver.solve()
        seconds = time.perf_counter() - t0
    if syncs is not None:
        syncs["count"] = counter.count
    launches = dict(pl.ldl_factor.launches)
    assert np.all(np.isfinite(sol.x)) and sol.x.shape == q.shape
    return solver, sol, seconds, launches


def check_batch(label, problem, variant, iterations_apart=1, count_syncs=False):
    """Solve a batch through "pallas" and "auto"; every lane Solved, the
    backends within 1e-7 relative in objective and ``iterations_apart`` in
    each lane's iterations, lanes 0, B/2, the slowest and B - 1 equal to
    DefaultSolver's solve of the lane alone (same status, iterations within
    ``iterations_apart``, objective within 1e-8 relative, the first history
    row within 1e-10 relative), and one launch of ``variant`` per iteration
    of the batch.

    ``iterations_apart`` is 1 where rounding does not move the count; on a
    problem class whose end game amplifies rounding it is the JAX package's
    own spread on the same lanes (ENTROPY_ITERATIONS_APART).  A lane alone
    and in the batch start one rounding apart: a matrix-vector product of
    one lane and of a batch sum in different orders (printed below).
    ``count_syncs`` also counts each batch solve's device waits
    (:class:`SyncCounter`)."""
    import clarabel_tpu_torch as tt

    P, q, A, b, cones = problem
    B, n = q.shape
    N = n + b.shape[1]
    runs = {}
    for method in ("pallas", "auto"):
        syncs = {} if count_syncs else None
        solver, sol, secs, launches = batch_solve(problem, method, syncs)
        its = sol.iterations
        statuses = sol.statuses()
        runs[method] = dict(sol=sol, history=solver.iteration_history(), wall_ms=secs * 1e3,
                            solves_per_s=B / secs,
                            ms_per_iteration=secs * 1e3 / max(int(its.max()), 1),
                            iterations_sum=int(its.sum()), iterations_max=int(its.max()),
                            iterations_min=int(its.min()), launches=launches,
                            syncs=None if syncs is None else syncs["count"])
        log(f"  {label} N={N} {method}: {sum(s.name == 'Solved' for s in statuses)}/{B} Solved, "
            f"iterations {its.min()}-{its.max()} (sum {its.sum()}), wall {secs * 1e3:.1f} ms, "
            f"{B / secs:.1f} solves/s, {secs * 1e3 / max(int(its.max()), 1):.2f} ms/iteration, "
            f"LDLᵀ launches {launches}"
            + ("" if syncs is None else f", device waits {syncs['count']} "
               f"({syncs['count'] / max(int(its.max()), 1):.1f}/iteration)"))
        assert all(s == tt.SolverStatus.Solved for s in statuses), f"{label} {method}: {statuses}"
    lu, ldl = runs["auto"]["sol"], runs["pallas"]["sol"]
    KEPT[label] = ldl
    rel = np.abs(ldl.obj_val - lu.obj_val) / np.maximum(1.0, np.abs(lu.obj_val))
    assert rel.max() <= 1e-7, f"{label}: objectives differ by {rel.max():.3e} relative"
    spread = np.bincount(np.abs(ldl.iterations - lu.iterations)).tolist()
    log(f"  {label}: lanes by |pallas - auto| iterations (0, 1, 2, ...): {spread}; "
        f"objectives within {rel.max():.2e} relative")
    assert len(spread) - 1 <= iterations_apart, \
        f"{label}: iterations {len(spread) - 1} apart, allowed {iterations_apart}"
    pallas_launches = runs["pallas"]["launches"]
    max_it = runs["pallas"]["iterations_max"]
    # one factor for the start and one per iteration of the batch, B at once
    assert max_it <= pallas_launches[variant] <= max_it + 2, \
        f"{label}: {pallas_launches[variant]} {variant} launches for {max_it} iterations"
    assert sum(pallas_launches.values()) == pallas_launches[variant]
    assert sum(runs["auto"]["launches"].values()) == 0

    lanes = sorted({0, B // 2, int(np.argmax(ldl.iterations)), B - 1})
    alone, apart = {}, {}
    for method, run in runs.items():
        sol = run["sol"]
        alone[method], apart[method] = [], []
        for i in lanes:
            settings = tt.DefaultSettings(verbose=False, direct_solve_method=method)
            solver = tt.DefaultSolver(P[i], q[i], A[i], b[i], cones, settings, device="cuda")
            one = solver.solve()
            alone[method].append((one.iterations, int(sol.iterations[i])))
            rows = min(one.iterations, int(sol.iterations[i])) + 1
            h1, hb = solver.iteration_history[:rows], run["history"][i, :rows]
            row_rel = np.max(np.abs(h1 - hb) / np.maximum(1.0, np.abs(hb)), axis=1)
            # the first row where the two paths are more than rounding apart
            apart[method].append(int(np.argmax(row_rel > 1e-6)) if np.any(row_rel > 1e-6) else None)
            assert one.status == sol.statuses()[i], f"{label} lane {i} {method}: {one.status.name}"
            assert row_rel[0] <= 1e-10, f"{label} lane {i} {method}: first rows {row_rel[0]:.2e} apart"
            assert abs(one.iterations - int(sol.iterations[i])) <= iterations_apart, \
                f"{label} lane {i} {method}: {one.iterations} vs {sol.iterations[i]} iterations"
            assert abs(one.obj_val - sol.obj_val[i]) <= 1e-8 * max(1.0, abs(one.obj_val)), \
                f"{label} lane {i} {method}: objective {one.obj_val!r} vs {sol.obj_val[i]!r}"
    # a lane's matrix-vector product alone and in the batch, on the card
    i = lanes[-1]
    At = torch.as_tensor(A, device="cuda")
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(B, n)), device="cuda")
    product_equal = bool(torch.equal(At[i] @ x[i], (At @ x.unsqueeze(-1))[i, :, 0]))
    log(f"  {label}: lanes {lanes} equal DefaultSolver's solves of them alone, both backends; "
        f"(alone, in the batch) iterations {alone}; first history row more than 1e-6 apart "
        f"{apart}; a lane's A·x alone and in the batch bitwise equal: {product_equal}")
    report = dict(B=B, N=N, variant=variant, iterations_apart=iterations_apart,
                  lanes_resolved=lanes, lanes_alone=alone, lanes_alone_rows_apart=apart,
                  lane_product_bitwise_equal=product_equal,
                  lanes_by_iteration_difference=spread, **{
                      method: {k: v for k, v in run.items() if k not in ("sol", "history")}
                      for method, run in runs.items()})
    return report, lu.obj_val


def sequential_yardstick(problem, lanes, methods=("pallas", "auto"), keep=None):
    """Solves per second of DefaultSolver looped over lanes of a batch on
    the card (setup included), per backend: the first ``lanes`` lanes, or
    the lanes of the list ``lanes``.  ``keep`` (a dict) gets each method's
    solutions."""
    import clarabel_tpu_torch as tt

    P, q, A, b, cones = problem
    lanes = list(range(lanes)) if isinstance(lanes, int) else list(lanes)
    out = {}
    for method in methods:
        settings = tt.DefaultSettings(verbose=False, direct_solve_method=method)
        torch.cuda.synchronize()
        sols = []
        t0 = time.perf_counter()
        for i in lanes:
            sols.append(tt.DefaultSolver(P[i], q[i], A[i], b[i], cones, settings,
                                         device="cuda").solve())
        secs = time.perf_counter() - t0
        if keep is None:
            assert all(sol.status == tt.SolverStatus.Solved for sol in sols)
        else:
            keep[method] = sols
        out[method] = dict(lanes=len(lanes), wall_ms=secs * 1e3, solves_per_s=len(lanes) / secs)
        log(f"  DefaultSolver over {len(lanes)} lanes, {method}: {secs * 1e3:.1f} ms, "
            f"{len(lanes) / secs:.1f} solves/s")
    return out


# -----------------------------------------------------------------
# phase 3c: the Schur-complement paths
# -----------------------------------------------------------------

#: phase 3b's batches that phase 3c solves again at f32 through "auto"
F32_BATCHES = {"box QP B=512": "schur_diag", "box QP B=2048": "schur_diag",
               "SOCP B=1024": "schur_lr"}


def counted_solve(make_solver):
    """Build a solver, then solve on the card with the LDLᵀ launch counts
    and the Cholesky call count set to 0 just before: (solver, solution,
    wall seconds, Cholesky calls, LDLᵀ launches)."""
    from clarabel_tpu_torch.kkt import dense as kkt_dense, pallas_ldl as pl

    solver = make_solver()
    torch.cuda.synchronize()
    for v in pl.ldl_factor.launches:
        pl.ldl_factor.launches[v] = 0
    kkt_dense.cholesky.calls = 0
    t0 = time.perf_counter()
    sol = solver.solve()
    seconds = time.perf_counter() - t0
    return solver, sol, seconds, kkt_dense.cholesky.calls, sum(pl.ldl_factor.launches.values())


def schur_single(label, problem, method, dtype, obj_ref, rel, gate=True):
    """One DefaultSolver solve through ``method`` at ``dtype`` ("auto" at f32,
    with the f32 preset), Solved with its objective within ``rel`` of
    ``obj_ref`` (the f64 LU solve's) -- unless ``gate`` is False, when it is
    only printed.  No LDLᵀ launch, and the Cholesky factor on every
    iteration."""
    import clarabel_tpu_torch as tt

    P, q, A, b, cones = problem
    settings = (tt.DefaultSettings.for_float32(verbose=False) if dtype == "float32"
                else tt.DefaultSettings(verbose=False, direct_solve_method=method))
    solver, sol, secs, chol, ldl = counted_solve(lambda: tt.DefaultSolver(
        P, q, A, b, cones, settings, dtype=dtype, device="cuda"))
    name = solver.info.linear_solver.name
    err = abs(sol.obj_val - obj_ref) / max(1.0, abs(obj_ref))
    log(f"  {label} {dtype} {name}: {sol.status.name}, {sol.iterations} iterations, "
        f"obj {sol.obj_val:.12e} (LU f64 {obj_ref:.12e}, rel {err:.2e}), {secs * 1e3:.1f} ms, "
        f"{chol} Cholesky factorizations" + ("" if gate else " (printed, not gated)"))
    if gate:
        assert np.all(np.isfinite(sol.x)) and sol.x.shape == (q.shape[0],)
        assert name == method, f"{label}: {name} ran, not {method}"
        assert sol.status == tt.SolverStatus.Solved, f"{label} {method} {dtype}: {sol.status.name}"
        assert err <= rel, f"{label} {method} {dtype}: objective {err:.3e} relative from LU's"
        assert ldl == 0 and chol >= sol.iterations
    return dict(method=name, dtype=dtype, status=sol.status.name, iterations=sol.iterations,
                obj=sol.obj_val, obj_lu_f64=obj_ref, rel_err=err, ms=secs * 1e3,
                cholesky_calls=chol, gated=gate)


def schur_batch(label, problem, method, f64_obj, f64_run):
    """One f32 BatchSolver solve through "auto": every lane Solved, within
    1e-3 relative of the f64 batch's objective on the same data."""
    import clarabel_tpu_torch as tt

    P, q, A, b, cones = problem
    B = q.shape[0]
    settings = tt.DefaultSettings.for_float32(verbose=False)
    _, sol, secs, chol, ldl = counted_solve(lambda: tt.BatchSolver(
        P, q, A, b, cones, settings, dtype="float32", device="cuda"))
    KEPT[f"{label} f32"] = sol
    its = sol.iterations
    solved = sum(s == tt.SolverStatus.Solved for s in sol.statuses())
    rel = np.abs(sol.obj_val - f64_obj) / np.maximum(1.0, np.abs(f64_obj))
    # the start's factorization and one per iteration of the slowest lane
    per_iteration = chol / (int(its.max()) + 1)
    row = dict(B=B, method=method, solved=solved, iterations_min=int(its.min()),
               iterations_max=int(its.max()), iterations_sum=int(its.sum()),
               wall_ms=secs * 1e3, solves_per_s=B / secs,
               ms_per_iteration=secs * 1e3 / max(int(its.max()), 1),
               cholesky_calls=chol, cholesky_per_iteration=per_iteration,
               max_rel_obj_vs_f64=float(rel.max()),
               f64_auto=dict((k, f64_run[k]) for k in
                             ("wall_ms", "solves_per_s", "ms_per_iteration", "iterations_max")))
    log(f"  {label} f32 {method}: {solved}/{B} Solved, iterations {its.min()}-{its.max()} "
        f"(sum {its.sum()}), wall {secs * 1e3:.1f} ms, {B / secs:.1f} solves/s, "
        f"{row['ms_per_iteration']:.2f} ms/iteration (f64 \"auto\" in phase 3b: "
        f"{f64_run['solves_per_s']:.1f} solves/s, {f64_run['ms_per_iteration']:.2f} ms/iteration), "
        f"{chol} Cholesky calls = {per_iteration:.2f} per iteration, "
        f"objective vs f64 max rel {rel.max():.2e}")
    assert solved == B, f"{label} f32: {solved}/{B} Solved"
    assert rel.max() <= 1e-3, f"{label} f32: objective {rel.max():.3e} relative from f64"
    assert ldl == 0
    return row


def repeat_solves(problem, method, times=2):
    """Solve ``problem`` ``times`` times on the card at f64 through
    ``method``; the objectives and x must be equal bit for bit."""
    import clarabel_tpu_torch as tt

    P, q, A, b, cones = problem
    settings = tt.DefaultSettings(verbose=False, direct_solve_method=method)
    sols = [tt.DefaultSolver(P, q, A, b, cones, settings, device="cuda").solve()
            for _ in range(times)]
    same = all(s.obj_val == sols[0].obj_val and np.array_equal(s.x, sols[0].x) for s in sols)
    log(f"  SOCP {method} x{times}: objectives {[s.obj_val for s in sols]}, "
        f"bitwise equal: {same}")
    assert same, f"SOCP {method}: repeated solves differ"
    return dict(method=method, objectives=[s.obj_val for s in sols], bitwise_equal=same)


def time_segment_sums(problem, B, reps=100):
    """The SOC segment sum of cones.ops (a padded gather and a sum over its
    last dimension) against ``index_add_``, on [B, m_soc] f64 data of the
    problem's cone layout: (ms, index_add_ ms)."""
    from clarabel_tpu_torch.cones import api, ops
    from clarabel_tpu_torch.cones.layout import ConeLayout

    layout = ConeLayout(api.collapse_cones(problem[4]))
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(B, layout.m_soc)),
                        dtype=torch.float64, device="cuda")
    seg = layout.index_tensors("cuda")["soc_seg"]
    zeros = torch.zeros((B, layout.num_soc), dtype=x.dtype, device=x.device)
    padded = cuda_ms(lambda: ops._soc_sum(layout, x), reps)
    index_add = cuda_ms(lambda: zeros.clone().index_add_(-1, seg, x), reps)
    err = float((ops._soc_sum(layout, x) - zeros.clone().index_add_(-1, seg, x)).abs().max())
    log(f"  segment sum B={B} SOCs {layout.soc_dims[:3]}{'...' if layout.num_soc > 3 else ''}: "
        f"padded {padded * 1e3:.1f} us, index_add_ {index_add * 1e3:.1f} us, max|Δ| {err:.1e}")
    return dict(B=B, m_soc=layout.m_soc, num_soc=layout.num_soc, padded_ms=padded,
                index_add_ms=index_add, max_abs_diff=err)


def schur_phase(seed, report, f64_objectives):
    """Phase 3c.  f64: the n = 1000 portfolio QP through "schur_diag",
    "schur_lr" and "schur", the n = 500 SOCP through "schur_lr" and "schur",
    each within 1e-7 relative of the LU solve of phases 2-3 ("schur" on
    these zero-cone layouts only printed: the JAX package's tests do not
    hold it to Solved there).  f32 "auto": the same two problems (through
    "schur_diag" and "schur_lr") within 1e-3 of LU, and phase 3b's box-QP
    and SOCP batches, every lane within 1e-3 of its f64 solve.  Then the
    SOCP twice through "pallas" and twice through "schur_lr" at f64, bit
    for bit equal, and the segment sums against index_add_."""
    qp = portfolio_qp(1000, 50, seed)
    socp = portfolio_socp(500, 50, seed + 1)
    qp_lu, socp_lu = report["qp"]["obj_lu"], report["socp"]["obj_lu"]
    out = {"single": []}
    for method in ("schur_diag", "schur_lr", "schur"):
        out["single"].append(dict(problem="QP", **schur_single(
            "QP", qp, method, "float64", qp_lu, 1e-7, gate=method != "schur")))
    for method in ("schur_lr", "schur"):
        out["single"].append(dict(problem="SOCP", **schur_single(
            "SOCP", socp, method, "float64", socp_lu, 1e-7, gate=method != "schur")))
    out["single"].append(dict(problem="QP", **schur_single(
        "QP", qp, "schur_diag", "float32", qp_lu, 1e-3)))
    out["single"].append(dict(problem="SOCP", **schur_single(
        "SOCP", socp, "schur_lr", "float32", socp_lu, 1e-3)))
    out["batches"] = {}
    for label, method in F32_BATCHES.items():
        problem = BATCHES[label][0](seed)
        out["batches"][label] = schur_batch(label, problem, method, f64_objectives[label],
                                            report["batches"][label]["auto"])
    out["repeat"] = [repeat_solves(socp, method) for method in ("pallas", "schur_lr")]
    out["segment_sums"] = [time_segment_sums(socp, 1),
                           time_segment_sums(BATCHES["SOCP B=1024"][0](seed), 1024)]
    return out


# -----------------------------------------------------------------
# phase 3d: the nonsymmetric cones, warm starts, data updates, callbacks
# -----------------------------------------------------------------


def resolve_cold_and_warm(label, problem, update):
    """Solve through "pallas", apply ``update`` (a 1 % change of q or b),
    then re-solve cold and warm-started from the first solution: both
    Solved, the objectives within 1e-6 relative; iterations printed."""
    import clarabel_tpu_torch as tt

    P, q, A, b, cones = problem
    settings = tt.DefaultSettings(verbose=False, direct_solve_method="pallas")
    solver = tt.DefaultSolver(P, q, A, b, cones, settings, device="cuda")
    first = solver.solve()
    update(solver, q, b)
    out = {}
    for kind in ("cold", "warm"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = solver.solve(warm_start=first if kind == "warm" else None)
        out[kind] = dict(status=sol.status.name, iterations=sol.iterations, obj=sol.obj_val,
                         ms=(time.perf_counter() - t0) * 1e3)
        assert sol.status == tt.SolverStatus.Solved, f"{label} {kind}: {sol.status.name}"
    rel = abs(out["warm"]["obj"] - out["cold"]["obj"]) / max(1.0, abs(out["cold"]["obj"]))
    log(f"  {label} after a 1 % update: cold {out['cold']['iterations']} iterations "
        f"({out['cold']['ms']:.1f} ms), warm {out['warm']['iterations']} iterations "
        f"({out['warm']['ms']:.1f} ms), objectives {out['cold']['obj']:.12e} / "
        f"{out['warm']['obj']:.12e} (rel {rel:.2e})")
    assert rel <= 1e-6, f"{label}: warm and cold objectives differ by {rel:.3e}"
    return dict(first_iterations=first.iterations, rel_obj=rel, **out)


def nonsym_phase(seed):
    """Phase 3d; returns (report, the LDLᵀ launches of its runs by variant)."""
    import clarabel_tpu_torch as tt
    from clarabel_tpu_torch.kkt import pallas_ldl as pl

    for v in pl.ldl_factor.launches:
        pl.ldl_factor.launches[v] = 0
    out = {}
    entropy = entropy_max(500, 20, 20, seed + 20)
    out["entropy"] = compare_methods("entropy n=500", entropy, "cuda")
    out["pnorm"] = compare_methods("p-norm p=1.5 300x100", pnorm_regression(300, 100, 1.5, seed + 21),
                                   "cuda")
    geomean = geomean_allocation(16, 4, 16, seed + 22)
    out["genpow"] = compare_methods("geometric means k=16", geomean, "cuda", variant="unrolled")
    layout = tt.DefaultSolver(*geomean, tt.DefaultSettings(verbose=False), device="cuda")._layout
    assert not layout.allows_primal_dual_scaling  # dual scaling: the barrier backtracking runs
    out["batch"], obj_lu = check_batch("entropy B=512", entropy_batch(512, 40, 4, 4, seed + 23),
                                       "unrolled", iterations_apart=ENTROPY_ITERATIONS_APART)
    out["batch"]["obj_lu_lanes"] = obj_lu.tolist()

    qp = portfolio_qp(1000, 50, seed)
    out["resolve_qp"] = resolve_cold_and_warm(
        "portfolio QP n=1000", qp, lambda s, q, b: s.update_q(q * 1.01))
    n_ent = 500

    def bump_b(s, q, b):
        b2 = b.copy()
        b2[3 * n_ent:] *= 1.01
        s.update_b(b2)

    out["resolve_entropy"] = resolve_cold_and_warm("entropy n=500", entropy, bump_b)

    solver = tt.DefaultSolver(*entropy, tt.DefaultSettings(verbose=False, direct_solve_method="pallas"),
                              device="cuda")
    solver.set_termination_callback(lambda info: info.iterations >= 3)
    sol = solver.solve()
    log(f"  entropy n=500 with a callback that stops at iteration 3: {sol.status.name}, "
        f"{sol.iterations} iterations")
    assert sol.status == tt.SolverStatus.CallbackTerminated and sol.iterations == 3
    out["callback"] = dict(status=sol.status.name, iterations=sol.iterations)
    torch.cuda.synchronize()
    launches = dict(pl.ldl_factor.launches)
    log(f"  LDLᵀ launches in phase 3d: {launches}")
    return out, launches


# -----------------------------------------------------------------
# phase 3e: PSD cones and chordal decomposition
# -----------------------------------------------------------------


class SyncCounter:
    """Counts the operations that make the host wait for the device, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them, inside a
    ``with`` block; the reads through ``timers.host_read`` are among them."""

    def __enter__(self):
        self._caught = warnings.catch_warnings(record=True)
        self._records = self._caught.__enter__()
        warnings.simplefilter("always")
        self._mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(self._mode)
        self.count = sum("synchroniz" in str(w.message) for w in self._records)
        self._caught.__exit__(*exc)
        return False


def psd_solve(label, problem, method, **settings):
    """One DefaultSolver solve on the card, built first; (solver, solution,
    report) with the wall time, the LDLᵀ launches by variant, the device
    reads through ``host_read`` and every device wait the sync debug mode
    sees, each counted from 0 just before the solve."""
    import clarabel_tpu_torch as tt
    from clarabel_tpu_torch.kkt import pallas_ldl as pl
    from clarabel_tpu_torch.timers import host_read

    P, q, A, b, cones = problem
    solver = tt.DefaultSolver(P, q, A, b, cones, tt.DefaultSettings(
        verbose=False, direct_solve_method=method, **settings), device="cuda")
    torch.cuda.synchronize()
    for v in pl.ldl_factor.launches:
        pl.ldl_factor.launches[v] = 0
    host_read.count = 0
    with SyncCounter() as syncs:
        t0 = time.perf_counter()
        sol = solver.solve()
        seconds = time.perf_counter() - t0
    assert np.all(np.isfinite(sol.x)) and sol.x.shape == (q.shape[0],)
    its = max(sol.iterations, 1)
    info = solver.info.linear_solver
    row = dict(method=method, kkt=info.name, N=info.dim, status=sol.status.name,
               iterations=sol.iterations, obj=sol.obj_val, ms=seconds * 1e3,
               ms_per_iteration=seconds * 1e3 / its, launches=dict(pl.ldl_factor.launches),
               reads=host_read.count, syncs=syncs.count)
    log(f"  {label} {method} ({info.name}, N={info.dim}): {sol.status.name}, "
        f"{sol.iterations} iterations, obj {sol.obj_val:.12e}, {seconds * 1e3:.1f} ms "
        f"({row['ms_per_iteration']:.2f} ms/iteration), LDLᵀ launches {row['launches']}, "
        f"device reads {host_read.count} ({host_read.count / its:.1f}/iteration), device waits "
        f"{syncs.count} ({syncs.count / its:.1f}/iteration)")
    return solver, sol, row


def min_eig_ratio(z_svec):
    """min eigenvalue / largest |eigenvalue| of the symmetric matrix whose
    svec is ``z_svec``."""
    d = int((np.sqrt(8 * len(z_svec) + 1) - 1) / 2)
    Z = np.zeros((d, d))
    k = 0
    for j in range(d):
        for i in range(j + 1):
            Z[i, j] = Z[j, i] = z_svec[k] if i == j else z_svec[k] / np.sqrt(2.0)
            k += 1
    e = np.linalg.eigvalsh(Z)
    return float(e.min() / np.abs(e).max())


def psd_phase(seed):
    """Phase 3e; returns (report, the LDLᵀ launches of its "pallas" runs by
    problem)."""
    import clarabel_tpu_torch as tt
    from clarabel_tpu_torch.cones import api

    out = {}
    # max-cut, primal: one dense PSD(100) block, N = 10200, K1
    maxcut = maxcut_primal(100, 248, seed + 30)
    runs = {m: psd_solve("max-cut n=100", maxcut, m) for m in ("pallas", "auto")}
    (_, ldl, r_ldl), (_, lu, r_lu) = runs["pallas"], runs["auto"]
    assert ldl.status == lu.status == tt.SolverStatus.Solved
    assert abs(ldl.obj_val - lu.obj_val) <= 1e-7 * max(1.0, abs(lu.obj_val))
    assert abs(ldl.iterations - lu.iterations) <= 1
    assert r_ldl["launches"]["blocked"] >= ldl.iterations and r_lu["kkt"] == "lu"
    out["maxcut"] = {"pallas": r_ldl, "auto": r_lu}

    # max-cut, dual: PSD(124) of a sparse graph, decomposed into cliques
    dual = maxcut_dual(124, 3, seed + 31)
    _, plain, r_plain = psd_solve("chordal max-cut n=124, not decomposed", dual, "lu",
                                  chordal_decomposition_enable=False)
    assert plain.status == tt.SolverStatus.Solved
    out["chordal"] = {"undecomposed_lu": r_plain}
    decomposed = {}
    for method in ("pallas", "lu"):
        solver, sol, row = psd_solve("chordal max-cut n=124", dual, method)
        decomposed[method] = sol
        assert solver._chordal is not None and sol.status == tt.SolverStatus.Solved
        rel = abs(sol.obj_val - plain.obj_val) / max(1.0, abs(plain.obj_val))
        ratio = min_eig_ratio(sol.z)
        cones = [c for c in solver._layout.cones if c.kind == api.PSD]
        row.update(rel_obj_vs_undecomposed=rel, completed_dual_min_eig_ratio=ratio,
                   psd_cones=len(cones), buckets=len(solver._layout.psd_buckets),
                   largest=max(c.dim for c in cones))
        log(f"    {len(cones)} PSD cones in {row['buckets']} buckets, the largest "
            f"{row['largest']}x{row['largest']}; objective {rel:.2e} from the undecomposed "
            f"solve; completed dual: min eigenvalue {ratio:.2e} of the largest")
        assert rel <= 1e-7, f"chordal {method}: objective {rel:.3e} from the undecomposed solve"
        assert ratio >= -1e-7, f"chordal {method}: completed dual min eigenvalue {ratio:.3e}"
        out["chordal"][method] = row
    # "auto": dense or the multifrontal engine, as the card's cost model
    # routes it
    solver, sol, row = psd_solve("chordal max-cut n=124", dual, "auto")
    assert sol.status == tt.SolverStatus.Solved
    assert abs(sol.obj_val - plain.obj_val) <= 1e-7 * max(1.0, abs(plain.obj_val))
    row["cost_model"] = solver.info.linear_solver.cost_model
    log(f"    auto took {row['kkt']}; cost model {row['cost_model']}")
    out["chordal"]["auto"] = row
    # a warm re-solve through the clique transform after a 1 % change of q
    P, q, A, b, cones = dual
    changed = (P, q * 1.01, A, b, cones)
    _, cold, r_cold = psd_solve("chordal max-cut, q + 1 %, cold", changed, "pallas")
    solver = tt.DefaultSolver(*changed, tt.DefaultSettings(verbose=False,
                                                           direct_solve_method="pallas"),
                              device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = solver.solve(warm_start=decomposed["pallas"])
    warm_ms = (time.perf_counter() - t0) * 1e3
    log(f"  chordal max-cut, q + 1 %, warm from the first solve: {warm.status.name}, "
        f"{warm.iterations} iterations ({warm_ms:.1f} ms), obj {warm.obj_val:.12e}; "
        f"cold {cold.iterations}")
    assert cold.status == tt.SolverStatus.Solved
    out["chordal"]["resolve"] = dict(cold=r_cold, warm=dict(
        status=warm.status.name, iterations=warm.iterations, obj=warm.obj_val, ms=warm_ms))

    # the bench's batched SDP, K2 at N = 58
    out["batches"] = {}
    for label, B in (("SDP B=64", 64), ("SDP B=2048", 2048)):
        out["batches"][label], obj = check_batch(label, sdp_batch(B, 16, 4, seed + 32 + B),
                                                 "unrolled", SDP_ITERATIONS_APART,
                                                 count_syncs=True)
        batch = out["batches"][label]
        batch["obj_lu_lanes"] = obj.tolist()
        log(f"  {label}: {batch['pallas']['solves_per_s']:.1f} solves/s through \"pallas\", "
            f"{batch['auto']['solves_per_s']:.1f} through \"auto\"")
    return out


# -----------------------------------------------------------------
# phase 3f: the sparse multifrontal KKT path
# -----------------------------------------------------------------


def banded_qp(n, seed):
    """The JAX bench's sparse QP (bench.py:307-342): P banded at offsets 0,
    ±1 and ±7, box constraints A = [I; -I], b = 1; KKT N = 3n."""
    import scipy.sparse as sp
    from clarabel_tpu_torch import NonnegativeConeT

    rng = np.random.default_rng(seed)
    diags = [2.0 * np.ones(n), -0.5 * np.ones(n - 1), -0.5 * np.ones(n - 1),
             0.1 * np.ones(n - 7)]
    Pm = sp.diags(diags, [0, 1, -1, 7], format="csc")
    P = ((Pm + Pm.T) * 0.5).tocsc()
    A = sp.vstack([sp.eye(n), -sp.eye(n)], format="csc")
    return P, rng.standard_normal(n), A, np.ones(2 * n), [NonnegativeConeT(2 * n)]


def banded_sdp(n_mat=250):
    """The JAX bench's auto-routed banded SDP (bench.py:420-463): one
    PSDTriangleConeT(n_mat) on a banded matrix variable (2·n_mat − 1
    variables, tri(n_mat) rows), which chordal decomposition splits into
    2 x 2 cliques."""
    import scipy.sparse as sp
    from clarabel_tpu_torch import PSDTriangleConeT

    tri = n_mat * (n_mat + 1) // 2
    pattern = [(i, i) for i in range(n_mat)] + [(i, i + 1) for i in range(n_mat - 1)]
    rows = np.array([j * (j + 1) // 2 + i for (i, j) in pattern])
    nvar = len(pattern)
    A = sp.csc_matrix((-np.ones(nvar), (rows, np.arange(nvar))), shape=(tri, nvar))
    q = np.array([-1.0 if i == j else 0.2 for (i, j) in pattern])
    return sp.eye(nvar, format="csc"), q, A, np.zeros(tri), [PSDTriangleConeT(n_mat)]


def kkt_residuals(problem, sol):
    """Host-side (scipy) relative KKT residuals of a returned (x, s, z) on a
    problem with nonnegative cones only: primal ‖Ax + s − b‖∞, stationarity
    ‖Px + q + Aᵀz‖∞, each over 1 + the largest of its terms, and
    complementarity |sᵀz| over 1 + |objective|; and the least s and z."""
    P, q, A, b, _ = problem
    x, s, z = sol.x, sol.s, sol.z
    Ax, Px, Atz = A @ x, P @ x, A.T @ z
    nrm = lambda *v: max(float(np.max(np.abs(u), initial=0.0)) for u in v)
    return dict(
        primal=nrm(Ax + s - b) / (1.0 + nrm(Ax, s, b)),
        stationarity=nrm(Px + q + Atz) / (1.0 + nrm(Px, q, Atz)),
        complementarity=abs(float(s @ z)) / (1.0 + abs(sol.obj_val)),
        min_s=float(s.min()), min_z=float(z.min()))


def time_multifrontal(solver, reps=5):
    """One factorization (assembly included) and one 1- and one 2-RHS solve
    of the solver's multifrontal engine, timed with CUDA events on its data
    at the identity scaling, and the unblocked kernel's launches in one
    factorization."""
    from clarabel_tpu_torch import loop
    from clarabel_tpu_torch.cones import ops as cone_ops
    from clarabel_tpu_torch.kkt import pallas_ldl as pl, sparse as kkt_sparse

    layout, dtype = solver._layout, solver._torch_dtype
    P, A = solver._P.predia(), solver._A.predia()
    state = cone_ops.set_identity_scaling(layout, dtype, P.data.device)
    ctx = (solver._skkt, solver._skkt_data)

    def prepare():
        return loop._kkt_prepare(layout, solver.settings, dtype, solver._n_int, False, P, A,
                                 state, sparse_kkt=ctx)

    before = pl.ldl_unblocked.launches
    factors, _, ok = prepare()
    torch.cuda.synchronize()
    per_factor = pl.ldl_unblocked.launches - before
    assert bool(ok)
    factor_ms = cuda_ms(prepare, reps)
    pl.ldl_unblocked.launches = before
    N = solver._skkt.N
    gen = torch.Generator(device="cpu").manual_seed(0)
    rhs = torch.randn((N, 2), generator=gen, dtype=dtype).to(P.data.device)
    ctx_, data, mff = factors[1]
    solve_ms = cuda_ms(lambda: kkt_sparse.solve(ctx_, data, mff, rhs[:, 0]), reps)
    solve2_ms = cuda_ms(lambda: kkt_sparse.solve(ctx_, data, mff, rhs), reps)
    return dict(factor_ms=factor_ms, solve_ms=solve_ms, solve_2rhs_ms=solve2_ms,
                launches_per_factor=per_factor)


def sparse_settings(dtype, **settings):
    """The settings of a sparse-path solve at ``dtype``: the f32 preset at
    f32."""
    import clarabel_tpu_torch as tt

    make = tt.DefaultSettings.for_float32 if dtype == "float32" else tt.DefaultSettings
    return make(verbose=False, **settings)


def sparse_solve(label, problem, method, dtype="float64", **settings):
    """One DefaultSolver solve on the card at ``dtype``, as
    :func:`psd_solve`, with the multifrontal engine's plan, setup, cost
    model and the unblocked kernel's launches, the refined solves' sweeps
    and the double-float LU's factors (each counted from 0 just before the
    solve) when the solve takes that engine."""
    import clarabel_tpu_torch as tt
    from clarabel_tpu_torch.kkt import dense as kkt_dense, df_ldl, pallas_ldl as pl
    from clarabel_tpu_torch.timers import host_read

    P, q, A, b, cones = problem
    t0 = time.perf_counter()
    solver = tt.DefaultSolver(P, q, A, b, cones, sparse_settings(
        dtype, direct_solve_method=method, **settings), dtype=dtype, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    pl.ldl_unblocked.launches = 0
    df_ldl.factor.launches = 0
    kkt_dense.solve_refined.sweeps = 0
    host_read.count = 0
    with SyncCounter() as syncs:
        t0 = time.perf_counter()
        sol = solver.solve()
        seconds = time.perf_counter() - t0
    launches = pl.ldl_unblocked.launches
    assert np.all(np.isfinite(sol.x)) and sol.x.shape == (q.shape[0],)
    its = max(sol.iterations, 1)
    info = solver.info.linear_solver
    row = dict(method=method, dtype=dtype, kkt=info.name, N=info.dim, status=sol.status.name,
               iterations=sol.iterations, obj=sol.obj_val, setup_s=setup_s, ms=seconds * 1e3,
               ms_per_iteration=seconds * 1e3 / its, reads=host_read.count, syncs=syncs.count,
               unblocked_launches=launches, df_factor_launches=df_ldl.factor.launches,
               sweeps_per_iteration=kkt_dense.solve_refined.sweeps / its,
               cost_model=info.cost_model)
    log(f"  {label} {method} {dtype} ({info.name}, N={info.dim}): {sol.status.name}, "
        f"{sol.iterations} iterations, obj {sol.obj_val:.12e}, setup {setup_s:.2f} s, solve "
        f"{seconds * 1e3:.1f} ms ({row['ms_per_iteration']:.2f} ms/iteration), device reads "
        f"{host_read.count / its:.1f}/iteration, waits {syncs.count / its:.1f}/iteration, "
        f"refinement sweeps {row['sweeps_per_iteration']:.2f}/iteration")
    if info.cost_model is not None:
        log(f"    cost model: {info.cost_model}")
    if solver._sparse:
        plan = solver._skkt.plan
        assert launches > 0, f"{label}: the multifrontal solve launched no unblocked kernel"
        buckets = sum(len(lvl) for lvl in plan.levels)
        # the cost model's per-iteration predictions for this plan, which
        # "auto" compares only below the dense fallback's size
        cm = info.cost_model
        row.update(levels=len(plan.levels), buckets=buckets, nnzL=plan.nnzL, flops=plan.flops,
                   symbolic_s=solver._symbolic_seconds,
                   widest_block_batch=max(B.k for lvl in plan.levels for B in lvl),
                   predicted_t_mf_s=cm["bucket_s"] * buckets + plan.flops / (cm["mf_gflops"] * 1e9),
                   predicted_t_dense_s=cm["dense_floor_s"]
                   + (info.dim / 4096.0) ** 3 * cm["dense_n4096_s"],
                   **time_multifrontal(solver))
        log(f"    predicted per iteration: multifrontal {row['predicted_t_mf_s'] * 1e3:.2f} ms, "
            f"dense LU {row['predicted_t_dense_s'] * 1e3:.2f} ms")
        log(f"    plan: {row['levels']} levels, {row['buckets']} buckets, nnzL {plan.nnzL}, "
            f"{plan.flops:.3e} flops, symbolic analysis {row['symbolic_s']:.2f} s; factor "
            f"{row['factor_ms']:.2f} ms, solve {row['solve_ms']:.2f} ms (2 RHS "
            f"{row['solve_2rhs_ms']:.2f} ms) by CUDA events; unblocked kernel "
            f"{row['launches_per_factor']} launches per factor, {launches} in the solve")
    return solver, sol, row


def sparse_phase(seed):
    """Phase 3f; returns its report."""
    import clarabel_tpu_torch as tt

    out = {}
    # the bench's banded QP at N = 60000, through "multifrontal" and "auto"
    qp = banded_qp(20000, seed + 40)
    out["qp"] = {}
    for method in ("multifrontal", "auto"):
        solver, sol, row = sparse_solve("banded QP n=20000", qp, method)
        assert solver.info.linear_solver.name == "multifrontal" and row["N"] == 60000
        assert sol.status == tt.SolverStatus.Solved, f"banded QP {method}: {sol.status.name}"
        row["residuals"] = kkt_residuals(qp, sol)
        log(f"    host KKT residuals {row['residuals']}")
        for key in ("primal", "stationarity", "complementarity"):
            assert row["residuals"][key] <= 1e-7, f"banded QP {method}: {key} residual"
        out["qp"][method] = row
    # the same family at n = 2000 (N = 6000): "multifrontal" against "lu";
    # the multifrontal solve repeated on the same solver repeats bit for bit
    small = banded_qp(2000, seed + 41)
    runs = {m: sparse_solve("banded QP n=2000", small, m) for m in ("multifrontal", "lu")}
    (solver, mf, r_mf), (_, lu, r_lu) = runs["multifrontal"], runs["lu"]
    assert mf.status == lu.status == tt.SolverStatus.Solved
    rel = abs(mf.obj_val - lu.obj_val) / max(1.0, abs(lu.obj_val))
    x_first = mf.x.copy()
    again = solver.solve()
    repeats = bool(np.array_equal(again.x, x_first) and again.iterations == mf.iterations)
    log(f"    objectives {rel:.2e} apart; a second multifrontal solve bitwise equal: {repeats}")
    assert rel <= 1e-7, f"banded QP n=2000: multifrontal {rel:.3e} from lu"
    assert repeats, "banded QP n=2000: a repeated multifrontal solve differs"
    out["qp_small"] = {"multifrontal": r_mf, "lu": r_lu, "rel_obj": rel, "repeats": repeats}
    # the bench's banded SDP: "auto" and "multifrontal" against "lu" on the
    # chordally decomposed dense path
    sdp = banded_sdp(250)
    _, ref, r_ref = sparse_solve("banded SDP n=250", sdp, "lu")
    assert ref.status == tt.SolverStatus.Solved
    out["sdp"] = {"lu": r_ref}
    for method in ("auto", "multifrontal"):
        solver, sol, row = sparse_solve("banded SDP n=250", sdp, method)
        assert solver._chordal is not None and sol.status == tt.SolverStatus.Solved
        row["rel_obj_vs_lu"] = abs(sol.obj_val - ref.obj_val) / max(1.0, abs(ref.obj_val))
        log(f"    {method} took {row['kkt']}, objective {row['rel_obj_vs_lu']:.2e} from lu")
        assert row["rel_obj_vs_lu"] <= 1e-7
        out["sdp"][method] = row
    assert out["sdp"]["multifrontal"]["kkt"] == "multifrontal"
    return out


# -----------------------------------------------------------------
# phase 3g: the sparse batch
# -----------------------------------------------------------------


def sparse_qp_batch(B, n, seed):
    """The JAX bench's batched_sparse_qp (bench.py:466-500), at f64: B
    tridiagonal QPs of one pattern, main diagonal 2 + U(0.5, 1.5) and
    off-diagonals U(-0.4, 0.4), box rows A = [I; -I] with b = 1 + U(0, 1);
    KKT N = 3n.  P and A are lists (one matrix per lane)."""
    import scipy.sparse as sp
    from clarabel_tpu_torch import NonnegativeConeT

    rng = np.random.default_rng(seed)
    Ps, qs, bs = [], [], []
    for _ in range(B):
        main = 2.0 + rng.uniform(0.5, 1.5, n)
        off = rng.uniform(-0.4, 0.4, n - 1)
        Ps.append(sp.diags([main, off, off], [0, 1, -1], format="csc"))
        qs.append(rng.standard_normal(n))
        bs.append(np.ones(2 * n) + rng.uniform(0, 1, 2 * n))
    A = sp.vstack([sp.eye(n), -sp.eye(n)], format="csc")
    return Ps, np.stack(qs), [A] * B, np.stack(bs), [NonnegativeConeT(2 * n)]


def nn_soc_batch(B, n, seed, slack=False):
    """The JAX package's test_sparse_batch_socp_lane at scale: P = I,
    A = [I; I], x ≤ 1 (NonnegativeConeT(n)) and ‖x[1:]‖ ≤ r − x[0]
    (SecondOrderConeT(n), expanded to rank 2), q per lane from the seed.
    The test's r = 2 holds the cone active at a far boundary point (‖q‖ ≈
    √n); ``slack`` takes r = 2‖q‖ per lane, where the cone stays inactive
    and only the nonnegative rows bind."""
    import scipy.sparse as sp
    from clarabel_tpu_torch import NonnegativeConeT, SecondOrderConeT

    rng = np.random.default_rng(seed)
    P = sp.eye(n, format="csc")
    A = sp.vstack([sp.eye(n), sp.eye(n)], format="csc")
    q = rng.standard_normal((B, n))
    b = np.tile(np.concatenate([np.ones(n), np.zeros(n)]), (B, 1))
    b[:, n] = 2.0 * np.linalg.norm(q, axis=1) if slack else 2.0
    return [P] * B, q, [A] * B, b, [NonnegativeConeT(n), SecondOrderConeT(n)]


def mixed_status_batch(n):
    """The JAX package's test_sparse_batch_mixed_statuses at N = 3n: an LP
    with x ≤ 1 and −x ≤ 1 (Solved) and the same with x[0] ≥ 2
    (PrimalInfeasible) in one batch."""
    import scipy.sparse as sp
    from clarabel_tpu_torch import NonnegativeConeT

    P = sp.csc_matrix((n, n))
    A = sp.vstack([sp.eye(n), -sp.eye(n)], format="csc")
    b_inf = np.ones(2 * n)
    b_inf[n] = -2.0
    return ([P, P], np.ones((2, n)), [A, A], np.stack([np.ones(2 * n), b_inf]),
            [NonnegativeConeT(2 * n)])


def time_multifrontal_batch(solver, reps=3):
    """:func:`time_multifrontal` for a SparseBatchSolver: one factorization
    of all its lanes and one 1- and 2-RHS solve per lane ([B, N, 1] and
    [B, N, 2]), by CUDA events, with the unblocked kernel's launches in one
    factorization."""
    from clarabel_tpu_torch import loop
    from clarabel_tpu_torch.cones import ops as cone_ops
    from clarabel_tpu_torch.kkt import pallas_ldl as pl, sparse as kkt_sparse

    layout = solver._layout
    P, A = solver._P.predia(), solver._A.predia()
    dtype, device, B = P.data.dtype, P.data.device, solver.B
    state = cone_ops.set_identity_scaling(layout, dtype, device, (B,))
    ctx = (solver._skkt, solver._skkt_data)

    def prepare():
        return loop._kkt_prepare(layout, solver.settings, dtype, solver.n, False, P, A,
                                 state, sparse_kkt=ctx)

    before = pl.ldl_unblocked.launches
    factors, _, ok = prepare()
    torch.cuda.synchronize()
    per_factor = pl.ldl_unblocked.launches - before
    assert bool(ok.all())
    factor_ms = cuda_ms(prepare, reps)
    pl.ldl_unblocked.launches = before
    gen = torch.Generator(device="cpu").manual_seed(0)
    rhs = torch.randn((B, solver._skkt.N, 2), generator=gen, dtype=dtype).to(device)
    ctx_, data, mff = factors[1]
    solve_ms = cuda_ms(lambda: kkt_sparse.solve(ctx_, data, mff, rhs[..., :1]), reps)
    solve2_ms = cuda_ms(lambda: kkt_sparse.solve(ctx_, data, mff, rhs), reps)
    return dict(factor_ms=factor_ms, solve_ms=solve_ms, solve_2rhs_ms=solve2_ms,
                launches_per_factor=per_factor)


def lane_solution(sol, i):
    """Lane ``i`` of a BatchSolution with the fields :func:`kkt_residuals`
    reads."""
    return types.SimpleNamespace(x=sol.x[i], s=sol.s[i], z=sol.z[i],
                                 obj_val=float(sol.obj_val[i]))


def sparse_batch_solve(label, problem, repeat=False, dtype="float64"):
    """One SparseBatchSolver solve on the card at ``dtype``: (solver,
    solution, report row), with the unblocked kernel's launches, the
    refined solves' sweeps and the device reads counted from 0 just before
    the solve, the solve's peak device memory, the plan, each lane's status
    and objective, and one factor and solve timed by CUDA events.
    ``repeat`` solves again and requires the same bits."""
    import clarabel_tpu_torch as tt
    from clarabel_tpu_torch.kkt import dense as kkt_dense, pallas_ldl as pl
    from clarabel_tpu_torch.timers import host_read

    P, q, A, b, cones = problem
    B = q.shape[0]
    t0 = time.perf_counter()
    solver = tt.SparseBatchSolver(P, q, A, b, cones, sparse_settings(
        dtype, direct_solve_method="multifrontal"), dtype=dtype, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    pl.ldl_unblocked.launches = 0
    kkt_dense.solve_refined.sweeps = 0
    host_read.count = 0
    t0 = time.perf_counter()
    sol = solver.solve()
    seconds = time.perf_counter() - t0
    launches, reads = pl.ldl_unblocked.launches, host_read.count
    sweeps = kkt_dense.solve_refined.sweeps
    peak = torch.cuda.max_memory_allocated()
    # every lane's x finite at f64; at f32 a lane short of Solved may end
    # with a non-finite x, as in the JAX package (phase 3k's NN + SOC batch)
    checked = [s == tt.SolverStatus.Solved or dtype == "float64" for s in sol.statuses()]
    assert np.all(np.isfinite(sol.x[checked])) and sol.x.shape == q.shape
    its = sol.iterations
    slowest = max(int(its.max()), 1)
    plan = solver.plan
    widest = max((B_.k, B_.c_pad) for lvl in plan.levels for B_ in lvl)
    statuses = sol.statuses()
    row = dict(B=B, N=solver._skkt.N, dtype=dtype, setup_s=setup_s, ms=seconds * 1e3,
               solves_per_s=B / seconds, ms_per_iteration=seconds * 1e3 / slowest,
               iterations_min=int(its.min()), iterations_max=int(its.max()),
               statuses={s.name: statuses.count(s) for s in set(statuses)},
               lane_statuses=[s.name for s in statuses], lane_obj=sol.obj_val.tolist(),
               reads=reads, reads_per_iteration=reads / slowest,
               sweeps_per_iteration=sweeps / slowest,
               unblocked_launches=launches, peak_memory_bytes=peak,
               levels=len(plan.levels), buckets=sum(len(lvl) for lvl in plan.levels),
               nnzL=plan.nnzL, total_cells=plan.total_cells, W=plan.W,
               widest_block_batch=B * widest[0], widest_block_cols=min(widest[1], 32),
               **time_multifrontal_batch(solver))
    log(f"  {label} B={B} N={row['N']} {dtype}: {row['statuses']}, iterations "
        f"{its.min()}-{its.max()}, setup {setup_s:.2f} s, solve {seconds * 1e3:.1f} ms, "
        f"{row['solves_per_s']:.1f} solves/s, {row['ms_per_iteration']:.2f} ms/iteration "
        f"(slowest lane), device reads {row['reads_per_iteration']:.1f}/iteration, refinement "
        f"sweeps {row['sweeps_per_iteration']:.2f}/iteration, peak memory {peak / 2**20:.0f} MiB")
    log(f"    plan: {row['levels']} levels, {row['buckets']} buckets, nnzL {plan.nnzL}, "
        f"{plan.total_cells} front cells per lane; factor {row['factor_ms']:.2f} ms, solve "
        f"{row['solve_ms']:.2f} ms (2 RHS {row['solve_2rhs_ms']:.2f} ms) by CUDA events; "
        f"unblocked kernel {row['launches_per_factor']} launches per factor (widest "
        f"{row['widest_block_batch']} x {row['widest_block_cols']}²), {launches} in the solve")
    if repeat:
        x_first, its_first = sol.x.copy(), its.copy()
        again = solver.solve()
        row["repeats"] = bool(np.array_equal(again.x, x_first)
                              and np.array_equal(again.iterations, its_first))
        log(f"    a second solve bitwise equal: {row['repeats']}")
        assert row["repeats"], f"{label}: a repeated solve differs"
    return solver, sol, row


def lanes_alone(label, problem, sol, lanes):
    """Lanes ``lanes`` of a batch solve against DefaultSolver's
    "multifrontal" solve of each alone on the card: the same status,
    iterations within 1, objectives within 1e-7 relative, and host KKT
    residuals of the batch's lane at most 1e-7 (Solved lanes).  Also the
    yardstick: DefaultSolver looped over those lanes, solves/s."""
    P, q, A, b, cones = problem
    keep = {}
    yard = sequential_yardstick(problem, lanes, methods=("multifrontal",), keep=keep)
    out = []
    for i, one in zip(lanes, keep["multifrontal"]):
        lane = lane_solution(sol, i)
        status = sol.statuses()[i]
        assert one.status == status, f"{label} lane {i}: {one.status.name} vs {status.name}"
        assert abs(one.iterations - int(sol.iterations[i])) <= 1, \
            f"{label} lane {i}: {one.iterations} vs {sol.iterations[i]} iterations"
        rel = abs(one.obj_val - lane.obj_val) / max(1.0, abs(one.obj_val))
        res = kkt_residuals((P[i], q[i], A[i], b[i], cones), lane)
        assert rel <= 1e-7, f"{label} lane {i}: objectives {rel:.3e} apart"
        for key in ("primal", "stationarity", "complementarity"):
            assert res[key] <= 1e-7, f"{label} lane {i}: {key} residual {res[key]:.3e}"
        out.append(dict(lane=i, iterations_alone=one.iterations,
                        iterations=int(sol.iterations[i]), rel_obj=rel, residuals=res))
    log(f"    lanes {lanes} equal DefaultSolver's multifrontal solves of them alone "
        f"(iterations alone/in the batch {[(r['iterations_alone'], r['iterations']) for r in out]}, "
        f"objectives within {max(r['rel_obj'] for r in out):.1e}, host KKT residuals up to "
        f"{max(max(r['residuals'][k] for k in ('primal', 'stationarity', 'complementarity')) for r in out):.1e})")
    return dict(lanes=out, yardstick=yard["multifrontal"])


def sparse_batch_phase(seed):
    """Phase 3g; returns its report."""
    import clarabel_tpu_torch as tt

    out = {}
    batches = {
        "sparse QP B=32": (sparse_qp_batch(32, 1000, seed + 50), True),
        "sparse QP B=512": (sparse_qp_batch(512, 1000, seed + 51), False),
        "NN+SOC slack B=64": (nn_soc_batch(64, 500, seed + 52, slack=True), False),
    }
    solutions = {}
    for label, (problem, repeat) in batches.items():
        solver, sol, row = sparse_batch_solve(label, problem, repeat=repeat)
        assert all(s == tt.SolverStatus.Solved for s in sol.statuses()), \
            f"{label}: {row['statuses']}"
        B = row["B"]
        lanes = sorted({0, B // 2, int(np.argmax(sol.iterations)), B - 1})
        row.update(lanes_alone(label, problem, sol, lanes))
        out[label] = row
        solutions[label] = (solver, sol)
        KEPT[label] = sol
    # the NN + SOC batch with the cone active (r = 2): the expanded cone's
    # end game loses primal feasibility on a few lanes in the JAX package
    # too (scripts/sparse_batch_soc_statuses.py), which then end
    # AlmostSolved; every lane must end in the Solved tier, and every Solved
    # lane's host KKT residuals stay at most 1e-7
    label = "NN+SOC B=64"
    problem = nn_soc_batch(64, 500, seed + 52)
    _, sol, row = sparse_batch_solve(label, problem)
    tier = (tt.SolverStatus.Solved, tt.SolverStatus.AlmostSolved)
    assert all(s in tier for s in sol.statuses()), f"{label}: {row['statuses']}"
    P, q, A, b, cones = problem
    worst = 0.0
    for i, status in enumerate(sol.statuses()):
        res = kkt_residuals((P[i], q[i], A[i], b[i], cones), lane_solution(sol, i))
        worst_i = max(res[k] for k in ("primal", "stationarity", "complementarity"))
        if status == tt.SolverStatus.Solved:
            assert worst_i <= 1e-7, f"{label} lane {i}: host KKT residual {worst_i:.3e}"
            worst = max(worst, worst_i)
        else:
            row.setdefault("almost_solved", []).append(
                dict(lane=i, iterations=int(sol.iterations[i]), residuals=res))
    log(f"    Solved lanes' host KKT residuals up to {worst:.1e}; AlmostSolved lanes "
        f"{[(r['lane'], r['iterations']) for r in row.get('almost_solved', [])]}")
    out[label] = row
    # mixed statuses: one feasible and one primal-infeasible lane
    _, sol, row = sparse_batch_solve("mixed statuses", mixed_status_batch(1000))
    assert sol.statuses() == [tt.SolverStatus.Solved, tt.SolverStatus.PrimalInfeasible], \
        f"mixed statuses: {sol.statuses()}"
    out["mixed statuses"] = row
    # a re-solve: q and b moved by 1 %, warm from the cold solution
    solver, cold = solutions["sparse QP B=32"]
    _, q, _, b, _ = batches["sparse QP B=32"][0]
    solver.update_values(q=q * 1.01, b=b * 1.01)
    t0 = time.perf_counter()
    warm = solver.solve(warm_start=cold)
    warm_s = time.perf_counter() - t0
    recold = solver.solve()
    assert all(s == tt.SolverStatus.Solved for s in warm.statuses() + recold.statuses())
    rel = np.abs(warm.obj_val - recold.obj_val) / np.maximum(1.0, np.abs(recold.obj_val))
    assert rel.max() <= 1e-6, f"warm re-solve: objectives {rel.max():.3e} from the cold one"
    out["resolve"] = dict(warm_iterations=warm.iterations.tolist(),
                          cold_iterations=recold.iterations.tolist(),
                          warm_ms=warm_s * 1e3, rel_obj=float(rel.max()))
    log(f"  re-solve after a 1 % update of q and b, B=32: warm iterations "
        f"{warm.iterations.min()}-{warm.iterations.max()} (sum {warm.iterations.sum()}), cold "
        f"{recold.iterations.min()}-{recold.iterations.max()} (sum {recold.iterations.sum()}), "
        f"warm {warm_s * 1e3:.1f} ms, objectives within {rel.max():.1e}")
    return out


# -----------------------------------------------------------------
# phase 3h: the host surface
# -----------------------------------------------------------------


@contextlib.contextmanager
def python_symbolic():
    """Inside the block the symbolic analyses run their Python versions, as
    where no compiler exists (the native engine reports no library)."""
    from clarabel_tpu_torch import native

    load = native._load
    native._load = lambda: None
    try:
        yield
    finally:
        native._load = load


def plan_differences(a, b):
    """The fields in which two multifrontal plans differ; none when they
    are equal field for field."""
    diffs = [f for f in ("N", "nnzL", "flops", "n_supernodes", "W", "total_cells")
             if getattr(a, f) != getattr(b, f)]
    if sorted(a.arrays) != sorted(b.arrays):
        diffs.append("arrays")
    else:
        diffs += [k for k in a.arrays if not np.array_equal(a.arrays[k], b.arrays[k])]
    buckets = lambda plan: [[(B, getattr(B, "asm", None)) for B in lvl] for lvl in plan.levels]
    if buckets(a) != buckets(b):
        diffs.append("levels")
    return diffs


def timed_setup(make):
    """(object, wall seconds) of ``make()``, the card synchronized after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    obj = make()
    torch.cuda.synchronize()
    return obj, time.perf_counter() - t0


def same_solution(a, b):
    """Two solutions equal bit for bit: status, iterations, x, z and s."""
    return (a.status == b.status and a.iterations == b.iterations
            and all(np.array_equal(getattr(a, v), getattr(b, v)) for v in ("x", "z", "s")))


class CApi:
    """The port's C ABI (include/clarabel_tpu.h) loaded in this process with
    ctypes; the shim sees the live interpreter and does not embed one."""

    class Cone(ctypes.Structure):
        _fields_ = [("tag", ctypes.c_uint8), ("dim", ctypes.c_int64),
                    ("power", ctypes.c_double), ("alpha", ctypes.POINTER(ctypes.c_double)),
                    ("nalpha", ctypes.c_int64)]

    class Info(ctypes.Structure):
        _fields_ = [("status", ctypes.c_int32), ("iterations", ctypes.c_int32),
                    ("obj_val", ctypes.c_double), ("obj_val_dual", ctypes.c_double),
                    ("solve_time", ctypes.c_double), ("r_prim", ctypes.c_double),
                    ("r_dual", ctypes.c_double)]

    CALLBACK = ctypes.CFUNCTYPE(ctypes.c_int32, ctypes.POINTER(Info), ctypes.c_void_p)

    def __init__(self, path):
        i64p, f64p = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double)
        L = ctypes.CDLL(str(path))
        L.clarabel_new.restype = ctypes.c_void_p
        L.clarabel_new.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p, i64p, f64p, f64p,
                                   i64p, i64p, f64p, f64p, ctypes.POINTER(self.Cone),
                                   ctypes.c_int64, ctypes.c_char_p]
        L.clarabel_solve.restype = ctypes.c_int32
        L.clarabel_solve.argtypes = [ctypes.c_void_p, f64p, f64p, f64p, ctypes.POINTER(self.Info)]
        L.clarabel_update.restype = ctypes.c_int32
        L.clarabel_update.argtypes = [ctypes.c_void_p, ctypes.c_char_p, f64p, ctypes.c_int64]
        L.clarabel_set_termination_callback.restype = ctypes.c_int32
        L.clarabel_set_termination_callback.argtypes = [ctypes.c_void_p, self.CALLBACK,
                                                        ctypes.c_void_p]
        L.clarabel_free.argtypes = [ctypes.c_void_p]
        L.clarabel_last_error.restype = ctypes.c_char_p
        self.lib = L

    @staticmethod
    def _ptr(a, kind):
        return a.ctypes.data_as(ctypes.POINTER(kind))

    def new(self, problem, settings):
        """A handle on a problem of zero and nonnegative cones (numpy P, A)."""
        import scipy.sparse as sp

        P, q, A, b, cones = problem
        Pc, Ac = sp.csc_matrix(np.triu(P)), sp.csc_matrix(A)
        bufs = [np.asarray(v, t) for v, t in (
            (Pc.indptr, np.int64), (Pc.indices, np.int64), (Pc.data, np.float64), (q, np.float64),
            (Ac.indptr, np.int64), (Ac.indices, np.int64), (Ac.data, np.float64),
            (b, np.float64))]
        recs = (self.Cone * len(cones))(*(self.Cone(c.kind, c.dim, 0.0, None, 0) for c in cones))
        kinds = (ctypes.c_int64, ctypes.c_int64, ctypes.c_double, ctypes.c_double,
                 ctypes.c_int64, ctypes.c_int64, ctypes.c_double, ctypes.c_double)
        h = self.lib.clarabel_new(P.shape[0], A.shape[0],
                                  *(self._ptr(a, k) for a, k in zip(bufs, kinds)),
                                  recs, len(cones), json.dumps(settings).encode())
        assert h, f"clarabel_new: {self.lib.clarabel_last_error().decode()}"
        return h

    def solve(self, h, n, m):
        """(status, info, x, wall seconds of the call)."""
        x, z, s = np.zeros(n), np.zeros(m), np.zeros(m)
        info = self.Info()
        f64 = ctypes.c_double
        t0 = time.perf_counter()
        status = self.lib.clarabel_solve(h, self._ptr(x, f64), self._ptr(z, f64),
                                         self._ptr(s, f64), ctypes.byref(info))
        wall = time.perf_counter() - t0
        assert status >= 0, f"clarabel_solve: {self.lib.clarabel_last_error().decode()}"
        return status, info, x, wall


def capi_phase(seed, qp_obj):
    """The C ABI part of phase 3h: returns (report, launches by variant)."""
    import clarabel_tpu_torch as tt
    from clarabel_tpu_torch import capi_support
    from clarabel_tpu_torch.kkt import pallas_ldl as pl

    out = {}
    path, out["build_s"], _ = capi_support.build_library()
    log(f"  C ABI: built {path.name} in {out['build_s']:.1f} s")
    api = CApi(path)
    launches = {}
    qp = portfolio_qp(1000, 50, seed)
    n, m = qp[0].shape[0], qp[2].shape[0]
    # the portfolio QP through "pallas" on the card (the shim's default
    # device), K1 counted from 0 just before and read just after
    h = api.new(qp, {"verbose": False, "direct_solve_method": "pallas"})
    pl.ldl_factor.launches["blocked"] = 0
    status, info, x, wall = api.solve(h, n, m)
    launches["blocked"] = pl.ldl_factor.launches["blocked"]
    rel = abs(info.obj_val - qp_obj) / max(1.0, abs(qp_obj))
    log(f"  C ABI portfolio QP N={n + m} pallas: status {status}, {info.iterations} iterations, "
        f"obj {info.obj_val:.12e} ({rel:.2e} from DefaultSolver's), K1 launches "
        f"{launches['blocked']}, {wall * 1e3:.1f} ms")
    assert status == int(tt.SolverStatus.Solved) and rel <= 1e-9
    assert launches["blocked"] > 0, "the C ABI's solve launched no K1"
    out["qp"] = dict(status=status, iterations=info.iterations, obj=info.obj_val,
                     rel_obj=rel, launches=launches["blocked"], ms=wall * 1e3)
    # the shim's cost per call: the call's wall time less the solve time
    # DefaultSolver.solve measures inside it, over repeated solves
    overheads = []
    for _ in range(5):
        _, info, _, wall = api.solve(h, n, m)
        overheads.append((wall - info.solve_time) * 1e3)
    out["overhead_ms"] = overheads
    log(f"  C ABI overhead per solve call (wall less DefaultSolver.solve's time): "
        f"median {float(np.median(overheads)):.3f} ms of {overheads}")
    # update q and re-solve, against DefaultSolver on the updated data
    q2 = qp[1] * 1.01
    assert api.lib.clarabel_update(h, b"q", CApi._ptr(q2, ctypes.c_double), n) == 0
    status, info, _, _ = api.solve(h, n, m)
    _, ref, _ = solve((qp[0], q2) + qp[2:], "pallas", "cuda")
    rel = abs(info.obj_val - ref.obj_val) / max(1.0, abs(ref.obj_val))
    log(f"  C ABI after a 1 % update of q: status {status}, obj {info.obj_val:.12e} "
        f"({rel:.2e} from DefaultSolver's)")
    assert status == int(tt.SolverStatus.Solved) and rel <= 1e-9
    out["updated_rel_obj"] = rel
    # a termination callback stops the next solve at iteration 3
    seen = []

    @CApi.CALLBACK
    def stop_at_three(info_p, user_data):
        seen.append(info_p.contents.iterations)
        return int(info_p.contents.iterations >= 3)

    assert api.lib.clarabel_set_termination_callback(h, stop_at_three, None) == 0
    status, info, _, _ = api.solve(h, n, m)
    log(f"  C ABI callback: status {status} at iteration {info.iterations}, saw {seen}")
    assert status == int(tt.SolverStatus.CallbackTerminated) and seen[-1] == 3
    api.lib.clarabel_free(h)
    # the small QP through "pallas": K2
    small = portfolio_qp(100, 10, seed + 2)
    h = api.new(small, {"verbose": False, "direct_solve_method": "pallas"})
    pl.ldl_factor.launches["unrolled"] = 0
    status, info, _, _ = api.solve(h, 100, 101)
    launches["unrolled"] = pl.ldl_factor.launches["unrolled"]
    api.lib.clarabel_free(h)
    log(f"  C ABI small QP N=201 pallas: status {status}, {info.iterations} iterations, "
        f"K2 launches {launches['unrolled']}")
    assert status == int(tt.SolverStatus.Solved) and launches["unrolled"] > 0
    out["small_qp"] = dict(status=status, iterations=info.iterations,
                           launches=launches["unrolled"])
    # the standalone C driver: no Python process in the caller; the
    # interpreter's site-packages on PYTHONPATH, the package found through
    # the compiled-in root
    import site

    exe = capi_support.build_driver(path)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(site.getsitepackages()))
    t0 = time.perf_counter()
    proc = subprocess.run([str(exe), "cuda"], capture_output=True, text=True, timeout=300,
                          env=env, cwd=str(exe.parent))
    log(f"  standalone C driver on cuda: exit {proc.returncode} in "
        f"{time.perf_counter() - t0:.1f} s: {proc.stdout.strip()!r}")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "status=1 obj=1.88" in proc.stdout
    out["driver_stdout"] = proc.stdout
    return out, launches


def host_phase(seed, qp_obj):
    """Phase 3h; returns (report, launches by path)."""
    import clarabel_tpu_torch as tt
    from clarabel_tpu_torch.kkt import pallas_ldl as pl

    out, launches = {}, {}
    info = tt.buildinfo()
    log(f"  buildinfo: {info}")
    assert info["native_symbolic"], "the native symbolic engine did not build on this machine"
    assert not any("jax" in key for key in info)
    out["buildinfo"] = info

    # the native symbolic engine against the Python versions: the banded
    # QP family of phase 3f at N = 3000 and 60000 and the sparse batch of
    # phase 3g at B = 32, setup wall time and symbolic seconds through each,
    # after one setup through each to pay their first-call costs
    settings = dict(verbose=False, direct_solve_method="multifrontal")
    warm = banded_qp(100, seed + 40)
    for engine in (contextlib.nullcontext, python_symbolic):
        with engine():
            tt.DefaultSolver(*warm, tt.DefaultSettings(**settings), device="cuda")
    for n in (1000, 20000):
        qp = banded_qp(n, seed + 40)
        make = lambda: tt.DefaultSolver(*qp, tt.DefaultSettings(**settings), device="cuda")
        native_solver, native_s = timed_setup(make)
        with python_symbolic():
            python_solver, python_s = timed_setup(make)
        diffs = plan_differences(native_solver._skkt.plan, python_solver._skkt.plan)
        out[f"setup_n{3 * n}"] = dict(native_s=native_s, python_s=python_s,
                                      native_symbolic_s=native_solver._symbolic_seconds,
                                      python_symbolic_s=python_solver._symbolic_seconds)
        log(f"  banded QP N={3 * n}: setup {native_s:.3f} s native, {python_s:.3f} s Python; "
            f"symbolic {native_solver._symbolic_seconds:.3f} s native, "
            f"{python_solver._symbolic_seconds:.3f} s Python; plans differ in "
            f"{diffs or 'nothing'}")
        assert not diffs, f"native and Python plans differ: {diffs[:5]}"
    # the same plan solves the same way: ms per iteration through each
    # engine's solver, in turns (native, Python, Python, native), every
    # solve bitwise the first
    per_iteration = {"native": [], "python": []}
    solves = []
    for engine, solver in (("native", native_solver), ("python", python_solver),
                           ("python", python_solver), ("native", native_solver)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = solver.solve()
        per_iteration[engine].append((time.perf_counter() - t0) * 1e3 / max(sol.iterations, 1))
        solves.append(sol)
    first = solves[0]
    repeat = all(same_solution(first, sol) for sol in solves[1:])
    out["setup_n60000"]["ms_per_iteration"] = per_iteration
    log(f"  banded QP N=60000 solves in turns: ms/iteration native {per_iteration['native']}, "
        f"Python {per_iteration['python']}; all four bitwise equal: {repeat}")
    assert repeat, "the native and the Python plan solve differently"
    del python_solver
    batch = sparse_qp_batch(32, 1000, seed + 50)
    make_batch = lambda: tt.SparseBatchSolver(*batch, tt.DefaultSettings(verbose=False),
                                              device="cuda")
    native_batch, batch_native_s = timed_setup(make_batch)
    with python_symbolic():
        python_batch, batch_python_s = timed_setup(make_batch)
    diffs = plan_differences(native_batch.plan, python_batch.plan)
    out["setup_sparse_batch_B32"] = dict(native_s=batch_native_s, python_s=batch_python_s)
    log(f"  sparse batch B=32 N=3000: setup {batch_native_s:.3f} s native, "
        f"{batch_python_s:.3f} s Python; plans differ in {diffs or 'nothing'}")
    assert not diffs
    del native_batch, python_batch

    with tempfile.TemporaryDirectory() as tmp:
        # JSON IO at full width: the N = 60000 QP saved from the sparse path
        # (O(nnz)), loaded on the card and solved bit for bit as the
        # original
        path = os.path.join(tmp, "banded_qp.json")
        t0 = time.perf_counter()
        native_solver.save_to_file(path)
        save_s = time.perf_counter() - t0
        with open(path) as f:
            data = json.load(f)
        P_triu_nnz = int(native_solver._P_csc.nnz)
        assert len(data["P"]["nzval"]) == P_triu_nnz and len(data["A"]["nzval"]) == qp[2].nnz
        pl.ldl_unblocked.launches = 0
        loaded, load_s = timed_setup(lambda: tt.DefaultSolver.load_from_file(path))
        second = loaded.solve()
        launches["fori"] = pl.ldl_unblocked.launches
        size = os.path.getsize(path)
        log(f"  banded QP N=60000 JSON: {size / 2**20:.2f} MiB (P {P_triu_nnz} and A "
            f"{qp[2].nnz} entries), saved in {save_s:.2f} s, loaded and set up in "
            f"{load_s:.2f} s; loaded solve {second.status.name}, {second.iterations} "
            f"iterations, bitwise the original's: {same_solution(first, second)}; K3 "
            f"launches {launches['fori']}")
        assert loaded._sparse and second.status == tt.SolverStatus.Solved
        assert same_solution(first, second), "the loaded N = 60000 QP solves differently"
        assert launches["fori"] > 0
        out["json_n60000"] = dict(bytes=size, save_s=save_s, load_s=load_s,
                                  iterations=second.iterations, launches=launches["fori"],
                                  widest_block_batch=max(B.k for lvl in loaded._skkt.plan.levels
                                                         for B in lvl))
        del native_solver, loaded

        # the dense portfolio QP (N = 2001) through "pallas": K1
        pqp = portfolio_qp(1000, 50, seed)
        original, first, _ = solve(pqp, "pallas", "cuda")
        path = os.path.join(tmp, "portfolio_qp.json")
        original.save_to_file(path)
        pl.ldl_factor.launches["blocked"] = 0
        loaded = tt.DefaultSolver.load_from_file(path)
        second = loaded.solve()
        launches["blocked"] = pl.ldl_factor.launches["blocked"]
        log(f"  portfolio QP N=2001 JSON: {os.path.getsize(path) / 2**20:.2f} MiB; loaded "
            f"solve {second.status.name}, {second.iterations} iterations, bitwise the "
            f"original's: {same_solution(first, second)}; K1 launches {launches['blocked']}")
        assert second.status == tt.SolverStatus.Solved and same_solution(first, second)
        assert launches["blocked"] > 0
        out["json_portfolio"] = dict(bytes=os.path.getsize(path), iterations=second.iterations,
                                     launches=launches["blocked"])

        # print targets: a verbose solve under print_to_buffer writes its
        # report there and nothing on stdout
        small = portfolio_qp(100, 10, seed + 2)
        solver = tt.DefaultSolver(*small, tt.DefaultSettings(
            verbose=True, direct_solve_method="pallas"), device="cuda")
        solver.print_to_buffer()
        captured = io.StringIO()
        with contextlib.redirect_stdout(captured):
            solver.solve()
        report = solver.get_print_buffer()
        log(f"  print_to_buffer: {len(report.splitlines())} lines in the buffer, "
            f"{len(captured.getvalue())} characters on stdout")
        assert "Solved" in report and "kkt = pallas" in report and captured.getvalue() == ""

        # profile: a trace of the small QP's "pallas" solve names K2
        solver.print_to_sink()
        trace_dir = os.path.join(tmp, "trace")
        with solver.profile(trace_dir):
            solver.solve()
        traces = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)]
        with open(traces[0]) as f:
            named = "ldl_unblocked_kernel" in f.read()
        log(f"  profile: {len(traces)} trace of {os.path.getsize(traces[0]) / 2**20:.2f} MiB, "
            f"names ldl_unblocked_kernel: {named}")
        assert len(traces) == 1 and named

    capi, capi_launches = capi_phase(seed, qp_obj)
    out["capi"] = capi
    return out, launches, capi_launches


# -----------------------------------------------------------------
# phase 3i: dense f32 (the compensated f32 stack)
# -----------------------------------------------------------------


def f32_counts():
    """The counters phase 3i reads, set to 0: the LDLᵀ and double-float LU
    launches, the refined solves and their sweeps, the device reads."""
    from clarabel_tpu_torch.kkt import dense as kkt_dense, df_ldl, pallas_ldl as pl
    from clarabel_tpu_torch.timers import host_read

    for v in pl.ldl_factor.launches:
        pl.ldl_factor.launches[v] = 0
    df_ldl.factor.launches = df_ldl.solve.launches = 0
    kkt_dense.solve_refined.calls = kkt_dense.solve_refined.sweeps = 0
    host_read.count = 0

    def read():
        return dict(pl.ldl_factor.launches, df_factor=df_ldl.factor.launches,
                    df_solve=df_ldl.solve.launches, refined_solves=kkt_dense.solve_refined.calls,
                    sweeps=kkt_dense.solve_refined.sweeps, reads=host_read.count)

    return read


#: phase 3i's solves that miss Solved in the JAX package too, on the same
#: data at f32 (scripts/f32_reference_status.py and
#: scripts/f32_entropy_lanes.py on the CPU; ROADMAP Queue 3): gated on the
#: JAX package's status -- label -> (the statuses a problem or lane may end
#: with, the JAX package's own statuses of the batch's lanes that it ends
#: short of Solved, or None for a single problem).  The SOCP and the QP have
#: a zero-cone row (the budget) whose KKT diagonal keeps only the 1e-6 static
#: regularization: the SOCP's unpivoted f32 LDLᵀ grows past f32's range at the
#: first scaled iteration, "schur" condenses through H ≈ εI (phase 3c does not
#: gate "schur" on these layouts at f64 either); both packages end
#: NumericalError.  The entropy batch's f32 end game: both packages end ~3 %
#: of its lanes short of Solved, and which lanes is decided by rounding -- the
#: JAX package's lanes move with one f32 ulp on b as far as they part from the
#: port's, and on the card a batch of 512 and four batches of 128 miss
#: different lanes -- so each lane is held to the JAX package's status where
#: that misses too, and otherwise to Solved at another rounding (the lane
#: solved alone); the count to the JAX package's (entropy_counts_agree); every
#: lane to its f64 objective (1e-3).
JAX_ENTROPY_SHORT = {
    27: "AlmostSolved", 37: "InsufficientProgress", 59: "AlmostSolved", 135: "AlmostSolved",
    154: "AlmostSolved", 181: "InsufficientProgress", 189: "AlmostSolved",
    230: "InsufficientProgress", 240: "AlmostSolved", 281: "AlmostSolved", 299: "AlmostSolved",
    321: "InsufficientProgress", 399: "AlmostSolved", 469: "AlmostSolved",
}
F32_REFERENCE_STATUS = {
    "portfolio SOCP n=500 pallas": (("NumericalError",), None),
    "portfolio QP n=1000 schur": (("NumericalError",), None),
    "entropy B=512 auto": (("Solved", "AlmostSolved", "InsufficientProgress"), JAX_ENTROPY_SHORT),
    # phase 3j's chordal max-cut through "pallas" at f32: the unpivoted f32
    # LDLᵀ of a PSD layout's KKT near cond(K) ~ 1/μ² (which is why the JAX
    # package routes f32 PSD layouts to "lu"); its plain twins on the CPU end
    # NumericalError after 8 iterations, and on phase 3j's SDP batch at
    # B = 2048 "pallas" leaves lanes at each of these statuses.  The JAX package's own status is not
    # recorded: its kernel runs in interpret mode on the CPU, out of reach at
    # N = 2181.  A Solved run is held to the objective gate
    "chordal max-cut n=124 pallas": (("Solved", "AlmostSolved", "InsufficientProgress",
                                      "NumericalError", "MaxIterations"), None),
}


def entropy_counts_agree(port_misses, jax_misses, alpha=0.01):
    """The one-sided exact test of one miss rate shared by two runs over the
    same lanes: given the misses of both, each falls in either run with
    probability 1/2, so the port's count passes while P(Bin(total, 1/2) ≥
    port_misses) ≥ ``alpha``.  Returns (passes, that probability)."""
    total = port_misses + jax_misses
    tail = sum(math.comb(total, k) for k in range(port_misses, total + 1)) / 2.0**total
    return tail >= alpha, tail


def f32_solve(label, problem, method, f64_obj, route, batch=False):
    """Solve ``problem`` on the card at f32 through ``method`` with the f32
    preset, twice: every problem (lane) Solved, the objective within 1e-3
    relative of ``f64_obj`` (the same problem's f64 solve on the card) --
    or the JAX package's own status where F32_REFERENCE_STATUS names one --,
    the second solve bit for bit the first, and the KKT route ``route``
    ("df" the double-float LU once per iteration, "jacobi" no df launch,
    "blocked"/"unrolled" that LDLᵀ kernel, "plain" neither)."""
    import clarabel_tpu_torch as tt

    P, q, A, b, cones = problem
    settings = tt.DefaultSettings.for_float32(verbose=False, direct_solve_method=method)
    cls = tt.BatchSolver if batch else tt.DefaultSolver
    make = lambda: cls(P, q, A, b, cones, settings, dtype="float32", device="cuda")
    runs = []
    for _ in range(2):
        solver = make()
        torch.cuda.synchronize()
        read = f32_counts()
        t0 = time.perf_counter()
        sol = solver.solve()
        secs = time.perf_counter() - t0
        runs.append((sol, secs, read()))
    (sol, secs, counts), (again, secs2, _) = runs
    statuses = sol.statuses() if batch else [sol.status]
    its = np.atleast_1d(sol.iterations)
    obj = np.atleast_1d(sol.obj_val)
    rel = np.abs(obj - np.atleast_1d(f64_obj)) / np.maximum(1.0, np.abs(np.atleast_1d(f64_obj)))
    B = len(statuses)
    name = solver.info.linear_solver.name if not batch else method
    row = dict(label=label, method=method, route=route, B=B, N=q.shape[-1] + b.shape[-1],
               solved=sum(s == tt.SolverStatus.Solved for s in statuses),
               iterations_min=int(its.min()), iterations_max=int(its.max()),
               wall_ms=secs * 1e3, wall_ms_repeat=secs2 * 1e3,
               ms_per_iteration=secs * 1e3 / max(int(its.max()), 1),
               solves_per_s=B / secs if batch else None,
               sweeps_per_solve=counts["sweeps"] / max(counts["refined_solves"], 1),
               reads_per_iteration=counts["reads"] / max(int(its.max()), 1),
               max_rel_obj_vs_f64=float(rel.max()), counts=counts, linear_solver=name)
    same = (np.array_equal(np.atleast_1d(again.obj_val), obj, equal_nan=True)
            and np.array_equal(again.x, sol.x, equal_nan=True)
            and np.array_equal(again.iterations, sol.iterations))
    row["repeat_bitwise_equal"] = bool(same)
    log(f"  {label} f32 {method} ({route}): {row['solved']}/{B} Solved, iterations "
        f"{its.min()}-{its.max()}, {row['ms_per_iteration']:.2f} ms/iteration "
        f"(wall {secs * 1e3:.1f} ms, repeat {secs2 * 1e3:.1f})"
        + (f", {row['solves_per_s']:.1f} solves/s" if batch else "")
        + f", {row['sweeps_per_solve']:.2f} sweeps per refined solve, "
        f"{row['reads_per_iteration']:.1f} reads/iteration, objective vs f64 max rel "
        f"{rel.max():.2e}, repeat bitwise equal {same}, launches {counts}")
    allowed, jax_short = F32_REFERENCE_STATUS.get(f"{label} {method}", (("Solved",), None))
    row["allowed_statuses"] = allowed
    names = [s.name for s in statuses]
    row["status"] = None if batch else names[0]
    off = {i: n for i, n in enumerate(names) if n != "Solved"}
    if off:
        log(f"    lanes not Solved: {off}")
    assert all(n in allowed for n in names), f"{label} f32 {method}: {off}, allowed {allowed}"
    if jax_short is not None:
        agree, tail = entropy_counts_agree(len(off), len(jax_short))
        # a lane that the JAX package solves, solved alone: the same lane at
        # another rounding, through the batch's own entry point at B = 1
        alone = {i: cls(P[[i]], q[[i]], A[[i]], b[[i]], cones, settings, dtype="float32",
                        device="cuda").solve().statuses()[0].name
                 for i in off if i not in jax_short}
        row.update(port_short=off, jax_short=jax_short, shared_rate_p=tail, alone=alone)
        log(f"    {len(off)} lanes short of Solved, the JAX package {len(jax_short)} of the same "
            f"{B}: P(Bin({len(off) + len(jax_short)}, 1/2) >= {len(off)}) = {tail:.3f}; short in "
            f"both {sorted(set(off) & set(jax_short))}; the others alone (B = 1): {alone}")
        assert agree, f"{label} f32 {method}: {len(off)} lanes short of Solved, JAX {len(jax_short)}"
        assert all(n == "Solved" for n in alone.values()), f"{label} f32 {method}: alone {alone}"
    failed = "NumericalError" in allowed  # the JAX package's own failure
    solved = np.array([n == "Solved" for n in names])
    assert rel[solved].max(initial=0.0) <= 1e-3 and (failed or rel.max() <= 1e-3), \
        f"{label} f32 {method}: objective {rel.max():.3e} from f64"
    assert same, f"{label} f32 {method}: a repeated solve differs"
    # a solve that stops early factors fewer times than it has iterations
    max_it = 1 if failed else int(its.max())
    if route == "df":
        assert max_it <= counts["df_factor"] <= max_it + 2, \
            f"{label}: {counts['df_factor']} df factors for {max_it} iterations"
        assert counts["df_solve"] > 0 and counts["blocked"] == counts["unrolled"] == 0
    else:
        assert counts["df_factor"] == counts["df_solve"] == 0, f"{label}: df LU launched"
    if route in ("blocked", "unrolled"):
        assert counts[route] >= max_it, f"{label}: {counts[route]} {route} launches"
    elif route != "df":
        assert counts["blocked"] == counts["unrolled"] == counts["fori"] == 0
    return row


#: phase 3i's f32 problems (also scripts/f32_df_parity.py's): label, the
#: problem from the seed, method, KKT route (as f32_solve reads it), batch
F32_PROBLEMS = (
    ("portfolio QP n=1000", lambda s: portfolio_qp(1000, 50, s), "pallas", "blocked", False),
    ("portfolio SOCP n=500", lambda s: portfolio_socp(500, 50, s + 1), "pallas", "blocked",
     False),
    ("small QP n=100", lambda s: portfolio_qp(100, 10, s + 2), "pallas", "unrolled", False),
    ("box QP B=2048", lambda s: BATCHES["box QP B=2048"][0](s), "pallas", "unrolled", True),
    ("geometric means k=16", lambda s: geomean_allocation(16, 4, 16, s + 22), "auto", "df",
     False),
    ("entropy B=512", lambda s: entropy_batch(512, 40, 4, 4, s + 23), "auto", "df", True),
    ("entropy n=500", lambda s: entropy_max(500, 20, 20, s + 20), "auto", "jacobi", False),
    ("p-norm p=1.5 300x100", lambda s: pnorm_regression(300, 100, 1.5, s + 21), "auto",
     "jacobi", False),
    ("portfolio QP n=1000", lambda s: portfolio_qp(1000, 50, s), "schur", "plain", False),
    ("portfolio QP n=1000", lambda s: portfolio_qp(1000, 50, s), "qdldl", "plain", False),
)


def f32_dense_phase(seed, report, f64_objectives):
    """Phase 3i: dense f32 solves on the card with the f32 preset, each
    against the same problem's f64 solve of an earlier phase."""
    f64 = {"portfolio QP n=1000": report["qp"]["obj_lu"],
           "portfolio SOCP n=500": report["socp"]["obj_lu"],
           "small QP n=100": report["small_qp"]["obj"],
           "box QP B=2048": f64_objectives["box QP B=2048"],
           "geometric means k=16": report["nonsym"]["genpow"]["obj_lu"],
           "entropy B=512": np.asarray(report["nonsym"]["batch"]["obj_lu_lanes"]),
           "entropy n=500": report["nonsym"]["entropy"]["obj_lu"],
           "p-norm p=1.5 300x100": report["nonsym"]["pnorm"]["obj_lu"]}
    return {f"{label} {method}": f32_solve(label, make(seed), method, f64[label], route, batch)
            for label, make, method, route, batch in F32_PROBLEMS}


# -----------------------------------------------------------------
# phase 3j: f32 with PSD cones (the double-float PSD scaling)
# -----------------------------------------------------------------

#: the lanes of phase 3j's SDP batch at B = 64 that the JAX package's f32
#: "pallas" ends short of Solved (scripts/f32_reference_status.py --problem
#: sdp64 --method pallas, on the CPU); its "auto" solves all 64
JAX_SDP64_SHORT = {"pallas": {1: "InsufficientProgress", 9: "AlmostSolved",
                              10: "AlmostSolved", 28: "AlmostSolved", 51: "AlmostSolved",
                              63: "AlmostSolved"},
                   "auto": {}}


def rate_not_above(short, total, ref_short, ref_total, alpha=0.01):
    """The one-sided Fisher exact test that a run's rate of lanes short of
    Solved (``short`` of ``total``) is not above a reference run's on other
    lanes of the same class (``ref_short`` of ``ref_total``): passes while
    P(X ≥ short) ≥ ``alpha`` for X the run's share of all short lanes under
    one shared rate (hypergeometric).  Returns (passes, that probability)."""
    n, k = total + ref_total, short + ref_short
    tail = sum(math.comb(k, i) * math.comb(n - k, total - i)
               for i in range(short, min(k, total) + 1)) / math.comb(n, total)
    return tail >= alpha, tail


def device_operations(fn):
    """The kernels and copies one call of ``fn`` puts on the card, counted
    by torch.profiler."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type.name == "CUDA")


def f32_psd_batch(label, problem, x_star, method, f64_obj, f64_run, max_iter=None):
    """The SDP batch at f32 through ``method`` ("auto" twice, the repeat bit
    for bit the first); each Solved lane's objective within 1e-3 relative of
    its f64 solve (phase 3e) and its x within 1e-3 of x* at B = 64, within
    the distance its own f32 stopping point admits at B = 2048 (P ⪰ λI
    makes ½λ|x - x*|² ≤ f(x) - f(x*) ≲ the duality gap, so |x - x*|₂ ≤
    √(2·gap/λ_min(P)), the gap no less than the preset's tolerance
    tol_gap_abs + tol_gap_rel·|obj|: the f32 tolerances stop some lanes
    1-2e-3 from x*, in the JAX package too, scripts/f32_reference_status.py
    --problem sdp2048 --lanes ...); the lanes short of Solved held as phase
    3i holds the entropy batch's: at B = 64 to the JAX package's own lanes
    ("auto": none; "pallas": the count by the one-sided exact test of
    entropy_counts_agree), at B = 2048 to its B = 64 rate
    (:func:`rate_not_above`), and through "auto" each solved alone (a batch
    of one) must be Solved; the KKT route "df" (the double-float LU, one
    factor per iteration) or "unrolled" (K2 at f32).  Prints ms per
    iteration and solves/s beside phase 3e's f64 figures, device reads and
    waits per iteration (at B = 64 device operations too), and how often
    the centering recovery fired.  ``max_iter`` caps the solve's iterations
    (a lane it stops counts as short of Solved)."""
    import clarabel_tpu_torch as tt
    from clarabel_tpu_torch import loop

    P, q, A, b, cones = problem
    B = q.shape[0]
    settings = tt.DefaultSettings.for_float32(
        verbose=False, direct_solve_method=method,
        **({} if max_iter is None else {"max_iter": max_iter}))
    make = lambda: tt.BatchSolver(P, q, A, b, cones, settings, dtype="float32", device="cuda")
    runs = []
    for _ in range(2 if method == "auto" else 1):
        solver = make()
        torch.cuda.synchronize()
        read = f32_counts()
        loop._centering_recovery.centering_steps = 0
        with SyncCounter() as syncs:
            t0 = time.perf_counter()
            sol = solver.solve()
            secs = time.perf_counter() - t0
        runs.append((sol, secs, read(), syncs.count,
                     int(loop._centering_recovery.centering_steps)))
    (sol, secs, counts, waits, fired), again = runs[0], runs[-1][0]
    secs2 = runs[-1][1]
    # the kernels and copies per iteration do not depend on B: counted at 64
    ops = device_operations(lambda: make().solve()) if B == 64 else None
    names = [s.name for s in sol.statuses()]
    its = sol.iterations
    max_it = int(its.max())
    solved = np.array([n == "Solved" for n in names])
    xerr = np.abs(sol.x - x_star).max(axis=1)
    # the gap the lane stopped at, or the f32 preset's gap tolerance where
    # the rounded objectives meet
    gap = np.maximum(np.abs(sol.obj_val - sol.obj_val_dual),
                     settings.tol_gap_abs + settings.tol_gap_rel * np.abs(sol.obj_val))
    admitted = np.sqrt(2.0 * gap / np.linalg.eigvalsh(P)[:, 0])
    xnorm = np.linalg.norm(sol.x - x_star, axis=1)
    rel = np.abs(sol.obj_val - f64_obj) / np.maximum(1.0, np.abs(f64_obj))
    same = (np.array_equal(again.x, sol.x, equal_nan=True)
            and np.array_equal(again.z, sol.z, equal_nan=True)
            and np.array_equal(again.iterations, sol.iterations))
    row = dict(label=label, method=method, B=B, N=q.shape[1] + b.shape[1],
               solved=int(solved.sum()), iterations_min=int(its.min()), iterations_max=max_it,
               wall_ms=secs * 1e3, wall_ms_repeat=secs2 * 1e3,
               ms_per_iteration=secs * 1e3 / max(max_it, 1), solves_per_s=B / secs,
               reads_per_iteration=counts["reads"] / max(max_it, 1),
               waits_per_iteration=waits / max(max_it, 1),
               device_operations_per_iteration=None if ops is None else ops / max(max_it, 1),
               centering_steps=fired, max_x_err_solved=float(xerr[solved].max(initial=0.0)),
               lanes_x_past_1e3=int((solved & (xerr > 1e-3)).sum()),
               max_x_over_admitted=float((xnorm / admitted)[solved].max(initial=0.0)),
               max_rel_obj_solved=float(rel[solved].max(initial=0.0)),
               repeat_bitwise_equal=bool(same), counts=counts,
               f64_ms_per_iteration=f64_run["ms_per_iteration"],
               f64_solves_per_s=f64_run["solves_per_s"])
    off = {i: n for i, n in enumerate(names) if n != "Solved"}
    worst = int(np.argmax(np.where(solved, xerr, -1.0)))
    slowest = np.argsort(its)[-3:][::-1].tolist()
    row.update(worst_x_lane=worst, slowest_lanes={i: int(its[i]) for i in slowest},
               iterations_histogram=np.bincount(its).tolist())
    log(f"  {label} f32 {method}: {row['solved']}/{B} Solved, iterations {its.min()}-{max_it}, "
        f"{row['ms_per_iteration']:.2f} ms/iteration, {row['solves_per_s']:.1f} solves/s "
        f"(f64 {method} in phase 3e: {f64_run['ms_per_iteration']:.2f} ms/iteration, "
        f"{f64_run['solves_per_s']:.1f} solves/s; wall {secs * 1e3:.1f} ms"
        + (f", repeat {secs2 * 1e3:.1f}" if method == "auto" else "")
        + f"), per iteration {row['reads_per_iteration']:.1f} device reads, "
        f"{row['waits_per_iteration']:.1f} waits"
        + ("" if ops is None else f", {row['device_operations_per_iteration']:.0f} device "
           "operations") + f"; centering recovery taken {fired} times; Solved lanes: x within "
        f"{row['max_x_err_solved']:.2e} of x* ({row['lanes_x_past_1e3']} past 1e-3; at most "
        f"{row['max_x_over_admitted']:.2f} of the distance the stopping point admits), "
        f"objective {row['max_rel_obj_solved']:.2e} from f64"
        + (f"; repeat bitwise equal {same}" if method == "auto" else "") + f"; launches {counts}")
    log(f"    the worst Solved lane's x: lane {worst} ({float(xerr[worst]):.2e}, "
        f"{int(its[worst])} iterations); the slowest lanes (lane: iterations) "
        f"{row['slowest_lanes']}")
    if off:
        log(f"    lanes not Solved: {off}")
    assert same, f"{label} f32 {method}: a repeated solve differs"
    if B == 64:
        assert row["max_x_err_solved"] <= 1e-3, \
            f"{label} f32 {method}: x {row['max_x_err_solved']:.2e} from x*"
    assert row["max_x_over_admitted"] <= 1.0, \
        f"{label} f32 {method}: x past the distance its stopping point admits"
    assert row["max_rel_obj_solved"] <= 1e-3, \
        f"{label} f32 {method}: objective {row['max_rel_obj_solved']:.2e} from f64"
    assert all(n in ("Solved", "AlmostSolved", "InsufficientProgress", "NumericalError",
                     "MaxIterations") for n in names), f"{label} f32 {method}: {off}"
    ref = JAX_SDP64_SHORT[method]
    if B == 64:
        if method == "auto":
            assert not off, f"{label} f32 auto: {off}"
        agree, tail = entropy_counts_agree(len(off), len(ref))
    else:
        agree, tail = rate_not_above(len(off), B, len(ref), 64)
    row.update(short=off, jax_b64_short=len(ref), short_rate_p=tail)
    log(f"    {len(off)} of {B} lanes short of Solved, the JAX package {len(ref)} of 64 (B = 64): "
        f"P = {tail:.3f}")
    assert agree, f"{label} f32 {method}: {len(off)} lanes short, P = {tail:.4f}"
    if method == "auto" and off:
        # the lanes short of Solved at another rounding: each as a batch of one
        alone = {i: tt.BatchSolver(P[[i]], q[[i]], A[[i]], b[[i]], cones, settings,
                                   dtype="float32", device="cuda").solve().statuses()[0].name
                 for i in off}
        row["alone"] = alone
        log(f"    alone (B = 1): {alone}")
        assert all(n == "Solved" for n in alone.values()), f"{label} f32 auto: alone {alone}"
    if method == "auto":
        assert max_it <= counts["df_factor"] <= max_it + 2, \
            f"{label}: {counts['df_factor']} df factors for {max_it} iterations"
        assert counts["df_solve"] > 0 and counts["unrolled"] == counts["blocked"] == 0
    else:
        assert counts["unrolled"] >= max_it and counts["df_factor"] == counts["df_solve"] == 0
    return row


def f32_psd_phase(seed, report):
    """Phase 3j: f32 on PSD layouts on the card, against phase 3e's f64
    solves of the same data."""
    import clarabel_tpu_torch as tt

    psd = report["psd"]
    out = {}
    for B in (64, 2048):
        label = f"SDP B={B}"
        problem, x_star = sdp_batch(B, 16, 4, seed + 32 + B, optimum=True)
        f64 = psd["batches"][label]
        for method in ("auto", "pallas"):
            # the B = 2048 batch through "pallas" stops at 60 iterations: 4
            # of its lanes (the unpivoted f32 LDLᵀ's) never converge and held
            # the batch to the default 200, 84 s of this phase, while every
            # other lane ends by iteration 60 (on the H100); the lanes
            # it stops count as short of Solved in the rate test
            cap = 60 if (B, method) == (2048, "pallas") else None
            out[f"{label} {method}"] = f32_psd_batch(
                label, problem, x_star, method, np.asarray(f64["obj_lu_lanes"]), f64[method],
                max_iter=cap)
        if B == 64:
            # one lane through DefaultSolver: the JAX package's test_df_lu.py
            # residual gate
            P, q, A, b, cones = problem
            solver = tt.DefaultSolver(P[0], q[0], A[0], b[0], cones,
                                      tt.DefaultSettings.for_float32(verbose=False),
                                      dtype="float32", device="cuda")
            sol = solver.solve()
            info = solver.info
            out["SDP lane 0 DefaultSolver"] = dict(
                status=sol.status.name, iterations=sol.iterations, res_primal=info.res_primal,
                res_dual=info.res_dual, x_err=float(np.abs(sol.x - x_star[0]).max()))
            log(f"  SDP lane 0 through DefaultSolver at f32: {sol.status.name}, "
                f"{sol.iterations} iterations, res_primal {info.res_primal:.2e}, res_dual "
                f"{info.res_dual:.2e}, x within {out['SDP lane 0 DefaultSolver']['x_err']:.2e} "
                f"of x*")
            assert sol.status == tt.SolverStatus.Solved
            assert info.res_primal < 1e-5 and info.res_dual < 1e-5
    # the chordal max-cut at f32, against phase 3e's f64 solve without the
    # decomposition
    dual = maxcut_dual(124, 3, seed + 31)
    obj64 = psd["chordal"]["undecomposed_lu"]["obj"]
    for method, route in (("lu", "jacobi"), ("pallas", "blocked")):
        out[f"chordal {method}"] = f32_solve("chordal max-cut n=124", dual, method, obj64, route)
    return out


# -----------------------------------------------------------------
# phase 3k: f32 on the sparse path
# -----------------------------------------------------------------


#: the lanes of phase 3k's f32 sparse batches that end short of Solved in
#: the JAX package's own f32 SparseBatchSolver on the same data
#: (scripts/f32_reference_status.py --problem nn_soc_b64, on the CPU): label
#: -> {lane: the JAX package's status}; the sparse QP batches' lanes are not
#: recorded (every lane of the port's ends Solved).  The NN + SOC batch with
#: the cone active is the expanded cone's f32 end game: the JAX package ends
#: 18 of its 64 lanes Solved, 32 AlmostSolved and 14 NumericalError (both
#: packages return a non-finite x on most of the lanes short of Solved), and
#: which lanes is decided by rounding (the port's CPU run ends 19 Solved, on
#: other lanes), so that batch is held to the JAX package's counts.
_NN_SOC_ALMOST = (0, 1, 6, 7, 9, 13, 15, 16, 17, 18, 19, 21, 23, 24, 26, 27, 28, 29, 30, 32,
                  36, 37, 39, 40, 41, 42, 43, 46, 50, 53, 59, 63)
_NN_SOC_FAILED = (2, 4, 11, 12, 20, 25, 31, 34, 38, 44, 48, 49, 58, 62)
SPARSE_F32_JAX_SHORT = {
    "NN+SOC B=64": {**{i: "AlmostSolved" for i in _NN_SOC_ALMOST},
                    **{i: "NumericalError" for i in _NN_SOC_FAILED}},
}


def expanded_soc(d=300):
    """The JAX package's f32 expansion test problem at d = 300
    (test_f32_small_expansion_cones_stay_dense_and_solve's third one, its
    draws in order): min ½‖x‖² + qᵀx with Σx = 1 and x in one
    SecondOrderConeT(d), which f32 keeps on the rank-2 expansion (above
    kkt.sparse.SOC_NO_EXPANSION_MAX_SIZE_F32 = 256)."""
    import scipy.sparse as sp
    from clarabel_tpu_torch import SecondOrderConeT, ZeroConeT

    rng = np.random.default_rng(3)
    rng.standard_normal(40)  # the test's d = 40 problem's q
    q = rng.standard_normal(d)
    A = sp.vstack([sp.csc_matrix(np.ones((1, d))), -sp.eye(d)], format="csc")
    return (sp.eye(d, format="csc"), q, A, np.concatenate([[1.0], np.zeros(d)]),
            [ZeroConeT(1), SecondOrderConeT(d)])


def primal_residual(problem, sol):
    """Host-side ‖Ax + s − b‖∞ over 1 + the largest of its terms."""
    _, _, A, b, _ = problem
    Ax = A @ sol.x
    nrm = lambda *v: max(float(np.max(np.abs(u), initial=0.0)) for u in v)
    return nrm(Ax + sol.s - b) / (1.0 + nrm(Ax, sol.s, b))


def f32_sparse_single(label, problem, method, f64_row, repeat=False):
    """One f32 solve of ``problem`` through ``method`` on the card, gated:
    Solved, the objective within 1e-4 relative of its f64 solve (``f64_row``,
    a :func:`sparse_solve` row of this run), and on the multifrontal engine
    the unblocked kernel launched; ``repeat`` solves again on the same
    solver and requires the same bits."""
    import clarabel_tpu_torch as tt

    solver, sol, row = sparse_solve(label, problem, method, dtype="float32")
    row["rel_obj_vs_f64"] = abs(sol.obj_val - f64_row["obj"]) / max(1.0, abs(f64_row["obj"]))
    row["f64_ms_per_iteration"] = f64_row["ms_per_iteration"]
    log(f"    f32 {row['ms_per_iteration']:.2f} ms/iteration, f64 "
        f"{f64_row['ms_per_iteration']:.2f}; {row['iterations']} iterations against "
        f"{f64_row['iterations']}; objective {row['rel_obj_vs_f64']:.2e} from f64; unblocked "
        f"kernel {row.get('launches_per_factor')} launches per factor, double-float LU "
        f"{row['df_factor_launches']} factors")
    assert sol.status == tt.SolverStatus.Solved, f"{label} f32 {method}: {sol.status.name}"
    assert row["rel_obj_vs_f64"] <= 1e-4, f"{label} f32: objective {row['rel_obj_vs_f64']:.3e}"
    if solver._sparse:
        assert row["unblocked_launches"] > 0 and row["df_factor_launches"] == 0
    if repeat:
        x_first = sol.x.copy()
        again = solver.solve()
        row["repeats"] = bool(np.array_equal(again.x, x_first)
                              and again.iterations == sol.iterations)
        log(f"    a second f32 solve bitwise equal: {row['repeats']}")
        assert row["repeats"], f"{label} f32: a repeated solve differs"
    return solver, sol, row


def f32_sparse_batch(label, problem, f64_row, repeat=False):
    """One f32 SparseBatchSolver solve on the card, gated on the JAX
    package's f32 outcome of the same batch (SPARSE_F32_JAX_SHORT): every
    lane Solved where that package's are; otherwise every lane in a status
    its lanes end in, and the counts of lanes short of Solved and of lanes
    failed (NumericalError) held to its counts by the one-sided exact test
    of :func:`entropy_counts_agree`.  Each lane Solved at both precisions
    within 1e-4 relative of its f64 objective (``f64_row``, phase 3g's); the
    unblocked kernel launched."""
    _, sol, row = sparse_batch_solve(label, problem, repeat=repeat, dtype="float32")
    f64_obj, f64_status = np.asarray(f64_row["lane_obj"]), f64_row["lane_statuses"]
    names = row["lane_statuses"]
    short = {i: n for i, n in enumerate(names) if n != "Solved"}
    jax_short = SPARSE_F32_JAX_SHORT.get(label, {})
    both = np.array([n == "Solved" and f == "Solved" for n, f in zip(names, f64_status)])
    rel = np.abs(sol.obj_val - f64_obj) / np.maximum(1.0, np.abs(f64_obj))
    failed = [i for i, n in short.items() if n == "NumericalError"]
    jax_failed = [i for i, n in jax_short.items() if n == "NumericalError"]
    short_agree, short_p = entropy_counts_agree(len(short), len(jax_short))
    failed_agree, failed_p = entropy_counts_agree(len(failed), len(jax_failed))
    row.update(short=short, jax_short=jax_short, shared_short_p=short_p,
               shared_failed_p=failed_p, max_rel_obj_vs_f64=float(rel[both].max(initial=0.0)),
               f64_ms_per_iteration=f64_row["ms_per_iteration"],
               f64_solves_per_s=f64_row["solves_per_s"])
    log(f"    f32 {row['ms_per_iteration']:.2f} ms/iteration and {row['solves_per_s']:.1f} "
        f"solves/s, f64 {f64_row['ms_per_iteration']:.2f} and {f64_row['solves_per_s']:.1f}; "
        f"{len(short)} lanes short of Solved ({len(failed)} NumericalError), the JAX "
        f"package's f32 {len(jax_short)} ({len(jax_failed)}): P(Bin >= port's) {short_p:.3f} "
        f"and {failed_p:.3f}; short in both {sorted(set(short) & set(jax_short))}, in the "
        f"port only {sorted(set(short) - set(jax_short))}; lanes Solved at both precisions "
        f"within {row['max_rel_obj_vs_f64']:.2e} of f64")
    allowed = {"Solved", *jax_short.values()}
    assert all(n in allowed for n in names), f"{label} f32: {short}, allowed {allowed}"
    assert short_agree and failed_agree, \
        f"{label} f32: {len(short)} short and {len(failed)} failed lanes against the JAX " \
        f"package's {len(jax_short)} and {len(jax_failed)}"
    assert row["max_rel_obj_vs_f64"] <= 1e-4, \
        f"{label} f32: objective {row['max_rel_obj_vs_f64']:.3e} from f64"
    assert row["unblocked_launches"] > 0
    return row


def f32_sparse_phase(seed, report):
    """Phase 3k: f32 on the sparse path on the card, each problem against
    its f64 solve in this run (phases 3f and 3g, and here the expanded SOC)."""
    sparse, batches = report["sparse"], report["sparse_batch"]
    out = {}
    # the JAX bench's sparse_multifrontal: banded QP, N = 60000, repeated
    _, _, out["banded QP"] = f32_sparse_single(
        "banded QP n=20000", banded_qp(20000, seed + 40), "multifrontal",
        sparse["qp"]["multifrontal"], repeat=True)
    assert out["banded QP"]["kkt"] == "multifrontal" and out["banded QP"]["N"] == 60000
    # the JAX bench's sparse_sdp_auto: "auto" decomposes and keeps the
    # multifrontal engine, the f32 PSD Hs values of the cliques in K
    solver, _, out["banded SDP"] = f32_sparse_single(
        "banded SDP n=250", banded_sdp(250), "auto", sparse["sdp"]["auto"])
    assert solver._chordal is not None and out["banded SDP"]["kkt"] == "multifrontal", \
        f"banded SDP f32 auto: took {out['banded SDP']['kkt']}"
    # the JAX bench's batched_sparse_qp at B = 32 (repeated) and 512
    for label, B, extra, repeat in (("sparse QP B=32", 32, 50, True),
                                    ("sparse QP B=512", 512, 51, False)):
        out[label] = f32_sparse_batch(label, sparse_qp_batch(B, 1000, seed + extra),
                                      batches[label], repeat=repeat)
    # phase 3g's NN + SOC batch, the cone active (rank-2 expansion)
    out["NN+SOC B=64"] = f32_sparse_batch("NN+SOC B=64", nn_soc_batch(64, 500, seed + 52),
                                          batches["NN+SOC B=64"])
    # the expanded SOC at d = 300: the segment matvec's .df and the
    # K-consistent Δs recovery on the card; the primal residual at the f32
    # preset's tolerance (no 1e-4 floor of the extension rows)
    soc = expanded_soc(300)
    _, _, f64_row = sparse_solve("expanded SOC d=300", soc, "multifrontal")
    solver, sol, row = f32_sparse_single("expanded SOC d=300", soc, "multifrontal", f64_row)
    row["primal_residual"] = primal_residual(soc, sol)
    tol = solver.settings.tol_feas
    log(f"    soc_expanded {solver._skkt.soc_expanded}, dia offsets "
        f"{len(solver._skkt.dia_offsets)}; host primal residual {row['primal_residual']:.2e} "
        f"(tol_feas {tol:.0e})")
    assert solver._skkt.soc_expanded == (True,) and not solver._skkt.dia_offsets
    assert row["primal_residual"] <= tol, f"expanded SOC f32: primal {row['primal_residual']:.3e}"
    out["expanded SOC"] = dict(row, f64=f64_row)
    return out


# -----------------------------------------------------------------
# phase 3l: multi-device (process groups and device meshes)
# -----------------------------------------------------------------

#: solutions of earlier phases that phase 3l holds its mesh solves to:
#: check_batch's "pallas" runs by label, phase 3c's f32 batches
#: ("<label> f32"), phase 3g's cold sparse batches
KEPT = {}

#: ranks phase 3l starts on the one card (gloo; NCCL refuses two ranks on
#: one GPU), and the seconds each group may take
MESH_WORLDS = (2, 4)
MESH_RANK_TIMEOUT = 300


def tall_sparse_problem(m, seed, n=48):
    """The JAX package's tall sparse box-constrained QP
    (tests/test_sharded.py:88-103) at ``m`` rows: P diagonal, ~3 nonzeros a
    row of A at random columns, b = |A x0| + 1."""
    import scipy.sparse as sp
    from clarabel_tpu_torch import NonnegativeConeT

    rng = np.random.default_rng(seed)
    P = sp.diags(1.0 + rng.uniform(0, 1, n), format="csc")
    q = rng.normal(size=n)
    rows = np.repeat(np.arange(m), 3)
    A = sp.csr_matrix((rng.normal(size=3 * m), (rows, rng.integers(0, n, 3 * m))),
                      shape=(m, n))
    A.sum_duplicates()
    b = np.abs(A @ rng.normal(size=n)) + 1.0
    return P, q, A, b, [NonnegativeConeT(m)]


def tall_dense_problem(n, m, seed):
    """The tall sparse problem's class with a dense A: P diagonal, A's
    entries N(0, 1/n), b = |A x0| + 1.  (The JAX test's dense tall_problem,
    tests/test_sharded.py:11-18, at n = 256 ends AlmostSolved with a NaN x
    at f32 through "schur_diag" in both packages; ROADMAP Queue 3.)"""
    from clarabel_tpu_torch import NonnegativeConeT

    rng = np.random.default_rng(seed)
    P = np.diag(1.0 + rng.uniform(0, 1, n))
    q = rng.normal(size=n)
    A = rng.normal(size=(m, n)) / np.sqrt(n)
    b = np.abs(A @ rng.normal(size=n)) + 1.0
    return P, q, A, b, [NonnegativeConeT(m)]


def tall_residuals(problem, sol):
    """The JAX test's host KKT check (tests/test_sharded.py:125-134): the
    primal and dual residuals over their limits 5e-4·max(1, |b|∞) and
    5e-4·max(1, |q|∞), and the most negative entry of s and z."""
    P, q, A, b, _ = problem
    r_prim = np.linalg.norm(A @ sol.x + sol.s - b, np.inf)
    r_dual = np.linalg.norm(P @ sol.x + q + A.T @ sol.z, np.inf)
    return dict(prim=r_prim / (5e-4 * max(1.0, np.abs(b).max())),
                dual=r_dual / (5e-4 * max(1.0, np.abs(q).max())),
                min_sz=float(min(sol.s.min(), sol.z.min())))


def sharded_solve(label, problem, mesh):
    """One f32 ShardedRowSolver solve on ``mesh`` with the f32 preset; gates
    the status (Solved or AlmostSolved, the JAX package's own status on its
    m = 1e5 problem), the JAX test's host residuals, and that it took the
    explicit collectives; (solution, report row) with the collectives per
    iteration."""
    import clarabel_tpu_torch as tt

    P, q, A, b, cones = problem
    t0 = time.perf_counter()
    solver = tt.ShardedRowSolver(P, q, A, b, cones, tt.DefaultSettings.for_float32(verbose=False),
                                 mesh=mesh)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sol = solver.solve()
    secs = time.perf_counter() - t0
    its = max(sol.iterations, 1)
    res = tall_residuals(problem, sol)
    calls = solver.collectives
    row = dict(m=A.shape[0], n=A.shape[1], sparse_A=solver._sparse_A, status=sol.status.name,
               iterations=sol.iterations, obj=sol.obj_val, setup_s=setup_s, ms=secs * 1e3,
               ms_per_iteration=secs * 1e3 / its, residuals_over_limit=res,
               collectives=calls,
               collectives_per_iteration={k: {f: v / its for f, v in c.items()}
                                          for k, c in calls.items()})
    assert solver._explicit_collectives, f"{label}: not on the explicit-collective path"
    assert sol.status in (tt.SolverStatus.Solved, tt.SolverStatus.AlmostSolved), \
        f"{label}: {sol.status.name}"
    assert res["prim"] <= 1 and res["dual"] <= 1 and res["min_sz"] >= -1e-5, f"{label}: {res}"
    return sol, row


def mesh_rank_main(args) -> int:
    """One rank of phase 3l's gloo groups on the card (``--mesh-rank MODE
    PORT RANK WORLD OUT``): solves MODE's problems on ``cuda:0`` through
    the mesh solvers and writes what it computed to OUT/rank<RANK>.npz."""
    import clarabel_tpu_torch as tt
    from clarabel_tpu_torch.kkt import pallas_ldl as pl
    from clarabel_tpu_torch.parallel import comm, distributed

    mode, port, rank, world, out_dir = args.mesh_rank
    rank, world = int(rank), int(world)
    distributed.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo")
    out = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if mode == "batches":
            rows_mesh = distributed.global_mesh(("rows",))
            problem = tall_sparse_problem(1_000_000, args.seed + 71)
            sol, row = sharded_solve(f"tall sparse m=1e6 world {world}", problem, rows_mesh)
            out.update(tall_x=sol.x, tall_obj=sol.obj_val, tall_row=json.dumps(row))
            batch_mesh = distributed.global_mesh(("batch",))
            P, q, A, b, cones = sdp_batch(2048, 16, 4, args.seed + 32 + 2048)
            settings = tt.DefaultSettings(verbose=False, direct_solve_method="pallas")
            solver = tt.BatchSolver(P, q, A, b, cones, settings, mesh=batch_mesh)
            torch.cuda.synchronize()
            pl.ldl_factor.launches["unrolled"] = 0
            t0 = time.perf_counter()
            sol = solver.solve()
            out.update(sdp_lanes=sol.lanes, sdp_obj=sol.obj_val, sdp_status=sol.status,
                       sdp_iterations=sol.iterations, sdp_ms=(time.perf_counter() - t0) * 1e3,
                       sdp_launches=pl.ldl_factor.launches["unrolled"])
            P, q, A, b, cones = sparse_qp_batch(32, 1000, args.seed + 50)
            solver = tt.SparseBatchSolver(P, q, A, b, cones, sparse_settings(
                "float64", direct_solve_method="multifrontal"), mesh=batch_mesh)
            torch.cuda.synchronize()
            pl.ldl_unblocked.launches = 0
            t0 = time.perf_counter()
            sol = solver.solve()
            out.update(sparse_lanes=sol.lanes, sparse_obj=sol.obj_val, sparse_status=sol.status,
                       sparse_iterations=sol.iterations,
                       sparse_ms=(time.perf_counter() - t0) * 1e3,
                       sparse_launches=pl.ldl_unblocked.launches)
        else:
            mesh2 = distributed.global_mesh(("batch", "rows"), shape=(2, world // 2))
            P, q, A, b, cones = box_qp_batch(2048, 32, args.seed + 1)
            comm.reset()
            solver = tt.BatchSolver(P, q, A, b, cones,
                                    tt.DefaultSettings.for_float32(verbose=False),
                                    dtype="float32", mesh=mesh2)
            t0 = time.perf_counter()
            sol = solver.solve()
            out.update(box_lanes=sol.lanes, box_obj=sol.obj_val, box_status=sol.status,
                       box_iterations=sol.iterations, box_x=sol.x,
                       box_ms=(time.perf_counter() - t0) * 1e3,
                       box_row_sharded=type(solver._A).__name__ == "DenseRowMat",
                       box_coords=[mesh2.get_local_rank(0), mesh2.get_local_rank(1)],
                       box_collectives=json.dumps(comm.snapshot()))
    out["nondeterministic"] = json.dumps(sorted({str(w.message).splitlines()[0] for w in caught
                                                 if "deterministic" in str(w.message)}))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()
    print(f"RANK{rank} OK", flush=True)
    return 0


def spawn_mesh_ranks(mode, world, args, out_dir):
    """Start ``world`` ranks of this script on the card in ``mode``, wait
    for them (each group within MESH_RANK_TIMEOUT seconds) and return each
    rank's results; raises, with the rank's output, if any rank failed.
    Every process started here has ended when this returns."""
    port = free_port()
    os.makedirs(out_dir, exist_ok=True)
    command = [sys.executable, os.path.abspath(__file__), "--seed", str(args.seed),
               "--mesh-rank", mode, str(port), None, str(world), out_dir]
    procs = []
    for rank in range(world):
        command[-3] = str(rank)
        procs.append(subprocess.Popen(list(command), stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + MESH_RANK_TIMEOUT
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, text) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0 and f"RANK{rank} OK" in text, \
            f"phase 3l {mode} world {world} rank {rank} failed ({p.returncode}):\n{text[-6000:]}"
    results = [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in range(world)]
    for r in results:
        # a rank's operations without a deterministic implementation, where
        # --deterministic's listing sees them
        for message in json.loads(str(r["nondeterministic"])):
            warnings.warn(message)
    return results


def mesh_phase(args, f64_objectives):
    """Phase 3l; returns (its report, the launches of K2 and K3 under the
    world-1 mesh)."""
    import clarabel_tpu_torch as tt
    from clarabel_tpu_torch.kkt import pallas_ldl as pl
    from clarabel_tpu_torch.parallel import comm, distributed

    seed = args.seed
    out = {}
    # (a) world 1 over NCCL, in this process
    log("  (a) world 1 over NCCL in this process")
    distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl")
    try:
        rows_mesh = distributed.global_mesh(("rows",))
        batch_mesh = distributed.global_mesh(("batch",))
        tall = {}
        for label, problem in (
                ("tall sparse m=1e5", tall_sparse_problem(100_000, seed + 70)),
                ("tall sparse m=1e6", tall_sparse_problem(1_000_000, seed + 71)),
                ("tall dense n=256 m=1e5", tall_dense_problem(256, 100_000, seed + 72))):
            comm.reset()
            sol, row = sharded_solve(label, problem, rows_mesh)
            assert not [s for k, s in comm.shapes if len(s) >= 2 and row["m"] in s[:-1]], \
                f"{label}: a collective carried A's rows: {sorted(comm.shapes)}"
            P, q, A, b, cones = problem
            t0 = time.perf_counter()
            ref = tt.DefaultSolver(P, q, A, b, cones, tt.DefaultSettings.for_float32(
                verbose=False, direct_solve_method="schur_diag"), dtype="float32",
                device="cuda").solve()
            ref_ms = (time.perf_counter() - t0) * 1e3
            err = float(np.abs(sol.x - ref.x).max() / max(1.0, np.abs(ref.x).max()))
            row.update(default_solver=dict(status=ref.status.name, iterations=ref.iterations,
                                           ms=ref_ms, obj=ref.obj_val), x_rel_vs_default=err,
                       shapes=[[k, list(s)] for k, s in sorted(comm.shapes)])
            per = row["collectives_per_iteration"]
            log(f"    {label}: {sol.status.name}, {sol.iterations} iterations, setup "
                f"{row['setup_s']:.2f} s, solve {row['ms']:.1f} ms "
                f"({row['ms_per_iteration']:.2f} ms/iteration); per iteration "
                f"{per['all_reduce']['calls']:.1f} all-reduces ({per['all_reduce']['bytes']:.0f} B), "
                f"{per['all_gather']['calls']:.1f} all-gathers ({per['all_gather']['bytes']:.0f} B); "
                f"residuals/limit {row['residuals_over_limit']}; DefaultSolver schur_diag f32 "
                f"{ref.status.name} {ref.iterations} it {ref_ms:.1f} ms, x within {err:.2e}")
            assert ref.status in (tt.SolverStatus.Solved, tt.SolverStatus.AlmostSolved)
            assert err <= 1e-4, f"{label}: x {err:.3e} from DefaultSolver's"
            tall[label] = (sol, row)
        out["world1"] = {k: row for k, (_, row) in tall.items()}

        # the batch solvers over the world-1 mesh: the same bits as their
        # solves without one, K2 and K3 launched under the mesh
        launches = {}
        problem = sdp_batch(2048, 16, 4, seed + 32 + 2048)
        P, q, A, b, cones = problem
        solver = tt.BatchSolver(P, q, A, b, cones, tt.DefaultSettings(
            verbose=False, direct_solve_method="pallas"), mesh=batch_mesh)
        torch.cuda.synchronize()
        for v in pl.ldl_factor.launches:
            pl.ldl_factor.launches[v] = 0
        t0 = time.perf_counter()
        sdp = solver.solve()
        sdp_ms = (time.perf_counter() - t0) * 1e3
        launches["unrolled"] = pl.ldl_factor.launches["unrolled"]
        base = KEPT["SDP B=2048"]
        same = all(np.array_equal(getattr(sdp, k), getattr(base, k))
                   for k in ("x", "z", "s", "obj_val", "iterations", "status"))
        log(f"    SDP batch B=2048 N=58 pallas on the mesh: {sdp_ms:.1f} ms, "
            f"{launches['unrolled']} K2 launches, lanes {sdp.lanes}; bitwise phase 3e's: {same}")
        assert same and sdp.lanes is None and launches["unrolled"] > 0
        problem = sparse_qp_batch(32, 1000, seed + 50)
        P, q, A, b, cones = problem
        solver = tt.SparseBatchSolver(P, q, A, b, cones, sparse_settings(
            "float64", direct_solve_method="multifrontal"), mesh=batch_mesh)
        torch.cuda.synchronize()
        pl.ldl_unblocked.launches = 0
        t0 = time.perf_counter()
        sparse = solver.solve()
        sparse_ms = (time.perf_counter() - t0) * 1e3
        launches["fori"] = pl.ldl_unblocked.launches
        base = KEPT["sparse QP B=32"]
        same_sparse = all(np.array_equal(getattr(sparse, k), getattr(base, k))
                          for k in ("x", "z", "s", "obj_val", "iterations", "status"))
        log(f"    sparse QP batch B=32 N=3000 on the mesh: {sparse_ms:.1f} ms, "
            f"{launches['fori']} K3 launches; bitwise phase 3g's: {same_sparse}")
        assert same_sparse and launches["fori"] > 0
        out["world1"]["SDP B=2048"] = dict(ms=sdp_ms, launches=launches["unrolled"],
                                          bitwise_equal_unsharded=same)
        out["world1"]["sparse QP B=32"] = dict(ms=sparse_ms, launches=launches["fori"],
                                              bitwise_equal_unsharded=same_sparse)
    finally:
        torch.distributed.destroy_process_group()

    # (b) several ranks on the one card
    log("  (b) ranks sharing the one card: gloo, carrying CUDA tensors (NCCL refuses two "
        "ranks on one GPU); not a scaling figure")
    tall_x, tall_obj = tall["tall sparse m=1e6"][0].x, tall["tall sparse m=1e6"][0].obj_val
    sdp_obj, sparse_obj = KEPT["SDP B=2048"].obj_val, KEPT["sparse QP B=32"].obj_val
    box_f32 = KEPT["box QP B=2048 f32"]
    for world in MESH_WORLDS:
        mode = "batches" if world == 2 else "mesh2"
        t0 = time.perf_counter()
        res = spawn_mesh_ranks(mode, world, args, os.path.join("build", "chip_smoke_mesh",
                                                               f"world{world}"))
        wall = time.perf_counter() - t0
        log(f"    world {world}: the group took {wall:.1f} s, process start included")
        entry = dict(wall_s=wall)
        if mode == "batches":
            row = json.loads(str(res[0]["tall_row"]))
            for r in res[1:]:
                assert np.array_equal(r["tall_x"], res[0]["tall_x"]), \
                    f"world {world}: the ranks' x differ"
            err = float(np.abs(res[0]["tall_x"] - tall_x).max() / max(1.0, np.abs(tall_x).max()))
            obj_err = abs(float(res[0]["tall_obj"]) - tall_obj) / max(1.0, abs(tall_obj))
            per = row["collectives_per_iteration"]
            log(f"    world {world} tall sparse m=1e6: {row['status']}, {row['iterations']} "
                f"iterations, {row['ms_per_iteration']:.2f} ms/iteration (world 1: "
                f"{tall['tall sparse m=1e6'][1]['ms_per_iteration']:.2f}; ranks sharing one "
                f"card: not a scaling figure); per iteration {per['all_reduce']['calls']:.1f} "
                f"all-reduces ({per['all_reduce']['bytes']:.0f} B), "
                f"{per['all_gather']['calls']:.1f} all-gathers ({per['all_gather']['bytes']:.0f} "
                f"B); x within {err:.2e}, objective within {obj_err:.2e} of world 1; every "
                f"rank's x the same bits")
            assert err <= 1e-4 and obj_err <= 1e-4, \
                f"world {world}: tall sparse {err:.3e}, {obj_err:.3e}"
            entry.update(tall=row, tall_x_rel_vs_world1=err, tall_obj_rel_vs_world1=obj_err)
            for key, ref_obj, per_rank in (("sdp", sdp_obj, 1024), ("sparse", sparse_obj, 16)):
                worst = 0.0
                for rank, r in enumerate(res):
                    lanes = np.arange(rank * per_rank, (rank + 1) * per_rank)
                    assert np.array_equal(r[f"{key}_lanes"], lanes), f"{key} rank {rank} lanes"
                    assert (r[f"{key}_status"] == int(tt.SolverStatus.Solved)).all(), \
                        f"{key} rank {rank}: {r[f'{key}_status']}"
                    rel = np.abs(r[f"{key}_obj"] - ref_obj[lanes]) / np.maximum(
                        1.0, np.abs(ref_obj[lanes]))
                    worst = max(worst, float(rel.max()))
                    assert int(r[f"{key}_launches"]) > 0
                log(f"    world 2 {key} batch split {per_rank} + {per_rank}: every lane Solved, "
                    f"objectives within {worst:.2e} of world 1's; per rank "
                    f"{[float(r[f'{key}_ms']) for r in res]} ms, kernel launches "
                    f"{[int(r[f'{key}_launches']) for r in res]}")
                assert worst <= 1e-7, f"world 2 {key}: objectives {worst:.3e} apart"
                entry[key] = dict(max_rel_obj=worst, ms=[float(r[f"{key}_ms"]) for r in res],
                                  launches=[int(r[f"{key}_launches"]) for r in res])
        else:
            f64_obj = f64_objectives["box QP B=2048"]
            worst = worst64 = 0.0
            groups = {}
            for r in res:
                g = int(r["box_coords"][0])
                groups.setdefault(g, []).append(r["box_x"])
                lanes = np.arange(g * 1024, (g + 1) * 1024)
                assert bool(r["box_row_sharded"]) and np.array_equal(r["box_lanes"], lanes)
                assert (r["box_status"] == int(tt.SolverStatus.Solved)).all()
                rel = np.abs(r["box_obj"] - box_f32.obj_val[lanes]) / np.maximum(
                    1.0, np.abs(box_f32.obj_val[lanes]))
                rel64 = np.abs(r["box_obj"] - f64_obj[lanes]) / np.maximum(
                    1.0, np.abs(f64_obj[lanes]))
                worst, worst64 = max(worst, float(rel.max())), max(worst64, float(rel64.max()))
            for xs in groups.values():
                assert all(np.array_equal(x, xs[0]) for x in xs), "a row group's x differ"
            collectives = json.loads(str(res[0]["box_collectives"]))
            its = int(max(r["box_iterations"].max() for r in res))
            log(f"    world 4 as a 2 x 2 (batch x rows) mesh, f32 box QP B=2048 N=96 auto "
                f"(schur_diag, A's rows split in two): every lane Solved, objectives within "
                f"{worst:.2e} of phase 3c's unsharded f32 solve and {worst64:.2e} of f64; "
                f"a row group's x the same bits; per rank {[float(r['box_ms']) for r in res]} ms, "
                f"collectives {collectives} over {its} iterations")
            assert worst <= 1e-4 and worst64 <= 1e-3, f"2-D mesh: {worst:.3e}, {worst64:.3e}"
            entry["box_2d"] = dict(max_rel_obj_vs_f32=worst, max_rel_obj_vs_f64=worst64,
                                   ms=[float(r["box_ms"]) for r in res],
                                   collectives=collectives, iterations=its)
        out[f"world{world}"] = entry
    return out, launches


def free_port():
    """A TCP port on this host that was free a moment ago."""
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", help="also write every measurement to this JSON file")
    parser.add_argument("--deterministic", action="store_true",
                        help="list the operations without a deterministic implementation")
    parser.add_argument("--mesh-rank", nargs=5, metavar=("MODE", "PORT", "RANK", "WORLD", "OUT"),
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.mesh_rank:
        # one rank of phase 3l's groups; its parent lists what
        # --deterministic finds in it
        if os.environ.get("CT_CHIP_SMOKE_DETERMINISTIC"):
            torch.use_deterministic_algorithms(True, warn_only=True)
        return mesh_rank_main(args)
    if args.deterministic:
        os.environ["CT_CHIP_SMOKE_DETERMINISTIC"] = "1"
        # cuBLAS repeats its results only with a fixed workspace
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True, warn_only=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            code = run(args)
        found = sorted({str(w.message).splitlines()[0] for w in caught
                        if "deterministic" in str(w.message)})
        # on standard error: the last line of standard output stays the result
        print(f"operations without a deterministic implementation: {len(found)}",
              file=sys.stderr)
        for line in found:
            print("  " + line, file=sys.stderr)
        return code
    return run(args)


def run(args) -> int:
    import clarabel_tpu_torch as tt
    from clarabel_tpu_torch.kkt import build, pallas_ldl as pl
    from clarabel_tpu_torch.solver import full_precision

    device = "cuda"
    settings = tt.DefaultSettings()
    report = {"seed": args.seed}
    started = time.perf_counter()

    # ---- phase 0: the card and the build
    card = card_line()
    sm_hz = sm_clock_hz()
    log(f"phase 0: card {card}, SM clock up to {sm_hz / 1e6:.0f} MHz")
    # one nvcc per source, started together
    t0 = time.perf_counter()
    built = build.build_all()
    seconds = time.perf_counter() - t0
    for path, secs, output in built.values():
        log(f"  built {path.name} in {secs:.1f} s")
        for line in output.splitlines():
            if "Used" in line or "spill" in line or "entry function" in line:
                log("  ptxas:", line.strip())
    log(f"  the build took {seconds:.1f} s")
    report["card"] = card
    report["build_s"] = seconds

    with full_precision():
        # ---- phase 1: kernels against their plain versions
        log("phase 1: kernels against their plain PyTorch versions")
        unblocked = ("unrolled", "fori")
        shapes = {dtype: [
            ("unrolled", 8, 100, 100), ("fori", 8, 100, 100),
            ("unrolled", 1, 100, 101),     # the N = 201 solve's shape
            ("blocked", 1, 1000, 1001),    # the QP's shape
            ("blocked", 1, 500, 1052),     # the SOCP's shape
            ("blocked", 4, 500, 501), ("blocked", 2, 1000, 1001),
            # edge shapes: one pivot; one panel and no rows below it; one
            # row below the first panel; a ragged last panel
            ("blocked", 2, 1, 0), ("blocked", 2, 16, 16), ("blocked", 2, 17, 16),
            ("blocked", 3, 50, 50),
        ] for dtype in (torch.float64, torch.float32)}
        # the unblocked kernel's edges: one and two pivots; the widest f64
        # triangle that fits shared memory (N = 240) and the first two
        # shapes that start in device memory; more matrices than SMs
        shapes[torch.float64] += [(v, B, n, m) for v in unblocked for B, n, m in (
            (1, 1, 0), (1, 1, 1), (1, 120, 120), (1, 120, 121), (1, 128, 128), (264, 32, 32))]
        # the JAX bench's bench_pallas_ldl shape (bench.py:271-273)
        shapes[torch.float32] += [(v, 8, 128, 128) for v in unblocked]
        # phase 3i's f32 box-QP batch
        shapes[torch.float32] += [("unrolled", 2048, 32, 64)]
        # the batch phase's shapes: box QP, SOCP, the two portfolio batches
        shapes[torch.float64] += [("unrolled", 512, 32, 64), ("unrolled", 2048, 32, 64),
                                  ("unrolled", 1024, 32, 97),
                                  ("unrolled", 64, 100, 101), ("blocked", 4, 1000, 1001)]
        # phase 3d's shapes: entropy, p-norm, geometric means, entropy batch
        shapes[torch.float64] += [(v, B, n, m) for v, B, n, m in NONSYM_SHAPES.values()]
        # phase 3e's shapes: the max-cut SDP, the chordal max-cut as its
        # decomposition gives it, the SDP batches
        chordal = tt.DefaultSolver(*maxcut_dual(124, 3, args.seed + 31),
                                   tt.DefaultSettings(direct_solve_method="pallas"), device=device)
        psd_shapes = {"maxcut": ("blocked", 1, 5050, 5150),
                      "chordal": ("blocked", 1, chordal._n_int, chordal.m),
                      "SDP B=64": ("unrolled", 64, 16, 42),
                      "SDP B=2048": ("unrolled", 2048, 16, 42)}
        shapes[torch.float64] += list(psd_shapes.values())
        # phase 3j's f32 shapes: the SDP batches through "pallas" (K2) and
        # the chordal max-cut (K1)
        shapes[torch.float32] += [psd_shapes[k] for k in ("SDP B=64", "SDP B=2048", "chordal")]
        rows = []
        for dtype, cases in shapes.items():
            for variant, B, n, m in cases:
                rows.append(check_kernel(variant, B, n, m, dtype, seed=args.seed + n + m,
                                         device=device, settings=settings,
                                         reps=3 if n + m > 1500 or B > 100 else 10, sm_hz=sm_hz))
        # (row, pivot) pairs the regularization must replace: negative and
        # zero pivots in the + block (rows < n), positive and zero ones in
        # the - block; rows 31, 32, 63, 127 and 128 sit on the blocked
        # kernel's panel edges
        edges = [(0, -1.0), (5, 0.0), (31, -1.0), (32, 0.0), (63, -1.0),
                 (102, 0.5), (127, 0.5), (128, 0.0)]
        check_regularization("blocked", 100, edges, device, settings)
        # at the first even N at least 16 columns wider than the widest f64
        # triangle this card's shared memory holds (N = 256 on the H100), the
        # unblocked kernel switches into shared memory at column j0 = 16 or
        # 17: irregular pivots just before, at and after it (+ block), and
        # two in the - block
        widest = 4096 - pl.unblocked_plan(4096, 8, pl._smem_capacity())[0]
        half = (widest + 17) // 2
        j0, _ = pl.unblocked_plan(2 * half, 8, pl._smem_capacity())
        around = [(j0 - 1, -1.0), (j0, 0.0), (j0 + 1, -1.0), (half + 2, 0.5), (half + half // 2, 0.0)]
        for variant in unblocked:
            check_regularization(variant, 100, edges, device, settings)
            check_regularization(variant, half, around, device, settings)
        report["kernels_vs_plain"] = rows
        # the multifrontal engine's diagonal blocks, per-matrix signs
        fronts = [check_front_blocks(B, N, args.seed + B + N, device, settings, sm_hz)
                  for B, N in FRONT_SHAPES]
        fronts += [check_front_blocks(B, N, args.seed + B + N, device,
                                      tt.DefaultSettings.for_float32(), sm_hz,
                                      dtype=torch.float32)
                   for B, N in FRONT_SHAPES_F32]
        report["front_blocks_vs_plain"] = fronts
        # the double-float LU's factor and solve kernels, bit for bit
        df_rows = df_phase1(args.seed, device, sm_hz)
        report["df_lu_vs_plain"] = df_rows

        # ---- phases 2-3: the main path, launches counted from zero
        for v in pl.ldl_factor.launches:
            pl.ldl_factor.launches[v] = 0
        log("phase 2: portfolio QP, n = 1000, k = 50")
        report["qp"] = compare_methods("QP", portfolio_qp(1000, 50, args.seed), device)
        log("phase 3: portfolio SOCP, n = 500, k = 50; small QP; batched entry")
        report["socp"] = compare_methods("SOCP", portfolio_socp(500, 50, args.seed + 1), device)
        small = portfolio_qp(100, 10, args.seed + 2)
        s_gpu, sol_gpu, _ = solve(small, "pallas", device)
        _, sol_cpu, _ = solve(small, "pallas", "cpu")
        log(f"  small QP N={s_gpu.info.linear_solver.dim}: cuda {sol_gpu.status.name} "
            f"{sol_gpu.iterations} it obj {sol_gpu.obj_val:.12e}; cpu {sol_cpu.status.name} "
            f"{sol_cpu.iterations} it obj {sol_cpu.obj_val:.12e}")
        assert sol_gpu.status == sol_cpu.status == tt.SolverStatus.Solved
        assert abs(sol_gpu.obj_val - sol_cpu.obj_val) <= 1e-8 * max(1.0, abs(sol_cpu.obj_val))
        report["small_qp"] = dict(obj=sol_gpu.obj_val, iterations=sol_gpu.iterations)
        for variant in ("unrolled", "fori", "blocked"):
            batched_entry(variant, 8 if variant != "blocked" else 2, 100, 100, device, settings)
        torch.cuda.synchronize()
        launches = dict(pl.ldl_factor.launches)

        # ---- phase 3b: batches, launches counted from zero for each solve
        log("phase 3b: batches through BatchSolver")
        report["batches"] = {}
        f64_objectives = {}
        for label, (make, variant) in BATCHES.items():
            problem = make(args.seed)
            report["batches"][label], f64_objectives[label] = check_batch(label, problem, variant)
            if label == "box QP B=512":
                report["sequential_box_qp"] = sequential_yardstick(problem, 16)

        # ---- phase 3c: the Schur-complement paths, at f64 and f32
        log("phase 3c: Schur paths")
        report["schur"] = schur_phase(args.seed, report, f64_objectives)

        # ---- phase 3d: nonsymmetric cones, re-solves, a callback; the
        # LDLᵀ launches counted from zero
        log("phase 3d: exponential, power and generalized power cones")
        t0 = time.perf_counter()
        report["nonsym"], launches_3d = nonsym_phase(args.seed)
        report["nonsym"]["seconds"] = time.perf_counter() - t0
        log(f"  phase 3d took {report['nonsym']['seconds']:.1f} s")

        # ---- phase 3e: PSD cones and chordal decomposition; the LDLᵀ
        # launches counted from zero for each solve
        log("phase 3e: PSD cones, chordal decomposition")
        t0 = time.perf_counter()
        report["psd"] = psd_phase(args.seed)
        report["psd"]["seconds"] = time.perf_counter() - t0
        log(f"  phase 3e took {report['psd']['seconds']:.1f} s")

        # ---- phase 3f: the sparse multifrontal path; the unblocked
        # kernel's launches counted from zero for each solve
        log("phase 3f: the sparse multifrontal KKT path")
        t0 = time.perf_counter()
        report["sparse"] = sparse_phase(args.seed)
        report["sparse"]["seconds"] = time.perf_counter() - t0
        log(f"  phase 3f took {report['sparse']['seconds']:.1f} s")

        # ---- phase 3g: the sparse batch; the unblocked kernel's launches
        # counted from zero for each solve
        log("phase 3g: SparseBatchSolver")
        t0 = time.perf_counter()
        report["sparse_batch"] = sparse_batch_phase(args.seed)
        report["sparse_batch"]["seconds"] = time.perf_counter() - t0
        log(f"  phase 3g took {report['sparse_batch']['seconds']:.1f} s")

        # ---- phase 3h: the host surface; the kernels' launches counted
        # from zero for each path
        log("phase 3h: the host surface (buildinfo, native symbolic engine, JSON IO, "
            "print targets, profile, C ABI)")
        t0 = time.perf_counter()
        report["host"], launches_3h, launches_capi = host_phase(args.seed, report["qp"]["obj"])
        report["host"]["seconds"] = time.perf_counter() - t0
        log(f"  phase 3h took {report['host']['seconds']:.1f} s")

        # ---- phase 3i: dense f32; the kernels' launches counted from zero
        # for each solve
        log("phase 3i: dense f32 (double-float LU, Jacobi LU, LDLᵀ at f32, plain f32 LU)")
        t0 = time.perf_counter()
        report["f32_dense"] = f32_dense_phase(args.seed, report, f64_objectives)
        report["f32_dense_seconds"] = time.perf_counter() - t0
        log(f"  phase 3i took {report['f32_dense_seconds']:.1f} s")

        # ---- phase 3j: f32 with PSD cones; the kernels' launches counted
        # from zero for each solve
        log("phase 3j: f32 with PSD cones (double-float PSD scaling, df LU with K_lo, "
            "K1/K2 at f32)")
        t0 = time.perf_counter()
        report["f32_psd"] = f32_psd_phase(args.seed, report)
        report["f32_psd_seconds"] = time.perf_counter() - t0
        log(f"  phase 3j took {report['f32_psd_seconds']:.1f} s")

        # ---- phase 3k: f32 on the sparse path; the kernels' launches
        # counted from zero for each solve
        log("phase 3k: f32 on the sparse path (compensated sparse refinement, K3 at f32 on "
            "the fronts)")
        t0 = time.perf_counter()
        report["f32_sparse"] = f32_sparse_phase(args.seed, report)
        report["f32_sparse_seconds"] = time.perf_counter() - t0
        log(f"  phase 3k took {report['f32_sparse_seconds']:.1f} s")

        # ---- phase 3l: multi-device; K2 and K3 counted from zero for the
        # world-1 mesh's batch solves
        log("phase 3l: multi-device (ShardedRowSolver, BatchSolver and SparseBatchSolver "
            "over device meshes; NCCL across several cards is unverified: one card here)")
        t0 = time.perf_counter()
        report["mesh"], launches_3l = mesh_phase(args, f64_objectives)
        report["mesh_seconds"] = time.perf_counter() - t0
        log(f"  phase 3l took {report['mesh_seconds']:.1f} s")

        # ---- phase 3m: the double-float LU's grid forms, and phase 3i's
        # entropy and p-norm solves on the double-float route; the kernels'
        # launches counted from zero for each solve
        log("phase 3m: the double-float LU past N = 512 (its grid forms; DF_LU_MAX_DIM raised "
            "to 4096 for phase 3i's entropy and p-norm solves)")
        t0 = time.perf_counter()
        report["df_grid"] = df_grid_phase(args.seed, device, sm_hz, report)
        report["df_grid_seconds"] = time.perf_counter() - t0
        log(f"  phase 3m took {report['df_grid_seconds']:.1f} s")

    # ---- phase 4: launch counts and the kernels line
    log(f"phase 4: launches on the main path {launches}")
    main_shape = {"blocked": (1, 1000, 1001), "unrolled": (1, 100, 101), "fori": (8, 100, 100)}
    kernels = []
    for variant, meta in KERNELS.items():
        assert launches[variant] > 0, f"{meta['name']} never launched on the main path"
        B, n, m = main_shape[variant]
        row = next(r for r in rows if r["variant"] == variant and r["B"] == B
                   and r["N"] == n + m and r["dtype"] == "float64")
        kernels.append(dict(
            name=meta["name"], route="cuda", source=SOURCE, replaces=meta["replaces"],
            launches=launches[variant], max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=None, shape=[B, n + m, n + m], dtype="float64",
            yardstick_ldl_factor_ms=row["ldl_factor_ms"],
            yardstick_lu_factor_ms=row["lu_factor_ms"],
        ))
    # the batch phase's path: one row per batch at its kernel's shape, with
    # the launches of its "pallas" solve
    for label, batch in report["batches"].items():
        variant, B, N = batch["variant"], batch["B"], batch["N"]
        row = next(r for r in rows if r["variant"] == variant and r["B"] == B
                   and r["N"] == N and r["dtype"] == "float64")
        count = batch["pallas"]["launches"][variant]
        assert count > 0, f"{KERNELS[variant]['name']} never launched by the {label} batch"
        kernels.append(dict(
            name=KERNELS[variant]["name"], route="cuda", source=SOURCE,
            replaces=KERNELS[variant]["replaces"], launches=count,
            max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=None,
            shape=[B, N, N], dtype="float64", path=f"BatchSolver {label}",
            yardstick_ldl_factor_ms=row["ldl_factor_ms"],
            yardstick_lu_factor_ms=row["lu_factor_ms"],
        ))
    # phase 3d's path: one row per problem at its kernel's shape, with the
    # launches of its "pallas" solve
    for label, (variant, B, n, m) in NONSYM_SHAPES.items():
        run_ = report["nonsym"][label]
        count = run_["pallas"]["launches"][variant] if label == "batch" else run_["factors"]
        assert count > 0, f"{KERNELS[variant]['name']} never launched by phase 3d's {label}"
        assert run_["N"] == n + m and launches_3d[variant] >= count
        row = next(r for r in rows if r["variant"] == variant and r["B"] == B
                   and r["N"] == n + m and r["dtype"] == "float64")
        kernels.append(dict(
            name=KERNELS[variant]["name"], route="cuda", source=SOURCE,
            replaces=KERNELS[variant]["replaces"], launches=count,
            max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=None,
            shape=[B, n + m, n + m], dtype="float64", path=f"phase 3d {label}",
            yardstick_ldl_factor_ms=row["ldl_factor_ms"],
            yardstick_lu_factor_ms=row["lu_factor_ms"],
        ))
    log(f"  K1 (blocked) and K2 (unrolled) launches in phase 3d: "
        f"{launches_3d['blocked']} and {launches_3d['unrolled']}")
    # phase 3e's path: one row per problem at its kernel's shape, with the
    # launches of its "pallas" solve
    psd = report["psd"]
    runs_3e = {"maxcut": psd["maxcut"]["pallas"], "chordal": psd["chordal"]["pallas"],
               **{label: psd["batches"][label]["pallas"] for label in psd["batches"]}}
    for label, (variant, B, n, m) in psd_shapes.items():
        count = runs_3e[label]["launches"][variant]
        assert count > 0, f"{KERNELS[variant]['name']} never launched by phase 3e's {label}"
        row = next(r for r in rows if r["variant"] == variant and r["B"] == B
                   and r["N"] == n + m and r["dtype"] == "float64")
        kernels.append(dict(
            name=KERNELS[variant]["name"], route="cuda", source=SOURCE,
            replaces=KERNELS[variant]["replaces"], launches=count,
            max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=None,
            shape=[B, n + m, n + m], dtype="float64", path=f"phase 3e {label}",
            yardstick_ldl_factor_ms=row["ldl_factor_ms"],
            yardstick_lu_factor_ms=row["lu_factor_ms"],
        ))
    # phase 3f's path: the unblocked kernel on the fronts' diagonal blocks,
    # per-matrix signs; one row per problem at its widest bucket's block
    # shape, with the launches of its multifrontal solve
    sparse = report["sparse"]
    for label, run_ in (("banded QP n=20000", sparse["qp"]["multifrontal"]),
                        ("banded SDP n=250", sparse["sdp"]["multifrontal"])):
        B = run_["widest_block_batch"]
        row = next(r for r in fronts if r["B"] == B and r["N"] == 32
                   and r["dtype"] == "float64")
        assert run_["unblocked_launches"] > 0
        kernels.append(dict(
            name=KERNELS["fori"]["name"], route="cuda", source=SOURCE,
            replaces=KERNELS["fori"]["replaces"], launches=run_["unblocked_launches"],
            max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=None,
            shape=[B, 32, 32], dtype="float64", signs="per-matrix",
            path=f"phase 3f {label}, multifrontal diagonal blocks",
            yardstick_lu_factor_ms=row["lu_factor_ms"],
        ))
    # phase 3g's path: the same kernel on the batches' fronts, every lane's
    # diagonal blocks of a bucket in one launch; one row per batch at its
    # widest bucket's block shape
    for label in ("sparse QP B=32", "sparse QP B=512"):
        run_ = report["sparse_batch"][label]
        B, N = run_["widest_block_batch"], run_["widest_block_cols"]
        row = next(r for r in fronts if r["B"] == B and r["N"] == N
                   and r["dtype"] == "float64")
        assert run_["unblocked_launches"] > 0
        kernels.append(dict(
            name=KERNELS["fori"]["name"], route="cuda", source=SOURCE,
            replaces=KERNELS["fori"]["replaces"], launches=run_["unblocked_launches"],
            max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=None,
            shape=[B, N, N], dtype="float64", signs="per-matrix",
            path=f"phase 3g {label}, multifrontal diagonal blocks of every lane",
            yardstick_lu_factor_ms=row["lu_factor_ms"],
        ))
    # phase 3h's paths: K1 through load_from_file and the C ABI, K2 through
    # the C ABI, K3 on the loaded N = 60000 QP's diagonal blocks
    main_row = lambda variant, B, N: next(r for r in rows if r["variant"] == variant
                                          and r["B"] == B and r["N"] == N
                                          and r["dtype"] == "float64")
    for variant, count, label in (
            ("blocked", launches_3h["blocked"], "phase 3h load_from_file portfolio QP"),
            ("blocked", launches_capi["blocked"], "phase 3h C ABI portfolio QP"),
            ("unrolled", launches_capi["unrolled"], "phase 3h C ABI small QP")):
        assert count > 0, f"{KERNELS[variant]['name']} never launched by {label}"
        B, n, m = main_shape[variant]
        row = main_row(variant, B, n + m)
        kernels.append(dict(
            name=KERNELS[variant]["name"], route="cuda", source=SOURCE,
            replaces=KERNELS[variant]["replaces"], launches=count,
            max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=None,
            shape=[B, n + m, n + m], dtype="float64", path=label,
            yardstick_ldl_factor_ms=row["ldl_factor_ms"],
            yardstick_lu_factor_ms=row["lu_factor_ms"],
        ))
    B = report["host"]["json_n60000"]["widest_block_batch"]
    row = next(r for r in fronts if r["B"] == B and r["N"] == 32
                   and r["dtype"] == "float64")
    assert launches_3h["fori"] > 0
    kernels.append(dict(
        name=KERNELS["fori"]["name"], route="cuda", source=SOURCE,
        replaces=KERNELS["fori"]["replaces"], launches=launches_3h["fori"],
        max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
        bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=None,
        shape=[B, 32, 32], dtype="float64", signs="per-matrix",
        path="phase 3h load_from_file banded QP n=20000, multifrontal diagonal blocks",
        yardstick_lu_factor_ms=row["lu_factor_ms"],
    ))
    # phase 3i's paths: the double-float LU's kernels on the geometric
    # means (1 x 176²) and the entropy batch (512 x 208²), K1 and K2 at f32.
    # The double-float solve's figures are at R = 2 (check_df_lu times one
    # twin solve per shape, at R = 2), its R = 1 time beside, here and in
    # phases 3j and 3m
    f32 = report["f32_dense"]
    for label, B, N in (("geometric means k=16 auto", 1, 176), ("entropy B=512 auto", 512, 208)):
        counts = f32[label]["counts"]
        row = next(r for r in df_rows if r["B"] == B and r["N"] == N and not r["K_lo"]
                   and "factor_ms" in r)
        for name, count, replaces, ms, plain, bound, by, floor in (
                ("df_lu_factor", counts["df_factor"], "clarabel_tpu/kkt/df_ldl.py:93",
                 row["factor_ms"], row["factor_plain_ms"], row["factor_bound_ms"],
                 row["factor_bound_by"], row["factor_nonfma_floor_ms"]),
                ("df_lu_solve", counts["df_solve"], "clarabel_tpu/kkt/df_ldl.py:179",
                 row["solve_ms"][2], row["solve_plain_ms"][2], row["solve_bound_ms"][2],
                 row["solve_bound_by"][2], row["solve_nonfma_floor_ms"][2])):
            assert count > 0, f"{name} never launched by phase 3i's {label}"
            kernels.append(dict(
                name=name, route="cuda", source=DF_SOURCE, replaces=replaces, launches=count,
                max_abs_err=row["max_abs_err"], ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by=by, library_ms=None, shape=[B, N, N], dtype="float32",
                path=f"dense f32, phase 3i {label}", tpu_kernel=False,
                nonfma_floor_ms=floor,
                yardstick_lu_factor_f32_ms=row["lu_factor_f32_ms"],
                yardstick_lu_factor_f64_ms=row["lu_factor_f64_ms"],
                **({"rhs": 2, "ms_R1": row["solve_ms"][1], "bound_ms_R1": row["solve_bound_ms"][1]}
                   if name == "df_lu_solve" else {"kernels_per_factor": row["factor_kernels"]})))
    for label, variant, (B, n, m) in (
            ("portfolio QP n=1000 pallas", "blocked", (1, 1000, 1001)),
            ("portfolio SOCP n=500 pallas", "blocked", (1, 500, 1052)),
            ("small QP n=100 pallas", "unrolled", (1, 100, 101)),
            ("box QP B=2048 pallas", "unrolled", (2048, 32, 64))):
        count = f32[label]["counts"][variant]
        assert count > 0, f"{KERNELS[variant]['name']} never launched by phase 3i's {label}"
        row = next(r for r in rows if r["variant"] == variant and r["B"] == B
                   and r["N"] == n + m and r["dtype"] == "float32")
        kernels.append(dict(
            name=KERNELS[variant]["name"], route="cuda", source=SOURCE,
            replaces=KERNELS[variant]["replaces"], launches=count,
            max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=None,
            shape=[B, n + m, n + m], dtype="float32", path=f"dense f32, phase 3i {label}",
            yardstick_ldl_factor_ms=row["ldl_factor_ms"],
            yardstick_lu_factor_ms=row["lu_factor_ms"],
        ))
    # phase 3j's paths: the double-float LU's kernels with K_lo on the SDP
    # batches (64 and 2048 x 58²), K2 at f32 on them, K1 at f32 on the
    # chordal max-cut
    f32p = report["f32_psd"]
    for label, B, N in (("SDP B=64 auto", 64, 58), ("SDP B=2048 auto", 2048, 58)):
        counts = f32p[label]["counts"]
        row = next(r for r in df_rows if r["B"] == B and r["N"] == N and r["K_lo"]
                   and "factor_ms" in r)
        for name, count, replaces, ms, plain, bound, by, floor in (
                ("df_lu_factor", counts["df_factor"], "clarabel_tpu/kkt/df_ldl.py:93",
                 row["factor_ms"], row["factor_plain_ms"], row["factor_bound_ms"],
                 row["factor_bound_by"], row["factor_nonfma_floor_ms"]),
                ("df_lu_solve", counts["df_solve"], "clarabel_tpu/kkt/df_ldl.py:179",
                 row["solve_ms"][2], row["solve_plain_ms"][2], row["solve_bound_ms"][2],
                 row["solve_bound_by"][2], row["solve_nonfma_floor_ms"][2])):
            assert count > 0, f"{name} never launched by phase 3j's {label}"
            kernels.append(dict(
                name=name, route="cuda", source=DF_SOURCE, replaces=replaces, launches=count,
                max_abs_err=row["max_abs_err"], ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by=by, library_ms=None, shape=[B, N, N], dtype="float32", K_lo=True,
                path=f"f32 PSD, phase 3j {label}", tpu_kernel=False, nonfma_floor_ms=floor,
                yardstick_lu_factor_f32_ms=row["lu_factor_f32_ms"],
                yardstick_lu_factor_f64_ms=row["lu_factor_f64_ms"],
                **({"rhs": 2, "ms_R1": row["solve_ms"][1], "bound_ms_R1": row["solve_bound_ms"][1]}
                   if name == "df_lu_solve" else {"kernels_per_factor": row["factor_kernels"]})))
    for label, count_of, (variant, B, n, m) in (
            ("SDP B=64 pallas", "unrolled", psd_shapes["SDP B=64"]),
            ("SDP B=2048 pallas", "unrolled", psd_shapes["SDP B=2048"]),
            ("chordal pallas", "blocked", psd_shapes["chordal"])):
        count = f32p[label]["counts"][count_of]
        assert count > 0, f"{KERNELS[variant]['name']} never launched by phase 3j's {label}"
        row = next(r for r in rows if r["variant"] == variant and r["B"] == B
                   and r["N"] == n + m and r["dtype"] == "float32")
        kernels.append(dict(
            name=KERNELS[variant]["name"], route="cuda", source=SOURCE,
            replaces=KERNELS[variant]["replaces"], launches=count,
            max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=None,
            shape=[B, n + m, n + m], dtype="float32", path=f"f32 PSD, phase 3j {label}",
            yardstick_ldl_factor_ms=row["ldl_factor_ms"],
            yardstick_lu_factor_ms=row["lu_factor_ms"],
        ))
    # phase 3k's paths: the unblocked kernel at f32 on the fronts' diagonal
    # blocks, per-matrix signs; one row per problem at its widest bucket's
    # block shape, with the launches of its f32 multifrontal solve
    f32s = report["f32_sparse"]
    for label in ("banded QP", "banded SDP", "sparse QP B=32", "sparse QP B=512"):
        run_ = f32s[label]
        B, N = run_["widest_block_batch"], run_.get("widest_block_cols", 32)
        row = next(r for r in fronts if r["B"] == B and r["N"] == N and r["dtype"] == "float32")
        assert run_["unblocked_launches"] > 0
        kernels.append(dict(
            name=KERNELS["fori"]["name"], route="cuda", source=SOURCE,
            replaces=KERNELS["fori"]["replaces"], launches=run_["unblocked_launches"],
            max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=None,
            shape=[B, N, N], dtype="float32", signs="per-matrix",
            path=f"f32 sparse, phase 3k {label}, multifrontal diagonal blocks",
            yardstick_lu_factor_ms=row["lu_factor_ms"],
        ))
    # phase 3l's path: K2 on the SDP batch and K3 on the sparse batch's
    # fronts, each launched by the batch solver over the world-1 mesh
    assert launches_3l["unrolled"] > 0 and launches_3l["fori"] > 0
    B, n, m = psd_shapes["SDP B=2048"][1:]
    row = next(r for r in rows if r["variant"] == "unrolled" and r["B"] == B
               and r["N"] == n + m and r["dtype"] == "float64")
    kernels.append(dict(
        name=KERNELS["unrolled"]["name"], route="cuda", source=SOURCE,
        replaces=KERNELS["unrolled"]["replaces"], launches=launches_3l["unrolled"],
        max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
        bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=None,
        shape=[B, n + m, n + m], dtype="float64",
        path="phase 3l BatchSolver(mesh=) SDP B=2048, world 1 over NCCL",
        yardstick_ldl_factor_ms=row["ldl_factor_ms"],
        yardstick_lu_factor_ms=row["lu_factor_ms"],
    ))
    run_ = report["sparse_batch"]["sparse QP B=32"]
    B, N = run_["widest_block_batch"], run_["widest_block_cols"]
    row = next(r for r in fronts if r["B"] == B and r["N"] == N and r["dtype"] == "float64")
    kernels.append(dict(
        name=KERNELS["fori"]["name"], route="cuda", source=SOURCE,
        replaces=KERNELS["fori"]["replaces"], launches=launches_3l["fori"],
        max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
        bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=None,
        shape=[B, N, N], dtype="float64", signs="per-matrix",
        path="phase 3l SparseBatchSolver(mesh=) sparse QP B=32, world 1 over NCCL, "
             "multifrontal diagonal blocks of every lane",
        yardstick_lu_factor_ms=row["lu_factor_ms"],
    ))
    # phase 3m's paths: the grid forms of the double-float LU's kernels on
    # the entropy problem (1 x 2540²) and the p-norm regression (1 x 1300²)
    # through the double-float route
    grid = report["df_grid"]
    for label, N in (("entropy n=500", 2540), ("p-norm p=1.5 300x100", 1300)):
        counts = grid["solves"][label]["counts"]
        row = next(r for r in grid["kernels"] if r["B"] == 1 and r["N"] == N
                   and not r["K_lo"] and "factor_ms" in r)
        for name, count, replaces, ms, plain, bound, by, floor in (
                ("df_lu_factor", counts["df_factor"], "clarabel_tpu/kkt/df_ldl.py:93",
                 row["factor_ms"], row["factor_plain_ms"], row["factor_bound_ms"],
                 row["factor_bound_by"], row["factor_nonfma_floor_ms"]),
                ("df_lu_solve", counts["df_solve"], "clarabel_tpu/kkt/df_ldl.py:179",
                 row["solve_ms"][2], row["solve_plain_ms"][2], row["solve_bound_ms"][2],
                 row["solve_bound_by"][2], row["solve_nonfma_floor_ms"][2])):
            assert count > 0, f"{name} never launched by phase 3m's {label}"
            kernels.append(dict(
                name=name, route="cuda", source=DF_SOURCE, replaces=replaces, launches=count,
                max_abs_err=row["max_abs_err"], ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by=by, library_ms=None, shape=[1, N, N], dtype="float32",
                path=f"dense f32 past N = 512 (grid form), phase 3m {label} auto",
                tpu_kernel=False, nonfma_floor_ms=floor,
                yardstick_lu_factor_f32_ms=row["lu_factor_f32_ms"],
                yardstick_lu_factor_f64_ms=row["lu_factor_f64_ms"],
                **({"rhs": 2, "ms_R1": row["solve_ms"][1], "bound_ms_R1": row["solve_bound_ms"][1]}
                   if name == "df_lu_solve" else {"kernels_per_factor": row["factor_kernels"]})))
    report["seconds"] = time.perf_counter() - started
    log(f"chip_smoke took {report['seconds']:.1f} s")
    report["launches"] = launches
    report["launches_3d"] = launches_3d
    report["launches_3h"] = launches_3h
    report["launches_capi"] = launches_capi
    report["launches_3l"] = launches_3l
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
