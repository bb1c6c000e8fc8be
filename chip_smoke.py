#!/usr/bin/env python3
"""Drive clarabel_tpu_torch on one CUDA card and check what comes out.

Run from the root of a checkout:  python3 chip_smoke.py [--seed S] [--out FILE]

Phases:
  0. the card (name and power limit, from nvidia-smi) and the build of the
     hand-written kernels (clarabel_tpu_torch/kkt/csrc/ldl.cu) into build/;
  1. each LDLᵀ kernel against its plain PyTorch version on the card, at f64
     and f32, at the shapes the solvers give it (the batch phase's
     512 and 2048 x 96², 1024 x 129², 64 x 201² and 4 x 2001², phase 3e's
     1 x 10200², the chordal max-cut's 1 x N² and 64 and 2048 x 58² among
     them), with the solve's backward error, the kernel's and the plain
     version's times and, as yardsticks the port never calls,
     torch.linalg.ldl_factor (pivoted, so another function; not at
     N = 10200) and torch.linalg.lu_factor; the unblocked kernel (K2/K3) bit for bit equal to its twin, also at the
     edges of its shared-memory design (N = 1, 2; N = 240, the widest f64
     triangle that fits; N = 241 and 256, which start in device memory; 264
     matrices of N = 64, more than the card's SMs; f32 N = 256, B = 8); the
     blocked kernel also at edge shapes (N = 1, 32, 33, 100: one panel, one
     row below it, a ragged last panel); plus cases where the dynamic
     regularization fires, on the blocked kernel's panel edges and around
     the unblocked kernel's switch into shared memory;
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
     (dense or the multifrontal engine's NotImplementedError, as the JAX
     package routes it), and a warm re-solve through the clique transform
     after a 1 % change of q; the JAX bench's strictly complementary SDP
     batch (n = 16, NonnegativeConeT(32) + PSDTriangleConeT(4), N = 58, K2)
     at B = 64 and 2048, checked as phase 3b checks its batches, each lane's
     iterations within 4 between the backends and between a lane alone and
     in the batch (the JAX package's own spread on those lanes); every
     solve prints its device reads and every device wait the sync debug
     mode sees;
  4. the launch counts of phases 2-3, 3b, 3d and 3e and one JSON line per
     kernel and shape.

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
import json
import os
import subprocess
import sys
import time
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


def sdp_batch(B, n, dmat, seed):
    """The JAX bench's batched SDP (bench.py:194-256), B strictly
    complementary instances built from a known primal-dual optimal pair:
    interior x*, complementary s* ⊥ z* on NonnegativeConeT(2n) (a quarter
    of the rows active) and on PSDTriangleConeT(dmat) (S*, Z* PSD on
    orthogonal complements), then b = Ax* + s*, q = -(Px* + Aᵀz*)."""
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
    return P, q, A, b, [NonnegativeConeT(2 * n), PSDTriangleConeT(dmat)]


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


def sequential_yardstick(problem, lanes):
    """Solves per second of DefaultSolver looped over the first ``lanes``
    lanes of a batch on the card, per backend."""
    import clarabel_tpu_torch as tt

    P, q, A, b, cones = problem
    out = {}
    for method in ("pallas", "auto"):
        settings = tt.DefaultSettings(verbose=False, direct_solve_method=method)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(lanes):
            sol = tt.DefaultSolver(P[i], q[i], A[i], b[i], cones, settings, device="cuda").solve()
            assert sol.status == tt.SolverStatus.Solved
        secs = time.perf_counter() - t0
        out[method] = dict(lanes=lanes, wall_ms=secs * 1e3, solves_per_s=lanes / secs)
        log(f"  DefaultSolver over {lanes} lanes, {method}: {secs * 1e3:.1f} ms, "
            f"{lanes / secs:.1f} solves/s")
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
    out["batch"], _ = check_batch("entropy B=512", entropy_batch(512, 40, 4, 4, seed + 23),
                                  "unrolled", iterations_apart=ENTROPY_ITERATIONS_APART)

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
    # "auto": the JAX package's route, dense or its multifrontal engine
    try:
        _, sol, row = psd_solve("chordal max-cut n=124", dual, "auto")
        assert sol.status == tt.SolverStatus.Solved
        assert abs(sol.obj_val - plain.obj_val) <= 1e-7 * max(1.0, abs(plain.obj_val))
        out["chordal"]["auto"] = row
    except NotImplementedError as e:
        assert "item 14" in str(e)
        log(f"  chordal max-cut n=124 auto: routes to the multifrontal engine ({e})")
        out["chordal"]["auto"] = dict(route="multifrontal", raised=str(e))
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
        out["batches"][label], _ = check_batch(label, sdp_batch(B, 16, 4, seed + 32 + B),
                                               "unrolled", SDP_ITERATIONS_APART,
                                               count_syncs=True)
        batch = out["batches"][label]
        log(f"  {label}: {batch['pallas']['solves_per_s']:.1f} solves/s through \"pallas\", "
            f"{batch['auto']['solves_per_s']:.1f} through \"auto\"")
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", help="also write every measurement to this JSON file")
    parser.add_argument("--deterministic", action="store_true",
                        help="list the operations without a deterministic implementation")
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.deterministic:
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

    # ---- phase 0: the card and the build
    card = card_line()
    sm_hz = sm_clock_hz()
    log(f"phase 0: card {card}, SM clock up to {sm_hz / 1e6:.0f} MHz")
    path, seconds, output = build.build("ldl.cu")
    log(f"  built {path.name} in {seconds:.1f} s")
    for line in output.splitlines():
        if "Used" in line or "spill" in line or "entry function" in line:
            log("  ptxas:", line.strip())
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
    report["launches"] = launches
    report["launches_3d"] = launches_3d
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
