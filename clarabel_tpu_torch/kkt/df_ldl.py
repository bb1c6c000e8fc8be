"""Double-float (f32x2) dense LU for ill-conditioned f32 KKT systems.

PyTorch port of ``clarabel_tpu/kkt/df_ldl.py``.  Near convergence the f32
KKT matrix reaches cond(K) ~ 1/μ² (about 5e9 on strictly complementary
problems), and every plain f32 factorization then applies its solve with
backward error ~eps32·‖K‖: iterative refinement's contraction factor
eps32·cond(K) exceeds one, and the refined direction keeps an O(1) forward
error.  A factorization whose application error is ~eps_df ≈ 2⁻⁴⁸ keeps
eps_df·cond ≪ 1, so one solve already has ~1e-5 forward accuracy and the
compensated refinement (``kkt/dense.solve_refined``) converges past it.

- :func:`factor`: right-looking LU with partial pivoting, carried entirely
  in (hi, lo) pairs.  An exact power-of-two symmetric scaling (no rounding)
  first brings the diagonal near 1.  A zero pivot becomes ``delta``, so the
  factor stays finite; the refinement then judges the solve.
- :func:`solve`: forward and backward substitution in double-float, one
  column per step, with a single rounding of (xh + xl)·s at the end.

Every function takes leading batch dimensions ([..., N, N]; the JAX package
``vmap``s an unbatched version).  The plain versions (:func:`factor_plain`,
:func:`solve_plain`) repeat the JAX package's arithmetic operation for
operation, each in its own PyTorch operation, so nothing is contracted into
an FMA; they are the CPU path and the twins the kernels are held to.  On a
CUDA tensor :func:`factor` and :func:`solve` launch the hand-written kernels
of ``csrc/df_lu.cu`` (``factor.launches`` and ``solve.launches`` count
them) or raise; nothing falls back.  The factor kernel is a panel-blocked
right-looking LU: each panel of ``nb`` columns is factored on its own, its
swaps are applied late, and every trailing entry takes the panel's ``nb``
updates in registers between one read and one write.  Up to
:data:`BLOCK_MAX_DIM` = 512 it runs as one block per matrix, the panel in
shared memory (the one-block form); above, as three launches per panel,
the trailing block spread over the card's SMs (the grid form).  The solve
kernel gives each matrix a block and runs the row-oriented substitution
blocked by 32, a warp per 32 rows up to 512 and each warp looping over
several row blocks above.  Both are bitwise equal to the twins at every N:
each entry sees the twin's operations in the twin's order, and where the
twin's masked updates would spread a non-finite value the kernels
recompute the matrix along the twin's own schedule.  Their floor on the
H100 is the non-FMA issue rate (33.5 T operations/s; error-free
arithmetic cannot fuse), 1.29 ms for the factor at 512 x 208².
:func:`factor_launch` and :func:`solve_launch` choose the form and its
launch parameters.  The JAX package computes this outside Pallas, so it
replaces no TPU kernel.
"""

from __future__ import annotations

import functools

import torch

from .compensated import _two_prod, _two_sum


def _df_add(ah, al, bh, bl):
    sh, se = _two_sum(ah, bh)
    return _two_sum(sh, se + al + bl)


def _df_sub(ah, al, bh, bl):
    return _df_add(ah, al, -bh, -bl)


def _df_mul(ah, al, bh, bl):
    ph, pe = _two_prod(ah, bh)
    return _two_sum(ph, pe + ah * bl + al * bh)


def _df_div(nh, nl, dh, dl):
    """Double-float division (n / d), ~eps_df accurate."""
    q1 = nh / dh
    # r = n - q1 * d in double-float
    ph, pe = _two_prod(q1, dh)
    rh, re = _two_sum(nh, -ph)
    r = rh + (re - pe + nl - q1 * dl)
    q2 = r / dh
    return _two_sum(q1, q2)


def _pow2_jacobi(K_hi):
    """Exact power-of-two symmetric scaling s [..., N] with s·diag·s ~ O(1).

    s = 2^-(e // 2) for frexp's exponent e of max(|K_ii|, 1e-30), with the
    floor division ``jnp``'s ``//`` does on negative exponents.  The power
    is built from its bits: exact on every device (e // 2 lies in [-64, 50],
    so 2^half is a normal f32)."""
    diag = torch.abs(torch.diagonal(K_hi, dim1=-2, dim2=-1))
    _, expo = torch.frexp(torch.maximum(diag, diag.new_tensor(1e-30)))
    half = -(expo // 2)
    return ((half + 127) << 23).to(torch.int32).view(torch.float32)


def _swap_rows(M, j, p):
    """Rows j and p[...] of M [..., N, C] swapped (p per problem): two rows
    moved, the rest copied."""
    at_p = p[..., None, None].expand(*p.shape, 1, M.shape[-1])
    row_j, row_p = M[..., j:j + 1, :].clone(), torch.gather(M, -2, at_p)
    out = M.clone()
    # the JAX package writes row j into p, then row p into j
    out.scatter_(-2, at_p, row_j)
    out[..., j:j + 1, :] = row_p
    return out


# -----------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the twins on the card)
# -----------------------------------------------------------------


def factor_plain(K_hi, K_lo=None, delta=1e-6):
    """Double-float LU with partial pivoting of K = K_hi + K_lo [..., N, N]
    (f32), column by column over the whole matrix, as the JAX package's
    ``factor`` runs it.  Returns ((Ah, Al, perm, s), ok): the multipliers
    below the diagonal and U on and above it as (hi, lo) pairs of the scaled
    matrix, the row permutation perm [..., N] (int64), the scaling s and
    ok [...] = every entry finite."""
    N = K_hi.shape[-1]
    if K_lo is None:
        K_lo = torch.zeros_like(K_hi)
    s = _pow2_jacobi(K_hi)
    Ah = K_hi * s.unsqueeze(-1) * s.unsqueeze(-2)  # exact
    Al = K_lo * s.unsqueeze(-1) * s.unsqueeze(-2)  # exact
    idx = torch.arange(N, device=K_hi.device)
    perm = idx.expand(K_hi.shape[:-1]).unsqueeze(-1)

    for j in range(N):
        ch, cl = Ah[..., :, j], Al[..., :, j]
        # partial pivot: the first largest |column| entry among rows >= j
        cand = torch.where(idx >= j, torch.abs(ch + cl), -1.0)
        p = torch.argmax(cand, dim=-1)
        Ah = _swap_rows(Ah, j, p)
        Al = _swap_rows(Al, j, p)
        perm = _swap_rows(perm, j, p)

        ch, cl = Ah[..., :, j], Al[..., :, j]
        dh, dl = ch[..., j], cl[..., j]
        # zero-pivot safeguard (numerically singular K_reg)
        bad = dh == 0.0
        dh = torch.where(bad, delta, dh)
        dl = torch.where(bad, 0.0, dl)

        lh, ll = _df_div(ch, cl, dh.unsqueeze(-1), dl.unsqueeze(-1))
        below = (idx > j).to(Ah.dtype)
        lh = lh * below
        ll = ll * below

        rh, rl = Ah[..., j, :], Al[..., j, :]
        # only columns > j of the pivot row enter the trailing update
        rh_t = rh * below
        rl_t = rl * below

        uh, ue = _two_prod(lh.unsqueeze(-1), rh_t.unsqueeze(-2))
        cross = (lh.unsqueeze(-1) * rl_t.unsqueeze(-2)
                 + ll.unsqueeze(-1) * rh_t.unsqueeze(-2))
        Ah, e1 = _two_sum(Ah, -uh)
        Al = Al + (e1 - ue - cross)
        # renormalize the pair: without this |Al| grows across steps and
        # the next step's error-free product (of Ah only) leaks plain-f32
        # error through the cross terms
        Ah, Al = _two_sum(Ah, Al)

        # the multipliers go into column j below the diagonal; rows <= j
        # keep their (final) U entries
        Ah[..., :, j] = torch.where(idx > j, lh, ch)
        Al[..., :, j] = torch.where(idx > j, ll, cl)

    ok = torch.isfinite(Ah).flatten(-2).all(dim=-1) & torch.isfinite(Al).flatten(-2).all(dim=-1)
    return (Ah, Al, perm.squeeze(-1), s), ok


def solve_plain(factors, rhs):
    """Solve K x = rhs through the double-float LU, as the JAX package's
    ``solve`` does: ``rhs`` [..., N] or [..., N, R]; the double-float
    solution rounded once at the end (the caller's compensated refinement
    recovers the sub-eps remainder)."""
    Ah, Al, perm, s = factors
    N = Ah.shape[-1]
    vec = rhs.dim() == Ah.dim() - 1
    if vec:
        rhs = rhs.unsqueeze(-1)
    sb = s.unsqueeze(-1)
    b = rhs * sb  # exact (power of two)
    yh = torch.take_along_dim(b, perm.unsqueeze(-1), dim=-2)
    yl = torch.zeros_like(yh)
    idx = torch.arange(N, device=Ah.device).unsqueeze(-1)

    # forward: L y = b_perm (unit lower; multipliers stored below diag)
    for j in range(N):
        below = (idx > j).to(Ah.dtype)
        yjh, yjl = yh[..., j:j + 1, :], yl[..., j:j + 1, :]
        uh, ul = _df_mul(Ah[..., :, j:j + 1] * below, Al[..., :, j:j + 1] * below, yjh, yjl)
        yh, yl = _df_sub(yh, yl, uh, ul)

    # backward: U x = y (column-oriented, reversed)
    xh, xl = yh, yl
    for j in range(N - 1, -1, -1):
        uh_col, ul_col = Ah[..., :, j:j + 1], Al[..., :, j:j + 1]
        dh, dl = Ah[..., j, j:j + 1], Al[..., j, j:j + 1]
        xjh, xjl = _df_div(xh[..., j, :], xl[..., j, :], dh, dl)
        # (xh and xl are fresh results of this loop's arithmetic: written in place)
        xh[..., j, :] = xjh
        xl[..., j, :] = xjl
        above = (idx < j).to(Ah.dtype)
        ph, pl = _df_mul(uh_col * above, ul_col * above, xjh.unsqueeze(-2), xjl.unsqueeze(-2))
        nh, nl = _df_sub(xh, xl, ph, pl)
        # keep row j (just finalized) untouched by the update
        keep = (idx == j).to(Ah.dtype)
        xh = nh * (1 - keep) + xh * keep
        xl = nl * (1 - keep) + xl * keep

    out = (xh + xl) * sb  # exact scale-back; one rounding in the sum
    return out.squeeze(-1) if vec else out


# -----------------------------------------------------------------
# kernel launches
# -----------------------------------------------------------------


@functools.cache
def _smem_capacity() -> int:
    """Shared-memory bytes one block may use on the card."""
    from . import build

    capacity = build.library("df_lu.cu").df_lu_smem_capacity()
    if capacity <= 0:
        raise RuntimeError(f"shared-memory capacity query failed: CUDA error {-capacity}")
    return capacity


@functools.cache
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


#: the largest N of the one-block forms: the solve's block has a warp per
#: 32 rows and at most 16 warps; larger N take the grid forms
BLOCK_MAX_DIM = 512
#: the factor kernel's panel width (``NB`` in ``csrc/df_lu.cu``)
FACTOR_NB = 8
#: the most matrices one grid-form factor launches over (a grid's z extent)
GRID_MAX_BATCH = 65535


def factor_smem_bytes(N):
    """Dynamic shared memory of the one-block factor (``factor_smem_bytes``
    in ``csrc/df_lu.cu``): the panel's N x FACTOR_NB pairs at an odd row
    stride, its U rows over the trailing columns, the permutation and the
    panel's row sources."""
    nb = FACTOR_NB
    return (2 * N * (nb + 1) + 2 * nb * max(N - nb, 1) + 2 * N) * 4


def grid_scratch_words(N):
    """Device-memory scratch of the grid-form factor, in floats per matrix
    (``grid_scratch_words`` in ``csrc/df_lu.cu``): the panel and its U rows
    as (hi, lo) pairs [FACTOR_NB][N], the permutation, the panel's pivots
    and two flags."""
    return 4 * FACTOR_NB * N + N + FACTOR_NB + 2


def grid_solve_scratch_words(N, rc):
    """Device-memory scratch of the grid-form solve, in floats per matrix
    (``grid_solve_scratch_words``): the iterate's hi and lo parts and the hi
    part's split, [N][rc] each."""
    return 4 * N * rc


def factor_launch(B, N, smem_capacity, sm_count):
    """(form, threads per block, shared-memory bytes) of ``df_lu_factor``
    for B matrices of order N.  Up to :data:`BLOCK_MAX_DIM`, the one-block
    form ("block"): 512 threads while each SM holds at most one matrix,
    fewer as more matrices share an SM, so that a batch of up to four per SM
    runs in one wave; it raises for a panel that does not fit the card's
    shared memory.  Above, the grid form ("grid": a panel block of 1024
    threads, static shared memory only); it raises for more matrices than
    a grid spans (:data:`GRID_MAX_BATCH`)."""
    if N > BLOCK_MAX_DIM:
        if B > GRID_MAX_BATCH:
            raise ValueError(f"df_lu_factor's grid form takes at most {GRID_MAX_BATCH} "
                             f"matrices per launch, got {B}")
        return "grid", 1024, 0
    per_sm = -(-B // sm_count)
    threads = 512 if per_sm <= 1 else 256 if per_sm <= 2 else 128
    nbytes = factor_smem_bytes(N)
    if nbytes > smem_capacity:
        raise ValueError(f"df_lu_factor at N={N} needs {nbytes} bytes of shared memory, the "
                         f"card has {smem_capacity}")
    return "block", threads, nbytes


def solve_launch(N, R, smem_capacity):
    """(form, right-hand sides per pass, shared-memory bytes) of
    ``df_lu_solve``.  Up to :data:`BLOCK_MAX_DIM`, the one-block form
    ("block"): a warp per 32-row block, a 32 x 16 half tile per warp and two
    more, a 32 x 32 tile for the diagonal block, and the [N, rc] iterate with
    its split hi parts (``solve_smem_bytes`` in ``csrc/df_lu.cu``); it raises
    for a block that does not fit.  Above, the grid form ("grid"): up to 32
    warps each looping over its row blocks, the iterate in device memory
    (:func:`grid_solve_scratch_words`), no dynamic shared memory."""
    rc = 1 if R == 1 else 2
    if N > BLOCK_MAX_DIM:
        return "grid", rc, 0
    nbytes = ((-(-N // 32) + 2) * 2 * 32 * 17 + 2 * 32 * 33 + 4 * N * rc) * 4
    if nbytes > smem_capacity:
        raise ValueError(f"df_lu_solve at N={N} needs {nbytes} bytes of shared memory, the "
                         f"card has {smem_capacity}")
    return "block", rc, nbytes


def _check(name, t, dims):
    if t.dtype != torch.float32:
        raise TypeError(f"the double-float LU takes float32, got {name} of {t.dtype}")
    if t.dim() < dims:
        raise ValueError(f"{name} needs at least {dims} dimensions, got {tuple(t.shape)}")


def _launch_factor(lib, K_hi, K_lo, delta):
    """``df_lu_factor`` (or ``df_lu_factor_grid``) of ``lib`` (the built
    ``csrc/df_lu.cu``) with factor_launch's parameters."""
    batch, N = K_hi.shape[:-2], K_hi.shape[-1]
    Kh = K_hi.reshape(-1, N, N).contiguous()
    B = Kh.shape[0]
    form, threads, nbytes = factor_launch(B, N, _smem_capacity(), _sm_count(Kh.device))
    Kl = None if K_lo is None else K_lo.reshape(-1, N, N).contiguous()
    s = _pow2_jacobi(Kh).contiguous()
    Ah, Al = torch.empty_like(Kh), torch.empty_like(Kh)
    perm = torch.empty((B, N), dtype=torch.int64, device=Kh.device)
    ok = torch.empty(B, dtype=torch.uint8, device=Kh.device)
    if B:
        args = (Kh.data_ptr(), None if Kl is None else Kl.data_ptr(), s.data_ptr(),
                Ah.data_ptr(), Al.data_ptr(), perm.data_ptr(), ok.data_ptr())
        with torch.cuda.device(Kh.device):
            stream = torch.cuda.current_stream().cuda_stream
            if form == "grid":
                words = grid_scratch_words(N)
                scratch = torch.empty((B, words), dtype=torch.float32, device=Kh.device)
                err = lib.df_lu_factor_grid(*args, scratch.data_ptr(), words, B, N,
                                            float(delta), stream)
            else:
                err = lib.df_lu_factor(*args, B, N, float(delta), threads, nbytes, stream)
        if err != 0:
            raise RuntimeError(f"df_lu_factor launch failed: CUDA error {err}")
        factor.launches += 1
    shape = lambda t, *tail: t.reshape(tuple(batch) + tail)
    return (shape(Ah, N, N), shape(Al, N, N), shape(perm, N), shape(s, N)), shape(ok.bool())


def factor(K_hi, K_lo=None, delta=1e-6):
    """Double-float LU with partial pivoting of K = K_hi + K_lo
    ([..., N, N], float32).  Returns ((Ah, Al, perm, s), ok) as
    :func:`factor_plain` does.  A CPU tensor takes the plain version; a CUDA
    tensor launches ``df_lu_factor`` or, above :data:`BLOCK_MAX_DIM`,
    ``df_lu_factor_grid`` (1 + 3·⌈N/8⌉ kernels, counted as one launch) and
    raises if it cannot."""
    _check("K_hi", K_hi, 2)
    if K_lo is not None and (K_lo.shape != K_hi.shape or K_lo.dtype != K_hi.dtype):
        raise ValueError("K_lo must match K_hi in shape and dtype")
    if K_hi.device.type == "cpu":
        return factor_plain(K_hi, K_lo, delta)
    if K_hi.device.type != "cuda":
        raise RuntimeError(f"no double-float LU kernel for device {K_hi.device}")
    from . import build

    return _launch_factor(build.library("df_lu.cu"), K_hi, K_lo, delta)


factor.launches = 0


def solve(factors, rhs):
    """Solve K x = rhs through :func:`factor`'s output; ``rhs`` [..., N] or
    [..., N, R].  A CPU tensor takes the plain version; a CUDA tensor
    launches ``df_lu_solve`` or, above :data:`BLOCK_MAX_DIM`,
    ``df_lu_solve_grid`` (one block per matrix, all R columns) and raises if
    it cannot."""
    Ah, Al, perm, s = factors
    _check("rhs", rhs, 1)
    if Ah.device.type == "cpu":
        return solve_plain(factors, rhs)
    if Ah.device.type != "cuda":
        raise RuntimeError(f"no double-float LU kernel for device {Ah.device}")
    from . import build

    N = Ah.shape[-1]
    vec = rhs.dim() == Ah.dim() - 1
    b = rhs.unsqueeze(-1) if vec else rhs
    R = b.shape[-1]
    shape = torch.broadcast_shapes(Ah.shape[:-2], b.shape[:-2])
    if shape != Ah.shape[:-2]:
        raise ValueError(f"rhs of shape {tuple(rhs.shape)} does not fit factors of "
                         f"{tuple(Ah.shape)}")
    b = b.expand(*shape, N, R).reshape(-1, N, R).contiguous()
    B = b.shape[0]
    form, rc, nbytes = solve_launch(N, R, _smem_capacity())
    lib = build.library("df_lu.cu")
    out = torch.empty_like(b)
    if B:
        args = (Ah.contiguous().data_ptr(), Al.contiguous().data_ptr(),
                perm.contiguous().data_ptr(), s.contiguous().data_ptr(), b.data_ptr(),
                out.data_ptr())
        with torch.cuda.device(Ah.device):
            stream = torch.cuda.current_stream().cuda_stream
            if form == "grid":
                words = grid_solve_scratch_words(N, rc)
                scratch = torch.empty((B, words), dtype=torch.float32, device=b.device)
                err = lib.df_lu_solve_grid(*args, scratch.data_ptr(), words, B, N, R, rc, stream)
            else:
                err = lib.df_lu_solve(*args, B, N, R, rc, nbytes, stream)
        if err != 0:
            raise RuntimeError(f"df_lu_solve launch failed: CUDA error {err}")
        solve.launches += 1
    out = out.reshape(*shape, N, R)
    return out.squeeze(-1) if vec else out


solve.launches = 0
