// Double-float (f32x2) LU with partial pivoting, and its solve, for Hopper
// (sm_90a).
//
// These kernels run clarabel_tpu_torch/kkt/df_ldl.py on the card: the
// factor and the solve of the JAX package's clarabel_tpu/kkt/df_ldl.py,
// which is plain JAX (a fori_loop over the N columns, outside Pallas), so
// they replace no TPU kernel.  In eager PyTorch the same loop is one launch
// per elementwise operation: about 6,000 launches per factor and 8,000 per
// solve at N = 208, which the card runs worst.
//
// Both kernels are bitwise equal to their plain twins (factor_plain and
// solve_plain): every add, subtract, multiply and divide goes through
// __fadd_rn, __fsub_rn, __fmul_rn or __fdiv_rn.  nvcc contracts a*b ± c
// into an FMA by default, which silently breaks Dekker's split and TwoProd
// (the error-free transforms then are not error-free), so nothing here is
// written with the plain operators.
//
// Layout: K_hi, K_lo, Ah, Al [B, N, N] row-major f32; s [B, N] f32 (the
// exact power-of-two scaling, computed by the wrapper as the twin computes
// it); perm [B, N] int64; ok [B] uint8; rhs and out [B, N, R] f32.
//
// Why a reordering stays bitwise equal.  In the twin each trailing entry
// (i, k) receives step j's update as a fixed sequence of rounded operations
// on row i's multiplier at step j and row j's U entry after steps < j.  Which
// thread performs it, and when, does not change the bits as long as every
// entry still sees steps 0, 1, ..., N-1 in order; row swaps move whole rows
// and may be applied late (LAPACK's laswp).  The twin also updates every
// entry outside the trailing block with 0/1 masks.  On finite, normalized
// pairs those updates are identities but for two effects the kernel
// reproduces (step 0 renormalizes row 0's pairs right of the pivot, step 1
// the pivot (0, 0)); otherwise they spread NaN, and only when a factor entry
// or a masked multiplier is non-finite or a value is so large (|x| > 2^115)
// that Dekker's split overflows.  The kernels detect that case per matrix
// and then recompute the matrix along the twin's own masked schedule (the
// "exact" branches below), so the outputs equal the twin's everywhere.
//
// Two forms of each kernel: up to N = 512 the one-block forms below (one
// CTA per matrix); above, the grid forms (sections "Factor, grid form" and
// "Solve, grid form"), which run the same schedules with the trailing
// update spread over the card and the solve's warps looping over their row
// blocks.  The wrapper (df_ldl.factor_launch, solve_launch) picks by N.
//
// Factor: panel-blocked right-looking LU, one CTA per matrix.  For each
// panel of NB = 8 columns (an A/B of 8, 16 and 32 on the H100 chose 8;
// PERF.md):
//   1. the panel's columns, all N rows, are staged in shared memory as
//      (hi, lo) pairs and factored there column by column: the pivot search
//      in the twin's total order (NaN first, then value, then the first
//      index; ranked as unsigned keys and reduced with __reduce_max_sync),
//      the swap inside the panel, the zero-pivot safeguard, the multipliers
//      (and the masked ones of rows <= j, for their finiteness only), and
//      the panel's remaining columns updated pair by pair over all threads
//      with the twin's operation sequence;
//   2. the panel's swaps are applied late to every other column as one
//      permutation of the rows they move (each column's entries read at
//      once, then written), and the panel's NB U rows over the trailing
//      columns are finished in shared memory, one thread per column taking
//      the panel's steps in order;
//   3. the trailing block is updated by register tiles: each thread holds
//      TM x TN pairs, applies the panel's NB rank-1 updates in step order
//      and writes the tile back once.  The multipliers and U rows come from
//      shared memory (broadcast and conflict-free), their Dekker splits are
//      computed once per thread and step.
// Device traffic per panel is the trailing block read and written once,
// against once per column before; `ok` is the finiteness of each entry as
// it is last written.
//
// Solve: one CTA per matrix, warp w owns rows 32w .. 32w + 31 and keeps
// their iterate in registers.  The row-oriented forward and backward
// substitution is blocked by 32: once a row block's values are final, every
// other warp applies its 32 x 32 tile of L (or U) against them in the
// twin's column order, as two 32 x 16 halves staged along rows (coalesced,
// by cp.async), the first before the barrier (both for the warp of the
// next diagonal block, which is on the critical path); that warp then
// solves its diagonal block with shuffles, its tile staged while it applies
// the off-diagonal one.  Half tiles and a 64-register cap let four blocks
// of the entropy batch (N = 208) share an SM.
// Only the triangles are computed; the twin's masked updates are identities
// unless a value is non-finite or huge, and then the block recomputes its
// matrix along the twin's masked schedule.
//
// Bound on the H100 SXM: error-free arithmetic cannot use the FMA, so the
// rate that applies is the non-FMA issue rate, 132 SMs x 128 lanes x
// 1.98 GHz = 33.5 T operations/s (half the 67 TFLOP/s FP32 peak).  The
// factor's trailing update is about 28 operations per entry and step, over
// sum (N-j)^2 ~ N^3/3 entries: 1.29 ms at 512 x 208², and 4.95 ms for one
// 512² matrix on one SM.  The solve is about 42 operations per triangle
// entry and right-hand side over both sweeps, and reads the factor once.
// Spreading one matrix over several SMs (a thread block cluster), for
// batches below the SM count, comes later (ROADMAP Queue 2).

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// Dekker's split constant for f32 (24-bit significand -> 12|12 halves)
constexpr float SPLIT = 4097.0f;
// below this magnitude a * SPLIT cannot overflow (2^115 * 4097 < 2^128)
constexpr float SPLIT_SAFE = 4.1538374868278621e34f;  // 2^115

__device__ __forceinline__ void split(float a, float& hi, float& lo) {
  float c = mul(a, SPLIT);
  hi = sub(c, sub(c, a));
  lo = sub(a, hi);
}

// a·b = p + e exactly, with a = ah + al and b = bh + bl already split
__device__ __forceinline__ void two_prod_split(float a, float ah, float al, float b, float bh,
                                               float bl, float& p, float& e) {
  p = mul(a, b);
  e = add(add(add(sub(mul(ah, bh), p), mul(ah, bl)), mul(al, bh)), mul(al, bl));
}

__device__ __forceinline__ void two_prod(float a, float b, float& p, float& e) {
  float ah, al, bh, bl;
  split(a, ah, al);
  split(b, bh, bl);
  two_prod_split(a, ah, al, b, bh, bl, p, e);
}

// a + b = s + e exactly (Knuth's TwoSum)
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = add(a, b);
  float z = sub(s, a);
  e = add(sub(a, sub(s, z)), sub(b, z));
}

__device__ __forceinline__ void df_add(float ah, float al, float bh, float bl, float& h,
                                       float& l) {
  float sh, se;
  two_sum(ah, bh, sh, se);
  two_sum(sh, add(add(se, al), bl), h, l);
}

__device__ __forceinline__ void df_sub(float ah, float al, float bh, float bl, float& h,
                                       float& l) {
  df_add(ah, al, -bh, -bl, h, l);
}

__device__ __forceinline__ void df_mul(float ah, float al, float bh, float bl, float& h,
                                       float& l) {
  float ph, pe;
  two_prod(ah, bh, ph, pe);
  two_sum(ph, add(add(pe, mul(ah, bl)), mul(al, bh)), h, l);
}

__device__ __forceinline__ void df_div(float nh, float nl, float dh, float dl, float& h,
                                       float& l) {
  float q1 = dvd(nh, dh);
  float ph, pe, rh, re;
  two_prod(q1, dh, ph, pe);
  two_sum(nh, -ph, rh, re);
  float r = add(rh, sub(add(sub(re, pe), nl), mul(q1, dl)));
  float q2 = dvd(r, dh);
  two_sum(q1, q2, h, l);
}

// One step of the twin's trailing update of the pair (a, al): the multiplier
// (lh, ll) with lh split into (lhh, lhl), the U entry (rh, rl) with rh split
// into (rhh, rhl).  TwoProd lh·rh, the cross terms lh·rl + ll·rh, TwoSum
// into a, and the renormalizing TwoSum of the pair.
__device__ __forceinline__ void df_update(float& a, float& al, float lh, float ll, float lhh,
                                          float lhl, float rh, float rl, float rhh, float rhl) {
  float uh, ue;
  two_prod_split(lh, lhh, lhl, rh, rhh, rhl, uh, ue);
  const float cross = add(mul(lh, rl), mul(ll, rh));
  float sh, e1;
  two_sum(a, -uh, sh, e1);
  const float lo = add(al, sub(sub(e1, ue), cross));
  two_sum(sh, lo, a, al);
}

// jnp.argmax's and torch.argmax's order: NaN above every number, the first
// index among equals
__device__ __forceinline__ bool better(float v, int i, float w, int k) {
  bool nv = isnan(v), nw = isnan(w);
  if (nv != nw) return nv;
  if (!nv && v != w) return v > w;
  return i < k;
}

__device__ __forceinline__ bool finite(float v) { return isfinite(v); }

// finite, and small enough that Dekker's split of it cannot overflow
__device__ __forceinline__ bool tame(float h, float l) {
  return fabsf(h) < SPLIT_SAFE && finite(l);
}

// ---------------------------------------------------------------------------
// Factor
// ---------------------------------------------------------------------------

constexpr int TM = 4;  // trailing tile: TM consecutive rows ...
constexpr int TN = 2;  // ... by TN columns 32 apart (a warp covers 32·TN columns)
constexpr int NB = 8;  // the factor's panel width
constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;

// Shared memory of the factor: the panel Ph/Pl [N][NB + 1] (rows padded to
// an odd stride), the panel's U rows Uh/Ul [NB][N - NB] over the trailing
// columns, perm [N] and the panel's row sources src [N] (int).  The exact
// branch reuses the panel's space.
__host__ __device__ constexpr size_t factor_smem_bytes(int N) {
  return ((size_t)2 * N * (NB + 1) + (size_t)2 * NB * (N > NB ? N - NB : 1) + 2 * N) * 4;
}

// the warps' pivot candidates for block_best, for blocks of up to W warps
template <int W>
struct SharedT {
  unsigned red_k[W];
  unsigned red_i[W];
};
using Shared = SharedT<MAX_WARPS>;

// A build with -DDF_LU_PROFILE (scripts/df_lu_phases.py, never the
// wrapper's) adds the factor's first block's clock cycles per part to
// df_lu_cycles, read by df_lu_profile_read: 0 scaling, 1 panels, 2 swaps
// and U rows, 3 trailing updates.  Other builds have neither.
#ifdef DF_LU_PROFILE
__device__ unsigned long long df_lu_cycles[4];
#define PROFILE_MARK(part)                              \
  if (threadIdx.x == 0 && blockIdx.x == 0) {            \
    const long long now = clock64();                    \
    df_lu_cycles[part] += (unsigned long long)(now - t_mark); \
    t_mark = now;                                       \
  }
#else
#define PROFILE_MARK(part)
#endif

// A candidate's rank in `better`'s order as an unsigned key: NaN above every
// number, numbers (>= 0, as |h + l| is) by value, the -1 of no candidate
// last; equal keys go to the smaller index
__device__ __forceinline__ unsigned rank_key(float v) {
  return isnan(v) ? 0xffffffffu : (v < 0.0f ? 0u : __float_as_uint(v) + 1u);
}

// block-wide argmax of (bv, bi) in `better`'s order; every thread returns it
template <class Sh>
__device__ __forceinline__ int block_best(Sh& sh, float bv, int bi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  unsigned key = rank_key(bv);
  unsigned top = __reduce_max_sync(0xffffffffu, key);
  unsigned idx = __reduce_min_sync(0xffffffffu, key == top ? (unsigned)bi : 0xffffffffu);
  if (lane == 0) {
    sh.red_k[warp] = top;
    sh.red_i[warp] = idx;
  }
  __syncthreads();
  // every warp reduces the warps' winners alike
  key = lane < warps ? sh.red_k[lane] : 0u;
  idx = lane < warps ? sh.red_i[lane] : 0xffffffffu;
  top = __reduce_max_sync(0xffffffffu, key);
  return (int)__reduce_min_sync(0xffffffffu, key == top ? idx : 0xffffffffu);
}

// The twin's schedule itself for one matrix, in global memory: every step
// updates every entry with 0/1 masks.  Taken only when the panel-blocked
// schedule saw a non-finite or huge value (ok false); O(N^3) device traffic.
// `smem` is 4N floats of scratch: shared memory in the one-block form,
// device memory in the grid form.
template <class Sh>
__device__ void factor_exact(Sh& sh, float* smem, const float* kh, const float* kl,
                             const float* s, float* ah, float* al, int* pm, int N, float delta,
                             uint8_t* ok) {
  const int tid = threadIdx.x, T = blockDim.x;
  float* colh = smem;  // masked multipliers of every row
  float* coll = colh + N;
  float* rowh = coll + N;  // the masked pivot row
  float* rowl = rowh + N;
  for (size_t e = tid; e < (size_t)N * N; e += T) {
    const int i = (int)(e / N), k = (int)(e % N);
    ah[e] = mul(mul(kh[e], s[i]), s[k]);
    al[e] = kl ? mul(mul(kl[e], s[i]), s[k]) : 0.0f;
  }
  for (int i = tid; i < N; i += T) pm[i] = i;
  __syncthreads();
  for (int j = 0; j < N; ++j) {
    float bv = -1.0f;
    int bi = N;
    for (int i = j + tid; i < N; i += T) {
      const float v = fabsf(add(ah[(size_t)i * N + j], al[(size_t)i * N + j]));
      if (better(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
    const int p = block_best(sh, bv, bi);
    if (p != j) {
      for (int k = tid; k < N; k += T) {
        const size_t ej = (size_t)j * N + k, ep = (size_t)p * N + k;
        const float th = ah[ej], tl = al[ej];
        ah[ej] = ah[ep];
        al[ej] = al[ep];
        ah[ep] = th;
        al[ep] = tl;
      }
      if (tid == 0) {
        const int t = pm[j];
        pm[j] = pm[p];
        pm[p] = t;
      }
    }
    __syncthreads();
    float dh = ah[(size_t)j * N + j], dl = al[(size_t)j * N + j];
    if (dh == 0.0f) {
      dh = delta;
      dl = 0.0f;
    }
    for (int i = tid; i < N; i += T) {
      float lh, ll;
      df_div(ah[(size_t)i * N + j], al[(size_t)i * N + j], dh, dl, lh, ll);
      const float below = i > j ? 1.0f : 0.0f;
      colh[i] = mul(lh, below);
      coll[i] = mul(ll, below);
      rowh[i] = mul(ah[(size_t)j * N + i], below);
      rowl[i] = mul(al[(size_t)j * N + i], below);
    }
    __syncthreads();
    for (size_t e = tid; e < (size_t)N * N; e += T) {
      const int i = (int)(e / N), k = (int)(e % N);
      if (k == j) continue;
      float uh, ue;
      two_prod(colh[i], rowh[k], uh, ue);
      const float cross = add(mul(colh[i], rowl[k]), mul(coll[i], rowh[k]));
      float sh_, e1;
      two_sum(ah[e], -uh, sh_, e1);
      const float lo = add(al[e], sub(sub(e1, ue), cross));
      two_sum(sh_, lo, ah[e], al[e]);
    }
    // column j: the multipliers below the diagonal, rows <= j as they were
    for (int i = j + 1 + tid; i < N; i += T) {
      ah[(size_t)i * N + j] = colh[i];
      al[(size_t)i * N + j] = coll[i];
    }
    __syncthreads();
  }
  bool fin = true;
  for (size_t e = tid; e < (size_t)N * N; e += T) fin = fin && finite(ah[e]) && finite(al[e]);
  const int all_fin = __syncthreads_and(fin);
  if (tid == 0) *ok = all_fin ? 1 : 0;
}

__global__ void __launch_bounds__(MAX_THREADS)
    df_lu_factor_kernel(const float* __restrict__ Kh, const float* __restrict__ Kl,
                        const float* __restrict__ S, float* __restrict__ Ah,
                        float* __restrict__ Al, long long* __restrict__ perm,
                        uint8_t* __restrict__ ok, int N, float delta) {
  constexpr int PS = NB + 1;  // panel row stride (odd: conflict-free columns)
  extern __shared__ float smem[];
  __shared__ Shared sh;
  __shared__ int piv[NB];
  // the rows the panel's swaps move (its own rows first, then the rows it
  // swapped in from below) and, for each, the index in moved[] of the row
  // that receives its entries
  __shared__ int moved[2 * NB], to[2 * NB], nmoved;
  const int UW = N > NB ? N - NB : 1;
  float* ph = smem;
  float* pl = ph + (size_t)N * PS;
  float* uh = pl + (size_t)N * PS;
  float* ul = uh + (size_t)NB * UW;
  int* pm = reinterpret_cast<int*>(ul + (size_t)NB * UW);
  int* src = pm + N;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, warps = T >> 5;
  const size_t off = (size_t)b * N * N;
  const float* kh = Kh + off;
  const float* kl = Kl ? Kl + off : nullptr;
  const float* s = S + (size_t)b * N;
  float* ah = Ah + off;
  float* al = Al + off;
#ifdef DF_LU_PROFILE
  long long t_mark = clock64();
#endif

  // the exact power-of-two scaling (K * s_i) * s_k
  for (int i = warp; i < N; i += warps) {
    const float si = s[i];
    for (int k = lane; k < N; k += 32) {
      const size_t e = (size_t)i * N + k;
      ah[e] = mul(mul(kh[e], si), s[k]);
      al[e] = kl ? mul(mul(kl[e], si), s[k]) : 0.0f;
    }
  }
  for (int i = tid; i < N; i += T) pm[i] = i;
  bool fin = true;   // every entry finite as it is last written
  bool tamed = true;  // no masked multiplier of a row <= j non-finite
  __syncthreads();
  PROFILE_MARK(0);

  for (int j0 = 0; j0 < N; j0 += NB) {
    const int w = min(NB, N - j0);
    const int c0 = j0 + w;  // first trailing row and column

    // 1. the panel, all N rows (rows < j0 hold final U entries, read for
    //    the masked multipliers only)
    for (int e = tid; e < N * w; e += T) {
      const int i = e / w, c = e % w;
      ph[i * PS + c] = ah[(size_t)i * N + j0 + c];
      pl[i * PS + c] = al[(size_t)i * N + j0 + c];
    }
    for (int i = j0 + tid; i < N; i += T) src[i] = i;
    __syncthreads();

    for (int c = 0; c < w; ++c) {
      const int j = j0 + c;
      float bv = -1.0f;
      int bi = N;
      // each thread reads the rows whose column c it updated at the step
      // before (rows j + tid, j + tid + T, ...): no barrier in between
      for (int i = j + tid; i < N; i += T) {
        const float v = fabsf(add(ph[i * PS + c], pl[i * PS + c]));
        if (better(v, i, bv, bi)) {
          bv = v;
          bi = i;
        }
      }
      const int p = block_best(sh, bv, bi);
      if (p != j && tid < w) {
        const float th = ph[j * PS + tid], tl = pl[j * PS + tid];
        ph[j * PS + tid] = ph[p * PS + tid];
        pl[j * PS + tid] = pl[p * PS + tid];
        ph[p * PS + tid] = th;
        pl[p * PS + tid] = tl;
      }
      if (tid == 32) {
        piv[c] = p;
        int t = pm[j];
        pm[j] = pm[p];
        pm[p] = t;
        t = src[j];
        src[j] = src[p];
        src[p] = t;
      }
      // the twin renormalizes row 0's pairs right of the pivot at step 0
      // (after using them) and the pivot (0, 0) at step 1
      if (j == 1 && tid >= 64 && tid < 64 + w) {
        float h, l;
        two_sum(ph[tid - 64], pl[tid - 64], h, l);
        ph[tid - 64] = h;
        pl[tid - 64] = l;
      }
      __syncthreads();

      float dh = ph[j * PS + c], dl = pl[j * PS + c];
      if (dh == 0.0f) {
        dh = delta;
        dl = 0.0f;
      }
      // the multipliers of rows > j; those of rows <= j, which the twin
      // masks (lh·0: NaN when lh is not finite), for their finiteness only
      for (int i = tid; i < N; i += T) {
        float lh, ll;
        df_div(ph[i * PS + c], pl[i * PS + c], dh, dl, lh, ll);
        if (i > j) {
          ph[i * PS + c] = lh;
          pl[i * PS + c] = ll;
        } else {
          tamed = tamed && finite(lh) && finite(ll);
        }
      }
      __syncthreads();
      // the panel's columns right of c, rows > j: pair q covers row
      // j + 1 + q % rows of column c + 1 + q / rows, so column c + 1 of row
      // j + 1 + t + k·T falls to thread t, which searches those rows next
      const int rows = N - 1 - j, pairs = rows * (w - 1 - c);
      if (pairs > 0) {
        int ri = tid % rows, ci = tid / rows;
        const int dri = T % rows, dci = T / rows;
        for (int q = tid; q < pairs; q += T) {
          const int i = j + 1 + ri, cc = c + 1 + ci;
          const float lh = ph[i * PS + c], ll = pl[i * PS + c];
          const float rh = ph[j * PS + cc], rl = pl[j * PS + cc];
          float lhh, lhl, rhh, rhl;
          split(lh, lhh, lhl);
          split(rh, rhh, rhl);
          df_update(ph[i * PS + cc], pl[i * PS + cc], lh, ll, lhh, lhl, rh, rl, rhh, rhl);
          ri += dri;
          ci += dci;
          if (ri >= rows) {
            ri -= rows;
            ++ci;
          }
        }
      }
    }
    __syncthreads();
    PROFILE_MARK(1);

    // the panel's rows >= j0 are final: L below the diagonal, U on and above
    for (int e = tid; e < (N - j0) * w; e += T) {
      const int i = j0 + e / w, c = e % w;
      const float h = ph[i * PS + c], l = pl[i * PS + c];
      ah[(size_t)i * N + j0 + c] = h;
      al[(size_t)i * N + j0 + c] = l;
      fin = fin && finite(h) && finite(l);
    }
    if (warp == 0) {
      // the rows swapped in from below the panel, each once, in pivot order
      const int p = lane < w ? piv[lane] : -1;
      bool ext = p >= c0;
      for (int c = 0; c < w; ++c) {
        const int q = __shfl_sync(0xffffffffu, p, c);
        ext = ext && !(c < lane && q == p);
      }
      const unsigned found = __ballot_sync(0xffffffffu, ext);
      const int n = w + __popc(found);
      if (ext) moved[w + __popc(found & ((1u << lane) - 1u))] = p;
      if (lane < w) moved[lane] = j0 + lane;
      __syncwarp();
      // moved[m]'s entries go to row moved[to[m]]
      for (int d = lane; d < n; d += 32) {
        const int r = src[moved[d]];
        int f = r - j0;
        if (r >= c0)
          for (int q = w; q < n; ++q)
            if (moved[q] == r) f = q;
        to[f] = d;
      }
      if (lane == 0) nmoved = n;
    }
    __syncthreads();

    // 2. the panel's swaps on every other column: the moved rows' entries
    //    read at once, then written where the swaps take them; over the
    //    trailing columns the panel's own rows go to Uh/Ul
    const int nm = nmoved;
    const int M = N - c0;
    for (int k = tid; k < N; k += T) {
      if (k >= j0 && k < c0) continue;
      float oh[2 * NB], ol[2 * NB];
#pragma unroll
      for (int m = 0; m < 2 * NB; ++m) {
        if (m < nm) {
          oh[m] = ah[(size_t)moved[m] * N + k];
          ol[m] = al[(size_t)moved[m] * N + k];
        }
      }
#pragma unroll
      for (int m = 0; m < 2 * NB; ++m) {
        if (m < nm) {
          const int d = to[m];
          if (k >= c0 && d < w) {
            uh[d * UW + (k - c0)] = oh[m];
            ul[d * UW + (k - c0)] = ol[m];
          } else {
            ah[(size_t)moved[d] * N + k] = oh[m];
            al[(size_t)moved[d] * N + k] = ol[m];
          }
        }
      }
    }
    __syncthreads();
    //    the U rows: each thread sweeps its columns, applying the panel's
    //    step t to the rows below t in step order, and writes them out
    for (int kk = tid; kk < M; kk += T) {
      for (int t = 0; t + 1 < w; ++t) {
        const float rh = uh[t * UW + kk], rl = ul[t * UW + kk];
        float rhh, rhl;
        split(rh, rhh, rhl);
        for (int r = t + 1; r < w; ++r) {
          const float lh = ph[(j0 + r) * PS + t], ll = pl[(j0 + r) * PS + t];
          float lhh, lhl;
          split(lh, lhh, lhl);
          df_update(uh[r * UW + kk], ul[r * UW + kk], lh, ll, lhh, lhl, rh, rl, rhh, rhl);
        }
      }
      for (int r = 0; r < w; ++r) {
        float h = uh[r * UW + kk], l = ul[r * UW + kk];
        if (j0 + r == 0) two_sum(uh[kk], ul[kk], h, l);
        ah[(size_t)(j0 + r) * N + c0 + kk] = h;
        al[(size_t)(j0 + r) * N + c0 + kk] = l;
        fin = fin && finite(h) && finite(l);
      }
    }
    __syncthreads();
    PROFILE_MARK(2);

    // 3. the trailing block: TM x TN register tiles, w delayed steps each
    if (M > 0) {
      const int row_tiles = (M + TM - 1) / TM;
      const int col_groups = (M + 32 * TN - 1) / (32 * TN);
      for (int task = warp; task < row_tiles * col_groups; task += warps) {
        const int i0 = c0 + (task / col_groups) * TM;
        const int kb = (task % col_groups) * 32 * TN + lane;  // column - c0
        float th[TM][TN], tl[TM][TN];
#pragma unroll
        for (int m = 0; m < TM; ++m)
#pragma unroll
          for (int n = 0; n < TN; ++n) {
            const int i = i0 + m, k = kb + 32 * n;
            const bool in = i < N && k < M;
            th[m][n] = in ? ah[(size_t)i * N + c0 + k] : 0.0f;
            tl[m][n] = in ? al[(size_t)i * N + c0 + k] : 0.0f;
          }
        for (int t = 0; t < w; ++t) {
          float rh[TN], rl[TN], rhh[TN], rhl[TN];
#pragma unroll
          for (int n = 0; n < TN; ++n) {
            const int k = kb + 32 * n;
            rh[n] = k < M ? uh[t * UW + k] : 0.0f;
            rl[n] = k < M ? ul[t * UW + k] : 0.0f;
            split(rh[n], rhh[n], rhl[n]);
          }
#pragma unroll
          for (int m = 0; m < TM; ++m) {
            const int i = min(i0 + m, N - 1);
            const float lh = ph[i * PS + t], ll = pl[i * PS + t];
            float lhh, lhl;
            split(lh, lhh, lhl);
#pragma unroll
            for (int n = 0; n < TN; ++n)
              df_update(th[m][n], tl[m][n], lh, ll, lhh, lhl, rh[n], rl[n], rhh[n], rhl[n]);
          }
        }
#pragma unroll
        for (int m = 0; m < TM; ++m)
#pragma unroll
          for (int n = 0; n < TN; ++n) {
            const int i = i0 + m, k = kb + 32 * n;
            if (i < N && k < M) {
              ah[(size_t)i * N + c0 + k] = th[m][n];
              al[(size_t)i * N + c0 + k] = tl[m][n];
            }
          }
      }
    }
    __syncthreads();
    PROFILE_MARK(3);
  }

  const int good = __syncthreads_and(fin && tamed);
  if (good) {
    for (int i = tid; i < N; i += T) perm[(size_t)b * N + i] = pm[i];
    if (tid == 0) ok[b] = 1;
    return;
  }
  factor_exact(sh, smem, kh, kl, s, ah, al, pm, N, delta, ok + b);
  __syncthreads();
  for (int i = tid; i < N; i += T) perm[(size_t)b * N + i] = pm[i];
}

// ---------------------------------------------------------------------------
// Factor, grid form (N > 512): one matrix spread over the card
// ---------------------------------------------------------------------------
//
// The one-block form runs the whole factor on one SM: 28·N³/3 operations at
// 128 lanes, 39.6 ms at N = 1024 and 604 ms at N = 2540, where the card's
// floor is 0.30 and 4.57 ms.  The grid form runs the same panel-blocked
// schedule (the same NB = 8 panels, the same operations in the same order
// for every entry, the same tests for the exact branch) as a sequence of
// launches per panel, the trailing block spread over the card:
//   panel     one block per matrix: the panel's columns, all N rows, staged
//             column-major in device memory (L2-resident: 2540 x 8 pairs is
//             163 KB) and factored column by column as in the one-block form;
//   swaps     a thread per column outside the panel: the panel's swaps
//             applied late, and over the trailing columns the panel's U
//             rows finished in the panel's step order;
//   trailing  a 2-D grid of 32 x 64 tiles: every entry takes the panel's NB
//             updates in registers, in step order, between one read and one
//             write.
// NB = 8 is the one-block form's panel width, and the grid form's too: per
// entry and panel the trailing launch moves 16 bytes for 8 x 28 operations,
// 14 operations a byte, above the card's non-FMA 33.5 T operations/s over
// 3.35 TB/s (10 a byte), so the trailing update stays bound by arithmetic;
// a wider panel adds to the serial panel launch (N·NB²/2 pair updates per
// panel on one SM, 2.9 ms per factor at N = 2540 for NB = 8) more than it
// saves in launches (3 per panel).  With a scale launch before the panels,
// a finish launch after them (the permutation and `ok`, or the exact branch
// on one block per matrix) and no trailing launch after the last panel,
// that makes 1 + 3·⌈N/8⌉ launches per factor, issued by df_lu_factor_grid
// on the caller's stream.
//
// Per-matrix scratch in device memory (grid_scratch_words floats): the
// panel Ph/Pl [NB][N] (column-major), the U rows Uh/Ul [NB][N] as the
// trailing update reads them (row 0 before its renormalization), pm [N]
// and piv [NB] (int), and two flags (int): every entry finite as it is
// last written, and no masked multiplier non-finite.  The exact branch
// reuses the panel's space.

constexpr int GRID_THREADS = 1024;  // the panel and finish launches' blocks
constexpr int GRID_WARPS = GRID_THREADS / 32;
constexpr int SWAP_THREADS = 128;
constexpr int TILE_ROWS = 32;       // trailing tile: 8 warps x TM rows ...
constexpr int TILE_COLS = 32 * TN;  // ... by a warp's 32·TN columns
constexpr int TILE_THREADS = 32 * (TILE_ROWS / TM);

__host__ __device__ constexpr size_t grid_scratch_words(int N) {
  return (size_t)4 * NB * N + N + NB + 2;
}

struct GridScratch {
  float *ph, *pl, *uh, *ul;
  int *pm, *piv, *flags;
  __device__ GridScratch(float* scratch, int N) {
    float* base = scratch + (size_t)blockIdx.z * grid_scratch_words(N);
    ph = base;
    pl = ph + (size_t)NB * N;
    uh = pl + (size_t)NB * N;
    ul = uh + (size_t)NB * N;
    pm = reinterpret_cast<int*>(ul + (size_t)NB * N);
    piv = pm + N;
    flags = piv + NB;
  }
};

// (K * s_i) * s_k, as the one-block form scales; the identity permutation
// and both flags set.  Grid (any, 1, B).
__global__ void df_lu_grid_scale_kernel(const float* __restrict__ Kh,
                                        const float* __restrict__ Kl,
                                        const float* __restrict__ S, float* __restrict__ Ah,
                                        float* __restrict__ Al, float* scratch, int N) {
  GridScratch g(scratch, N);
  const size_t off = (size_t)blockIdx.z * N * N;
  const float* s = S + (size_t)blockIdx.z * N;
  const size_t NN = (size_t)N * N;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < NN;
       e += (size_t)gridDim.x * blockDim.x) {
    const int i = (int)(e / N), k = (int)(e % N);
    Ah[off + e] = mul(mul(Kh[off + e], s[i]), s[k]);
    Al[off + e] = Kl ? mul(mul(Kl[off + e], s[i]), s[k]) : 0.0f;
  }
  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i < N; i += blockDim.x) g.pm[i] = i;
    if (threadIdx.x < 2) g.flags[threadIdx.x] = 1;
  }
}

// The panel j0 .. j0 + w - 1 of every matrix, one block each (grid (1, 1,
// B)): the one-block form's step 1 on the column-major panel in device
// memory, then the panel's rows >= j0 written back.
__global__ void __launch_bounds__(GRID_THREADS)
    df_lu_grid_panel_kernel(float* __restrict__ Ah, float* __restrict__ Al, float* scratch,
                            int N, int j0, float delta) {
  __shared__ SharedT<GRID_WARPS> sh;
  GridScratch g(scratch, N);
  float* ph = g.ph;
  float* pl = g.pl;
  const size_t off = (size_t)blockIdx.z * N * N;
  float* ah = Ah + off;
  float* al = Al + off;
  const int tid = threadIdx.x, T = blockDim.x;
  const int w = min(NB, N - j0);

  for (int e = tid; e < N * w; e += T) {
    const int i = e / w, c = e % w;
    ph[(size_t)c * N + i] = ah[(size_t)i * N + j0 + c];
    pl[(size_t)c * N + i] = al[(size_t)i * N + j0 + c];
  }
  bool fin = true, tamed = true;
  __syncthreads();

  for (int c = 0; c < w; ++c) {
    const int j = j0 + c;
    float* colh = ph + (size_t)c * N;
    float* coll = pl + (size_t)c * N;
    float bv = -1.0f;
    int bi = N;
    // each thread reads the rows whose column c it updated at the step
    // before, as in the one-block form
    for (int i = j + tid; i < N; i += T) {
      const float v = fabsf(add(colh[i], coll[i]));
      if (better(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
    const int p = block_best(sh, bv, bi);
    if (p != j && tid < w) {
      const size_t cj = (size_t)tid * N + j, cp = (size_t)tid * N + p;
      const float th = ph[cj], tl = pl[cj];
      ph[cj] = ph[cp];
      pl[cj] = pl[cp];
      ph[cp] = th;
      pl[cp] = tl;
    }
    if (tid == 32) {
      g.piv[c] = p;
      const int t = g.pm[j];
      g.pm[j] = g.pm[p];
      g.pm[p] = t;
    }
    // row 0's pairs of the first panel: renormalized by the twin's step 0
    // right of the pivot and at step 1 on it
    if (j == 1 && tid >= 64 && tid < 64 + w) {
      float h, l;
      two_sum(ph[(size_t)(tid - 64) * N], pl[(size_t)(tid - 64) * N], h, l);
      ph[(size_t)(tid - 64) * N] = h;
      pl[(size_t)(tid - 64) * N] = l;
    }
    __syncthreads();

    float dh = colh[j], dl = coll[j];
    if (dh == 0.0f) {
      dh = delta;
      dl = 0.0f;
    }
    for (int i = tid; i < N; i += T) {
      float lh, ll;
      df_div(colh[i], coll[i], dh, dl, lh, ll);
      if (i > j) {
        colh[i] = lh;
        coll[i] = ll;
      } else {
        tamed = tamed && finite(lh) && finite(ll);
      }
    }
    __syncthreads();
    const int rows = N - 1 - j, pairs = rows * (w - 1 - c);
    if (pairs > 0) {
      int ri = tid % rows, ci = tid / rows;
      const int dri = T % rows, dci = T / rows;
      for (int q = tid; q < pairs; q += T) {
        const int i = j + 1 + ri;
        const size_t cc = (size_t)(c + 1 + ci) * N;
        const float lh = colh[i], ll = coll[i];
        const float rh = ph[cc + j], rl = pl[cc + j];
        float lhh, lhl, rhh, rhl;
        split(lh, lhh, lhl);
        split(rh, rhh, rhl);
        df_update(ph[cc + i], pl[cc + i], lh, ll, lhh, lhl, rh, rl, rhh, rhl);
        ri += dri;
        ci += dci;
        if (ri >= rows) {
          ri -= rows;
          ++ci;
        }
      }
    }
  }
  __syncthreads();

  for (int e = tid; e < (N - j0) * w; e += T) {
    const int i = j0 + e / w, c = e % w;
    const float h = ph[(size_t)c * N + i], l = pl[(size_t)c * N + i];
    ah[(size_t)i * N + j0 + c] = h;
    al[(size_t)i * N + j0 + c] = l;
    fin = fin && finite(h) && finite(l);
  }
  const bool all_fin = __syncthreads_and(fin);
  const bool all_tamed = __syncthreads_and(tamed);
  if (tid == 0) {
    if (!all_fin) g.flags[0] = 0;
    if (!all_tamed) g.flags[1] = 0;
  }
}

// The panel j0's swaps on every column outside it, a thread per column
// (grid (⌈(N - w) / SWAP_THREADS⌉, 1, B)): the moved rows' entries read at
// once, then written where the swaps take them; over the trailing columns
// the panel's own rows are its U rows, which the thread finishes in the
// panel's step order and writes to the factor (row 0 renormalized, as the
// twin's step 0 leaves it) and, as the trailing launch reads them, to Uh/Ul.
__global__ void __launch_bounds__(SWAP_THREADS)
    df_lu_grid_swap_kernel(float* __restrict__ Ah, float* __restrict__ Al, float* scratch, int N,
                           int j0) {
  __shared__ int moved[2 * NB], to[2 * NB], nmoved;
  __shared__ float Lh[NB][NB], Ll[NB][NB];
  __shared__ float Sh[NB][SWAP_THREADS], Sl[NB][SWAP_THREADS];
  GridScratch g(scratch, N);
  const size_t off = (size_t)blockIdx.z * N * N;
  float* ah = Ah + off;
  float* al = Al + off;
  const int tid = threadIdx.x;
  const int w = min(NB, N - j0), c0 = j0 + w;

  if (tid == 0) {
    // the panel's rows, then the rows it swapped in from below, each once,
    // in pivot order; src[d] is the index in moved[] of the row whose
    // entries end in moved[d]
    int n = w, src[2 * NB];
    for (int c = 0; c < w; ++c) moved[c] = j0 + c;
    for (int c = 0; c < w; ++c) {
      const int p = g.piv[c];
      bool seen = p < c0;
      for (int q = w; q < n; ++q) seen = seen || moved[q] == p;
      if (!seen) moved[n++] = p;
    }
    for (int d = 0; d < n; ++d) src[d] = d;
    for (int c = 0; c < w; ++c) {
      const int p = g.piv[c];
      int f = p - j0;
      if (p >= c0)
        for (int q = w; q < n; ++q)
          if (moved[q] == p) f = q;
      const int t = src[c];
      src[c] = src[f];
      src[f] = t;
    }
    // moved[m]'s entries go to row moved[to[m]]
    for (int d = 0; d < n; ++d) to[src[d]] = d;
    nmoved = n;
  }
  if (tid < w * w) {
    const int r = tid / w, t = tid % w;
    Lh[r][t] = g.ph[(size_t)t * N + j0 + r];
    Ll[r][t] = g.pl[(size_t)t * N + j0 + r];
  }
  __syncthreads();

  const int kk = blockIdx.x * SWAP_THREADS + tid;
  const bool active = kk < N - w;
  const int k = kk < j0 ? kk : kk + w;
  const bool upper = active && k >= c0;
  const int nm = nmoved;
  if (active) {
    float oh[2 * NB], ol[2 * NB];
#pragma unroll
    for (int m = 0; m < 2 * NB; ++m) {
      if (m < nm) {
        oh[m] = ah[(size_t)moved[m] * N + k];
        ol[m] = al[(size_t)moved[m] * N + k];
      }
    }
#pragma unroll
    for (int m = 0; m < 2 * NB; ++m) {
      if (m < nm) {
        const int d = to[m];
        if (upper && d < w) {
          Sh[d][tid] = oh[m];
          Sl[d][tid] = ol[m];
        } else {
          ah[(size_t)moved[d] * N + k] = oh[m];
          al[(size_t)moved[d] * N + k] = ol[m];
        }
      }
    }
  }
  bool fin = true;
  if (upper) {
    for (int t = 0; t + 1 < w; ++t) {
      const float rh = Sh[t][tid], rl = Sl[t][tid];
      float rhh, rhl;
      split(rh, rhh, rhl);
      for (int r = t + 1; r < w; ++r) {
        const float lh = Lh[r][t], ll = Ll[r][t];
        float lhh, lhl;
        split(lh, lhh, lhl);
        df_update(Sh[r][tid], Sl[r][tid], lh, ll, lhh, lhl, rh, rl, rhh, rhl);
      }
    }
    for (int r = 0; r < w; ++r) {
      float h = Sh[r][tid], l = Sl[r][tid];
      g.uh[(size_t)r * N + k] = h;
      g.ul[(size_t)r * N + k] = l;
      if (j0 + r == 0) two_sum(Sh[r][tid], Sl[r][tid], h, l);
      ah[(size_t)(j0 + r) * N + k] = h;
      al[(size_t)(j0 + r) * N + k] = l;
      fin = fin && finite(h) && finite(l);
    }
  }
  if (!__syncthreads_and(fin) && tid == 0) g.flags[0] = 0;
}

// The trailing block of the panel j0, a TILE_ROWS x TILE_COLS tile per
// block (grid (⌈M / TILE_COLS⌉, ⌈M / TILE_ROWS⌉, B), M = N - j0 - w): the
// tile's multipliers and U entries staged in shared memory, then each
// thread's TM x TN pairs take the panel's w updates in step order, as the
// one-block form's step 3 gives them.
__global__ void __launch_bounds__(TILE_THREADS)
    df_lu_grid_trailing_kernel(float* __restrict__ Ah, float* __restrict__ Al, float* scratch,
                               int N, int j0) {
  __shared__ float Lh[NB][TILE_ROWS], Ll[NB][TILE_ROWS];
  __shared__ float Rh[NB][TILE_COLS], Rl[NB][TILE_COLS];
  GridScratch g(scratch, N);
  const size_t off = (size_t)blockIdx.z * N * N;
  float* ah = Ah + off;
  float* al = Al + off;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int w = min(NB, N - j0), c0 = j0 + w;
  const int r0 = c0 + blockIdx.y * TILE_ROWS;  // the tile's first row
  const int k0 = c0 + blockIdx.x * TILE_COLS;  // and first column

  for (int e = tid; e < w * TILE_ROWS; e += TILE_THREADS) {
    const int t = e / TILE_ROWS, r = e % TILE_ROWS;
    const int i = min(r0 + r, N - 1);
    Lh[t][r] = g.ph[(size_t)t * N + i];
    Ll[t][r] = g.pl[(size_t)t * N + i];
  }
  for (int e = tid; e < w * TILE_COLS; e += TILE_THREADS) {
    const int t = e / TILE_COLS, c = e % TILE_COLS;
    const int k = k0 + c;
    Rh[t][c] = k < N ? g.uh[(size_t)t * N + k] : 0.0f;
    Rl[t][c] = k < N ? g.ul[(size_t)t * N + k] : 0.0f;
  }
  __syncthreads();

  const int m0 = warp * TM;  // the thread's rows in the tile ...
  float th[TM][TN], tl[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) {  // ... and its columns, 32 apart
      const int i = r0 + m0 + m, k = k0 + lane + 32 * n;
      const bool in = i < N && k < N;
      th[m][n] = in ? ah[(size_t)i * N + k] : 0.0f;
      tl[m][n] = in ? al[(size_t)i * N + k] : 0.0f;
    }
  for (int t = 0; t < w; ++t) {
    float rh[TN], rl[TN], rhh[TN], rhl[TN];
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      rh[n] = Rh[t][lane + 32 * n];
      rl[n] = Rl[t][lane + 32 * n];
      split(rh[n], rhh[n], rhl[n]);
    }
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const float lh = Lh[t][m0 + m], ll = Ll[t][m0 + m];
      float lhh, lhl;
      split(lh, lhh, lhl);
#pragma unroll
      for (int n = 0; n < TN; ++n)
        df_update(th[m][n], tl[m][n], lh, ll, lhh, lhl, rh[n], rl[n], rhh[n], rhl[n]);
    }
  }
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const int i = r0 + m0 + m, k = k0 + lane + 32 * n;
      if (i < N && k < N) {
        ah[(size_t)i * N + k] = th[m][n];
        al[(size_t)i * N + k] = tl[m][n];
      }
    }
}

// After the last panel (grid (1, 1, B)): the permutation and `ok` of a
// matrix whose flags held; otherwise the exact branch recomputes it along
// the twin's masked schedule, on this one block.
__global__ void __launch_bounds__(GRID_THREADS)
    df_lu_grid_finish_kernel(const float* __restrict__ Kh, const float* __restrict__ Kl,
                             const float* __restrict__ S, float* __restrict__ Ah,
                             float* __restrict__ Al, long long* __restrict__ perm,
                             uint8_t* __restrict__ ok, float* scratch, int N, float delta) {
  __shared__ SharedT<GRID_WARPS> sh;
  GridScratch g(scratch, N);
  const int b = blockIdx.z;
  if (!(g.flags[0] && g.flags[1])) {
    const size_t off = (size_t)b * N * N;
    factor_exact(sh, g.ph, Kh + off, Kl ? Kl + off : nullptr, S + (size_t)b * N, Ah + off,
                 Al + off, g.pm, N, delta, ok + b);
    __syncthreads();
  } else if (threadIdx.x == 0) {
    ok[b] = 1;
  }
  for (int i = threadIdx.x; i < N; i += blockDim.x) perm[(size_t)b * N + i] = g.pm[i];
}

// ---------------------------------------------------------------------------
// Solve
// ---------------------------------------------------------------------------

constexpr int TP = 33;   // diagonal tile row stride (odd: conflict-free columns)
constexpr int HP = 17;   // half tile row stride
constexpr int MAX_BLOCKS = MAX_THREADS / 32;  // the one-block form's row blocks: N <= 512

// Shared memory of the solve: a 32 x 16 (hi, lo) half tile per warp and two
// more for the next diagonal block's warp (used in turn), a 32 x 32 tile
// for the diagonal block, and the iterate with its hi parts split (yh, yl,
// yhh, yhl) [N][RC].  Four blocks of the entropy batch's N = 208 fit an SM.
__host__ __device__ constexpr size_t solve_smem_bytes(int N, int RC) {
  return ((size_t)((N + 31) / 32 + 2) * 2 * 32 * HP + (size_t)2 * 32 * TP +
          (size_t)4 * N * RC) * 4;
}

// Rows 32·I.., columns c0 .. c0 + C - 1 of the factor into a tile of row
// stride P, copied asynchronously (cp.async, no registers held) and
// committed as one group; entries past N are zeros.  The warp waits
// (tile_ready) before it reads the tile, and checks each entry's
// finiteness as it reads it.
template <int C, int P>
__device__ __forceinline__ void stage_tile(float* th, float* tl, const float* ah,
                                           const float* al, int N, int I, int c0) {
  constexpr int ROWS = 32 / C;  // rows per pass of the warp
  const int lane = threadIdx.x & 31;
  const int k = c0 + lane % C;
  __syncwarp();
  for (int r = lane / C; r < 32; r += ROWS) {
    const int i = 32 * I + r;
    float* dh = th + r * P + lane % C;
    float* dl = tl + r * P + lane % C;
    if (i < N && k < N) {
      __pipeline_memcpy_async(dh, ah + (size_t)i * N + k, 4);
      __pipeline_memcpy_async(dl, al + (size_t)i * N + k, 4);
    } else {
      *dh = 0.0f;
      *dl = 0.0f;
    }
  }
  __pipeline_commit();
}

__device__ __forceinline__ void tile_ready(int pending) {
  __pipeline_wait_prior(pending);
  __syncwarp();
}

// The twin's schedule itself for one matrix and right-hand sides c0..c0+rc-1
// (the columns of a solve are independent), run by one warp: every step
// updates every row with 0/1 masks.  Taken only when the blocked schedule
// saw a non-finite or huge value.
template <int RC>
__device__ void solve_exact(float* yh, float* yl, const float* ah, const float* al,
                            const long long* pm, const float* s, const float* r, float* o,
                            int N, int R, int c0, int rc) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < N; i += 32) {
    const long long pi = pm[i];
    for (int c = 0; c < rc; ++c) {
      yh[i * RC + c] = mul(r[pi * R + c0 + c], s[pi]);
      yl[i * RC + c] = 0.0f;
    }
  }
  __syncwarp();
  for (int j = 0; j < N; ++j) {
    float jh[RC], jl[RC];
    for (int c = 0; c < rc; ++c) {
      jh[c] = yh[j * RC + c];
      jl[c] = yl[j * RC + c];
    }
    __syncwarp();
    for (int i = lane; i < N; i += 32) {
      const float below = i > j ? 1.0f : 0.0f;
      const size_t ei = (size_t)i * N + j;
      for (int c = 0; c < rc; ++c) {
        float uh, ul;
        df_mul(mul(ah[ei], below), mul(al[ei], below), jh[c], jl[c], uh, ul);
        df_sub(yh[i * RC + c], yl[i * RC + c], uh, ul, yh[i * RC + c], yl[i * RC + c]);
      }
    }
    __syncwarp();
  }
  for (int j = N - 1; j >= 0; --j) {
    float jh[RC], jl[RC];
    const size_t ejj = (size_t)j * N + j;
    for (int c = 0; c < rc; ++c)
      df_div(yh[j * RC + c], yl[j * RC + c], ah[ejj], al[ejj], jh[c], jl[c]);
    __syncwarp();
    for (int i = lane; i < N; i += 32) {
      const float above = i < j ? 1.0f : 0.0f;
      const float keep = i == j ? 1.0f : 0.0f;
      const float drop = sub(1.0f, keep);
      const size_t ei = (size_t)i * N + j;
      for (int c = 0; c < rc; ++c) {
        // row j holds x_j before the update, as in the twin
        const float xh = i == j ? jh[c] : yh[i * RC + c];
        const float xl = i == j ? jl[c] : yl[i * RC + c];
        float ph_, pl_, nh, nl;
        df_mul(mul(ah[ei], above), mul(al[ei], above), jh[c], jl[c], ph_, pl_);
        df_sub(xh, xl, ph_, pl_, nh, nl);
        yh[i * RC + c] = add(mul(nh, drop), mul(xh, keep));
        yl[i * RC + c] = add(mul(nl, drop), mul(xl, keep));
      }
    }
    __syncwarp();
  }
  for (int i = lane; i < N; i += 32)
    for (int c = 0; c < rc; ++c)
      o[i * R + c0 + c] = mul(add(yh[i * RC + c], yl[i * RC + c]), s[i]);
  __syncwarp();
}

// y_i -= L_ij·y_j (forward) or x_i -= U_ij·x_j (backward) for the columns
// j = j0 + jj of a staged half tile, jj in the twin's order (ascending
// forward, descending backward): df_mul then df_sub, with L_ij's split
// taken once for every right-hand side and y_j's hi part split beforehand
template <int RC, bool FORWARD>
__device__ __forceinline__ void apply_half(const float* th, const float* tl, const float* yh,
                                           const float* yl, const float* yhh,
                                           const float* yhl, int j0, int cols, float (&xh)[RC],
                                           float (&xl)[RC], bool& fin) {
  const int lane = threadIdx.x & 31;
#pragma unroll 4
  for (int q = 0; q < cols; ++q) {
    const int jj = FORWARD ? q : cols - 1 - q;
    const int j = j0 + jj;
    const float uh = th[lane * HP + jj], ul = tl[lane * HP + jj];
    fin = fin && finite(uh) && finite(ul);
    float uhh, uhl;
    split(uh, uhh, uhl);
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      const float bh = yh[j * RC + c], bl = yl[j * RC + c];
      float ph, pe, h, l;
      two_prod_split(uh, uhh, uhl, bh, yhh[j * RC + c], yhl[j * RC + c], ph, pe);
      two_sum(ph, add(add(pe, mul(uh, bl)), mul(ul, bh)), h, l);
      df_sub(xh[c], xl[c], h, l, xh[c], xl[c]);
    }
  }
}

// One block per matrix, warp w owns the rows of block w (32w ... 32w + 31),
// its iterate in registers.  Forward: once block J's y is final (a block
// barrier), every later block applies its tile of L's columns of block J,
// in two halves of 16 columns (the first staged before the barrier), and
// block J + 1 then solves its diagonal block with shuffles (its tile staged
// right after the barrier, while it applies the off-diagonal one).
// Backward the same from the last block, U's tiles applied in descending
// column order.  Each row thus takes the triangle's updates in the twin's
// column order.
// (two blocks of 512 threads' registers per SM: four of the entropy batch's
// 224-thread blocks, one wave of 512 matrices)
template <int RC>
__global__ void __launch_bounds__(MAX_THREADS, 2)
    df_lu_solve_kernel(const float* __restrict__ Ah, const float* __restrict__ Al,
                       const long long* __restrict__ perm, const float* __restrict__ S,
                       const float* __restrict__ rhs, float* __restrict__ out, int N, int R) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nblk = blockDim.x >> 5;
  float* th = smem + (size_t)w * 2 * 32 * HP;  // the warp's half tile
  float* tl = th + 32 * HP;
  float* xt = smem + (size_t)nblk * 2 * 32 * HP;  // two half tiles for the next diagonal block
  float* dh_t = xt + (size_t)2 * 2 * 32 * HP;  // the diagonal block's tile
  float* dl_t = dh_t + 32 * TP;
  float* yh = dl_t + 32 * TP;
  float* yl = yh + (size_t)N * RC;
  float* yhh = yl + (size_t)N * RC;
  float* yhl = yhh + (size_t)N * RC;

  const int b = blockIdx.x;
  const size_t off = (size_t)b * N * N;
  const float* ah = Ah + off;
  const float* al = Al + off;
  const float* s = S + (size_t)b * N;
  const long long* pm = perm + (size_t)b * N;
  const float* r = rhs + (size_t)b * N * R;
  float* o = out + (size_t)b * N * R;
  const int i = 32 * w + lane;
  const int rows = min(32, N - 32 * w);

  for (int c0 = 0; c0 < R; c0 += RC) {
    const int rc = min(RC, R - c0);
    bool fin = true;  // every factor entry, iterate and output finite and tame
    float xh[RC], xl[RC];
    const long long pi = i < N ? pm[i] : 0;
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      xh[c] = i < N && c < rc ? mul(r[pi * R + c0 + c], s[pi]) : 0.0f;
      xl[c] = 0.0f;
    }

    // forward: L y = b_perm; block w's diagonal once tiles 0 .. w-1 are in
    if (w == 0) stage_tile<32, TP>(dh_t, dl_t, ah, al, N, 0, 0);
    for (int J = -1; J < nblk - 1; ++J) {
      if (J >= 0) {
        // the next diagonal block's warp stages both halves before the
        // barrier, the second into xt (in turn, so that the previous one's
        // may still be read); the other warps their second half after the
        // first is applied
        const bool next = w == J + 1;
        float* xh_t = xt + (size_t)(J & 1) * 2 * 32 * HP;
        float* xl_t = xh_t + 32 * HP;
        if (w > J) stage_tile<16, HP>(th, tl, ah, al, N, w, 32 * J);
        if (next) stage_tile<16, HP>(xh_t, xl_t, ah, al, N, w, 32 * J + 16);
        __syncthreads();
        if (next) stage_tile<32, TP>(dh_t, dl_t, ah, al, N, w, 32 * w);
        if (w > J) {
          tile_ready(next ? 1 : 0);
          apply_half<RC, true>(th, tl, yh, yl, yhh, yhl, 32 * J, 16, xh, xl, fin);
          if (!next) {
            stage_tile<16, HP>(th, tl, ah, al, N, w, 32 * J + 16);
            tile_ready(0);
          }
          apply_half<RC, true>(next ? xh_t : th, next ? xl_t : tl, yh, yl, yhh, yhl,
                               32 * J + 16, 16, xh, xl, fin);
        }
      }
      if (w == J + 1) {
        tile_ready(0);
        for (int jj = 0; jj < rows; ++jj) {
          const float lh = dh_t[lane * TP + jj], ll = dl_t[lane * TP + jj];
          fin = fin && finite(lh) && finite(ll);
#pragma unroll
          for (int c = 0; c < RC; ++c) {
            const float jh = __shfl_sync(0xffffffffu, xh[c], jj);
            const float jl = __shfl_sync(0xffffffffu, xl[c], jj);
            if (lane > jj) {
              float uh, ul;
              df_mul(lh, ll, jh, jl, uh, ul);
              df_sub(xh[c], xl[c], uh, ul, xh[c], xl[c]);
            }
          }
        }
        if (i < N) {
#pragma unroll
          for (int c = 0; c < RC; ++c) {
            yh[i * RC + c] = xh[c];
            yl[i * RC + c] = xl[c];
            split(xh[c], yhh[i * RC + c], yhl[i * RC + c]);
            fin = fin && (c >= rc || tame(xh[c], xl[c]));
          }
        }
      }
    }

    // backward: U x = y; block w's diagonal once tiles nblk-1 .. w+1 are in
    __syncthreads();  // the last forward diagonal block is done with its tile
    if (w == nblk - 1) stage_tile<32, TP>(dh_t, dl_t, ah, al, N, w, 32 * w);
    for (int J = nblk; J > 0; --J) {
      if (J < nblk) {
        const int cols = min(32, N - 32 * J);  // the upper half first
        const bool two = cols > 16, next = w == J - 1;
        float* xh_t = xt + (size_t)(J & 1) * 2 * 32 * HP;
        float* xl_t = xh_t + 32 * HP;
        if (w < J) stage_tile<16, HP>(th, tl, ah, al, N, w, 32 * J + (two ? 16 : 0));
        if (next && two) stage_tile<16, HP>(xh_t, xl_t, ah, al, N, w, 32 * J);
        __syncthreads();
        if (next) stage_tile<32, TP>(dh_t, dl_t, ah, al, N, w, 32 * w);
        if (w < J) {
          tile_ready(next ? 1 : 0);
          if (two) {
            apply_half<RC, false>(th, tl, yh, yl, yhh, yhl, 32 * J + 16, cols - 16, xh, xl,
                                  fin);
            if (!next) {
              stage_tile<16, HP>(th, tl, ah, al, N, w, 32 * J);
              tile_ready(0);
            }
          }
          apply_half<RC, false>(two && next ? xh_t : th, two && next ? xl_t : tl, yh, yl, yhh,
                                yhl, 32 * J, min(cols, 16), xh, xl, fin);
        }
      }
      if (w == J - 1) {
        tile_ready(0);
        for (int jj = rows - 1; jj >= 0; --jj) {
          const float uh_ = dh_t[lane * TP + jj], ul_ = dl_t[lane * TP + jj];
          const float dh = dh_t[jj * TP + jj], dl = dl_t[jj * TP + jj];
          fin = fin && finite(uh_) && finite(ul_);
#pragma unroll
          for (int c = 0; c < RC; ++c) {
            if (lane == jj) df_div(xh[c], xl[c], dh, dl, xh[c], xl[c]);
            const float jh = __shfl_sync(0xffffffffu, xh[c], jj);
            const float jl = __shfl_sync(0xffffffffu, xl[c], jj);
            if (lane < jj) {
              float ph_, pl_;
              df_mul(uh_, ul_, jh, jl, ph_, pl_);
              df_sub(xh[c], xl[c], ph_, pl_, xh[c], xl[c]);
            }
          }
        }
        if (i < N) {
#pragma unroll
          for (int c = 0; c < RC; ++c) {
            yh[i * RC + c] = xh[c];
            yl[i * RC + c] = xl[c];
            split(xh[c], yhh[i * RC + c], yhl[i * RC + c]);
            if (c < rc) {
              fin = fin && tame(xh[c], xl[c]);
              const float v = mul(add(xh[c], xl[c]), s[i]);
              o[i * R + c0 + c] = v;
              fin = fin && finite(v);
            }
          }
        }
      }
    }
    if (__syncthreads_or(!fin) && w == 0)
      solve_exact<RC>(yh, yl, ah, al, pm, s, r, o, N, R, c0, rc);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Solve, grid form (N > 512)
// ---------------------------------------------------------------------------
//
// The one-block solve gives each 32-row block a warp, 16 warps at most.
// The grid form keeps one block per matrix, of 32·min(⌈N/32⌉, 32) threads,
// and lets warp w own the row blocks w, w + W, w + 2W, ... (W warps): the
// iterate of every row (hi, lo and the hi part's split) lives in a [4][N][RC]
// scratch in device memory (L2-resident), and the warp that applies a tile
// loads its rows' iterate, applies the tile's 32 columns in the twin's order
// and stores it back.  The L and U entries are read from the factor directly
// (each lane its row's 32 consecutive entries, from L1 after the first).
// The schedule is the one-block form's: block J's diagonal is solved once
// every tile left of it is applied (forward; right of it backward), by the
// warp that owns it, right after it applies its own last tile; a block
// barrier per row block.  The same tests pick the exact branch.

constexpr int GRID_SOLVE_THREADS = 1024;

__host__ __device__ constexpr size_t grid_solve_scratch_words(int N, int RC) {
  return (size_t)4 * N * RC;
}

// y_i -= L_ij·y_j (forward) or x_i -= U_ij·x_j (backward) for the rows of
// block I and the columns j0 .. j0 + cols - 1, in the twin's order, as
// apply_half applies a staged half tile.
template <int RC, bool FORWARD>
__device__ __forceinline__ void grid_apply_tile(const float* ah, const float* al, float* yh,
                                                float* yl, const float* yhh, const float* yhl,
                                                int N, int I, int j0, int cols, bool& fin) {
  const int lane = threadIdx.x & 31;
  const int i = 32 * I + lane;
  const bool in = i < N;
  float xh[RC], xl[RC];
#pragma unroll
  for (int c = 0; c < RC; ++c) {
    xh[c] = in ? yh[i * RC + c] : 0.0f;
    xl[c] = in ? yl[i * RC + c] : 0.0f;
  }
  for (int q = 0; q < cols; ++q) {
    const int j = j0 + (FORWARD ? q : cols - 1 - q);
    const float uh = in ? ah[(size_t)i * N + j] : 0.0f;
    const float ul = in ? al[(size_t)i * N + j] : 0.0f;
    fin = fin && finite(uh) && finite(ul);
    float uhh, uhl;
    split(uh, uhh, uhl);
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      const float bh = yh[j * RC + c], bl = yl[j * RC + c];
      float ph, pe, h, l;
      two_prod_split(uh, uhh, uhl, bh, yhh[j * RC + c], yhl[j * RC + c], ph, pe);
      two_sum(ph, add(add(pe, mul(uh, bl)), mul(ul, bh)), h, l);
      df_sub(xh[c], xl[c], h, l, xh[c], xl[c]);
    }
  }
  if (in) {
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      yh[i * RC + c] = xh[c];
      yl[i * RC + c] = xl[c];
    }
  }
}

// Block I's diagonal, by the warp that owns it, as the one-block form
// solves it: forward the unit lower triangle, backward the upper one with
// its divisions and the outputs.  Its rows' values go to the iterate.
template <int RC, bool FORWARD>
__device__ __forceinline__ void grid_diagonal(const float* ah, const float* al, const float* s,
                                              float* yh, float* yl, float* yhh, float* yhl,
                                              float* o, int N, int R, int c0, int rc, int I,
                                              bool& fin) {
  const int lane = threadIdx.x & 31;
  const int i = 32 * I + lane;
  const bool in = i < N;
  const int rows = min(32, N - 32 * I);
  float xh[RC], xl[RC];
#pragma unroll
  for (int c = 0; c < RC; ++c) {
    xh[c] = in ? yh[i * RC + c] : 0.0f;
    xl[c] = in ? yl[i * RC + c] : 0.0f;
  }
  for (int q = 0; q < rows; ++q) {
    const int jj = FORWARD ? q : rows - 1 - q;
    const int j = 32 * I + jj;
    const float uh = in ? ah[(size_t)i * N + j] : 0.0f;
    const float ul = in ? al[(size_t)i * N + j] : 0.0f;
    fin = fin && finite(uh) && finite(ul);
    if (FORWARD) {
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        const float jh = __shfl_sync(0xffffffffu, xh[c], jj);
        const float jl = __shfl_sync(0xffffffffu, xl[c], jj);
        if (lane > jj) {
          float ph, pl;
          df_mul(uh, ul, jh, jl, ph, pl);
          df_sub(xh[c], xl[c], ph, pl, xh[c], xl[c]);
        }
      }
    } else {
      const float dh = ah[(size_t)j * N + j], dl = al[(size_t)j * N + j];
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        if (lane == jj) df_div(xh[c], xl[c], dh, dl, xh[c], xl[c]);
        const float jh = __shfl_sync(0xffffffffu, xh[c], jj);
        const float jl = __shfl_sync(0xffffffffu, xl[c], jj);
        if (lane < jj) {
          float ph, pl;
          df_mul(uh, ul, jh, jl, ph, pl);
          df_sub(xh[c], xl[c], ph, pl, xh[c], xl[c]);
        }
      }
    }
  }
  if (in) {
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      yh[i * RC + c] = xh[c];
      yl[i * RC + c] = xl[c];
      split(xh[c], yhh[i * RC + c], yhl[i * RC + c]);
      if (c < rc) {
        fin = fin && tame(xh[c], xl[c]);
        if (!FORWARD) {
          const float v = mul(add(xh[c], xl[c]), s[i]);
          o[i * R + c0 + c] = v;
          fin = fin && finite(v);
        }
      }
    }
  }
}

template <int RC>
__global__ void __launch_bounds__(GRID_SOLVE_THREADS)
    df_lu_solve_grid_kernel(const float* __restrict__ Ah, const float* __restrict__ Al,
                            const long long* __restrict__ perm, const float* __restrict__ S,
                            const float* __restrict__ rhs, float* __restrict__ out,
                            float* scratch, int N, int R) {
  const int tid = threadIdx.x, T = blockDim.x;
  const int w = tid >> 5, W = T >> 5;
  const int nblk = (N + 31) / 32;
  const int b = blockIdx.x;
  const size_t off = (size_t)b * N * N;
  const float* ah = Ah + off;
  const float* al = Al + off;
  const float* s = S + (size_t)b * N;
  const long long* pm = perm + (size_t)b * N;
  const float* r = rhs + (size_t)b * N * R;
  float* o = out + (size_t)b * N * R;
  float* yh = scratch + (size_t)b * grid_solve_scratch_words(N, RC);
  float* yl = yh + (size_t)N * RC;
  float* yhh = yl + (size_t)N * RC;
  float* yhl = yhh + (size_t)N * RC;

  for (int c0 = 0; c0 < R; c0 += RC) {
    const int rc = min(RC, R - c0);
    bool fin = true;  // every factor entry, iterate and output finite and tame
    for (int i = tid; i < N; i += T) {
      const long long pi = pm[i];
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        yh[i * RC + c] = c < rc ? mul(r[pi * R + c0 + c], s[pi]) : 0.0f;
        yl[i * RC + c] = 0.0f;
      }
    }
    __syncthreads();

    // forward: L y = b_perm.  Step J applies column block J to the blocks
    // below it; the owner of block J + 1 applies that tile first and then
    // solves block J + 1's diagonal
    for (int J = -1; J < nblk - 1; ++J) {
      if (J < 0) {
        if (w == 0) grid_diagonal<RC, true>(ah, al, s, yh, yl, yhh, yhl, o, N, R, c0, rc, 0, fin);
      } else {
        for (int I = J + 1 + ((w - (J + 1)) % W + W) % W; I < nblk; I += W) {
          grid_apply_tile<RC, true>(ah, al, yh, yl, yhh, yhl, N, I, 32 * J, 32, fin);
          if (I == J + 1)
            grid_diagonal<RC, true>(ah, al, s, yh, yl, yhh, yhl, o, N, R, c0, rc, I, fin);
        }
      }
      __syncthreads();
    }

    // backward: U x = y, the same from the last block, the tiles' columns
    // in descending order
    for (int J = nblk; J > 0; --J) {
      if (J == nblk) {
        if (w == (nblk - 1) % W)
          grid_diagonal<RC, false>(ah, al, s, yh, yl, yhh, yhl, o, N, R, c0, rc, nblk - 1, fin);
      } else {
        const int cols = min(32, N - 32 * J);
        for (int I = J - 1 - ((J - 1 - w) % W + W) % W; I >= 0; I -= W) {
          grid_apply_tile<RC, false>(ah, al, yh, yl, yhh, yhl, N, I, 32 * J, cols, fin);
          if (I == J - 1)
            grid_diagonal<RC, false>(ah, al, s, yh, yl, yhh, yhl, o, N, R, c0, rc, I, fin);
        }
      }
      __syncthreads();
    }
    if (__syncthreads_or(!fin) && w == 0)
      solve_exact<RC>(yh, yl, ah, al, pm, s, r, o, N, R, c0, rc);
    __syncthreads();
  }
}

int smem_capacity() {
  int device, capacity;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&capacity, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? capacity : -(int)err;
}

template <int RC>
int launch_solve(const float* Ah, const float* Al, const long long* perm, const float* s,
                 const float* rhs, float* out, int B, int N, int R, int smem_bytes,
                 cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(df_lu_solve_kernel<RC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  df_lu_solve_kernel<RC><<<B, 32 * ((N + 31) / 32), smem_bytes, stream>>>(Ah, Al, perm, s, rhs,
                                                                          out, N, R);
  return (int)cudaGetLastError();
}

template <int RC>
int launch_solve_grid(const float* Ah, const float* Al, const long long* perm, const float* s,
                      const float* rhs, float* out, float* scratch, int B, int N, int R,
                      cudaStream_t stream) {
  const int nblk = (N + 31) / 32;
  const int threads = 32 * (nblk < GRID_SOLVE_THREADS / 32 ? nblk : GRID_SOLVE_THREADS / 32);
  df_lu_solve_grid_kernel<RC><<<B, threads, 0, stream>>>(Ah, Al, perm, s, rhs, out, scratch, N,
                                                         R);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The kernels the factor entry points have launched since the library was
// loaded (one per launch issued): a caller reads it before and after a
// factor to count that factor's kernels (df_lu_factor_kernels).
static int factor_kernels = 0;

// K_lo may be null (a zero lo part).  threads (a multiple of 32 from 128
// to 512) and smem_bytes (at least factor_smem_bytes(N)) are chosen by the
// wrapper (df_ldl.factor_launch).
int df_lu_factor(const float* K_hi, const float* K_lo, const float* s, float* Ah, float* Al,
                 long long* perm, uint8_t* ok, int B, int N, float delta, int threads,
                 int smem_bytes, void* stream) {
  if (threads < 128 || threads > MAX_THREADS || threads % 32 ||
      (size_t)smem_bytes < factor_smem_bytes(N))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(df_lu_factor_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  df_lu_factor_kernel<<<B, threads, smem_bytes, (cudaStream_t)stream>>>(K_hi, K_lo, s, Ah, Al,
                                                                        perm, ok, N, delta);
  ++factor_kernels;
  return (int)cudaGetLastError();
}

// rc (1 or 2) right-hand sides per pass and smem_bytes (at least
// solve_smem_bytes(N, rc)) are chosen by the wrapper (df_ldl.solve_launch);
// one block of 32·⌈N/32⌉ threads per matrix, so N <= 512 (the one-block
// form; df_lu_solve_grid takes larger N).
int df_lu_solve(const float* Ah, const float* Al, const long long* perm, const float* s,
                const float* rhs, float* out, int B, int N, int R, int rc, int smem_bytes,
                void* stream) {
  if (N > 32 * MAX_BLOCKS || (size_t)smem_bytes < solve_smem_bytes(N, rc))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (rc == 1) return launch_solve<1>(Ah, Al, perm, s, rhs, out, B, N, R, smem_bytes, st);
  if (rc == 2) return launch_solve<2>(Ah, Al, perm, s, rhs, out, B, N, R, smem_bytes, st);
  return (int)cudaErrorInvalidValue;
}

// The grid form of df_lu_factor, for any N (the wrapper takes it above 512):
// 1 + 3·⌈N/8⌉ launches on `stream`, B <= 65535 matrices; scratch holds
// `words` >= grid_scratch_words(N) floats per matrix.
int df_lu_factor_grid(const float* K_hi, const float* K_lo, const float* s, float* Ah, float* Al,
                      long long* perm, uint8_t* ok, float* scratch, int words, int B, int N,
                      float delta, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || (size_t)words != grid_scratch_words(N))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t NN = (size_t)N * N;
  const int scale_blocks = NN < (size_t)256 * 1024 ? (int)((NN + 255) / 256) : 1024;
  df_lu_grid_scale_kernel<<<dim3(scale_blocks, 1, B), 256, 0, st>>>(K_hi, K_lo, s, Ah, Al,
                                                                     scratch, N);
  ++factor_kernels;
  cudaError_t err = cudaGetLastError();
  for (int j0 = 0; j0 < N && err == cudaSuccess; j0 += NB) {
    const int w = N - j0 < NB ? N - j0 : NB, M = N - j0 - w;
    df_lu_grid_panel_kernel<<<dim3(1, 1, B), GRID_THREADS, 0, st>>>(Ah, Al, scratch, N, j0,
                                                                   delta);
    ++factor_kernels;
    if (N > w) {
      df_lu_grid_swap_kernel<<<dim3((N - w + SWAP_THREADS - 1) / SWAP_THREADS, 1, B),
                               SWAP_THREADS, 0, st>>>(Ah, Al, scratch, N, j0);
      ++factor_kernels;
    }
    if (M > 0) {
      df_lu_grid_trailing_kernel<<<dim3((M + TILE_COLS - 1) / TILE_COLS,
                                        (M + TILE_ROWS - 1) / TILE_ROWS, B),
                                   TILE_THREADS, 0, st>>>(Ah, Al, scratch, N, j0);
      ++factor_kernels;
    }
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  df_lu_grid_finish_kernel<<<dim3(1, 1, B), GRID_THREADS, 0, st>>>(K_hi, K_lo, s, Ah, Al, perm,
                                                                  ok, scratch, N, delta);
  ++factor_kernels;
  return (int)cudaGetLastError();
}

// The grid form of df_lu_solve, for any N: one block per matrix; scratch
// holds `words` = grid_solve_scratch_words(N, rc) floats per matrix.
int df_lu_solve_grid(const float* Ah, const float* Al, const long long* perm, const float* s,
                     const float* rhs, float* out, float* scratch, int words, int B, int N,
                     int R, int rc, void* stream) {
  if (B < 1 || N < 1 || (rc != 1 && rc != 2) ||
      (size_t)words != grid_solve_scratch_words(N, rc))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (rc == 1) return launch_solve_grid<1>(Ah, Al, perm, s, rhs, out, scratch, B, N, R, st);
  if (rc == 2) return launch_solve_grid<2>(Ah, Al, perm, s, rhs, out, scratch, B, N, R, st);
  return (int)cudaErrorInvalidValue;
}

// The bytes of shared memory one block may use on the library's card
// (cudaDevAttrMaxSharedMemoryPerBlockOptin), or minus the CUDA error.
int df_lu_smem_capacity(void) { return smem_capacity(); }

// The kernels df_lu_factor and df_lu_factor_grid have launched so far.
int df_lu_factor_kernels(void) { return factor_kernels; }

#ifdef DF_LU_PROFILE
// The factor's cycle counts per part since the last read, then reset.
int df_lu_profile_read(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, df_lu_cycles, sizeof(df_lu_cycles));
  if (err == cudaSuccess) {
    const unsigned long long zero[4] = {0, 0, 0, 0};
    err = cudaMemcpyToSymbol(df_lu_cycles, zero, sizeof(zero));
  }
  return (int)err;
}
#endif

}  // extern "C"
