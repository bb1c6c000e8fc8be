// Double-float (f32x2) LU with partial pivoting, and its solve, for Hopper
// (sm_90a).
//
// These kernels run clarabel_tpu_torch/kkt/df_ldl.py on the card: the
// factor and the solve of the JAX package's clarabel_tpu/kkt/df_ldl.py,
// which is plain JAX (a fori_loop over the N columns, outside Pallas), so
// they replace no TPU kernel.  In eager PyTorch the same loop is one launch
// per elementwise operation: about 6,000 launches per factor and 8,000 per
// solve at N = 208, which the card runs worst.  Here one block owns one
// matrix of the batch and walks its columns with block barriers.
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
// Bound on the H100 SXM (NVIDIA datasheet: 67 TFLOP/s FP32 outside the
// tensor cores, 3.35 TB/s): the factor's trailing update is about 28 f32
// operations per entry, none fused, over Σ(N−j)² ≈ N³/3 entries; at
// 512 x 208² that is 40 G operations, 0.6 ms at the peak, against 177 MB of
// input and output pairs (0.05 ms): operations bound it.  This design reads
// and writes the pair through device memory at every column (about
// 16·N³/3 bytes per matrix, 25 GB at 512 x 208²), so HBM bounds it
// instead, and per-column barriers bound the single matrix (1 x 176²: one
// SM).  Keeping the trailing block in shared memory once it fits, and
// spreading one matrix over SMs, come later (ROADMAP Queue 2).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// Dekker's split constant for f32 (24-bit significand -> 12|12 halves)
constexpr float SPLIT = 4097.0f;

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

// jnp.argmax's and torch.argmax's order: NaN above every number, the first
// index among equals
__device__ __forceinline__ bool better(float v, int i, float w, int k) {
  bool nv = isnan(v), nw = isnan(w);
  if (nv != nw) return nv;
  if (!nv && v != w) return v > w;
  return i < k;
}

__device__ __forceinline__ bool finite(float v) { return isfinite(v); }

// ---------------------------------------------------------------------------
// Factor.  One block per matrix.  Column j:
//   1. the block-wide argmax of |Ah + Al| over rows >= j (first index on ties);
//   2. rows j and p of Ah, Al and perm swapped;
//   3. the pivot (dh, dl), a zero dh replaced by (delta, 0);
//   4. the multipliers (lh, ll) = (ch, cl) / (dh, dl) of rows > j, in
//      shared memory and in column j; rows <= j keep their U entries;
//   5. the trailing update of rows and columns > j: TwoProd lh·rh, the cross
//      terms lh·rl + ll·rh, TwoSum into Ah, and the renormalizing TwoSum of
//      the pair.
// The twin updates the whole matrix at every step with 0/1 masks; outside
// the trailing block those updates leave finite entries as they are, but
// for two effects the kernel reproduces: at j = 0 the renormalizing TwoSum
// also normalizes row 0 (the only pairs not normalized yet), and a
// non-finite multiplier of a row <= j (lh·0 is NaN there) makes the twin's
// factor non-finite, so ``ok`` is false.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(1024) df_lu_factor_kernel(const float* __restrict__ Kh,
                                                            const float* __restrict__ Kl,
                                                            const float* __restrict__ S,
                                                            float* __restrict__ Ah,
                                                            float* __restrict__ Al,
                                                            long long* __restrict__ perm,
                                                            uint8_t* __restrict__ ok, int N,
                                                            float delta) {
  extern __shared__ float smem[];
  float* colh = smem;  // multipliers lh, ll of rows > j and their splits
  float* coll = colh + N;
  float* colhh = coll + N;
  float* colhl = colhh + N;
  float* rowh = colhl + N;  // pivot row rh, rl of columns > j and the split of rh
  float* rowl = rowh + N;
  float* rowhh = rowl + N;
  float* rowhl = rowhh + N;
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int piv;
  __shared__ int bad_multiplier;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, warps = T >> 5;
  const size_t off = (size_t)b * N * N;
  const float* kh = Kh + off;
  const float* kl = Kl ? Kl + off : nullptr;
  const float* s = S + (size_t)b * N;
  float* ah = Ah + off;
  float* al = Al + off;
  long long* pm = perm + (size_t)b * N;

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
  if (tid == 0) bad_multiplier = 0;
  __syncthreads();

  for (int j = 0; j < N; ++j) {
    // 1. pivot search
    float bv = -1.0f;
    int bi = N;
    for (int i = j + tid; i < N; i += T) {
      const size_t e = (size_t)i * N + j;
      const float v = fabsf(add(ah[e], al[e]));
      if (better(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float v = __shfl_down_sync(0xffffffffu, bv, o);
      const int i = __shfl_down_sync(0xffffffffu, bi, o);
      if (better(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < warps ? red_v[lane] : -1.0f;
      bi = lane < warps ? red_i[lane] : N;
      for (int o = 16; o > 0; o >>= 1) {
        const float v = __shfl_down_sync(0xffffffffu, bv, o);
        const int i = __shfl_down_sync(0xffffffffu, bi, o);
        if (better(v, i, bv, bi)) {
          bv = v;
          bi = i;
        }
      }
      if (lane == 0) piv = bi;
    }
    __syncthreads();

    // 2. row swap
    const int p = piv;
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
        const long long t = pm[j];
        pm[j] = pm[p];
        pm[p] = t;
      }
      __syncthreads();
    }

    // 3. pivot, zero-pivot safeguard
    const size_t ejj = (size_t)j * N + j;
    float dh = ah[ejj], dl = al[ejj];
    if (dh == 0.0f) {
      dh = delta;
      dl = 0.0f;
    }

    // 4. multipliers of rows > j (and the twin's masked ones of rows <= j,
    //    for their finiteness only), the pivot row
    for (int i = tid; i < N; i += T) {
      const size_t e = (size_t)i * N + j;
      float lh, ll;
      df_div(ah[e], al[e], dh, dl, lh, ll);
      if (i > j) {
        colh[i] = lh;
        coll[i] = ll;
        split(lh, colhh[i], colhl[i]);
        ah[e] = lh;
        al[e] = ll;
      } else if (!finite(lh) || !finite(ll)) {
        bad_multiplier = 1;
      }
    }
    for (int k = j + 1 + tid; k < N; k += T) {
      const size_t e = (size_t)j * N + k;
      const float rh = ah[e], rl = al[e];
      rowh[k] = rh;
      rowl[k] = rl;
      split(rh, rowhh[k], rowhl[k]);
      if (j == 0) {
        float h, l;
        two_sum(rh, rl, h, l);
        ah[e] = h;
        al[e] = l;
      }
    }
    __syncthreads();

    // 5. trailing update
    for (int i = j + 1 + warp; i < N; i += warps) {
      const float lh = colh[i], ll = coll[i], lhh = colhh[i], lhl = colhl[i];
      for (int k = j + 1 + lane; k < N; k += 32) {
        const size_t e = (size_t)i * N + k;
        const float rh = rowh[k], rl = rowl[k];
        float uh, ue;
        two_prod_split(lh, lhh, lhl, rh, rowhh[k], rowhl[k], uh, ue);
        const float cross = add(mul(lh, rl), mul(ll, rh));
        const float a = ah[e];
        float sh, e1;
        two_sum(a, -uh, sh, e1);
        const float lo = add(al[e], sub(sub(e1, ue), cross));
        float h, l;
        two_sum(sh, lo, h, l);
        ah[e] = h;
        al[e] = l;
      }
    }
    __syncthreads();
  }

  // ok: every entry finite (and no masked multiplier non-finite)
  bool fin = true;
  for (size_t e = tid; e < (size_t)N * N; e += T) fin = fin && finite(ah[e]) && finite(al[e]);
  const int all_fin = __syncthreads_and(fin);
  if (tid == 0) ok[b] = (all_fin && !bad_multiplier) ? 1 : 0;
}

// ---------------------------------------------------------------------------
// Solve.  One block per matrix, all R right-hand sides; the double-float
// iterate (yh, yl) [N, R] in shared memory.  The power-of-two scaling and
// the permutation on the way in, N forward and N backward double-float
// steps, and one rounding (xh + xl)·s on the way out.  Each step updates
// every row with the twin's 0/1 masks, so non-finite values spread exactly
// as in the twin.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(1024) df_lu_solve_kernel(const float* __restrict__ Ah,
                                                           const float* __restrict__ Al,
                                                           const long long* __restrict__ perm,
                                                           const float* __restrict__ S,
                                                           const float* __restrict__ rhs,
                                                           float* __restrict__ out, int N,
                                                           int R) {
  extern __shared__ float smem[];
  float* yh = smem;
  float* yl = smem + (size_t)N * R;
  __shared__ float jh[32], jl[32];  // row j of the iterate (R <= 32 per pass)

  const int b = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  const size_t off = (size_t)b * N * N;
  const float* ah = Ah + off;
  const float* al = Al + off;
  const float* s = S + (size_t)b * N;
  const long long* pm = perm + (size_t)b * N;
  const float* r = rhs + (size_t)b * N * R;
  float* o = out + (size_t)b * N * R;
  const int NR = N * R;

  for (int e = tid; e < NR; e += T) {
    const int i = e / R, c = e % R;
    const long long pi = pm[i];
    yh[e] = mul(r[pi * R + c], s[pi]);
    yl[e] = 0.0f;
  }
  __syncthreads();

  // the right-hand sides in passes of 32 columns, so row j fits jh/jl
  for (int c0 = 0; c0 < R; c0 += 32) {
    const int RC = min(32, R - c0);
    const int work = N * RC;
    // forward: L y = b_perm
    for (int j = 0; j < N; ++j) {
      if (tid < RC) {
        jh[tid] = yh[j * R + c0 + tid];
        jl[tid] = yl[j * R + c0 + tid];
      }
      __syncthreads();
      for (int w = tid; w < work; w += T) {
        const int i = w / RC, c = w % RC;
        const float below = i > j ? 1.0f : 0.0f;
        const size_t ei = (size_t)i * N + j;
        float uh, ul;
        df_mul(mul(ah[ei], below), mul(al[ei], below), jh[c], jl[c], uh, ul);
        const int e = i * R + c0 + c;
        df_sub(yh[e], yl[e], uh, ul, yh[e], yl[e]);
      }
      __syncthreads();
    }
    // backward: U x = y
    for (int j = N - 1; j >= 0; --j) {
      if (tid < RC) {
        const size_t ejj = (size_t)j * N + j;
        df_div(yh[j * R + c0 + tid], yl[j * R + c0 + tid], ah[ejj], al[ejj], jh[tid], jl[tid]);
      }
      __syncthreads();
      for (int w = tid; w < work; w += T) {
        const int i = w / RC, c = w % RC;
        const int e = i * R + c0 + c;
        // row j holds x_j before the update, as in the twin
        const float xh = i == j ? jh[c] : yh[e];
        const float xl = i == j ? jl[c] : yl[e];
        const float above = i < j ? 1.0f : 0.0f;
        const size_t ei = (size_t)i * N + j;
        float ph, pl, nh, nl;
        df_mul(mul(ah[ei], above), mul(al[ei], above), jh[c], jl[c], ph, pl);
        df_sub(xh, xl, ph, pl, nh, nl);
        const float keep = i == j ? 1.0f : 0.0f;
        const float drop = sub(1.0f, keep);
        yh[e] = add(mul(nh, drop), mul(xh, keep));
        yl[e] = add(mul(nl, drop), mul(xl, keep));
      }
      __syncthreads();
    }
  }

  for (int e = tid; e < NR; e += T) o[e] = mul(add(yh[e], yl[e]), s[e / R]);
}

int smem_capacity() {
  int device, capacity;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&capacity, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? capacity : -(int)err;
}

int threads_for(int work, int cap) {
  int t = ((work + 31) / 32) * 32;
  return t < 32 ? 32 : (t > cap ? cap : t);
}

}  // namespace

extern "C" {

// K_lo may be null (a zero lo part).  smem_capacity is the card's opt-in
// shared memory per block (df_lu_smem_capacity).
int df_lu_factor(const float* K_hi, const float* K_lo, const float* s, float* Ah, float* Al,
                 long long* perm, uint8_t* ok, int B, int N, float delta, int smem_cap,
                 void* stream) {
  const size_t nbytes = (size_t)8 * N * sizeof(float);
  if (nbytes + 1024 > (size_t)smem_cap) return (int)cudaErrorInvalidValue;
  // (beside the kernel's static shared memory, under 1 KB)
  if (nbytes + 1024 > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        df_lu_factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)nbytes);
    if (err != cudaSuccess) return (int)err;
  }
  // several matrices share an SM once the batch outnumbers the SMs
  const int threads = B > 132 ? 256 : 1024;
  df_lu_factor_kernel<<<B, threads, nbytes, (cudaStream_t)stream>>>(K_hi, K_lo, s, Ah, Al, perm,
                                                                   ok, N, delta);
  return (int)cudaGetLastError();
}

// smem_bytes = 2·N·R·sizeof(float), at most the card's opt-in capacity.
int df_lu_solve(const float* Ah, const float* Al, const long long* perm, const float* s,
                const float* rhs, float* out, int B, int N, int R, int smem_bytes,
                void* stream) {
  if (smem_bytes + 1024 > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        df_lu_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = threads_for(N * (R < 32 ? R : 32), 1024);
  df_lu_solve_kernel<<<B, threads, smem_bytes, (cudaStream_t)stream>>>(Ah, Al, perm, s, rhs, out,
                                                                      N, R);
  return (int)cudaGetLastError();
}

// The bytes of shared memory one block may use on the library's card
// (cudaDevAttrMaxSharedMemoryPerBlockOptin), or minus the CUDA error.
int df_lu_smem_capacity(void) { return smem_capacity(); }

}  // extern "C"
