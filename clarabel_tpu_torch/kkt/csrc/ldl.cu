// Batched unpivoted LDLᵀ of quasidefinite KKT matrices, for Hopper (sm_90a).
//
// These kernels replace the three Pallas TPU kernels of
// clarabel_tpu/kkt/pallas_ldl.py.  They compute what those kernels compute:
// the LDLᵀ factorization of K = [[P̃, Aᵀ], [A, -H̃]] without pivoting, with
// QDLDL's dynamic regularization applied to every pivot d in elimination
// order (qdldl.rs:517-527):
//
//     if (d * sign[j] < eps) d = delta * sign[j];        (strict <)
//
// sign[j] is +1 on the first n rows and -1 on the m cone rows; eps = -inf and
// delta = 0 turn the regularization off.  Every matrix of the batch is
// N x N, row-major, contiguous, and factored in place.  The host entry points
// at the end of this file take PyTorch's current stream, launch, allocate
// nothing and return cudaGetLastError().
//
// The TPU kernels keep the whole padded matrix in VMEM and work in 128-column
// panels, the MXU's width.  Neither fits Hopper: a 256 x 256 f64 matrix is
// 512 KB, a block has at most 227 KB of shared memory, and f64 has no wgmma.
// So the blocked factor keeps the matrix in device memory (L2-resident at
// these sizes); the unblocked one keeps the trailing upper triangle, which
// fits up to N = 240 at f64, in shared memory.  The arithmetic is FP64/FP32.
//
// Bound on the H100 SXM (NVIDIA datasheet): an LDLᵀ, like a Cholesky
// factorization, is N³/6 multiply-adds (N³/3 flops; LU's 2N³/3 does twice
// the work) and moves at least 2·N²·sizeof(T) bytes.  At N = 2001, f64:
// 2.67 GFLOP, which is 40 µs at the 67 TFLOP/s FP64 tensor-core peak and
// 79 µs at the 34 TFLOP/s FP64 FMA peak, against 19 µs for the 64 MB at
// 3.35 TB/s: compute bounds it.  What keeps these kernels far from that
// bound: the blocked factor walks its panels in order, three launches each,
// and its trailing update uses scalar FMAs on 64 x 64 tiles staged through
// shared memory.  DMMA (mma.sync f64) tiles for the trailing update with a
// wider panel, and TMA loads, are the work of a later change.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// Products and differences that the compiler may not contract into an FMA:
// the unblocked and panel kernels then round exactly as the plain PyTorch
// versions (clarabel_tpu_torch/kkt/pallas_ldl.py) do.
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }

template <typename T>
__device__ __forceinline__ T regularize(T d, T sign, T eps, T delta) {
  return (mul_rn(d, sign) < eps) ? mul_rn(delta, sign) : d;
}

// widest trailing triangle the unblocked kernel takes in shared memory: the
// widest the H100's 227 KB hold (340 columns at f32), in whole 32-column chunks
constexpr int SMEM_MAX_COLS = 352;
constexpr int SMEM_CHUNKS = SMEM_MAX_COLS / 32;  // a lane's columns of the pivot row, in registers
constexpr int PANEL_WIDTH = 32;  // columns per panel of the blocked kernel
constexpr int ROW_THREADS = 64;  // rows below the panel's diagonal block per block
constexpr int TILE = 64;         // trailing-update tile edge
constexpr int TRAILING_THREADS = 256;

// ---------------------------------------------------------------------------
// Unblocked LDLᵀ.  Replaces _ldl_kernel_call_unrolled (K2) and
// _ldl_kernel_call (K3), pallas_ldl.py:115-200, which run the same
// elimination (K2 unrolled at trace time, K3 as a fori_loop).
//
// Output layout (theirs): Lᵀ strictly above the diagonal, D on it, and row
// j's entries left of the diagonal written as 0/d_j.
//
// Grid: one block per matrix.  Bound: at N = 201 the 2·N²·sizeof(T) bytes
// (0.65 MB at f64, 0.19 µs at 3.35 TB/s) outweigh the N³/3 flops (0.04 µs at
// 67 TFLOP/s), but one block runs on one SM.  There the design's floor is
// its N³/3 multiplies and subtractions, separate operations (the twin rounds
// each, so no FMA), at the SM's 64 FP64 lanes: about 21 µs at N = 201 and
// 1.98 GHz (the SM's FP64 peak, its tensor cores, is 4x that).  What holds
// the kernel above it is shared-memory traffic (an update loads and stores
// its entry) and each step's chain of pivot, division and barrier.  What the
// design does:
//
//   - The trailing upper triangle lives in dynamic shared memory, packed by
//     rows: local row i (matrix row j0 + i) holds columns j0 + i .. N - 1,
//     so M(M+1)/2 entries for M = N - j0.  It is read from K once, all
//     column steps run on it, and the N x N output is written once.  The
//     f64 triangle fits up to N = 240 in the H100's 227 KB.
//   - Beyond that (or beyond SMEM_MAX_COLS), the first j0 steps run on K in
//     device memory (L1/L2-resident), each ending with row j written in its
//     packed form; then the trailing triangle of rows j0 .. N - 1, which
//     then fits, moves into shared memory.  The host picks j0 and the bytes
//     (pallas_ldl.unblocked_plan).
//   - Two steps per pass, one barrier per pass.  Pass (j, j + 1): every
//     warp regularizes d_j, forms l = K[j][j+1] / d_j and takes row j + 1
//     through step j in registers (its lane's columns), which gives d_{j+1};
//     lane i of each warp forms both l of the warp's i-th row r (warps take
//     rows round robin), true divisions; the warp walks its rows, taking the
//     l by shuffle, and loads each entry once for both updates
//     K[r][c] -= l_j * K[j][c], then -= l_{j+1} * K'[j+1][c] (mul_rn,
//     sub_rn): the same roundings in the same order as two single steps,
//     with half the shared-memory traffic.  A pass writes only rows
//     r > j + 1 and reads rows j, j + 1, final since the last barrier; row
//     j + 1's stepped values are stored a pass later, when nothing reads it.
//   - The pivot slot and row j are never written after step j - 1, so the
//     write-out recomputes d = regularize(K[j][j]) and emits K[j][c] / d
//     right of the diagonal, d on it and 0 / d left of it: the values the
//     global steps write, and the plain twin's, bit for bit (-0.0 for a
//     negative pivot, NaN for an unregularized zero one).
// ---------------------------------------------------------------------------

// offset of local row i in the packed triangle of width M
__device__ __forceinline__ int packed_row(int i, int M) { return i * M - i * (i - 1) / 2; }

// Warps per block: 32, except 8 for a triangle of at most 64 columns, so
// that several blocks share an SM when the batch outnumbers the SMs.
constexpr int unblocked_warps(int chunks) { return chunks <= 2 ? 8 : 32; }
static_assert(SMEM_CHUNKS <= 11, "update_row's dispatch covers 11 chunks");

// Row r's columns r .. M - 1 from a warp's registers (v[k] at 32k + lane).
template <typename T, int CH>
__device__ __forceinline__ void store_row(T* row, int r, int M, int lane, const T (&v)[CH]) {
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    const int c = 32 * k + lane;
    if (c >= r && c < M) row[c] = v[k];
  }
}

// One row's update by the two steps j, j + 1 of a pass:
// S(r, c) -= l0 * u0(c), then S(r, c) -= l1 * u1(c), for r <= c < M, with
// the lane holding the columns c = 32k + lane, row pointing at S(r, lane)
// and t = r - lane.  The row's first chunk K0 = r / 32 is a template
// parameter, so the chunks left of the row cost nothing and the rest are
// one basic block: every load, then every store.  The loads are
// unconditional (a column left of r reads the row before, one right of
// M - 1 the row after or the pad that the plan adds behind the triangle);
// the stores are not.
template <typename T, int CH, int K0>
__device__ __forceinline__ void update_row(T* row, int t, bool last_ok, T l0, T l1,
                                           const T (&u0)[CH], const T (&u1)[CH]) {
  T x[CH - K0];
#pragma unroll
  for (int k = K0; k < CH; ++k) x[k - K0] = row[32 * k];
#pragma unroll
  for (int k = K0; k < CH; ++k) {
    const T v = sub_rn(sub_rn(x[k - K0], mul_rn(l0, u0[k])), mul_rn(l1, u1[k]));
    if (32 * k >= t && (k + 1 < CH || last_ok)) row[32 * k] = v;
  }
}

// CH: 32-column chunks of the trailing triangle's width M, 32·(CH-1) < M <= 32·CH
template <typename T, int CH, int W = unblocked_warps(CH)>
__global__ void __launch_bounds__(32 * W)
ldl_unblocked_kernel(T* __restrict__ K, const T* __restrict__ sign, int N,
                     int j0, T eps, T delta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  T* a = K + (size_t)blockIdx.x * N * N;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // steps 0 .. j0 - 1 in device memory; a lane loads GLOBAL_CHUNKS of its
  // row's columns before it stores any, so their L2 round trips overlap
  constexpr int GLOBAL_CHUNKS = 4;
  for (int j = 0; j < j0; ++j) {
    const T* rowj = a + (size_t)j * N;
    const T d = regularize(rowj[j], sign[j], eps, delta);
    for (int r = j + 1 + warp; r < N; r += W) {
      const T l = rowj[r] / d;
      T* rowr = a + (size_t)r * N;
      for (int c0 = r + lane; c0 < N; c0 += 32 * GLOBAL_CHUNKS) {
        T x[GLOBAL_CHUNKS], u[GLOBAL_CHUNKS];
#pragma unroll
        for (int q = 0; q < GLOBAL_CHUNKS; ++q) {
          const int c = c0 + 32 * q;
          x[q] = c < N ? rowr[c] : T(0);
          u[q] = c < N ? rowj[c] : T(0);
        }
#pragma unroll
        for (int q = 0; q < GLOBAL_CHUNKS; ++q) {
          const int c = c0 + 32 * q;
          if (c < N) rowr[c] = sub_rn(x[q], mul_rn(l, u[q]));
        }
      }
    }
    __syncthreads();
    const T zero_over_d = T(0) / d;
    T* roww = a + (size_t)j * N;
    for (int c = threadIdx.x; c < N; c += blockDim.x) {
      const T v = roww[c];
      roww[c] = (c < j) ? zero_over_d : (c == j ? d : v / d);
    }
  }

  // the trailing triangle into shared memory; below, local row and column
  // i stand for matrix row and column j0 + i, and row(i)[c] = S(i, c), c >= i
  const int M = N - j0;
  const T* ga = a + (size_t)j0 * N + j0;
  for (int i = warp; i < M; i += W) {
    T* row = s + packed_row(i, M) - i;
    const T* g = ga + (size_t)i * N;
    for (int c = i + lane; c < M; c += 32) row[c] = g[c];
  }
  __syncthreads();

  // Two steps per pass, each row loaded and stored once for both.  Every
  // warp first takes pivot row j + 1 through step j itself (u1 below), the
  // same roundings as the step would make; warp 0 stores that row at the
  // next pass, when nothing reads it any more.
  const bool last_ok = 32 * (CH - 1) + lane < M;  // this lane's column in the last chunk exists
  T u1[CH];  // row j + 1 after step j, at columns 32k + lane
  int j = 0;
  for (; j + 1 < M; j += 2) {
    if (j > 0 && warp == 0) store_row<T, CH>(s + packed_row(j - 1, M) - (j - 1), j - 1, M, lane, u1);
    const T* rowj = s + packed_row(j, M) - j;
    const T* rowj1 = s + packed_row(j + 1, M) - (j + 1);
    const T d0 = regularize(rowj[j], sign[j0 + j], eps, delta);
    const T lj1 = rowj[j + 1] / d0;  // l of row j + 1 at step j
    const T d1 = regularize(sub_rn(rowj1[j + 1], mul_rn(lj1, rowj[j + 1])), sign[j0 + j + 1],
                            eps, delta);
    // warp w takes rows j + 2 + w + W·i, i = 0, 1, ..; lane i forms both l
    // of the warp's i-th row, a true division each
    const int rl = j + 2 + W * lane + warp;
    T l0v = T(0), l1v = T(0);
    int offl = 0;
    if (rl < M) {
      const T x = rowj[rl];
      l0v = x / d0;
      l1v = sub_rn(rowj1[rl], mul_rn(lj1, x)) / d1;
      offl = packed_row(rl, M) - rl;
    }
    T u0[CH];  // row j at columns 32k + lane
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int c = 32 * k + lane;
      const bool in = c > j && c < M;
      u0[k] = in ? rowj[c] : T(0);
      u1[k] = in ? sub_rn(rowj1[c], mul_rn(lj1, u0[k])) : T(0);
    }
    for (int i = 0;; ++i) {
      const int r = j + 2 + W * i + warp;
      if (r >= M) break;  // uniform across the warp
      const T l0 = __shfl_sync(0xffffffffu, l0v, i);
      const T l1 = __shfl_sync(0xffffffffu, l1v, i);
      T* row = s + __shfl_sync(0xffffffffu, offl, i) + lane;
      switch (r >> 5) {  // the row's first chunk
#define UPDATE_FROM(K0) \
  case K0:              \
    if constexpr (K0 < CH) update_row<T, CH, K0>(row, r - lane, last_ok, l0, l1, u0, u1); \
    break;
        UPDATE_FROM(0) UPDATE_FROM(1) UPDATE_FROM(2) UPDATE_FROM(3)
        UPDATE_FROM(4) UPDATE_FROM(5) UPDATE_FROM(6) UPDATE_FROM(7)
        UPDATE_FROM(8) UPDATE_FROM(9) UPDATE_FROM(10)
#undef UPDATE_FROM
      }
    }
    __syncthreads();
  }
  // the last pass's row j + 1 (none if M = 1); for odd M, step M - 1 has no
  // rows to update
  if (j > 0 && warp == 0) store_row<T, CH>(s + packed_row(j - 1, M) - (j - 1), j - 1, M, lane, u1);
  __syncthreads();

  // write-out of rows j0 .. N - 1
  for (int idx = threadIdx.x; idx < M * N; idx += blockDim.x) {
    const int i = idx / N, c = idx - i * N;
    const int j = j0 + i;
    const T* rowj = s + packed_row(i, M) - i;
    const T d = regularize(rowj[i], sign[j], eps, delta);
    a[(size_t)j * N + c] = (c < j) ? T(0) / d : (c == j ? d : rowj[c - j0] / d);
  }
}

// ---------------------------------------------------------------------------
// Blocked LDLᵀ.  Replaces _ldl_kernel_call_blocked (K1), pallas_ldl.py:36-112:
// per panel of columns, rank-1 steps confined to the panel, then one trailing
// update K22 -= L21·D·L21ᵀ.  Output layout (theirs): L strictly below the
// diagonal, D on it (written as d + 0·pivot, as theirs), zeros above.
//
// The kernels work on the transposed matrix: the wrapper hands them
// Kᵀ row-major, i.e. K column-major, so that column j of K's lower triangle
// -- what a panel step reads and writes -- is contiguous.  Below, A(r, c)
// denotes K[r][c], stored at a[c * N + r].  Only A's lower triangle is read
// or written until ldl_finalize_kernel moves L into the row-major lower
// triangle and zeros the rest.
// ---------------------------------------------------------------------------

// Bound: N³/6 multiply-adds (N³/3 flops); at N = 2001, f64, 0.040 ms at the
// 67 TFLOP/s FP64 tensor-core peak (the header gives the rest).
//
// A panel [A11; A21] -- columns [p0, pe), rows [p0, N) -- is factored by two
// kernels, the right-looking split of a panel: (a) factors the diagonal block
// A11 and is the only place where pivots are formed and regularized; (b)
// solves the rows below it, which are independent of one another, on a grid
// of row slabs.  Both keep the rounding of the panel's rank-1 steps
// (mul_rn/sub_rn, no FMA contraction): row r >= pe at step j computes
//
//     l = A(r, j) / d_j;   A(r, c) -= l * u(c, j) for j < c < pe;   L(r, j) = l
//
// with u(c, j) = A(c, j) as it stands when column j is eliminated.  The
// pitfalls, and what the design does about them:
//   - Read after write on A11: (a) writes the packed L11/D in place, so (b)
//     never reads A11; it reads u from the scratch ubuf [B, PW, PW] and d
//     from dbuf, both written by (a) and read after it in stream order.
//   - Empty grids: (b) and the trailing update launch only when rows remain
//     below the panel (not for N <= PW, nor for the last panel); a grid
//     dimension of 0 is an invalid launch.  The host checks every launch.
//   - Only the last panel can be narrower than PW, and it has no rows below
//     it, so (b) always sees a full panel and keeps its row in registers.
//
// (a) Diagonal block: one block of PW x PW threads per matrix, thread
// (x, y) = (r, c) holding A11(r, c), c <= r < pw, in a register for the whole
// factorization.  Step j: column j's threads publish their values (u(c, j)
// below the pivot) in shared memory, double-buffered so one barrier per step
// suffices; every thread regularizes the same pivot; thread (r, c),
// j < c <= r, subtracts (A(r, j) / d) * u(c, j); column j's threads store u
// to ubuf and become L(r, j), the pivot's thread d + 0·pivot.  Loads and
// stores run along rows, K being column-major, so they coalesce.
template <typename T>
__global__ void __launch_bounds__(PANEL_WIDTH * PANEL_WIDTH)
ldl_diag_kernel(T* __restrict__ K, T* __restrict__ dbuf, T* __restrict__ ubuf,
                const T* __restrict__ sign, int N, int p0, int pe, T eps,
                T delta) {
  T* a = K + (size_t)blockIdx.x * N * N;
  T* dv = dbuf + (size_t)blockIdx.x * N + p0;
  T* u = ubuf + (size_t)blockIdx.x * PANEL_WIDTH * PANEL_WIDTH;
  const int pw = pe - p0;
  const int r = threadIdx.x, c = threadIdx.y;
  const bool mine = c <= r && r < pw;
  T* x = a + (size_t)(p0 + c) * N + (p0 + r);  // A(p0 + r, p0 + c)
  T v = mine ? *x : T(0);
  __shared__ T s_col[2][PANEL_WIDTH];
  for (int j = 0; j < pw; ++j) {
    T* col = s_col[j & 1];  // col[i] = A(p0 + i, p0 + j), i >= j
    if (mine && c == j) col[r] = v;
    __syncthreads();
    const T piv = col[j];
    const T d = regularize(piv, sign[p0 + j], eps, delta);
    if (!mine || c < j) continue;
    if (c > j) {
      v = sub_rn(v, mul_rn(col[r] / d, col[c]));
    } else if (r > j) {
      u[j * PANEL_WIDTH + r] = v;
      v = v / d;
    } else {
      dv[j] = d;
      v = add_rn(d, mul_rn(T(0), piv));
    }
  }
  if (mine) *x = v;
}

// (b) Rows below the diagonal block: grid (row slabs of ROW_THREADS) x batch;
// one thread per row r >= pe runs the PW steps above on its 32 panel values
// in registers, with u and d staged in shared memory (a broadcast read: every
// thread of a step reads the same address).  Row r's panel values are
// A(r, p0 + k) = a[(p0 + k) * N + r]: neighbouring threads, neighbouring
// addresses.  At N = 2001 the first panel's 1969 rows are 31 blocks.
template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
ldl_rows_kernel(T* __restrict__ K, const T* __restrict__ dbuf,
                const T* __restrict__ ubuf, int N, int p0, int pe) {
  T* a = K + (size_t)blockIdx.y * N * N;
  const T* dv = dbuf + (size_t)blockIdx.y * N + p0;
  const T* u = ubuf + (size_t)blockIdx.y * PANEL_WIDTH * PANEL_WIDTH;
  __shared__ T s_u[PANEL_WIDTH * PANEL_WIDTH];  // s_u[j * PW + c] = u(p0 + c, p0 + j)
  __shared__ T s_d[PANEL_WIDTH];
  for (int i = threadIdx.x; i < PANEL_WIDTH * PANEL_WIDTH; i += blockDim.x) s_u[i] = u[i];
  for (int i = threadIdx.x; i < PANEL_WIDTH; i += blockDim.x) s_d[i] = dv[i];
  __syncthreads();
  const int r = pe + blockIdx.x * ROW_THREADS + threadIdx.x;
  if (r >= N) return;
  T* row = a + (size_t)p0 * N + r;  // row[k * N] = A(r, p0 + k)
  T x[PANEL_WIDTH];
#pragma unroll
  for (int k = 0; k < PANEL_WIDTH; ++k) x[k] = row[(size_t)k * N];
#pragma unroll
  for (int j = 0; j < PANEL_WIDTH; ++j) {
    const T l = x[j] / s_d[j];
#pragma unroll
    for (int k = j + 1; k < PANEL_WIDTH; ++k)
      x[k] = sub_rn(x[k], mul_rn(l, s_u[j * PANEL_WIDTH + k]));
    x[j] = l;
  }
#pragma unroll
  for (int k = 0; k < PANEL_WIDTH; ++k) row[(size_t)k * N] = x[k];
}

// (c) Trailing update: A(r, c) -= sum_k (L(r, k) * d_k) * L(c, k) over the
// panel's columns k, for pe <= c <= r < N.  Grid: (lower-triangle tiles of
// K22) x batch.  Each block stages the two [PANEL_WIDTH x TILE] slices of L21
// in shared memory (one scaled by D, as the TPU kernel scales B by dvec) and
// each thread accumulates a 4 x 4 block of its tile with FMAs.
template <typename T>
__global__ void __launch_bounds__(TRAILING_THREADS)
ldl_trailing_kernel(T* __restrict__ K, const T* __restrict__ dbuf, int N,
                    int p0, int pe) {
  T* a = K + (size_t)blockIdx.y * N * N;
  const T* dv = dbuf + (size_t)blockIdx.y * N;
  const int pw = pe - p0;

  // linear block index -> (ti, tj), ti >= tj
  const long long t = blockIdx.x;
  int ti = (int)((sqrt(8.0 * (double)t + 1.0) - 1.0) * 0.5);
  while ((long long)ti * (ti + 1) / 2 > t) --ti;
  while ((long long)(ti + 1) * (ti + 2) / 2 <= t) ++ti;
  const int tj = (int)(t - (long long)ti * (ti + 1) / 2);
  const int r0 = pe + ti * TILE;
  const int c0 = pe + tj * TILE;

  __shared__ T s_lr[PANEL_WIDTH][TILE];  // L(r0 + i, p0 + k) * d_k
  __shared__ T s_lc[PANEL_WIDTH][TILE];  // L(c0 + i, p0 + k)
  for (int idx = threadIdx.x; idx < PANEL_WIDTH * TILE; idx += blockDim.x) {
    const int k = idx / TILE;
    const int i = idx % TILE;
    T lr = T(0), lc = T(0);
    if (k < pw) {
      const T* colk = a + (size_t)(p0 + k) * N;
      if (r0 + i < N) lr = colk[r0 + i] * dv[p0 + k];
      if (c0 + i < N) lc = colk[c0 + i];
    }
    s_lr[k][i] = lr;
    s_lc[k][i] = lc;
  }
  __syncthreads();

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  T acc[4][4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = T(0);
  for (int k = 0; k < pw; ++k) {
    T ra[4], cb[4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) ra[ii] = s_lr[k][tx + 16 * ii];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) cb[jj] = s_lc[k][ty + 16 * jj];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = fma(ra[ii], cb[jj], acc[ii][jj]);
  }
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int c = c0 + ty + 16 * jj;
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int r = r0 + tx + 16 * ii;
      if (r < N && c <= r) {
        T* x = a + (size_t)c * N + r;
        *x -= acc[ii][jj];
      }
    }
  }
}

// (d) Finalize: row-major lower triangle <- L, row-major upper triangle <- 0.
// In memory, L(r, c) for r > c sits at a[c * N + r], the row-major upper
// triangle, so this is an in-place transpose of the strict upper triangle into
// the strict lower one.  Grid: (32 x 32 tiles) x (32 x 32 tiles) x batch;
// block (bx, by) with bx <= by swaps memory tiles (bx, by) and (by, bx)
// through shared memory; the diagonal stays as it is.
template <typename T>
__global__ void ldl_finalize_kernel(T* __restrict__ K, int N) {
  const int bx = blockIdx.x, by = blockIdx.y;
  if (bx > by) return;
  T* a = K + (size_t)blockIdx.z * N * N;
  __shared__ T tile[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  // source: memory rows bx*32 + i, columns by*32 + tx (upper side)
  for (int i = ty; i < 32; i += blockDim.y) {
    const int row = bx * 32 + i, col = by * 32 + tx;
    if (row < N && col < N) tile[i][tx] = a[(size_t)row * N + col];
  }
  __syncthreads();
  for (int i = ty; i < 32; i += blockDim.y) {
    // lower side: memory (r, c) = (by*32 + i, bx*32 + tx) <- source (c, r)
    const int r = by * 32 + i, c = bx * 32 + tx;
    if (r < N && c < N && r > c) a[(size_t)r * N + c] = tile[tx][i];
    // upper side: memory (bx*32 + i, by*32 + tx) <- 0
    const int ur = bx * 32 + i, uc = by * 32 + tx;
    if (ur < N && uc < N && ur < uc) a[(size_t)ur * N + uc] = T(0);
  }
}

// a warp's rows of one step must fit its 32 lanes (the shuffle of l)
static_assert(SMEM_MAX_COLS <= 32 * unblocked_warps(SMEM_CHUNKS), "too few warps for SMEM_MAX_COLS");
static_assert(64 <= 32 * unblocked_warps(2), "too few warps for 64 columns");

// The shared-memory bytes one block may use, queried once, on the device
// current at the first call (the library serves one card), or minus the
// CUDA error of the query.
int smem_capacity() {
  static const int bytes = [] {
    int dev = 0, b = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&b, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    return err == cudaSuccess ? b : -(int)err;
  }();
  return bytes;
}

// The instance with the fewest chunks that covers the trailing triangle's
// width, so that no lane loops over chunks right of column N - 1.  Each
// instance is allowed the whole capacity once, before its first launch.
template <typename T, int CH = 1>
int launch_unblocked(T* K, const T* sign, int B, int N, int j0, int smem_bytes,
                     T eps, T delta, cudaStream_t stream) {
  if constexpr (CH < SMEM_CHUNKS) {
    if (N - j0 > 32 * CH)
      return launch_unblocked<T, CH + 1>(K, sign, B, N, j0, smem_bytes, eps, delta, stream);
  }
  static const cudaError_t allowed = cudaFuncSetAttribute(
      ldl_unblocked_kernel<T, CH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_capacity());
  if (allowed != cudaSuccess) return (int)allowed;
  ldl_unblocked_kernel<T, CH><<<B, 32 * unblocked_warps(CH), smem_bytes, stream>>>(K, sign, N, j0, eps, delta);
  return (int)cudaGetLastError();
}

// j0 and smem_bytes come from the host's plan: the trailing triangle of
// columns j0 .. N - 1 and its pad must fit smem_bytes, and smem_bytes the
// device.
template <typename T>
int ldl_unblocked(T* K, const T* sign, int B, int N, int j0, int smem_bytes,
                  T eps, T delta, cudaStream_t stream) {
  if (B <= 0 || N <= 0) return 0;
  const long long M = N - j0;
  // the packed triangle and the pad behind it that update_row may read
  if (j0 < 0 || M <= 0 || M > SMEM_MAX_COLS ||
      (M * (M + 1) / 2 + (M + 31) / 32 * 32 - M) * (long long)sizeof(T) > smem_bytes)
    return (int)cudaErrorInvalidValue;
  const int capacity = smem_capacity();
  if (capacity < 0) return -capacity;
  if (smem_bytes > capacity) return (int)cudaErrorInvalidValue;
  return launch_unblocked<T>(K, sign, B, N, j0, smem_bytes, eps, delta, stream);
}

template <typename T>
int ldl_blocked(T* K, T* dbuf, T* ubuf, const T* sign, int B, int N, T eps,
                T delta, cudaStream_t stream) {
  if (B <= 0 || N <= 0) return 0;
  for (int p0 = 0; p0 < N; p0 += PANEL_WIDTH) {
    const int pe = (p0 + PANEL_WIDTH < N) ? p0 + PANEL_WIDTH : N;
    ldl_diag_kernel<T><<<B, dim3(PANEL_WIDTH, PANEL_WIDTH), 0, stream>>>(
        K, dbuf, ubuf, sign, N, p0, pe, eps, delta);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int M = N - pe;
    if (M > 0) {  // then pe - p0 == PANEL_WIDTH
      const dim3 slabs((unsigned)((M + ROW_THREADS - 1) / ROW_THREADS), (unsigned)B);
      ldl_rows_kernel<T><<<slabs, ROW_THREADS, 0, stream>>>(K, dbuf, ubuf, N, p0, pe);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      const long long tiles = (M + TILE - 1) / TILE;
      const dim3 grid((unsigned)(tiles * (tiles + 1) / 2), (unsigned)B);
      ldl_trailing_kernel<T><<<grid, TRAILING_THREADS, 0, stream>>>(K, dbuf, N, p0, pe);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  const unsigned nt = (unsigned)((N + 31) / 32);
  ldl_finalize_kernel<T><<<dim3(nt, nt, (unsigned)B), dim3(32, 8), 0, stream>>>(K, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ldl_unblocked_f64(double* K, const double* sign, int B, int N, int j0,
                      int smem_bytes, double eps, double delta, void* stream) {
  return ldl_unblocked<double>(K, sign, B, N, j0, smem_bytes, eps, delta, (cudaStream_t)stream);
}

int ldl_unblocked_f32(float* K, const float* sign, int B, int N, int j0,
                      int smem_bytes, float eps, float delta, void* stream) {
  return ldl_unblocked<float>(K, sign, B, N, j0, smem_bytes, eps, delta, (cudaStream_t)stream);
}

// The bytes of shared memory one block may use on the library's card
// (cudaDevAttrMaxSharedMemoryPerBlockOptin), or minus the CUDA error.
int ldl_smem_capacity(void) { return smem_capacity(); }

int ldl_smem_max_cols(void) { return SMEM_MAX_COLS; }

// dbuf [B, N] and ubuf [B, PANEL_WIDTH, PANEL_WIDTH] are scratch of K's type.
int ldl_blocked_f64(double* K, double* dbuf, double* ubuf, const double* sign,
                    int B, int N, double eps, double delta, void* stream) {
  return ldl_blocked<double>(K, dbuf, ubuf, sign, B, N, eps, delta, (cudaStream_t)stream);
}

int ldl_blocked_f32(float* K, float* dbuf, float* ubuf, const float* sign,
                    int B, int N, float eps, float delta, void* stream) {
  return ldl_blocked<float>(K, dbuf, ubuf, sign, B, N, eps, delta, (cudaStream_t)stream);
}

int ldl_panel_width(void) { return PANEL_WIDTH; }

}  // extern "C"
