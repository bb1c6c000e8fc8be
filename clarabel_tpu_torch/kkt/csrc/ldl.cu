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
// So the designs below are the simple ones: the matrix stays in device
// memory (L2-resident at these sizes) and the arithmetic is FP64/FP32 FMA.
//
// Bound on the H100 SXM (NVIDIA datasheet): the factorization is N³/3
// multiply-adds (2N³/3 flops) and moves at least 2·N²·sizeof(T) bytes.  At
// N = 2001, f64: 5.3 GFLOP, which is 79 µs at the 67 TFLOP/s FP64 tensor-core
// peak and 157 µs at the 34 TFLOP/s FP64 FMA peak, against 19 µs for the
// 64 MB at 3.35 TB/s: compute bounds it.  What keeps these kernels far from
// that bound: the panel factorization runs on one SM per matrix, one column
// at a time with two block-wide barriers per column, and the trailing update
// uses scalar FMAs on 64 x 64 tiles staged through shared memory.  DMMA
// (mma.sync f64) tiles for the trailing update, a panel spread over several
// SMs, and TMA loads are the work of a later change.

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

constexpr int UNBLOCKED_THREADS = 256;
constexpr int PANEL_THREADS = 1024;
constexpr int PANEL_WIDTH = 32;  // columns per panel of the blocked kernel
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
// Grid: one block per matrix.  Column j: every thread reads and regularizes
// the pivot; warps take rows r > j, lanes take columns c >= r, and update the
// upper triangle K[r][c] -= (K[j][r] / d) * K[j][c]; a barrier; then row j is
// overwritten with its packed form.  Row j is never read again, so one
// barrier per column suffices.  The N³/6 updates run on one SM per matrix:
// this kernel is for N <= 256, where the whole matrix is L1/L2-resident.
//
// Bound: at N = 200 the 2·N²·sizeof(T) bytes (0.64 MB at f64, 0.19 µs at
// 3.35 TB/s per matrix) outweigh the N³/3 multiply-adds (0.08 µs at
// 67 TFLOP/s).  The kernel is far from either: its 200 columns are 200
// dependent steps of one block, each a barrier and an L1/L2 round trip.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(UNBLOCKED_THREADS)
ldl_unblocked_kernel(T* __restrict__ K, const T* __restrict__ sign, int N,
                     T eps, T delta) {
  T* a = K + (size_t)blockIdx.x * N * N;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int j = 0; j < N; ++j) {
    const T* rowj = a + (size_t)j * N;
    const T d = regularize(rowj[j], sign[j], eps, delta);
    for (int r = j + 1 + warp; r < N; r += nwarps) {
      const T l = rowj[r] / d;
      T* rowr = a + (size_t)r * N;
      for (int c = r + lane; c < N; c += 32)
        rowr[c] = sub_rn(rowr[c], mul_rn(l, rowj[c]));
    }
    __syncthreads();
    const T zero_over_d = T(0) / d;
    T* roww = a + (size_t)j * N;
    for (int c = threadIdx.x; c < N; c += blockDim.x) {
      const T v = roww[c];
      roww[c] = (c < j) ? zero_over_d : (c == j ? d : v / d);
    }
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

// Bound: N³/3 multiply-adds; at N = 2001, f64, 0.080 ms at the 67 TFLOP/s
// FP64 tensor-core peak (the header gives the rest).  The panel kernel's
// serial column steps take most of the time; the trailing update, the N³/3
// work itself, is the smaller part at these sizes.
//
// (a) Panel: one block per matrix factors columns [p0, pe) over rows [p0, N).
// Column j: thread 0 regularizes the pivot; the panel rows of column j are
// staged in shared memory; each thread takes rows r > j, forms
// l = A(r, j) / d, updates A(r, c) -= l * A(c, j) for c in (j, min(r, pe-1)]
// and stores l as L(r, j).  d goes to dbuf for the trailing update.
template <typename T>
__global__ void __launch_bounds__(PANEL_THREADS)
ldl_panel_kernel(T* __restrict__ K, T* __restrict__ dbuf,
                 const T* __restrict__ sign, int N, int p0, int pe, T eps,
                 T delta) {
  T* a = K + (size_t)blockIdx.x * N * N;
  T* dv = dbuf + (size_t)blockIdx.x * N;
  __shared__ T s_col[PANEL_WIDTH];
  __shared__ T s_d;
  for (int j = p0; j < pe; ++j) {
    T* colj = a + (size_t)j * N;  // colj[r] = A(r, j)
    if (threadIdx.x == 0) {
      const T piv = colj[j];
      const T d = regularize(piv, sign[j], eps, delta);
      s_d = d;
      dv[j] = d;
      colj[j] = add_rn(d, mul_rn(T(0), piv));
    }
    for (int c = j + 1 + threadIdx.x; c < pe; c += blockDim.x)
      s_col[c - p0] = colj[c];
    __syncthreads();
    const T d = s_d;
    for (int r = j + 1 + threadIdx.x; r < N; r += blockDim.x) {
      const T l = colj[r] / d;
      const int cend = min(r, pe - 1);
      for (int c = j + 1; c <= cend; ++c) {
        T* x = a + (size_t)c * N + r;
        *x = sub_rn(*x, mul_rn(l, s_col[c - p0]));
      }
      colj[r] = l;
    }
    __syncthreads();
  }
}

// (b) Trailing update: A(r, c) -= sum_k (L(r, k) * d_k) * L(c, k) over the
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

// (c) Finalize: row-major lower triangle <- L, row-major upper triangle <- 0.
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

template <typename T>
int ldl_unblocked(T* K, const T* sign, int B, int N, T eps, T delta,
                  cudaStream_t stream) {
  if (B <= 0 || N <= 0) return 0;
  ldl_unblocked_kernel<T><<<B, UNBLOCKED_THREADS, 0, stream>>>(K, sign, N, eps, delta);
  return (int)cudaGetLastError();
}

template <typename T>
int ldl_blocked(T* K, T* dbuf, const T* sign, int B, int N, T eps, T delta,
                cudaStream_t stream) {
  if (B <= 0 || N <= 0) return 0;
  for (int p0 = 0; p0 < N; p0 += PANEL_WIDTH) {
    const int pe = (p0 + PANEL_WIDTH < N) ? p0 + PANEL_WIDTH : N;
    ldl_panel_kernel<T><<<B, PANEL_THREADS, 0, stream>>>(K, dbuf, sign, N, p0, pe, eps, delta);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int M = N - pe;
    if (M > 0) {
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

int ldl_unblocked_f64(double* K, const double* sign, int B, int N, double eps,
                      double delta, void* stream) {
  return ldl_unblocked<double>(K, sign, B, N, eps, delta, (cudaStream_t)stream);
}

int ldl_unblocked_f32(float* K, const float* sign, int B, int N, float eps,
                      float delta, void* stream) {
  return ldl_unblocked<float>(K, sign, B, N, eps, delta, (cudaStream_t)stream);
}

int ldl_blocked_f64(double* K, double* dbuf, const double* sign, int B, int N,
                    double eps, double delta, void* stream) {
  return ldl_blocked<double>(K, dbuf, sign, B, N, eps, delta, (cudaStream_t)stream);
}

int ldl_blocked_f32(float* K, float* dbuf, const float* sign, int B, int N,
                    float eps, float delta, void* stream) {
  return ldl_blocked<float>(K, dbuf, sign, B, N, eps, delta, (cudaStream_t)stream);
}

int ldl_panel_width(void) { return PANEL_WIDTH; }

}  // extern "C"
