// Kernels K4 and K3: symmetric / planar Hermitian matrix-vector product
// that reads only the upper tiles of a full-stored matrix -- the hot
// `A v` of every tridiagonalization panel column
// (eigensolver_gpu_torch/ops/sytrd.py::_panel_columns and
// ops/sytrd_planar.py::_panel_columns_planar, use_pallas=True).
//
// Replaces:
//   K4  eigensolver_gpu_tpu/ops/symv_pallas.py::symv
//       (pallas_call at :117, body _symv_kernel at :58);
//   K3  eigensolver_gpu_tpu/ops/hemv_pallas.py::hemv_planar
//       (pallas_call at :100, body _hemv_kernel at :39).
//
// What they compute: y = A v for symmetric A (K4), and
// (yr, yi) = (Ar + i Ai)(vr + i vi) for Ar symmetric, Ai antisymmetric
// (K3). Every off-diagonal upper tile T = A[bi, bj] (bi < bj) is read once
// and used twice: T v[bj] goes to y[bi], and T^H v[bi] to y[bj]; a
// diagonal tile is used once. For the planar pair, with Tr, Ti the tiles of
// Ar, Ai:
//     y[bi] += (Tr vr_j - Ti vi_j,   Tr vi_j + Ti vr_j)
//     y[bj] += (Tr^T vr_i + Ti^T vi_i,   Tr^T vi_i - Ti^T vr_i)
//
// What bounds them on the H100: bytes. n = 4096 in fp32 is 33.6 MB of
// upper tiles (2 flop per byte read), far below the fp32 rate.
//
// Ordering. The Pallas kernels accumulate into y across a sequential TPU
// grid; a CUDA grid has no order. Here no two blocks ever add to the same
// address: the tile (bi, bj) writes its two 64-vectors into a partial
// buffer P of shape (nt, n) -- the row product into P[bj, rows of bi], the
// transposed product into P[bi, rows of bj] -- so every slot of P is
// written exactly once, by one block, and needs no zeroing. A second
// launch sums P over its first axis in the fixed order k = 0 .. nt-1. The
// result is therefore bit-reproducible from run to run (no atomics), at
// the price of nt * n extra floats written and read (1 MB at n = 4096,
// 3 % of the matrix bytes).
//
// Design: one 256-thread block per 64 x 64 upper tile (a 2-D grid whose
// lower-triangle blocks exit at once). The tile is staged in padded shared
// memory with coalesced row reads; 128 threads then form the row product
// and 128 the transposed product, each a conflict-free walk of 32 tile
// entries, and a last step adds the two halves. Any n >= 1 is taken: edge
// tiles are guarded, and the matrix may be a view (row stride lda >= n).
// Plain FMA arithmetic, no tensor cores.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr int kHalf = kTile / 2;

// Stage the tile A[r0 : r0+64, c0 : c0+64] (zero past n) in shared memory.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ a, size_t lda,
                                          int n, int r0, int c0,
                                          T (*s)[kTile + 1]) {
  const int col = threadIdx.x % kTile;
  const int gc = c0 + col;
  for (int row = threadIdx.x / kTile; row < kTile; row += kThreads / kTile) {
    const int gr = r0 + row;
    s[row][col] = (gr < n && gc < n) ? a[(size_t)gr * lda + gc] : T(0);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
symv_tiles(const T* __restrict__ a, int lda, int n, const T* __restrict__ v,
           T* __restrict__ part) {
  const int bi = blockIdx.y, bj = blockIdx.x;
  if (bi > bj) return;
  __shared__ T s[kTile][kTile + 1];
  __shared__ T vi[kTile], vj[kTile];
  __shared__ T red[4][kTile];
  const int t = threadIdx.x;
  const int r0 = bi * kTile, c0 = bj * kTile;
  load_tile(a, (size_t)lda, n, r0, c0, s);
  if (t < kTile) {
    vi[t] = r0 + t < n ? v[r0 + t] : T(0);
  } else if (t < 2 * kTile) {
    const int j = t - kTile;
    vj[j] = c0 + j < n ? v[c0 + j] : T(0);
  }
  __syncthreads();
  const int idx = t % kTile;
  const int half = (t / kTile) & 1;
  T acc = T(0);
  if (t < 2 * kTile) {  // row product: sum_j s[idx][j] vj[j]
    for (int j = half * kHalf; j < (half + 1) * kHalf; ++j)
      acc += s[idx][j] * vj[j];
  } else {  // transposed product: sum_i s[i][idx] vi[i]
    for (int i = half * kHalf; i < (half + 1) * kHalf; ++i)
      acc += s[i][idx] * vi[i];
  }
  red[t / kTile][idx] = acc;
  __syncthreads();
  if (t < kTile) {
    if (r0 + t < n) part[(size_t)bj * n + r0 + t] = red[0][t] + red[1][t];
  } else if (t < 2 * kTile && bi != bj) {
    const int j = t - kTile;
    if (c0 + j < n) part[(size_t)bi * n + c0 + j] = red[2][j] + red[3][j];
  }
}

__global__ void __launch_bounds__(kThreads)
hemv_planar_tiles(const float* __restrict__ ar, const float* __restrict__ ai,
                  int lda, int n, const float* __restrict__ vr,
                  const float* __restrict__ vi, float* __restrict__ part_r,
                  float* __restrict__ part_i) {
  const int bi = blockIdx.y, bj = blockIdx.x;
  if (bi > bj) return;
  __shared__ float sr[kTile][kTile + 1];
  __shared__ float si[kTile][kTile + 1];
  __shared__ float vir[kTile], vii[kTile], vjr[kTile], vji[kTile];
  __shared__ float red_r[4][kTile], red_i[4][kTile];
  const int t = threadIdx.x;
  const int r0 = bi * kTile, c0 = bj * kTile;
  load_tile(ar, (size_t)lda, n, r0, c0, sr);
  load_tile(ai, (size_t)lda, n, r0, c0, si);
  if (t < kTile) {
    const bool in = r0 + t < n;
    vir[t] = in ? vr[r0 + t] : 0.f;
    vii[t] = in ? vi[r0 + t] : 0.f;
  } else if (t < 2 * kTile) {
    const int j = t - kTile;
    const bool in = c0 + j < n;
    vjr[j] = in ? vr[c0 + j] : 0.f;
    vji[j] = in ? vi[c0 + j] : 0.f;
  }
  __syncthreads();
  const int idx = t % kTile;
  const int half = (t / kTile) & 1;
  float acc_r = 0.f, acc_i = 0.f;
  if (t < 2 * kTile) {  // (Tr + i Ti) v_j
    for (int j = half * kHalf; j < (half + 1) * kHalf; ++j) {
      const float tr = sr[idx][j], ti = si[idx][j];
      acc_r += tr * vjr[j] - ti * vji[j];
      acc_i += tr * vji[j] + ti * vjr[j];
    }
  } else {  // (Tr^T - i Ti^T) v_i
    for (int i = half * kHalf; i < (half + 1) * kHalf; ++i) {
      const float tr = sr[i][idx], ti = si[i][idx];
      acc_r += tr * vir[i] + ti * vii[i];
      acc_i += tr * vii[i] - ti * vir[i];
    }
  }
  red_r[t / kTile][idx] = acc_r;
  red_i[t / kTile][idx] = acc_i;
  __syncthreads();
  if (t < kTile) {
    if (r0 + t < n) {
      const size_t o = (size_t)bj * n + r0 + t;
      part_r[o] = red_r[0][t] + red_r[1][t];
      part_i[o] = red_i[0][t] + red_i[1][t];
    }
  } else if (t < 2 * kTile && bi != bj) {
    const int j = t - kTile;
    if (c0 + j < n) {
      const size_t o = (size_t)bi * n + c0 + j;
      part_r[o] = red_r[2][j] + red_r[3][j];
      part_i[o] = red_i[2][j] + red_i[3][j];
    }
  }
}

// y[p, i] = sum_k part[p, k, i], k ascending: the fixed summation order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
sum_partials(const T* __restrict__ part, int nt, int n, int planes,
             T* __restrict__ y) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  for (int p = 0; p < planes; ++p) {
    const T* src = part + (size_t)p * nt * n;
    T acc = T(0);
    for (int k = 0; k < nt; ++k) acc += src[(size_t)k * n + i];
    y[(size_t)p * n + i] = acc;
  }
}

template <typename T>
int symv_launch(const T* a, int lda, int n, const T* v, T* part, T* y,
                void* stream) {
  if (n < 1 || lda < n) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nt = (n + kTile - 1) / kTile;
  symv_tiles<T><<<dim3(nt, nt), kThreads, 0, st>>>(a, lda, n, v, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials<T><<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      part, nt, n, 1, y);
  return (int)cudaGetLastError();
}

}  // namespace

// part: nt * n scratch elements, nt = ceil(n / 64); y: n elements.
extern "C" int symv_f32_launch(const float* a, int lda, int n, const float* v,
                               float* part, float* y, void* stream) {
  return symv_launch<float>(a, lda, n, v, part, y, stream);
}

extern "C" int symv_f64_launch(const double* a, int lda, int n,
                               const double* v, double* part, double* y,
                               void* stream) {
  return symv_launch<double>(a, lda, n, v, part, y, stream);
}

// part: 2 * nt * n scratch floats (real plane, then imaginary);
// y: 2 * n floats (yr, then yi).
extern "C" int hemv_planar_launch(const float* ar, const float* ai, int lda,
                                  int n, const float* vr, const float* vi,
                                  float* part, float* y, void* stream) {
  if (n < 1 || lda < n) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nt = (n + kTile - 1) / kTile;
  hemv_planar_tiles<<<dim3(nt, nt), kThreads, 0, st>>>(
      ar, ai, lda, n, vr, vi, part, part + (size_t)nt * n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials<float><<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      part, nt, n, 2, y);
  return (int)cudaGetLastError();
}
