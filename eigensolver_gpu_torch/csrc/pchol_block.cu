// Kernel K1: planar Cholesky of one HPD diagonal block, its inverse, and
// the first bad pivot -- one thread block per diagonal block, launched once
// per block step of the left-looking planar Cholesky
// (eigensolver_gpu_torch/ops/planar.py::pcholesky_lower).
//
// Replaces: eigensolver_gpu_tpu/ops/pchol_pallas.py::pchol_block_planar_pallas
// (pallas_call at :129, body _pchol_block_kernel at :43).
//
// What bounds it on the H100: latency. The block is 2 x 128 x 128 fp32 in
// and 4 x 128 x 128 out (384 KB, ~0.1 us of HBM time) and ~5.6 MFLOP, but
// the factorization is 128 dependent column steps and the inverse another
// 128, each step waiting on the previous one at a __syncthreads(): the
// time is ~2 x 128 x (barrier + one step's shared-memory round trip).
//
// What the design does about it:
//   * one block of 1024 threads, so each step's trailing update is spread
//     over all 32 warps and the step costs a few shared-memory accesses
//     per thread;
//   * L (two 128 x 128 planes, 128 KB) lives in dynamic shared memory for
//     both phases -- the Pallas kernel kept four planes in VMEM (256 KB),
//     more than a block's 227 KB, so inv(L) lives in registers instead:
//     thread (rg, c) owns column c of rows rg, rg+8, ..., rg+120;
//   * the scaled pivot column is staged in a 128-entry buffer, so the
//     trailing update reads it by broadcast and the factor only updates
//     the lower triangle (the Pallas kernel's one-hot lane reductions
//     existed only because Mosaic cannot index lanes dynamically);
//   * the inverse's pivot row is double-buffered, so each inverse step
//     needs one barrier instead of two.
//
// Contract (same as the Pallas kernel): fail = 1-based index of the first
// pivot that is <= 0 or NaN, 0 if none; a bad pivot is clamped to FLT_MIN
// (a NaN pivot stays NaN) and the factorization continues. Outputs are
// row-major nb x nb with the strict upper triangles zero.

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>

namespace {

constexpr int kNbMax = 128;
constexpr int kThreads = 1024;
constexpr int kRowGroups = kThreads / kNbMax;     // 8
constexpr int kRowsPerThread = kNbMax / kRowGroups;  // 16

__global__ void __launch_bounds__(kThreads)
pchol_block_kernel(const float* __restrict__ ar, const float* __restrict__ ai,
                   int lda, int nb, float* __restrict__ ldr,
                   float* __restrict__ ldi, float* __restrict__ invr,
                   float* __restrict__ invi, int* __restrict__ fail_out) {
  extern __shared__ float smem[];
  float* Lr = smem;             // nb x nb, row-major
  float* Li = smem + nb * nb;
  __shared__ float col_r[kNbMax];
  __shared__ float col_i[kNbMax];
  __shared__ float row_r[2][kNbMax];
  __shared__ float row_i[2][kNbMax];

  const int t = threadIdx.x;
  const int c = t % kNbMax;   // column this thread updates
  const int rg = t / kNbMax;  // its rows: rg + kRowGroups * i

  for (int idx = t; idx < nb * nb; idx += kThreads) {
    const int r = idx / nb, cc = idx % nb;
    Lr[idx] = ar[(size_t)r * lda + cc];
    Li[idx] = ai[(size_t)r * lda + cc];
  }
  __syncthreads();

  // ---- factor: lower triangle only, column j scaled then downdated ----
  int fail = 0;
  for (int j = 0; j < nb; ++j) {
    const float pivot = Lr[j * nb + j];
    if (fail == 0 && !(pivot > 0.0f)) fail = j + 1;  // <= 0 or NaN
    const float dj = sqrtf(isnan(pivot) ? pivot : fmaxf(pivot, FLT_MIN));
    if (t > j && t < nb) {
      const float vr = Lr[t * nb + j] / dj;
      const float vi = Li[t * nb + j] / dj;
      col_r[t] = vr;
      col_i[t] = vi;
      Lr[t * nb + j] = vr;
      Li[t * nb + j] = vi;
    }
    __syncthreads();
    // every thread has read the pivot by now; nobody reads (j, j) below
    if (t == j) {
      Lr[j * nb + j] = dj;
      Li[j * nb + j] = 0.0f;
    }
    if (c > j && c < nb) {
      const float qr = col_r[c], qi = col_i[c];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int r = rg + kRowGroups * i;
        if (r >= c && r < nb) {
          const float pr = col_r[r], pi = col_i[r];
          // A[r, c] -= l[r] * conj(l[c])
          Lr[r * nb + c] -= pr * qr + pi * qi;
          Li[r * nb + c] -= pi * qr - pr * qi;
        }
      }
    }
    __syncthreads();
  }
  if (t == 0) *fail_out = fail;

  for (int idx = t; idx < nb * nb; idx += kThreads) {
    const int r = idx / nb, cc = idx % nb;
    const bool low = cc <= r;
    ldr[idx] = low ? Lr[idx] : 0.0f;
    ldi[idx] = low ? Li[idx] : 0.0f;
  }

  // ---- inverse: forward substitution on I, downdate form, in registers --
  float xr[kRowsPerThread], xi[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = rg + kRowGroups * i;
    xr[i] = (r == c) ? 1.0f : 0.0f;
    xi[i] = 0.0f;
  }
  for (int j = 0; j < nb; ++j) {
    const int buf = j & 1;
    if (rg == j % kRowGroups && c < nb) {
      const float djj = Lr[j * nb + j];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        if (i == j / kRowGroups) {
          xr[i] /= djj;
          xi[i] /= djj;
          row_r[buf][c] = xr[i];
          row_i[buf][c] = xi[i];
        }
      }
    }
    __syncthreads();
    if (c < nb) {
      const float yr = row_r[buf][c], yi = row_i[buf][c];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int r = rg + kRowGroups * i;
        if (r > j && r < nb) {
          const float lr = Lr[r * nb + j], li = Li[r * nb + j];
          xr[i] -= lr * yr - li * yi;
          xi[i] -= lr * yi + li * yr;
        }
      }
    }
  }
  if (c < nb) {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = rg + kRowGroups * i;
      if (r < nb) {
        invr[r * nb + c] = xr[i];
        invi[r * nb + c] = xi[i];
      }
    }
  }
}

}  // namespace

// Launch on `stream`. nb <= 128; a, out row-major (lda for the input).
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int pchol_block_planar_launch(const float* ar, const float* ai,
                                         int lda, int nb, float* ldr,
                                         float* ldi, float* invr, float* invi,
                                         int* fail, void* stream) {
  if (nb < 1 || nb > kNbMax) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * sizeof(float) * kNbMax * kNbMax;
  cudaError_t err = cudaFuncSetAttribute(
      pchol_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  pchol_block_kernel<<<1, kThreads, 2 * sizeof(float) * nb * nb,
                       (cudaStream_t)stream>>>(ar, ai, lda, nb, ldr, ldi,
                                               invr, invi, fail);
  return (int)cudaGetLastError();
}
