// Kernel K2: one nb-column zlatrd panel of the planar hetrd (nb <= 32,
// mb <= 4096), columns panel_end-1 down to panel_end-nb.
//
// Replaces: eigensolver_gpu_tpu/ops/latrd_pallas.py::latrd_panel_planar
// (pallas_call at :333, _latrd_kernel at :228, _phase at :58), itself the
// fused form of the reference's per-column chain zher2_mv_zlarfg ->
// zhemv -> stacked_zgemv_C -> stacked_zgemv_N_finish_W, glued there by an
// atomics-based software grid barrier (zhetrd_gpu.F90:142-163).
//
// What bounds it on the H100: memory. Each column's y = A v streams the
// leading cj x cj block of both planes: 8 * cj^2 bytes, up to 134 MB at
// mb = 4096, i.e. ~40 us per column at 3.35 TB/s, ~1.3 ms per panel. The
// rest is latency: per column one dependent chain of small reductions
// (the compact-WY corrections, zlarfg, the W finish) that no amount of
// parallelism shortens.
//
// What the design does about it: the Pallas kernel carried y, a_col and
// tau from one step of its sequential (nb+2, tiles) grid to the next; a
// CUDA grid has no order, so each column is two launches on one stream:
//   * latrd_matvec -- row-parallel, one warp per row, reads A's rows
//     < cj coalesced and writes y = A v (v is zero from row cj on, so
//     only the leading cj x cj block is read);
//   * latrd_step -- one block of 1024 threads: finishes W for the column
//     whose y just arrived (corrections, tau, the alpha update), then
//     prepares the next column (its raw column read from A, the
//     corrections, a branch-free zlarfg, the v / packed-column / scalar
//     writes). Block-wide sums go through warp shuffles.
// The work panels are kept slot-major (a slot's column is contiguous), so
// every per-slot read in the step kernel is coalesced; the caller sees
// them as (mb, nb) views. Sums are taken in another order than the TPU's,
// so outputs agree to a tolerance, not bitwise.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMbMax = 4096;
constexpr int kRows = kMbMax / kThreads;  // rows per thread in the step
constexpr int kNbMax = 32;                // one warp per slot
constexpr int kMvWarps = 8;               // rows per matvec block

enum Plane { VR = 0, VI, WR, WI, CR, CI };

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Sum of (a, b) over the block; every thread gets the totals.
__device__ float2 block_sum2(float a, float b, float* red) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read from a previous call
  if (lane == 0) {
    red[warp] = a;
    red[kWarps + warp] = b;
  }
  __syncthreads();
  return make_float2(warp_sum(red[lane]), warp_sum(red[kWarps + lane]));
}

// y[r] = sum_{c < n} A[r, c] v[c] for r < n (planar complex).
__global__ void __launch_bounds__(kMvWarps * 32)
latrd_matvec(const float* __restrict__ ar, const float* __restrict__ ai,
             int lda, int n, const float* __restrict__ vr,
             const float* __restrict__ vi, float* __restrict__ yr,
             float* __restrict__ yi) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kMvWarps + (threadIdx.x >> 5);
  if (row >= n) return;
  const float* pr = ar + (size_t)row * lda;
  const float* pi = ai + (size_t)row * lda;
  float sr = 0.0f, si = 0.0f;
#pragma unroll 4
  for (int c = lane; c < n; c += 32) {
    const float a = __ldg(pr + c), b = __ldg(pi + c);
    const float x = __ldg(vr + c), z = __ldg(vi + c);
    sr += a * x - b * z;
    si += a * z + b * x;
  }
  sr = warp_sum(sr);
  si = warp_sum(si);
  if (lane == 0) {
    yr[row] = sr;
    yi[row] = si;
  }
}

// Finish W for slot s_fin (if >= 0), then prepare slot s_prep (if >= 0).
// pan: [6][nb][mb] slot-major planes; scal: [4][nb] = (d, e, tau_r, tau_i).
__global__ void __launch_bounds__(kThreads)
latrd_step(const float* __restrict__ ar, const float* __restrict__ ai, int lda,
           int mb, int pe, int nb, int s_fin, int s_prep, float* pan,
           float* scal, const float* __restrict__ y) {
  __shared__ float v_r[kMbMax], v_i[kMbMax];
  __shared__ float zc[4][kNbMax];
  __shared__ float red[2 * kWarps];
  __shared__ float sc[3];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  auto slot = [&](int plane, int k) {
    return pan + ((size_t)plane * nb + k) * mb;
  };

  if (s_fin >= 0) {
    const int s = s_fin, cj = pe - 1 - s;
    for (int r = t; r < mb; r += kThreads) {
      v_r[r] = slot(VR, s)[r];
      v_i[r] = slot(VI, s)[r];
    }
    __syncthreads();
    // warp k: (W^H v)_k and (V^H v)_k over rows < cj (v is zero below)
    if (warp < s) {
      const float *wkr = slot(WR, warp), *wki = slot(WI, warp);
      const float *vkr = slot(VR, warp), *vki = slot(VI, warp);
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      for (int r = lane; r < cj; r += 32) {
        const float x = v_r[r], z = v_i[r];
        float p = wkr[r], q = wki[r];
        a0 += p * x + q * z;
        a1 += p * z - q * x;
        p = vkr[r];
        q = vki[r];
        a2 += p * x + q * z;
        a3 += p * z - q * x;
      }
      a0 = warp_sum(a0);
      a1 = warp_sum(a1);
      a2 = warp_sum(a2);
      a3 = warp_sum(a3);
      if (lane == 0) {
        zc[0][warp] = a0;
        zc[1][warp] = a1;
        zc[2][warp] = a2;
        zc[3][warp] = a3;
      }
    }
    __syncthreads();
    // y -= V (W^H v) + W (V^H v);  w = tau y;  h = w^H v
    const float tr = scal[2 * nb + s], ti = scal[3 * nb + s];
    float w_r[kRows], w_i[kRows];
    float hr = 0.f, hi = 0.f;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = t + i * kThreads;
      float yr = 0.f, yi = 0.f;
      if (r < cj) {
        yr = y[r];
        yi = y[mb + r];
        for (int k = 0; k < s; ++k) {
          const float vr = slot(VR, k)[r], vi = slot(VI, k)[r];
          const float wr = slot(WR, k)[r], wi = slot(WI, k)[r];
          yr -= vr * zc[0][k] - vi * zc[1][k] + wr * zc[2][k] - wi * zc[3][k];
          yi -= vr * zc[1][k] + vi * zc[0][k] + wr * zc[3][k] + wi * zc[2][k];
        }
      }
      w_r[i] = tr * yr - ti * yi;
      w_i[i] = tr * yi + ti * yr;
      if (r < mb) {
        hr += w_r[i] * v_r[r] + w_i[i] * v_i[r];
        hi += w_r[i] * v_i[r] - w_i[i] * v_r[r];
      }
    }
    const float2 h = block_sum2(hr, hi, red);
    const float al_r = -0.5f * (tr * h.x - ti * h.y);
    const float al_i = -0.5f * (tr * h.y + ti * h.x);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = t + i * kThreads;
      if (r < mb) {
        const bool keep = r < cj;
        slot(WR, s)[r] = keep ? w_r[i] + al_r * v_r[r] - al_i * v_i[r] : 0.f;
        slot(WI, s)[r] = keep ? w_i[i] + al_r * v_i[r] + al_i * v_r[r] : 0.f;
      }
    }
    __syncthreads();  // W[s] and zc reads done before the prepare phase
  }

  if (s_prep >= 0) {
    const int s = s_prep, cj = pe - 1 - s;
    const int pidx = cj > 0 ? cj - 1 : 0;
    const bool has_r = cj > 0;
    if (t < s) {  // row cj of W and V, the zlacgv'd pair
      zc[0][t] = slot(WR, t)[cj];
      zc[1][t] = slot(WI, t)[cj];
      zc[2][t] = slot(VR, t)[cj];
      zc[3][t] = slot(VI, t)[cj];
    }
    __syncthreads();
    // a = A[:, cj] - V conj(w_row) - W conj(v_row)
    float a_r[kRows], a_i[kRows];
    float xn = 0.f;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = t + i * kThreads;
      float xr = 0.f, xi = 0.f;
      if (r < mb) {
        xr = ar[(size_t)r * lda + cj];
        xi = ai[(size_t)r * lda + cj];
        for (int k = 0; k < s; ++k) {
          const float vr = slot(VR, k)[r], vi = slot(VI, k)[r];
          const float wr = slot(WR, k)[r], wi = slot(WI, k)[r];
          xr -= vr * zc[0][k] + vi * zc[1][k] + wr * zc[2][k] + wi * zc[3][k];
          xi -= vi * zc[0][k] - vr * zc[1][k] + wi * zc[2][k] - wr * zc[3][k];
        }
        if (r == cj) sc[0] = xr;
        if (r == pidx) {
          sc[1] = xr;
          sc[2] = xi;
        }
        if (r < cj - 1) xn += xr * xr + xi * xi;
      }
      a_r[i] = xr;
      a_i[i] = xi;
    }
    const float xnormsq = block_sum2(xn, 0.f, red).x;  // also publishes sc
    const float d_val = sc[0], alphr = sc[1], alphi = sc[2];

    // branch-free planar zlarfg (ops/sytrd_planar.py::_larfg_planar)
    const float norm = sqrtf(alphr * alphr + alphi * alphi + xnormsq);
    float beta = alphr >= 0.f ? -norm : norm;
    const bool trivial = (xnormsq == 0.f) && (alphi == 0.f);
    const float safe_beta = trivial ? 1.f : beta;
    float tk_r = (beta - alphr) / safe_beta, tk_i = -alphi / safe_beta;
    const float dr = alphr - beta;
    const float den = dr * dr + alphi * alphi;
    const float safe_den = trivial ? 1.f : den;
    float sc_r = dr / safe_den, sc_i = -alphi / safe_den;
    if (trivial || !has_r) tk_r = tk_i = sc_r = sc_i = 0.f;
    if (trivial) beta = alphr;

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = t + i * kThreads;
      if (r < mb) {
        const bool xm = r < cj - 1;
        const bool one = has_r && r == cj - 1;
        float vr = xm ? a_r[i] * sc_r - a_i[i] * sc_i : 0.f;
        float vi = xm ? a_r[i] * sc_i + a_i[i] * sc_r : 0.f;
        if (one) {
          vr = 1.f;
          vi = 0.f;
        }
        slot(VR, s)[r] = vr;
        slot(VI, s)[r] = vi;
        float cr = xm ? vr : a_r[i], ci = xm ? vi : a_i[i];
        if (one) {
          cr = beta;
          ci = 0.f;
        }
        if (r == cj) {
          cr = d_val;
          ci = 0.f;
        }
        slot(CR, s)[r] = cr;
        slot(CI, s)[r] = ci;
      }
    }
    if (t == 0) {
      scal[s] = d_val;
      scal[nb + s] = has_r ? beta : 0.f;
      scal[2 * nb + s] = tk_r;
      scal[3 * nb + s] = tk_i;
    }
  }
}

}  // namespace

// Run one panel on `stream`: 1 + 2 * nb launches. pan [6][nb][mb] and scal
// [4][nb] must be zeroed by the caller; y is [2][mb] scratch. Returns the
// first cudaError_t met while launching (0 = all launched).
extern "C" int latrd_panel_planar_launch(const float* ar, const float* ai,
                                         int lda, int mb, int pe, int nb,
                                         float* pan, float* scal, float* y,
                                         void* stream) {
  if (nb < 1 || nb > kNbMax || pe < nb || pe > mb || mb > kMbMax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  latrd_step<<<1, kThreads, 0, st>>>(ar, ai, lda, mb, pe, nb, -1, 0, pan, scal,
                                     y);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int s = 0; s < nb; ++s) {
    const int cj = pe - 1 - s;
    if (cj > 0) {
      latrd_matvec<<<(cj + kMvWarps - 1) / kMvWarps, kMvWarps * 32, 0, st>>>(
          ar, ai, lda, cj, pan + ((size_t)VR * nb + s) * mb,
          pan + ((size_t)VI * nb + s) * mb, y, y + mb);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    latrd_step<<<1, kThreads, 0, st>>>(ar, ai, lda, mb, pe, nb, s,
                                       s + 1 < nb ? s + 1 : -1, pan, scal, y);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
