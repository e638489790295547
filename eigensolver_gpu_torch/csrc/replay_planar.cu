// Kernel K10: planar complex replay of the bulge-chase reflectors onto
// eigenvector columns, y <- Q2 y on (re, im) planes, wave after wave from one
// call (eigensolver_gpu_torch/ops/replay.py::apply_q2_planar_kernel, called
// once per planar two-stage solve by models/zhegvdx_planar.py).
//
// Replaces eigensolver_gpu_tpu/ops/replay_pallas.py::apply_q2_planar_pallas
// (pallas_call at :646, bodies _replay_kernel_resident at :225,
// _replay_kernel_planar at :538, _wave_body at :96).
//
// What it computes (ops/sb2st_planar.py::apply_q2_planar): the wave schedule
// of the real replay (csrc/replay.cu): for each wave in order, for each slot
// i of the wave, with
//     par = wave % 2, c0 = n_groups - 1 - (wave - par) / 2,
//     u = u_lo + i, u_lo = min(max(0, -c0), max(n_u - n_slots, 0)),
//     j = c0 + u, k = par + 2u, a0 = j g + k b,
// the slot is valid when 0 <= j < n_groups, k <= kmax and a0 <= n - 3, and
// then y[a0 + 1 : a0 + 1 + l_win, :] <- Q y[a0 + 1 : a0 + 1 + l_win, :] with
// Q = Q_r + i Q_i the leading l_win x l_win blocks (l_win = b + g - 1 <= 128)
// of qw_r[wave, i] and qw_i[wave, i], 128 x 128 row-major matrices
// precomputed by ops/replay.py::window_qs_planar. Rows at and past n do not
// exist: they read as zero and are not stored (Q is the identity there).
//
// What bounds it on the H100: operations. n = 4096, b = 32, g = 96, m = 4096
// is 8 l_win^2 m flop for each of about 2 800 valid windows, 1.5 Tflop, 22 ms
// at the fp32 FMA rate; both planes of y and of the windows (read once) are
// 1 GB, 0.3 ms.
//
// Design, the real kernel's: one launch per wave, all enqueued from this one
// C call. Windows of one wave start g + 2b rows apart and are l_win rows
// tall, so exactly l_win rows per window never overlap. A block owns one
// (window, 64-column tile): it streams both planes of Q and of the y tile
// through shared memory in chunks along the contraction, keeps an 8 x 4
// complex accumulator tile per thread in registers (four real FMAs per
// term), and writes its rows back only after its last read of them, so the
// update is in place. Fixed summation order: two calls give the same bits.
// Plain FMA arithmetic, no tensor cores; float and double (the double
// instance takes a chunk of 8 so that its tiles fit 48 KB of static shared
// memory).

#include <cuda_runtime.h>

namespace {

constexpr int kP = 128;   // row stride of a stored window, largest l_win
constexpr int kBN = 64;   // columns of y per block
constexpr int kThreads = 256;
constexpr int kTM = 8, kTN = 4;  // accumulator tile of a thread

template <typename T>
__global__ void __launch_bounds__(kThreads)
replay_planar_wave(const T* __restrict__ qw_r, const T* __restrict__ qw_i,
                   T* y_r, T* y_i, int ldy, int n, int m, int b, int g,
                   int wave, int n_groups, int kmax, int n_u, int n_slots) {
  constexpr int kBK = sizeof(T) == 8 ? 8 : 16;  // contraction chunk
  const int i = blockIdx.y;
  const int par = wave % 2;
  const int c0 = n_groups - 1 - (wave - par) / 2;
  int u_lo = c0 < 0 ? -c0 : 0;
  const int u_cap = n_u - n_slots > 0 ? n_u - n_slots : 0;
  if (u_lo > u_cap) u_lo = u_cap;
  const int u = u_lo + i;
  const int j = c0 + u, k = par + 2 * u;
  const int a0 = j * g + k * b;
  if (j < 0 || j >= n_groups || k > kmax || a0 > n - 3) return;
  const int r0 = a0 + 1;
  const int lwin = b + g - 1;
  const int col0 = blockIdx.x * kBN;
  const size_t qoff = ((size_t)wave * n_slots + i) * kP * kP;
  const T* qr = qw_r + qoff;
  const T* qi = qw_i + qoff;

  __shared__ T qsr[kBK][kP + 1];  // qs[kk][row] = Q[row, k0 + kk]
  __shared__ T qsi[kBK][kP + 1];
  __shared__ T ysr[kBK][kBN];     // ys[kk][col] = y[r0 + k0 + kk, col0 + col]
  __shared__ T ysi[kBK][kBN];
  const int tid = threadIdx.x;
  const int ty = tid / (kBN / kTN), tx = tid % (kBN / kTN);
  T acc_r[kTM][kTN], acc_i[kTM][kTN];
#pragma unroll
  for (int a = 0; a < kTM; ++a)
#pragma unroll
    for (int c = 0; c < kTN; ++c) {
      acc_r[a][c] = T(0);
      acc_i[a][c] = T(0);
    }

  for (int k0 = 0; k0 < lwin; k0 += kBK) {
    for (int e = tid; e < kP * kBK; e += kThreads) {
      const int kk = e % kBK, row = e / kBK;
      const bool in = row < lwin && k0 + kk < lwin;
      qsr[kk][row] = in ? qr[(size_t)row * kP + k0 + kk] : T(0);
      qsi[kk][row] = in ? qi[(size_t)row * kP + k0 + kk] : T(0);
    }
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int col = e % kBN, kk = e / kBN;
      const int gr = r0 + k0 + kk, gc = col0 + col;
      const bool in = k0 + kk < lwin && gr < n && gc < m;
      ysr[kk][col] = in ? y_r[(size_t)gr * ldy + gc] : T(0);
      ysi[kk][col] = in ? y_i[(size_t)gr * ldy + gc] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      T qar[kTM], qai[kTM], ybr[kTN], ybi[kTN];
#pragma unroll
      for (int a = 0; a < kTM; ++a) {
        qar[a] = qsr[kk][ty * kTM + a];
        qai[a] = qsi[kk][ty * kTM + a];
      }
#pragma unroll
      for (int c = 0; c < kTN; ++c) {
        ybr[c] = ysr[kk][tx * kTN + c];
        ybi[c] = ysi[kk][tx * kTN + c];
      }
#pragma unroll
      for (int a = 0; a < kTM; ++a)
#pragma unroll
        for (int c = 0; c < kTN; ++c) {
          acc_r[a][c] += qar[a] * ybr[c];
          acc_r[a][c] -= qai[a] * ybi[c];
          acc_i[a][c] += qar[a] * ybi[c];
          acc_i[a][c] += qai[a] * ybr[c];
        }
    }
    __syncthreads();
  }
  // every read of this block's rows and columns of y is behind the last
  // barrier; no other block of the wave touches them
#pragma unroll
  for (int a = 0; a < kTM; ++a) {
    const int row = ty * kTM + a;
    if (row >= lwin || r0 + row >= n) continue;
#pragma unroll
    for (int c = 0; c < kTN; ++c) {
      const int gc = col0 + tx * kTN + c;
      if (gc < m) {
        y_r[(size_t)(r0 + row) * ldy + gc] = acc_r[a][c];
        y_i[(size_t)(r0 + row) * ldy + gc] = acc_i[a][c];
      }
    }
  }
}

template <typename T>
int replay_planar_launch(const T* qw_r, const T* qw_i, T* y_r, T* y_i, int ldy,
                         int n, int m, int b, int g, int n_waves, int n_slots,
                         void* stream) {
  if (n < 3 || m < 1 || ldy < m || b < 2 || g < 1 || b + g - 1 > kP ||
      n_waves < 1 || n_slots < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int kmax = (n - 3) / b;
  const int n_groups = (n - 2 + g - 1) / g;
  const int n_u = kmax / 2 + 1;
  const dim3 grid((m + kBN - 1) / kBN, n_slots);
  for (int wave = 0; wave < n_waves; ++wave) {
    replay_planar_wave<T><<<grid, kThreads, 0, st>>>(
        qw_r, qw_i, y_r, y_i, ldy, n, m, b, g, wave, n_groups, kmax, n_u,
        n_slots);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace

// qw_r, qw_i: n_waves * n_slots windows of 128 x 128 elements each; y_r, y_i:
// n rows of m elements at row stride ldy, updated in place.
extern "C" int apply_q2_planar_f32_launch(const float* qw_r, const float* qw_i,
                                          float* y_r, float* y_i, int ldy,
                                          int n, int m, int b, int g,
                                          int n_waves, int n_slots,
                                          void* stream) {
  return replay_planar_launch<float>(qw_r, qw_i, y_r, y_i, ldy, n, m, b, g,
                                     n_waves, n_slots, stream);
}

extern "C" int apply_q2_planar_f64_launch(const double* qw_r,
                                          const double* qw_i, double* y_r,
                                          double* y_i, int ldy, int n, int m,
                                          int b, int g, int n_waves,
                                          int n_slots, void* stream) {
  return replay_planar_launch<double>(qw_r, qw_i, y_r, y_i, ldy, n, m, b, g,
                                      n_waves, n_slots, stream);
}
