// Kernel K5: QL factorization of one (m, b) panel strip of the successive
// band reduction, plus the forward-larft T factor of its reflectors
// (eigensolver_gpu_torch/ops/ql_panel.py::ql_panel, called once per panel
// by ops/sbrd.py::sbrd).
//
// Replaces eigensolver_gpu_tpu/ops/ql_panel_pallas.py::ql_panel_pallas
// (pallas_call at :301, body _ql_panel_kernel at :41).
//
// What it computes (ops/sbrd.py::_ql_panel + _larft_forward): for column
// j = b-1 .. 0, with top = rb + j, a Householder reflector H = I - tau v v^T
// (LAPACK dlarfg conventions: beta = -sign(alpha) norm, v[top] = 1) that
// zeroes rows [0, top) of column j against the pivot at row top, applied to
// the columns < j. Rows past top are never touched. A column already zero
// above its pivot is trivial: tau = 0, v = 0 including the pivot entry, the
// column left as it was. Then T (b x b, upper triangular) with
// H(0) H(1) .. H(b-1) = I - V T V^T: T[:, j] = -tau_j T[:, :j] (V^T V)[:j, j],
// T[j, j] = tau_j.
//
// What bounds it on the H100: neither bytes nor operations but the chain of
// b dependent columns, each a reduction over the strip followed by a rank-1
// update of it. The strip at m = 4096, b = 32 is 512 KB in fp32 and does
// not fit the 227 KB of shared memory of a block, so one 1024-thread block
// works on the output copy in global memory, where the strip stays in L2,
// with a block barrier between the phases of a column. Only rows
// [0, rb + b) are read after the first copy. Every sum is taken in a fixed
// order (per-thread strided partials, then a serial sum over the partials),
// so the result is the same from run to run. Plain FMA arithmetic.
//
// Any m >= 1, 1 <= b <= 64, 0 <= rb <= m - b; the panel may be a column
// slice of a row-major matrix (row stride ldp >= b).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxB = 64;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ql_panel_kernel(const T* __restrict__ p, int ldp, int m, int b, int rb,
                T* r, T* v, T* tau, T* tmat) {
  __shared__ T part[kThreads];
  __shared__ T gram[kMaxB * kMaxB];
  __shared__ T colsum[kMaxB];
  const int tid = threadIdx.x;
  const int lanes = kThreads / b;  // row lanes of the (row lane, column) layout
  const int c = tid % b;
  const int rl = tid / b;
  const bool in_layout = rl < lanes;

  for (int idx = tid; idx < m * b; idx += kThreads) {
    const int row = idx / b, col = idx - row * b;
    r[idx] = p[(size_t)row * ldp + col];
    v[idx] = T(0);
  }
  for (int idx = tid; idx < b * b; idx += kThreads) tmat[idx] = T(0);
  __syncthreads();

  for (int j = b - 1; j >= 0; --j) {
    const int top = rb + j;
    // ||x||^2 over rows [0, top) of column j
    T acc = T(0);
    for (int row = tid; row < top; row += kThreads) {
      const T x = r[(size_t)row * b + j];
      acc += x * x;
    }
    part[tid] = acc;
    __syncthreads();
    for (int half = kThreads / 2; half > 0; half >>= 1) {
      if (tid < half) part[tid] += part[tid + half];
      __syncthreads();
    }
    const T xnormsq = part[0];
    const T alpha = r[(size_t)top * b + j];
    __syncthreads();  // part is reused below
    const bool trivial = xnormsq == T(0);
    const T norm = sqrt(alpha * alpha + xnormsq);
    const T beta = alpha >= T(0) ? -norm : norm;
    const T tau_j = trivial ? T(0) : (beta - alpha) / beta;
    const T denom = trivial ? T(1) : alpha - beta;
    // v = x / denom above the pivot, 1 at the pivot; the column becomes
    // (0, .., 0, beta). Each row is read and written by one thread.
    for (int row = tid; row <= top; row += kThreads) {
      const size_t at = (size_t)row * b + j;
      if (row < top) {
        v[at] = r[at] / denom;
        r[at] = T(0);
      } else if (!trivial) {
        v[at] = T(1);
        r[at] = beta;
      }
    }
    if (tid == 0) tau[j] = tau_j;
    __syncthreads();
    if (trivial || j == 0) continue;  // uniform: no update to apply
    // vp[c] = sum_row v[row] r[row, c] for the columns c < j
    acc = T(0);
    if (in_layout && c < j) {
      for (int row = rl; row <= top; row += lanes)
        acc += v[(size_t)row * b + j] * r[(size_t)row * b + c];
    }
    part[tid] = acc;
    __syncthreads();
    if (tid < j) {
      T s = T(0);
      for (int l = 0; l < lanes; ++l) s += part[l * b + tid];
      colsum[tid] = s;
    }
    __syncthreads();
    if (in_layout && c < j) {
      const T scale = tau_j * colsum[c];
      for (int row = rl; row <= top; row += lanes)
        r[(size_t)row * b + c] -= scale * v[(size_t)row * b + j];
    }
    __syncthreads();
  }

  // gram = V^T V over the rows that hold reflector entries
  const int vrows = rb + b;
  for (int idx = tid; idx < b * b; idx += kThreads) {
    const int i = idx / b, k = idx - i * b;
    T acc = T(0);
    for (int row = 0; row < vrows; ++row)
      acc += v[(size_t)row * b + i] * v[(size_t)row * b + k];
    gram[idx] = acc;
  }
  __syncthreads();
  // forward larft: b dependent columns; T is upper triangular, so row i of
  // column j sums over l in [i, j)
  for (int j = 0; j < b; ++j) {
    if (tid < b) {
      const T tau_j = tau[j];
      T val = T(0);
      if (tid < j) {
        T s = T(0);
        for (int l = tid; l < j; ++l) s += tmat[tid * b + l] * gram[l * b + j];
        val = -tau_j * s;
      } else if (tid == j) {
        val = tau_j;
      }
      tmat[tid * b + j] = val;
    }
    __syncthreads();
  }
}

template <typename T>
int ql_panel_launch(const T* p, int ldp, int m, int b, int rb, T* r, T* v,
                    T* tau, T* tmat, void* stream) {
  if (b < 1 || b > kMaxB || m < b || rb < 0 || rb + b > m || ldp < b)
    return (int)cudaErrorInvalidValue;
  ql_panel_kernel<T><<<1, kThreads, 0, (cudaStream_t)stream>>>(
      p, ldp, m, b, rb, r, v, tau, tmat);
  return (int)cudaGetLastError();
}

}  // namespace

// r, v: m * b elements (row-major, contiguous); tau: b; tmat: b * b.
extern "C" int ql_panel_f32_launch(const float* p, int ldp, int m, int b,
                                   int rb, float* r, float* v, float* tau,
                                   float* tmat, void* stream) {
  return ql_panel_launch<float>(p, ldp, m, b, rb, r, v, tau, tmat, stream);
}

extern "C" int ql_panel_f64_launch(const double* p, int ldp, int m, int b,
                                   int rb, double* r, double* v, double* tau,
                                   double* tmat, void* stream) {
  return ql_panel_launch<double>(p, ldp, m, b, rb, r, v, tau, tmat, stream);
}
