// Kernel K6: planar complex QL factorization of one (m, b) panel strip of the
// Hermitian band reduction, plus the forward-larft T factor of its
// reflectors (eigensolver_gpu_torch/ops/ql_panel.py::ql_panel_planar, called
// once per panel by ops/sbrd_planar.py::psbrd).
//
// Replaces eigensolver_gpu_tpu/ops/ql_panel_pallas.py::ql_panel_planar_pallas
// (pallas_call at :263, body _ql_panel_planar_kernel at :129).
//
// What it computes (ops/sbrd_planar.py::_ql_panel_planar +
// _larft_forward_planar with conjugated taus), on (re, im) planes: for
// column j = b-1 .. 0, with top = rb + j, a complex Householder reflector
// H = I - tau v v^H (LAPACK zlarfg: beta = -sign(Re alpha) |(alpha, x)| real,
// tau = (beta - alpha) / beta complex, v = x / (alpha - beta) above the
// pivot, v[top] = 1) with H^H (alpha, x) = (beta, 0). The column becomes
// (0, .., 0, beta) with a zero imaginary part at the pivot, and the columns
// c < j take H^H:  P[:, c] -= v (conj(tau) (v^H P[:, c])). Rows past top are
// never touched. A column with a zero tail AND a real pivot is trivial:
// tau = 0, v = 0 including the pivot entry, the column left as it was (a zero
// tail under a complex pivot still rotates the pivot to real). Then T
// (b x b, upper triangular, complex) with
// H(0)^H H(1)^H .. H(b-1)^H = I - V T V^H, the forward larft of the
// conjugated taus: T[:, j] = -conj(tau_j) T[:, :j] (V^H V)[:j, j],
// T[j, j] = conj(tau_j).
//
// What bounds it on the H100: as for the real kernel (csrc/ql_panel.cu),
// neither bytes nor operations but the chain of b dependent columns, each a
// reduction over the strip followed by a rank-1 update of it, on twice the
// data. Both planes of the strip at m = 4096, b = 32 are 1 MB in fp32, far
// past a block's shared memory, so one 1024-thread block works on the output
// copies in global memory, where they stay in L2, with a block barrier
// between the phases of a column. Every sum is taken in a fixed order
// (per-thread strided partials, then a serial or tree sum over the
// partials), so the result is the same from run to run. Plain FMA
// arithmetic, four real products per complex one.
//
// Any m >= 1, 1 <= b <= 64, 0 <= rb <= m - b; the planes may be column slices
// of row-major matrices with one common row stride ldp >= b.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxB = 64;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ql_panel_planar_kernel(const T* __restrict__ pr, const T* __restrict__ pi,
                       int ldp, int m, int b, int rb, T* rr, T* ri, T* vr,
                       T* vi, T* taur, T* taui, T* tmr, T* tmi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* part_r = reinterpret_cast<T*>(smem_raw);  // kThreads
  T* part_i = part_r + kThreads;               // kThreads
  T* gram_r = part_i + kThreads;               // b * b
  T* gram_i = gram_r + b * b;                  // b * b
  T* col_r = gram_i + b * b;                   // b
  T* col_i = col_r + b;                        // b
  const int tid = threadIdx.x;
  const int lanes = kThreads / b;  // row lanes of the (row lane, column) layout
  const int c = tid % b;
  const int rl = tid / b;
  const bool in_layout = rl < lanes;

  for (int idx = tid; idx < m * b; idx += kThreads) {
    const int row = idx / b, col = idx - row * b;
    rr[idx] = pr[(size_t)row * ldp + col];
    ri[idx] = pi[(size_t)row * ldp + col];
    vr[idx] = T(0);
    vi[idx] = T(0);
  }
  for (int idx = tid; idx < b * b; idx += kThreads) {
    tmr[idx] = T(0);
    tmi[idx] = T(0);
  }
  __syncthreads();

  for (int j = b - 1; j >= 0; --j) {
    const int top = rb + j;
    // |x|^2 over rows [0, top) of column j
    T acc = T(0);
    for (int row = tid; row < top; row += kThreads) {
      const T xr = rr[(size_t)row * b + j], xi = ri[(size_t)row * b + j];
      acc += xr * xr + xi * xi;
    }
    part_r[tid] = acc;
    __syncthreads();
    for (int half = kThreads / 2; half > 0; half >>= 1) {
      if (tid < half) part_r[tid] += part_r[tid + half];
      __syncthreads();
    }
    const T xnormsq = part_r[0];
    const T ar = rr[(size_t)top * b + j], ai = ri[(size_t)top * b + j];
    __syncthreads();  // part_r is reused below
    const bool trivial = xnormsq == T(0) && ai == T(0);
    const T norm = sqrt(ar * ar + ai * ai + xnormsq);
    const T beta = ar >= T(0) ? -norm : norm;
    const T tr = trivial ? T(0) : (beta - ar) / beta;
    const T ti = trivial ? T(0) : -ai / beta;
    // 1 / (alpha - beta)
    const T dr = ar - beta;
    const T den = dr * dr + ai * ai;
    const T sr = trivial ? T(0) : dr / den;
    const T si = trivial ? T(0) : -ai / den;
    // v = x / (alpha - beta) above the pivot, 1 at the pivot; the column
    // becomes (0, .., 0, beta). Each row is read and written by one thread.
    for (int row = tid; row <= top; row += kThreads) {
      const size_t at = (size_t)row * b + j;
      if (row < top) {
        const T xr = rr[at], xi = ri[at];
        vr[at] = xr * sr - xi * si;
        vi[at] = xr * si + xi * sr;
        rr[at] = T(0);
        ri[at] = T(0);
      } else if (!trivial) {
        vr[at] = T(1);
        rr[at] = beta;
        ri[at] = T(0);
      }
    }
    if (tid == 0) {
      taur[j] = tr;
      taui[j] = ti;
    }
    __syncthreads();
    if (trivial || j == 0) continue;  // uniform: no update to apply
    // vp[c] = sum_row conj(v[row]) P[row, c] for the columns c < j
    T acc_r = T(0), acc_i = T(0);
    if (in_layout && c < j) {
      for (int row = rl; row <= top; row += lanes) {
        const T wr = vr[(size_t)row * b + j], wi = vi[(size_t)row * b + j];
        const T xr = rr[(size_t)row * b + c], xi = ri[(size_t)row * b + c];
        acc_r += wr * xr + wi * xi;
        acc_i += wr * xi - wi * xr;
      }
    }
    part_r[tid] = acc_r;
    part_i[tid] = acc_i;
    __syncthreads();
    if (tid < j) {
      T s_r = T(0), s_i = T(0);
      for (int l = 0; l < lanes; ++l) {
        s_r += part_r[l * b + tid];
        s_i += part_i[l * b + tid];
      }
      // conj(tau) * vp
      col_r[tid] = tr * s_r + ti * s_i;
      col_i[tid] = tr * s_i - ti * s_r;
    }
    __syncthreads();
    if (in_layout && c < j) {
      const T ur = col_r[c], ui = col_i[c];
      for (int row = rl; row <= top; row += lanes) {
        const T wr = vr[(size_t)row * b + j], wi = vi[(size_t)row * b + j];
        rr[(size_t)row * b + c] -= wr * ur - wi * ui;
        ri[(size_t)row * b + c] -= wr * ui + wi * ur;
      }
    }
    __syncthreads();
  }

  // gram = V^H V over the rows that hold reflector entries
  const int vrows = rb + b;
  for (int idx = tid; idx < b * b; idx += kThreads) {
    const int i = idx / b, k = idx - i * b;
    T acc_r = T(0), acc_i = T(0);
    for (int row = 0; row < vrows; ++row) {
      const T ar = vr[(size_t)row * b + i], ai = vi[(size_t)row * b + i];
      const T br = vr[(size_t)row * b + k], bi = vi[(size_t)row * b + k];
      acc_r += ar * br + ai * bi;
      acc_i += ar * bi - ai * br;
    }
    gram_r[idx] = acc_r;
    gram_i[idx] = acc_i;
  }
  __syncthreads();
  // forward larft of the conjugated taus: b dependent columns; T is upper
  // triangular, so row i of column j sums over l in [i, j)
  for (int j = 0; j < b; ++j) {
    if (tid < b) {
      const T tr = taur[j], ti = -taui[j];
      T val_r = T(0), val_i = T(0);
      if (tid < j) {
        T s_r = T(0), s_i = T(0);
        for (int l = tid; l < j; ++l) {
          const T xr = tmr[tid * b + l], xi = tmi[tid * b + l];
          const T gr = gram_r[l * b + j], gi = gram_i[l * b + j];
          s_r += xr * gr - xi * gi;
          s_i += xr * gi + xi * gr;
        }
        val_r = -(tr * s_r - ti * s_i);
        val_i = -(tr * s_i + ti * s_r);
      } else if (tid == j) {
        val_r = tr;
        val_i = ti;
      }
      tmr[tid * b + j] = val_r;
      tmi[tid * b + j] = val_i;
    }
    __syncthreads();
  }
}

template <typename T>
int ql_panel_planar_launch(const T* pr, const T* pi, int ldp, int m, int b,
                           int rb, T* rr, T* ri, T* vr, T* vi, T* taur,
                           T* taui, T* tmr, T* tmi, void* stream) {
  if (b < 1 || b > kMaxB || m < b || rb < 0 || rb + b > m || ldp < b)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(2 * kThreads + 2 * b * b + 2 * b) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      ql_panel_planar_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ql_panel_planar_kernel<T><<<1, kThreads, smem, (cudaStream_t)stream>>>(
      pr, pi, ldp, m, b, rb, rr, ri, vr, vi, taur, taui, tmr, tmi);
  return (int)cudaGetLastError();
}

}  // namespace

// rr, ri, vr, vi: m * b elements each (row-major, contiguous); taur, taui:
// b; tmr, tmi: b * b.
extern "C" int ql_panel_planar_f32_launch(
    const float* pr, const float* pi, int ldp, int m, int b, int rb, float* rr,
    float* ri, float* vr, float* vi, float* taur, float* taui, float* tmr,
    float* tmi, void* stream) {
  return ql_panel_planar_launch<float>(pr, pi, ldp, m, b, rb, rr, ri, vr, vi,
                                       taur, taui, tmr, tmi, stream);
}

extern "C" int ql_panel_planar_f64_launch(
    const double* pr, const double* pi, int ldp, int m, int b, int rb,
    double* rr, double* ri, double* vr, double* vi, double* taur, double* taui,
    double* tmr, double* tmi, void* stream) {
  return ql_panel_planar_launch<double>(pr, pi, ldp, m, b, rb, rr, ri, vr, vi,
                                        taur, taui, tmr, tmi, stream);
}
