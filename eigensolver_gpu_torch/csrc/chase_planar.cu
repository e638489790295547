// Kernel K8: planar complex Hermitian band -> complex tridiagonal bulge
// chase, all wavefront timesteps from one call
// (eigensolver_gpu_torch/ops/chase.py::bulge_chase_planar_kernel, called once
// per planar two-stage solve by models/zhegvdx_planar.py).
//
// Replaces eigensolver_gpu_tpu/ops/chase_pallas.py::bulge_chase_planar_pallas
// (pallas_call at :880, bodies _chase_kernel_planar at :723 and
// _window_update_planar at :601). The Pallas module's opt-in batch3
// re-staging (_chase_kernel_b3) is another schedule of the TPU's memory with
// the same outputs, not another function, and has no counterpart here.
//
// What it computes (ops/sb2st_planar.py::bulge_chase_planar): each plane is
// lower band storage, A[i, j] = band_r[j, i - j] + i band_i[j, i - j] for
// 0 <= i - j < 2b, and A[j, i] = conj(A[i, j]) (so the imaginary plane holds
// -Im of the upper triangle). The schedule is the real chase's
// (csrc/chase.cu): at timestep t = 3 v + k, slot s holds
// (v, k) = (t / 3 - s, t % 3 + 3 s), rows I = [r0, r0 + b), r0 = v + 1 + k b,
// active when 0 <= v <= n - 3 and r0 <= n - 2. An active slot forms the
// complex Householder reflector H = I - tau v v^H (LAPACK zlarfg: real beta,
// H^H x = beta e1; trivial when the tail is zero AND the pivot real) of
// x = A[I, r0 - 1] (k == 0) or A[I, r0 - b] (k > 0) and applies the
// similarity A <- H^H A H to the lower trapezoid of its window:
//     A10 = A[I, r0 - b : r0]        <- H^H A10 = A10 - conj(tau) v (v^H A10)
//     A11 = A[I, I] (lower part)     <- A11 - w v^H - v w^H,
//           y = A11 v, w = tau y - (|tau|^2 Re(v^H y) / 2) v
//     A21 = A[r0 + b : r0 + 2b, I]   <- A21 H = A21 - tau (A21 v) v^H
// and stores v at vt[t, s, :], tau at taut[t, s], both planes. Inactive
// slots keep the zeros the wrapper put there.
//
// The diagonal of a Hermitian matrix is real. The plain version rebuilds
// its window Hermitian at every step, which reads the imaginary part of the
// diagonal as zero; this kernel reads it as zero too (the tile load below)
// AND writes it as zero (the A11 update is 2 Re(w_p conj(v_p)), real), so
// rounding never accumulates there.
//
// What bounds it on the H100: the 3 (n - 3) + 1 strictly ordered timesteps
// (12 280 at n = 4096), each a few microseconds of work on at most
// ceil(n / (3b - 1)) windows of 3 b^2 complex entries. Bytes (the two band
// planes, read and written once, and the reflector store) and operations
// are far below what the sequence costs.
//
// Design, the real kernel's: one launch per timestep, all enqueued on the
// stream from this one C call; the stream orders the timesteps, and within
// one the active slots are independent blocks. The host computes the
// contiguous range of active slots and launches only those. A block stages
// its three b x b complex tiles in shared memory straight from band storage
// (out-of-matrix columns are guarded), builds the reflector in one warp,
// forms the three products with 3b threads, and writes the tiles back; it
// writes nothing outside its window. All sums run in a fixed order, so two
// calls give the same bits. Plain FMA arithmetic, four real products per
// complex one; float and double instances.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxB = 64;

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ double warp_sum(double x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
chase_planar_step(T* band_r, T* band_i, int n, int b, int t, int s_lo,
                  int s_slots, T* vt_r, T* vt_i, T* taut_r, T* taut_i) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int ld = b + 1;
  const int tile = b * ld;
  // tiles [q][p], p fastest, real plane then imaginary plane
  T* a10r = smem;             // A[r0 + p, r0 - b + q]
  T* a10i = a10r + tile;
  T* a11r = a10i + tile;      // A[r0 + p, r0 + q], both triangles
  T* a11i = a11r + tile;
  T* a21r = a11i + tile;      // A[r0 + b + p, r0 + q]
  T* a21i = a21r + tile;
  T* vvr = a21i + tile;       // reflector
  T* vvi = vvr + b;
  T* u1r = vvi + b;           // v^H A10
  T* u1i = u1r + b;
  T* yyr = u1i + b;           // A11 v
  T* yyi = yyr + b;
  T* y2r = yyi + b;           // A21 v
  T* y2i = y2r + b;
  T* wwr = y2i + b;           // w
  T* wwi = wwr + b;
  T* scal = wwi + b;          // tau_r, tau_i

  const int tid = threadIdx.x;
  const int s = s_lo + blockIdx.x;
  const int k = t % 3 + 3 * s;
  const int r0 = t / 3 - s + 1 + k * b;
  const int w = 2 * b;

  for (int idx = tid; idx < b * b; idx += kThreads) {
    const int q = idx / b, p = idx - q * b;
    const int c10 = r0 - b + q, c11 = r0 + q;
    const int at = q * ld + p;
    const bool in10 = c10 >= 0;
    a10r[at] = in10 ? band_r[(size_t)c10 * w + b + p - q] : T(0);
    a10i[at] = in10 ? band_i[(size_t)c10 * w + b + p - q] : T(0);
    T sr = T(0), si = T(0);
    if (p > q) {  // stored entry A[r0 + p, r0 + q]
      if (c11 < n) {
        sr = band_r[(size_t)c11 * w + p - q];
        si = band_i[(size_t)c11 * w + p - q];
      }
    } else if (p == q) {  // the diagonal is real: its imaginary part reads 0
      if (c11 < n) sr = band_r[(size_t)c11 * w];
    } else if (r0 + p < n) {  // conj of the stored A[r0 + q, r0 + p]
      sr = band_r[(size_t)(r0 + p) * w + q - p];
      si = -band_i[(size_t)(r0 + p) * w + q - p];
    }
    a11r[at] = sr;
    a11i[at] = si;
    const bool in21 = c11 < n;
    a21r[at] = in21 ? band_r[(size_t)c11 * w + b + p - q] : T(0);
    a21i[at] = in21 ? band_i[(size_t)c11 * w + b + p - q] : T(0);
  }
  __syncthreads();

  if (tid < 32) {  // zlarfg in one warp; lane handles p = lane and lane + 32
    const int off = (k == 0 ? b - 1 : 0) * ld;
    const T* xr = a10r + off;
    const T* xi = a10i + off;
    const T x0r = tid < b ? xr[tid] : T(0), x0i = tid < b ? xi[tid] : T(0);
    const T x1r = tid + 32 < b ? xr[tid + 32] : T(0);
    const T x1i = tid + 32 < b ? xi[tid + 32] : T(0);
    const T xnormsq = warp_sum((tid == 0 ? T(0) : x0r * x0r + x0i * x0i) +
                               x1r * x1r + x1i * x1i);
    const T ar = xr[0], ai = xi[0];
    const bool trivial = xnormsq == T(0) && ai == T(0);
    const T norm = sqrt(ar * ar + ai * ai + xnormsq);
    const T beta = ar >= T(0) ? -norm : norm;
    const T tr = trivial ? T(0) : (beta - ar) / beta;
    const T ti = trivial ? T(0) : -ai / beta;
    const T dr = ar - beta;
    const T den = dr * dr + ai * ai;
    const T sr = trivial ? T(0) : dr / den;   // 1 / (alpha - beta)
    const T si = trivial ? T(0) : -ai / den;
    if (tid < b) {
      vvr[tid] = tid == 0 ? (trivial ? T(0) : T(1)) : x0r * sr - x0i * si;
      vvi[tid] = tid == 0 ? T(0) : x0r * si + x0i * sr;
    }
    if (tid + 32 < b) {
      vvr[tid + 32] = x1r * sr - x1i * si;
      vvi[tid + 32] = x1r * si + x1i * sr;
    }
    if (tid == 0) {
      scal[0] = tr;
      scal[1] = ti;
    }
  }
  __syncthreads();

  if (tid < b) {  // u1[q] = sum_p conj(v[p]) A10[p, q]
    T acc_r = T(0), acc_i = T(0);
    for (int p = 0; p < b; ++p) {
      const T vr = vvr[p], vi = vvi[p];
      const T xr = a10r[tid * ld + p], xi = a10i[tid * ld + p];
      acc_r += vr * xr + vi * xi;
      acc_i += vr * xi - vi * xr;
    }
    u1r[tid] = acc_r;
    u1i[tid] = acc_i;
  } else if (tid < 2 * b) {  // y[p] = sum_q A11[p, q] v[q]
    const int p = tid - b;
    T acc_r = T(0), acc_i = T(0);
    for (int q = 0; q < b; ++q) {
      const T xr = a11r[q * ld + p], xi = a11i[q * ld + p];
      acc_r += xr * vvr[q] - xi * vvi[q];
      acc_i += xr * vvi[q] + xi * vvr[q];
    }
    yyr[p] = acc_r;
    yyi[p] = acc_i;
  } else if (tid < 3 * b) {  // y2[p] = sum_q A21[p, q] v[q]
    const int p = tid - 2 * b;
    T acc_r = T(0), acc_i = T(0);
    for (int q = 0; q < b; ++q) {
      const T xr = a21r[q * ld + p], xi = a21i[q * ld + p];
      acc_r += xr * vvr[q] - xi * vvi[q];
      acc_i += xr * vvi[q] + xi * vvr[q];
    }
    y2r[p] = acc_r;
    y2i[p] = acc_i;
  }
  __syncthreads();

  const T tr = scal[0], ti = scal[1];
  if (tid < 32) {  // w = tau y - (|tau|^2 Re(v^H y) / 2) v
    const bool lo = tid < b, hi = tid + 32 < b;
    const T v0r = lo ? vvr[tid] : T(0), v0i = lo ? vvi[tid] : T(0);
    const T y0r = lo ? yyr[tid] : T(0), y0i = lo ? yyi[tid] : T(0);
    const T v1r = hi ? vvr[tid + 32] : T(0), v1i = hi ? vvi[tid + 32] : T(0);
    const T y1r = hi ? yyr[tid + 32] : T(0), y1i = hi ? yyi[tid + 32] : T(0);
    const T vav = warp_sum(v0r * y0r + v0i * y0i + v1r * y1r + v1i * y1i);
    const T half = T(0.5) * (tr * tr + ti * ti) * vav;
    if (lo) {
      wwr[tid] = tr * y0r - ti * y0i - half * v0r;
      wwi[tid] = tr * y0i + ti * y0r - half * v0i;
    }
    if (hi) {
      wwr[tid + 32] = tr * y1r - ti * y1i - half * v1r;
      wwi[tid + 32] = tr * y1i + ti * y1r - half * v1i;
    }
  }
  __syncthreads();

  for (int idx = tid; idx < b * b; idx += kThreads) {
    const int q = idx / b, p = idx - q * b;
    const int c10 = r0 - b + q, c11 = r0 + q;
    const int at = q * ld + p;
    const T vpr = vvr[p], vpi = vvi[p], vqr = vvr[q], vqi = vvi[q];
    if (c10 >= 0) {  // A10 -= v_p (conj(tau) u1_q)
      const T cr = tr * u1r[q] + ti * u1i[q], ci = tr * u1i[q] - ti * u1r[q];
      band_r[(size_t)c10 * w + b + p - q] = a10r[at] - (vpr * cr - vpi * ci);
      band_i[(size_t)c10 * w + b + p - q] = a10i[at] - (vpr * ci + vpi * cr);
    }
    if (c11 < n) {
      if (p >= q) {  // A11 -= w_p conj(v_q) + v_p conj(w_q)
        const T wpr = wwr[p], wpi = wwi[p], wqr = wwr[q], wqi = wwi[q];
        band_r[(size_t)c11 * w + p - q] =
            a11r[at] - (wpr * vqr + wpi * vqi + vpr * wqr + vpi * wqi);
        band_i[(size_t)c11 * w + p - q] =
            p == q ? T(0)
                   : a11i[at] - (wpi * vqr - wpr * vqi + vpi * wqr - vpr * wqi);
      }
      // A21 -= (tau y2_p) conj(v_q)
      const T cr = tr * y2r[p] - ti * y2i[p], ci = tr * y2i[p] + ti * y2r[p];
      band_r[(size_t)c11 * w + b + p - q] = a21r[at] - (cr * vqr + ci * vqi);
      band_i[(size_t)c11 * w + b + p - q] = a21i[at] - (ci * vqr - cr * vqi);
    }
  }
  if (tid < b) {
    vt_r[((size_t)t * s_slots + s) * b + tid] = vvr[tid];
    vt_i[((size_t)t * s_slots + s) * b + tid] = vvi[tid];
  }
  if (tid == 0) {
    taut_r[(size_t)t * s_slots + s] = tr;
    taut_i[(size_t)t * s_slots + s] = ti;
  }
}

template <typename T>
int chase_planar_launch(T* band_r, T* band_i, int n, int b, T* vt_r, T* vt_i,
                        T* taut_r, T* taut_i, void* stream) {
  if (n < 3 || b < 2 || b > kMaxB) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int s_slots = ((n - 3) / b) / 3 + 1;
  const int t_total = n > 3 ? 3 * (n - 3) + 1 : 1;
  const int stride = 3 * b - 1;
  const size_t smem = (size_t)(6 * b * (b + 1) + 10 * b + 2) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      chase_planar_step<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  for (int t = 0; t < t_total; ++t) {
    const int vmax = t / 3, k0 = t % 3;
    // slot s is active when 0 <= vmax - s <= n - 3 and
    // r0 = vmax + 1 + k0 b + s (3b - 1) <= n - 2
    const int room = n - 3 - vmax - k0 * b;
    if (room < 0) continue;
    const int s_lo = vmax - (n - 3) > 0 ? vmax - (n - 3) : 0;
    int s_hi = room / stride;
    if (s_hi > vmax) s_hi = vmax;
    if (s_hi > s_slots - 1) s_hi = s_slots - 1;
    if (s_hi < s_lo) continue;
    chase_planar_step<T><<<s_hi - s_lo + 1, kThreads, smem, st>>>(
        band_r, band_i, n, b, t, s_lo, s_slots, vt_r, vt_i, taut_r, taut_i);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace

// band_r, band_i: n * 2b elements each, chased in place (the first column
// of band_r is d, the second columns of the two planes are e on return);
// vt_r, vt_i: t3 * s_slots * b and taut_r, taut_i: t3 * s_slots elements,
// zeroed by the caller, with s_slots = ((n - 3) / b) / 3 + 1,
// t3 = 3 * ceil((3 (n - 3) + 1) / 3).
extern "C" int bulge_chase_planar_f32_launch(float* band_r, float* band_i,
                                             int n, int b, float* vt_r,
                                             float* vt_i, float* taut_r,
                                             float* taut_i, void* stream) {
  return chase_planar_launch<float>(band_r, band_i, n, b, vt_r, vt_i, taut_r,
                                    taut_i, stream);
}

extern "C" int bulge_chase_planar_f64_launch(double* band_r, double* band_i,
                                             int n, int b, double* vt_r,
                                             double* vt_i, double* taut_r,
                                             double* taut_i, void* stream) {
  return chase_planar_launch<double>(band_r, band_i, n, b, vt_r, vt_i, taut_r,
                                     taut_i, stream);
}
