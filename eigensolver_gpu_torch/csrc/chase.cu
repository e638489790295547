// Kernel K7: band -> tridiagonal bulge chase, all wavefront timesteps from
// one call (eigensolver_gpu_torch/ops/chase.py::bulge_chase_kernel, called
// once per two-stage solve by models/syevdx.py).
//
// Replaces eigensolver_gpu_tpu/ops/chase_pallas.py::bulge_chase_pallas
// (pallas_call at :1009, bodies _chase_kernel at :240 and _window_update at
// :162).
//
// What it computes (ops/sb2st.py::bulge_chase): the band is lower band
// storage, A[i, j] = band[j, i - j] for 0 <= i - j < 2b. Sweep v eliminates
// column v; its chase step k works at rows I = [r0, r0 + b), r0 = v + 1 + k b.
// At timestep t = 3 v + k, slot s holds (v, k) = (t / 3 - s, t % 3 + 3 s) and is
// active when 0 <= v <= n - 3 and r0 <= n - 2. An active slot forms the
// Householder reflector H = I - tau v v^T (LAPACK dlarfg conventions) of
// x = A[I, r0 - 1] (k == 0) or A[I, r0 - b] (k > 0) and applies H A H to the
// lower trapezoid of its window:
//     A10 = A[I, r0 - b : r0]        <- H A10
//     A11 = A[I, I] (lower part)     <- A11 - v w^T - w v^T,
//           y = A11 v, w = tau y - (tau^2 (v . y) / 2) v
//     A21 = A[r0 + b : r0 + 2b, I]   <- A21 H
// and stores v at vt[t, s, :], tau at taut[t, s]. Inactive slots keep the
// zeros the wrapper put there.
//
// What bounds it on the H100: the 3 (n - 3) + 1 strictly ordered timesteps
// (12 280 at n = 4096), each a few microseconds of work on at most
// ceil(n / (3b - 1)) windows of 3 b^2 entries. Bytes (the band, read and
// written once, and the reflector store) and operations are far below what
// the sequence costs.
//
// Design: one launch per timestep, all enqueued on the stream from this one
// C call; the stream orders the timesteps, and within one the active slots
// are independent blocks (their band strips lie 3b - 1 rows apart and are
// 2b rows tall). The host computes the contiguous range of active slots and
// launches only those. A grid barrier inside one cooperative kernel would
// save the launches, but a launch sequence cannot deadlock and needs no
// co-residency; the sequence is the price. A block stages its three b x b
// tiles in shared memory straight from band storage (no shear, no padding:
// out-of-matrix columns are guarded), builds the reflector in one warp,
// forms the three products with 3b threads, and writes the tiles back. All
// sums run in a fixed order, so two calls give the same bits. Plain FMA
// arithmetic; float and double instances.

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
chase_step(T* band, int n, int b, int t, int s_lo, int s_slots, T* vt,
           T* taut) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int ld = b + 1;
  T* a10 = smem;            // [q][p], p fastest: entry A[r0 + p, r0 - b + q]
  T* a11 = a10 + b * ld;    // [q][p]: A[r0 + p, r0 + q], both triangles
  T* a21 = a11 + b * ld;    // [q][p]: A[r0 + b + p, r0 + q]
  T* vv = a21 + b * ld;     // reflector
  T* u1 = vv + b;           // v^T A10
  T* yy = u1 + b;           // A11 v
  T* y2 = yy + b;           // A21 v
  T* ww = y2 + b;           // w
  T* scal = ww + b;         // tau

  const int tid = threadIdx.x;
  const int s = s_lo + blockIdx.x;
  const int k = t % 3 + 3 * s;
  const int r0 = t / 3 - s + 1 + k * b;
  const int w = 2 * b;

  for (int idx = tid; idx < b * b; idx += kThreads) {
    const int q = idx / b, p = idx - q * b;
    const int c10 = r0 - b + q, c11 = r0 + q;
    a10[q * ld + p] = c10 >= 0 ? band[(size_t)c10 * w + b + p - q] : T(0);
    T sym = T(0);
    if (p >= q) {
      if (c11 < n) sym = band[(size_t)c11 * w + p - q];
    } else if (r0 + p < n) {
      sym = band[(size_t)(r0 + p) * w + q - p];
    }
    a11[q * ld + p] = sym;
    a21[q * ld + p] = c11 < n ? band[(size_t)c11 * w + b + p - q] : T(0);
  }
  __syncthreads();

  if (tid < 32) {  // larfg in one warp; lane handles p = lane and lane + 32
    const T* x = a10 + (k == 0 ? b - 1 : 0) * ld;
    const T x0 = tid < b ? x[tid] : T(0);
    const T x1 = tid + 32 < b ? x[tid + 32] : T(0);
    const T xnormsq = warp_sum((tid == 0 ? T(0) : x0 * x0) + x1 * x1);
    const T alpha = x[0];
    const bool trivial = xnormsq == T(0);
    const T norm = sqrt(alpha * alpha + xnormsq);
    const T beta = alpha >= T(0) ? -norm : norm;
    const T tau = trivial ? T(0) : (beta - alpha) / beta;
    const T denom = trivial ? T(1) : alpha - beta;
    if (tid < b) vv[tid] = tid == 0 ? (trivial ? T(0) : T(1)) : x0 / denom;
    if (tid + 32 < b) vv[tid + 32] = x1 / denom;
    if (tid == 0) scal[0] = tau;
  }
  __syncthreads();

  if (tid < b) {  // u1[q] = sum_p v[p] A10[p, q]
    T acc = T(0);
    for (int p = 0; p < b; ++p) acc += vv[p] * a10[tid * ld + p];
    u1[tid] = acc;
  } else if (tid < 2 * b) {  // y[p] = sum_q A11[p, q] v[q]
    const int p = tid - b;
    T acc = T(0);
    for (int q = 0; q < b; ++q) acc += a11[q * ld + p] * vv[q];
    yy[p] = acc;
  } else if (tid < 3 * b) {  // y2[p] = sum_q A21[p, q] v[q]
    const int p = tid - 2 * b;
    T acc = T(0);
    for (int q = 0; q < b; ++q) acc += a21[q * ld + p] * vv[q];
    y2[p] = acc;
  }
  __syncthreads();

  const T tau = scal[0];
  if (tid < 32) {  // w = tau y - (tau^2 (v . y) / 2) v
    const T v0 = tid < b ? vv[tid] : T(0), y0 = tid < b ? yy[tid] : T(0);
    const T v1 = tid + 32 < b ? vv[tid + 32] : T(0);
    const T y1 = tid + 32 < b ? yy[tid + 32] : T(0);
    const T vav = warp_sum(v0 * y0 + v1 * y1);
    const T half = T(0.5) * tau * tau * vav;
    if (tid < b) ww[tid] = tau * y0 - half * v0;
    if (tid + 32 < b) ww[tid + 32] = tau * y1 - half * v1;
  }
  __syncthreads();

  for (int idx = tid; idx < b * b; idx += kThreads) {
    const int q = idx / b, p = idx - q * b;
    const int c10 = r0 - b + q, c11 = r0 + q;
    if (c10 >= 0)
      band[(size_t)c10 * w + b + p - q] = a10[q * ld + p] - tau * vv[p] * u1[q];
    if (c11 < n) {
      if (p >= q)
        band[(size_t)c11 * w + p - q] =
            a11[q * ld + p] - (vv[p] * ww[q] + ww[p] * vv[q]);
      band[(size_t)c11 * w + b + p - q] = a21[q * ld + p] - tau * y2[p] * vv[q];
    }
  }
  if (tid < b) vt[((size_t)t * s_slots + s) * b + tid] = vv[tid];
  if (tid == 0) taut[(size_t)t * s_slots + s] = tau;
}

template <typename T>
int chase_launch(T* band, int n, int b, T* vt, T* taut, void* stream) {
  if (n < 3 || b < 2 || b > kMaxB) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int s_slots = ((n - 3) / b) / 3 + 1;
  const int t_total = n > 3 ? 3 * (n - 3) + 1 : 1;
  const int stride = 3 * b - 1;
  const size_t smem = (size_t)(3 * b * (b + 1) + 5 * b + 1) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      chase_step<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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
    chase_step<T><<<s_hi - s_lo + 1, kThreads, smem, st>>>(
        band, n, b, t, s_lo, s_slots, vt, taut);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace

// band: n * 2b elements, chased in place (its first two columns are d and
// e on return); vt: t3 * s_slots * b and taut: t3 * s_slots elements, zeroed
// by the caller, with s_slots = ((n - 3) / b) / 3 + 1,
// t3 = 3 * ceil((3 (n - 3) + 1) / 3).
extern "C" int bulge_chase_f32_launch(float* band, int n, int b, float* vt,
                                      float* taut, void* stream) {
  return chase_launch<float>(band, n, b, vt, taut, stream);
}

extern "C" int bulge_chase_f64_launch(double* band, int n, int b, double* vt,
                                      double* taut, void* stream) {
  return chase_launch<double>(band, n, b, vt, taut, stream);
}
