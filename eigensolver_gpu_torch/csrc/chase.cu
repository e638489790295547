// Kernel K7: band -> tridiagonal bulge chase, all wavefront timesteps in one
// persistent kernel (eigensolver_gpu_torch/ops/chase.py::bulge_chase_kernel,
// called once per two-stage solve by models/syevdx.py).
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
// What bounds it on the H100: the 3 (n - 3) + 1 dependent timesteps (12 280
// at n = 4096), each a few microseconds of latency on at most
// ceil(n / (3b - 1)) windows of 3 b^2 entries: per step a slot waits for its
// neighbours' flags, stages its tiles from L2, builds the reflector and
// applies it. Bytes (the band, read and written once, and the reflector
// store) and operations are far below that chain. On an NVIDIA H100 80GB
// HBM3 at 700 W (n = 4096, b = 32, fp32, tools/kernel_phases.py) a step
// takes about 7 000 SM cycles: the flag wait 1 400, staging the tiles after
// it 1 300, the publishing fence 1 200, the write-back 1 100, the dlarfg
// 800, the three products 800, w 500.
//
// Design, the planar chase's (csrc/chase_planar.cu, whose header derives the
// dependency rule and the deadlock freedom; tests/test_torch_chase_schedule.py
// checks the rule against this chase's footprint): one cooperative launch
// per call of G blocks, block g owning the (item, slot) pairs
// p = item s_slots + s with p = g (mod G) and looping over all timesteps; at
// each it runs its pairs in ascending p. Slot s at t waits for slots s - 1
// and s + 1 of its item to have finished t - 1, and every slot, active or
// not, publishes after it waits. One band (batch 1) is the plain case; a
// batch of bands (one launch for the batch of a batched solve) chases each
// item exactly so, with pairs of different items never waiting on each
// other, so each item's outputs are the bits of a launch on that item alone.
// G = min(batch s_slots, the blocks that fit on the card at once: resident
// blocks an SM times SMs).
//
// Flags: progress[p] = t + 1 once pair p has finished t (an int scratch of
// batch s_slots words, zeroed by the caller on the stream). Publishing is
// __syncthreads(), then thread 0's fence.acq_rel.gpu and a relaxed
// device-scope store (a release); waiting is thread 0 spinning on
// device-scope acquire loads, then __syncthreads(). Band tiles are read
// with ld.global.cg (L2, never a stale L1 line of another SM's write), all
// of a thread's tile entries at b = 32 in flight at once; the band is not
// marked const __restrict__, which would allow non-coherent loads.
//
// Co-residency: a spinning block needs its neighbours to run, so all G
// blocks must be resident at once. G is at most what the occupancy
// calculator says fits (one block an SM at least: a block takes at most
// 101 KB of shared memory, fp64, b = 64); the cooperative launch checks it
// and fails with an error (cudaErrorCooperativeLaunchTooLarge) rather than
// run what could hang, and the wrapper raises. There is no fallback.
// Deadlock-free: block g runs (t, p) only after its own (t, p - G) and
// (t - 1, *), and every wait is on a (t - 1, *) of another block, so the
// least unfinished (t, p) in lexicographic order can always run.
//
// A block of 512 threads stages its three b x b tiles in shared memory
// straight from band storage (out-of-matrix columns are guarded; thread
// (p, q0) takes the entries of row p in columns q0, q0 + 512 / b, .., so
// the loops hold no division), builds the reflector in one warp, forms the
// three products with 3b threads, and writes the tiles back; it writes
// nothing outside its window. The window arithmetic and the order of every
// sum are those of the launch sequence this kernel replaced (one launch per
// timestep), so its outputs are the same bits; two calls give the same
// bits. Plain FMA arithmetic; float and double instances.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxB = 64;
constexpr int kTileLoads = 2;  // tile entries a thread loads at once: all of them at b = 32

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ double warp_sum(double x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// a band entry from L2, past this SM's L1
__device__ __forceinline__ float from_l2(const float* p) { return __ldcg(p); }
__device__ __forceinline__ double from_l2(const double* p) { return __ldcg(p); }

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// after a __syncthreads(): the block's writes, then the flag (fence.acq_rel
// and a relaxed store make a release at device scope)
__device__ __forceinline__ void publish(int* p, int v) {
  asm volatile("fence.acq_rel.gpu;\n\tst.relaxed.gpu.b32 [%0], %1;" : : "l"(p), "r"(v) : "memory");
}

// One active window (t, s): stage, reflect, apply, write back. Called by
// all threads of the block; `smem` holds 3 b (b + 1) + 5 b + 1 elements.
// Thread (pt, q0) = (tid % b, tid / b) handles the tile entries (pt, q) for
// q = q0, q0 + qs, .. < b, qs = kThreads / b (none when q0 >= qs).
template <typename T>
__device__ void chase_window(T* band, int n, int b, int t, int s, int s_slots, T* vt,
                             T* taut, T* smem, int pt, int q0, int qs) {
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
  const int k = t % 3 + 3 * s;
  const int r0 = t / 3 - s + 1 + k * b;
  const int w = 2 * b;

  // columns r0 - b and r0; entry (p, q) of A10 and A21 lies q (2b - 1) + p + b
  // past them, of A11 q (2b - 1) + p (p >= q)
  const T* c10 = band + (ptrdiff_t)(r0 - b) * w;
  const T* c11 = band + (size_t)r0 * w;

  // the three tiles: thread (pt, q0) takes the entries (pt, q0 + k qs),
  // kTileLoads of them (three loads each) in flight at once
  for (int qb = q0; qb < b; qb += kTileLoads * qs) {
    T x[kTileLoads][3];
#pragma unroll
    for (int u = 0; u < kTileLoads; ++u) {
      const int q = qb + u * qs, p = pt;
      if (q >= b) break;
      const int o = q * (w - 1) + p;
      const bool in10 = r0 - b + q >= 0, in11 = r0 + q < n;
      x[u][0] = in10 ? from_l2(c10 + o + b) : T(0);
      // A11: the stored entry A[r0 + p, r0 + q] (p >= q), else the stored
      // A[r0 + q, r0 + p]; one load path for both, so the warp does not split
      const bool low = p >= q;
      const int o11 = low ? o : p * (w - 1) + q;
      const bool in = low ? in11 : r0 + p < n;
      x[u][1] = in ? from_l2(c11 + o11) : T(0);
      x[u][2] = in11 ? from_l2(c11 + o + b) : T(0);
    }
#pragma unroll
    for (int u = 0; u < kTileLoads; ++u) {
      const int q = qb + u * qs;
      if (q >= b) break;
      const int at = q * ld + pt;
      a10[at] = x[u][0];
      a11[at] = x[u][1];
      a21[at] = x[u][2];
    }
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

  for (int q = q0; q < b; q += qs) {
    const int p = pt;
    const int o = q * (w - 1) + p;
    const int at = q * ld + p;
    if (r0 - b + q >= 0) band[(ptrdiff_t)(r0 - b) * w + o + b] = a10[at] - tau * vv[p] * u1[q];
    if (r0 + q < n) {
      if (p >= q) band[(size_t)r0 * w + o] = a11[at] - (vv[p] * ww[q] + ww[p] * vv[q]);
      band[(size_t)r0 * w + o + b] = a21[at] - tau * y2[p] * vv[q];
    }
  }
  if (tid < b) vt[((size_t)t * s_slots + s) * b + tid] = vv[tid];
  if (tid == 0) taut[(size_t)t * s_slots + s] = tau;
}

// All timesteps: block g owns the (item, slot) pairs p = g (mod G); item k's
// band starts k n 2b elements in, its reflectors k t3 s_slots b (vt) and
// k t3 s_slots (taut) elements in.
template <typename T>
__global__ void __launch_bounds__(kThreads)
chase_kernel(T* band, int n, int b, int t_total, int t3, int s_slots, int pairs, T* vt,
             T* taut, int* progress) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int qs = kThreads / b, pt = threadIdx.x % b;
  const int q0 = threadIdx.x / b < qs ? threadIdx.x / b : b;  // b: no entries
  const size_t band_len = (size_t)n * 2 * b, tau_len = (size_t)t3 * s_slots;
  for (int t = 0; t < t_total; ++t) {
    const int vmax = t / 3, k0 = t % 3;
    for (int p = blockIdx.x; p < pairs; p += gridDim.x) {
      const int item = p / s_slots, s = p - item * s_slots;
      // wait for slots s - 1 and s + 1 of this item to have finished t - 1
      if (threadIdx.x == 0 && t > 0) {
        const int* lo = progress + (s > 0 ? p - 1 : p);
        const int* hi = progress + (s + 1 < s_slots ? p + 1 : p);
        while (load_acquire(lo) < t || load_acquire(hi) < t) {
        }
      }
      __syncthreads();
      const int v = vmax - s;
      if (v >= 0 && v <= n - 3 && v + 1 + (k0 + 3 * s) * b <= n - 2)
        chase_window<T>(band + item * band_len, n, b, t, s, s_slots, vt + item * tau_len * b,
                        taut + item * tau_len, smem, pt, q0, qs);
      __syncthreads();
      if (threadIdx.x == 0) publish(progress + p, t + 1);
    }
  }
}

template <typename T>
size_t smem_bytes(int b) {
  return (size_t)(3 * b * (b + 1) + 5 * b + 1) * sizeof(T);
}

// G: the pairs, at most as many blocks as fit on the card at once
template <typename T>
cudaError_t grid_blocks(int b, int pairs, int* blocks) {
  const size_t smem = smem_bytes<T>(b);
  auto kernel = chase_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  const long long resident = (long long)per_sm * sms;
  *blocks = pairs < resident ? pairs : (int)resident;
  return cudaSuccess;
}

template <typename T>
int chase_launch(T* band, int n, int b, int batch, T* vt, T* taut, int* progress,
                 void* stream) {
  if (n < 3 || b < 2 || b > kMaxB || batch < 0) return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  int s_slots = ((n - 3) / b) / 3 + 1;
  int t_total = n > 3 ? 3 * (n - 3) + 1 : 1;
  int t3 = 3 * ((t_total + 2) / 3);
  if ((long long)batch * s_slots > (1LL << 30)) return (int)cudaErrorInvalidValue;
  int pairs = batch * s_slots;
  const size_t smem = smem_bytes<T>(b);
  auto kernel = chase_kernel<T>;
  int blocks = 0;
  cudaError_t err = grid_blocks<T>(b, pairs, &blocks);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&band, &n, &b, &t_total, &t3, &s_slots, &pairs, &vt, &taut, &progress};
  // fails, and launches nothing, if the blocks cannot all be resident
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(kThreads), args,
                                    smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// A batch of bands, item after item: band: batch * n * 2b elements, chased
// in place (an item's first two columns are its d and e on return); vt:
// batch * t3 * s_slots * b and taut: batch * t3 * s_slots elements, zeroed by
// the caller, with s_slots = ((n - 3) / b) / 3 + 1,
// t3 = 3 * ceil((3 (n - 3) + 1) / 3); progress: batch * s_slots ints, zeroed
// by the caller.
extern "C" int bulge_chase_f32_launch(float* band, int n, int b, int batch, float* vt,
                                      float* taut, int* progress, void* stream) {
  return chase_launch<float>(band, n, b, batch, vt, taut, progress, stream);
}

extern "C" int bulge_chase_f64_launch(double* band, int n, int b, int batch, double* vt,
                                      double* taut, int* progress, void* stream) {
  return chase_launch<double>(band, n, b, batch, vt, taut, progress, stream);
}

// The number of blocks G a launch of `pairs` (item, slot) pairs at half-width
// b runs (f64: the double instance), in *blocks; for the logs and checks.
extern "C" int bulge_chase_blocks(int b, int pairs, int f64, int* blocks) {
  if (b < 2 || b > kMaxB || pairs < 1) return (int)cudaErrorInvalidValue;
  return (int)(f64 ? grid_blocks<double>(b, pairs, blocks) : grid_blocks<float>(b, pairs, blocks));
}
