// Kernel K8: planar complex Hermitian band -> complex tridiagonal bulge
// chase, all wavefront timesteps in one persistent kernel
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
// What bounds it on the H100: the 3 (n - 3) + 1 dependent timesteps (12 280
// at n = 4096), each a few microseconds of latency on at most
// ceil(n / (3b - 1)) windows of 3 b^2 complex entries: per step a slot
// waits for its neighbours' flags, stages its tiles from L2, builds the
// reflector and applies it. Bytes (the two band planes, read and written
// once, and the reflector store) and operations are far below that chain.
// On an NVIDIA H100 80GB HBM3 at 700 W (n = 4096, b = 32, fp32,
// tools/kernel_phases.py) a step takes about 9 300 SM cycles: staging the
// tiles after the wait 2 100, the write-back 1 700, the three products
// 1 600, the flag wait 1 400, the publishing fence 1 100, the zlarfg 900,
// w 500.
//
// Design: one cooperative launch per call of G blocks, block g owning the
// (item, slot) pairs p = item s_slots + s with p = g (mod G) and looping over
// all timesteps; at each it runs its pairs in ascending p, and an active slot
// runs the window arithmetic below on its item's band. One band (batch 1)
// is the case the text below speaks of; a batch of bands (one launch for
// the batch of a batched solve) chases each item exactly so, with pairs of
// different items never waiting on each other, so each item's outputs are
// the bits of a launch on that item alone. G = min(batch s_slots, the
// blocks that fit on the card at once: resident blocks an SM times SMs).
//
// The dependency rule: slot s at t waits for slots s - 1 and s + 1 of its
// item to have finished t - 1 (its own t - 1 precedes it in its block). Derived from the
// band footprint of the plain chase (ops/sb2st.py::bulge_chase): slot s at t
// reads the strip rows j0(t) + s (3b - 1) + [0, 2b), j0(t) = t / 3 + 1 +
// (t % 3) b - b, and writes those entries with q + d < 3b. From t - 1 to t
// j0 moves by b (k = 1, 2) or by 1 - 2b (k = 0), so against strips 3b - 1
// rows apart only the strips of slots s + 1 (k = 1, 2: one shared row) and
// s - 1 (k = 0: b shared rows) meet slot s's, and a window of t - 1 two
// slots away lies at least 2b - 1 rows clear of it; the windows of one
// timestep are disjoint. Every slot, active or not, waits before it
// publishes, so by induction slot s at t starts after every slot s' has
// finished every t' with |s' - s| <= t - t'; tests/test_torch_chase_schedule.py
// checks that every read-after-write and write-after-read pair of the plain
// footprint, at any distance in time, lies inside that cone.
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
// 205 KB of shared memory, fp64, b = 64); the cooperative launch checks it
// and fails with an error (cudaErrorCooperativeLaunchTooLarge) rather than
// run what could hang, and the wrapper raises. There is no fallback.
// Deadlock-free: block g runs (t, p) only after its own (t, p - G) and
// (t - 1, *), and every wait is on a (t - 1, *) of another block, so the
// least unfinished (t, p) in lexicographic order can always run.
//
// A block of 512 threads stages its three b x b complex tiles in shared
// memory straight from band storage (out-of-matrix columns are guarded;
// thread (p, q0) takes the entries of row p in columns q0, q0 + 512 / b,
// .., so the loops hold no division), builds the reflector in one warp,
// forms the three products with 3b threads, and writes the tiles back; it
// writes nothing outside its window. All sums run in a fixed order, so two
// calls give the same bits. Plain FMA arithmetic, four real products per
// complex one; float and double instances.

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
// all threads of the block; `smem` holds 6 b (b + 1) + 10 b + 2 elements.
// Thread (pt, q0) = (tid % b, tid / b) handles the tile entries (pt, q) for
// q = q0, q0 + qs, .. < b, qs = kThreads / b (none when q0 >= qs).
template <typename T>
__device__ void chase_window(T* band_r, T* band_i, int n, int b, int t, int s,
                             int s_slots, T* vt_r, T* vt_i, T* taut_r, T* taut_i,
                             T* smem, int pt, int q0, int qs) {
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
  const int k = t % 3 + 3 * s;
  const int r0 = t / 3 - s + 1 + k * b;
  const int w = 2 * b;

  // columns r0 - b and r0 of both planes; entry (p, q) of A10 and A21 lies
  // q (2b - 1) + p + b past them, of A11 q (2b - 1) + p (p >= q)
  const T* c10r = band_r + (ptrdiff_t)(r0 - b) * w;
  const T* c10i = band_i + (ptrdiff_t)(r0 - b) * w;
  const T* c11r = band_r + (size_t)r0 * w;
  const T* c11i = band_i + (size_t)r0 * w;

  // the three tiles: thread (pt, q0) takes the entries (pt, q0 + k qs),
  // kTileLoads of them (six loads each) in flight at once
  for (int qb = q0; qb < b; qb += kTileLoads * qs) {
    T x[kTileLoads][6];
#pragma unroll
    for (int u = 0; u < kTileLoads; ++u) {
      const int q = qb + u * qs, p = pt;
      if (q >= b) break;
      const int o = q * (w - 1) + p;
      const bool in10 = r0 - b + q >= 0, in11 = r0 + q < n;
      x[u][0] = in10 ? from_l2(c10r + o + b) : T(0);
      x[u][1] = in10 ? from_l2(c10i + o + b) : T(0);
      // A11: the stored entry A[r0 + p, r0 + q] (p >= q), else the conj of
      // the stored A[r0 + q, r0 + p]; the diagonal is real: its imaginary
      // part reads 0. One load path for all three, so the warp does not split
      const bool low = p >= q;
      const int o11 = low ? o : p * (w - 1) + q;
      const bool in = low ? in11 : r0 + p < n;
      const T sr = in ? from_l2(c11r + o11) : T(0);
      const T si = in && p != q ? from_l2(c11i + o11) : T(0);
      x[u][2] = sr;
      x[u][3] = low || !in ? si : -si;
      x[u][4] = in11 ? from_l2(c11r + o + b) : T(0);
      x[u][5] = in11 ? from_l2(c11i + o + b) : T(0);
    }
#pragma unroll
    for (int u = 0; u < kTileLoads; ++u) {
      const int q = qb + u * qs;
      if (q >= b) break;
      const int at = q * ld + pt;
      a10r[at] = x[u][0];
      a10i[at] = x[u][1];
      a11r[at] = x[u][2];
      a11i[at] = x[u][3];
      a21r[at] = x[u][4];
      a21i[at] = x[u][5];
    }
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

  for (int q = q0; q < b; q += qs) {
    const int p = pt;
    const int o = q * (w - 1) + p;
    const int at = q * ld + p;
    const T vpr = vvr[p], vpi = vvi[p], vqr = vvr[q], vqi = vvi[q];
    if (r0 - b + q >= 0) {  // A10 -= v_p (conj(tau) u1_q)
      const T cr = tr * u1r[q] + ti * u1i[q], ci = tr * u1i[q] - ti * u1r[q];
      band_r[(ptrdiff_t)(r0 - b) * w + o + b] = a10r[at] - (vpr * cr - vpi * ci);
      band_i[(ptrdiff_t)(r0 - b) * w + o + b] = a10i[at] - (vpr * ci + vpi * cr);
    }
    if (r0 + q < n) {
      if (p >= q) {  // A11 -= w_p conj(v_q) + v_p conj(w_q)
        const T wpr = wwr[p], wpi = wwi[p], wqr = wwr[q], wqi = wwi[q];
        band_r[(size_t)r0 * w + o] =
            a11r[at] - (wpr * vqr + wpi * vqi + vpr * wqr + vpi * wqi);
        band_i[(size_t)r0 * w + o] =
            p == q ? T(0)
                   : a11i[at] - (wpi * vqr - wpr * vqi + vpi * wqr - vpr * wqi);
      }
      // A21 -= (tau y2_p) conj(v_q)
      const T cr = tr * y2r[p] - ti * y2i[p], ci = tr * y2i[p] + ti * y2r[p];
      band_r[(size_t)r0 * w + o + b] = a21r[at] - (cr * vqr + ci * vqi);
      band_i[(size_t)r0 * w + o + b] = a21i[at] - (ci * vqr - cr * vqi);
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


// All timesteps: block g owns the (item, slot) pairs p = g (mod G); item k's
// band starts k n 2b elements in, its reflectors k t3 s_slots b (vt) and
// k t3 s_slots (taut) elements in.
template <typename T>
__global__ void __launch_bounds__(kThreads)
chase_planar_kernel(T* band_r, T* band_i, int n, int b, int t_total, int t3, int s_slots,
                    int pairs, T* vt_r, T* vt_i, T* taut_r, T* taut_i, int* progress) {
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
        chase_window<T>(band_r + item * band_len, band_i + item * band_len, n, b, t, s, s_slots,
                        vt_r + item * tau_len * b, vt_i + item * tau_len * b,
                        taut_r + item * tau_len, taut_i + item * tau_len, smem, pt, q0, qs);
      __syncthreads();
      if (threadIdx.x == 0) publish(progress + p, t + 1);
    }
  }
}

template <typename T>
size_t smem_bytes(int b) {
  return (size_t)(6 * b * (b + 1) + 10 * b + 2) * sizeof(T);
}

// G: the pairs, at most as many blocks as fit on the card at once
template <typename T>
cudaError_t grid_blocks(int b, int pairs, int* blocks) {
  const size_t smem = smem_bytes<T>(b);
  auto kernel = chase_planar_kernel<T>;
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
int chase_planar_launch(T* band_r, T* band_i, int n, int b, int batch, T* vt_r, T* vt_i,
                        T* taut_r, T* taut_i, int* progress, void* stream) {
  if (n < 3 || b < 2 || b > kMaxB || batch < 0) return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  int s_slots = ((n - 3) / b) / 3 + 1;
  int t_total = n > 3 ? 3 * (n - 3) + 1 : 1;
  int t3 = 3 * ((t_total + 2) / 3);
  if ((long long)batch * s_slots > (1LL << 30)) return (int)cudaErrorInvalidValue;
  int pairs = batch * s_slots;
  const size_t smem = smem_bytes<T>(b);
  auto kernel = chase_planar_kernel<T>;
  int blocks = 0;
  cudaError_t err = grid_blocks<T>(b, pairs, &blocks);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&band_r, &band_i, &n, &b, &t_total, &t3, &s_slots, &pairs,
                  &vt_r, &vt_i, &taut_r, &taut_i, &progress};
  // fails, and launches nothing, if the blocks cannot all be resident
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(kThreads), args,
                                    smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// A batch of bands, item after item: band_r, band_i: batch * n * 2b elements
// each, chased in place (the first column of an item's band_r is its d, the
// second columns of the two planes its e on return); vt_r, vt_i:
// batch * t3 * s_slots * b and taut_r, taut_i: batch * t3 * s_slots elements,
// zeroed by the caller, with s_slots = ((n - 3) / b) / 3 + 1,
// t3 = 3 * ceil((3 (n - 3) + 1) / 3); progress: batch * s_slots ints, zeroed
// by the caller.
extern "C" int bulge_chase_planar_f32_launch(float* band_r, float* band_i,
                                             int n, int b, int batch, float* vt_r,
                                             float* vt_i, float* taut_r,
                                             float* taut_i, int* progress,
                                             void* stream) {
  return chase_planar_launch<float>(band_r, band_i, n, b, batch, vt_r, vt_i, taut_r,
                                    taut_i, progress, stream);
}

extern "C" int bulge_chase_planar_f64_launch(double* band_r, double* band_i,
                                             int n, int b, int batch, double* vt_r,
                                             double* vt_i, double* taut_r,
                                             double* taut_i, int* progress,
                                             void* stream) {
  return chase_planar_launch<double>(band_r, band_i, n, b, batch, vt_r, vt_i, taut_r,
                                     taut_i, progress, stream);
}

// The number of blocks G a launch of `pairs` (item, slot) pairs at half-width
// b runs (f64: the double instance), in *blocks; for the logs and checks.
extern "C" int bulge_chase_planar_blocks(int b, int pairs, int f64, int* blocks) {
  if (b < 2 || b > kMaxB || pairs < 1) return (int)cudaErrorInvalidValue;
  return (int)(f64 ? grid_blocks<double>(b, pairs, blocks) : grid_blocks<float>(b, pairs, blocks));
}
