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
// column left as it was. v and r are separate (m, b) outputs. Then T (b x b,
// upper triangular) with H(0) H(1) .. H(b-1) = I - V T V^T:
// T[:, j] = -tau_j T[:, :j] (V^T V)[:j, j], T[j, j] = tau_j.
//
// What bounds it on the H100: neither bytes (0.5 MB in fp32 at (4096, 32))
// nor operations, but the chain of b dependent columns, each a reduction
// over the strip followed by a rank-1 update of it. On one SM the strip
// lives in L2 and every column moves it through that SM's path to L2.
//
// What the design does about it (the planar twin's, csrc/ql_panel_planar.cu,
// for real numbers): the active rows [0, rb + b) are cut into contiguous row
// slabs, one per thread block, and the blocks form one thread-block cluster
// (up to 16, one per SM; the launch raises if no such cluster can be
// co-resident). Each block reads its slab once into shared memory and writes
// it back once; v lives in the entries the reflector zeroes, as in LAPACK.
// Per column two cluster barriers:
//   1. each block publishes its partial |x|^2 (and the pivot's owner alpha)
//      in its shared memory; after the barrier every block reads the
//      partials from its peers' shared memory and sums them in the same
//      fixed order, so all hold bit-identical beta and tau;
//   2. each block scales its rows to v and publishes its partial
//      v^T P[:, c < j]; after the barrier every block sums the partials in
//      fixed order, applies the rank-1 update to its rows and, in the same
//      pass, takes the next column's partial norm.
// Then each block publishes its partial gram V^T V; block 0 sums them in
// fixed order and runs the b-step larft. No atomics: bit-reproducible.
// The number of blocks follows the active rows (one per kRowsTarget rows),
// so a short panel (rb + b <= 256) runs in one block, whose cluster barrier
// waits on no peer. Whether the slab is in shared memory is decided at
// compile time; where it does not fit (fp32 far past m = 4096) it stays in
// the output r in global memory and the same code runs on it. Plain FMA
// arithmetic.
//
// Any m >= 1, 1 <= b <= 64, 0 <= rb <= m - b; the panel may be a column
// slice of a row-major matrix (row stride ldp >= b).
//
// A batch of panels (the panels of a batch of problems at one sbrd step:
// same m, b, rb, item k at batch stride sp from the first) is one launch of
// gridDim (blocks, batch) with the cluster (blocks, 1, 1): a cluster an item,
// each running the code above on its own panel and its own outputs (contiguous,
// item after item). The clusters share nothing, so those that do not fit on
// the card at once run after the others, and each item's outputs are the bits
// of a launch on that item alone.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxB = 64;
constexpr int kMaxBlocks = 16;    // the largest (non-portable) cluster
constexpr int kRowsTarget = 256;  // active rows per block
constexpr int kSmemMax = 232448;  // a block's shared memory on the H100
constexpr int kLoads = 8;         // global loads in flight a thread

struct Geometry {
  int blocks, slab_rows, slab_in_smem, smem_bytes;
};

// Shared memory, in elements of T: the slot a block publishes (norm and
// alpha, double-buffered by column parity: 4; v^T P: kMaxB; gram: b b),
// lane partials (2 kThreads), the update vector u and the taus (2 kMaxB),
// then the trivial flags (kMaxB ints) and, if it fits, the slab
// (slab_rows b).
__host__ __device__ inline int slot_len(int b) { return 4 + kMaxB + b * b; }

__host__ __device__ inline size_t base_elems(int b) {
  return (size_t)slot_len(b) + 2 * kThreads + 2 * kMaxB;
}

Geometry geometry(int b, int rb, int itemsize) {
  const int mact = rb + b;
  int blocks = (mact + kRowsTarget - 1) / kRowsTarget;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const int slab = (mact + blocks - 1) / blocks;
  const size_t base = base_elems(b) * itemsize + kMaxB * sizeof(int);
  const size_t with_slab = base + (size_t)slab * b * itemsize;
  const bool fits = with_slab <= (size_t)kSmemMax;
  return Geometry{blocks, slab, fits ? 1 : 0, (int)(fits ? with_slab : base)};
}

// kSmemSlab: the slab is in shared memory (known at compile time, so its
// accesses compile to shared-memory instructions), else in r.
template <typename T, bool kSmemSlab>
__global__ void __launch_bounds__(kThreads)
ql_panel_kernel(const T* __restrict__ p, int ldp, long long sp, int m, int b, int rb,
                int slab_rows, T* r, T* v, T* tau, T* tmat) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  {  // this cluster's item: its panel and its outputs
    const long long item = blockIdx.y;
    p += item * sp;
    const long long mb = (long long)m * b;
    r += item * mb;
    v += item * mb;
    tau += item * b;
    tmat += item * (long long)b * b;
  }
  cg::cluster_group cluster = cg::this_cluster();
  T* slot = reinterpret_cast<T*>(smem_raw);  // published to the peers
  // element `off` of block g's copy of the slot array that `q` points into
  auto peer = [&](T* q, int g, int off) -> T { return cluster.map_shared_rank(q, g)[off]; };
  T* nslots = slot;                          // 2 x (|x|^2 partial, alpha)
  T* wslot = slot + 4;                       // v^T P partial, kMaxB
  T* gslot = wslot + kMaxB;                  // gram partial, b b
  T* part = slot + slot_len(b);              // kThreads
  T* npart = part + kThreads;                // kThreads
  T* u = npart + kThreads;                   // kMaxB
  T* tau_s = u + kMaxB;                      // kMaxB, all columns
  int* trivial_of = reinterpret_cast<int*>(tau_s + kMaxB);  // kMaxB

  const int tid = threadIdx.x;
  const int nblocks = gridDim.x;
  const int rank = blockIdx.x;
  const int mact = rb + b;
  const int row0 = rank * slab_rows;
  const int row1 = min(row0 + slab_rows, mact);
  const int nrows = max(row1 - row0, 0);
  T* s = kSmemSlab ? reinterpret_cast<T*>(trivial_of + kMaxB) : r + (size_t)row0 * b;
  // (row lane, column) layout of the column passes
  const int lanes = kThreads / b;
  const int c = tid % b;
  const int rl = tid / b;
  const bool in_layout = rl < lanes;
  auto at = [&](int row, int col) { return (row - row0) * b + col; };

  // the slab, kLoads loads in flight a thread
  for (int base = tid; base < nrows * b; base += kLoads * kThreads) {
    T x[kLoads];
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int idx = base + q * kThreads;
      if (idx < nrows * b) x[q] = p[(size_t)(row0 + idx / b) * ldp + idx % b];
    }
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int idx = base + q * kThreads;
      if (idx < nrows * b) s[idx] = x[q];
    }
  }
  // rows past the last pivot are never touched: copied, v = 0
  for (int idx = rank * kThreads + tid; idx < (m - mact) * b; idx += nblocks * kThreads) {
    const int row = mact + idx / b, col = idx % b;
    r[(size_t)row * b + col] = p[(size_t)row * ldp + col];
    v[(size_t)row * b + col] = T(0);
  }
  __syncthreads();

  // Publish the partial |x|^2 of column jn over this slab's rows < rb + jn
  // (acc: this thread's share, if its layout column is jn) and, from the
  // pivot's owner, alpha; then the cluster barrier. The slot alternates
  // with the column's parity: a column without an update has only this
  // barrier, and a slow peer may still read the previous column's slot.
  auto publish_norm = [&](int jn, T acc) {
    T* nslot = nslots + 2 * (jn & 1);
    if (in_layout && c == jn) npart[rl] = acc;
    __syncthreads();
    if (tid == 0) {
      T sum = T(0);
      for (int l = 0; l < lanes; ++l) sum += npart[l];
      nslot[0] = sum;
      const int top = rb + jn;
      if (top >= row0 && top < row1) nslot[1] = s[at(top, jn)];
    }
    cluster.sync();
  };

  {
    const int jn = b - 1;
    T acc = T(0);
    if (in_layout && c == jn)
      for (int row = row0 + rl; row < min(row1, rb + jn); row += lanes) {
        const T x = s[at(row, jn)];
        acc += x * x;
      }
    publish_norm(jn, acc);
  }

  for (int j = b - 1; j >= 0; --j) {
    const int top = rb + j;
    T* nslot = nslots + 2 * (j & 1);
    // every warp sums the peers' partials in the same order (a butterfly
    // whose pairs add the same two values in every lane)
    const int lane = tid % 32;
    T xnormsq = lane < nblocks ? peer(nslot, lane, 0) : T(0);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) xnormsq += __shfl_xor_sync(0xffffffffu, xnormsq, off);
    const T alpha = peer(nslot, top / slab_rows, 1);
    const bool trivial = xnormsq == T(0);
    const T norm = sqrt(alpha * alpha + xnormsq);
    const T beta = alpha >= T(0) ? -norm : norm;
    const T tau_j = trivial ? T(0) : (beta - alpha) / beta;
    const T denom = trivial ? T(1) : alpha - beta;
    // v = x / (alpha - beta) above the pivot (kept in the zeroed entries);
    // the pivot becomes beta
    for (int row = row0 + tid; row < min(row1, top + 1); row += kThreads) {
      const int k = at(row, j);
      if (row < top)
        s[k] = s[k] / denom;
      else if (!trivial)
        s[k] = beta;
    }
    if (tid == 0) {
      tau_s[j] = tau_j;
      trivial_of[j] = trivial ? 1 : 0;
    }
    if (j == 0) break;
    const bool update = !trivial;  // uniform over the cluster
    if (update) {
      __syncthreads();
      // vp[c] = sum_row v[row] P[row, c] for the columns c < j
      T acc = T(0);
      if (in_layout && c < j) {
#pragma unroll 4
        for (int row = row0 + rl; row < min(row1, top + 1); row += lanes) {
          const T w = row == top ? T(1) : s[at(row, j)];
          acc += w * s[at(row, c)];
        }
      }
      part[tid] = acc;
      __syncthreads();
      if (tid < j) {
        T sum = T(0);
        for (int l = 0; l < lanes; ++l) sum += part[l * b + tid];
        wslot[tid] = sum;
      }
      cluster.sync();
      if (tid < j) {
        T sum = T(0);
        T w[kMaxBlocks];  // all remote loads in flight, then the sum
#pragma unroll
        for (int g = 0; g < kMaxBlocks; ++g) w[g] = g < nblocks ? peer(wslot, g, tid) : T(0);
#pragma unroll
        for (int g = 0; g < kMaxBlocks; ++g) sum += w[g];
        u[tid] = tau_j * sum;
      }
      __syncthreads();
    }
    // the rank-1 update of the columns c < j, rows <= top, and the next
    // column's partial norm over rows < top - 1
    T acc = T(0);
    if (in_layout && c < j) {
#pragma unroll 4
      for (int row = row0 + rl; row < min(row1, top + 1); row += lanes) {
        T x = s[at(row, c)];
        if (update) {
          const T w = row == top ? T(1) : s[at(row, j)];
          x -= w * u[c];
          s[at(row, c)] = x;
        }
        if (c == j - 1 && row < top - 1) acc += x * x;
      }
    }
    publish_norm(j - 1, acc);
  }
  __syncthreads();

  // partial gram (V^T V)[l, k] for l < k over this slab: v_l is nonzero on
  // rows <= rb + l < rb + k only, where v_k is stored in the slab
  for (int q = tid; q < b * b; q += kThreads) {
    const int l = q / b, k = q % b;
    T acc = T(0);
    if (l < k) {
      const int topl = rb + l;
#pragma unroll 8
      for (int row = row0; row < min(row1, topl + 1); ++row) {
        const T a = row < topl ? s[at(row, l)] : (trivial_of[l] ? T(0) : T(1));
        acc += a * s[at(row, k)];
      }
    }
    gslot[q] = acc;
  }
  __syncthreads();
  // outputs: above each pivot r = 0 and v as stored; at the pivot r = beta
  // and v = 1 (0 when trivial); below it r as it stands and v = 0
  for (int idx = tid; idx < nrows * b; idx += kThreads) {
    const int row = row0 + idx / b, col = idx % b;
    const int topc = rb + col;
    const T x = s[idx];
    const size_t o = (size_t)row * b + col;
    if (row < topc) {
      r[o] = T(0);
      v[o] = x;
    } else {
      r[o] = x;
      v[o] = row == topc && !trivial_of[col] ? T(1) : T(0);
    }
  }
  cluster.sync();
  if (rank == 0) {
    for (int q = tid; q < b * b; q += kThreads) {
      T sum = T(0);
      for (int g = 0; g < nblocks; ++g) sum += peer(gslot, g, q);
      gslot[q] = sum;
    }
  }
  cluster.sync();  // the peers' shared memory stays readable until here
  if (rank != 0) return;
  if (tid < b) tau[tid] = tau_s[tid];
  // forward larft: b dependent columns; T is upper triangular, so row i of
  // column j sums over l in [i, j). T[i][j] is kept at the gram's (j, i),
  // whose lower triangle the gram leaves unused.
  for (int j = 0; j < b; ++j) {
    if (tid <= j) {
      const T tau_j = tau_s[j];
      T val = tau_j;
      if (tid < j) {
        T sum = T(0);
        for (int l = tid; l < j; ++l) sum += gslot[l * b + tid] * gslot[l * b + j];
        val = -tau_j * sum;
      }
      gslot[j * b + tid] = val;
    }
    __syncthreads();
  }
  for (int q = tid; q < b * b; q += kThreads) {
    const int i = q / b, j = q % b;
    tmat[q] = i <= j ? gslot[j * b + i] : T(0);
  }
}

template <typename T>
int ql_panel_launch(const T* p, int ldp, long long sp, int m, int b, int rb, int batch,
                    T* r, T* v, T* tau, T* tmat, void* stream) {
  if (b < 1 || b > kMaxB || m < b || rb < 0 || rb + b > m || ldp < b || batch < 0 ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  const Geometry geo = geometry(b, rb, (int)sizeof(T));
  auto kernel = geo.slab_in_smem ? ql_panel_kernel<T, true> : ql_panel_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(geo.blocks, batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = geo.smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = geo.blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a cluster that cannot be co-resident would never run: refuse it (the
  // clusters of a batch need not all be resident at once)
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, kernel, p, ldp, sp, m, b, rb, geo.slab_rows, r, v, tau,
                           tmat);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// batch panels, item k at p + k sp (row stride ldp); r, v: batch * m * b
// elements (row-major, contiguous, item after item); tau: batch * b; tmat:
// batch * b * b.
extern "C" int ql_panel_f32_launch(const float* p, int ldp, long long sp, int m, int b,
                                   int rb, int batch, float* r, float* v, float* tau,
                                   float* tmat, void* stream) {
  return ql_panel_launch<float>(p, ldp, sp, m, b, rb, batch, r, v, tau, tmat, stream);
}

extern "C" int ql_panel_f64_launch(const double* p, int ldp, long long sp, int m, int b,
                                   int rb, int batch, double* r, double* v, double* tau,
                                   double* tmat, void* stream) {
  return ql_panel_launch<double>(p, ldp, sp, m, b, rb, batch, r, v, tau, tmat, stream);
}
