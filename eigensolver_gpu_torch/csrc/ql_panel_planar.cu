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
// What bounds it on the H100: neither bytes (1 MB in fp32 at (4096, 32))
// nor operations, but the chain of b dependent columns, each a reduction
// over the strip followed by a rank-1 update of it. On one SM the strip
// lives in L2 and every column moves it through that SM's path to L2.
//
// What the design does about it: the active rows [0, rb + b) are cut into
// contiguous row slabs, one per thread block, and the blocks form one
// thread-block cluster (up to 16, one per SM). Each block reads its slab
// of both planes once into shared memory and writes it back once; v lives
// in the entries the reflector zeroes, as in LAPACK. Per column two
// cluster barriers:
//   1. each block publishes its partial |x|^2 (and the pivot's owner
//      alpha) in its shared memory; after the barrier every block reads
//      the partials from its peers' shared memory and sums them in the
//      same fixed order, so all hold bit-identical beta and tau;
//   2. each block scales its rows to v and publishes its partial
//      v^H P[:, c < j]; after the barrier every block sums the partials in
//      fixed order, applies the rank-1 update to its rows and, in the same
//      pass, takes the next column's partial norm.
// Then each block publishes its partial gram V^H V; block 0 sums them in
// fixed order and runs the b-step larft. No atomics: bit-reproducible.
// The number of blocks follows the active rows (one per kRowsTarget rows),
// so a short panel runs in one block without cluster barriers to wait on.
// Where a slab does not fit shared memory (fp64 at b = 64, or fp32 far past
// m = 4096) it stays in the output planes in global memory and the same
// code runs on it. Plain FMA arithmetic, four real products per complex one.
//
// Any m >= 1, 1 <= b <= 64, 0 <= rb <= m - b; the planes may be column slices
// of row-major matrices with one common row stride ldp >= b.
//
// A batch of panels (the panels of a batch of problems at one psbrd step:
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
// alpha, double-buffered by column parity: 8; v^H P: 2 kMaxB; gram: 2 b b),
// lane partials (3 kThreads), the update vector u (2 kMaxB), the taus
// (2 kMaxB), then the trivial flags (kMaxB ints) and, if it fits, the slab
// (2 slab_rows b).
__host__ __device__ inline int slot_len(int b) { return 8 + 2 * kMaxB + 2 * b * b; }

__host__ __device__ inline size_t base_elems(int b) {
  return (size_t)slot_len(b) + 3 * kThreads + 4 * kMaxB;
}

Geometry geometry(int b, int rb, int itemsize) {
  const int mact = rb + b;
  int blocks = (mact + kRowsTarget - 1) / kRowsTarget;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const int slab = (mact + blocks - 1) / blocks;
  const size_t base = base_elems(b) * itemsize + kMaxB * sizeof(int);
  const size_t with_slab = base + (size_t)2 * slab * b * itemsize;
  const bool fits = with_slab <= (size_t)kSmemMax;
  return Geometry{blocks, slab, fits ? 1 : 0, (int)(fits ? with_slab : base)};
}

// kSmemSlab: the slab is in shared memory (known at compile time, so its
// accesses compile to shared-memory instructions), else in rr / ri.
template <typename T, bool kSmemSlab>
__global__ void __launch_bounds__(kThreads)
ql_panel_planar_kernel(const T* __restrict__ pr, const T* __restrict__ pi,
                       int ldp, long long sp, int m, int b, int rb, int slab_rows,
                       T* rr, T* ri, T* vr, T* vi, T* taur, T* taui, T* tmr, T* tmi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  {  // this cluster's item: its panel and its outputs
    const long long item = blockIdx.y;
    pr += item * sp;
    pi += item * sp;
    const long long mb = (long long)m * b, bb = (long long)b * b;
    rr += item * mb;
    ri += item * mb;
    vr += item * mb;
    vi += item * mb;
    taur += item * b;
    taui += item * b;
    tmr += item * bb;
    tmi += item * bb;
  }
  cg::cluster_group cluster = cg::this_cluster();
  T* slot = reinterpret_cast<T*>(smem_raw);  // published to the peers
  // element `off` of block g's copy of the slot array that `p` points into
  auto peer = [&](T* p, int g, int off) -> T { return cluster.map_shared_rank(p, g)[off]; };
  T* nslots = slot;                          // 2 x (|x|^2 partial, alpha)
  T* wslot = slot + 8;                       // v^H P partial, 2 kMaxB
  T* gslot = wslot + 2 * kMaxB;              // gram partial, 2 b b
  T* part_r = slot + slot_len(b);            // kThreads
  T* part_i = part_r + kThreads;             // kThreads
  T* npart = part_i + kThreads;              // kThreads
  T* u_r = npart + kThreads;                 // kMaxB
  T* u_i = u_r + kMaxB;
  T* tau_r = u_i + kMaxB;                    // kMaxB, all columns
  T* tau_i = tau_r + kMaxB;
  int* trivial_of = reinterpret_cast<int*>(tau_i + kMaxB);  // kMaxB

  const int tid = threadIdx.x;
  const int nblocks = gridDim.x;
  const int rank = blockIdx.x;
  const int mact = rb + b;
  const int row0 = rank * slab_rows;
  const int row1 = min(row0 + slab_rows, mact);
  const int nrows = max(row1 - row0, 0);
  T* sr = kSmemSlab ? reinterpret_cast<T*>(trivial_of + kMaxB) : rr + (size_t)row0 * b;
  T* si = kSmemSlab ? sr + (size_t)slab_rows * b : ri + (size_t)row0 * b;
  // (row lane, column) layout of the column passes
  const int lanes = kThreads / b;
  const int c = tid % b;
  const int rl = tid / b;
  const bool in_layout = rl < lanes;
  auto at = [&](int row, int col) { return (row - row0) * b + col; };

  // the slab, kLoads loads in flight a thread
  for (int base = tid; base < nrows * b; base += kLoads * kThreads) {
    T xr[kLoads], xi[kLoads];
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int idx = base + q * kThreads;
      if (idx < nrows * b) {
        const size_t g = (size_t)(row0 + idx / b) * ldp + idx % b;
        xr[q] = pr[g];
        xi[q] = pi[g];
      }
    }
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int idx = base + q * kThreads;
      if (idx < nrows * b) {
        sr[idx] = xr[q];
        si[idx] = xi[q];
      }
    }
  }
  // rows past the last pivot are never touched: copied, v = 0
  for (int idx = rank * kThreads + tid; idx < (m - mact) * b; idx += nblocks * kThreads) {
    const int row = mact + idx / b, col = idx % b;
    rr[(size_t)row * b + col] = pr[(size_t)row * ldp + col];
    ri[(size_t)row * b + col] = pi[(size_t)row * ldp + col];
    vr[(size_t)row * b + col] = T(0);
    vi[(size_t)row * b + col] = T(0);
  }
  __syncthreads();

  // Publish the partial |x|^2 of column jn over this slab's rows < rb + jn
  // (acc: this thread's share, if its layout column is jn) and, from the
  // pivot's owner, alpha; then the cluster barrier. The slot alternates
  // with the column's parity: a column without an update has only this
  // barrier, and a slow peer may still read the previous column's slot.
  auto publish_norm = [&](int jn, T acc) {
    T* nslot = nslots + 4 * (jn & 1);
    if (in_layout && c == jn) npart[rl] = acc;
    __syncthreads();
    if (tid == 0) {
      T s = T(0);
      for (int l = 0; l < lanes; ++l) s += npart[l];
      nslot[0] = s;
      const int top = rb + jn;
      if (top >= row0 && top < row1) {
        nslot[1] = sr[at(top, jn)];
        nslot[2] = si[at(top, jn)];
      }
    }
    cluster.sync();
  };

  {
    const int jn = b - 1;
    T acc = T(0);
    if (in_layout && c == jn)
      for (int row = row0 + rl; row < min(row1, rb + jn); row += lanes) {
        const T xr = sr[at(row, jn)], xi = si[at(row, jn)];
        acc += xr * xr + xi * xi;
      }
    publish_norm(jn, acc);
  }

  for (int j = b - 1; j >= 0; --j) {
    const int top = rb + j;
    T* nslot = nslots + 4 * (j & 1);
    // every warp sums the peers' partials in the same order (a butterfly
    // whose pairs add the same two values in every lane)
    const int lane = tid % 32;
    T xnormsq = lane < nblocks ? peer(nslot, lane, 0) : T(0);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) xnormsq += __shfl_xor_sync(0xffffffffu, xnormsq, off);
    const T ar = peer(nslot, top / slab_rows, 1), ai = peer(nslot, top / slab_rows, 2);
    const bool trivial = xnormsq == T(0) && ai == T(0);
    const T norm = sqrt(ar * ar + ai * ai + xnormsq);
    const T beta = ar >= T(0) ? -norm : norm;
    const T tr = trivial ? T(0) : (beta - ar) / beta;
    const T ti = trivial ? T(0) : -ai / beta;
    // 1 / (alpha - beta)
    const T dr = ar - beta;
    const T den = dr * dr + ai * ai;
    const T sc_r = trivial ? T(0) : dr / den;
    const T sc_i = trivial ? T(0) : -ai / den;
    // v = x / (alpha - beta) above the pivot (kept in the zeroed entries);
    // the pivot becomes real beta
    for (int row = row0 + tid; row < min(row1, top + 1); row += kThreads) {
      const size_t k = at(row, j);
      if (row < top) {
        const T xr = sr[k], xi = si[k];
        sr[k] = xr * sc_r - xi * sc_i;
        si[k] = xr * sc_i + xi * sc_r;
      } else if (!trivial) {
        sr[k] = beta;
        si[k] = T(0);
      }
    }
    if (tid == 0) {
      tau_r[j] = tr;
      tau_i[j] = ti;
      trivial_of[j] = trivial ? 1 : 0;
    }
    if (j == 0) break;
    const bool update = !trivial;  // uniform over the cluster
    if (update) {
      __syncthreads();
      // vp[c] = sum_row conj(v[row]) P[row, c] for the columns c < j
      T acc_r = T(0), acc_i = T(0);
      if (in_layout && c < j) {
#pragma unroll 4
        for (int row = row0 + rl; row < min(row1, top + 1); row += lanes) {
          const T wr = row == top ? T(1) : sr[at(row, j)];
          const T wi = row == top ? T(0) : si[at(row, j)];
          const T xr = sr[at(row, c)], xi = si[at(row, c)];
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
        wslot[2 * tid] = s_r;
        wslot[2 * tid + 1] = s_i;
      }
      cluster.sync();
      if (tid < j) {
        T s_r = T(0), s_i = T(0);
        T w_r[kMaxBlocks], w_i[kMaxBlocks];  // all remote loads in flight, then the sum
#pragma unroll
        for (int g = 0; g < kMaxBlocks; ++g) {
          w_r[g] = g < nblocks ? peer(wslot, g, 2 * tid) : T(0);
          w_i[g] = g < nblocks ? peer(wslot, g, 2 * tid + 1) : T(0);
        }
#pragma unroll
        for (int g = 0; g < kMaxBlocks; ++g) {
          s_r += w_r[g];
          s_i += w_i[g];
        }
        // conj(tau) * vp
        u_r[tid] = tr * s_r + ti * s_i;
        u_i[tid] = tr * s_i - ti * s_r;
      }
      __syncthreads();
    }
    // the rank-1 update of the columns c < j, rows <= top, and the next
    // column's partial norm over rows < top - 1
    T acc = T(0);
    if (in_layout && c < j) {
#pragma unroll 4
      for (int row = row0 + rl; row < min(row1, top + 1); row += lanes) {
        T xr = sr[at(row, c)], xi = si[at(row, c)];
        if (update) {
          const T wr = row == top ? T(1) : sr[at(row, j)];
          const T wi = row == top ? T(0) : si[at(row, j)];
          xr -= wr * u_r[c] - wi * u_i[c];
          xi -= wr * u_i[c] + wi * u_r[c];
          sr[at(row, c)] = xr;
          si[at(row, c)] = xi;
        }
        if (c == j - 1 && row < top - 1) acc += xr * xr + xi * xi;
      }
    }
    publish_norm(j - 1, acc);
  }
  __syncthreads();

  // partial gram (V^H V)[l, k] for l < k over this slab: v_l is nonzero on
  // rows <= rb + l < rb + k only, where v_k is stored in the slab
  for (int p = tid; p < b * b; p += kThreads) {
    const int l = p / b, k = p % b;
    T acc_r = T(0), acc_i = T(0);
    if (l < k) {
      const int topl = rb + l;
#pragma unroll 8
      for (int row = row0; row < min(row1, topl + 1); ++row) {
        T ar = T(0), ai = T(0);
        if (row < topl) {
          ar = sr[at(row, l)];
          ai = si[at(row, l)];
        } else if (!trivial_of[l]) {
          ar = T(1);
        }
        const T br = sr[at(row, k)], bi = si[at(row, k)];
        acc_r += ar * br + ai * bi;
        acc_i += ar * bi - ai * br;
      }
    }
    gslot[2 * p] = acc_r;
    gslot[2 * p + 1] = acc_i;
  }
  __syncthreads();
  // outputs: above each pivot r = 0 and v as stored; at the pivot r = beta
  // and v = 1 (0 when trivial); below it r as it stands and v = 0
  for (int idx = tid; idx < nrows * b; idx += kThreads) {
    const int row = row0 + idx / b, col = idx % b;
    const int topc = rb + col;
    const T xr = sr[idx], xi = si[idx];
    const size_t o = (size_t)row * b + col;
    if (row < topc) {
      rr[o] = T(0);
      ri[o] = T(0);
      vr[o] = xr;
      vi[o] = xi;
    } else {
      rr[o] = xr;
      ri[o] = xi;
      vr[o] = row == topc && !trivial_of[col] ? T(1) : T(0);
      vi[o] = T(0);
    }
  }
  cluster.sync();
  if (rank == 0) {
    for (int p = tid; p < b * b; p += kThreads) {
      T s_r = T(0), s_i = T(0);
      for (int g = 0; g < nblocks; ++g) {
        s_r += peer(gslot, g, 2 * p);
        s_i += peer(gslot, g, 2 * p + 1);
      }
      gslot[2 * p] = s_r;
      gslot[2 * p + 1] = s_i;
    }
  }
  cluster.sync();  // the peers' shared memory stays readable until here
  if (rank != 0) return;
  if (tid < b) {
    taur[tid] = tau_r[tid];
    taui[tid] = tau_i[tid];
  }
  // forward larft of the conjugated taus: b dependent columns; T is upper
  // triangular, so row i of column j sums over l in [i, j). T[i][j] is kept
  // at the gram's (j, i), whose lower triangle the gram leaves unused.
  for (int j = 0; j < b; ++j) {
    if (tid <= j) {
      const T tr = tau_r[j], ti = -tau_i[j];
      T val_r = tr, val_i = ti;
      if (tid < j) {
        T s_r = T(0), s_i = T(0);
        for (int l = tid; l < j; ++l) {
          const T xr = gslot[2 * (l * b + tid)], xi = gslot[2 * (l * b + tid) + 1];
          const T gr = gslot[2 * (l * b + j)], gi = gslot[2 * (l * b + j) + 1];
          s_r += xr * gr - xi * gi;
          s_i += xr * gi + xi * gr;
        }
        val_r = -(tr * s_r - ti * s_i);
        val_i = -(tr * s_i + ti * s_r);
      }
      gslot[2 * (j * b + tid)] = val_r;
      gslot[2 * (j * b + tid) + 1] = val_i;
    }
    __syncthreads();
  }
  for (int p = tid; p < b * b; p += kThreads) {
    const int i = p / b, j = p % b;
    tmr[p] = i <= j ? gslot[2 * (j * b + i)] : T(0);
    tmi[p] = i <= j ? gslot[2 * (j * b + i) + 1] : T(0);
  }
}

template <typename T>
int ql_panel_planar_launch(const T* pr, const T* pi, int ldp, long long sp, int m, int b,
                           int rb, int batch, T* rr, T* ri, T* vr, T* vi, T* taur,
                           T* taui, T* tmr, T* tmi, void* stream) {
  if (b < 1 || b > kMaxB || m < b || rb < 0 || rb + b > m || ldp < b || batch < 0 ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  const Geometry geo = geometry(b, rb, (int)sizeof(T));
  auto kernel =
      geo.slab_in_smem ? ql_panel_planar_kernel<T, true> : ql_panel_planar_kernel<T, false>;
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
  err = cudaLaunchKernelEx(&cfg, kernel, pr, pi, ldp, sp, m, b, rb, geo.slab_rows, rr, ri, vr,
                           vi, taur, taui, tmr, tmi);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// batch panels, item k at pr + k sp, pi + k sp (row stride ldp); rr, ri, vr,
// vi: batch * m * b elements each (row-major, contiguous, item after item);
// taur, taui: batch * b; tmr, tmi: batch * b * b.
extern "C" int ql_panel_planar_f32_launch(
    const float* pr, const float* pi, int ldp, long long sp, int m, int b, int rb,
    int batch, float* rr, float* ri, float* vr, float* vi, float* taur, float* taui,
    float* tmr, float* tmi, void* stream) {
  return ql_panel_planar_launch<float>(pr, pi, ldp, sp, m, b, rb, batch, rr, ri, vr, vi,
                                       taur, taui, tmr, tmi, stream);
}

extern "C" int ql_panel_planar_f64_launch(
    const double* pr, const double* pi, int ldp, long long sp, int m, int b, int rb,
    int batch, double* rr, double* ri, double* vr, double* vi, double* taur, double* taui,
    double* tmr, double* tmi, void* stream) {
  return ql_panel_planar_launch<double>(pr, pi, ldp, sp, m, b, rb, batch, rr, ri, vr, vi,
                                        taur, taui, tmr, tmi, stream);
}
