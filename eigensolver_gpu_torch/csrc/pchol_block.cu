// Kernel K1: planar Cholesky of one HPD diagonal block, its inverse, and
// the first bad pivot -- one thread block per diagonal block, launched once
// per block step of the left-looking planar Cholesky
// (eigensolver_gpu_torch/ops/planar.py::pcholesky_lower). A batch of
// problems (one diagonal block each, at the same step) is one launch with a
// grid of one block per problem: the block body is the same for every
// item, so each item's outputs are those of a launch on that item alone.
//
// Replaces: eigensolver_gpu_tpu/ops/pchol_pallas.py::pchol_block_planar_pallas
// (pallas_call at :129, body _pchol_block_kernel at :43).
//
// What bounds it on the H100: latency. The block is 2 x 128 x 128 fp32 in
// and 4 x 128 x 128 out (384 KB, ~0.1 us of HBM time) and ~11 MFLOP, but
// an unblocked factor and inverse are 2 x 128 dependent column steps, each
// ending at a block barrier (about 1.5 us a step with 1024 threads).
//
// A batched launch (k-point batches: one problem a block, 220 KB of shared
// memory, so one block a SM) runs up to 132 problems at once: the batch
// pays the latency once a wave instead of once a problem.
//
// What the design does about it: blocked by 32-column block columns, so
// only the diagonal blocks' 4 x 32 column steps are dependent block-wide
// steps, with little work each; the rest is solves in registers and block
// products.
//   * Factor, right-looking, for each block column kb (nb padded to a
//     multiple of 32 with an identity border):
//       1. all threads factor the 32 x 32 diagonal block in shared memory,
//          up to three entries of its lower triangle a thread, one barrier
//          a column (on the card this beat one warp holding row i in lane i
//          and broadcasting by __shfl_sync);
//       2. one thread per row below solves that row against L_kk^H, in
//          registers, while the last warp inverts L_kk (one lane per
//          column of inv(L_kk), in registers);
//       3. all warps apply the Hermitian rank-32 downdate of the trailing
//          lower block triangle from shared memory, one 32 x 32 block
//          product per 64 threads (a 4 x 4 tile a thread).
//   * Inverse of the off-diagonal blocks by diagonals of the block
//     triangle: X_ij = -inv(L_ii) sum_{k=j}^{i-1} L_ik X_kj, level
//     d = i - j = 1, 2, 3; each level is a round of 32 x 32 block
//     products, one (i, j, k) term each, into scratch blocks, their sum,
//     and a round of products with inv(L_ii), a barrier after each.
//   * L (two 128 x 129 planes, rows padded by one float so that column
//     reads across a warp hit distinct banks), the ten lower blocks of
//     inv(L) (32 x 33 each, 83 KB) and the current diagonal block's columns
//     as rows (8 KB, read four at a time by the solves) live in dynamic
//     shared memory (220 KB).
//     The sums T_ij are kept in the unused upper blocks of L.
//   * 256 threads, so a thread may hold 255 registers: the warp-serial
//     steps keep a row (or a column) of 32 complex values in registers and
//     still have room to issue the step's broadcasts back to back.
//
// Contract (same as the Pallas kernel): fail = 1-based index of the first
// pivot that is <= 0 or NaN, 0 if none; a bad pivot is clamped to FLT_MIN
// (a NaN pivot stays NaN) and the factorization continues. Outputs are
// row-major nb x nb with the strict upper triangles zero. fp32, plain FFMA
// (no tensor cores, so no TF32). Rows of the inverse before a bad pivot
// depend only on the rows of L before it: the inverse products skip the
// structurally zero upper entries of inv(L_ii), so inf/NaN past a bad
// pivot never reaches them.

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>

namespace {

constexpr int kNbMax = 128;
constexpr int kBlk = 32;                        // block-column width
constexpr int kThreads = 256;  // up to 255 registers a thread for the warp-serial steps
constexpr int kLd = kNbMax + 1;                 // padded row stride of L
constexpr int kPlane = kNbMax * kLd;            // one plane of L
constexpr int kInvBlocks = 10;                  // lower blocks of a 4 x 4 grid
constexpr int kXLd = kBlk + 1;                  // padded row stride of an inverse block
constexpr int kXBlock = kBlk * kXLd;
constexpr int kInvPlane = kInvBlocks * kXBlock;
constexpr int kGroupThreads = 64;               // threads per 32 x 32 product
constexpr int kGroups = kThreads / kGroupThreads;
constexpr int kTile = 4;                        // a thread's 4 x 4 tile of it
constexpr int kLoads = 16;                      // global loads in flight a thread
constexpr size_t kSmemBytes = sizeof(float) * (2 * kPlane + 2 * kInvPlane + 2 * kBlk * kBlk + kBlk);

__device__ __forceinline__ int inv_block(int i, int j) { return i * (i + 1) / 2 + j; }

// One 32 x 32 output block of C (row stride ldc) accumulates
// sign * A op(B), by the 64 threads of a group: thread gt owns
// rows 4 * (gt / 8) .. + 3 and columns gt % 8 + 8 q, so a warp's loads of A
// and B each touch distinct banks. op(B)[k][c] = conj(B[c][k]) when conj_t,
// else B[k][c]. With a_lower, A is lower triangular and only its k <= row
// entries are used (a structural zero times an inf past a bad pivot would
// give NaN). If overwrite, C is set instead of accumulated.
struct BlockTerm {
  const float* ar;
  const float* ai;
  int lda;
  const float* br;
  const float* bi;
  int ldb;
};

__device__ void block_product(float* cr, float* ci, int ldc, const BlockTerm t, float sign,
                              bool conj_t, bool a_lower, bool overwrite, int gt) {
  const int c0 = gt % 8;
  const int r0 = kTile * (gt / 8);
  float accr[kTile][kTile], acci[kTile][kTile];
#pragma unroll
  for (int q = 0; q < kTile; ++q)
#pragma unroll
    for (int p = 0; p < kTile; ++p) accr[q][p] = acci[q][p] = 0.f;
  {
    const int kend = a_lower ? r0 + kTile : kBlk;
    for (int k = 0; k < kend; ++k) {
      float xr[kTile], xi[kTile], yr[kTile], yi[kTile];
#pragma unroll
      for (int q = 0; q < kTile; ++q) {
        xr[q] = t.ar[(r0 + q) * t.lda + k];
        xi[q] = t.ai[(r0 + q) * t.lda + k];
      }
#pragma unroll
      for (int p = 0; p < kTile; ++p) {
        const int c = c0 + 8 * p;
        if (conj_t) {
          yr[p] = t.br[c * t.ldb + k];
          yi[p] = -t.bi[c * t.ldb + k];
        } else {
          yr[p] = t.br[k * t.ldb + c];
          yi[p] = t.bi[k * t.ldb + c];
        }
      }
#pragma unroll
      for (int q = 0; q < kTile; ++q) {
        if (!a_lower || k <= r0 + q) {
#pragma unroll
          for (int p = 0; p < kTile; ++p) {
            accr[q][p] += xr[q] * yr[p] - xi[q] * yi[p];
            acci[q][p] += xr[q] * yi[p] + xi[q] * yr[p];
          }
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kTile; ++q) {
#pragma unroll
    for (int p = 0; p < kTile; ++p) {
      const int at = (r0 + q) * ldc + c0 + 8 * p;
      if (overwrite) {
        cr[at] = sign * accr[q][p];
        ci[at] = sign * acci[q][p];
      } else {
        cr[at] += sign * accr[q][p];
        ci[at] += sign * acci[q][p];
      }
    }
  }
}

// All threads: factor the diagonal block at (c0, c0) of L in place. Thread
// t owns the entries t, t + kThreads, ... of the block's lower triangle (528
// entries). One barrier a column step: in step j every thread scales the
// two column-j entries it needs itself (l = a * (1 / d_j), the same product
// wherever it is taken) and downdates its entries right of column j; the
// owners write the scaled column j in step j + 1, when nobody reads it.
// Returns the updated fail (1-based, first bad pivot below nb), the same in
// every thread.
__device__ int factor_diag_block(float* Lr, float* Li, int c0, int nb, int fail, int t) {
  constexpr int kTri = kBlk * (kBlk + 1) / 2;
  constexpr int kOwn = (kTri + kThreads - 1) / kThreads;
  int ei[kOwn], ek[kOwn];  // the entries' row and column; -1 for none
#pragma unroll
  for (int s = 0; s < kOwn; ++s) {
    const int e = t + s * kThreads;
    int i = (int)((sqrtf(8.f * e + 1.f) - 1.f) * 0.5f);
    while (i * (i + 1) / 2 > e) --i;
    while ((i + 1) * (i + 2) / 2 <= e) ++i;
    ei[s] = e < kTri ? i : -1;
    ek[s] = e < kTri ? e - i * (i + 1) / 2 : -1;
  }
  float* Dr = Lr + c0 * kLd + c0;
  float* Di = Li + c0 * kLd + c0;
  float pend_r[kOwn], pend_i[kOwn];  // scaled column entries, written a step later
  float dj_prev = 0.f;
  for (int j = 0; j < kBlk; ++j) {
    const float pivot = Dr[j * kLd + j];
    if (fail == 0 && c0 + j < nb && !(pivot > 0.0f)) fail = c0 + j + 1;  // <= 0 or NaN
    // 1 / d_j by the hardware reciprocal square root (within 2 ulp): an IEEE
    // square root and division in this dependent chain cost more than the
    // barrier; d_j itself is pivot / sqrt(pivot)
    const float clamped = isnan(pivot) ? pivot : fmaxf(pivot, FLT_MIN);
    const float rdj = rsqrtf(clamped);
    const float dj = clamped * rdj;
#pragma unroll
    for (int s = 0; s < kOwn; ++s) {
      if (j > 0 && ek[s] == j - 1 && ei[s] > j - 1) {
        Dr[ei[s] * kLd + j - 1] = pend_r[s];
        Di[ei[s] * kLd + j - 1] = pend_i[s];
      }
    }
    if (t == 0 && j > 0) {
      Dr[(j - 1) * kLd + j - 1] = dj_prev;
      Di[(j - 1) * kLd + j - 1] = 0.f;
    }
#pragma unroll
    for (int s = 0; s < kOwn; ++s) {
      const int i = ei[s], k = ek[s];
      if (k == j && i > j) {
        pend_r[s] = Dr[i * kLd + j] * rdj;
        pend_i[s] = Di[i * kLd + j] * rdj;
      }
      if (k > j) {  // A[i, k] -= l[i] * conj(l[k])
        const float pr = Dr[i * kLd + j] * rdj, pi = Di[i * kLd + j] * rdj;
        const float qr = Dr[k * kLd + j] * rdj, qi = Di[k * kLd + j] * rdj;
        Dr[i * kLd + k] -= pr * qr + pi * qi;
        Di[i * kLd + k] -= pi * qr - pr * qi;
      }
    }
    dj_prev = dj;
    __syncthreads();
  }
  if (t == 0) {
    Dr[(kBlk - 1) * kLd + kBlk - 1] = dj_prev;
    Di[(kBlk - 1) * kLd + kBlk - 1] = 0.f;
  }
  for (int idx = t; idx < kBlk * kBlk; idx += kThreads) {
    const int i = idx / kBlk, k = idx % kBlk;
    if (k > i) {
      Dr[i * kLd + k] = 0.f;
      Di[i * kLd + k] = 0.f;
    }
  }
  return fail;
}

// The columns of the factored diagonal block, as rows: Tr[j * 32 + m] =
// L_kk[m][j] (0 above the diagonal), so a step of the solves below reads
// column j four entries to a (broadcast) load; rd[j] = 1 / L_kk[j][j].
__device__ void transpose_diag_block(const float* Lr, const float* Li, int c0, float* Tr,
                                     float* Ti, float* rd, int t) {
  for (int idx = t; idx < kBlk * kBlk; idx += kThreads) {
    const int j = idx / kBlk, m = idx % kBlk;
    Tr[idx] = Lr[(c0 + m) * kLd + c0 + j];
    Ti[idx] = Li[(c0 + m) * kLd + c0 + j];
  }
  if (t < kBlk) rd[t] = 1.0f / Lr[(c0 + t) * kLd + c0 + t];
}

// One thread: row r (below the diagonal block) of the panel solved against
// L_kk^H, in place: x_j = (a_j - sum_{m<j} x_m conj(L_jm)) / L_jj.
__device__ void solve_row(float* Lr, float* Li, const float* Tr, const float* Ti,
                          const float* rdiag, int c0, int r) {
  float xr[kBlk], xi[kBlk];
#pragma unroll
  for (int k = 0; k < kBlk; ++k) {
    xr[k] = Lr[r * kLd + c0 + k];
    xi[k] = Li[r * kLd + c0 + k];
  }
#pragma unroll
  for (int j = 0; j < kBlk; ++j) {
    xr[j] *= rdiag[j];
    xi[j] *= rdiag[j];
#pragma unroll
    for (int q = (j + 1) / 4; q < kBlk / 4; ++q) {
      const float4 lr = reinterpret_cast<const float4*>(Tr + j * kBlk)[q];
      const float4 li = reinterpret_cast<const float4*>(Ti + j * kBlk)[q];
      const float l4r[4] = {lr.x, lr.y, lr.z, lr.w}, l4i[4] = {li.x, li.y, li.z, li.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int m = 4 * q + u;
        if (m > j) {
          xr[m] -= xr[j] * l4r[u] + xi[j] * l4i[u];
          xi[m] -= xi[j] * l4r[u] - xr[j] * l4i[u];
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kBlk; ++k) {
    Lr[r * kLd + c0 + k] = xr[k];
    Li[r * kLd + c0 + k] = xi[k];
  }
}

// One warp: column `lane` of inv(L_kk) by forward substitution on the
// identity in downdate form, written to the inverse block (kb, kb).
__device__ void invert_diag_block(const float* Tr, const float* Ti, const float* rdiag,
                                  float* xr_out, float* xi_out, int lane) {
  float xr[kBlk], xi[kBlk];
#pragma unroll
  for (int r = 0; r < kBlk; ++r) {
    xr[r] = r == lane ? 1.f : 0.f;
    xi[r] = 0.f;
  }
#pragma unroll
  for (int r = 0; r < kBlk; ++r) {
    xr[r] *= rdiag[r];
    xi[r] *= rdiag[r];
#pragma unroll
    for (int q = (r + 1) / 4; q < kBlk / 4; ++q) {
      const float4 lr = reinterpret_cast<const float4*>(Tr + r * kBlk)[q];
      const float4 li = reinterpret_cast<const float4*>(Ti + r * kBlk)[q];
      const float l4r[4] = {lr.x, lr.y, lr.z, lr.w}, l4i[4] = {li.x, li.y, li.z, li.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = 4 * q + u;
        if (k > r) {
          xr[k] -= l4r[u] * xr[r] - l4i[u] * xi[r];
          xi[k] -= l4r[u] * xi[r] + l4i[u] * xr[r];
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kBlk; ++r) {
    xr_out[r * kXLd + lane] = xr[r];
    xi_out[r * kXLd + lane] = xi[r];
  }
}

__global__ void __launch_bounds__(kThreads, 1)
pchol_block_kernel(const float* __restrict__ ar, const float* __restrict__ ai,
                   int lda, long long sa, int nb, float* __restrict__ ldr,
                   float* __restrict__ ldi, float* __restrict__ invr,
                   float* __restrict__ invi, long long so, int* __restrict__ fail_out) {
  extern __shared__ float smem[];
  // this block's problem: input planes at item * sa, outputs at item * so
  const long long item = blockIdx.x;
  ar += item * sa;
  ai += item * sa;
  ldr += item * so;
  ldi += item * so;
  invr += item * so;
  invi += item * so;
  fail_out += item;
  float* Lr = smem;
  float* Li = Lr + kPlane;
  float* Xr = Li + kPlane;  // lower blocks of inv(L), 32 x 32 each
  float* Xi = Xr + kInvPlane;
  float* Tr = Xi + kInvPlane;  // the diagonal block's columns as rows
  float* Ti = Tr + kBlk * kBlk;
  float* rdiag = Ti + kBlk * kBlk;  // its reciprocal diagonal

  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;
  const int nblk = (nb + kBlk - 1) / kBlk;
  const int np = nblk * kBlk;  // padded with an identity border

  // the block, kLoads global loads in flight a thread
  for (int base = t; base < np * np; base += kLoads * kThreads) {
    float vr[kLoads], vi[kLoads];
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int idx = base + q * kThreads, r = idx / np, c = idx % np;
      vr[q] = r == c ? 1.f : 0.f;
      vi[q] = 0.f;
      if (idx < np * np && r < nb && c < nb) {
        vr[q] = ar[(size_t)r * lda + c];
        vi[q] = ai[(size_t)r * lda + c];
      }
    }
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int idx = base + q * kThreads;
      if (idx < np * np) {
        Lr[(idx / np) * kLd + idx % np] = vr[q];
        Li[(idx / np) * kLd + idx % np] = vi[q];
      }
    }
  }
  __syncthreads();

  // ---- factor, right-looking by block columns ----
  int fail = 0;
  for (int kb = 0; kb < nblk; ++kb) {
    const int c0 = kb * kBlk;
    fail = factor_diag_block(Lr, Li, c0, nb, fail, t);
    __syncthreads();
    transpose_diag_block(Lr, Li, c0, Tr, Ti, rdiag, t);
    __syncthreads();
    const int below = np - c0 - kBlk;
    if (t < below) solve_row(Lr, Li, Tr, Ti, rdiag, c0, c0 + kBlk + t);
    if (warp == kThreads / 32 - 1) {
      const int blk = inv_block(kb, kb) * kXBlock;
      invert_diag_block(Tr, Ti, rdiag, Xr + blk, Xi + blk, lane);
    }
    __syncthreads();
    // trailing downdate A_ij -= X_ik X_jk^H for kb < j <= i < nblk
    const int rest = nblk - kb - 1;
    const int tasks = rest * (rest + 1) / 2;
    const int g = t / kGroupThreads, gt = t % kGroupThreads;
    for (int task = g; task < tasks; task += kGroups) {
      int i = 0, rem = task;
      while (rem > i) rem -= ++i;  // task -> (i, j) with j <= i
      const int bi = kb + 1 + i, bj = kb + 1 + rem;
      const BlockTerm term{Lr + bi * kBlk * kLd + c0, Li + bi * kBlk * kLd + c0, kLd,
                           Lr + bj * kBlk * kLd + c0, Li + bj * kBlk * kLd + c0, kLd};
      block_product(Lr + bi * kBlk * kLd + bj * kBlk, Li + bi * kBlk * kLd + bj * kBlk, kLd,
                    term, -1.f, true, false, false, gt);
    }
    __syncthreads();
  }
  if (t == 0) *fail_out = fail;

  // ---- inverse of the off-diagonal blocks, by diagonals ----
  auto block_at = [](int r, int c) { return r * kBlk * kLd + c * kBlk; };  // block (r, c) of L
  for (int d = 1; d < nblk; ++d) {
    const int tasks = nblk - d;
    const int g = t / kGroupThreads, gt = t % kGroupThreads;
    // T_ij = sum_{k=j}^{i-1} L_ik X_kj, kept in block (j, i) of L's upper
    // part. Each (task, term) product is one group's work: the first term
    // goes to T_ij, the others to the free upper blocks (s, s + 1), which
    // are then added to T_ij in a fixed order.
    for (int p = g; p < tasks * d; p += kGroups) {
      const int ti = p / d, tt = p % d, i = d + ti, j = ti, k = j + tt;
      const int s_blk = ti * (d - 1) + tt - 1;
      const int out = tt == 0 ? block_at(j, i) : block_at(s_blk, s_blk + 1);
      const int xb = inv_block(k, j) * kXBlock;
      const BlockTerm term{Lr + block_at(i, k), Li + block_at(i, k), kLd, Xr + xb, Xi + xb, kXLd};
      block_product(Lr + out, Li + out, kLd, term, 1.f, false, false, true, gt);
    }
    __syncthreads();
    if (d > 1) {
      for (int idx = t; idx < tasks * kBlk * kBlk; idx += kThreads) {
        const int ti = idx / (kBlk * kBlk), r = idx / kBlk % kBlk, c = idx % kBlk;
        const int at = block_at(ti, d + ti) + r * kLd + c;
        for (int tt = 1; tt < d; ++tt) {
          const int from = block_at(ti * (d - 1) + tt - 1, ti * (d - 1) + tt) + r * kLd + c;
          Lr[at] += Lr[from];
          Li[at] += Li[from];
        }
      }
      __syncthreads();
    }
    // X_ij = -inv(L_ii) T_ij
    for (int task = g; task < tasks; task += kGroups) {
      const int i = d + task, j = task;
      const int xd = inv_block(i, i) * kXBlock, xo = inv_block(i, j) * kXBlock;
      const BlockTerm term{Xr + xd, Xi + xd, kXLd, Lr + block_at(j, i), Li + block_at(j, i), kLd};
      block_product(Xr + xo, Xi + xo, kXLd, term, -1.f, false, true, true, gt);
    }
    __syncthreads();
  }

  for (int idx = t; idx < nb * nb; idx += kThreads) {
    const int r = idx / nb, c = idx % nb;
    const bool low = c <= r;
    ldr[idx] = low ? Lr[r * kLd + c] : 0.0f;
    ldi[idx] = low ? Li[r * kLd + c] : 0.0f;
    const int at = inv_block(r / kBlk, low ? c / kBlk : 0) * kXBlock + (r % kBlk) * kXLd +
                   c % kBlk;
    invr[idx] = low ? Xr[at] : 0.0f;
    invi[idx] = low ? Xi[at] : 0.0f;
  }
}

}  // namespace

// Launch on `stream` for `batch` problems (grid = batch, one block each;
// a batch over the 132 SMs runs in waves). nb <= 128; a, out row-major (lda
// for the input); item b's input planes start at ar + b * sa, ai + b * sa,
// its four outputs at ldr + b * so, ..., its fail at fail[b]. Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int pchol_block_planar_launch(const float* ar, const float* ai,
                                         int lda, long long sa, int nb, int batch,
                                         float* ldr, float* ldi, float* invr, float* invi,
                                         long long so, int* fail, void* stream) {
  if (nb < 1 || nb > kNbMax || batch < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      pchol_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  pchol_block_kernel<<<batch, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      ar, ai, lda, sa, nb, ldr, ldi, invr, invi, so, fail);
  return (int)cudaGetLastError();
}
