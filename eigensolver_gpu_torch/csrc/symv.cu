// Kernels K4 and K3: symmetric / planar Hermitian matrix-vector product
// that reads only the upper tiles of a full-stored matrix -- the hot
// `A v` of every tridiagonalization panel column
// (eigensolver_gpu_torch/ops/sytrd.py::_panel_columns and
// ops/sytrd_planar.py::_panel_columns_planar, use_pallas=True).
//
// Replaces:
//   K4  eigensolver_gpu_tpu/ops/symv_pallas.py::symv
//       (pallas_call at :117, body _symv_kernel at :58);
//   K3  eigensolver_gpu_tpu/ops/hemv_pallas.py::hemv_planar
//       (pallas_call at :100, body _hemv_kernel at :39).
//
// What they compute: y = A v for symmetric A (K4), and
// (yr, yi) = (Ar + i Ai)(vr + i vi) for Ar symmetric, Ai antisymmetric
// (K3). Every off-diagonal upper tile T = A[bi, bj] (bi < bj) is read once
// and used twice: T v[bj] goes to y[bi] (its row product), and T^H v[bi]
// to y[bj] (its column product); a diagonal tile gives its column product
// T^H v[bj] = T v[bj] only. For the planar pair, with Tr, Ti the tiles of
// Ar, Ai:
//     y[bi] += (Tr vr_j - Ti vi_j,   Tr vi_j + Ti vr_j)
//     y[bj] += (Tr^T vr_i + Ti^T vi_i,   Tr^T vi_i - Ti^T vr_i)
//
// What bounds them on the H100: bytes. The upper tiles of n = 4096 are
// 33.6 MB in fp32 (K3's two planes and K4 in fp64: 67.1 MB) at 2 flop per
// byte read, far below the fp32 rate. K4's fp32 triangle fits in the 50 MB
// L2 up to n of about 5000, so a caller that repeats the product on one
// block (the 32 columns of a sytrd panel) finds it warm and can run faster
// than bytes / 3.35 TB/s; K3's two planes at n = 4096 never fit. Past the
// bytes, a call pays its launch, the ramp of the first copies and the
// latency of the final sums: at the solve's small extents those are most
// of it.
//
// Design: one cooperative launch a call, no float atomics.
//   * The upper tiles (64 x 64) are numbered column strip by column strip:
//     tile (i, j), i <= j, is t = j (j + 1) / 2 + i. The grid is one wave:
//     min(tiles, resident blocks) blocks, block b taking the consecutive
//     tiles from b * tiles / blocks (integer division), so every SM gets
//     the same number of blocks and they differ by at most one tile: 7 or 8
//     tiles a block at n = 4096 (264 blocks, 2 a SM), one at the small
//     extents (10 blocks at n = 256).
//   * A block walks its tiles down each column strip and keeps the column
//     products of that strip (all into y[bj]) in registers over the run; a
//     run ends at the strip's diagonal tile or at the block's last tile and
//     writes one 64-vector of column partials. Each off-diagonal tile writes
//     its row product, one 64-vector, at once. Every partial slot (row: the
//     tile; column: the run's last tile) is written by exactly one block.
//   * Tiles are staged through a ring of 96 KB of shared memory a block (6
//     stages of 16 KB for K4 fp32; 3 of 32 KB for K4 fp64 and for K3, which
//     carries both planes in one stage), filled by cp.async: 16-byte copies
//     when the rows are 16-byte aligned (the matrix pointer and lda *
//     element size), element copies otherwise (a contiguous n = 999
//     matrix), zero-filled past n. All other stages are in flight while one
//     is multiplied: 160 KB a SM for K4 fp32, 128 KB for fp64 and K3.
//   * Each of the 256 threads holds a 4 x 4 patch of the tile: its row sums
//     are added over the 16 threads of a tile row by warp shuffles in a
//     fixed pattern; its column sums stay in registers for the run and are
//     added over the 16 row groups in shared memory in row-group order.
//   * Ordering: a grid barrier (cooperative groups) follows the streaming;
//     then every output row is summed from its strip's partials in a fixed
//     order -- the runs of its column strip by tile, then the row partials
//     of tiles (k, j) by j -- by 8 threads over consecutive slices, the
//     slices added in order; the rows are spread over all blocks. So the
//     bits are the same from call to call on a given card (the split
//     follows its SM count). Partial traffic: about tiles + blocks
//     64-vectors written and read (2 350 at n = 4096, 0.6 MB in fp32: 1.8 %
//     of the triangle).
//   A per-strip int32 arrival counter, with the block that completes a
//   strip summing it, was built and timed first: the last blocks to stream
//   completed up to 9 strips each and summed them one after another, which
//   cost more than the barrier (PERF.md, Findings).
//   The launch fails (cudaErrorCooperativeLaunchTooLarge) when the blocks
//   cannot all be resident; the grid never asks for more than the occupancy
//   calculator allows.
//   A batch of problems (one n, one extent) is still one cooperative launch.
//   Each item keeps the split of its unbatched launch: min(tiles, resident
//   blocks of the unbatched kernel) *virtual* blocks, taking their tiles by
//   the same integer rule, so its partials, and the fixed-order sums over
//   them, are the unbatched bits. The one-wave grid walks the (item,
//   virtual block) pairs, grid-strided; each item has its own slice of the
//   partial scratch, and after the one grid barrier the final sums run over
//   (item, row slice). The batched walk is a kernel instance of its own
//   (kBatched): in the unbatched one the item is the constant 0, which keeps
//   its registers and time those of the kernel before the batch axis (the
//   item's offsets held in one instance for both made the unbatched K4 and
//   K3 slower, K3 with a stack frame).
//
// C entries (a: row-major views, unit column stride, row stride lda >= n,
// item k at a + k * sa; v: item k at v + k * sv; `part`: a scratch of
// batch * symv_part_elems(n, planes) elements of the matrix's type; y:
// batch x planes x n; all on the card, launched on `stream`; a launch
// returns a cudaError_t code):
//   symv_f32_launch(a, lda, sa, n, v, sv, part, y, batch, stream)      K4 fp32
//   symv_f64_launch(a, lda, sa, n, v, sv, part, y, batch, stream)      K4 fp64
//   hemv_planar_launch(ar, ai, lda, sa, n, vr, vi, sv, part, y, batch, stream)
//                      K3 fp32, an item's y = (yr, yi) as 2 x n
//   symv_part_elems(n, planes)           the scratch of one item
// Plain FMA arithmetic, no tensor cores.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr int kTx = 16;              // threads across a tile row, 4 columns each
constexpr int kTy = kThreads / kTx;  // row groups of 4 rows
constexpr int kTileElems = kTile * kTile;
constexpr int kMaxDevices = 64;

// P planes of the matrix and of v (1: real, 2: planar complex)
template <typename T, int P>
struct Cfg {
  static constexpr int kStages = 24 / (P * sizeof(T));  // 96 KB of tiles
  // one stage: P tile planes, then P planes of v over the tile's rows (vi)
  // and P over its columns (vj)
  static constexpr int kStageElems = P * kTileElems + 2 * P * kTile;
  static constexpr int kRedElems = P * kTy * kTile;  // >= kThreads
  static constexpr int kSmemBytes = (kStages * kStageElems + kRedElems) * sizeof(T);
};

template <typename T, int P>
struct Args {
  const T* a[P];
  const T* v[P];
  T* part;     // an item: row partials [P][tiles][64], then column partials [P][tiles][64]
  T* y;        // an item: P planes of n
  long long sa, sv, sp;  // batch strides of a, v and part (y: P n)
  unsigned tiles, blocks;  // upper tiles; virtual blocks of an item
  int lda, n, nt, batch;
  bool wide;   // 16-byte aligned rows: 16-byte copies
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes, of which the first `bytes` are read and the rest zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// one element of N bytes, read when `bytes` is N and zero-filled when 0
template <int N>
__device__ __forceinline__ void cp_async_elem(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)),
               "l"(src), "n"(N), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ long long strip_start(int j) { return (long long)j * (j + 1) / 2; }

// the tile (i, j) numbered t
__device__ __forceinline__ void tile_of(long long t, int& i, int& j) {
  int jj = (int)((sqrt(8.0 * (double)t + 1.0) - 1.0) * 0.5);
  while (strip_start(jj) > t) --jj;
  while (strip_start(jj + 1) <= t) ++jj;
  j = jj;
  i = (int)(t - strip_start(jj));
}

// Block b takes tiles [block_first(b), block_first(b + 1)): the tiles are
// shared out as evenly as integers allow (tiles * blocks < 2^32).
__device__ __forceinline__ unsigned block_first(unsigned b, unsigned tiles, unsigned blocks) {
  return b * tiles / blocks;
}

__device__ __forceinline__ unsigned block_of(unsigned t, unsigned tiles, unsigned blocks) {
  return ((t + 1) * blocks - 1) / tiles;
}

// Stage tile (bi, bj) of problem `item` and the vector slices it needs; zero
// past n.
// (The item's pointers are formed here from the kernel parameters: a copy
// of them held over the tile loop cost K3 a stack frame.)
template <typename T, int P>
__device__ __forceinline__ void issue_tile(const Args<T, P>& g, int item, T* stage, int bi,
                                           int bj) {
  const int r0 = bi * kTile, c0 = bj * kTile;
  const size_t lda = (size_t)g.lda, oa = (size_t)item * g.sa;
  if (g.wide) {
    constexpr int kVec = 16 / sizeof(T);
    constexpr int kChunks = kTile / kVec;  // a tile row
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int u = 0; u < kTile * kChunks / kThreads; ++u) {
        const int c = threadIdx.x + u * kThreads;
        const int row = c / kChunks, col = (c % kChunks) * kVec;
        const int gr = r0 + row, gc = c0 + col;
        const int valid = gr < g.n ? min(max(g.n - gc, 0), kVec) : 0;
        const T* src = g.a[p] + oa + (valid ? gr * lda + gc : 0);
        cp_async16(stage + p * kTileElems + row * kTile + col, src, valid * (int)sizeof(T));
      }
    }
  } else {
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll 4
      for (int u = 0; u < kTileElems / kThreads; ++u) {
        const int e = threadIdx.x + u * kThreads;
        const int row = e / kTile, col = e % kTile;
        const int gr = r0 + row, gc = c0 + col;
        const bool in = gr < g.n && gc < g.n;
        cp_async_elem<sizeof(T)>(stage + p * kTileElems + e,
                                 g.a[p] + oa + (in ? gr * lda + gc : 0), in ? (int)sizeof(T) : 0);
      }
    }
  }
  if (threadIdx.x < 2 * P * kTile) {  // vi planes, then vj planes
    const int w = threadIdx.x / kTile, k = threadIdx.x % kTile;
    const int gi = (w < P ? r0 : c0) + k;
    const T* base = g.v[w % P] + (size_t)item * g.sv;
    cp_async_elem<sizeof(T)>(stage + P * kTileElems + threadIdx.x, gi < g.n ? base + gi : base,
                             gi < g.n ? (int)sizeof(T) : 0);
  }
}

// column q (0..3) of thread tx's patch: one 16-byte chunk of 4 floats, or
// two of 2 doubles half a row apart (conflict-free 16-byte shared loads)
template <typename T>
__device__ __forceinline__ int patch_col(int tx, int q) {
  constexpr int kV = sizeof(T) == 4 ? 4 : 2;
  return (q / kV) * (kTx * kV) + tx * kV + q % kV;
}

template <typename T>
__device__ __forceinline__ void load_patch_row(const T* row, int tx, T x[4]) {
  if constexpr (sizeof(T) == 4) {
    const float4 f = *reinterpret_cast<const float4*>(row + 4 * tx);
    x[0] = f.x, x[1] = f.y, x[2] = f.z, x[3] = f.w;
  } else {
    const double2 lo = *reinterpret_cast<const double2*>(row + 2 * tx);
    const double2 hi = *reinterpret_cast<const double2*>(row + kTx * 2 + 2 * tx);
    x[0] = lo.x, x[1] = lo.y, x[2] = hi.x, x[3] = hi.y;
  }
}

// s[r]: this thread's sums of rows 4 ty + r over its 4 columns. Returns the
// sum over the 16 threads of the tile row group (lanes differing in bits
// 0-3) of row 4 ty + 2 * bit3(tx) + bit2(tx), in a fixed pattern.
template <typename T>
__device__ __forceinline__ T reduce_rows(const T s[4], int tx) {
  const bool hi = tx & 8;
  T k0 = hi ? s[2] : s[0], k1 = hi ? s[3] : s[1];
  k0 += __shfl_xor_sync(0xffffffffu, hi ? s[0] : s[2], 8);
  k1 += __shfl_xor_sync(0xffffffffu, hi ? s[1] : s[3], 8);
  const bool b2 = tx & 4;
  T k = b2 ? k1 : k0;
  k += __shfl_xor_sync(0xffffffffu, b2 ? k0 : k1, 4);
  k += __shfl_xor_sync(0xffffffffu, k, 2);
  k += __shfl_xor_sync(0xffffffffu, k, 1);
  return k;
}

// The products of one staged tile: row sums s (rows 4 ty + r) over this
// thread's columns, and column sums over its rows added into acc.
template <typename T, int P>
__device__ __forceinline__ void tile_products(const T* stage, int tx, int ty, T s[P][4],
                                              T acc[P][4]) {
  const T* vi = stage + P * kTileElems;
  const T* vj = vi + P * kTile;
  T xi[P][4], xj[P][4];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      xi[p][q] = vi[p * kTile + 4 * ty + q];
      xj[p][q] = vj[p * kTile + patch_col<T>(tx, q)];
      s[p][q] = T(0);
    }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    T x[P][4];
#pragma unroll
    for (int p = 0; p < P; ++p)
      load_patch_row(stage + p * kTileElems + (4 * ty + r) * kTile, tx, x[p]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if constexpr (P == 1) {
        s[0][r] += x[0][q] * xj[0][q];
        acc[0][q] += x[0][q] * xi[0][r];
      } else {  // (Tr + i Ti) v_j and (Tr^T - i Ti^T) v_i
        const T tr = x[0][q], ti = x[1][q];
        s[0][r] += tr * xj[0][q] - ti * xj[1][q];
        s[1][r] += tr * xj[1][q] + ti * xj[0][q];
        acc[0][q] += tr * xi[0][r] + ti * xi[1][r];
        acc[1][q] += tr * xi[1][r] - ti * xi[0][r];
      }
    }
  }
}

// y from the partials, after the grid barrier. Output strip k has
// runs + nt - 1 - k partials in a fixed order: the column partials of the runs
// of column strip k (at each run's last tile), then the row partials of
// tiles (k, j), j = k + 1 .. nt - 1. A block takes work items of 32 rows of
// one plane of one strip of one problem (grid-strided over the blocks);
// each row is summed by 8 threads over consecutive slices of the partials
// (loads asked for kBatch at a time, added in slot order), the slices then
// added in order.
template <typename T, int P, bool kBatched>
__device__ void finish(const Args<T, P>& g, T* red) {
  constexpr int kRows = 32, kGroups = kThreads / kRows, kBatch = 16;
  const int t = threadIdx.x, grp = t / kRows;
  const int per = g.nt * P * (kTile / kRows), items = kBatched ? per * g.batch : per;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int b = kBatched ? item / per : 0, w = kBatched ? item % per : item;
    const T* part = g.part + b * g.sp;
    const int k = w / (P * 2), p = w / 2 % P, r = w % 2 * kRows + t % kRows;
    const unsigned s = (unsigned)strip_start(k), b0 = block_of(s, g.tiles, g.blocks);
    const int runs = (int)(block_of(s + k, g.tiles, g.blocks) - b0) + 1, m = runs + g.nt - 1 - k;
    const int q1 = (grp + 1) * m / kGroups;
    T sum = T(0);
    for (int q0 = grp * m / kGroups; q0 < q1; q0 += kBatch) {
      T x[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int q = q0 + u;
        const size_t slot =
            q < runs ? (size_t)(P + p) * g.tiles +
                           min(block_first(b0 + q + 1, g.tiles, g.blocks) - 1, s + k)
                     : (size_t)p * g.tiles + strip_start(k + 1 + q - runs) + k;
        x[u] = q < q1 ? __ldcg(part + slot * kTile + r) : T(0);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) sum += x[u];
    }
    red[t] = sum;
    __syncthreads();
    if (t < kRows) {
      T total = red[t];
#pragma unroll
      for (int h = 1; h < kGroups; ++h) total += red[h * kRows + t];
      const int row = k * kTile + r;
      if (row < g.n) g.y[((size_t)b * P + p) * g.n + row] = total;
    }
    __syncthreads();
  }
}

// The tiles of virtual block vb of item k: partials into the item's part.
template <typename T, int P>
__device__ __forceinline__ void stream_tiles(const Args<T, P>& g, int item, unsigned vb) {
  using C = Cfg<T, P>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  T* red = smem + C::kStages * C::kStageElems;

  const int t = threadIdx.x, tx = t % kTx, ty = t / kTx;
  const unsigned first = block_first(vb, g.tiles, g.blocks);
  const int cnt = (int)(block_first(vb + 1, g.tiles, g.blocks) - first);
  int ci, cj;  // the tile being multiplied
  tile_of(first, ci, cj);
  int li = ci, lj = cj;  // the next tile to stage
#pragma unroll
  for (int s = 0; s < C::kStages - 1; ++s) {
    if (s < cnt) {
      issue_tile(g, item, smem + s * C::kStageElems, li, lj);
      if (++li > lj) ++lj, li = 0;
    }
    cp_async_commit();
  }

  T acc[P][4];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = T(0);

  for (int k = 0; k < cnt; ++k) {
    cp_async_wait<C::kStages - 2>();
    __syncthreads();
    if (k + C::kStages - 1 < cnt) {
      issue_tile(g, item, smem + ((k + C::kStages - 1) % C::kStages) * C::kStageElems, li, lj);
      if (++li > lj) ++lj, li = 0;
    }
    cp_async_commit();
    T s[P][4];
    tile_products<T, P>(smem + (k % C::kStages) * C::kStageElems, tx, ty, s, acc);
    const unsigned tile = first + k;
    if (ci != cj) {  // the row product into strip ci
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const T row_sum = reduce_rows(s[p], tx);
        if ((tx & 3) == 0)
          g.part[item * g.sp + ((size_t)p * g.tiles + tile) * kTile + 4 * ty + 2 * ((tx >> 3) & 1) +
                 ((tx >> 2) & 1)] = row_sum;
      }
    }
    if (ci == cj || k == cnt - 1) {  // the run ends: its column partial into strip cj
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          red[(p * kTy + ty) * kTile + patch_col<T>(tx, q)] = acc[p][q];
          acc[p][q] = T(0);
        }
      __syncthreads();
      if (t < P * kTile) {
        const int p = t / kTile, c = t % kTile;
        T sum = red[p * kTy * kTile + c];
#pragma unroll
        for (int h = 1; h < kTy; ++h) sum += red[(p * kTy + h) * kTile + c];
        g.part[item * g.sp + (((size_t)P + p) * g.tiles + tile) * kTile + c] = sum;
      }
    }
    if (++ci > cj) ++cj, ci = 0;
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring and red are free for the next pair
}

// A batched launch walks the (item, virtual block) pairs; an unbatched one
// (its own kernel instance: item 0 is a constant there, so it pays nothing
// for the batch axis) has one pair a block.
template <typename T, int P, bool kBatched>
__device__ __forceinline__ void upper_tiles(const Args<T, P>& g) {
  using C = Cfg<T, P>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* red = reinterpret_cast<T*>(smem_raw) + C::kStages * C::kStageElems;
  if constexpr (kBatched) {
    const unsigned pairs = g.blocks * (unsigned)g.batch;
    for (unsigned q = blockIdx.x; q < pairs; q += gridDim.x)
      stream_tiles(g, (int)(q / g.blocks), q % g.blocks);
  } else {
    stream_tiles(g, 0, blockIdx.x);
  }

  // every partial is written before any is summed
  cg::this_grid().sync();
  finish<T, P, kBatched>(g, red);
}

template <typename T, bool kBatched>
__global__ void __launch_bounds__(kThreads) symv_kernel(const __grid_constant__ Args<T, 1> g) {
  upper_tiles<T, 1, kBatched>(g);
}

template <bool kBatched>
__global__ void __launch_bounds__(kThreads)
    hemv_planar_kernel(const __grid_constant__ Args<float, 2> g) {
  upper_tiles<float, 2, kBatched>(g);
}

// Resident blocks of `kern` on the card (cached a device in `slots`).
template <typename T, int P>
cudaError_t resident(void (*kern)(const Args<T, P>), int dev, int* slots) {
  using C = Cfg<T, P>;
  if (slots[dev] != 0) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, C::kSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm * sms < 1) return cudaErrorLaunchOutOfResources;
  slots[dev] = per_sm * sms;
  return cudaSuccess;
}

// An item's virtual blocks follow the unbatched kernel's residency, so a
// batched item splits its tiles as its unbatched launch does; the batched
// grid is its own kernel's one wave.
template <typename T, int P>
int launch(void (*single)(const Args<T, P>), void (*batched)(const Args<T, P>), Args<T, P> g,
           void* stream) {
  using C = Cfg<T, P>;
  if (g.n < 1 || g.lda < g.n || g.batch < 1) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  static int slots[2][kMaxDevices] = {};  // resident blocks: unbatched, batched kernel
  err = resident(single, dev, slots[0]);
  if (err == cudaSuccess && g.batch > 1) err = resident(batched, dev, slots[1]);
  if (err != cudaSuccess) return (int)err;
  const unsigned wave = slots[g.batch > 1][dev];
  g.nt = (g.n + kTile - 1) / kTile;
  const unsigned long long tiles = (unsigned long long)g.nt * (g.nt + 1) / 2;
  const unsigned long long blocks = tiles < (unsigned)slots[0][dev] ? tiles : slots[0][dev];
  if (tiles * blocks >= (1ULL << 32)) return (int)cudaErrorInvalidValue;  // n past 300 000
  const unsigned long long pairs = blocks * (unsigned long long)g.batch;
  if (pairs >= (1ULL << 32)) return (int)cudaErrorInvalidValue;
  g.tiles = (unsigned)tiles, g.blocks = (unsigned)blocks;
  g.sp = 2LL * P * (long long)tiles * kTile;  // symv_part_elems
  g.wide = (size_t)g.lda * sizeof(T) % 16 == 0 && (size_t)g.sa * sizeof(T) % 16 == 0;
  for (int p = 0; p < P; ++p) g.wide = g.wide && reinterpret_cast<uintptr_t>(g.a[p]) % 16 == 0;
  const unsigned grid = pairs < wave ? (unsigned)pairs : wave;
  void* args[] = {&g};
  err = cudaLaunchCooperativeKernel((const void*)(g.batch > 1 ? batched : single), dim3(grid),
                                    dim3(kThreads), args, C::kSmemBytes, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// elements of one item's scratch `part` for order n with `planes` planes (1 or 2)
extern "C" long long symv_part_elems(int n, int planes) {
  const long long nt = (n + kTile - 1) / kTile;
  return 2LL * planes * (nt * (nt + 1) / 2) * kTile;
}

extern "C" int symv_f32_launch(const float* a, int lda, long long sa, int n, const float* v,
                               long long sv, float* part, float* y, int batch, void* stream) {
  Args<float, 1> g{};
  g.a[0] = a, g.v[0] = v, g.part = part, g.y = y, g.lda = lda, g.n = n;
  g.sa = sa, g.sv = sv, g.batch = batch;
  return launch(symv_kernel<float, false>, symv_kernel<float, true>, g, stream);
}

extern "C" int symv_f64_launch(const double* a, int lda, long long sa, int n, const double* v,
                               long long sv, double* part, double* y, int batch, void* stream) {
  Args<double, 1> g{};
  g.a[0] = a, g.v[0] = v, g.part = part, g.y = y, g.lda = lda, g.n = n;
  g.sa = sa, g.sv = sv, g.batch = batch;
  return launch(symv_kernel<double, false>, symv_kernel<double, true>, g, stream);
}

extern "C" int hemv_planar_launch(const float* ar, const float* ai, int lda, long long sa, int n,
                                  const float* vr, const float* vi, long long sv, float* part,
                                  float* y, int batch, void* stream) {
  Args<float, 2> g{};
  g.a[0] = ar, g.a[1] = ai, g.v[0] = vr, g.v[1] = vi;
  g.part = part, g.y = y, g.lda = lda, g.n = n;
  g.sa = sa, g.sv = sv, g.batch = batch;
  return launch(hemv_planar_kernel<false>, hemv_planar_kernel<true>, g, stream);
}
