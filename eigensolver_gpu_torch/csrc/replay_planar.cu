// Kernel K10: planar complex replay of the bulge-chase reflectors onto
// eigenvector columns, y <- Q2 y on (re, im) planes, every window in one
// launch (eigensolver_gpu_torch/ops/replay.py::apply_q2_planar_kernel,
// called once per planar two-stage solve by models/zhegvdx_planar.py).
//
// Replaces eigensolver_gpu_tpu/ops/replay_pallas.py::apply_q2_planar_pallas
// (pallas_call at :646, bodies _replay_kernel_resident at :225,
// _replay_kernel_planar at :538, _wave_body at :96).
//
// What it computes (ops/sb2st_planar.py::apply_q2_planar): for each valid
// window v of the wave schedule, in replay order (wave after wave; the
// windows of one wave are disjoint, so their order inside a wave is free),
//     y[r0_v : r0_v + l_win, :] <- Q_v y[r0_v : r0_v + l_win, :]
// with Q_v = Q_r + i Q_i the leading l_win x l_win block (l_win = b + g - 1
// <= 128) of the 128 x 128 row-major matrices qc_r[v], qc_i[v] of the
// compact window store (ops/replay.py::window_store_planar forms only the
// valid windows; row0[v] = r0_v from ops/replay.py::window_table). Rows at
// and past n do not exist: they read as zero and are not stored.
//
// What bounds it on the H100: operations. n = 4096, b = 32, g = 96,
// m = 4096 is 8 l_win^2 m flop for each of 2 795 valid windows, 1.5 Tflop,
// 22 ms at the fp32 FMA rate; both planes of y (read and written once) and
// of the windows (read once) are 0.6 GB, 0.2 ms. On an NVIDIA H100 80GB
// HBM3 at 700 W a call at that shape takes 36 ms: per 32-deep chunk of a
// window, thread 0 of a block spends about 4 800 SM cycles in the FMAs
// (the two warps a scheduler need 4 100 at the full rate), 1 200 asking for
// the next copies and 650 waiting for copies and at the barrier
// (tools/kernel_phases.py).
//
// Design. The columns of y are independent through the whole replay: a
// window touches all m columns of its l_win rows and nothing else. So one
// block owns a tile of kBN = 32 columns (128 blocks at m = 4096, about one
// per SM) and runs every window in replay order with block barriers alone:
// no launch per wave, no grid-wide ordering, no block for an invalid slot.
// Every block reads every window from L2 (the blocks run in near lock
// step, so a window comes from device memory about once).
//
// A batch of problems (one launch for the batch of a batched solve: one
// n, m and window table, each item its own windows and its own y) is the
// grid's second axis: block (x, k) replays item k's windows onto columns
// 32 x .. 32 x + 31 of item k's y, exactly as above, so each item's result
// is the bits of a launch on that item alone. y's tensor maps are 3-D with
// the item outermost (one item: a third dimension of 1), so the zero fill
// past row n stays inside the item (a 2-D map over the stacked items would
// read the next item's first rows there); a window's box of the store is one whole window (128 rows at a
// multiple of 128), which never crosses an item, so the store keeps its
// 2-D map over the stacked items' windows.
//
// A window is a product of the 128 x 128 Q (rows and columns past l_win
// are zero in the rows read) with the 128 x 32 y tile, in contraction
// chunks of kKC = 128 bytes a row (32 fp32, 16 fp64). A ring of kStages
// chunks of Q and of the y tile is filled by the TMA while the FMAs of an
// earlier chunk run: thread 0 asks for four 2-D boxes a chunk (both planes
// of Q, from a tensor map of the window store, and of y), completing on
// the stage's transaction barrier, so no thread spends issue slots on
// copies. Rows past n and columns past m arrive as zeros; rows past the
// window are zeroed in shared memory. The ring runs on across windows, so
// the first chunks of window v + 1 land during window v unless their rows
// meet window v's (then they are asked for after its write-back). The
// write-back is plain stores; a proxy fence puts them before the TMA's
// later reads of the same rows, a chunk after the stores, when they have
// drained, unless the next window reads them (fenced at once, the full
// fence cost 1.6 ms a call at n = m = 4096 on an NVIDIA H100 80GB HBM3 at
// 700 W).
// 256 threads; thread (ty, tx) keeps the complex 4 x 4 accumulator tile of
// rows ty + 32 a, columns 4 tx .. 4 tx + 3 in registers (four real FMAs a
// term) and reads its fragments with 16-byte shared loads: per 4 fp32
// contraction steps 8 loads of y and 8 of Q for 256 FMAs (16 FMAs a load).
// Q boxes land with the TMA's 128-byte swizzle, so the four rows a warp
// reads fall in distinct banks. A window's rows are written back from the
// registers after its last chunk, so the update is in place. Fixed
// summation order: two calls give the same bits. Plain FMA arithmetic, no
// tensor cores (the JAX package forces full fp32 precision here); float and
// double instances.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kP = 128;        // row stride of a stored window, the largest l_win
constexpr int kBN = 32;        // columns of y per block
constexpr int kThreads = 256;
constexpr int kStages = 3;     // contraction chunks in the ring
constexpr int kTM = 4;         // rows of a thread's tile: ty + kRowStep a
constexpr int kTN = 4;         // columns of a thread's tile: 4 tx + c, one 16-byte load
constexpr int kRowStep = kThreads / (kBN / kTN);  // 32
static_assert(kTM * kRowStep == kP, "the threads' tiles cover 128 x kBN");
static_assert(kRowStep % 8 == 0, "a thread's rows share their swizzle, row % 8 == ty % 8");

template <typename T>
struct Shape {
  static constexpr int kEV = 16 / sizeof(T);       // elements in 16 bytes
  static constexpr int kKC = 128 / sizeof(T);      // contraction chunk: 128 bytes of a Q row
  static constexpr int kQ = kP * kKC;              // one plane of a Q chunk, 16 KB
  static constexpr int kY = kKC * kBN;             // one plane of a y chunk, 4 KB
  static constexpr int kStage = 2 * kQ + 2 * kY;   // elements of a ring stage
  static constexpr size_t kSmem = kStages * kStage * sizeof(T) + 1024 + kStages * 8;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_u32(bar)) : "memory");
}

// the issuing thread's arrival, with the bytes the TMA will deliver
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// box (x, y) of a 2-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y,
                                         uint64_t* bar) {
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.tile"
               ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];"
               :: "r"(smem_u32(dst)), "l"(map), "r"(x), "r"(y), "r"(smem_u32(bar))
               : "memory");
}

// box (x, y, z) of a 3-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y, int z,
                                         uint64_t* bar) {
  asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.tile"
               ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];"
               :: "r"(smem_u32(dst)), "l"(map), "r"(x), "r"(y), "r"(z), "r"(smem_u32(bar))
               : "memory");
}

// four consecutive elements, 16-byte aligned, from or to shared or global memory
__device__ __forceinline__ void load4(const float* p, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
__device__ __forceinline__ void load4(const double* p, double* x) {
  const double2 u = reinterpret_cast<const double2*>(p)[0];
  const double2 v = reinterpret_cast<const double2*>(p)[1];
  x[0] = u.x, x[1] = u.y, x[2] = v.x, x[3] = v.y;
}
__device__ __forceinline__ void store4(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(double* p, const double* x) {
  reinterpret_cast<double2*>(p)[0] = make_double2(x[0], x[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(x[2], x[3]);
}
__device__ __forceinline__ void load16(const float* p, float (&x)[4]) { load4(p, x); }
__device__ __forceinline__ void load16(const double* p, double (&x)[2]) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  x[0] = v.x, x[1] = v.y;
}

// Thread 0 starts the copies of chunk c of window `win` of item `item`,
// whose first row is r0, into the ring stage `stage`, completing on `bar`:
// both planes of Q[0 : 128, c kKC : (c + 1) kKC] (rows of 128 bytes, 16-byte
// pieces swizzled: piece j of row r lands at j ^ (r % 8)) of the store's
// window item n_win + win and of the item's
// y[r0 + c kKC : r0 + (c + 1) kKC, col0 : col0 + kBN].
template <typename T>
__device__ __forceinline__ void issue_chunk(const CUtensorMap* maps, uint64_t* bar, int r0,
                                            int col0, int win, int c, int item, int n_win,
                                            T* stage) {
  using S = Shape<T>;
  const int qrow = (item * n_win + win) * kP;
  // the block's earlier accesses to this stage come before the TMA's writes
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  mbar_expect(bar, S::kStage * sizeof(T));
  tma_load(stage, maps, c * S::kKC, qrow, bar);
  tma_load(stage + S::kQ, maps + 1, c * S::kKC, qrow, bar);
  tma_load(stage + 2 * S::kQ, maps + 2, col0, r0 + c * S::kKC, item, bar);
  tma_load(stage + 2 * S::kQ + S::kY, maps + 3, col0, r0 + c * S::kKC, item, bar);
}

// acc += Q[rows, chunk] y[chunk, cols] for the thread's tile, k ascending
template <typename T>
__device__ __forceinline__ void fma_chunk(const T* stage, int ty, int tx,
                                          T (&acc_r)[kTM][kTN], T (&acc_i)[kTM][kTN]) {
  using S = Shape<T>;
  const T* sqr = stage;
  const T* sqi = sqr + S::kQ;
  const T* syr = sqi + S::kQ;
  const T* syi = syr + S::kY;
#pragma unroll
  for (int k0 = 0; k0 < S::kKC; k0 += S::kEV) {
    T yr[S::kEV][kTN], yi[S::kEV][kTN];
#pragma unroll
    for (int j = 0; j < S::kEV; ++j) {
      load4(syr + (k0 + j) * kBN + kTN * tx, yr[j]);
      load4(syi + (k0 + j) * kBN + kTN * tx, yi[j]);
    }
#pragma unroll
    for (int a = 0; a < kTM; ++a) {
      // row ty + kRowStep a; its piece k0 / kEV lies at (k0 / kEV) ^ (row % 8)
      const int at = (ty + kRowStep * a) * S::kKC + ((k0 / S::kEV) ^ (ty & 7)) * S::kEV;
      T qr[S::kEV], qi[S::kEV];
      load16(sqr + at, qr);
      load16(sqi + at, qi);
#pragma unroll
      for (int j = 0; j < S::kEV; ++j)
#pragma unroll
        for (int c = 0; c < kTN; ++c) {
          acc_r[a][c] += qr[j] * yr[j][c];
          acc_r[a][c] -= qi[j] * yi[j][c];
          acc_i[a][c] += qr[j] * yi[j][c];
          acc_i[a][c] += qi[j] * yr[j][c];
        }
    }
  }
}

// Windows 0 .. n_win - 1 of item `item` in order, on the column tile at
// col0; maps are the tensor maps of Q_r, Q_i (the window store) and y_r,
// y_i; y_r, y_i point at the item's y.
template <typename T>
__device__ void replay_windows(const CUtensorMap* maps, const int* row0, int n_win, T* y_r,
                               T* y_i, int ldy, int n, int lwin, int col0, int item, T* smem,
                               uint64_t* bars) {
  using S = Shape<T>;
  const int ty = threadIdx.x / (kBN / kTN), tx = threadIdx.x % (kBN / kTN);
  const int nc = (lwin + S::kKC - 1) / S::kKC;  // chunks a window
  const int total = n_win * nc;
  int next = 0;  // chunks asked for so far
  // the first rows of the current window v and of window v + 1, each read
  // from global memory a window before its first use
  int v = -1, r_cur = 0, r_next = row0[0];
  // the rows of the last window still wait for the proxy fence that puts
  // their stores before the TMA's reads of them
  bool unfenced = false;
  auto issue = [&]() {
    const int win = next / nc, st = next % kStages;
    if (threadIdx.x == 0)
      issue_chunk<T>(maps, bars + st, win == v ? r_cur : r_next, col0, win, next - win * nc,
                     item, n_win, smem + st * S::kStage);
    ++next;
  };
  // the first chunks of window 0
  while (next < total && next < kStages - 1 && next < nc) issue();

  for (v = 0; v < n_win; ++v) {
    T acc_r[kTM][kTN], acc_i[kTM][kTN];
#pragma unroll
    for (int a = 0; a < kTM; ++a)
#pragma unroll
      for (int c = 0; c < kTN; ++c) acc_r[a][c] = acc_i[a][c] = T(0);
    r_cur = r_next;
    r_next = v + 1 < n_win ? row0[v + 1] : 0;
    for (int c = 0; c < nc; ++c) {
      const int f = v * nc + c;
      T* stage = smem + (f % kStages) * S::kStage;
      // chunk f has landed: the (f / kStages)-th fill of its stage
      mbar_wait(bars + f % kStages, (f / kStages) & 1);
      const int tail = (c + 1) * S::kKC - lwin;  // rows of the chunk past the window
      if (tail > 0) {  // read as zero (the y rows there belong to no window of v)
        T* sy = stage + 2 * S::kQ;
        for (int e = threadIdx.x; e < tail * kBN; e += kThreads) {
          const int at = (S::kKC - tail) * kBN + e;
          sy[at] = T(0);
          sy[S::kY + at] = T(0);
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      }
      // fence the last window's stores once they have drained (a chunk of
      // FMAs later), before the first refill that may reach a window that
      // reads them (chunk nc - 2 asks for the next window's first chunk)
      if (unfenced && c == (nc >= 3 ? 1 : 0)) {
        asm volatile("fence.proxy.async.global;" ::: "memory");
        unfenced = false;
      }
      __syncthreads();
      // the stage of chunk f - 1 is free: refill it with the chunk kStages - 1
      // ahead, if that belongs to this window or to a next window clear of it
      if (next < total && next <= f + kStages - 1 &&
          (next / nc == v ||
           (next / nc == v + 1 && (r_next - r_cur >= lwin || r_cur - r_next >= lwin))))
        issue();
      fma_chunk<T>(stage, ty, tx, acc_r, acc_i);
    }
    // every read of this window's rows is behind the barrier of its last
    // chunk; the rows of no other chunk in flight meet them
    const int r0 = r_cur, gc = col0 + kTN * tx;
    if (gc < ldy) {
#pragma unroll
      for (int a = 0; a < kTM; ++a) {
        const int row = ty + kRowStep * a;
        if (row < lwin && r0 + row < n) {
          store4(y_r + (size_t)(r0 + row) * ldy + gc, acc_r[a]);
          store4(y_i + (size_t)(r0 + row) * ldy + gc, acc_i[a]);
        }
      }
    }
    // the rows written come before the TMA's reads of them: at once if the
    // next window reads them, else a chunk later
    unfenced = true;
    if (v + 1 < n_win && r_next - r_cur < lwin && r_cur - r_next < lwin) {
      asm volatile("fence.proxy.async.global;" ::: "memory");
      unfenced = false;
    }
    __syncthreads();
    // the first chunks of window v + 1 that waited for this write-back
    while (next < total && next <= (v + 1) * nc + kStages - 2 && next / nc == v + 1) issue();
  }
}

struct Maps {
  CUtensorMap q_r, q_i, y_r, y_i;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
replay_planar_kernel(const __grid_constant__ Maps maps, const int* row0, int n_win, T* y_r,
                     T* y_i, int ldy, int n, int lwin) {
  const int item = blockIdx.y;
  const size_t sy = (size_t)n * ldy;  // the items' y, one after the other
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the ring on a 1024-byte boundary (the TMA's 128-byte swizzle), then
  // one transaction barrier a stage
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + kStages * Shape<T>::kStage * sizeof(T));
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  replay_windows<T>(&maps.q_r, row0, n_win, y_r + item * sy, y_i + item * sy, ldy, n, lwin,
                    blockIdx.x * kBN, item, reinterpret_cast<T*>(base), bars);
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the map of `rows` rows of `cols` elements at row stride ld: 2-D, or 3-D
// with `items` such blocks, a block every rows * ld elements and the block
// outermost; boxes of box_rows by box_cols (of one block); what lies past a
// block's rows or columns reads as zero
template <typename T>
cudaError_t map_tiles(CUtensorMap* map, const T* base, int cols, long long rows, int ld,
                      int rank, int items, int box_cols, int box_rows,
                      CUtensorMapSwizzle swizzle) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)items};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * sizeof(T),
                                 (cuuint64_t)rows * ld * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUresult res = encode(
      map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_FLOAT64,
      rank, const_cast<T*>(base), dims, strides, box, steps,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T>
int replay_planar_launch(const T* qc_r, const T* qc_i, const int* row0, int n_win, T* y_r,
                         T* y_i, int ldy, int n, int m, int lwin, int batch, void* stream) {
  using S = Shape<T>;
  if (n < 1 || m < 1 || ldy < m || ldy % 4 != 0 || lwin < 1 || lwin > kP || n_win < 0 ||
      batch < 0 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(qc_r) | reinterpret_cast<uintptr_t>(qc_i) |
       reinterpret_cast<uintptr_t>(y_r) | reinterpret_cast<uintptr_t>(y_i)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  if (n_win == 0 || batch == 0) return (int)cudaSuccess;
  // the store: batch * n_win * 128 rows of 128, in 128-byte-wide boxes
  // swizzled by 128 bytes; y: batch items of n rows of m, in boxes of kKC
  // rows by kBN columns of one item
  Maps maps;
  const long long store_rows = (long long)batch * n_win * kP;
  cudaError_t err = map_tiles(&maps.q_r, qc_r, kP, store_rows, kP, 2, 1, S::kKC, kP,
                              CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = map_tiles(&maps.q_i, qc_i, kP, store_rows, kP, 2, 1, S::kKC, kP,
                    CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = map_tiles(&maps.y_r, y_r, m, n, ldy, 3, batch, kBN, S::kKC,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == cudaSuccess)
    err = map_tiles(&maps.y_i, y_i, m, n, ldy, 3, batch, kBN, S::kKC,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return (int)err;
  auto kernel = replay_planar_kernel<T>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)S::kSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((m + kBN - 1) / kBN, batch), kThreads, S::kSmem, (cudaStream_t)stream>>>(
      maps, row0, n_win, y_r, y_i, ldy, n, lwin);
  return (int)cudaGetLastError();
}

}  // namespace

// A batch of problems, item after item: qc_r, qc_i: batch * n_win windows
// of 128 x 128 elements each (16-byte aligned), item k's windows k n_win ..
// (k + 1) n_win - 1; row0: n_win ints on the device, each window's first row
// of y, in replay order, one table for every item; y_r, y_i: batch items of
// n rows of m elements at row stride ldy (a multiple of 4, 16-byte aligned),
// an item every n ldy elements, updated in place.
extern "C" int apply_q2_planar_f32_launch(const float* qc_r, const float* qc_i,
                                          const int* row0, int n_win, float* y_r, float* y_i,
                                          int ldy, int n, int m, int lwin, int batch,
                                          void* stream) {
  return replay_planar_launch<float>(qc_r, qc_i, row0, n_win, y_r, y_i, ldy, n, m, lwin,
                                     batch, stream);
}

extern "C" int apply_q2_planar_f64_launch(const double* qc_r, const double* qc_i,
                                          const int* row0, int n_win, double* y_r,
                                          double* y_i, int ldy, int n, int m, int lwin,
                                          int batch, void* stream) {
  return replay_planar_launch<double>(qc_r, qc_i, row0, n_win, y_r, y_i, ldy, n, m, lwin,
                                      batch, stream);
}
