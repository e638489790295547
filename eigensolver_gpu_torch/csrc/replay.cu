// Kernel K9: replay of the bulge-chase reflectors onto eigenvector columns,
// y <- Q2 y, every window in one launch
// (eigensolver_gpu_torch/ops/replay.py::apply_q2_kernel, called once per
// real two-stage solve by models/syevdx.py).
//
// Replaces eigensolver_gpu_tpu/ops/replay_pallas.py::apply_q2_pallas
// (pallas_call at :763, bodies _replay_kernel_resident at :225,
// _replay_kernel at :414, _wave_body at :96, _wave_body_twophase at :160).
//
// What it computes (ops/sb2st.py::apply_q2, tsolve='qform'): for each valid
// window v of the wave schedule, in replay order (wave after wave; the
// windows of one wave are disjoint, so their order inside a wave is free),
//     y[r0_v : r0_v + l_win, :] <- Q_v y[r0_v : r0_v + l_win, :]
// with Q_v the leading l_win x l_win block (l_win = b + g - 1 <= 128) of the
// 128 x 128 row-major matrix qc[v] of the compact window store
// (ops/replay.py::window_store forms only the valid windows; row0[v] = r0_v
// from ops/replay.py::window_table). Rows at and past n do not exist: they
// read as zero and are not stored.
//
// What bounds it on the H100: operations. n = 4096, b = 32, g = 96,
// m = 4096 is 2 l_win^2 m flop for each of 2 795 valid windows, 0.37 Tflop,
// 5.5 ms at the fp32 FMA rate; y (read and written once) and the windows
// (read once) are 0.25 GB, 0.07 ms. Every block reads every window, so the
// windows come through L2 once a column tile: 23 GB at 32 columns a block.
// On an NVIDIA H100 80GB HBM3 at 700 W a call at that shape takes 11.2 ms:
// consumer thread 0 spends 68 % of its SM cycles in the FMAs (1 740 a
// 32-deep chunk for 1 024 FMA instructions: one warp a scheduler, 59 % of
// its issue rate), 12 % waiting for copies, 8 % releasing stages and 12 %
// at a window's end (write-back, fences, signals, the zero-fill barrier);
// the producer spends 32 % of its cycles issuing copies (640 a chunk), 42 %
// waiting for a free stage and 25 % for a window's signal
// (tools/kernel_phases.py).
//
// Design: the one of kernel K10 (csrc/replay_planar.cu) with one plane.
// The columns of y are independent through the whole replay, so one block
// owns a tile of kBN columns and runs every window in replay order: no
// launch per wave, no block for an invalid slot. A window is the product of
// its 128 x 128 Q (rows and columns past l_win zero in the rows kept) with
// the 128 x kBN y tile, in contraction chunks of kKC = 128 bytes a Q row
// (32 fp32, 16 fp64). A real product has a quarter of the complex one's
// FMAs for each element loaded, so the copies are taken off the consumers:
// one producer warp keeps a ring of kStages chunks filled by the TMA (a Q
// box, 128-byte swizzled, and a y box a chunk), and the kConsumers consumer
// threads wait on each stage's transaction barrier and release it on
// another, with no block-wide barrier a chunk. Consumer (ty, tx) keeps a
// kTM x 4 accumulator tile in registers (rows ty + kRowStep a, columns
// 4 tx .. 4 tx + 3) and reads its fragments with 16-byte shared loads:
// 8 x 4 tiles, 128 FMAs for every 12 loads of 16 bytes (a 4 x 4 tile on 256
// consumers gives 64 for 8, an 8 x 8 tile 16 a load but only 64 column tiles
// at m = 4096 or 2 consumer warps a block; PERF.md has the variants' times).
// The consumers write the rows back from their registers, so the update is
// in place. Before the producer asks for the next window's chunks, the
// consumers signal that the rows it reads are written and fenced for the
// TMA: at once after the write-back if that window meets this one, else a
// chunk into the next window, after the write-back's proxy fence, deferred
// so the stores have drained. Fixed summation order: two calls give the
// same bits. Plain FMA arithmetic, no tensor cores; float and double
// instances.
//
// A batch of problems (one launch for the batch of a batched solve: one
// n, m and window table, each item its own windows and its own y) is the
// grid's second axis, as in K10: block (x, k) replays item k's windows onto
// columns 32 x .. 32 x + 31 of item k's y, exactly as above, so each item's
// result is the bits of a launch on that item alone. y's tensor map is 3-D
// with the item outermost (one item: a third dimension of 1), so the zero
// fill past row n stays inside the item; a window's box of the store is one
// whole window, which never crosses an item, so the store keeps its 2-D map
// over the stacked items' windows.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kP = 128;  // row stride of a stored window, the largest l_win
constexpr int kConsumers = 128;  // consumer threads
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kBN = 32;  // columns of y a block
constexpr int kColThreads = kBN / 4;  // consumers across the columns, 4 each
constexpr int kRowStep = kConsumers / kColThreads;
constexpr int kTM = kP / kRowStep;  // rows of a consumer's tile
constexpr int kStages = 4;  // contraction chunks in the ring
static_assert(kRowStep % 8 == 0, "a thread's rows share their swizzle, row % 8 == ty % 8");

template <typename T>
struct Shape {
  static constexpr int kEV = 16 / sizeof(T);   // elements in 16 bytes
  static constexpr int kKC = 128 / sizeof(T);  // contraction chunk: 128 bytes of a Q row
  static constexpr int kQ = kP * kKC;          // a Q chunk, 16 KB
  static constexpr int kY = kKC * kBN;         // a y chunk
  static constexpr int kStage = kQ + kY;       // elements of a ring stage
  static constexpr size_t kSmem = kStages * kStage * sizeof(T) + 1024 + (2 * kStages + 1) * 8;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  uint64_t state;
  asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];"
               : "=l"(state) : "r"(smem_u32(bar)) : "memory");
  (void)state;
}

// the producer's arrival, with the bytes the TMA will deliver
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

// the consumers alone (the producer warp is not in it). A named barrier
// counts whole warps, so the warp is reconverged first (lane 0 alone
// releases a stage).
__device__ __forceinline__ void consumers_sync() {
  __syncwarp();
  asm volatile("bar.sync 1, %0;" :: "n"(kConsumers) : "memory");
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

// acc += Q[rows, chunk] y[chunk, cols] for the thread's tile, k ascending
template <typename T>
__device__ __forceinline__ void fma_chunk(const T* stage, int ty, int tx, T (&acc)[kTM][4]) {
  using S = Shape<T>;
  const T* sq = stage;
  const T* sy = stage + S::kQ;
#pragma unroll
  for (int k0 = 0; k0 < S::kKC; k0 += S::kEV) {
    T yv[S::kEV][4];
#pragma unroll
    for (int j = 0; j < S::kEV; ++j) load4(sy + (k0 + j) * kBN + 4 * tx, yv[j]);
#pragma unroll
    for (int a = 0; a < kTM; ++a) {
      // row ty + kRowStep a; its piece k0 / kEV lies at (k0 / kEV) ^ (row % 8)
      const int at = (ty + kRowStep * a) * S::kKC + ((k0 / S::kEV) ^ (ty & 7)) * S::kEV;
      T q[S::kEV];
      load16(sq + at, q);
#pragma unroll
      for (int j = 0; j < S::kEV; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] += q[j] * yv[j][c];
    }
  }
}

struct Maps {
  CUtensorMap q, y;
};

// The producer: chunk after chunk of every window of item `item` (the
// store's windows item n_win ..) into the ring, each window's first chunk
// only after the consumers' signal for it.
template <typename T>
__device__ void produce(const Maps& maps, const int* row0, int n_win, int nc, int col0,
                        int item, T* ring, uint64_t* full, uint64_t* empty, uint64_t* sig) {
  using S = Shape<T>;
  int r_cur = 0, r_next = row0[0];
  for (int w = 0, f = 0; w < n_win; ++w) {
    r_cur = r_next;
    r_next = w + 1 < n_win ? row0[w + 1] : 0;
    if (w > 0) mbar_wait(sig, (w - 1) & 1);
    for (int c = 0; c < nc; ++c, ++f) {
      const int st = f % kStages, use = f / kStages;
      if (use > 0) mbar_wait(empty + st, (use - 1) & 1);
      T* stage = ring + st * S::kStage;
      mbar_expect(full + st, S::kStage * sizeof(T));
      tma_load(stage, &maps.q, c * S::kKC, (item * n_win + w) * kP, full + st);
      tma_load(stage + S::kQ, &maps.y, col0, r_cur + c * S::kKC, item, full + st);
    }
  }
}

// The consumers: windows 0 .. n_win - 1 in order on the column tile at col0
// of y, the item's.
template <typename T>
__device__ void consume(const int* row0, int n_win, int nc, T* y, int ldy, int n, int lwin,
                        int col0, const T* ring, uint64_t* full, uint64_t* empty,
                        uint64_t* sig) {
  using S = Shape<T>;
  const int ct = threadIdx.x;
  const int ty = ct / kColThreads, tx = ct % kColThreads;
  const int lane = threadIdx.x & 31;
  // the second chunk of a window: where a deferred fence and its signal go
  const int c_fence = nc > 1 ? 1 : 0;
  // the first rows of windows v, v + 1 and v + 2, each read a window early
  int r_cur = 0, r_next = row0[0], r_after = n_win > 1 ? row0[1] : 0;
  bool pending = false;  // the last window's stores wait for their proxy fence
  for (int v = 0; v < n_win; ++v) {
    r_cur = r_next;
    r_next = r_after;
    r_after = v + 2 < n_win ? row0[v + 2] : 0;
    // window v + 1 reads rows of this one: signal after the write-back
    const bool meets = v + 1 < n_win && r_next - r_cur < lwin && r_cur - r_next < lwin;
    T acc[kTM][4];
#pragma unroll
    for (int a = 0; a < kTM; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = T(0);
    for (int c = 0; c < nc; ++c) {
      const int f = v * nc + c, st = f % kStages;
      const T* stage = ring + st * S::kStage;
      // chunk f has landed: the (f / kStages)-th fill of its stage
      mbar_wait(full + st, (f / kStages) & 1);
      if (c == c_fence) {
        // the last window's stores have drained behind a chunk of FMAs
        if (pending) {
          asm volatile("fence.proxy.async.global;" ::: "memory");
          pending = false;
        }
        if (!meets && v + 1 < n_win) mbar_arrive(sig);
      }
      const int tail = (c + 1) * S::kKC - lwin;  // rows of the chunk past the window
      if (tail > 0) {  // read as zero (those y rows belong to no window of v)
        T* sy = const_cast<T*>(stage) + S::kQ;
        for (int e = ct; e < tail * kBN; e += kConsumers) sy[(S::kKC - tail) * kBN + e] = T(0);
        // before the TMA's later writes to the stage, and the consumers' reads
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        consumers_sync();
      }
      fma_chunk<T>(stage, ty, tx, acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + st);
    }
    // no chunk in flight reads this window's rows: they go straight back
    const int gc = col0 + 4 * tx;
#pragma unroll
    for (int a = 0; a < kTM; ++a) {
      const int row = ty + kRowStep * a;
      if (row < lwin && r_cur + row < n && gc < ldy)
        store4(y + (size_t)(r_cur + row) * ldy + gc, acc[a]);
    }
    if (meets) {
      asm volatile("fence.proxy.async.global;" ::: "memory");
      mbar_arrive(sig);
    } else {
      pending = true;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
replay_kernel(const __grid_constant__ Maps maps, const int* row0, int n_win, T* y, int ldy,
              int n, int lwin) {
  using S = Shape<T>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the ring on a 1024-byte boundary (the TMA's 128-byte swizzle), then the
  // stages' fill and release barriers and the window signal
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  T* ring = reinterpret_cast<T*>(base);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kStages * S::kStage * sizeof(T));
  uint64_t* empty = full + kStages;
  uint64_t* sig = empty + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers / 32);
    }
    mbar_init(sig, kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int nc = (lwin + S::kKC - 1) / S::kKC;  // chunks a window
  const int col0 = blockIdx.x * kBN;
  const int item = blockIdx.y;
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers)
      produce<T>(maps, row0, n_win, nc, col0, item, ring, full, empty, sig);
    return;
  }
  // the items' y, one after the other
  consume<T>(row0, n_win, nc, y + (size_t)item * n * ldy, ldy, n, lwin, col0, ring, full, empty,
             sig);
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
int replay_launch(const T* qc, const int* row0, int n_win, T* y, int ldy, int n, int m, int lwin,
                  int batch, void* stream) {
  using S = Shape<T>;
  if (n < 1 || m < 1 || ldy < m || ldy % 4 != 0 || lwin < 1 || lwin > kP || n_win < 0 ||
      batch < 0 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(qc) | reinterpret_cast<uintptr_t>(y)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  if (n_win == 0 || batch == 0) return (int)cudaSuccess;
  // the store: batch * n_win * 128 rows of 128, in 128-byte-wide boxes
  // swizzled by 128 bytes; y: batch items of n rows of m, in boxes of kKC
  // rows by kBN columns of one item
  Maps maps;
  cudaError_t err = map_tiles(&maps.q, qc, kP, (long long)batch * n_win * kP, kP, 2, 1, S::kKC,
                              kP, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = map_tiles(&maps.y, y, m, n, ldy, 3, batch, kBN, S::kKC, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return (int)err;
  auto kernel = replay_kernel<T>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)S::kSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((m + kBN - 1) / kBN, batch), kThreads, S::kSmem, (cudaStream_t)stream>>>(
      maps, row0, n_win, y, ldy, n, lwin);
  return (int)cudaGetLastError();
}

}  // namespace

// A batch of problems, item after item: qc: batch * n_win windows of
// 128 x 128 elements (16-byte aligned), item k's windows k n_win ..
// (k + 1) n_win - 1; row0: n_win ints on the device, each window's first row
// of y, in replay order, one table for every item; y: batch items of n rows
// of m elements at row stride ldy (a multiple of 4, 16-byte aligned), an
// item every n ldy elements, updated in place.
extern "C" int apply_q2_f32_launch(const float* qc, const int* row0, int n_win, float* y,
                                   int ldy, int n, int m, int lwin, int batch, void* stream) {
  return replay_launch<float>(qc, row0, n_win, y, ldy, n, m, lwin, batch, stream);
}

extern "C" int apply_q2_f64_launch(const double* qc, const int* row0, int n_win, double* y,
                                   int ldy, int n, int m, int lwin, int batch, void* stream) {
  return replay_launch<double>(qc, row0, n_win, y, ldy, n, m, lwin, batch, stream);
}
