// Kernel K2: one nb-column zlatrd panel of the planar hetrd (nb <= 32,
// mb <= 4096), columns panel_end-1 down to panel_end-nb, in one cooperative
// launch.
//
// Replaces: eigensolver_gpu_tpu/ops/latrd_pallas.py::latrd_panel_planar
// (pallas_call at :333, _latrd_kernel at :228, _phase at :58), itself the
// fused form of the reference's per-column chain zher2_mv_zlarfg ->
// zhemv -> stacked_zgemv_C -> stacked_zgemv_N_finish_W, glued there by an
// atomics-based software grid barrier (zhetrd_gpu.F90:142-163).
//
// What bounds it on the H100: memory. Each column's y = A v needs the v of
// the column before it, so the leading cj x cj block of both planes is
// streamed once a column: 8 cj^2 bytes, 134 MB at cj = 4096, about 40 us a
// column at 3.35 TB/s. The block does not fit in the 50 MB L2, so at
// mb = 4096 a column after the first reads at least 82 MB of it from device
// memory, 0.79 ms a panel (1.27 ms if the L2 kept none of it); at
// mb <= 2048 its two planes can stay in L2 through the panel. The
// rest is latency: a column's scalars (zlarfg, the compact-WY coefficients,
// w^H v) are grid-wide sums that each wait for the one before. On an NVIDIA
// H100 80GB HBM3 at 700 W a panel at mb = pe = 4096 takes 1.74 ms; block 0
// spends 79 % of its SM cycles in the matvecs (85 900 a column, about
// 3.1 TB/s), 3 000-6 000 a column in each grid barrier (the one after the
// matvec waits for the slowest rows) and 3 300 a column reducing W^H x and
// V^H x, whose parts every block reads from every block (8 MB of L2 reads a
// column at 128 blocks) (tools/kernel_phases.py).
//
// Design: one cooperative launch of ceil(mb / 32) blocks of 1024 threads;
// block b owns rows [32 b, 32 b + 32), one warp a row, and keeps its rows
// of V and W in shared memory. v = scale x + e_{cj-1}, with x the corrected
// column below cj - 1 and scale the zlarfg scaling, so every product with v
// splits into a product with x, which is known before the norm is reduced,
// and a term of row cj - 1. A column is three phases between grid barriers:
//   1. the slab's rows of a = A[:, cj] - V conj(W[cj, :]) - W conj(V[cj, :])
//      (the raw column kept from the phase 2 before), published as x, and
//      the slab's part of |x|^2;
//   2. every block reduces |x|^2 and runs the branch-free zlarfg; the slab's
//      rows of v and of the packed column; u = A[:cj, :cj - 1] x on the slab
//      rows, streamed from device memory (a warp a row, 16-byte loads, x in
//      shared memory), with A[:, cj - 1], the next column's raw column; the
//      slab's parts of W^H x and V^H x;
//   3. W^H v and V^H v from the reduced parts; the slab's rows of
//      y = scale u + A[:, cj - 1] - V (W^H v) - W (V^H v) and w = tau y; the
//      slab's part of w^H v;
// then, behind the third barrier, alpha = -tau (w^H v) / 2 and the slab's
// rows of W[:, s] = w + alpha v. Row cj - 1 of W, which the next column's
// corrections need on every block, is formed by each block from the
// published w there (rounded without contraction, so it is the owner's
// bits). The parts are reduced in block order by every block (no float
// atomics), so two calls give the same bits. Sums are taken in another
// order than the TPU's, so outputs agree to a tolerance, not bitwise.
//
// A batch of problems (one mb, one panel_end; the JAX kernel under
// jax.vmap) is one launch too: the grid holds G = min(batch, resident /
// blocks) groups of ceil(mb / 32) blocks, and group g takes items g, g + G,
// .. in turn, each with its own slice of the scratch and of the outputs.
// The groups run in lockstep behind the grid barriers: a group with no item
// in the last round only takes part in them. An item keeps the unbatched
// block count and block-order sums, so its outputs are the bits of its
// unbatched launch (where its rows are 16-byte aligned alike). A batch of
// one runs a kernel instance of its own (kBatched false) that reads its
// problem from the parameters, as before the batch axis. The launch fails
// (cudaErrorCooperativeLaunchTooLarge) when one group cannot be resident;
// there is no fallback.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kWarps;  // rows a block owns: one warp each
constexpr int kSlabLd = kRows + 1;  // the slab's row stride: lane k of a row hits bank k
constexpr int kNbMax = 32;     // one lane per slot
constexpr int kMbMax = 4096;
constexpr int kGMax = kMbMax / kRows;  // blocks at most

enum Plane { VR = 0, VI, WR, WI, CR, CI };
// published scalars: d, alpha (row cj - 1 of a), w at row cj - 1
enum Pub { P_D = 0, P_AR, P_AI, P_WR, P_WI, kPub = 8 };
// per-block parts, field-major: |x|^2, w^H v, then (W^H x, V^H x) per slot
enum Field { F_XN = 0, F_HR, F_HI, F_Z, kFields = F_Z + 4 * kNbMax };
// slab-row vectors in shared memory: a, the raw column, u, v, w
enum Row { R_AR = 0, R_AI, R_CR, R_CI, R_UR, R_UI, R_VR, R_VI, R_WR, R_WI, kRowVecs };
// block-wide scalars in shared memory
enum Sc { S_XN = 0, S_D, S_AR, S_AI, S_HR, S_HI, S_WLR, S_WLI, S_PWR, S_PWI, kSc };

struct Panel {
  const float* ar;
  const float* ai;
  int lda, mb, pe, nb;
  float* pan;   // [6][nb][mb] slot-major
  float* scal;  // [4][nb]
  float* scr;   // x [2][mb], kPub scalars, kFields x G parts
  long long sa;  // batch stride of ar and ai
  int batch, groups;
};

// floats of one problem's scratch
__host__ __device__ inline size_t latrd_scratch(int mb) {
  return 2 * mb + kPub + kFields * kGMax;
}

// The item a block of a batched launch works on: its pointers and the
// block's place in its group. Kept in shared memory and read where used, so
// that they do not stay in registers over the column loop (held there, they
// made the kernel spill).
struct Item {
  const float* ar;
  const float* ai;
  float* pan;
  float* scal;
  float* scr;
  int blk;
};

// Where panel() finds its problem: an unbatched launch in the kernel's
// parameters and blockIdx (as before the batch axis: read in place, they
// cost no registers; read through the Item, the unbatched panel was
// slower), a batched one in the Item.
struct FromParams {
  const Panel& p;
  __device__ const float* ar() const { return p.ar; }
  __device__ const float* ai() const { return p.ai; }
  __device__ float* pan() const { return p.pan; }
  __device__ float* scal() const { return p.scal; }
  __device__ float* scr() const { return p.scr; }
  __device__ int blk() const { return blockIdx.x; }
};

struct FromItem {
  const Item& it;
  __device__ const float* ar() const { return it.ar; }
  __device__ const float* ai() const { return it.ai; }
  __device__ float* pan() const { return it.pan; }
  __device__ float* scal() const { return it.scal; }
  __device__ float* scr() const { return it.scr; }
  __device__ int blk() const { return it.blk; }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Sum of the G <= kGMax parts at f over the blocks, in block order, on one
// warp (every lane gets the total; every block computes the same bits). A
// lane's loads are all asked for before the first add.
__device__ __forceinline__ float parts_sum(const float* f, int G, int lane) {
  float v[kGMax / 32];
#pragma unroll
  for (int i = 0; i < kGMax / 32; ++i)
    v[i] = lane + 32 * i < G ? __ldcg(f + lane + 32 * i) : 0.f;
  float q = v[0];
#pragma unroll
  for (int i = 1; i < kGMax / 32; ++i) q += v[i];
  return warp_sum(q);
}

// w + alpha v on one entry, rounded as the plain version's tensor ops are
__device__ __forceinline__ float2 w_final(float wr, float wi, float alr, float ali, float vr,
                                          float vi) {
  return make_float2(__fsub_rn(__fadd_rn(wr, __fmul_rn(alr, vr)), __fmul_rn(ali, vi)),
                     __fadd_rn(__fadd_rn(wi, __fmul_rn(alr, vi)), __fmul_rn(ali, vr)));
}

// (sum_c A[r, c] x[c]) over c < ncol on one warp, row pointers pr / pi
template <bool kVec>
__device__ __forceinline__ float2 row_dot(const float* __restrict__ pr,
                                          const float* __restrict__ pi, const float* xr,
                                          const float* xi, int ncol, int lane) {
  float sr = 0.f, si = 0.f;
  int c0 = 0;
  if (kVec) {
    const int n4 = ncol >> 2;
    const float4* a4 = reinterpret_cast<const float4*>(pr);
    const float4* b4 = reinterpret_cast<const float4*>(pi);
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* z4 = reinterpret_cast<const float4*>(xi);
#pragma unroll 2
    for (int q = lane; q < n4; q += 32) {
      const float4 a = __ldg(a4 + q), b = __ldg(b4 + q);
      const float4 x = x4[q], z = z4[q];
      sr += a.x * x.x - b.x * z.x;
      si += a.x * z.x + b.x * x.x;
      sr += a.y * x.y - b.y * z.y;
      si += a.y * z.y + b.y * x.y;
      sr += a.z * x.z - b.z * z.z;
      si += a.z * z.z + b.z * x.z;
      sr += a.w * x.w - b.w * z.w;
      si += a.w * z.w + b.w * x.w;
    }
    c0 = n4 << 2;
  }
  for (int c = c0 + lane; c < ncol; c += 32) {
    const float a = __ldg(pr + c), b = __ldg(pi + c);
    sr += a * xr[c] - b * xi[c];
    si += a * xi[c] + b * xr[c];
  }
  return make_float2(warp_sum(sr), warp_sum(si));
}

// One panel of the problem that `src` points to, on the G = ceil(mb / 32)
// blocks of a group.
template <bool kVec, typename Src>
__device__ __forceinline__ void panel(const Panel& p, const Src& src) {
  const int G = (p.mb + kRows - 1) / kRows;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int mbp = (p.mb + 3) & ~3;
  float* xs_r = smem;                        // x of the whole column
  float* xs_i = xs_r + mbp;
  float* sv = xs_i + mbp;                    // [4][kNbMax][kSlabLd]: the slab's V_r V_i W_r W_i
  float* rv = sv + 4 * kNbMax * kSlabLd;     // [kRowVecs][kRows]
  float* zc = rv + kRowVecs * kRows;         // [4][kNbMax]: per-slot coefficients
  float* zr = zc + 4 * kNbMax;               // [4 kNbMax]: reduced W^H x, V^H x
  float* sc = zr + 4 * kNbMax;               // [kSc]
  auto slab = [&](int plane, int k) { return sv + (plane * kNbMax + k) * kSlabLd; };
  auto vec = [&](int which) { return rv + which * kRows; };
  auto slot = [&](int plane, int k) { return src.pan() + ((size_t)plane * p.nb + k) * p.mb; };

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int r_lo = src.blk() * kRows;
  const int nrow = min(kRows, p.mb - r_lo);
  float* xg_r = src.scr();
  float* xg_i = xg_r + p.mb;
  float* pub = xg_i + p.mb;
  float* part = pub + kPub;
  auto field = [&](int f) { return part + (size_t)f * G; };

  if (t < nrow) {  // the first column's raw entries
    vec(R_CR)[t] = __ldg(src.ar() + (size_t)(r_lo + t) * p.lda + p.pe - 1);
    vec(R_CI)[t] = __ldg(src.ai() + (size_t)(r_lo + t) * p.lda + p.pe - 1);
  }

  for (int s = 0; s < p.nb; ++s) {
    const int cj = p.pe - 1 - s;
    const bool has_r = cj > 0;
    const int pidx = has_r ? cj - 1 : 0;
    const int ncol = cj > 1 ? cj - 1 : 0;  // x is zero from row cj - 1 on
    __syncthreads();

    // ---- 1. a = A[:, cj] - V conj(W[cj, :s]) - W conj(V[cj, :s]) on the slab
    if (t < s) {  // row cj of W and V; W[cj, s - 1] is this block's own copy
      const bool last = t == s - 1;
      zc[t] = last ? sc[S_WLR] : __ldcg(slot(WR, t) + cj);
      zc[kNbMax + t] = last ? sc[S_WLI] : __ldcg(slot(WI, t) + cj);
      zc[2 * kNbMax + t] = __ldcg(slot(VR, t) + cj);
      zc[3 * kNbMax + t] = __ldcg(slot(VI, t) + cj);
    }
    __syncthreads();
    if (warp < nrow) {
      const int i = warp, r = r_lo + i;
      float cr = 0.f, ci = 0.f;
      if (lane < s) {
        const float vr = slab(0, lane)[i], vi = slab(1, lane)[i];
        const float wr = slab(2, lane)[i], wi = slab(3, lane)[i];
        const float z0 = zc[lane], z1 = zc[kNbMax + lane];
        const float z2 = zc[2 * kNbMax + lane], z3 = zc[3 * kNbMax + lane];
        cr = vr * z0 + vi * z1 + wr * z2 + wi * z3;
        ci = vi * z0 - vr * z1 + wi * z2 - wr * z3;
      }
      cr = warp_sum(cr);
      ci = warp_sum(ci);
      if (lane == 0) {
        const float xr = vec(R_CR)[i] - cr, xi = vec(R_CI)[i] - ci;
        vec(R_AR)[i] = xr;
        vec(R_AI)[i] = xi;
        const bool xm = r < cj - 1;
        xg_r[r] = xm ? xr : 0.f;
        xg_i[r] = xm ? xi : 0.f;
        if (r == cj) pub[P_D] = xr;
        if (r == pidx) {
          pub[P_AR] = xr;
          pub[P_AI] = xi;
        }
      }
    }
    __syncthreads();
    if (warp == 0) {
      float q = 0.f;
      if (lane < nrow && r_lo + lane < cj - 1) {
        const float xr = vec(R_AR)[lane], xi = vec(R_AI)[lane];
        q = xr * xr + xi * xi;
      }
      q = warp_sum(q);
      if (lane == 0) field(F_XN)[src.blk()] = q;
    }
    grid.sync();

    // ---- 2. zlarfg, v and the packed column; u = A x; W^H x and V^H x
    if (warp == 0) {
      const float d = __ldcg(pub + P_D), alr = __ldcg(pub + P_AR), ali = __ldcg(pub + P_AI);
      const float q = parts_sum(field(F_XN), G, lane);
      if (lane == 0) {
        sc[S_XN] = q;
        sc[S_D] = d;
        sc[S_AR] = alr;
        sc[S_AI] = ali;
      }
    }
    for (int c = t; c < ncol; c += kThreads) {
      xs_r[c] = __ldcg(xg_r + c);
      xs_i[c] = __ldcg(xg_i + c);
    }
    __syncthreads();
    const float xnormsq = sc[S_XN], d_val = sc[S_D], alphr = sc[S_AR], alphi = sc[S_AI];
    // branch-free planar zlarfg (ops/sytrd_planar.py::_larfg_planar)
    const float norm = sqrtf(alphr * alphr + alphi * alphi + xnormsq);
    float beta = alphr >= 0.f ? -norm : norm;
    const bool trivial = (xnormsq == 0.f) && (alphi == 0.f);
    const float safe_beta = trivial ? 1.f : beta;
    float tk_r = (beta - alphr) / safe_beta, tk_i = -alphi / safe_beta;
    const float dr = alphr - beta;
    const float den = dr * dr + alphi * alphi;
    const float safe_den = trivial ? 1.f : den;
    float sc_r = dr / safe_den, sc_i = -alphi / safe_den;
    if (trivial || !has_r) tk_r = tk_i = sc_r = sc_i = 0.f;
    if (trivial) beta = alphr;
    if (src.blk() == 0 && t == 0) {
      src.scal()[s] = d_val;
      src.scal()[p.nb + s] = has_r ? beta : 0.f;
      src.scal()[2 * p.nb + s] = tk_r;
      src.scal()[3 * p.nb + s] = tk_i;
    }
    if (t < nrow) {
      const int r = r_lo + t;
      const float ar_ = vec(R_AR)[t], ai_ = vec(R_AI)[t];
      const bool xm = r < cj - 1;
      const bool one = has_r && r == cj - 1;
      float vr = xm ? ar_ * sc_r - ai_ * sc_i : 0.f;
      float vi = xm ? ar_ * sc_i + ai_ * sc_r : 0.f;
      if (one) {
        vr = 1.f;
        vi = 0.f;
      }
      slot(VR, s)[r] = vr;
      slot(VI, s)[r] = vi;
      slab(0, s)[t] = vr;
      slab(1, s)[t] = vi;
      vec(R_VR)[t] = vr;
      vec(R_VI)[t] = vi;
      float cr = xm ? vr : ar_, ci = xm ? vi : ai_;
      if (one) {
        cr = beta;
        ci = 0.f;
      }
      if (r == cj) {
        cr = d_val;
        ci = 0.f;
      }
      slot(CR, s)[r] = cr;
      slot(CI, s)[r] = ci;
    }
    if (warp < nrow) {  // a warp a slab row
      const int i = warp, r = r_lo + i;
      if (r < cj) {
        const float2 u = row_dot<kVec>(src.ar() + (size_t)r * p.lda,
                                       src.ai() + (size_t)r * p.lda,
                                       xs_r, xs_i, ncol, lane);
        if (lane == 0) {
          vec(R_UR)[i] = u.x;
          vec(R_UI)[i] = u.y;
        }
      }
      if (lane == 1 && has_r) {  // A[r, cj - 1]: y's term of v's unit entry, the next raw column
        vec(R_CR)[i] = __ldg(src.ar() + (size_t)r * p.lda + cj - 1);
        vec(R_CI)[i] = __ldg(src.ai() + (size_t)r * p.lda + cj - 1);
      }
    }
    if (warp < s) {  // warp k: the slab's (W^H x)_k and (V^H x)_k
      const int k = warp;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      if (lane < nrow && r_lo + lane < cj - 1) {
        const float x = vec(R_AR)[lane], z = vec(R_AI)[lane];
        float pp = slab(2, k)[lane], qq = slab(3, k)[lane];
        a0 = pp * x + qq * z;
        a1 = pp * z - qq * x;
        pp = slab(0, k)[lane];
        qq = slab(1, k)[lane];
        a2 = pp * x + qq * z;
        a3 = pp * z - qq * x;
      }
      a0 = warp_sum(a0);
      a1 = warp_sum(a1);
      a2 = warp_sum(a2);
      a3 = warp_sum(a3);
      if (lane == 0) {
        field(F_Z + 4 * k)[src.blk()] = a0;
        field(F_Z + 4 * k + 1)[src.blk()] = a1;
        field(F_Z + 4 * k + 2)[src.blk()] = a2;
        field(F_Z + 4 * k + 3)[src.blk()] = a3;
      }
    }
    grid.sync();

    // ---- 3. W^H v, V^H v; y and w = tau y on the slab; the slab's w^H v
    float ewr = 0.f, ewi = 0.f, evr = 0.f, evi = 0.f;  // row cj - 1 of W and V
    if (t < s && has_r) {
      ewr = __ldcg(slot(WR, t) + cj - 1);
      ewi = __ldcg(slot(WI, t) + cj - 1);
      evr = __ldcg(slot(VR, t) + cj - 1);
      evi = __ldcg(slot(VI, t) + cj - 1);
    }
    {  // warp w reduces fields w, w + 32, ..: every load asked for first
      float v[4 * kNbMax / kWarps][kGMax / 32];
#pragma unroll
      for (int k = 0; k < 4 * kNbMax / kWarps; ++k)
#pragma unroll
        for (int i = 0; i < kGMax / 32; ++i) {
          const int f = warp + kWarps * k, j = lane + 32 * i;
          v[k][i] = f < 4 * s && j < G ? __ldcg(field(F_Z + f) + j) : 0.f;
        }
#pragma unroll
      for (int k = 0; k < 4 * kNbMax / kWarps; ++k) {
        float q = v[k][0];
#pragma unroll
        for (int i = 1; i < kGMax / 32; ++i) q += v[k][i];
        q = warp_sum(q);
        if (lane == 0 && warp + kWarps * k < 4 * s) zr[warp + kWarps * k] = q;
      }
    }
    __syncthreads();
    if (t < s) {  // W^H v = scale (W^H x) + conj(W[cj - 1, :]); V^H v likewise
      const float zwr = zr[4 * t], zwi = zr[4 * t + 1], zvr = zr[4 * t + 2], zvi = zr[4 * t + 3];
      zc[t] = sc_r * zwr - sc_i * zwi + ewr;
      zc[kNbMax + t] = sc_r * zwi + sc_i * zwr - ewi;
      zc[2 * kNbMax + t] = sc_r * zvr - sc_i * zvi + evr;
      zc[3 * kNbMax + t] = sc_r * zvi + sc_i * zvr - evi;
    }
    __syncthreads();
    if (warp < nrow) {
      const int i = warp, r = r_lo + i;
      float cr = 0.f, ci = 0.f;
      if (lane < s) {
        const float vr = slab(0, lane)[i], vi = slab(1, lane)[i];
        const float wr = slab(2, lane)[i], wi = slab(3, lane)[i];
        const float z0 = zc[lane], z1 = zc[kNbMax + lane];
        const float z2 = zc[2 * kNbMax + lane], z3 = zc[3 * kNbMax + lane];
        cr = vr * z0 - vi * z1 + wr * z2 - wi * z3;
        ci = vr * z1 + vi * z0 + wr * z3 + wi * z2;
      }
      cr = warp_sum(cr);
      ci = warp_sum(ci);
      if (lane == 0) {
        float wr = 0.f, wi = 0.f;
        if (r < cj) {
          const float ur = vec(R_UR)[i], ui = vec(R_UI)[i];
          float yr = sc_r * ur - sc_i * ui, yi = sc_r * ui + sc_i * ur;
          if (has_r) {
            yr += vec(R_CR)[i];
            yi += vec(R_CI)[i];
          }
          yr -= cr;
          yi -= ci;
          wr = tk_r * yr - tk_i * yi;
          wi = tk_r * yi + tk_i * yr;
          if (r == cj - 1) {
            pub[P_WR] = wr;
            pub[P_WI] = wi;
          }
        }
        vec(R_WR)[i] = wr;
        vec(R_WI)[i] = wi;
      }
    }
    __syncthreads();
    if (warp == 0) {
      float hr = 0.f, hi = 0.f;
      if (lane < nrow) {
        const float wr = vec(R_WR)[lane], wi = vec(R_WI)[lane];
        const float vr = vec(R_VR)[lane], vi = vec(R_VI)[lane];
        hr = wr * vr + wi * vi;
        hi = wr * vi - wi * vr;
      }
      hr = warp_sum(hr);
      hi = warp_sum(hi);
      if (lane == 0) {
        field(F_HR)[src.blk()] = hr;
        field(F_HI)[src.blk()] = hi;
      }
    }
    grid.sync();

    // ---- alpha, W[:, s] = w + alpha v on the slab; W[cj - 1, s] on every block
    if (warp == 0) {
      const float pwr = __ldcg(pub + P_WR), pwi = __ldcg(pub + P_WI);
      const float hr = parts_sum(field(F_HR), G, lane);
      const float hi = parts_sum(field(F_HI), G, lane);
      if (lane == 0) {
        sc[S_HR] = hr;
        sc[S_HI] = hi;
        sc[S_PWR] = pwr;
        sc[S_PWI] = pwi;
      }
    }
    __syncthreads();
    const float hr = sc[S_HR], hi = sc[S_HI];
    const float al_r = -0.5f * (tk_r * hr - tk_i * hi);
    const float al_i = -0.5f * (tk_r * hi + tk_i * hr);
    if (t < nrow) {
      const int r = r_lo + t;
      float2 w = make_float2(0.f, 0.f);
      if (r < cj)
        w = w_final(vec(R_WR)[t], vec(R_WI)[t], al_r, al_i, vec(R_VR)[t], vec(R_VI)[t]);
      slot(WR, s)[r] = w.x;
      slot(WI, s)[r] = w.y;
      slab(2, s)[t] = w.x;
      slab(3, s)[t] = w.y;
    }
    if (t == kThreads - 1 && s + 1 < p.nb) {  // v[cj - 1] = 1 (s + 1 < nb implies cj > 0)
      const float2 w = w_final(sc[S_PWR], sc[S_PWI], al_r, al_i, 1.f, 0.f);
      sc[S_WLR] = w.x;
      sc[S_WLI] = w.y;
    }
  }
}

template <bool kVec, bool kBatched>
__global__ void __launch_bounds__(kThreads, 1)
    latrd_panel_kernel(const __grid_constant__ Panel p) {
  if constexpr (!kBatched) {
    panel<kVec>(p, FromParams{p});
    return;
  }
  __shared__ Item it;
  const int G = gridDim.x / p.groups;  // blocks of a group
  // group g takes items g, g + groups, ..: as many rounds as the first group
  const int end = (p.batch + p.groups - 1) / p.groups * p.groups;
  for (int k = (int)blockIdx.x / G; k < end; k += p.groups) {
    if (k >= p.batch) {  // no item for this group: only the columns' three barriers
      for (int b = 0; b < 3 * p.nb; ++b) cg::this_grid().sync();
      continue;
    }
    __syncthreads();  // the block is done with the item before
    if (threadIdx.x == 0) {
      it.ar = p.ar + k * p.sa, it.ai = p.ai + k * p.sa;
      it.pan = p.pan + (size_t)k * 6 * p.nb * p.mb;
      it.scal = p.scal + (size_t)k * 4 * p.nb;
      it.scr = p.scr + k * latrd_scratch(p.mb);
      it.blk = (int)blockIdx.x % G;
    }
    __syncthreads();
    panel<kVec>(p, FromItem{it});
  }
}

size_t smem_bytes(int mb) {
  const int mbp = (mb + 3) & ~3;
  return sizeof(float) *
         (2 * mbp + 4 * kNbMax * kSlabLd + kRowVecs * kRows + 8 * kNbMax + kSc);
}

}  // namespace

// Floats of the scratch a panel of mb rows needs (latrd_panel_planar_launch).
extern "C" int latrd_panel_scratch_floats(int mb) { return (int)latrd_scratch(mb); }

// Run one panel of each of `batch` problems on `stream` in one cooperative
// launch; item k's planes start at ar + k * sa, ai + k * sa. pan
// [batch][6][nb][mb] and scal [batch][4][nb] are written in full; scratch
// holds batch * latrd_panel_scratch_floats(mb) floats. Returns the first
// cudaError_t met while launching (0 = launched);
// cudaErrorCooperativeLaunchTooLarge when the ceil(mb / 32) blocks of one
// problem cannot all be resident.
extern "C" int latrd_panel_planar_launch(const float* ar, const float* ai, int lda,
                                         long long sa, int mb, int pe, int nb, float* pan,
                                         float* scal, float* scratch, int batch,
                                         void* stream) {
  if (nb < 1 || nb > kNbMax || pe < nb || pe > mb || mb > kMbMax || lda < mb || batch < 1)
    return (int)cudaErrorInvalidValue;
  Panel p{ar, ai, lda, mb, pe, nb, pan, scal, scratch, sa, batch, 1};
  const bool vec = lda % 4 == 0 && sa % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(ar) | reinterpret_cast<uintptr_t>(ai)) % 16 == 0;
  const void* kernels[2][2] = {
      {reinterpret_cast<const void*>(latrd_panel_kernel<false, false>),
       reinterpret_cast<const void*>(latrd_panel_kernel<false, true>)},
      {reinterpret_cast<const void*>(latrd_panel_kernel<true, false>),
       reinterpret_cast<const void*>(latrd_panel_kernel<true, true>)}};
  const void* kernel = kernels[vec][batch > 1];
  const int blocks = (mb + kRows - 1) / kRows;
  const size_t smem = smem_bytes(mb);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm * sms < blocks) return (int)cudaErrorCooperativeLaunchTooLarge;
  p.groups = min(batch, per_sm * sms / blocks);
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks * p.groups), dim3(kThreads), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
