// Grouped matrix products over rows sorted by group, for Hopper (sm_90a):
// the experts of a Mixture-of-Experts layer (models/moe.py).
//
// It replaces no Pallas kernel: the reference computes the experts with
// jax.lax.ragged_dot (src/repro/models/moe.py, _moe_ragged), which XLA
// lowers itself. The port's grouped product has to read its group
// boundaries on the device, so that a round which routes tokens can be
// captured in a CUDA graph, and it needs a backward of its own:
//
//   fwd    Y[r]  = X[r] . W[g(r)]      grouped_fwd_wgmma_kernel (bf16),
//                                      grouped_fwd_kernel (fp32)
//   dgrad  dX[r] = dY[r] . W[g(r)]^T   grouped_dgrad_wgmma_kernel (bf16),
//                                      grouped_dgrad_kernel (fp32)
//   wgrad  dW[g] = X_g^T . dY_g        grouped_wgrad_wgmma_kernel (bf16),
//                                      grouped_wgrad_kernel (fp32)
//
// over R rows sorted by group, X (R, K), W (E, K, N), Y (R, N); offs (E,)
// int32 holds the groups' cumulative row ends and is read on the device.
// Rows past offs[E-1] belong to no group: fwd and dgrad write them zero, as
// ragged_dot does. An expert with no row gets dW zero.
//
// Numbers. X and dY come in the compute dtype (fp32 or bf16), W in its
// stored dtype (fp32 or bf16). Each W value is rounded to the compute dtype
// as it is loaded (round to nearest even: the values of w.to(x.dtype),
// without casting the whole W). Sums run in fp32. fp32 runs on the CUDA
// cores with explicit FMAs (no TF32); bf16 on the tensor cores. Y and dX
// are stored in the compute dtype; dW is rounded to the compute dtype, then
// stored in W's dtype (the backward of the cast). Every output element is
// summed in a fixed order with no atomics, so reruns are bit-identical and
// a captured replay equals its eager run.
//
// Bound. The MoE's fp32 expert weights: a deepseek-v2 prefill of 4 x 512
// tokens (12,288 routed rows) reads 15.1 GB of them per layer against
// 0.58 TFLOP, so the products are bound by the bytes of W. No kernel
// writes a cast copy of W.
//
// bf16 fwd and dgrad (the serving and training path). One mainloop,
// templated on the direction, computes the transposed tile
// out^T = op(W)^T . rows^T on wgmma, so that W is the A operand:
//
//   * a CTA owns 128 of W's output columns (fwd) or rows (dgrad), two
//     consumer warpgroups of 64 (wgmma's M), and one row tile of BR rows
//     of one group (wgmma's N, 8 to 256): a decode step's 1-4 rows an
//     expert pad to 8, not to 64. BR is picked on the host from R and E
//     alone (kernels/grouped_mm.py, rows_plan), so a capture stays valid
//     for any routing; at batch A a group fits one row tile and each
//     expert's W slice is read once;
//   * a producer warp keeps a ring of stages in flight with TMA
//     (cp.async.bulk.tensor on full and empty mbarriers): a stage is 64 of
//     the reduction, the W box (128 x 64 values in W's dtype) and the row
//     box (BR rows x 64 bf16). Both directions read one 4-d tensor map of
//     W, (N, K, E, 1): fwd walks W's K rows, dgrad its N columns. A row
//     box may begin at any row of the group and run into the next group's
//     rows or past R (TMA fills zeros there); the epilogue stores only the
//     tile's rows;
//   * the consumers read their W fragment from shared memory (128-byte
//     swizzle: no bank conflict in fwd, two-way in dgrad), round it to
//     bf16 in registers (cvt.rn.bf16x2) and issue wgmma m64nBRk16 with A
//     from registers and the row box as B, K-major: no bf16 copy of W
//     anywhere;
//   * the output tile goes out through shared memory as 16-byte row
//     stores;
//   * with few rows (decode) the launch has too few working CTAs for the
//     card, so the host splits the reduction into S ordered slices (S from
//     R, E, K, N and the SM count): each CTA writes its slice's fp32
//     partial into a workspace that the wrapper takes from PyTorch's
//     allocator, and grouped_{fwd,dgrad}_sum_kernel adds the S partials in
//     slice order and rounds once;
//   * each CTA finds its (group, first row) from offs on the card, as the
//     fp32 kernels do, from a copy of offs in shared memory (one round
//     trip); min(R, ceil(R / BR) + E) row tiles cover any routing, the
//     surplus exits.
//
// bf16 wgrad (the training path's weight gradient). dW is the bound: all
// of it is written, an expert without rows included (deepseek-v2's fp32
// dW is 5.03 GB a product) against 0.16 GB of x and dY at batch A. So the
// kernel keeps dW's store stream busy, overlaps it with the products, and
// reads few operand bytes beside it (they share L2 with the stores):
//
//   * a work item is (expert, 128 of K, BN of N) of dW, BN 128 or 256; a
//     persistent grid of about one CTA an SM walks the items in a fixed
//     order (CTA c takes items c, c + grid, ...), experts outermost, so
//     the CTAs in flight share one expert's rows in L2. The tile, the grid
//     and the ring's stages come from shapes and the SM count alone
//     (kernels/grouped_mm.py, wgrad_plan): a capture fits any routing.
//     Each CTA finds its group's rows from a copy of offs in shared memory;
//   * one producer thread keeps a TMA ring of stages in flight on full and
//     empty mbarriers: a stage is 64 routed rows from the group's first
//     row on, the x box (64 rows x 128 of K, two 128-byte panels) and the
//     dY box (64 rows x BN, BN / 64 panels), 128-byte swizzle. The group's
//     last, partial stage comes in boxes of 16 rows, as many as its rows
//     need (deepseek-v2's batch A has ~77 rows an expert: 80 rows read,
//     not 128). A box may run into the next group's rows or past R (TMA
//     reads zeros there);
//   * two consumer warpgroups, 64 of K each, run wgmma m64nBNk16 with the
//     routed rows as the reduction, one a 16 rows: A = x_g^T and B = dY_g,
//     both MN-major in shared memory (the transpose bits of the SS form).
//     A comes straight from the TMA box: the register form would need an
//     ldmatrix.trans of every fragment and registers beside the BN / 2
//     accumulators, for nothing the SS form lacks;
//   * rows outside the group add exactly nothing, whatever they hold (inf
//     or NaN too): where the group ends inside a 16-row step, the
//     consumers zero the step's rows at or past the end in both boxes in
//     shared memory, then fence.proxy.async (wgmma reads through the async
//     proxy) before the product;
//   * the epilogue rounds the accumulator to bf16, widens it to W's dtype
//     and stages it in shared memory in 128-byte swizzled panels (no bank
//     conflict: a warp's accesses cover each bank the fewest times their
//     bytes allow). The consumers then store it in 16-byte stores of whole
//     lines, half of it after each wgmma of the next item is issued and
//     before it is waited for, the rest before the next epilogue: the
//     stores of one item and the products of the next overlap without a
//     second staged tile (the store stream needs the issue slots of many
//     warps: three store warps, or TMA stores, kept it slower). An expert
//     without rows issues no load and no wgmma: its tile goes out as
//     zeros straight from registers;
//   * each output element has one accumulator chain, steps in row order:
//     no atomics and no split of the rows.
//
// fp32 compute (reduced widths only): one CTA per 64 x 64 output tile on
// the CUDA cores with explicit FMAs. fwd and dgrad launch ceil(R / 64) + E
// row tiles (enough for every group's last partial tile), found as above
// from offs in device memory. wgrad launches one CTA per (group, K-tile,
// N-tile) and walks its group's rows in chunks. The loop stages a tile of
// each operand in shared memory (a warp reads consecutive addresses along
// whichever axis is contiguous), then multiplies. Index arithmetic is
// 64-bit where it spans a matrix (deepseek-v2's W holds 1.26e9 values).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 64;  // output tile rows (fwd/dgrad: routed rows; wgrad: K)
constexpr int BN = 64;  // output tile columns

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// The multiply of one 64 x 64 output tile on the CUDA cores (fp32
// compute): 256 threads, 4 x 4 outputs each, explicit FMAs. A staged
// operand tile of BK x 64 lives in shared memory at at(kk, mn), laid out
// [k][mn] so that a thread reads its 4 rows and 4 columns as float4.
struct Core {
  static constexpr int BK = 16, THREADS = 256, LDS = BM + 4;
  static constexpr int SMEM = BK * LDS;
  float acc[4][4];

  __device__ static int at(int kk, int mn) { return kk * LDS + mn; }

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  __device__ void step(const float* As, const float* Bs) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(As + at(kk, ty * 4));
      const float4 b = *reinterpret_cast<const float4*>(Bs + at(kk, tx * 4));
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  template <typename F> __device__ void each(F f) const {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) f(ty * 4 + i, tx * 4 + j, acc[i][j]);
  }
};

// Stage a BK x 64 operand tile into shared memory in fp32: element (kk,
// mn) is src[kk * ld + mn] (K_CONTIG false) or src[mn * ld + kk] (K_CONTIG
// true), widened from TS, zero outside (k_lim, mn_lim). The thread index
// runs fastest along the contiguous axis, so a warp reads consecutive
// addresses.
template <bool K_CONTIG, typename TS>
__device__ __forceinline__ void stage(float* s, const TS* __restrict__ src,
                                      long long ld, int k_lim, int mn_lim) {
  constexpr int KT = Core::BK, MT = 64;
#pragma unroll 4
  for (int i = threadIdx.x; i < KT * MT; i += Core::THREADS) {
    const int kk = K_CONTIG ? i % KT : i / MT;
    const int mn = K_CONTIG ? i / KT : i % MT;
    float v = 0.f;
    if (kk < k_lim && mn < mn_lim)
      v = as_float(src[K_CONTIG ? (long long)mn * ld + kk
                                : (long long)kk * ld + mn]);
    s[Core::at(kk, mn)] = v;
  }
}

__device__ __forceinline__ int clamp_row(int v, long long R) {
  return v < 0 ? 0 : (v > R ? (int)R : v);
}

struct Tile {
  int g, r0, r1;  // group (E: the rows past the last group), rows [r0, r1)
};

// Row tile t of a launch: the groups in order, each cut into ceil(rows /
// bm) tiles, then the rows past offs[E-1] as group E. g = -1 for a surplus
// tile. Warp 0 scans offs (in device or shared memory) 32 groups at a time
// (a warp prefix sum of the tile counts) and stops at the chunk that holds
// t.
__device__ Tile row_tile(const int* __restrict__ offs, int E, long long R,
                         long long t, int bm) {
  __shared__ int s[3];
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    if (lane == 0) s[0] = -1;
    __syncwarp();
    long long before = 0;  // tiles of the groups before the chunk
    for (int e0 = 0; e0 < E && before <= t; e0 += 32) {
      const int e = e0 + lane;
      int start = 0, end = 0;
      if (e < E) {
        start = e ? clamp_row(offs[e - 1], R) : 0;
        end = max(start, clamp_row(offs[e], R));
      }
      const int n = (end - start + bm - 1) / bm;
      int incl = n;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += v;
      }
      const long long first = before + incl - n;
      if (t >= first && t < first + n) {
        s[0] = e;
        s[1] = start + (int)(t - first) * bm;
        s[2] = min(end, s[1] + bm);
      }
      before += __shfl_sync(0xffffffffu, incl, 31);
    }
    __syncwarp();
    if (lane == 0 && s[0] < 0) {
      const int last = E ? clamp_row(offs[E - 1], R) : 0;
      const long long n = (R - last + bm - 1) / bm;
      if (t >= before && t < before + n) {
        s[0] = E;
        s[1] = last + (int)(t - before) * bm;
        s[2] = (int)min(R, (long long)s[1] + bm);
      }
    }
  }
  __syncthreads();
  return {s[0], s[1], s[2]};
}

// fwd (DGRAD false): out (R, nout) = a (R, kin) . W[g], W (E, kin, nout).
// dgrad (DGRAD true): out (R, nout) = a (R, kin) . W[g]^T, W (E, nout, kin).
template <typename TW, bool DGRAD>
__device__ __forceinline__ void rows_body(const float* __restrict__ a,
                                          const TW* __restrict__ w,
                                          const int* __restrict__ offs,
                                          float* __restrict__ out, long long R,
                                          int kin, int nout, int E) {
  __shared__ __align__(16) float As[Core::SMEM];
  __shared__ __align__(16) float Bs[Core::SMEM];
  const Tile tile = row_tile(offs, E, R, blockIdx.x, BM);
  if (tile.g < 0) return;
  const int n0 = blockIdx.y * BN;
  const int rows = tile.r1 - tile.r0, cols = min(BN, nout - n0);
  Core core;
  core.zero();
  if (tile.g < E) {
    const float* a0 = a + (long long)tile.r0 * kin;
    const TW* wg = w + (long long)tile.g * kin * nout;
    for (int k0 = 0; k0 < kin; k0 += Core::BK) {
      const int kl = min(Core::BK, kin - k0);
      stage<true>(As, a0 + k0, kin, kl, rows);
      if (DGRAD)  // (kk, n) = W[g][n0 + n][k0 + kk]
        stage<true>(Bs, wg + (long long)n0 * kin + k0, kin, kl, cols);
      else        // (kk, n) = W[g][k0 + kk][n0 + n]
        stage<false>(Bs, wg + (long long)k0 * nout + n0, nout, kl, cols);
      __syncthreads();
      core.step(As, Bs);
      __syncthreads();
    }
  }
  float* o = out + (long long)tile.r0 * nout + n0;
  core.each([&](int m, int n, float v) {
    if (m < rows && n < cols) o[(long long)m * nout + n] = v;
  });
}

template <typename TW>
__global__ void __launch_bounds__(Core::THREADS)
    grouped_fwd_kernel(const float* __restrict__ a, const TW* __restrict__ w,
                       const int* __restrict__ offs, float* __restrict__ out,
                       long long R, int kin, int nout, int E) {
  rows_body<TW, false>(a, w, offs, out, R, kin, nout, E);
}

template <typename TW>
__global__ void __launch_bounds__(Core::THREADS)
    grouped_dgrad_kernel(const float* __restrict__ a, const TW* __restrict__ w,
                         const int* __restrict__ offs, float* __restrict__ out,
                         long long R, int kin, int nout, int E) {
  rows_body<TW, true>(a, w, offs, out, R, kin, nout, E);
}

// dW[g] (K, N) = x_g^T . dy_g over the group's rows in fp32, stored in TW;
// x (R, K), dy (R, N).
template <typename TW>
__global__ void __launch_bounds__(Core::THREADS)
    grouped_wgrad_kernel(const float* __restrict__ x,
                         const float* __restrict__ dy,
                         const int* __restrict__ offs, TW* __restrict__ dw,
                         long long R, int K, int N, int E) {
  __shared__ __align__(16) float As[Core::SMEM];
  __shared__ __align__(16) float Bs[Core::SMEM];
  const int g = blockIdx.y;
  const int tiles_n = (N + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * BM, n0 = (blockIdx.x % tiles_n) * BN;
  const int rows_k = min(BM, K - m0), cols = min(BN, N - n0);
  const int start = g ? clamp_row(offs[g - 1], R) : 0;
  const int end = max(start, clamp_row(offs[g], R));
  Core core;
  core.zero();
  for (int r = start; r < end; r += Core::BK) {
    const int kl = min(Core::BK, end - r);
    // (kk, m) = x[r + kk][m0 + m]; (kk, n) = dy[r + kk][n0 + n]
    stage<false>(As, x + (long long)r * K + m0, K, kl, rows_k);
    stage<false>(Bs, dy + (long long)r * N + n0, N, kl, cols);
    __syncthreads();
    core.step(As, Bs);
    __syncthreads();
  }
  TW* o = dw + (long long)g * K * N + (long long)m0 * N + n0;
  core.each([&](int m, int n, float v) {
    if (m < rows_k && n < cols) o[(long long)m * N + n] = from_float<TW>(v);
  });
}

template <typename TW>
int launch_rows(const void* a, const void* w, const void* offs, void* out,
                long long R, int kin, int nout, int E, int dgrad,
                cudaStream_t st) {
  const dim3 grid((unsigned)((R + BM - 1) / BM + E),
                  (unsigned)((nout + BN - 1) / BN));
  const dim3 block(Core::THREADS);
  if (dgrad)
    grouped_dgrad_kernel<TW><<<grid, block, 0, st>>>(
        (const float*)a, (const TW*)w, (const int*)offs, (float*)out, R, kin,
        nout, E);
  else
    grouped_fwd_kernel<TW><<<grid, block, 0, st>>>(
        (const float*)a, (const TW*)w, (const int*)offs, (float*)out, R, kin,
        nout, E);
  return (int)cudaGetLastError();
}

template <typename TW>
int launch_wgrad(const void* x, const void* dy, const void* offs, void* dw,
                 long long R, int K, int N, int E, cudaStream_t st) {
  const dim3 grid((unsigned)(((K + BM - 1) / BM) * ((N + BN - 1) / BN)),
                  (unsigned)E);
  grouped_wgrad_kernel<TW><<<grid, Core::THREADS, 0, st>>>(
      (const float*)x, (const float*)dy, (const int*)offs, (TW*)dw, R, K, N,
      E);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 fwd and dgrad: wgmma with the expert weights as the register operand
// ---------------------------------------------------------------------------

constexpr int kTileM = 128;  // W's output columns (fwd) or rows (dgrad) a CTA
constexpr int kStepK = 64;   // the reduction a stage: 128 bytes of a bf16 row
constexpr int kConsumers = 256;  // two consumer warpgroups of 64 of M
// and one producer warpgroup, of which one thread issues the loads: with
// 384 threads the launch gives 168 registers a thread, and setmaxnreg
// moves what the producer frees, 128 x (168 - 24), to the consumers,
// 256 x (240 - 168) (flash_wgmma.cu's split)
constexpr int kThreads = kConsumers + 128;
constexpr int kRingBytes = 200 * 1024;  // the ring's budget of shared memory

// Shared-memory plan of a CTA with row tiles of BR rows and W in TW (bytes
// from a 1024-aligned base). A stage: the W box, kTileM x kStepK values in
// 128-byte panels (fwd: kTileM / PW panels of kStepK rows; dgrad: kStepK /
// PW panels of kTileM rows), then the row box, BR rows of 128 bytes; all
// with the 128-byte swizzle. After the mainloop the ring holds the output
// tile, BR rows of kTileM values padded so that the stores of one warp hit
// distinct banks.
template <int BR, typename TW>
struct RowsPlan {
  static constexpr int PW = 128 / (int)sizeof(TW);  // W values a panel row
  static constexpr int W_TILE = kTileM * kStepK * (int)sizeof(TW);
  static constexpr int STAGE = W_TILE + BR * 128;
  static constexpr int STAGES = kRingBytes / STAGE < 8 ? kRingBytes / STAGE
                                                       : 8;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int OUT16_LD = kTileM + 8;  // bf16 values a staged row
  static constexpr int OUT32_LD = kTileM + 4;  // fp32 partials a staged row
  static constexpr int BYTES = RING + 2 * STAGES * 8 + 1024;  // + mbarriers,
                                                              // alignment
  static_assert(BR % 8 == 0 && BR <= 256, "wgmma takes N = 8 ... 256");
  static_assert(STAGES >= 2 && BR * OUT32_LD * 4 <= RING, "plan");
};

// The W pair (kr, kr + 1) of output m in a stage's W box, rounded to bf16
// and packed (kr even): fwd W[g][k0 + kr][m0 + m], panels of PW columns of
// m and rows kr; dgrad W[g][m0 + m][k0 + kr], panels of PW columns of kr
// and rows m.
template <typename TW, bool DGRAD>
__device__ __forceinline__ uint32_t w_pair(const uint8_t* wt, int m, int kr) {
  constexpr int PW = 128 / (int)sizeof(TW);
  if constexpr (DGRAD) {
    const uint8_t* p = wt + (kr / PW) * (kTileM * 128) +
                       swizzle128(m, (kr % PW) * sizeof(TW));
    if constexpr (sizeof(TW) == 4) {
      const float2 v = *reinterpret_cast<const float2*>(p);
      return pack_bf16(v.x, v.y);
    } else {
      return *reinterpret_cast<const uint32_t*>(p);
    }
  } else {
    const uint8_t* p = wt + (m / PW) * (kStepK * 128);
    const uint32_t c = (m % PW) * sizeof(TW);
    if constexpr (sizeof(TW) == 4) {
      return pack_bf16(*reinterpret_cast<const float*>(p + swizzle128(kr, c)),
                       *reinterpret_cast<const float*>(
                           p + swizzle128(kr + 1, c)));
    } else {
      const uint32_t lo = *reinterpret_cast<const uint16_t*>(
          p + swizzle128(kr, c));
      const uint32_t hi = *reinterpret_cast<const uint16_t*>(
          p + swizzle128(kr + 1, c));
      return lo | (hi << 16);
    }
  }
}

// fwd (DGRAD false): out (R, nout) = a (R, kin) . W[g], W (E, kin, nout).
// dgrad (DGRAD true): out (R, nout) = a (R, kin) . W[g]^T, W (E, nout, kin).
// amap: a as (kin, R, 1, 1), boxes of (kStepK, BR); wmap: W as (N, K, E,
// 1), boxes of (PW, kStepK) (fwd) or (PW, kTileM) (dgrad). CTA c owns row
// tile c / (m_tiles * splits) (the CTAs that share a row box run
// together), then output tile and slice of the reduction. With splits > 1
// it writes its slice's fp32 partial to part (splits, R, nout), else bf16
// to out.
template <int BR, typename TW, bool DGRAD>
__device__ __forceinline__ void wgmma_rows_body(
    const CUtensorMap* amap, const CUtensorMap* wmap,
    const int* __restrict__ offs, bf16* __restrict__ out,
    float* __restrict__ part, long long R, int kin, int nout, int E,
    int splits) {
  using P = RowsPlan<BR, TW>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const sbase = smem_raw + (base - smem_u32(smem_raw));
  const int tid = threadIdx.x;
  const int m_tiles = (nout + kTileM - 1) / kTileM;
  const long long per_tile = (long long)m_tiles * splits;
  const int rest = (int)(blockIdx.x % per_tile);
  const int m0 = (rest % m_tiles) * kTileM, slice = rest / m_tiles;

  // offs into the (still idle) ring in one round trip, then the scan
  int* const soffs = reinterpret_cast<int*>(sbase);
  for (int e = tid; e < E; e += kThreads) soffs[e] = offs[e];
  __syncthreads();
  const Tile tile = row_tile(soffs, E, R, blockIdx.x / per_tile, BR);
  if (tile.g < 0) return;
  const int steps = (kin + kStepK - 1) / kStepK;
  const int per = (steps + splits - 1) / splits;
  const int first = min(steps, slice * per);
  const int n_steps = tile.g < E ? min(steps, first + per) - first : 0;

  const uint32_t full0 = base + P::RING, empty0 = full0 + 8 * P::STAGES;
  if (tid == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers / 32);  // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == kConsumers) {
      for (int i = 0; i < n_steps; ++i) {
        const int s = i % P::STAGES;
        const uint32_t phase = (i / P::STAGES) & 1;
        const int k0 = (first + i) * kStepK;
        const uint32_t full = full0 + 8 * s, wt = base + s * P::STAGE;
        mbar_wait(empty0 + 8 * s, phase ^ 1);  // the stage is free
        mbar_expect_tx(full, P::STAGE);
        if (DGRAD)
          for (int p = 0; p < kStepK / P::PW; ++p)
            tma_load(wt + p * kTileM * 128, wmap, full, k0 + p * P::PW, m0,
                     tile.g, 0);
        else
          for (int p = 0; p < kTileM / P::PW; ++p)
            tma_load(wt + p * kStepK * 128, wmap, full, m0 + p * P::PW, k0,
                     tile.g, 0);
        tma_load(wt + P::W_TILE, amap, full, k0, tile.r0, 0, 0);
      }
    }
    return;
  }

  // consumer warpgroups: warpgroup wg owns outputs 64 wg ... 64 wg + 63 of
  // the tile; this thread's A rows (and accumulator rows) are mr, mr + 8,
  // its accumulator columns (rows of the row tile) 8 i + 2 tig, + 1
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int mr = 64 * (tid >> 7) + 16 * warp + gid;
  float acc[BR / 2];
#pragma unroll
  for (int r = 0; r < BR / 2; ++r) acc[r] = 0.f;
  for (int i = 0; i < n_steps; ++i) {
    const int s = i % P::STAGES;
    mbar_wait(full0 + 8 * s, (i / P::STAGES) & 1);
    __syncwarp();  // wgmma's .aligned forms need the warp converged
    const uint8_t* wt = sbase + s * P::STAGE;
    // A of step kk: register e holds (row mr + 8 (e & 1), reduction
    // 16 kk + 2 tig + 8 (e >> 1) and the one after it)
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        a[kk][e] = w_pair<TW, DGRAD>(wt, mr + 8 * (e & 1),
                                     16 * kk + 2 * tig + 8 * (e >> 1));
    const uint32_t rows_box = base + s * P::STAGE + P::W_TILE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<0>(acc, a[kk], smem_desc(rows_box + 32 * kk, 16, 1024, 1));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(a);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

  // the epilogue: the ring is free once both warpgroups are done with it
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  const int rows = tile.r1 - tile.r0, cols = min(kTileM, nout - m0);
  if (splits == 1) {
    bf16* t = reinterpret_cast<bf16*>(sbase);
#pragma unroll
    for (int r = 0; r < BR / 2; ++r)
      t[(8 * (r >> 2) + 2 * tig + (r & 1)) * P::OUT16_LD + mr +
        8 * ((r >> 1) & 1)] = __float2bfloat16_rn(acc[r]);
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    constexpr int V = kTileM / 8;  // 16-byte vectors a row
    for (int v = tid; v < BR * V; v += kConsumers) {
      const int j = v / V, c = (v % V) * 8;
      if (j < rows && c < cols)
        *reinterpret_cast<uint4*>(out + (long long)(tile.r0 + j) * nout +
                                  m0 + c) =
            *reinterpret_cast<const uint4*>(t + j * P::OUT16_LD + c);
    }
  } else {
    float* t = reinterpret_cast<float*>(sbase);
#pragma unroll
    for (int r = 0; r < BR / 2; ++r)
      t[(8 * (r >> 2) + 2 * tig + (r & 1)) * P::OUT32_LD + mr +
        8 * ((r >> 1) & 1)] = acc[r];
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    constexpr int V = kTileM / 4;
    float* p = part + ((long long)slice * R + tile.r0) * nout + m0;
    for (int v = tid; v < BR * V; v += kConsumers) {
      const int j = v / V, c = (v % V) * 4;
      if (j < rows && c < cols)
        *reinterpret_cast<float4*>(p + (long long)j * nout + c) =
            *reinterpret_cast<const float4*>(t + j * P::OUT32_LD + c);
    }
  }
}

template <int BR, typename TW>
__global__ void __launch_bounds__(kThreads, 1) grouped_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap amap,
    const __grid_constant__ CUtensorMap wmap, const int* __restrict__ offs,
    bf16* __restrict__ out, float* __restrict__ part, long long R, int kin,
    int nout, int E, int splits) {
  wgmma_rows_body<BR, TW, false>(&amap, &wmap, offs, out, part, R, kin, nout,
                                 E, splits);
}

template <int BR, typename TW>
__global__ void __launch_bounds__(kThreads, 1) grouped_dgrad_wgmma_kernel(
    const __grid_constant__ CUtensorMap amap,
    const __grid_constant__ CUtensorMap wmap, const int* __restrict__ offs,
    bf16* __restrict__ out, float* __restrict__ part, long long R, int kin,
    int nout, int E, int splits) {
  wgmma_rows_body<BR, TW, true>(&amap, &wmap, offs, out, part, R, kin, nout,
                                E, splits);
}

// out (n values, n % 4 == 0) = the splits partials of part (splits, n)
// added in slice order, rounded to bf16 once.
__device__ __forceinline__ void split_sum(const float* __restrict__ part,
                                          bf16* __restrict__ out, long long n,
                                          int splits) {
  const long long nv = n / 4;
  for (long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x; v < nv;
       v += (long long)gridDim.x * blockDim.x) {
    float4 s = reinterpret_cast<const float4*>(part)[v];
    for (int k = 1; k < splits; ++k) {
      const float4 p = reinterpret_cast<const float4*>(part + k * n)[v];
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(s.x, s.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(s.z, s.w);
    reinterpret_cast<uint2*>(out)[v] =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                   *reinterpret_cast<const uint32_t*>(&hi));
  }
}

__global__ void grouped_fwd_sum_kernel(const float* __restrict__ part,
                                       bf16* __restrict__ out, long long n,
                                       int splits) {
  split_sum(part, out, n, splits);
}

__global__ void grouped_dgrad_sum_kernel(const float* __restrict__ part,
                                         bf16* __restrict__ out, long long n,
                                         int splits) {
  split_sum(part, out, n, splits);
}

// The map of mats (rows, cols) matrices as the 4-d (cols, rows, mats, 1),
// boxes of (box0, box1, 1, 1), 128-byte swizzle; past an edge reads zero.
CUresult encode_mats(EncodeTiled fn, CUtensorMap* map, const void* ptr,
                     CUtensorMapDataType type, int elem, long long cols,
                     long long rows, long long mats, int box0, int box1) {
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)mats, 1};
  const cuuint64_t strides[3] = {(cuuint64_t)(cols * elem),
                                 (cuuint64_t)(cols * rows * elem),
                                 (cuuint64_t)(cols * rows * mats * elem)};
  const cuuint32_t box[4] = {(cuuint32_t)box0, (cuuint32_t)box1, 1, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box, one,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int BR, typename TW>
int launch_wgmma(const void* a, const void* w, const void* offs, void* out,
                 void* part, long long R, int kin, int nout, int E, int dgrad,
                 int splits, cudaStream_t st) {
  using P = RowsPlan<BR, TW>;
  if (R == 0) return 0;  // no row, nothing to write
  // row tiles: every tile holds a row, and E groups and the tail cut R
  // rows into at most ceil(R / BR) + E tiles
  const long long tiles = (R + BR - 1) / BR + E < R ? (R + BR - 1) / BR + E
                                                     : R;
  const long long ctas =
      (long long)((nout + kTileM - 1) / kTileM) * splits * tiles;
  if (splits < 1 || (splits > 1 && part == nullptr) || 4LL * E > P::RING ||
      ctas > INT_MAX)
    return (int)cudaErrorInvalidValue;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap amap, wmap;
  CUresult res = encode_mats(fn, &amap, a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                             2, kin, R, 1, kStepK, BR);
  // W (E, K, N): fwd K = kin, N = nout; dgrad K = nout, N = kin
  if (res == CUDA_SUCCESS)
    res = encode_mats(fn, &wmap, w,
                      sizeof(TW) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                      (int)sizeof(TW), dgrad ? kin : nout,
                      dgrad ? nout : kin, E, P::PW, dgrad ? kTileM : kStepK);
  if (res != CUDA_SUCCESS) return kEncodeFailed + (int)res;
  auto kernel = dgrad ? grouped_dgrad_wgmma_kernel<BR, TW>
                      : grouped_fwd_wgmma_kernel<BR, TW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)ctas, kThreads, P::BYTES, st>>>(
      amap, wmap, (const int*)offs, (bf16*)out, (float*)part, R, kin, nout, E,
      splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long n = R * nout;
  const long long blocks = (n / 4 + 255) / 256;
  const unsigned grid = (unsigned)(blocks < 132 * 16 ? blocks : 132 * 16);
  if (dgrad)
    grouped_dgrad_sum_kernel<<<grid, 256, 0, st>>>((const float*)part,
                                                   (bf16*)out, n, splits);
  else
    grouped_fwd_sum_kernel<<<grid, 256, 0, st>>>((const float*)part,
                                                 (bf16*)out, n, splits);
  return (int)cudaGetLastError();
}

// The row tile widths that the bf16 kernels are built for (rows_plan in
// kernels/grouped_mm.py picks among them).
#define GROUPED_ROW_TILES(X) X(8) X(16) X(32) X(64) X(128) X(256)

template <typename TW>
int launch_wgmma_br(int br, const void* a, const void* w, const void* offs,
                    void* out, void* part, long long R, int kin, int nout,
                    int E, int dgrad, int splits, cudaStream_t st) {
  switch (br) {
#define CASE(B)                                                            \
  case B:                                                                  \
    return launch_wgmma<B, TW>(a, w, offs, out, part, R, kin, nout, E,     \
                               dgrad, splits, st);
    GROUPED_ROW_TILES(CASE)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename TW>
int plan_of(int br, int stages) {
  switch (br) {
#define CASE(B) \
  case B:       \
    return stages ? RowsPlan<B, TW>::STAGES : RowsPlan<B, TW>::BYTES;
    GROUPED_ROW_TILES(CASE)
#undef CASE
    default:
      return -1;
  }
}

// ---------------------------------------------------------------------------
// bf16 wgrad: wgmma with the routed rows as the reduction
// ---------------------------------------------------------------------------

constexpr int kWgradTileK = 128;  // dW rows (of K) an item: two warpgroups
constexpr int kWgradStep = 64;    // routed rows a stage of the ring
constexpr int kWgradSub = 16;     // rows a box of a group's partial stage
constexpr int kPanel = 64 * 128;  // one swizzled box: 64 rows of 128 bytes
static_assert(kWgradSub == 16, "a partial stage's box is one wgmma step");

// Shared-memory plan of a wgrad CTA with dW tiles of kWgradTileK x BN in TW
// (bytes from a 1024-aligned base): the staged dW tile, a 64 x BN half a
// consumer warpgroup, in panels of 64 rows x PO values; the ring, each
// stage the x box (two panels: 64 rows x 128 of K) and the dY box (BN / 64
// panels: 64 rows x BN); the full and empty mbarriers; the copy of offs.
// Every panel has the 128-byte swizzle. wgrad_smem in kernels/grouped_mm.py
// repeats bytes().
template <int BN, typename TW>
struct WgradPlan {
  static constexpr int PO = 128 / (int)sizeof(TW);  // dW values a panel row
  static constexpr int OUT_WG = 64 * BN * (int)sizeof(TW);
  static constexpr int RING = 2 * OUT_WG;  // where the ring starts
  static constexpr int X_BOX = 2 * kPanel;
  static constexpr int STAGE = X_BOX + (BN / 64) * kPanel;
  static constexpr int PANELS = STAGE / kPanel;
  static constexpr long long bytes(int stages, int E) {
    return 1024LL + RING + (long long)stages * (STAGE + 16) + 4LL * E;
  }
  static_assert(BN == 128 || BN == 256, "the dW tile widths");
};

// The (expert, first dW row, first dW column, first routed row, row past
// the last) of work item t.
struct WgradItem {
  int g, k0, n0, start, end;
};

__device__ __forceinline__ WgradItem wgrad_item(const int* soffs, long long R,
                                                int t, int k_tiles,
                                                int n_tiles, int bn) {
  const int per_g = k_tiles * n_tiles, rest = t % per_g;
  WgradItem it;
  it.g = t / per_g;
  it.k0 = (rest / n_tiles) * kWgradTileK;
  it.n0 = (rest % n_tiles) * bn;
  it.start = it.g ? clamp_row(soffs[it.g - 1], R) : 0;
  it.end = max(it.start, clamp_row(soffs[it.g], R));
  return it;
}

// The routed rows of a stage from row r of a group that ends at row end:
// a whole stage of kWgradStep, or the last, partial one in ceil(valid /
// kWgradSub) boxes of kWgradSub rows (wgmma steps of 16).
__device__ __forceinline__ int wgrad_steps(int r, int end) {
  const int valid = end - r;
  return valid >= kWgradStep ? kWgradStep / 16
                             : (valid + kWgradSub - 1) / kWgradSub;
}

// A consumer warpgroup's 64 x BN half of an item's dW tile on its way out:
// 16-byte vectors of whole lines, vector j of this thread (0 <= j < J) at
// v = wtid + 128 j, row v / V, columns (v % V) VW ... + VW - 1 (a warp
// writes 512 contiguous bytes), read from the staged half or zero.
template <int BN, typename TW>
struct WgradOut {
  static constexpr int V = BN * (int)sizeof(TW) / 16;  // vectors a row
  static constexpr int VW = 16 / (int)sizeof(TW);      // dW values a vector
  static constexpr int J = 64 * V / 128;               // vectors a thread
  const uint8_t* staged;
  TW* o;  // the half's first element in dW
  int rows, cols, next;

  __device__ void begin(const uint8_t* s, TW* dw, const WgradItem& it,
                        int k0, int K, int N) {
    staged = s;
    o = dw + ((long long)it.g * K + k0) * N + it.n0;
    rows = min(64, K - k0);
    cols = min(BN, N - it.n0);
    next = 0;
  }

  // Store this thread's vectors next ... upto - 1 (zeros when zero).
  __device__ void put(int upto, int wtid, int N, bool zero = false) {
    using P = WgradPlan<BN, TW>;
    for (; next < min(upto, J); ++next) {
      const int v = wtid + 128 * next, row = v / V, col = (v % V) * VW;
      if (row < rows && col < cols) {
        uint4 val = make_uint4(0, 0, 0, 0);
        if (!zero)
          val = *reinterpret_cast<const uint4*>(
              staged + (col / P::PO) * kPanel +
              swizzle128(row, (col % P::PO) * (int)sizeof(TW)));
        *reinterpret_cast<uint4*>(o + (long long)row * N + col) = val;
      }
    }
  }
};

// dW[g] (K, N) = x_g^T . dy_g, rounded to bf16, stored in TW (see the
// header). xmap, xmap16: x as (K, R, 1, 1), boxes of (64, 64) and (64,
// 16); dymap, dymap16: dy as (N, R, 1, 1), the same boxes. Item t is
// expert t / (k_tiles n_tiles), then K tile, then N tile.
template <int BN, typename TW>
__global__ void __launch_bounds__(kThreads, 1) grouped_wgrad_wgmma_kernel(
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap xmap16,
    const __grid_constant__ CUtensorMap dymap,
    const __grid_constant__ CUtensorMap dymap16, const int* __restrict__ offs,
    TW* __restrict__ dw, long long R, int K, int N, int E, int stages) {
  using P = WgradPlan<BN, TW>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const sbase = smem_raw + (base - smem_u32(smem_raw));
  const int tid = threadIdx.x;
  const uint32_t ring = base + P::RING;
  const uint32_t full0 = ring + stages * P::STAGE, empty0 = full0 + 8 * stages;
  int* const soffs =
      reinterpret_cast<int*>(sbase + P::RING + stages * (P::STAGE + 16));
  const int k_tiles = (K + kWgradTileK - 1) / kWgradTileK;
  const int n_tiles = (N + BN - 1) / BN;
  const int items = E * k_tiles * n_tiles;

  for (int e = tid; e < E; e += kThreads) soffs[e] = offs[e];
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers / 32);  // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warpgroup: one thread keeps the ring full, item after item
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == kConsumers) {
      uint32_t i = 0;
      for (int t = blockIdx.x; t < items; t += gridDim.x) {
        const WgradItem it = wgrad_item(soffs, R, t, k_tiles, n_tiles, BN);
        for (int r = it.start; r < it.end; r += kWgradStep, ++i) {
          const uint32_t s = i % stages, phase = (i / stages) & 1;
          const uint32_t full = full0 + 8 * s, st = ring + s * P::STAGE;
          const int steps = wgrad_steps(r, it.end);
          mbar_wait(empty0 + 8 * s, phase ^ 1);  // the stage is free
          mbar_expect_tx(full, P::PANELS * kWgradSub * 128 * steps);
          if (steps == kWgradStep / 16) {
            for (int p = 0; p < 2; ++p)
              tma_load(st + p * kPanel, &xmap, full, it.k0 + 64 * p, r, 0,
                       0);
            for (int p = 0; p < BN / 64; ++p)
              tma_load(st + P::X_BOX + p * kPanel, &dymap, full,
                       it.n0 + 64 * p, r, 0, 0);
          } else {
            for (int j = 0; j < steps; ++j) {
              const int rj = r + kWgradSub * j;
              const uint32_t sj = st + kWgradSub * 128 * j;
              for (int p = 0; p < 2; ++p)
                tma_load(sj + p * kPanel, &xmap16, full, it.k0 + 64 * p, rj,
                         0, 0);
              for (int p = 0; p < BN / 64; ++p)
                tma_load(sj + P::X_BOX + p * kPanel, &dymap16, full,
                         it.n0 + 64 * p, rj, 0, 0);
            }
          }
        }
      }
    }
    return;
  }

  // consumer warpgroups: warpgroup wg owns dW rows k0 + 64 wg ... + 63 of
  // an item; this thread's accumulator rows are m and m + 8 of them, its
  // columns 8 j + 2 tig and the one after it
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = tid >> 7, wtid = tid & 127;
  const int lane = tid & 31, tig = lane & 3;
  const int m = 16 * (wtid >> 5) + (lane >> 2);
  uint8_t* const out_s = sbase + wg * P::OUT_WG;
  using Out = WgradOut<BN, TW>;
  Out staged;  // the last item with rows: its staged half, still going out
  staged.next = Out::J;
  float acc[BN / 2];
  uint32_t i = 0;
  for (int t = blockIdx.x; t < items; t += gridDim.x) {
    const WgradItem it = wgrad_item(soffs, R, t, k_tiles, n_tiles, BN);
    if (it.end == it.start) {  // no rows: no load, no product, zeros out
      Out zero;
      zero.begin(out_s, dw, it, it.k0 + 64 * wg, K, N);
      zero.put(Out::J, wtid, N, true);
      continue;
    }
#pragma unroll
    for (int r = 0; r < BN / 2; ++r) acc[r] = 0.f;
    for (int r = it.start; r < it.end; r += kWgradStep, ++i) {
      const uint32_t s = i % stages;
      const uint32_t st = ring + s * P::STAGE;
      mbar_wait(full0 + 8 * s, (i / stages) & 1);
      const int valid = it.end - r, steps = wgrad_steps(r, it.end);
      if (valid < kWgradSub * steps) {
        // the group's last step: rows at or past its end (the next
        // group's, rows of no group, zeros past R) add exactly nothing,
        // whatever they hold
        uint8_t* const p0 = sbase + P::RING + s * P::STAGE + valid * 128;
        const int chunks = (kWgradSub * steps - valid) * 8;  // 16 B each
        for (int c = tid; c < P::PANELS * chunks; c += kConsumers)
          *reinterpret_cast<uint4*>(p0 + (c / chunks) * kPanel +
                                    (c % chunks) * 16) = make_uint4(0, 0, 0,
                                                                    0);
        fence_proxy_async();
        asm volatile("bar.sync 3, 256;\n" ::: "memory");
      }
      __syncwarp();  // wgmma's .aligned forms need the warp converged
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // 16 routed rows a step
        if (kk < steps)
          wgmma_ss_mn(
              acc, smem_desc(st + wg * kPanel + kk * 2048, kPanel, 1024, 1),
              smem_desc(st + P::X_BOX + kk * 2048, kPanel, 1024, 1));
      wgmma_commit();
      // while the products run: half the last item's stores
      staged.put(staged.next + Out::J / 2, wtid, N);
      wgmma_wait_all();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }

    // the epilogue: the last item's stores done, bf16, then TW, into this
    // warpgroup's staged half; its stores go out during the next item's
    // products
    staged.put(Out::J, wtid, N);
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
#pragma unroll
    for (int r = 0; r < BN / 2; r += 2) {
      const int row = m + 8 * ((r >> 1) & 1), col = 8 * (r >> 2) + 2 * tig;
      const uint32_t pb = pack_bf16(acc[r], acc[r + 1]);
      uint8_t* const dst = out_s + (col / P::PO) * kPanel +
                           swizzle128(row, (col % P::PO) * (int)sizeof(TW));
      if constexpr (sizeof(TW) == 4)
        *reinterpret_cast<float2*>(dst) = make_float2(
            __uint_as_float(pb << 16), __uint_as_float(pb & 0xffff0000u));
      else
        *reinterpret_cast<uint32_t*>(dst) = pb;
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    staged.begin(out_s, dw, it, it.k0 + 64 * wg, K, N);
  }
  staged.put(Out::J, wtid, N);
}

template <int BN, typename TW>
int launch_wgrad_wgmma(const void* x, const void* dy, const void* offs,
                       void* dw, long long R, int K, int N, int E, int stages,
                       int ctas, cudaStream_t st) {
  using P = WgradPlan<BN, TW>;
  const long long items = (long long)E * ((K + kWgradTileK - 1) / kWgradTileK) *
                          ((N + BN - 1) / BN);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const long long bytes = P::bytes(stages, E);
  if (stages < 2 || ctas < 1 || items > INT_MAX || bytes > optin)
    return (int)cudaErrorInvalidValue;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  // no row: no load, no map of x or dy (TMA takes no empty tensor)
  CUtensorMap maps[4];
  memset(maps, 0, sizeof maps);
  CUresult res = CUDA_SUCCESS;
  for (int m = 0; m < 4 && R > 0 && res == CUDA_SUCCESS; ++m)
    res = encode_mats(fn, &maps[m], m < 2 ? x : dy,
                      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, m < 2 ? K : N, R,
                      1, 64, m % 2 ? kWgradSub : kWgradStep);
  if (res != CUDA_SUCCESS) return kEncodeFailed + (int)res;
  auto kernel = grouped_wgrad_wgmma_kernel<BN, TW>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)(ctas < items ? ctas : items), kThreads, (size_t)bytes,
           st>>>(maps[0], maps[1], maps[2], maps[3], (const int*)offs,
                 (TW*)dw, R, K, N, E, stages);
  return (int)cudaGetLastError();
}

// The dW tile widths that the bf16 wgrad kernel is built for (wgrad_plan
// in kernels/grouped_mm.py picks one).
#define GROUPED_WGRAD_TILES(X) X(128) X(256)

template <typename TW>
int launch_wgrad_bn(int bn, const void* x, const void* dy, const void* offs,
                    void* dw, long long R, int K, int N, int E, int stages,
                    int ctas, cudaStream_t st) {
  switch (bn) {
#define CASE(B)                                                           \
  case B:                                                                 \
    return launch_wgrad_wgmma<B, TW>(x, dy, offs, dw, R, K, N, E, stages, \
                                     ctas, st);
    GROUPED_WGRAD_TILES(CASE)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename TW>
long long wgrad_bytes(int bn, int stages, int E) {
  switch (bn) {
#define CASE(B) \
  case B:       \
    return WgradPlan<B, TW>::bytes(stages, E);
    GROUPED_WGRAD_TILES(CASE)
#undef CASE
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// fwd (dgrad 0): out (R, nout) = a (R, kin) . W[g(r)], W (E, kin, nout);
// dgrad (dgrad 1): out (R, nout) = a (R, kin) . W[g(r)]^T, W (E, nout, kin).
// a and out in the compute dtype (bf16 when x_bf16), W fp32 or bf16
// (w_bf16); offs (E,) int32 cumulative row ends. bf16 compute takes the
// wgmma kernels with row tiles of br rows and the reduction in splits
// slices (part: an fp32 (splits, R, nout) workspace when splits > 1); a,
// W 16-byte aligned. fp32 compute takes the CUDA-core kernels (br, splits
// and part unused). Returns a cudaError_t, or 10000 + the CUresult of a
// tensor map that failed to encode.
int grouped_mm_rows(const void* a, const void* w, const void* offs, void* out,
                    void* part, long long R, int kin, int nout, int E,
                    int x_bf16, int w_bf16, int dgrad, int br, int splits,
                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (x_bf16)
    return w_bf16 ? launch_wgmma_br<bf16>(br, a, w, offs, out, part, R, kin,
                                          nout, E, dgrad, splits, st)
                  : launch_wgmma_br<float>(br, a, w, offs, out, part, R, kin,
                                           nout, E, dgrad, splits, st);
  return w_bf16 ? launch_rows<bf16>(a, w, offs, out, R, kin, nout, E, dgrad,
                                    st)
                : launch_rows<float>(a, w, offs, out, R, kin, nout, E, dgrad,
                                     st);
}

// The ring's stages (stages 1) or the dynamic shared memory of a CTA in
// bytes (stages 0) of the bf16 kernels at row tile br and W in bf16
// (w_bf16) or fp32; -1 for a br they are not built for.
int grouped_rows_plan(int br, int w_bf16, int stages) {
  return w_bf16 ? plan_of<bf16>(br, stages) : plan_of<float>(br, stages);
}

// dW (E, K, N) in W's dtype (w_bf16) = x_g^T . dy_g, rounded to the compute
// dtype first; x (R, K) and dy (R, N) in the compute dtype (x_bf16). bf16
// compute takes the wgmma kernel with dW tiles of 128 x bn, a ring of
// stages and ctas persistent CTAs (x, dy 16-byte aligned); fp32 compute
// the CUDA-core kernel (bn, stages and ctas unused). Returns a cudaError_t,
// or 10000 + the CUresult of a tensor map that failed to encode.
int grouped_mm_wgrad(const void* x, const void* dy, const void* offs,
                     void* dw, long long R, int K, int N, int E, int x_bf16,
                     int w_bf16, int bn, int stages, int ctas, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (x_bf16)
    return w_bf16 ? launch_wgrad_bn<bf16>(bn, x, dy, offs, dw, R, K, N, E,
                                          stages, ctas, st)
                  : launch_wgrad_bn<float>(bn, x, dy, offs, dw, R, K, N, E,
                                           stages, ctas, st);
  return w_bf16 ? launch_wgrad<bf16>(x, dy, offs, dw, R, K, N, E, st)
                : launch_wgrad<float>(x, dy, offs, dw, R, K, N, E, st);
}

// The dynamic shared memory of a bf16 wgrad CTA in bytes at dW tile width
// bn, W in bf16 (w_bf16) or fp32, the ring's stages and E experts; -1 for a
// bn it is not built for, or a size past INT_MAX.
int grouped_wgrad_plan(int bn, int w_bf16, int stages, int E) {
  const long long b = w_bf16 ? wgrad_bytes<bf16>(bn, stages, E)
                             : wgrad_bytes<float>(bn, stages, E);
  return b > INT_MAX ? -1 : (int)b;
}

}  // extern "C"
