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
//   wgrad  dW[g] = X_g^T . dY_g        grouped_wgrad_kernel
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
// fp32 fwd and dgrad (reduced widths only) and wgrad: one CTA per 64 x 64
// output tile. fwd and dgrad launch ceil(R / 64) + E row tiles (enough for
// every group's last partial tile), found as above from offs in device
// memory. wgrad launches one CTA per (group, K-tile, N-tile) and walks its
// group's rows in chunks. The loop stages a tile of each operand in shared
// memory (a warp reads consecutive addresses along whichever axis is
// contiguous), then multiplies; bf16 wgrad on mma.sync m16n8k16. Index
// arithmetic is 64-bit where it spans a matrix (deepseek-v2's W holds
// 1.26e9 values).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

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

// The multiply of one 64 x 64 output tile, by compute dtype. A staged
// operand tile of KT x 64 lives in shared memory at at(kk, mn).
template <typename TC> struct Core;

// fp32: 256 threads, 4 x 4 outputs each, FMAs on the CUDA cores; tiles laid
// out [k][mn] so that a thread reads its 4 rows and 4 columns as float4.
template <> struct Core<float> {
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

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// bf16: 4 warps in a 2 x 2 grid, 32 x 32 outputs each as 2 x 4 mma.sync
// m16n8k16 tiles with fp32 accumulators; tiles laid out [mn][k] (k
// contiguous, rows padded to 40 values: the fragment loads hit 32 banks).
template <> struct Core<bf16> {
  static constexpr int BK = 32, THREADS = 128, LDS = BK + 8;
  static constexpr int SMEM = BM * LDS;
  float acc[2][4][4];

  __device__ static int at(int kk, int mn) { return mn * LDS + kk; }

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
  }

  __device__ void step(const bf16* As, const bf16* Bs) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp / 2, wn = warp % 2, gid = lane / 4, tig = lane % 4;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm * 32 + mi * 16 + gid;
        a[mi][0] = ld32(As + at(ks + tig * 2, r));
        a[mi][1] = ld32(As + at(ks + tig * 2, r + 8));
        a[mi][2] = ld32(As + at(ks + tig * 2 + 8, r));
        a[mi][3] = ld32(As + at(ks + tig * 2 + 8, r + 8));
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = wn * 32 + ni * 8 + gid;
        b[ni][0] = ld32(Bs + at(ks + tig * 2, c));
        b[ni][1] = ld32(Bs + at(ks + tig * 2 + 8, c));
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          float* d = acc[mi][ni];
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
              "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
              "{%0, %1, %2, %3};\n"
              : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
              : "r"(a[mi][0]), "r"(a[mi][1]), "r"(a[mi][2]), "r"(a[mi][3]),
                "r"(b[ni][0]), "r"(b[ni][1]));
        }
    }
  }

  template <typename F> __device__ void each(F f) const {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp / 2, wn = warp % 2, gid = lane / 4, tig = lane % 4;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          f(wm * 32 + mi * 16 + gid + (c >= 2 ? 8 : 0),
            wn * 32 + ni * 8 + tig * 2 + (c & 1), acc[mi][ni][c]);
  }
};

// Stage a KT x MT operand tile into shared memory in the compute dtype:
// element (kk, mn) is src[kk * ld + mn] (K_CONTIG false) or src[mn * ld +
// kk] (K_CONTIG true), zero outside (k_lim, mn_lim). The thread index runs
// fastest along the contiguous axis, so a warp reads consecutive addresses.
template <typename TC, int KT, int MT, bool K_CONTIG, typename TS>
__device__ __forceinline__ void stage(TC* s, const TS* __restrict__ src,
                                      long long ld, int k_lim, int mn_lim) {
#pragma unroll 4
  for (int i = threadIdx.x; i < KT * MT; i += Core<TC>::THREADS) {
    const int kk = K_CONTIG ? i % KT : i / MT;
    const int mn = K_CONTIG ? i / KT : i % MT;
    float v = 0.f;
    if (kk < k_lim && mn < mn_lim)
      v = as_float(src[K_CONTIG ? (long long)mn * ld + kk
                                : (long long)kk * ld + mn]);
    s[Core<TC>::at(kk, mn)] = from_float<TC>(v);
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
template <typename TC, typename TW, bool DGRAD>
__device__ __forceinline__ void rows_body(const TC* __restrict__ a,
                                          const TW* __restrict__ w,
                                          const int* __restrict__ offs,
                                          TC* __restrict__ out, long long R,
                                          int kin, int nout, int E) {
  using C = Core<TC>;
  __shared__ __align__(16) TC As[C::SMEM];
  __shared__ __align__(16) TC Bs[C::SMEM];
  const Tile tile = row_tile(offs, E, R, blockIdx.x, BM);
  if (tile.g < 0) return;
  const int n0 = blockIdx.y * BN;
  const int rows = tile.r1 - tile.r0, cols = min(BN, nout - n0);
  C core;
  core.zero();
  if (tile.g < E) {
    const TC* a0 = a + (long long)tile.r0 * kin;
    const TW* wg = w + (long long)tile.g * kin * nout;
    for (int k0 = 0; k0 < kin; k0 += C::BK) {
      const int kl = min(C::BK, kin - k0);
      stage<TC, C::BK, BM, true>(As, a0 + k0, kin, kl, rows);
      if (DGRAD)  // (kk, n) = W[g][n0 + n][k0 + kk]
        stage<TC, C::BK, BN, true>(Bs, wg + (long long)n0 * kin + k0, kin,
                                   kl, cols);
      else        // (kk, n) = W[g][k0 + kk][n0 + n]
        stage<TC, C::BK, BN, false>(Bs, wg + (long long)k0 * nout + n0,
                                    nout, kl, cols);
      __syncthreads();
      core.step(As, Bs);
      __syncthreads();
    }
  }
  TC* o = out + (long long)tile.r0 * nout + n0;
  core.each([&](int m, int n, float v) {
    if (m < rows && n < cols) o[(long long)m * nout + n] = from_float<TC>(v);
  });
}

template <typename TC, typename TW>
__global__ void __launch_bounds__(Core<TC>::THREADS)
    grouped_fwd_kernel(const TC* __restrict__ a, const TW* __restrict__ w,
                       const int* __restrict__ offs, TC* __restrict__ out,
                       long long R, int kin, int nout, int E) {
  rows_body<TC, TW, false>(a, w, offs, out, R, kin, nout, E);
}

template <typename TC, typename TW>
__global__ void __launch_bounds__(Core<TC>::THREADS)
    grouped_dgrad_kernel(const TC* __restrict__ a, const TW* __restrict__ w,
                         const int* __restrict__ offs, TC* __restrict__ out,
                         long long R, int kin, int nout, int E) {
  rows_body<TC, TW, true>(a, w, offs, out, R, kin, nout, E);
}

// dW[g] (K, N) = x_g^T . dy_g over the group's rows; x (R, K), dy (R, N).
template <typename TC, typename TW>
__global__ void __launch_bounds__(Core<TC>::THREADS)
    grouped_wgrad_kernel(const TC* __restrict__ x, const TC* __restrict__ dy,
                         const int* __restrict__ offs, TW* __restrict__ dw,
                         long long R, int K, int N, int E) {
  using C = Core<TC>;
  __shared__ __align__(16) TC As[C::SMEM];
  __shared__ __align__(16) TC Bs[C::SMEM];
  const int g = blockIdx.y;
  const int tiles_n = (N + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * BM, n0 = (blockIdx.x % tiles_n) * BN;
  const int rows_k = min(BM, K - m0), cols = min(BN, N - n0);
  const int start = g ? clamp_row(offs[g - 1], R) : 0;
  const int end = max(start, clamp_row(offs[g], R));
  C core;
  core.zero();
  for (int r = start; r < end; r += C::BK) {
    const int kl = min(C::BK, end - r);
    // (kk, m) = x[r + kk][m0 + m]; (kk, n) = dy[r + kk][n0 + n]
    stage<TC, C::BK, BM, false>(As, x + (long long)r * K + m0, K, kl, rows_k);
    stage<TC, C::BK, BN, false>(Bs, dy + (long long)r * N + n0, N, kl, cols);
    __syncthreads();
    core.step(As, Bs);
    __syncthreads();
  }
  TW* o = dw + (long long)g * K * N + (long long)m0 * N + n0;
  core.each([&](int m, int n, float v) {
    if (m < rows_k && n < cols)
      o[(long long)m * N + n] = from_float<TW>(as_float(from_float<TC>(v)));
  });
}

template <typename TC, typename TW>
int launch_rows(const void* a, const void* w, const void* offs, void* out,
                long long R, int kin, int nout, int E, int dgrad,
                cudaStream_t st) {
  const dim3 grid((unsigned)((R + BM - 1) / BM + E),
                  (unsigned)((nout + BN - 1) / BN));
  const dim3 block(Core<TC>::THREADS);
  if (dgrad)
    grouped_dgrad_kernel<TC, TW><<<grid, block, 0, st>>>(
        (const TC*)a, (const TW*)w, (const int*)offs, (TC*)out, R, kin, nout,
        E);
  else
    grouped_fwd_kernel<TC, TW><<<grid, block, 0, st>>>(
        (const TC*)a, (const TW*)w, (const int*)offs, (TC*)out, R, kin, nout,
        E);
  return (int)cudaGetLastError();
}

template <typename TC, typename TW>
int launch_wgrad(const void* x, const void* dy, const void* offs, void* dw,
                 long long R, int K, int N, int E, cudaStream_t st) {
  const dim3 grid((unsigned)(((K + BM - 1) / BM) * ((N + BN - 1) / BN)),
                  (unsigned)E);
  grouped_wgrad_kernel<TC, TW><<<grid, Core<TC>::THREADS, 0, st>>>(
      (const TC*)x, (const TC*)dy, (const int*)offs, (TW*)dw, R, K, N, E);
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
  return w_bf16 ? launch_rows<float, bf16>(a, w, offs, out, R, kin, nout, E,
                                           dgrad, st)
                : launch_rows<float, float>(a, w, offs, out, R, kin, nout, E,
                                            dgrad, st);
}

// The ring's stages (stages 1) or the dynamic shared memory of a CTA in
// bytes (stages 0) of the bf16 kernels at row tile br and W in bf16
// (w_bf16) or fp32; -1 for a br they are not built for.
int grouped_rows_plan(int br, int w_bf16, int stages) {
  return w_bf16 ? plan_of<bf16>(br, stages) : plan_of<float>(br, stages);
}

// dW (E, K, N) in W's dtype (w_bf16) = x_g^T . dy_g, rounded to the compute
// dtype first; x (R, K) and dy (R, N) in the compute dtype (x_bf16).
int grouped_mm_wgrad(const void* x, const void* dy, const void* offs,
                     void* dw, long long R, int K, int N, int E, int x_bf16,
                     int w_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (x_bf16)
    return w_bf16 ? launch_wgrad<bf16, bf16>(x, dy, offs, dw, R, K, N, E, st)
                  : launch_wgrad<bf16, float>(x, dy, offs, dw, R, K, N, E, st);
  return w_bf16 ? launch_wgrad<float, bf16>(x, dy, offs, dw, R, K, N, E, st)
                : launch_wgrad<float, float>(x, dy, offs, dw, R, K, N, E, st);
}

}  // extern "C"
