// Grouped matrix products over rows sorted by group, for Hopper (sm_90a):
// the experts of a Mixture-of-Experts layer (models/moe.py).
//
// It replaces no Pallas kernel: the reference computes the experts with
// jax.lax.ragged_dot (src/repro/models/moe.py, _moe_ragged), which XLA
// lowers itself. The port's grouped product has to read its group
// boundaries on the device, so that a round which routes tokens can be
// captured in a CUDA graph, and it needs a backward of its own:
//
//   grouped_fwd_kernel    fwd    Y[r]  = X[r] . W[g(r)]
//   grouped_dgrad_kernel  dgrad  dX[r] = dY[r] . W[g(r)]^T
//   grouped_wgrad_kernel  wgrad  dW[g] = X_g^T . dY_g
//
// over R rows sorted by group, X (R, K), W (E, K, N), Y (R, N); offs (E,)
// int32 holds the groups' cumulative row ends and is read on the device.
// Rows past offs[E-1] belong to no group: fwd and dgrad write them zero, as
// ragged_dot does. An expert with no row gets dW zero.
//
// Numbers. X and dY come in the compute dtype (fp32 or bf16), W in its
// stored dtype (fp32 or bf16). Each W value is rounded to the compute dtype
// as its tile is loaded (round to nearest even: the values of
// w.to(x.dtype), without casting the whole W). Sums run in fp32. fp32 runs
// on the CUDA cores with explicit FMAs (no TF32); bf16 on the tensor cores
// with mma.sync m16n8k16. Y and dX are stored in the compute dtype; dW is
// rounded to the compute dtype, then stored in W's dtype (the backward of
// the cast). Every output element is one CTA's sum over its reduction in a
// fixed order: no atomics, so reruns are bit-identical and a captured
// replay equals its eager run.
//
// Design. One CTA computes a 64 x 64 output tile. fwd and dgrad launch
// ceil(R / 64) + E row tiles (enough for every group's last partial tile):
// warp 0 of each CTA scans offs in chunks of 32 groups with a warp prefix
// sum of the groups' tile counts to find its (group, first row); surplus
// CTAs exit. No host read. wgrad launches one CTA per (group, K-tile,
// N-tile); it walks its group's rows in chunks. The loop stages a tile of
// each operand in shared memory (a warp reads consecutive addresses along
// whichever axis is contiguous), then multiplies. Index arithmetic is 64-bit
// where it spans a matrix (deepseek-v2's W holds 1.26e9 values).
//
// Bound. The MoE's fp32 expert weights: a deepseek-v2 prefill of 4 x 512
// tokens (12,288 routed rows) reads 15.1 GB of them per layer against
// 0.58 TFLOP, so the products are bound by the bytes of W. The design reads
// W once per row tile of its group, rounds it in registers, and never
// writes a cast copy. A simple kernel first: no TMA, no wgmma, no
// pipelining of the staged tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// BM) tiles, then the rows past offs[E-1] as group E. g = -1 for a surplus
// tile. Warp 0 scans offs 32 groups at a time (a warp prefix sum of the
// tile counts) and stops at the chunk that holds t.
__device__ Tile row_tile(const int* __restrict__ offs, int E, long long R,
                         long long t) {
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
      const int n = (end - start + BM - 1) / BM;
      int incl = n;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += v;
      }
      const long long first = before + incl - n;
      if (t >= first && t < first + n) {
        s[0] = e;
        s[1] = start + (int)(t - first) * BM;
        s[2] = min(end, s[1] + BM);
      }
      before += __shfl_sync(0xffffffffu, incl, 31);
    }
    __syncwarp();
    if (lane == 0 && s[0] < 0) {
      const int last = E ? clamp_row(offs[E - 1], R) : 0;
      const long long n = (R - last + BM - 1) / BM;
      if (t >= before && t < before + n) {
        s[0] = E;
        s[1] = last + (int)(t - before) * BM;
        s[2] = (int)min(R, (long long)s[1] + BM);
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
  const Tile tile = row_tile(offs, E, R, blockIdx.x);
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

}  // namespace

extern "C" {

// fwd (dgrad 0): out (R, nout) = a (R, kin) . W[g(r)], W (E, kin, nout);
// dgrad (dgrad 1): out (R, nout) = a (R, kin) . W[g(r)]^T, W (E, nout, kin).
// a and out in the compute dtype (bf16 when x_bf16), W fp32 or bf16
// (w_bf16); offs (E,) int32 cumulative row ends.
int grouped_mm_rows(const void* a, const void* w, const void* offs, void* out,
                    long long R, int kin, int nout, int E, int x_bf16,
                    int w_bf16, int dgrad, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (x_bf16)
    return w_bf16 ? launch_rows<bf16, bf16>(a, w, offs, out, R, kin, nout, E,
                                            dgrad, st)
                  : launch_rows<bf16, float>(a, w, offs, out, R, kin, nout, E,
                                             dgrad, st);
  return w_bf16 ? launch_rows<float, bf16>(a, w, offs, out, R, kin, nout, E,
                                           dgrad, st)
                : launch_rows<float, float>(a, w, offs, out, R, kin, nout, E,
                                            dgrad, st);
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
