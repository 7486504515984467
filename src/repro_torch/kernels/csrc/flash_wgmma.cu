// Causal GQA flash attention for bf16 on Hopper's tensor cores (sm_90a).
//
// CUDA counterpart of the Pallas TPU kernel in
// src/repro/kernels/flash_attention.py (flash_attention / _flash_kernel)
// for bf16 q, k, v: softmax(softcap(q k^T / sqrt(dh)) masked) v with an
// online softmax, for the prefill of every full and sliding-window layer.
// fp32 inputs take the CUDA-core kernel of flash_attention.cu instead.
//
// Layout. q, o: (b, tq, h, dh); k, v: (b, tk, kv, dh), row-major bf16.
// Query head hi of batch bi reads kv head hi / (h / kv), the reference's
// index map. Tensor maps run over that layout as it lies, as 4-d tensors
// (dh, heads, t, b): no transposes.
//
// Bound. At the gemma2-2b serve shapes (dh 256, t 512-4,608) the work is
// 4 dh flops per visible (query, key) pair against 2 bytes per element of
// q, k, v and o, far above the card's ridge: bound by operations, 0.352 ms
// of bf16 tensor-core work at b=4, t=4,608, h=8 (989 TFLOP/s). So both
// products run on wgmma, and the loads are off the critical path:
//
//   * one CTA per (b*h, 128-query tile), query tiles launched longest
//     first (the causal triangle's tail then fills the last wave); two
//     consumer warpgroups own 64 query rows each, a producer warpgroup
//     (one thread of it) issues the TMA loads; setmaxnreg gives the
//     consumers 240 registers (the O accumulator alone is dh / 2 fp32
//     registers a thread) and the producer 24;
//   * shared memory: the Q tile (loaded once), and K and V tiles of 64
//     keys in a 2-stage ring with full and empty mbarriers (K and V have
//     separate full barriers, so S = Q K^T starts before V lands): 192 KB
//     at dh = 256. Rows are cut into panels of min(64, dh) elements, each
//     stored with the TMA's 128-byte swizzle (64 or 32 bytes at dh 32, 16);
//   * S = Q K^T: wgmma m64n64k16, both operands K-major from shared
//     memory, fp32 accumulators. Products of bf16 values are exact in
//     fp32, so S matches the reference's fp32 dot up to summation order;
//   * the softmax runs on the accumulator fragment in registers; a row's
//     max and sum are reduced over the 4 threads that hold it;
//   * O += P V: P rounded to bf16 in registers is wgmma's A operand (the
//     RS form, no trip through shared memory), V is read MN-major (the
//     transpose bit), m64n{dh}k16;
//   * kv tiles wholly outside the causal/window band of the CTA are not
//     loaded; a warpgroup skips the tiles outside its own rows' band. A
//     CTA that holds a row whose band is empty (has_empty_row) loads every
//     kv tile and neither warpgroup skips one: that row's scores are all
//     -1e30, so it comes out the mean of V over all tk keys, as in the
//     reference, and the other rows do not change (alpha = 0 at their
//     first visible tile, p = 0 past their band). Only a launch that can
//     have such a row (tq > tk + window - 1) takes the EMPTY_ROWS
//     instantiation that checks for one; prefill (tq == tk) runs the one
//     without the check, where walk_all folds to false;
//   * no split-KV and no atomics: the result is deterministic.
//
// Numerics, as the reference: s = (q . k) * scale, then cap * tanh(s /
// cap) (tanhf, never tanh.approx), then the mask; masked entries inside a
// visited tile get -1e30 (a row fully masked in one tile takes p = 1 there
// and the next tile's alpha = 0 wipes it), keys past tk get -inf; running
// max, denominator and O in fp32; exp by exp2f((s - m) log2 e). The one
// new rounding: P is rounded to bf16 before the P V product, and the
// denominator sums that same rounded P, so every output row stays a convex
// combination of V rows. The denominator is floored at 1e-30 and the
// output rounded to bf16, nearest even.
//
// The TMA, mbarrier and wgmma helpers are hopper.cuh's, which
// grouped_mm.cu shares.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 128;         // queries per CTA: two warpgroups of 64
constexpr int kBK = 64;          // keys per kv tile
constexpr int kConsumers = 256;  // two consumer warpgroups
// and one producer warpgroup, of which one thread issues the loads: with
// 384 threads the launch gives 168 registers a thread, and setmaxnreg
// moves exactly what the producer frees, 128 x (168 - 24), to the
// consumers, 256 x (240 - 168); the pool is the CTA's own
constexpr int kThreads = kConsumers + 128;
constexpr float kMaskFill = -1e30f;
constexpr int kFarRow = 1 << 29;  // past any row or key index, no overflow
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory plan of one CTA for head dim DH (bytes, from a 1024-aligned
// base: the 128-byte swizzle repeats every 1024 bytes).
template <int DH>
struct Plan {
  static constexpr int SW = DH * 2 < 128 ? DH * 2 : 128;  // swizzle span
  static constexpr int PW = SW / 2;           // elements in a panel row
  static constexpr int NP = DH / PW;          // panels across the head dim
  static constexpr int PANEL = 64 * SW;       // one panel of 64 rows
  static constexpr int TILE = NP * PANEL;     // 64 rows x dh
  static constexpr int Q = 0;                 // 2 tiles (128 queries)
  static constexpr int K = Q + 2 * TILE;      // 2 stages
  static constexpr int V = K + 2 * TILE;      // 2 stages
  static constexpr int BARS = V + 2 * TILE;   // 7 mbarriers
  static constexpr int BYTES = BARS + 7 * 8 + 1024;  // + alignment slack
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;
};

// True when a query row up to q_last sees no key: with a window, rows
// qi >= tk + window - 1 lie past the band of every key (causal or not).
// Prefill (tq == tk) never has one.
__host__ __device__ __forceinline__ bool has_empty_row(int q_last, int tk,
                                                       int window) {
  return window > 0 && q_last >= tk + window - 1;
}

// S = A B^T (accumulate != 0: S += A B^T), m64n64k16; A (64 x 16) and
// B (64 x 16) from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int DH, bool EMPTY_ROWS>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   __nv_bfloat16* __restrict__ o, int tq, int tk, int nh,
                   int kvh, float scale, float cap, int causal, int window) {
  using P = Plan<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full_q = base + P::BARS;
  // full_k(s) = full_q + 8 + 8 s, full_v(s) = full_q + 24 + 8 s,
  // empty(s) = full_q + 40 + 8 s
  const int tid = threadIdx.x;
  const int bi = blockIdx.x / nh;
  const int hi = blockIdx.x % nh;
  const int kvi = hi / (nh / kvh);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest tiles first

  // the kv tiles that hold a key some query of this CTA may see, or all
  // of them for a CTA with an empty-band row
  const int q_last = min(q0 + kBQ, tq) - 1;
  const bool walk_all = EMPTY_ROWS && has_empty_row(q_last, tk, window);
  const int k_end = causal && !walk_all ? min(tk, q_last + 1) : tk;
  const int k_begin =
      window > 0 && !walk_all ? max(0, q0 - window + 1) : 0;
  const int kt_begin = k_begin / kBK;
  const int n_tiles = max(0, (k_end + kBK - 1) / kBK - kt_begin);

  if (tid == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(full_q + 8 + 8 * s, 1);
      mbar_init(full_q + 24 + 8 * s, 1);
      mbar_init(full_q + 40 + 8 * s, kConsumers / 32);  // one per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warpgroup: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == kConsumers) {
      mbar_expect_tx(full_q, 2 * P::TILE);
      for (int w = 0; w < 2; ++w)
        for (int p = 0; p < P::NP; ++p)
          tma_load(base + P::Q + w * P::TILE + p * P::PANEL, &qmap, full_q,
                   p * P::PW, hi, q0 + 64 * w, bi);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i & 1;
        const uint32_t phase = (i >> 1) & 1;
        const int k0 = (kt_begin + i) * kBK;
        mbar_wait(full_q + 40 + 8 * s, phase ^ 1);  // the stage is free
        const uint32_t fk = full_q + 8 + 8 * s, fv = full_q + 24 + 8 * s;
        mbar_expect_tx(fk, P::TILE);
        for (int p = 0; p < P::NP; ++p)
          tma_load(base + P::K + s * P::TILE + p * P::PANEL, &kmap, fk,
                   p * P::PW, kvi, k0, bi);
        mbar_expect_tx(fv, P::TILE);
        for (int p = 0; p < P::NP; ++p)
          tma_load(base + P::V + s * P::TILE + p * P::PANEL, &vmap, fv,
                   p * P::PW, kvi, k0, bi);
      }
    }
  } else {
    // consumer warpgroups: warpgroup wg owns query rows q0 + 64 wg ...
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = tid >> 7;
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    // this thread's accumulator rows: row0 and row0 + 8; its columns in
    // each group of 8: col0 and col0 + 1
    const int row0 = q0 + 64 * wg + 16 * warp + (lane >> 2);
    const int col0 = 2 * (lane & 3);
    // the warpgroup's rows, for skipping tiles outside their band and
    // masking tiles across its edges; unbounded in a CTA that walks every
    // tile, so that none is skipped and every one is masked
    const int qw0 = walk_all ? -kFarRow : q0 + 64 * wg;
    const int qw1 = walk_all ? kFarRow : q0 + 64 * wg + 63;
    const float inv_cap = cap != 0.f ? 1.f / cap : 0.f;
    const uint32_t qa = base + P::Q + wg * P::TILE;
    constexpr uint32_t kSBO = 8 * P::SW;  // 8 rows of a panel

    float acc[DH / 2];
#pragma unroll
    for (int r = 0; r < DH / 2; ++r) acc[r] = 0.f;
    float m[2] = {kMaskFill, kMaskFill};
    float l[2] = {0.f, 0.f};  // this thread's share of the row sums

    mbar_wait(full_q, 0);
    __syncwarp();  // wgmma's .aligned forms need the warp converged
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i & 1;
      const uint32_t phase = (i >> 1) & 1;
      const int k0 = (kt_begin + i) * kBK;
      const uint32_t fk = full_q + 8 + 8 * s, fv = full_q + 24 + 8 * s;
      const uint32_t empty = full_q + 40 + 8 * s;
      mbar_wait(fk, phase);
      __syncwarp();
      // a tile outside this warpgroup's band adds exactly nothing
      if ((causal && k0 > qw1) || (window > 0 && k0 + kBK - 1 <= qw0 - window)) {
        mbar_wait(fv, phase);  // keeps the empty barrier's phases in order
        __syncwarp();
        if (lane == 0) mbar_arrive(empty);
        continue;
      }

      // S = Q K^T over dh / 16 steps of 16
      float sc[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) sc[r] = 0.f;
      const uint32_t kb = base + P::K + s * P::TILE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t off = (kk / (P::SW / 32)) * P::PANEL +
                             (kk % (P::SW / 32)) * 32;
        wgmma_ss_n64(sc, smem_desc(qa + off, 16, kSBO, P::LAYOUT),
                     smem_desc(kb + off, 16, kSBO, P::LAYOUT), kk);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // scale, softcap, mask; accumulator element r sits in row
      // row0 + 8 ((r >> 1) & 1), column 8 (r >> 2) + col0 + (r & 1)
      const bool edge = (causal && k0 + kBK - 1 > qw0) ||
                        (window > 0 && k0 <= qw1 - window) || k0 + kBK > tk;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int hr = (r >> 1) & 1;
        float x = sc[r] * scale;
        if (cap != 0.f) x = cap * tanhf(x * inv_cap);
        if (edge) {
          const int qi = row0 + 8 * hr;
          const int ki = k0 + 8 * (r >> 2) + col0 + (r & 1);
          bool keep = true;
          if (causal) keep = qi >= ki;
          if (window > 0) keep = keep && ki > qi - window;
          x = keep ? x : kMaskFill;
          if (ki >= tk) x = -INFINITY;
        }
        sc[r] = x;
        mx[hr] = fmaxf(mx[hr], x);
      }
      float alpha[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
        alpha[hr] = exp2f((m[hr] - mx[hr]) * kLog2e);
        m[hr] = mx[hr];
      }

      // P in bf16, packed as wgmma's A fragments: step kk covers keys
      // 16 kk .. 16 kk + 15, register e holds accumulator pair 8 kk + 2 e
      uint32_t pa[4][4];
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 8 * kk + 2 * e;
          const int hr = e & 1;
          const uint32_t pb = pack_bf16(exp2f((sc[r] - m[hr]) * kLog2e),
                                        exp2f((sc[r + 1] - m[hr]) * kLog2e));
          rs[hr] += __uint_as_float(pb << 16) +
                    __uint_as_float(pb & 0xffff0000u);
          pa[kk][e] = pb;
        }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) l[hr] = alpha[hr] * l[hr] + rs[hr];
#pragma unroll
      for (int r = 0; r < DH / 2; ++r) acc[r] *= alpha[(r >> 1) & 1];

      // O += P V over 4 steps of 16 keys
      mbar_wait(fv, phase);
      __syncwarp();
      const uint32_t vb = base + P::V + s * P::TILE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<1>(acc, pa[kk], smem_desc(vb + kk * 16 * P::SW, P::PANEL,
                                            kSBO, P::LAYOUT));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty);
    }

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
      const int qi = row0 + 8 * hr;
      if (qi >= tq) continue;
      const float den = fmaxf(l[hr], 1e-30f);
      __nv_bfloat16* orow =
          o + ((size_t)bi * tq + qi) * ((size_t)nh * DH) + (size_t)hi * DH;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + col0) =
            __floats2bfloat162_rn(acc[4 * j + 2 * hr] / den,
                                  acc[4 * j + 2 * hr + 1] / den);
    }
  }
}

// The map of a (b, t, heads, dh) bf16 tensor as the 4-d (dh, heads, t, b),
// boxes of (one panel, 1 head, 64 rows, 1 batch). Rows past t read as 0.
template <int DH>
CUresult encode_map(EncodeTiled fn, CUtensorMap* map, const void* ptr, int b,
                    int t, int heads) {
  using P = Plan<DH>;
  const cuuint64_t dims[4] = {(cuuint64_t)DH, (cuuint64_t)heads,
                              (cuuint64_t)t, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)DH * 2,
                                 (cuuint64_t)heads * DH * 2,
                                 (cuuint64_t)t * heads * DH * 2};
  const cuuint32_t box[4] = {(cuuint32_t)P::PW, 1, 64, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      P::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : P::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                    : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int tq, int tk, int h, int kvh, float scale, float cap, int causal,
           int window, cudaStream_t stream) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap qmap, kmap, vmap;
  CUresult res = encode_map<DH>(fn, &qmap, q, b, tq, h);
  if (res == CUDA_SUCCESS) res = encode_map<DH>(fn, &kmap, k, b, tk, kvh);
  if (res == CUDA_SUCCESS) res = encode_map<DH>(fn, &vmap, v, b, tk, kvh);
  if (res != CUDA_SUCCESS) return kEncodeFailed + (int)res;
  auto kernel = has_empty_row(tq - 1, tk, window)
                    ? flash_wgmma_kernel<DH, true>
                    : flash_wgmma_kernel<DH, false>;
  constexpr int smem = Plan<DH>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(b * h, (tq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      qmap, kmap, vmap, (__nv_bfloat16*)o, tq, tk, h, kvh, scale, cap, causal,
      window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// o = attention(q, k, v) on the tensor cores. q, o: (b, tq, h, dh); k, v:
// (b, tk, kvh, dh); all bf16, contiguous, 16-byte aligned. dh in {16, 32,
// 64, 128, 256}; h % kvh == 0; window 0 means none. Returns a cudaError_t,
// or 10000 + the CUresult of a tensor map that failed to encode.
int flash_attention_bf16_fwd(const void* q, const void* k, const void* v,
                             void* o, int b, int tq, int tk, int h, int kvh,
                             int dh, float scale, float cap, int causal,
                             int window, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dh) {
    case 16:
      return launch<16>(q, k, v, o, b, tq, tk, h, kvh, scale, cap, causal,
                        window, st);
    case 32:
      return launch<32>(q, k, v, o, b, tq, tk, h, kvh, scale, cap, causal,
                        window, st);
    case 64:
      return launch<64>(q, k, v, o, b, tq, tk, h, kvh, scale, cap, causal,
                        window, st);
    case 128:
      return launch<128>(q, k, v, o, b, tq, tk, h, kvh, scale, cap, causal,
                         window, st);
    case 256:
      return launch<256>(q, k, v, o, b, tq, tk, h, kvh, scale, cap, causal,
                         window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory a CTA of the dh instantiation takes (bytes), or -1
// for a dh the kernel does not take; ptxas -v reports only static memory.
int flash_wgmma_smem_bytes(int dh) {
  switch (dh) {
    case 16: return Plan<16>::BYTES;
    case 32: return Plan<32>::BYTES;
    case 64: return Plan<64>::BYTES;
    case 128: return Plan<128>::BYTES;
    case 256: return Plan<256>::BYTES;
    default: return -1;
  }
}

}  // extern "C"
