// Causal GQA flash attention in fp32 on Hopper's CUDA cores (sm_90a).
//
// CUDA counterpart of the Pallas TPU kernel in
// src/repro/kernels/flash_attention.py (flash_attention / _flash_kernel)
// for fp32 inputs: softmax(softcap(q k^T / sqrt(dh)) masked) v with an
// online softmax. bf16 inputs take the tensor-core kernel of
// flash_wgmma.cu; fp32 stays here, where every product is a full fp32 FMA
// (TF32 would round q and k to 10 mantissa bits), so the reference's 2e-5
// tolerance holds.
//
// Layout. q, o: (b, tq, h, dh); k, v: (b, tk, kv, dh), row-major fp32.
// Query head hi of batch bi reads kv head
// hi / (h / kv), the reference's index map (ih // h) * kv + (ih % h) // g.
// The kernel reads the (b, t, heads, dh) layout in place: no transposes.
//
// Design. The TPU kernel runs a sequential grid (b*h, tq/128, tk/128) and
// carries the running max, denominator and accumulator in VMEM scratch from
// one kv step to the next. Here CTAs run in parallel and in no order, so one
// CTA owns one (b*h, 64-query tile) and loops over the kv tiles itself:
//
//   * the Q tile, one K tile and one V tile sit in shared memory, Q and K with a padded row stride dh + 1 so
//     the column reads of the score product are free of bank conflicts;
//   * 256 threads; thread (rg, cg) = (tid / 16, tid % 16) owns rows
//     4 rg .. 4 rg + 3 of the tile, score columns cg + 16 j (j < 4) and
//     output columns cg + 16 c (c < dh / 16). Scores, running max,
//     denominator and the output accumulator stay in registers; a row's
//     max and sum are reduced over its 16 lanes with warp shuffles; only
//     the probabilities go through shared memory, for the P V product;
//   * kv tiles wholly outside the causal/window band of the query tile are
//     skipped. Masked entries inside a visited tile get -1e30, as in the
//     reference: a row fully masked in one tile takes p = exp(0) there,
//     and the next tile's alpha = exp(-1e30 - m) = 0 wipes it. Keys past
//     tk (a ragged last tile) get -inf and so weigh nothing;
//   * a query tile that holds a row whose band is empty (has_empty_row)
//     walks every kv tile instead: that row's scores are all -1e30, so it
//     comes out the mean of V over all tk keys, as in the reference, and
//     the other rows do not change (alpha = 0 at their first visible tile,
//     p = 0 past their band).
//
// Numerics, as the reference: s = (q . k) * scale, then the softcap
// cap * tanh(s / cap), then the mask; fp32 softmax and accumulation; the
// denominator floored at 1e-30. No --use_fast_math (expf and tanhf stay accurate).
//
// Bound. At the gemma2-2b serve shapes (dh 256, t 512-4608) the work is
// 4 dh flops per visible (query, key) pair against 2 bytes per element of
// q, k, v and o: far above the card's ridge, so it is bound by operations.
// In fp32 they run as FMAs on the CUDA cores (67 TFLOP/s peak).
//
// Shared memory: 4 (2 * 64 (dh + 1) + 64 dh + 64 * 65) bytes, 213,760 at
// dh = 256, above the 48 KB default, so each instantiation raises its
// dynamic limit with cudaFuncSetAttribute before the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // queries per CTA
constexpr int kBK = 64;        // keys per kv tile
constexpr int kThreads = 256;
constexpr float kMaskFill = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }

// True when a query row up to q_last sees no key: with a window, rows
// qi >= tk + window - 1 lie past the band of every key (causal or not).
// Prefill (tq == tk) never has one.
__device__ __forceinline__ bool has_empty_row(int q_last, int tk,
                                              int window) {
  return window > 0 && q_last >= tk + window - 1;
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (2 * kBQ * (DH + 1) + kBK * DH + kBQ * (kBK + 1));
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int tq, int tk,
             int h, int kvh, float scale, float cap, int causal,
             int window) {
  constexpr int QS = DH + 1;   // padded row stride of the Q and K tiles
  constexpr int PS = kBK + 1;  // padded row stride of the P tile
  constexpr int NC = DH / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBQ * QS;
  float* vs = ks + kBK * QS;
  float* ps = vs + kBK * DH;

  const int tid = threadIdx.x;
  const int rg = tid >> 4;
  const int cg = tid & 15;
  const int bi = blockIdx.y / h;
  const int hi = blockIdx.y % h;
  const int kvi = hi / (h / kvh);
  const int q0 = blockIdx.x * kBQ;

  const size_t q_row = (size_t)h * DH;    // stride between tokens of q, o
  const size_t kv_row = (size_t)kvh * DH; // stride between tokens of k, v
  const T* qb = q + (size_t)bi * tq * q_row + (size_t)hi * DH;
  const T* kb = k + (size_t)bi * tk * kv_row + (size_t)kvi * DH;
  const T* vb = v + (size_t)bi * tk * kv_row + (size_t)kvi * DH;
  T* ob = o + (size_t)bi * tq * q_row + (size_t)hi * DH;

  for (int i = tid; i < kBQ * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    const int qi = q0 + r;
    qs[r * QS + d] = qi < tq ? to_f32(qb[(size_t)qi * q_row + d]) : 0.f;
  }

  float acc[4][NC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMaskFill;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // the kv tiles that hold a key some query of this tile may see, or all
  // of them for a tile with an empty-band row
  const int q_last = min(q0 + kBQ, tq) - 1;
  const bool walk_all = has_empty_row(q_last, tk, window);
  const int k_end = causal && !walk_all ? min(tk, q_last + 1) : tk;
  const int k_begin =
      window > 0 && !walk_all ? max(0, q0 - window + 1) : 0;
  const int kt_begin = k_begin / kBK;
  const int kt_end = (k_end + kBK - 1) / kBK;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the Q tile is stored; the last tile's readers done
    for (int i = tid; i < kBK * DH; i += kThreads) {
      const int r = i / DH, d = i % DH;
      const int ki = k0 + r;
      const bool in = ki < tk;
      ks[r * QS + d] = in ? to_f32(kb[(size_t)ki * kv_row + d]) : 0.f;
      vs[r * DH + d] = in ? to_f32(vb[(size_t)ki * kv_row + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(rg * 4 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(cg + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + rg * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ki = k0 + cg + 16 * j;
        float x = s[i][j] * scale;
        if (cap != 0.f) x = cap * tanhf(x / cap);
        bool keep = true;
        if (causal) keep = keep && qi >= ki;
        if (window > 0) keep = keep && ki > qi - window;
        x = keep ? x : kMaskFill;
        if (ki >= tk) x = -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(rg * 4 + i) * PS + cg + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(rg * 4 + i) * PS + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = vs[kk * DH + cg + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg * 4 + i;
    if (qi >= tq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      store(&ob[(size_t)qi * q_row + cg + 16 * c], acc[i][c] / den);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int tq, int tk, int h, int kvh, float scale, float cap,
           int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((tq + kBQ - 1) / kBQ, b * h);
  flash_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, tq, tk, h, kvh, scale,
      cap, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int dh, const void* q, const void* k, const void* v, void* o,
             int b, int tq, int tk, int h, int kvh, float scale, float cap,
             int causal, int window, cudaStream_t stream) {
  switch (dh) {
    case 16:
      return launch<T, 16>(q, k, v, o, b, tq, tk, h, kvh, scale, cap,
                           causal, window, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, b, tq, tk, h, kvh, scale, cap,
                           causal, window, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, b, tq, tk, h, kvh, scale, cap,
                           causal, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, b, tq, tk, h, kvh, scale, cap,
                            causal, window, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, b, tq, tk, h, kvh, scale, cap,
                            causal, window, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// o = attention(q, k, v). q, o: (b, tq, h, dh); k, v: (b, tk, kvh, dh);
// all fp32, contiguous. dh in {16, 32, 64, 128, 256}; h % kvh == 0; window
// 0 means none.
int flash_attention_f32_fwd(const void* q, const void* k, const void* v,
                            void* o, int b, int tq, int tk, int h, int kvh,
                            int dh, float scale, float cap, int causal,
                            int window, void* stream) {
  return dispatch<float>(dh, q, k, v, o, b, tq, tk, h, kvh, scale, cap,
                         causal, window, (cudaStream_t)stream);
}

}  // extern "C"
