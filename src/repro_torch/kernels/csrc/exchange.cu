// Rotated-space lattice exchange kernels for Hopper (sm_90a).
//
// CUDA counterparts of the Pallas TPU kernels in src/repro/kernels/exchange.py:
//
//   exch_rotate    <- fused_rotate   (_rotate_kernel)
//   exch_encode    <- fused_encode   (_encode_kernel)
//   exch_quantize  <- quantize_codes (_quantize_kernel)
//   exch_snap      <- snap_codes     (_snap_kernel)
//   exch_decode    <- fused_decode   (_decode_kernel)
//
// Layout: a batch of m messages of d_pad fp32 coordinates, row-major. Each
// message splits into nb = d_pad / b Hadamard blocks of b = r*c coordinates;
// the packed code layout views a block as r rows of c columns and packs
// `pack = 8 / bits` codes per byte along the rows: byte (p, k) of a block
// holds the codes of rows p*pack .. p*pack+pack-1 in column k, the code of
// row p*pack+t in bits [t*bits, (t+1)*bits).
//
// Rotation. On the TPU, H_r X H_c is two MXU matmuls per block. H_r (x) H_c
// on the row-major (r, c) block is the Sylvester H_b on the contiguous
// b-vector, so here one CTA holds one (message, block) pair in shared memory
// and runs log2(b) radix-2 butterfly stages (h = 1, 2, 4, ...). This is
// exact fp32 arithmetic (adds and subtracts only, no TF32): the lattice scale
// gamma can be as small as 2^-18 max|y|, so y/gamma needs ~18 mantissa bits.
// The plain PyTorch version in kernels/exchange.py runs the same stages in
// the same order, so the two agree bit for bit.
//
// Bound. All five kernels are memory-bound on an H100: the butterfly does
// log2(b) <= 14 adds per coordinate against 8-16 bytes moved, far below the
// card's ~20 fp32 flop/byte ridge. The design therefore reads every input
// once and writes every output once (the rotated block never leaves shared
// memory between the rotation and the quantize, nor between the snap and
// the inverse rotation), and keeps the elementwise kernels to one coalesced
// pass.
//
// Signs. The encode and decode kernels take one sign row shared by every
// message (sign_stride 0) or one row per message (sign_stride d_pad): the
// per-message codec API gives each message its own rotation.
//
// Rounding. No --use_fast_math. The quantize and snap arithmetic uses the
// explicit round-to-nearest intrinsics (__fdiv_rn, __fadd_rn, __fsub_rn,
// __fmul_rn), which nvcc never contracts into an FMA, so fused_encode's
// codes, quantize_codes' codes and the plain version's codes are the same
// function of the same y. rintf rounds half to even, as jnp.round does.

#include <stdint.h>

#include "common.cuh"

namespace {

// Loads block j of message i (times the signs unless `inverse`) into shared
// memory and applies H_b, unscaled.
__device__ __forceinline__ void load_and_transform(
    float* sm, const float* __restrict__ x, size_t base,
    const float* __restrict__ s, int b, bool apply_signs) {
  for (int e = threadIdx.x; e < b; e += blockDim.x) {
    const float v = x[base + e];
    sm[e] = apply_signs ? __fmul_rn(v, s[e]) : v;
  }
  __syncthreads();
  fwht_shared(sm, b);
}

__global__ void __launch_bounds__(kMaxThreads)
rotate_kernel(const float* __restrict__ x, const float* __restrict__ signs,
              float* __restrict__ y, int d_pad, int b, float scale,
              int inverse) {
  extern __shared__ float sm[];
  const int j = blockIdx.x;
  const int i = blockIdx.y;
  const size_t base = (size_t)i * d_pad + (size_t)j * b;
  const float* s = signs + (size_t)j * b;
  load_and_transform(sm, x, base, s, b, !inverse);
  for (int e = threadIdx.x; e < b; e += blockDim.x) {
    const float v = __fmul_rn(sm[e], scale);
    y[base + e] = inverse ? __fmul_rn(v, s[e]) : v;
  }
}

// Two CTAs of 1024 threads per SM at b=16,384 need <= 32 registers a
// thread: the second bound holds ptxas to that.
__global__ void __launch_bounds__(kMaxThreads, 2)
encode_kernel(const float* __restrict__ x, const float* __restrict__ signs,
              int sign_stride, const float* __restrict__ u,
              const float* __restrict__ gam,
              int gam_stride, const float* __restrict__ levels,
              int lev_stride, float levels_default,
              int32_t* __restrict__ codes32, uint8_t* __restrict__ codes8,
              float* __restrict__ yout, int d_pad, int b, int c, int bits,
              int pack, float scale) {
  extern __shared__ float sm[];
  const int j = blockIdx.x;
  const int i = blockIdx.y;
  const size_t base = (size_t)i * d_pad + (size_t)j * b;
  load_and_transform(sm, x, base,
                     signs + (size_t)i * sign_stride + (size_t)j * b, b,
                     true);
  for (int e = threadIdx.x; e < b; e += blockDim.x) {
    const float v = __fmul_rn(sm[e], scale);
    sm[e] = v;
    if (yout != nullptr) yout[base + e] = v;
  }
  __syncthreads();
  const float g = gam[(size_t)i * gam_stride];
  const float L = levels != nullptr ? levels[(size_t)i * lev_stride]
                                    : levels_default;
  const float* uu = u + base;
  if (pack == 1) {
    for (int e = threadIdx.x; e < b; e += blockDim.x)
      codes32[base + e] = (int32_t)quantize_one(sm[e], g, uu[e], L);
    return;
  }
  const int nbytes = b / pack;
  const size_t obase = (size_t)i * (d_pad / pack) + (size_t)j * nbytes;
  for (int o = threadIdx.x; o < nbytes; o += blockDim.x) {
    const int p = o / c;
    const int k = o - p * c;
    unsigned acc = 0;
    for (int t = 0; t < pack; ++t) {
      const int e = (p * pack + t) * c + k;
      acc |= quantize_one(sm[e], g, uu[e], L) << (t * bits);
    }
    codes8[obase + o] = (uint8_t)acc;
  }
}

__global__ void quantize_kernel(const float* __restrict__ y,
                                const float* __restrict__ u,
                                const float* __restrict__ gam, int gam_stride,
                                const float* __restrict__ levels,
                                int lev_stride, float levels_default,
                                int32_t* __restrict__ codes32,
                                uint8_t* __restrict__ codes8, int m,
                                int d_pad, int b, int c, int bits, int pack) {
  const int per = d_pad / pack;
  const int nbytes = b / pack;
  const size_t n_out = (size_t)m * per;
  for (size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x; o < n_out;
       o += (size_t)gridDim.x * blockDim.x) {
    const int i = (int)(o / per);
    const int rem = (int)(o - (size_t)i * per);
    const float g = gam[(size_t)i * gam_stride];
    const float L = levels != nullptr ? levels[(size_t)i * lev_stride]
                                      : levels_default;
    if (pack == 1) {
      const size_t e = (size_t)i * d_pad + rem;
      codes32[o] = (int32_t)quantize_one(y[e], g, u[e], L);
      continue;
    }
    const int j = rem / nbytes;
    const int r2 = rem - j * nbytes;
    const int p = r2 / c;
    const int k = r2 - p * c;
    const size_t ebase = (size_t)i * d_pad + (size_t)j * b;
    unsigned acc = 0;
    for (int t = 0; t < pack; ++t) {
      const size_t e = ebase + (size_t)(p * pack + t) * c + k;
      acc |= quantize_one(y[e], g, u[e], L) << (t * bits);
    }
    codes8[o] = (uint8_t)acc;
  }
}

__global__ void snap_kernel(const int32_t* __restrict__ codes32,
                            const uint8_t* __restrict__ codes8, int mc,
                            const float* __restrict__ w, int mw,
                            const float* __restrict__ gam, int gam_stride,
                            const float* __restrict__ levels, int lev_stride,
                            float levels_default, float* __restrict__ out,
                            int m, int d_pad, int b, int c, int bits,
                            int pack) {
  const size_t n = (size_t)m * d_pad;
  const unsigned mask = (1u << bits) - 1u;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int i = (int)(idx / d_pad);
    const int e = (int)(idx - (size_t)i * d_pad);
    const size_t ci = mc == 1 ? 0 : (size_t)i;
    const size_t wi = mw == 1 ? 0 : (size_t)i;
    unsigned code;
    if (pack == 1) {
      code = (unsigned)codes32[ci * d_pad + e];
    } else {
      const int j = e / b;
      const int rem = e - j * b;
      const int row = rem / c;
      const int k = rem - row * c;
      const unsigned byte =
          codes8[ci * (d_pad / pack) + (size_t)j * (b / pack) +
                 (size_t)(row / pack) * c + k];
      code = (byte >> ((row % pack) * bits)) & mask;
    }
    const float g = gam[(size_t)i * gam_stride];
    const float L = levels != nullptr ? levels[(size_t)i * lev_stride]
                                      : levels_default;
    out[idx] = snap_one((float)code, w[wi * d_pad + e], g, L);
  }
}

// One (message, block) pair: rotate the reference block, snap every code to
// the representative nearest it, inverse-rotate. Code row i is codes row
// (mc == 1 ? 0 : i), reference row (mr == 1 ? 0 : i).
__global__ void __launch_bounds__(kMaxThreads)
decode_kernel(const int32_t* __restrict__ codes32,
              const uint8_t* __restrict__ codes8, int mc,
              const float* __restrict__ ref, int mr,
              const float* __restrict__ signs, int sign_stride,
              const float* __restrict__ gam, int gam_stride,
              const float* __restrict__ levels, int lev_stride,
              float levels_default, float* __restrict__ out, int d_pad,
              int b, int c, int bits, int pack, float scale) {
  extern __shared__ float sm[];
  const int j = blockIdx.x;
  const int i = blockIdx.y;
  const size_t ci = mc == 1 ? 0 : (size_t)i;
  const size_t ri = mr == 1 ? 0 : (size_t)i;
  const float* s = signs + (size_t)i * sign_stride + (size_t)j * b;
  load_and_transform(sm, ref, ri * d_pad + (size_t)j * b, s, b, true);
  const float g = gam[(size_t)i * gam_stride];
  const float L = levels != nullptr ? levels[(size_t)i * lev_stride]
                                    : levels_default;
  const unsigned mask = (1u << bits) - 1u;
  const size_t cbase = ci * (d_pad / pack) + (size_t)j * (b / pack);
  for (int e = threadIdx.x; e < b; e += blockDim.x) {
    unsigned code;
    if (pack == 1) {
      code = (unsigned)codes32[ci * d_pad + (size_t)j * b + e];
    } else {
      const int row = e / c;
      const int k = e - row * c;
      const unsigned byte = codes8[cbase + (size_t)(row / pack) * c + k];
      code = (byte >> ((row % pack) * bits)) & mask;
    }
    sm[e] = snap_one((float)code, __fmul_rn(sm[e], scale), g, L);
  }
  __syncthreads();
  fwht_shared(sm, b);
  const size_t obase = (size_t)i * d_pad + (size_t)j * b;
  for (int e = threadIdx.x; e < b; e += blockDim.x)
    out[obase + e] = __fmul_rn(__fmul_rn(sm[e], scale), s[e]);
}

}  // namespace

extern "C" {

// y = (H_b x*signs) / sqrt(b) per block, or signs * (H_b x) / sqrt(b) when
// `inverse`. x, y: (m, d_pad) fp32; signs: (d_pad,) fp32.
int exch_rotate(const void* x, const void* signs, void* y, int m, int d_pad,
                int b, int inverse, float scale, void* stream) {
  const size_t smem = (size_t)b * sizeof(float);
  cudaError_t err = allow_shared(rotate_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(d_pad / b, m);
  rotate_kernel<<<grid, block_threads(b), smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)signs, (float*)y, d_pad, b, scale,
      inverse);
  return (int)cudaGetLastError();
}

// Rotate + stochastic round + wrap. codes32 (m, d_pad) int32 when pack == 1,
// else codes8 (m, d_pad / pack) uint8; yout (m, d_pad) fp32 or null; signs
// (d_pad,) with sign_stride 0 or (m, d_pad) with sign_stride d_pad.
int exch_encode(const void* x, const void* signs, int sign_stride,
                const void* u,
                const void* gam, int gam_stride, const void* levels,
                int lev_stride, float levels_default, void* codes32,
                void* codes8, void* yout, int m, int d_pad, int b, int c,
                int bits, int pack, float scale, void* stream) {
  const size_t smem = (size_t)b * sizeof(float);
  cudaError_t err = allow_shared(encode_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(d_pad / b, m);
  encode_kernel<<<grid, block_threads(b), smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)signs, sign_stride, (const float*)u,
      (const float*)gam, gam_stride, (const float*)levels, lev_stride,
      levels_default, (int32_t*)codes32, (uint8_t*)codes8, (float*)yout,
      d_pad, b, c, bits, pack, scale);
  return (int)cudaGetLastError();
}

// The quantize half of exch_encode on already-rotated y.
int exch_quantize(const void* y, const void* u, const void* gam,
                  int gam_stride, const void* levels, int lev_stride,
                  float levels_default, void* codes32, void* codes8, int m,
                  int d_pad, int b, int c, int bits, int pack, void* stream) {
  const size_t n_out = (size_t)m * (d_pad / pack);
  quantize_kernel<<<elt_blocks(n_out), kEltThreads, 0,
                    (cudaStream_t)stream>>>(
      (const float*)y, (const float*)u, (const float*)gam, gam_stride,
      (const float*)levels, lev_stride, levels_default, (int32_t*)codes32,
      (uint8_t*)codes8, m, d_pad, b, c, bits, pack);
  return (int)cudaGetLastError();
}

// Positional snap of mc code rows against mw reference rows (either may be
// 1 and broadcasts); out (max(mc, mw), d_pad) fp32.
int exch_snap(const void* codes32, const void* codes8, int mc, const void* w,
              int mw, const void* gam, int gam_stride, const void* levels,
              int lev_stride, float levels_default, void* out, int m,
              int d_pad, int b, int c, int bits, int pack, void* stream) {
  const size_t n = (size_t)m * d_pad;
  snap_kernel<<<elt_blocks(n), kEltThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)codes32, (const uint8_t*)codes8, mc, (const float*)w,
      mw, (const float*)gam, gam_stride, (const float*)levels, lev_stride,
      levels_default, (float*)out, m, d_pad, b, c, bits, pack);
  return (int)cudaGetLastError();
}

// Full Dec(ref, msg): mc code rows against mr reference rows in original
// coordinates (either may be 1 and broadcasts); signs as exch_encode's;
// out (m, d_pad) fp32, m = max(mc, mr).
int exch_decode(const void* codes32, const void* codes8, int mc,
                const void* ref, int mr, const void* signs, int sign_stride,
                const void* gam, int gam_stride, const void* levels,
                int lev_stride, float levels_default, void* out, int m,
                int d_pad, int b, int c, int bits, int pack, float scale,
                void* stream) {
  const size_t smem = (size_t)b * sizeof(float);
  cudaError_t err = allow_shared(decode_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(d_pad / b, m);
  decode_kernel<<<grid, block_threads(b), smem, (cudaStream_t)stream>>>(
      (const int32_t*)codes32, (const uint8_t*)codes8, mc, (const float*)ref,
      mr, (const float*)signs, sign_stride, (const float*)gam, gam_stride,
      (const float*)levels, lev_stride, levels_default, (float*)out, d_pad,
      b, c, bits, pack, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
