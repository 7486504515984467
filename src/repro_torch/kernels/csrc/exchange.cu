// Rotated-space lattice exchange kernels for Hopper (sm_90a).
//
// CUDA counterparts of the Pallas TPU kernels in src/repro/kernels/exchange.py:
//
//   exch_rotate    <- fused_rotate   (_rotate_kernel)
//   exch_encode    <- fused_encode   (_encode_kernel)
//   exch_quantize  <- quantize_codes (_quantize_kernel)
//   exch_snap      <- snap_codes     (_snap_kernel)
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
// Bound. All four kernels are memory-bound on an H100: the butterfly does
// log2(b) <= 14 adds per coordinate against 8-16 bytes moved, far below the
// card's ~20 fp32 flop/byte ridge. The design therefore reads every input
// once and writes every output once (the rotated block never leaves shared
// memory between the rotation and the quantize), and keeps the elementwise
// kernels to one coalesced pass.
//
// Rounding. No --use_fast_math. The quantize and snap arithmetic uses the
// explicit round-to-nearest intrinsics (__fdiv_rn, __fadd_rn, __fsub_rn,
// __fmul_rn), which nvcc never contracts into an FMA, so fused_encode's
// codes, quantize_codes' codes and the plain version's codes are the same
// function of the same y. rintf rounds half to even, as jnp.round does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kEltThreads = 256;

int block_threads(int b) {
  int t = b / 2;
  if (t > kMaxThreads) t = kMaxThreads;
  if (t < 32) t = 32;
  return t;
}

int elt_blocks(size_t n) {
  size_t blocks = (n + kEltThreads - 1) / kEltThreads;
  const size_t cap = 132 * 32;  // enough CTAs to fill every SM
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

// floor(y / g + u) taken modulo L with the floored modulo of jnp.mod
// (q is negative for about half the coordinates, so C's % and fmodf are
// wrong). L is a power of two, so q / L and L * floor(q / L) are exact.
__device__ __forceinline__ unsigned quantize_one(float y, float g, float u,
                                                 float L) {
  float q = floorf(__fadd_rn(__fdiv_rn(y, g), u));
  float r = __fsub_rn(q, __fmul_rn(L, floorf(__fdiv_rn(q, L))));
  return (unsigned)r;
}

// gamma * (c + L * round((w / gamma - c) / L)), round half to even.
__device__ __forceinline__ float snap_one(float code, float w, float g,
                                          float L) {
  float t = __fdiv_rn(__fsub_rn(__fdiv_rn(w, g), code), L);
  float q = __fadd_rn(code, __fmul_rn(L, rintf(t)));
  return __fmul_rn(q, g);
}

// In-place Sylvester transform of the b floats in shared memory.
__device__ __forceinline__ void fwht_shared(float* sm, int b) {
  const int half = b >> 1;
  for (int h = 1; h < b; h <<= 1) {
    for (int p = threadIdx.x; p < half; p += blockDim.x) {
      const int i0 = ((p & ~(h - 1)) << 1) | (p & (h - 1));
      const int i1 = i0 + h;
      const float a = sm[i0];
      const float c = sm[i1];
      sm[i0] = __fadd_rn(a, c);
      sm[i1] = __fsub_rn(a, c);
    }
    __syncthreads();
  }
}

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

__global__ void __launch_bounds__(kMaxThreads)
encode_kernel(const float* __restrict__ x, const float* __restrict__ signs,
              const float* __restrict__ u, const float* __restrict__ gam,
              int gam_stride, const float* __restrict__ levels,
              int lev_stride, float levels_default,
              int32_t* __restrict__ codes32, uint8_t* __restrict__ codes8,
              float* __restrict__ yout, int d_pad, int b, int c, int bits,
              int pack, float scale) {
  extern __shared__ float sm[];
  const int j = blockIdx.x;
  const int i = blockIdx.y;
  const size_t base = (size_t)i * d_pad + (size_t)j * b;
  load_and_transform(sm, x, base, signs + (size_t)j * b, b, true);
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

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
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
// else codes8 (m, d_pad / pack) uint8; yout (m, d_pad) fp32 or null.
int exch_encode(const void* x, const void* signs, const void* u,
                const void* gam, int gam_stride, const void* levels,
                int lev_stride, float levels_default, void* codes32,
                void* codes8, void* yout, int m, int d_pad, int b, int c,
                int bits, int pack, float scale, void* stream) {
  const size_t smem = (size_t)b * sizeof(float);
  cudaError_t err = allow_shared(encode_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(d_pad / b, m);
  encode_kernel<<<grid, block_threads(b), smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)signs, (const float*)u,
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

}  // extern "C"
