// Single-vector lattice encode and decode for Hopper (sm_90a).
//
// CUDA counterparts of the Pallas TPU kernels in
// src/repro/kernels/lattice_quant.py:
//
//   lattice_enc_kernel  <- lattice_encode (_encode_kernel)
//                          codes = floor(y / gamma + u) mod 2^bits
//   lattice_dec_kernel  <- lattice_decode (_decode_kernel)
//                          x = gamma (c + 2^bits round((w / gamma - c) / 2^bits))
//
// over one rotated vector of d coordinates (d % 1024 == 0, the TPU kernels'
// (8, 128) tiles) with one scalar gamma.
//
// Design. Both are elementwise streams, so each is one coalesced grid-stride
// pass; where every pointer is 16-byte aligned (the wrapper checks), a
// thread moves four coordinates at a time as float4 / int4. gamma is read
// on the device from a pointer (a 0-d or (1,) tensor, no host sync) or, when
// the pointer is null, taken by value. The arithmetic is quantize_one and
// snap_one of common.cuh, the exchange kernels' own: the floored modulo of
// jnp.mod, rintf for jnp.round's half to even, and explicit _rn intrinsics
// that nvcc never contracts into an FMA, so the kernels and the plain
// versions (kernels/lattice_quant.py) agree bit for bit.
//
// Codes are int32 (the reference's uint32; every code is below 2^16).
//
// Bound. Bytes: 12 per coordinate either way (two fp32 reads and a 4-byte
// write), against 7 fp32 operations per coordinate, far below the card's
// ops/byte ridge.

#include <stdint.h>

#include "common.cuh"

namespace {

__global__ void lattice_enc_kernel(const float* __restrict__ y,
                                   const float* __restrict__ u,
                                   const float* __restrict__ gptr, float gval,
                                   int32_t* __restrict__ codes, size_t n,
                                   float L, int vec) {
  const float g = gptr != nullptr ? *gptr : gval;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (vec) {
    const float4* y4 = reinterpret_cast<const float4*>(y);
    const float4* u4 = reinterpret_cast<const float4*>(u);
    int4* c4 = reinterpret_cast<int4*>(codes);
    for (; i < n / 4; i += stride) {
      const float4 a = y4[i];
      const float4 b = u4[i];
      int4 o;
      o.x = (int32_t)quantize_one(a.x, g, b.x, L);
      o.y = (int32_t)quantize_one(a.y, g, b.y, L);
      o.z = (int32_t)quantize_one(a.z, g, b.z, L);
      o.w = (int32_t)quantize_one(a.w, g, b.w, L);
      c4[i] = o;
    }
    return;
  }
  for (; i < n; i += stride)
    codes[i] = (int32_t)quantize_one(y[i], g, u[i], L);
}

__global__ void lattice_dec_kernel(const int32_t* __restrict__ codes,
                                   const float* __restrict__ w,
                                   const float* __restrict__ gptr, float gval,
                                   float* __restrict__ out, size_t n, float L,
                                   int vec) {
  const float g = gptr != nullptr ? *gptr : gval;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (vec) {
    const int4* c4 = reinterpret_cast<const int4*>(codes);
    const float4* w4 = reinterpret_cast<const float4*>(w);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (; i < n / 4; i += stride) {
      const int4 c = c4[i];
      const float4 a = w4[i];
      float4 o;
      o.x = snap_one((float)c.x, a.x, g, L);
      o.y = snap_one((float)c.y, a.y, g, L);
      o.z = snap_one((float)c.z, a.z, g, L);
      o.w = snap_one((float)c.w, a.w, g, L);
      o4[i] = o;
    }
    return;
  }
  for (; i < n; i += stride)
    out[i] = snap_one((float)codes[i], w[i], g, L);
}

}  // namespace

extern "C" {

// codes (d,) int32 = floor(y / gamma + u) mod L; y, u (d,) fp32; gamma read
// from gptr, or gval when gptr is null; vec: every pointer 16-byte aligned.
int lattice_encode_fwd(const void* y, const void* u, const void* gptr,
                       float gval, void* codes, long long d, float L, int vec,
                       void* stream) {
  const size_t n = (size_t)d;
  lattice_enc_kernel<<<elt_blocks(vec ? n / 4 : n), kEltThreads, 0,
                       (cudaStream_t)stream>>>(
      (const float*)y, (const float*)u, (const float*)gptr, gval,
      (int32_t*)codes, n, L, vec);
  return (int)cudaGetLastError();
}

// out (d,) fp32 = gamma (c + L round((w / gamma - c) / L)); codes (d,) int32;
// w (d,) fp32; gamma and vec as lattice_encode_fwd's.
int lattice_decode_fwd(const void* codes, const void* w, const void* gptr,
                       float gval, void* out, long long d, float L, int vec,
                       void* stream) {
  const size_t n = (size_t)d;
  lattice_dec_kernel<<<elt_blocks(vec ? n / 4 : n), kEltThreads, 0,
                       (cudaStream_t)stream>>>(
      (const int32_t*)codes, (const float*)w, (const float*)gptr, gval,
      (float*)out, n, L, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
