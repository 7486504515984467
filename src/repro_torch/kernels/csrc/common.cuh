// Device helpers shared by the lattice kernels (exchange.cu,
// lattice_quant.cu): the elementwise launch geometry and the quantize and
// snap arithmetic. One definition here keeps the kernels that must agree
// bit for bit on the same rounding (the butterfly is butterfly.cuh's).
// kernels/build.py hashes this header into every library's name, so an
// edit here rebuilds them all.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kEltThreads = 256;

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

}  // namespace
