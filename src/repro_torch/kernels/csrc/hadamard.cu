// Blocked Hadamard transform for Hopper (sm_90a).
//
// CUDA counterpart of the Pallas TPU kernel in src/repro/kernels/hadamard.py
// (hadamard_blocks / _hadamard_kernel): y = (H_r X H_c) / sqrt(r c) for every
// (r, c) block X of an (n, r, c) batch. It is the core of the rotation in
// kernels/ops.py (rotate_blocks, the counterpart of rotate_pallas).
//
// Design. On the TPU, H_r X H_c is two MXU matmuls per block. H_r (x) H_c on
// the row-major (r, c) block is the Sylvester H_rc on the contiguous
// rc-vector, for any split of rc (exchange.cu says why), so the kernel runs
// the exchange's cluster butterfly (butterfly.cuh, fwht_block<C>) without
// signs: a block of b = rc coordinates is split across a cluster of C CTAs,
// n = b / C contiguous coordinates a CTA and 8 a thread, with stages in
// registers, across lanes, through shared memory and across the cluster's
// shared memory. This is rotate_cluster_kernel<C> of exchange.cu without
// the sign row. The adds are exact fp32 (__fadd_rn, __fsub_rn), with no
// TF32: H's entries are +-1, and a TF32 tensor-core product would round X to
// 10 mantissa bits, 5e-4 relative, outside the rotation tolerance. The plain
// PyTorch version (kernels/hadamard.py, hadamard_plain) runs the same stages
// in the same order and multiplies by the same fp32 scale, so the two agree
// bit for bit.
//
// Input. fp32 or bf16, by a template on the input type: a thread loads its
// 8 coordinates in two 16-byte loads (fp32) or one (8 bf16 values, widened
// exactly to fp32, as the TPU kernel's astype), so the wrapper adds no cast
// pass. The output is fp32.
//
// Geometry. The wrapper picks C (kernels/hadamard.py, launch_geometry): 1
// for b <= 2,048, else b / 2,048 up to the portable 8, so a CTA holds at
// most 4,096 coordinates; this kernel also takes chunks of 8,192 (1,024
// threads), C = 2 at b = 16,384, for the wrapper's choice to be timed
// against.
//
// Bound. Bytes: 8 per coordinate for fp32 input, 6 for bf16 (read X, write
// y), against log2(rc) <= 15 adds and one multiply per coordinate, far below
// the card's fp32 ops/byte ridge. Every coordinate crosses device memory
// once each way.

#include <cuda_bf16.h>

#include "butterfly.cuh"

namespace {

// the largest chunk a CTA of this kernel holds: 1,024 threads of 8
constexpr int kMaxHadamardChunk = 2 * kMaxChunk;

// v[e] = chunk[off + e] widened to fp32 for off + e < n, 0 beyond; one
// 16-byte load of 8 bf16 values when it can (a bf16 value is the upper half
// of its fp32 value, so the widening is exact). Every address read lies
// inside the chunk.
__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ chunk,
                                      int off, int n, float v[kVals]) {
  const __nv_bfloat16* p = chunk + off;
  if (off + kVals <= n && ((uintptr_t)p & 15) == 0) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[2 * q] = __uint_as_float(w[q] << 16);
      v[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < kVals; ++e) {
    const float x = __bfloat162float(chunk[min(off + e, n - 1)]);
    v[e] = off + e < n ? x : 0.f;
  }
}

// (H_b x) / sqrt(b) of block j by a cluster of C CTAs (grid (nblocks * C));
// CTA `rank` holds block coordinates rank * n .. rank * n + n - 1.
template <int C, typename T>
__global__ void __launch_bounds__(kMaxHadamardChunk / kVals)
hadamard_cluster_kernel(const T* __restrict__ x, float* __restrict__ y, int b,
                        float scale, int n, int k) {
  extern __shared__ float sm[];
  const int j = blockIdx.x / C;
  const int rank = blockIdx.x % C;
  const int t = threadIdx.x;
  // coordinates this thread holds: 8, or fewer in a chunk under 8, or none
  // for the threads past a chunk under a warp's span
  const int nv = kVals * t < n ? min(kVals, n - kVals * t) : 0;
  const size_t chunk = (size_t)j * b + (size_t)rank * n;
  float v[kVals];
  load8(x + chunk, kVals * t, n, v);
  fwht_block<C>(v, sm, n, k, nv);
#pragma unroll
  for (int e = 0; e < kVals; ++e) v[e] = __fmul_rn(sm[kVals * t + e], scale);
  store8(y + chunk + kVals * t, nv, v);
}

bool hadamard_cluster_ok(int b, int cluster) {
  if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8)
    return false;
  const int n = b / cluster;
  return b % cluster == 0 && n <= kMaxHadamardChunk &&
         (cluster == 1 || n >= kWarpSpan);
}

template <typename T>
cudaError_t launch(const void* x, void* y, int nblocks, int b, float scale,
                   int cluster, cudaStream_t stream) {
  if (!hadamard_cluster_ok(b, cluster)) return cudaErrorInvalidValue;
  const int n = b / cluster;
  cudaError_t err = launch_cluster(
      hadamard_cluster_kernel<1, T>, hadamard_cluster_kernel<2, T>,
      hadamard_cluster_kernel<4, T>, hadamard_cluster_kernel<8, T>, cluster,
      nblocks, 1, n, stream, (const T*)x, (float*)y, b, scale, n, log2i(n));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y = H_b x * scale for each of the n contiguous blocks of b = r*c values,
// each split across a cluster of `cluster` CTAs; x (n, b) fp32 or, when
// `bf16`, bf16; y (n, b) fp32.
int hadamard_blocks_fwd(const void* x, void* y, int n, int b, int bf16,
                        float scale, int cluster, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(bf16 ? launch<__nv_bfloat16>(x, y, n, b, scale, cluster, s)
                    : launch<float>(x, y, n, b, scale, cluster, s));
}

}  // extern "C"
