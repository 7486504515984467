// Blocked Hadamard transform for Hopper (sm_90a).
//
// CUDA counterpart of the Pallas TPU kernel in src/repro/kernels/hadamard.py
// (hadamard_blocks / _hadamard_kernel): y = (H_r X H_c) / sqrt(r c) for every
// (r, c) block X of an (n, r, c) batch. It is the core of the rotation in
// kernels/ops.py (rotate_blocks, the counterpart of rotate_pallas).
//
// Design. On the TPU, H_r X H_c is two MXU matmuls per block. H_r (x) H_c on
// the row-major (r, c) block is the Sylvester H_rc on the contiguous
// rc-vector, for any split of rc (exchange.cu says why), so one CTA holds one
// block in shared memory and runs log2(rc) radix-2 butterfly stages
// (h = 1, 2, 4, ...; fwht_shared in common.cuh, the stages of the rotation
// kernels). The adds are exact fp32 (__fadd_rn, __fsub_rn), with no TF32:
// H's entries are +-1, and a TF32 tensor-core product would round X to 10
// mantissa bits, 5e-4 relative, outside the rotation tolerance. The plain
// PyTorch version (kernels/hadamard.py, hadamard_plain) runs the same stages
// in the same order and multiplies by the same fp32 scale, so the two agree
// bit for bit.
//
// Input. fp32 or bf16, by a template on the input type: a bf16 block is
// widened to fp32 as it is loaded (exact, as the TPU kernel's astype), so
// the wrapper adds no cast pass. The output is fp32.
//
// Block size. rc up to 32,768 floats, 128 KiB of dynamic shared memory, raised
// per kernel above the 48 KB default (allow_shared).
//
// Bound. Bytes: 8 per coordinate for fp32 input, 6 for bf16 (read X, write
// y), against log2(rc) <= 15 adds and one multiply per coordinate, far below
// the card's fp32 ops/byte ridge. Every coordinate crosses device memory
// once each way.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
hadamard_kernel(const T* __restrict__ x, float* __restrict__ y, int b,
                float scale) {
  extern __shared__ float sm[];
  const size_t base = (size_t)blockIdx.x * b;
  for (int e = threadIdx.x; e < b; e += blockDim.x)
    sm[e] = to_f32(x[base + e]);
  __syncthreads();
  fwht_shared(sm, b);
  for (int e = threadIdx.x; e < b; e += blockDim.x)
    y[base + e] = __fmul_rn(sm[e], scale);
}

template <typename T>
cudaError_t launch(const void* x, void* y, int n, int b, float scale,
                   cudaStream_t stream) {
  const size_t smem = (size_t)b * sizeof(float);
  cudaError_t err = allow_shared(hadamard_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  hadamard_kernel<T><<<n, block_threads(b), smem, stream>>>(
      (const T*)x, (float*)y, b, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y = H_b x * scale for each of the n contiguous blocks of b = r*c values;
// x (n, b) fp32 or, when `bf16`, bf16; y (n, b) fp32.
int hadamard_blocks_fwd(const void* x, void* y, int n, int b, int bf16,
                        float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(bf16 ? launch<__nv_bfloat16>(x, y, n, b, scale, s)
                    : launch<float>(x, y, n, b, scale, s));
}

}  // extern "C"
