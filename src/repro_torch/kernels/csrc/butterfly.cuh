// The thread-block-cluster butterfly of the Hopper rotations: the unscaled
// Sylvester transform H_b of one block of b = 2^k fp32 coordinates, split
// across a cluster of C CTAs (Hopper's distributed shared memory), each
// holding a chunk of n = b / C contiguous coordinates, 8 of them a thread:
//
//   h = 1, 2, 4        in each thread's registers;
//   h = 8 .. 128       across the lanes of a warp (__shfl_xor_sync);
//   h = 256 .. n / 2   through shared memory, three stages a pass: a thread
//                      reads the 8 coordinates that differ in three index
//                      bits, runs the stages in registers, writes them back;
//   h = n .. b / 2     across the cluster: after cluster.sync() each CTA
//                      gathers its share of offsets from all C peers'
//                      shared memory, runs the stages in registers, writes
//                      the results back to their owners, cluster.sync().
//
// Every stage pairs (a, c) at h apart into a + c and a - c with a the lower
// index, in the order h = 1, 2, 4, ..., as the plain PyTorch version
// (kernels/exchange.py, _fwht) runs them, so the two agree bit for bit.
// Used by exchange.cu (rotate, encode, decode) and hadamard.cu, with
// load8 and store8 (8 coordinates a thread in 16-byte accesses) and
// launch_cluster (a kernel<C> on clusters of C CTAs). kernels/build.py
// hashes every header into each library's name.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kVals = 8;                   // coordinates a thread holds
constexpr int kWarpSpan = kVals * 32;      // what register + lane stages span
constexpr int kMaxChunk = 4096;            // largest chunk the wrapper picks
constexpr int kMaxCluster = 8;             // the portable cluster size

int chunk_threads(int n) {
  const int t = n / kVals;
  return t < 32 ? 32 : t;
}

// One butterfly stage on bit P of the register index: pairs (e, e + 2^P).
template <int P>
__device__ __forceinline__ void reg_stage(float v[kVals]) {
#pragma unroll
  for (int e = 0; e < kVals; ++e) {
    if (e & (1 << P)) continue;
    const float a = v[e];
    const float c = v[e | (1 << P)];
    v[e] = __fadd_rn(a, c);
    v[e | (1 << P)] = __fsub_rn(a, c);
  }
}

__device__ __forceinline__ float as_float(int w, const float*) {
  return __int_as_float(w);
}
__device__ __forceinline__ float as_float(int w, const int32_t*) {
  return (float)w;  // a code, below 2^16: exact
}

// v[e] = chunk[off + e] as a float for off + e < n, 0 beyond; two 16-byte
// loads when it can. Every address read lies inside the chunk.
template <typename T>
__device__ __forceinline__ void load8(const T* __restrict__ chunk, int off,
                                      int n, float v[kVals]) {
  static_assert(sizeof(T) == 4, "4-byte elements");
  const T* p = chunk + off;
  if (off + kVals <= n && ((uintptr_t)p & 15) == 0) {
    const int4 a = reinterpret_cast<const int4*>(p)[0];
    const int4 b = reinterpret_cast<const int4*>(p)[1];
    const int w[kVals] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int e = 0; e < kVals; ++e) v[e] = as_float(w[e], p);
    return;
  }
#pragma unroll
  for (int e = 0; e < kVals; ++e) {
    const float x = (float)chunk[min(off + e, n - 1)];
    v[e] = off + e < n ? x : 0.f;
  }
}

__device__ __forceinline__ void store4x2(float* p, const float v[kVals]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store4x2(int32_t* p, const int32_t v[kVals]) {
  reinterpret_cast<int4*>(p)[0] = make_int4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<int4*>(p)[1] = make_int4(v[4], v[5], v[6], v[7]);
}

// p[e] = v[e] for e < nv; two 16-byte stores when it can.
template <typename T>
__device__ __forceinline__ void store8(T* p, int nv, const T v[kVals]) {
  if (nv == kVals && ((uintptr_t)p & 15) == 0) {
    store4x2(p, v);
    return;
  }
#pragma unroll
  for (int e = 0; e < kVals; ++e)
    if (e < nv) p[e] = v[e];
}

// Unscaled H_n on the CTA's chunk of n = 2^k coordinates, thread t holding
// chunk coordinates 8t .. 8t + nv - 1 in v: stages h = 1, 2, 4 in
// registers, h = 8 .. 128 across lanes, h = 256 .. n/2 through shared
// memory. Leaves the chunk in sm, visible to the whole CTA.
__device__ __forceinline__ void fwht_chunk(float v[kVals], float* sm,
                                           int n, int k, int nv) {
  const int t = threadIdx.x;
  if (n > 1) reg_stage<0>(v);
  if (n > 2) reg_stage<1>(v);
  if (n > 4) reg_stage<2>(v);
  const int lane = t & 31;
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    if ((kVals << s) >= n) break;
    // lane ^ 2^s holds the coordinates h = 8 * 2^s away; the lower of the
    // two keeps a + c, the upper a - c with a the partner's value
    const bool upper = (lane >> s) & 1;
#pragma unroll
    for (int e = 0; e < kVals; ++e) {
      const float o = __shfl_xor_sync(0xffffffffu, v[e], 1 << s);
      v[e] = upper ? __fsub_rn(o, v[e]) : __fadd_rn(v[e], o);
    }
  }
  store8(sm + kVals * t, nv, v);
  __syncthreads();
  // above a warp's span, three stages a pass over index bits w .. w+2; the
  // window slides down at the top (w = k - 3) so it stays in the chunk, and
  // the stages below lo in it, done already, are not run again
  for (int lo = 8; lo < k; lo += 3) {
    const int w = lo < k - 3 ? lo : k - 3;
    const int base = (t & ((1 << w) - 1)) | ((t >> w) << (w + 3));
    float x[kVals];
#pragma unroll
    for (int e = 0; e < kVals; ++e) x[e] = sm[base + (e << w)];
    if (lo - w <= 0) reg_stage<0>(x);
    if (lo - w <= 1) reg_stage<1>(x);
    reg_stage<2>(x);
#pragma unroll
    for (int e = 0; e < kVals; ++e) sm[base + (e << w)] = x[e];
    __syncthreads();
  }
}

// The last log2(C) stages, h = n .. b/2, across the cluster's C chunks of
// one block (C > 1, n >= 256, blockDim.x = n / 8). CTA `rank` takes offsets
// rank * n/C .. (rank+1) * n/C - 1 of every chunk; thread t the 8/C of them
// t + j * blockDim.x, from each of the C peers: register index e = j*C + p
// holds peer p's value, so register bit s is stage h = n * 2^s. Leaves
// every chunk finished in its owner's sm; the closing cluster.sync() also
// means no CTA reads a peer's shared memory after it (none exits early).
template <int C>
__device__ __forceinline__ void cluster_stages(float* sm, int n) {
  static_assert(C > 1 && C <= kMaxCluster, "cluster of 2, 4 or 8");
  constexpr int kPer = kVals / C;
  cg::cluster_group cluster = cg::this_cluster();
  const int first = (int)cluster.block_rank() * (n / C) + threadIdx.x;
  float* peer[C];
#pragma unroll
  for (int p = 0; p < C; ++p) peer[p] = cluster.map_shared_rank(sm, p);
  cluster.sync();  // every chunk of the block is through its local stages
  float w[kVals];
#pragma unroll
  for (int j = 0; j < kPer; ++j)
#pragma unroll
    for (int p = 0; p < C; ++p)
      w[j * C + p] = peer[p][first + j * blockDim.x];
  reg_stage<0>(w);
  if (C > 2) reg_stage<1>(w);
  if (C > 4) reg_stage<2>(w);
#pragma unroll
  for (int j = 0; j < kPer; ++j)
#pragma unroll
    for (int p = 0; p < C; ++p)
      peer[p][first + j * blockDim.x] = w[j * C + p];
  cluster.sync();
}

// H_b on the cluster's block: the chunk's stages, then the cluster's.
template <int C>
__device__ __forceinline__ void fwht_block(float v[kVals], float* sm, int n,
                                           int k, int nv) {
  fwht_chunk(v, sm, n, k, nv);
  if constexpr (C > 1) cluster_stages<C>(sm, n);
}

// Launches kernel<C>, given as its instantiations k1, k2, k4 and k8, on
// grid (nb * C, m) in clusters of (C, 1, 1), n = b / C coordinates a CTA.
// C must be 1, 2, 4 or 8, and n at most kMaxChunk and, when C > 1, at
// least a warp's span.
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*k1)(Params...), void (*k2)(Params...),
                           void (*k4)(Params...), void (*k8)(Params...),
                           int cluster, int nb, int m, int n,
                           cudaStream_t stream, Args... args) {
  void (*kernel)(Params...) =
      cluster == 1 ? k1 : cluster == 2 ? k2 : cluster == 4 ? k4 : k8;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb * cluster, m);
  cfg.blockDim = dim3(chunk_threads(n));
  // a chunk under a warp's span still gets 8 floats a thread, so that no
  // thread reads past the CTA's shared memory
  cfg.dynamicSmemBytes = (size_t)kVals * chunk_threads(n) * sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

bool cluster_ok(int b, int cluster) {
  if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8)
    return false;
  const int n = b / cluster;
  return b % cluster == 0 && n <= kMaxChunk &&
         (cluster == 1 || n >= kWarpSpan);
}

int log2i(int n) {
  int k = 0;
  while ((1 << k) < n) ++k;
  return k;
}

}  // namespace
