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
// b-vector, so here it runs as log2(b) radix-2 butterfly stages (h = 1, 2,
// 4, ...). This is exact fp32 arithmetic (adds and subtracts only, no
// TF32): the lattice scale gamma can be as small as 2^-18 max|y|, so
// y/gamma needs ~18 mantissa bits. The plain PyTorch version in
// kernels/exchange.py runs the same stages in the same order, each pair
// (a, c) at h apart giving a + c and a - c with a the lower index, so the
// two agree bit for bit.
//
// The butterfly. exch_rotate, exch_encode and exch_decode, on the federated
// paths at 1-16 messages of two 16,384-blocks, would start only 2-32 CTAs
// with one CTA a block, each waiting on 14 (decode 28) barriers:
// latency-bound. So all three split a block of b coordinates across a
// thread-block cluster of C CTAs (Hopper's distributed shared memory), each
// holding a chunk of n = b / C contiguous coordinates (2,048 at b = 16,384,
// C = 8), 8 of them a thread:
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
// At n = 2,048 that is 2 barriers and 2 cluster barriers a transform instead
// of 14 barriers. The wrapper picks C from the geometry: b / 2,048, at most
// 8 (the portable cluster size), at most r / pack so that every CTA's chunk
// holds whole groups of `pack` rows of the (r, c) block (a packed byte never
// spans two CTAs; pack is 1 for the rotation), and C = 1 for b <= 2,048.
//
// The snap has no butterfly: one thread takes 8 contiguous coordinates of
// one message row, with 16-byte loads and stores and, for packed codes, one
// 8-byte load of the 8 bytes that hold them.
//
// Bound. All five kernels are memory-bound on an H100: the butterfly does
// log2(b) <= 14 adds per coordinate against 8-16 bytes moved, far below the
// card's ~20 fp32 flop/byte ridge. The design therefore reads every input
// once and writes every output once (the rotated block never leaves the
// SMs between the rotation and the quantize, nor between the snap and the
// inverse rotation), and keeps the elementwise kernels to one coalesced
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

#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

// ---------------------------------------------------------------------------
// the cluster butterfly of exch_rotate, exch_encode and exch_decode
// ---------------------------------------------------------------------------

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

// (H_b x*s) / sqrt(b), or s * (H_b x) / sqrt(b) when `inverse`, of one
// (message i, block j) pair by a cluster of C CTAs (grid (nb * C, m)); CTA
// `rank` holds block coordinates rank * n .. rank * n + n - 1.
template <int C>
__global__ void __launch_bounds__(kMaxChunk / kVals)
rotate_cluster_kernel(const float* __restrict__ x,
                      const float* __restrict__ signs, float* __restrict__ y,
                      int d_pad, int b, float scale, int inverse, int n,
                      int k) {
  extern __shared__ float sm[];
  const int j = blockIdx.x / C;
  const int rank = blockIdx.x % C;
  const int t = threadIdx.x;
  // coordinates this thread holds: 8, or fewer in a chunk under 8, or none
  // for the threads past a chunk under a warp's span
  const int nv = kVals * t < n ? min(kVals, n - kVals * t) : 0;
  // the CTA's chunk within a message, and the message's row
  const size_t chunk = (size_t)j * b + (size_t)rank * n;
  const size_t row = (size_t)blockIdx.y * d_pad;
  float v[kVals], sg[kVals];
  load8(x + row + chunk, kVals * t, n, v);
  load8(signs + chunk, kVals * t, n, sg);
  if (!inverse) {
#pragma unroll
    for (int e = 0; e < kVals; ++e) v[e] = __fmul_rn(v[e], sg[e]);
  }
  fwht_block<C>(v, sm, n, k, nv);
#pragma unroll
  for (int e = 0; e < kVals; ++e) {
    const float w = __fmul_rn(sm[kVals * t + e], scale);
    v[e] = inverse ? __fmul_rn(w, sg[e]) : w;
  }
  store8(y + row + chunk + kVals * t, nv, v);
}

// Rotate + stochastic round + wrap of one (message i, block j) pair by a
// cluster of C CTAs (grid (nb * C, m)); CTA `rank` holds block coordinates
// rank * n .. rank * n + n - 1.
template <int C>
__global__ void __launch_bounds__(kMaxChunk / kVals)
encode_cluster_kernel(const float* __restrict__ x,
                      const float* __restrict__ signs, int sign_stride,
                      const float* __restrict__ u,
                      const float* __restrict__ gam, int gam_stride,
                      const float* __restrict__ levels, int lev_stride,
                      float levels_default, int32_t* __restrict__ codes32,
                      uint8_t* __restrict__ codes8, float* __restrict__ yout,
                      int d_pad, int b, int c, int bits, int pack,
                      float scale, int n, int k) {
  extern __shared__ float sm[];
  const int j = blockIdx.x / C;
  const int rank = blockIdx.x % C;
  const int i = blockIdx.y;
  const int t = threadIdx.x;
  // coordinates this thread holds: 8, or fewer in a chunk under 8, or none
  // for the threads past a chunk under a warp's span
  const int nv = kVals * t < n ? min(kVals, n - kVals * t) : 0;
  // the CTA's chunk of message i, and this thread's first coordinate
  const size_t chunk = (size_t)i * d_pad + (size_t)j * b + (size_t)rank * n;
  const size_t at = chunk + kVals * t;
  float v[kVals], sg[kVals];
  load8(x + chunk, kVals * t, n, v);
  load8(signs + (size_t)i * sign_stride + (chunk - (size_t)i * d_pad),
        kVals * t, n, sg);
#pragma unroll
  for (int e = 0; e < kVals; ++e) v[e] = __fmul_rn(v[e], sg[e]);
  fwht_block<C>(v, sm, n, k, nv);

  const float g = gam[(size_t)i * gam_stride];
  const float L = levels != nullptr ? levels[(size_t)i * lev_stride]
                                    : levels_default;
  float y[kVals];
#pragma unroll
  for (int e = 0; e < kVals; ++e) y[e] = __fmul_rn(sm[kVals * t + e], scale);
  if (yout != nullptr) store8(yout + at, nv, y);
  if (pack == 1) {
    float uu[kVals];
    load8(u + chunk, kVals * t, n, uu);
    int32_t q[kVals];
#pragma unroll
    for (int e = 0; e < kVals; ++e)
      q[e] = (int32_t)quantize_one(y[e], g, uu[e], L);
    store8(codes32 + at, nv, q);
    return;
  }
  // byte (p, col) of the chunk packs rows p*pack .. p*pack+pack-1 of its
  // column: rows of this CTA alone, as n / c is a multiple of pack
  const float* uu = u + chunk;
  const int nbytes = n / pack;
  const size_t obase = (size_t)i * (d_pad / pack) + (size_t)j * (b / pack) +
                       (size_t)rank * nbytes;
  for (int o = t; o < nbytes; o += blockDim.x) {
    const int p = o / c;
    const int col = o - p * c;
    unsigned acc = 0;
    for (int tt = 0; tt < pack; ++tt) {
      const int e = (p * pack + tt) * c + col;
      acc |= quantize_one(__fmul_rn(sm[e], scale), g, uu[e], L)
             << (tt * bits);
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

// code[e] of coordinates e0 .. e0 + nv - 1 of one message from its packed
// bytes `cb`. With c a multiple of 8 a group of 8 lies in one row of one
// (r, c) block, and its 8 bytes are contiguous at (row / pack) * c + col:
// one 8-byte load, each byte shifted by (row % pack) * bits. Otherwise (c <
// 8, a short group, an unaligned row) byte by byte, every read at or below
// e0 + nv - 1 (nv >= 1).
__device__ __forceinline__ void unpack8(const uint8_t* __restrict__ cb,
                                        int e0, int nv, int b, int c,
                                        int bits, int pack,
                                        float code[kVals]) {
  const unsigned mask = (1u << bits) - 1u;
  if (nv == kVals && c % kVals == 0) {
    const int j = e0 / b;
    const int rem = e0 - j * b;
    const int row = rem / c;
    const int col = rem - row * c;
    const uint8_t* p = cb + (size_t)j * (b / pack) + (size_t)(row / pack) * c
                       + col;
    if (((uintptr_t)p & 7) == 0) {
      const uint2 word = *reinterpret_cast<const uint2*>(p);
      const int shift = (row % pack) * bits;
#pragma unroll
      for (int e = 0; e < kVals; ++e) {
        const unsigned w4 = e < 4 ? word.x : word.y;
        code[e] = (float)((w4 >> (8 * (e & 3) + shift)) & mask);
      }
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < kVals; ++e) {
    const int at = e0 + min(e, nv - 1);
    const int j = at / b;
    const int rem = at - j * b;
    const int row = rem / c;
    const int col = rem - row * c;
    const unsigned byte =
        cb[(size_t)j * (b / pack) + (size_t)(row / pack) * c + col];
    code[e] = (float)((byte >> ((row % pack) * bits)) & mask);
  }
}

constexpr int kSnapThreads = 256;

// Positional snap: thread t of CTA (x, y) takes coordinates e0 .. e0 + 7,
// e0 = 8 (x * blockDim.x + t), of message y (and y + gridDim.y, ... past
// the grid's 65,535 rows). Code row i is codes row (mc == 1 ? 0 : i),
// reference row (mw == 1 ? 0 : i).
__global__ void __launch_bounds__(kSnapThreads)
snap_vec_kernel(const int32_t* __restrict__ codes32,
                const uint8_t* __restrict__ codes8, int mc,
                const float* __restrict__ w, int mw,
                const float* __restrict__ gam, int gam_stride,
                const float* __restrict__ levels, int lev_stride,
                float levels_default, float* __restrict__ out, int m,
                int d_pad, int b, int c, int bits, int pack) {
  const int e0 = kVals * (blockIdx.x * blockDim.x + threadIdx.x);
  if (e0 >= d_pad) return;
  const int nv = min(kVals, d_pad - e0);
  for (int i = blockIdx.y; i < m; i += gridDim.y) {
    const size_t ci = mc == 1 ? 0 : (size_t)i;
    const size_t wi = mw == 1 ? 0 : (size_t)i;
    const float g = gam[(size_t)i * gam_stride];
    const float L = levels != nullptr ? levels[(size_t)i * lev_stride]
                                      : levels_default;
    float code[kVals], wv[kVals], v[kVals];
    if (pack == 1)
      load8(codes32 + ci * d_pad, e0, d_pad, code);
    else
      unpack8(codes8 + ci * (d_pad / pack), e0, nv, b, c, bits, pack, code);
    load8(w + wi * d_pad, e0, d_pad, wv);
#pragma unroll
    for (int e = 0; e < kVals; ++e) v[e] = snap_one(code[e], wv[e], g, L);
    store8(out + (size_t)i * d_pad + e0, nv, v);
  }
}

// Full Dec(ref, msg) of one (message i, block j) pair by a cluster of C
// CTAs: rotate the reference block, snap every code to the representative
// nearest it, inverse-rotate; each transform with its own cluster exchange.
// Code row i is codes row (mc == 1 ? 0 : i), reference row (mr == 1 ? 0 :
// i).
template <int C>
__global__ void __launch_bounds__(kMaxChunk / kVals)
decode_cluster_kernel(const int32_t* __restrict__ codes32,
                      const uint8_t* __restrict__ codes8, int mc,
                      const float* __restrict__ ref, int mr,
                      const float* __restrict__ signs, int sign_stride,
                      const float* __restrict__ gam, int gam_stride,
                      const float* __restrict__ levels, int lev_stride,
                      float levels_default, float* __restrict__ out,
                      int d_pad, int b, int c, int bits, int pack,
                      float scale, int n, int k) {
  extern __shared__ float sm[];
  const int j = blockIdx.x / C;
  const int rank = blockIdx.x % C;
  const int i = blockIdx.y;
  const int t = threadIdx.x;
  // coordinates this thread holds: 8, or fewer in a chunk under 8, or none
  // for the threads past a chunk under a warp's span
  const int nv = kVals * t < n ? min(kVals, n - kVals * t) : 0;
  const size_t ci = mc == 1 ? 0 : (size_t)i;
  const size_t ri = mr == 1 ? 0 : (size_t)i;
  const int e0 = rank * n + kVals * t;  // the thread's first in the block
  // the CTA's chunk within a message, and this thread's first coordinate
  const size_t chunk = (size_t)j * b + (size_t)rank * n;
  const size_t in_msg = chunk + kVals * t;
  float v[kVals], sg[kVals];
  load8(ref + ri * d_pad + chunk, kVals * t, n, v);
  load8(signs + (size_t)i * sign_stride + chunk, kVals * t, n, sg);
#pragma unroll
  for (int e = 0; e < kVals; ++e) v[e] = __fmul_rn(v[e], sg[e]);
  fwht_block<C>(v, sm, n, k, nv);

  const float g = gam[(size_t)i * gam_stride];
  const float L = levels != nullptr ? levels[(size_t)i * lev_stride]
                                    : levels_default;
  float code[kVals];
  if (pack == 1) {
    load8(codes32 + ci * d_pad + chunk, kVals * t, n, code);
  } else {
    const unsigned mask = (1u << bits) - 1u;
    const uint8_t* cb = codes8 + ci * (d_pad / pack) + (size_t)j * (b / pack);
#pragma unroll
    for (int e = 0; e < kVals; ++e) {
      const int at = min(e0 + e, rank * n + n - 1);  // inside the chunk
      const int row = at / c;
      const int col = at - row * c;
      const unsigned byte = cb[(size_t)(row / pack) * c + col];
      code[e] = (float)((byte >> ((row % pack) * bits)) & mask);
    }
  }
#pragma unroll
  for (int e = 0; e < kVals; ++e)
    v[e] = snap_one(code[e], __fmul_rn(sm[kVals * t + e], scale), g, L);
  fwht_block<C>(v, sm, n, k, nv);
#pragma unroll
  for (int e = 0; e < kVals; ++e)
    v[e] = __fmul_rn(__fmul_rn(sm[kVals * t + e], scale), sg[e]);
  store8(out + (size_t)i * d_pad + in_msg, nv, v);
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

extern "C" {

// y = (H_b x*signs) / sqrt(b) per block, or signs * (H_b x) / sqrt(b) when
// `inverse`. x, y: (m, d_pad) fp32; signs: (d_pad,) fp32; each block split
// across a cluster of `cluster` CTAs.
int exch_rotate(const void* x, const void* signs, void* y, int m, int d_pad,
                int b, int inverse, float scale, int cluster, void* stream) {
  if (!cluster_ok(b, cluster)) return (int)cudaErrorInvalidValue;
  const int n = b / cluster;
  cudaError_t err = launch_cluster(
      rotate_cluster_kernel<1>, rotate_cluster_kernel<2>,
      rotate_cluster_kernel<4>, rotate_cluster_kernel<8>, cluster, d_pad / b,
      m, n, (cudaStream_t)stream, (const float*)x, (const float*)signs,
      (float*)y, d_pad, b, scale, inverse, n, log2i(n));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Rotate + stochastic round + wrap. codes32 (m, d_pad) int32 when pack == 1,
// else codes8 (m, d_pad / pack) uint8; yout (m, d_pad) fp32 or null; signs
// (d_pad,) with sign_stride 0 or (m, d_pad) with sign_stride d_pad; each
// block split across a cluster of `cluster` CTAs.
int exch_encode(const void* x, const void* signs, int sign_stride,
                const void* u,
                const void* gam, int gam_stride, const void* levels,
                int lev_stride, float levels_default, void* codes32,
                void* codes8, void* yout, int m, int d_pad, int b, int c,
                int bits, int pack, float scale, int cluster, void* stream) {
  if (!cluster_ok(b, cluster)) return (int)cudaErrorInvalidValue;
  const int n = b / cluster;
  cudaError_t err = launch_cluster(
      encode_cluster_kernel<1>, encode_cluster_kernel<2>,
      encode_cluster_kernel<4>, encode_cluster_kernel<8>, cluster, d_pad / b,
      m, n, (cudaStream_t)stream, (const float*)x, (const float*)signs,
      sign_stride, (const float*)u, (const float*)gam, gam_stride,
      (const float*)levels, lev_stride, levels_default, (int32_t*)codes32,
      (uint8_t*)codes8, (float*)yout, d_pad, b, c, bits, pack, scale, n,
      log2i(n));
  if (err != cudaSuccess) return (int)err;
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
  const int per_cta = kVals * kSnapThreads;
  dim3 grid((d_pad + per_cta - 1) / per_cta, m < 65535 ? m : 65535);
  snap_vec_kernel<<<grid, kSnapThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)codes32, (const uint8_t*)codes8, mc, (const float*)w,
      mw, (const float*)gam, gam_stride, (const float*)levels, lev_stride,
      levels_default, (float*)out, m, d_pad, b, c, bits, pack);
  return (int)cudaGetLastError();
}

// Full Dec(ref, msg): mc code rows against mr reference rows in original
// coordinates (either may be 1 and broadcasts); signs as exch_encode's;
// out (m, d_pad) fp32, m = max(mc, mr); each block split across a cluster
// of `cluster` CTAs.
int exch_decode(const void* codes32, const void* codes8, int mc,
                const void* ref, int mr, const void* signs, int sign_stride,
                const void* gam, int gam_stride, const void* levels,
                int lev_stride, float levels_default, void* out, int m,
                int d_pad, int b, int c, int bits, int pack, float scale,
                int cluster, void* stream) {
  if (!cluster_ok(b, cluster)) return (int)cudaErrorInvalidValue;
  const int n = b / cluster;
  cudaError_t err = launch_cluster(
      decode_cluster_kernel<1>, decode_cluster_kernel<2>,
      decode_cluster_kernel<4>, decode_cluster_kernel<8>, cluster, d_pad / b,
      m, n, (cudaStream_t)stream, (const int32_t*)codes32,
      (const uint8_t*)codes8, mc, (const float*)ref, mr, (const float*)signs,
      sign_stride, (const float*)gam, gam_stride, (const float*)levels,
      lev_stride, levels_default, (float*)out, d_pad, b, c, bits, pack, scale,
      n, log2i(n));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
