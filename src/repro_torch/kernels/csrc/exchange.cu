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
// and two variants of the snap that replace no TPU kernel: they take over
// the fp32 passes the QuAFL round ran around its two snaps (on the TPU, XLA
// fuses those into its own loops):
//
//   exch_uplink    <- uplink  (the uplink snap, the server average and the
//                              round's error norms)
//   exch_average   <- average (the downlink snap and the clients' average,
//                              in place)
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
// C = 8), 8 of them a thread: registers, lanes, shared memory, then the
// cluster (butterfly.cuh, fwht_block<C>, which hadamard.cu shares).
//
// At n = 2,048 that is 2 barriers and 2 cluster barriers a transform instead
// of 14 barriers. The wrapper picks C from the geometry: b / 2,048, at most
// 8 (the portable cluster size), at most r / pack so that every CTA's chunk
// holds whole groups of `pack` rows of the (r, c) block (a packed byte never
// spans two CTAs; pack is 1 for the rotation), and C = 1 for b <= 2,048.
//
// The snap and the quantize have no butterfly: one thread takes 8
// contiguous coordinates (or packed bytes) of one message row (the quantize
// 2 on a launch too small to fill the card), with 16-byte loads and stores
// of the floats and codes and one access to the packed bytes that hold
// them.
//
// Bound. All seven kernels are memory-bound on an H100: the butterfly does
// log2(b) <= 14 adds per coordinate against 8-16 bytes moved, far below the
// card's ~20 fp32 flop/byte ridge. The design therefore reads every input
// once and writes every output once (the rotated block never leaves the
// SMs between the rotation and the quantize, nor between the snap and the
// inverse rotation; a snapped row of the QuAFL round never leaves them
// between its snap and the averages and norms that read it), and keeps the
// elementwise kernels to one coalesced pass.
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

#include "butterfly.cuh"
#include "common.cuh"

namespace {

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

// CTAs of the vectorised snap and quantize: 256 threads, 8 coordinates (or
// packed bytes; for the quantize V of them) a thread.
constexpr int kVecThreads = 256;

// v[e] = p[off + e] for off + e < n, 0 beyond, V (2 or 8) of them in one
// 8-byte load (V = 2) or load8's two 16-byte loads where it can; every read
// inside p[0 .. n - 1].
template <int V>
__device__ __forceinline__ void loadv(const float* __restrict__ p, int off,
                                      int n, float v[V]) {
  if constexpr (V == kVals) {
    load8(p, off, n, v);
  } else {
    const float* q = p + off;
    if (off + V <= n && ((uintptr_t)q & (4 * V - 1)) == 0) {
      const float2 a = *reinterpret_cast<const float2*>(q);
      v[0] = a.x, v[1] = a.y;
      return;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float x = p[min(off + e, n - 1)];
      v[e] = off + e < n ? x : 0.f;
    }
  }
}

// p[e] = v[e] for e < nv, in one 8-byte store (V = 2) or two 16-byte
// stores (V = 8) where it can.
template <int V>
__device__ __forceinline__ void storev(int32_t* p, int nv,
                                       const int32_t v[V]) {
  if constexpr (V == kVals) {
    store8(p, nv, v);
  } else {
    if (nv == V && ((uintptr_t)p & (4 * V - 1)) == 0) {
      *reinterpret_cast<int2*>(p) = make_int2(v[0], v[1]);
      return;
    }
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (e < nv) p[e] = v[e];
  }
}

// Stochastic round + wrap of already-rotated y: thread t of CTA (x, y)
// takes outputs o0 .. o0 + V - 1, o0 = V (x * blockDim.x + t), of the per
// = d_pad / pack outputs of message y (and y + gridDim.y, ... past the
// grid's 65,535 rows); V = 8, or 2 on a launch too small to fill the card
// (there each thread's latency bounds the launch). Unpacked (pack 1),
// output o is coordinate o: V contiguous floats of y and u (two 16-byte
// loads each at V = 8, one 8-byte load at V = 2), V int32 codes stored the
// same way. Packed, with c a multiple of V, the V bytes (p, k .. k + V - 1)
// of block j lie in one row p of its packed bytes and hold columns k .. k +
// V - 1 of coordinate rows p*pack .. p*pack + pack - 1: V contiguous floats
// of y and u from each of the pack rows, OR-ed into bytes, one V-byte
// store. Otherwise (c < V, a short row, an unaligned output) byte by byte,
// every read inside the row.
template <int V>
__global__ void __launch_bounds__(kVecThreads)
quantize_vec_kernel(const float* __restrict__ y, const float* __restrict__ u,
                    const float* __restrict__ gam, int gam_stride,
                    const float* __restrict__ levels, int lev_stride,
                    float levels_default, int32_t* __restrict__ codes32,
                    uint8_t* __restrict__ codes8, int m, int d_pad, int b,
                    int c, int bits, int pack) {
  static_assert(V == 2 || V == kVals, "2 or 8 outputs a thread");
  const int per = d_pad / pack;
  const int o0 = V * (blockIdx.x * blockDim.x + threadIdx.x);
  if (o0 >= per) return;
  const int nv = min(V, per - o0);
  const int nbytes = b / pack;  // packed bytes a block
  for (int i = blockIdx.y; i < m; i += gridDim.y) {
    const float g = gam[(size_t)i * gam_stride];
    const float L = levels != nullptr ? levels[(size_t)i * lev_stride]
                                      : levels_default;
    const float* yi = y + (size_t)i * d_pad;
    const float* ui = u + (size_t)i * d_pad;
    float yv[V], uv[V];
    if (pack == 1) {
      loadv<V>(yi, o0, d_pad, yv);
      loadv<V>(ui, o0, d_pad, uv);
      int32_t q[V];
#pragma unroll
      for (int e = 0; e < V; ++e)
        q[e] = (int32_t)quantize_one(yv[e], g, uv[e], L);
      storev<V>(codes32 + (size_t)i * d_pad + o0, nv, q);
      continue;
    }
    uint8_t* out = codes8 + (size_t)i * per + o0;
    if (nv == V && c % V == 0 && ((uintptr_t)out & (V - 1)) == 0) {
      const int j = o0 / nbytes;
      const int rem = o0 - j * nbytes;
      const int p = rem / c;
      const int e0 = j * b + p * pack * c + (rem - p * c);
      unsigned acc[V] = {};
      for (int tt = 0; tt < pack; ++tt) {
        loadv<V>(yi, e0 + tt * c, d_pad, yv);
        loadv<V>(ui, e0 + tt * c, d_pad, uv);
#pragma unroll
        for (int e = 0; e < V; ++e)
          acc[e] |= quantize_one(yv[e], g, uv[e], L) << (tt * bits);
      }
      // the V bytes as one little-endian word
      unsigned long long word = 0;
#pragma unroll
      for (int e = 0; e < V; ++e)
        word |= (unsigned long long)(acc[e] & 0xffu) << (8 * e);
      if constexpr (V == 8)
        *reinterpret_cast<unsigned long long*>(out) = word;
      else
        *reinterpret_cast<unsigned short*>(out) = (unsigned short)word;
      continue;
    }
    for (int e = 0; e < nv; ++e) {
      const int j = (o0 + e) / nbytes;
      const int rem = o0 + e - j * nbytes;
      const int p = rem / c;
      const int at = j * b + p * pack * c + (rem - p * c);
      unsigned acc = 0;
      for (int tt = 0; tt < pack; ++tt)
        acc |= quantize_one(yi[at + tt * c], g, ui[at + tt * c], L)
               << (tt * bits);
      out[e] = (uint8_t)acc;
    }
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

// Positional snap: thread t of CTA (x, y) takes coordinates e0 .. e0 + 7,
// e0 = 8 (x * blockDim.x + t), of message y (and y + gridDim.y, ... past
// the grid's 65,535 rows). Code row i is codes row (mc == 1 ? 0 : i),
// reference row (mw == 1 ? 0 : i).
__global__ void __launch_bounds__(kVecThreads)
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

// Rows of the uplink snap whose per-warp sums a CTA holds at once; a round
// with more messages takes them kUpRows at a time, the running server sum
// kept in `out` between the groups. The finish takes kFinishRows at a time.
constexpr int kUpRows = 32;
constexpr int kFinishRows = 1024;
constexpr int kWarps = kVecThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// v[e] = p[off + e] for off + e < n, 0 beyond: load8 at V = 8, else one
// access a value (a warp's accesses still coalesce); reads inside p[0, n).
template <int V, typename T>
__device__ __forceinline__ void load_vals(const T* __restrict__ p, int off,
                                          int n, float v[V]) {
  if constexpr (V == kVals) {
    load8(p, off, n, v);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float x = (float)p[min(off + e, n - 1)];
      v[e] = off + e < n ? x : 0.f;
    }
  }
}

// The codes of coordinates e0 .. e0 + nv - 1 (nv >= 1) of message i:
// int32 (pack 1) or from its packed bytes (unpack8 at V = 8, else byte by
// byte).
template <int V>
__device__ __forceinline__ void load_codes(const int32_t* __restrict__ codes32,
                                           const uint8_t* __restrict__ codes8,
                                           size_t i, int e0, int nv,
                                           int d_pad, int b, int c, int bits,
                                           int pack, float code[V]) {
  if (pack == 1) {
    load_vals<V>(codes32 + i * d_pad, e0, d_pad, code);
    return;
  }
  const uint8_t* c8 = codes8 + i * (d_pad / pack);
  if constexpr (V == kVals) {
    unpack8(c8, e0, nv, b, c, bits, pack, code);
  } else {
    const unsigned mask = (1u << bits) - 1u;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int at = e0 + min(e, nv - 1);
      const int j = at / b;
      const int rem = at - j * b;
      const int row = rem / c;
      const int col = rem - row * c;
      const unsigned byte =
          c8[(size_t)j * (b / pack) + (size_t)(row / pack) * c + col];
      code[e] = (float)((byte >> ((row % pack) * bits)) & mask);
    }
  }
}

// The uplink snap with what the round reads of it. A CTA strides over
// chunks of V * kVecThreads coordinates (chunk x, x + gridDim.x, ...); a
// thread takes V coordinates of a chunk (8, or 1 where 8 would leave the
// card nearly idle) through all s messages: it snaps message i's codes
// against the rotated server w, QY_i = snap(c_i, w), sums QY_i in
// ascending i and writes the server average (w + sum) / (s+1)
// (`with_server`) or sum / s; for each message it adds (QY_i - Y_i)^2,
// Y_i^2 and (QY_i - w)^2 over its coordinates, each warp sums them (a fixed
// butterfly) into its own slots of `red`, and at the end of the CTA's
// chunks the warps' slots are summed in warp order into the CTA's partials,
// partials[(q * s + i) * gridDim.x + x], q = 0, 1, 2. No atomics: the same
// launch gives the same bits.
template <int V>
__global__ void __launch_bounds__(kVecThreads)
snap_vec_kernel_up_average(const int32_t* __restrict__ codes32,
                           const uint8_t* __restrict__ codes8,
                           const float* __restrict__ w,
                           const float* __restrict__ y,
                           const float* __restrict__ gam, int gam_stride,
                           const float* __restrict__ levels, int lev_stride,
                           float levels_default, float* __restrict__ out,
                           float* __restrict__ partials, int s, int d_pad,
                           int b, int c, int bits, int pack,
                           int with_server) {
  static_assert(V == 1 || V == kVals, "1 or 8 coordinates a thread");
  __shared__ float red[kWarps][kUpRows][3];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int span = V * kVecThreads;
  const int chunks = (d_pad + span - 1) / span;
  for (int i0 = 0; i0 < s; i0 += kUpRows) {
    const int rows = min(kUpRows, s - i0);
    const bool last = i0 + rows == s;
    for (int k = lane; k < kUpRows * 3; k += 32) red[warp][k / 3][k % 3] = 0.f;
    __syncwarp();
    for (int ch = blockIdx.x; ch < chunks; ch += gridDim.x) {
      const int e0 = ch * span + V * threadIdx.x;
      // coordinates of this thread: V, fewer at the end, none past d_pad
      // (such a thread still takes part in its warp's sums)
      const int nv = e0 < d_pad ? min(V, d_pad - e0) : 0;
      float wv[V], acc[V];
      load_vals<V>(w, e0, d_pad, wv);
      if (i0 == 0) {
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = 0.f;
      } else {
        load_vals<V>(out, e0, d_pad, acc);
      }
      for (int r = 0; r < rows; ++r) {
        const size_t i = (size_t)(i0 + r);
        float se = 0.f, sy = 0.f, sd = 0.f;
        if (nv > 0) {
          const float g = gam[i * gam_stride];
          const float L = levels != nullptr ? levels[i * lev_stride]
                                            : levels_default;
          float code[V], yv[V];
          load_codes<V>(codes32, codes8, i, e0, nv, d_pad, b, c, bits, pack,
                        code);
          load_vals<V>(y + i * d_pad, e0, d_pad, yv);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            if (e >= nv) continue;
            const float q = snap_one(code[e], wv[e], g, L);
            acc[e] = __fadd_rn(acc[e], q);
            const float dq = __fsub_rn(q, yv[e]);
            const float dw = __fsub_rn(q, wv[e]);
            se = __fadd_rn(se, __fmul_rn(dq, dq));
            sy = __fadd_rn(sy, __fmul_rn(yv[e], yv[e]));
            sd = __fadd_rn(sd, __fmul_rn(dw, dw));
          }
        }
        se = warp_sum(se);
        sy = warp_sum(sy);
        sd = warp_sum(sd);
        if (lane == 0) {
          red[warp][r][0] = __fadd_rn(red[warp][r][0], se);
          red[warp][r][1] = __fadd_rn(red[warp][r][1], sy);
          red[warp][r][2] = __fadd_rn(red[warp][r][2], sd);
        }
      }
      if (nv == 0) continue;
      if (last) {
        const float n = with_server ? (float)(s + 1) : (float)s;
#pragma unroll
        for (int e = 0; e < V; ++e)
          acc[e] = __fdiv_rn(with_server ? __fadd_rn(wv[e], acc[e]) : acc[e],
                             n);
      }
      if constexpr (V == kVals) {
        store8(out + e0, nv, acc);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e)
          if (e < nv) out[e0 + e] = acc[e];
      }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < rows * 3; k += blockDim.x) {
      const int r = k / 3, q = k % 3;
      float v = 0.f;
      for (int wp = 0; wp < kWarps; ++wp) v = __fadd_rn(v, red[wp][r][q]);
      partials[((size_t)q * s + i0 + r) * gridDim.x + blockIdx.x] = v;
    }
    __syncthreads();
  }
}

// The fixed-order finish of the uplink's sums, one CTA, kFinishRows
// messages at a time: warp r % kWarps sums message r's three rows of the
// `nparts` CTA partials (lanes strided, in double, then a butterfly), and
// its lane 0 keeps sqrt(SE) / (sqrt(SY) + 1e-9) and sqrt(SD) in shared
// memory; thread 0 then takes the messages in order: stats[0] = the mean
// of the former (rel_err), stats[1] = the max of the latter + 1e-8
// (hint_srv; a NaN carries through).
__global__ void __launch_bounds__(kVecThreads)
snap_vec_kernel_up_finish(const float* __restrict__ partials, int nparts,
                          int s, float* __restrict__ stats) {
  __shared__ float ratio[kFinishRows], dist[kFinishRows];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float rel = 0.f, hint = 0.f;
  for (int i0 = 0; i0 < s; i0 += kFinishRows) {
    const int rows = min(kFinishRows, s - i0);
    for (int r = warp; r < rows; r += kWarps) {
      const float* p0 = partials + (size_t)(i0 + r) * nparts;
      const float* p1 = p0 + (size_t)s * nparts;
      const float* p2 = p1 + (size_t)s * nparts;
      double se = 0.0, sy = 0.0, sd = 0.0;
      for (int k = lane; k < nparts; k += 32) {
        se += (double)p0[k];
        sy += (double)p1[k];
        sd += (double)p2[k];
      }
      se = warp_sum(se);
      sy = warp_sum(sy);
      sd = warp_sum(sd);
      if (lane == 0) {
        ratio[r] = __fdiv_rn(sqrtf((float)se),
                             __fadd_rn(sqrtf((float)sy), 1e-9f));
        dist[r] = sqrtf((float)sd);
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int r = 0; r < rows; ++r) {
        const float dn = dist[r];
        rel = __fadd_rn(rel, ratio[r]);
        if (i0 + r == 0 || dn != dn || dn > hint) hint = dn;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    stats[0] = __fdiv_rn(rel, (float)s);
    stats[1] = __fadd_rn(hint, 1e-8f);
  }
}

// The downlink snap and the clients' average, in place: thread t of CTA
// (x, yb) takes coordinates e0 .. e0 + 7, e0 = 8 (x * blockDim.x + t), reads
// their one code row once, and for each message i = yb, yb + gridDim.y, ...
// snaps it against Y_i and writes into Y_i either QX / (s+1) + (s Y_i) /
// (s+1) (`mix`; the divisions, product and sum each rounded once, in that
// order) or QX.
__global__ void __launch_bounds__(kVecThreads)
snap_vec_kernel_down_average(const int32_t* __restrict__ codes32,
                             const uint8_t* __restrict__ codes8, float* y,
                             const float* __restrict__ gam,
                             const float* __restrict__ levels,
                             float levels_default, int m, int d_pad, int b,
                             int c, int bits, int pack, int mix) {
  const int e0 = kVals * (blockIdx.x * blockDim.x + threadIdx.x);
  if (e0 >= d_pad) return;
  const int nv = min(kVals, d_pad - e0);
  const float g = gam[0];
  const float L = levels != nullptr ? levels[0] : levels_default;
  const float sf = (float)m, s1 = (float)(m + 1);
  float code[kVals];
  if (pack == 1)
    load8(codes32, e0, d_pad, code);
  else
    unpack8(codes8, e0, nv, b, c, bits, pack, code);
  for (int i = blockIdx.y; i < m; i += gridDim.y) {
    float* yi = y + (size_t)i * d_pad;
    float v[kVals];
    load8(yi, e0, d_pad, v);
#pragma unroll
    for (int e = 0; e < kVals; ++e) {
      const float qx = snap_one(code[e], v[e], g, L);
      v[e] = mix ? __fadd_rn(__fdiv_rn(qx, s1),
                             __fdiv_rn(__fmul_rn(v[e], sf), s1))
                 : qx;
    }
    store8(yi + e0, nv, v);
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

// The quantize half of exch_encode on already-rotated y, `per_thread` (2 or
// 8) outputs a thread.
int exch_quantize(const void* y, const void* u, const void* gam,
                  int gam_stride, const void* levels, int lev_stride,
                  float levels_default, void* codes32, void* codes8, int m,
                  int d_pad, int b, int c, int bits, int pack, int per_thread,
                  void* stream) {
  void (*kernel)(const float*, const float*, const float*, int, const float*,
                 int, float, int32_t*, uint8_t*, int, int, int, int, int,
                 int) =
      per_thread == 8   ? quantize_vec_kernel<8>
      : per_thread == 2 ? quantize_vec_kernel<2>
                        : nullptr;
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaSuccess;  // no message: nothing to launch
  const int per_cta = per_thread * kVecThreads;
  dim3 grid((d_pad / pack + per_cta - 1) / per_cta, m < 65535 ? m : 65535);
  kernel<<<grid, kVecThreads, 0, (cudaStream_t)stream>>>(
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
  const int per_cta = kVals * kVecThreads;
  dim3 grid((d_pad + per_cta - 1) / per_cta, m < 65535 ? m : 65535);
  snap_vec_kernel<<<grid, kVecThreads, 0, (cudaStream_t)stream>>>(
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

// The uplink snap of s code rows against the one rotated server row w,
// with Y (s, d_pad): out (d_pad,) the server average; partials 3 * s *
// ctas floats; stats (2,) rel_err and hint_srv. Two launches on `stream`:
// ctas CTAs of `per_thread` (1 or 8) coordinates a thread, then the
// one-CTA finish.
int exch_uplink(const void* codes32, const void* codes8, const void* w,
                const void* y, const void* gam, int gam_stride,
                const void* levels, int lev_stride, float levels_default,
                void* out, void* partials, void* stats, int s, int d_pad,
                int b, int c, int bits, int pack, int with_server, int ctas,
                int per_thread, void* stream) {
  void (*kernel)(const int32_t*, const uint8_t*, const float*, const float*,
                 const float*, int, const float*, int, float, float*, float*,
                 int, int, int, int, int, int, int) =
      per_thread == kVals ? snap_vec_kernel_up_average<kVals>
      : per_thread == 1   ? snap_vec_kernel_up_average<1>
                          : nullptr;
  if (kernel == nullptr || s < 1 || ctas < 1)
    return (int)cudaErrorInvalidValue;
  kernel<<<ctas, kVecThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)codes32, (const uint8_t*)codes8, (const float*)w,
      (const float*)y, (const float*)gam, gam_stride, (const float*)levels,
      lev_stride, levels_default, (float*)out, (float*)partials, s, d_pad, b,
      c, bits, pack, with_server);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  snap_vec_kernel_up_finish<<<1, kVecThreads, 0, (cudaStream_t)stream>>>(
      (const float*)partials, ctas, s, (float*)stats);
  return (int)cudaGetLastError();
}

// The downlink snap of one code row against the m rows of y, averaged
// into y in place (`mix`) or written there; `rows` CTAs along the messages.
int exch_average(const void* codes32, const void* codes8, void* y,
                 const void* gam, const void* levels, float levels_default,
                 int m, int d_pad, int b, int c, int bits, int pack, int mix,
                 int rows, void* stream) {
  if (m == 0) return (int)cudaSuccess;  // no message: nothing to launch
  const int per_cta = kVals * kVecThreads;
  dim3 grid((d_pad + per_cta - 1) / per_cta, rows);
  snap_vec_kernel_down_average<<<grid, kVecThreads, 0,
                                 (cudaStream_t)stream>>>(
      (const int32_t*)codes32, (const uint8_t*)codes8, (float*)y,
      (const float*)gam, (const float*)levels, levels_default, m, d_pad, b,
      c, bits, pack, mix);
  return (int)cudaGetLastError();
}

}  // extern "C"
