// All-pairs 256-bit Hamming matching with the selection fused in.
//
// Replaces the two TPU kernels of slam_rgbd_tpu/ops/hamming_pallas.py:
//
//   hamming_top2 (pallas_call at line 119, body lines 43-83): per query the
//     best and second-best distance over all columns and the first index of
//     the best; a pair with an invalid side reads 1e9.
//   gated_match  (pallas_call at line 291, body lines 179-245): one distance
//     pass, two gated argmins. Tier 1 keeps pairs inside a pixel radius with
//     agreeing depth, tier 2 keeps pairs inside a 3-D merge radius.
//
// Design. The TPU kernels take the distance from a bf16 sign product on the
// matrix unit, d = (256 - s1.s2) / 2, and tile the columns through VMEM with
// a running merge across sequential grid steps. Here the signs are packed to
// 8 words of 32 bits a descriptor (bit = sign > 0) by `pack_signs`, and a
// pair's distance is 8 x popc(a ^ b): the same integer for every pair of
// +-1 rows. A row of zeros (an empty map slot) packs to all-zero bits and
// reads another distance than the sign product's 128, but such rows are
// always masked by their validity, so every unmasked pair agrees.
//
// One block takes kQueries queries, whose words and gate data sit in shared
// memory. Each thread walks the columns tid, tid + kThreads, ... in
// ascending order and keeps, for each query, its running minimum under a
// strict '<': the first index wins inside a thread. Threads and warps then
// combine by the minimum of the 64-bit key (distance << 32 | index), which
// is the lexicographic minimum of (distance, index): first index on ties,
// in a fixed order, without atomics. Repeated launches are bit-identical.
// The (K1, K2) distance matrix exists only in registers.
//
// What bounds it on an H100: integer issue. 1024 x 16384 pairs at 8 xor +
// 8 popc + 7 adds and two gates a pair is ~1e9 lane operations; the inputs
// are ~1 MB, read once from device memory and then from L2 by each block.
//
// Numerics. The gates are float32 in the reference's order and the library
// is built with --fmad=false, so each product and sum rounds as in the plain
// torch versions (`gated_match_reference`, `hamming_top2_reference`).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQueries = 8;     // queries a block
constexpr int kWords = 8;       // 256 bits
constexpr int kMeta = 8;        // floats of gate data a row
constexpr uint32_t kMasked = 0x7fffffffu;  // distance of a masked pair
constexpr float kBig = 1e9f;               // what a masked pair reads as

__device__ __forceinline__ uint64_t make_key(uint32_t dist, uint32_t idx) {
  return (static_cast<uint64_t>(dist) << 32) | idx;
}

__device__ __forceinline__ uint32_t key_dist(uint64_t key) {
  return static_cast<uint32_t>(key >> 32);
}

__device__ __forceinline__ float dist_as_float(uint32_t dist) {
  return dist == kMasked ? kBig : static_cast<float>(dist);
}

__device__ __forceinline__ uint64_t shfl_xor_u64(uint64_t v, int lane_mask) {
  return __shfl_xor_sync(0xffffffffu, static_cast<unsigned long long>(v),
                         lane_mask);
}

__device__ __forceinline__ uint64_t min_u64(uint64_t a, uint64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ uint32_t hamming256(const uint4& a0, const uint4& a1,
                                               const uint4& b0, const uint4& b1) {
  return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
         __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
         __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

// signs: (n, 256) int8. bits: (n, 8) words, bit b of word w = signs[w*32+b] > 0.
// One warp packs one word with a ballot.
__global__ void pack_signs(const int8_t* __restrict__ signs, int n,
                           uint32_t* __restrict__ bits) {
  const int lane = threadIdx.x & 31;
  const int word = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  if (word >= n * kWords) return;  // whole warps leave together
  const uint32_t w = __ballot_sync(0xffffffffu, signs[word * 32 + lane] > 0);
  if (lane == 0) bits[word] = w;
}

// The queries of this block into shared memory; rows past n1 are invalid.
__device__ __forceinline__ void load_query_bits(const uint32_t* __restrict__ bits1,
                                                int q0, int n1,
                                                uint32_t (*sq)[kWords]) {
  for (int t = threadIdx.x; t < kQueries * kWords; t += kThreads) {
    const int q = t / kWords, w = t % kWords;
    sq[q][w] = (q0 + q < n1) ? bits1[(q0 + q) * kWords + w] : 0u;
  }
}

// ---------------------------------------------------------------- top-2 ----

struct Top2 {
  uint64_t key;     // (best distance, first index of it)
  uint32_t second;  // least distance over every other column
};

// Fold partial `o` into `a`: the lexicographic winner gives best and index,
// second is the least of the loser's best and both seconds.
__device__ __forceinline__ Top2 merge_top2(const Top2& a, const Top2& o) {
  Top2 r;
  const bool o_wins = o.key < a.key;
  r.key = o_wins ? o.key : a.key;
  const uint32_t loser = key_dist(o_wins ? a.key : o.key);
  r.second = min(loser, min(a.second, o.second));
  return r;
}

__global__ void __launch_bounds__(kThreads)
hamming_top2_kernel(const uint32_t* __restrict__ bits1,
                    const uint8_t* __restrict__ valid1, int n1,
                    const uint32_t* __restrict__ bits2,
                    const uint8_t* __restrict__ valid2, int n2,
                    float* __restrict__ best, float* __restrict__ second,
                    int* __restrict__ idx) {
  __shared__ __align__(16) uint32_t sq[kQueries][kWords];
  __shared__ uint8_t sv[kQueries];
  __shared__ Top2 part[kQueries][kWarps];
  const int q0 = blockIdx.x * kQueries;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  load_query_bits(bits1, q0, n1, sq);
  if (threadIdx.x < kQueries)
    sv[threadIdx.x] = (q0 + threadIdx.x < n1) ? valid1[q0 + threadIdx.x] : 0;
  __syncthreads();

  Top2 acc[kQueries];
#pragma unroll
  for (int q = 0; q < kQueries; ++q) acc[q] = Top2{make_key(kMasked, 0u), kMasked};

  const uint4* cols = reinterpret_cast<const uint4*>(bits2);
  for (int c = threadIdx.x; c < n2; c += kThreads) {
    const uint4 b0 = cols[2 * c], b1 = cols[2 * c + 1];
    const bool col_ok = valid2[c] != 0;
#pragma unroll
    for (int q = 0; q < kQueries; ++q) {
      const uint4 a0 = *reinterpret_cast<const uint4*>(&sq[q][0]);
      const uint4 a1 = *reinterpret_cast<const uint4*>(&sq[q][4]);
      const uint32_t d =
          (col_ok && sv[q]) ? hamming256(a0, a1, b0, b1) : kMasked;
      if (d < key_dist(acc[q].key)) {
        acc[q].second = key_dist(acc[q].key);
        acc[q].key = make_key(d, static_cast<uint32_t>(c));
      } else if (d < acc[q].second) {
        acc[q].second = d;
      }
    }
  }

#pragma unroll
  for (int q = 0; q < kQueries; ++q) {
    Top2 a = acc[q];
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      Top2 o;
      o.key = shfl_xor_u64(a.key, m);
      o.second = __shfl_xor_sync(0xffffffffu, a.second, m);
      a = merge_top2(a, o);
    }
    if (lane == 0) part[q][warp] = a;
  }
  __syncthreads();

  if (threadIdx.x < kQueries && q0 + threadIdx.x < n1) {
    const int q = threadIdx.x;
    Top2 a = part[q][0];
    for (int w = 1; w < kWarps; ++w) a = merge_top2(a, part[q][w]);
    best[q0 + q] = dist_as_float(key_dist(a.key));
    second[q0 + q] = dist_as_float(a.second);
    idx[q0 + q] = static_cast<int>(a.key & 0xffffffffu);
  }
}

// ---------------------------------------------------------- gated match ----

struct Gates {
  float px2;        // pixel radius squared
  float z_rel_tol;  // relative depth tolerance
  float mr2;        // merge radius, signed square: negative turns tier 2 off
};

__global__ void __launch_bounds__(kThreads)
gated_match_kernel(const uint32_t* __restrict__ bits1,
                   const float* __restrict__ q_meta, int n1,
                   const uint32_t* __restrict__ bits2,
                   const float* __restrict__ p_meta, int n2, Gates g,
                   float* __restrict__ d1, int* __restrict__ i1,
                   float* __restrict__ d2, int* __restrict__ i2) {
  __shared__ __align__(16) uint32_t sq[kQueries][kWords];
  __shared__ float sm[kQueries][kMeta];
  __shared__ uint64_t part[2][kQueries][kWarps];
  const int q0 = blockIdx.x * kQueries;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  load_query_bits(bits1, q0, n1, sq);
  for (int t = threadIdx.x; t < kQueries * kMeta; t += kThreads) {
    const int q = t / kMeta, w = t % kMeta;
    sm[q][w] = (q0 + q < n1) ? q_meta[(q0 + q) * kMeta + w] : 0.0f;
  }
  __syncthreads();

  uint64_t k1[kQueries], k2[kQueries];
#pragma unroll
  for (int q = 0; q < kQueries; ++q) k1[q] = k2[q] = make_key(kMasked, 0u);

  const uint4* cols = reinterpret_cast<const uint4*>(bits2);
  const float4* metas = reinterpret_cast<const float4*>(p_meta);
  for (int c = threadIdx.x; c < n2; c += kThreads) {
    const uint4 b0 = cols[2 * c], b1 = cols[2 * c + 1];
    const float4 pa = metas[2 * c];      // pu, pv, z, ok
    const float4 pb = metas[2 * c + 1];  // x, y, z, |p|^2
    const bool col_ok = pa.w > 0.5f;
#pragma unroll
    for (int q = 0; q < kQueries; ++q) {
      const float* m = sm[q];
      if (!(col_ok && m[3] > 0.5f)) continue;
      const uint4 a0 = *reinterpret_cast<const uint4*>(&sq[q][0]);
      const uint4 a1 = *reinterpret_cast<const uint4*>(&sq[q][4]);
      const uint32_t d = hamming256(a0, a1, b0, b1);
      // tier 1: reprojection pixel gate and relative depth agreement
      const float du = m[0] - pa.x, dv = m[1] - pa.y;
      const bool z_ok = fabsf(m[2] - pa.z) < g.z_rel_tol * fmaxf(m[2], 0.3f);
      if (du * du + dv * dv < g.px2 && z_ok && d < key_dist(k1[q]))
        k1[q] = make_key(d, static_cast<uint32_t>(c));
      // tier 2: 3-D distance by |q|^2 + |p|^2 - 2 q.p, summed left to right
      const float cross = m[4] * pb.x + m[5] * pb.y + m[6] * pb.z;
      const float dist2 = m[7] + pb.w - 2.0f * cross;
      if (dist2 < g.mr2 && d < key_dist(k2[q]))
        k2[q] = make_key(d, static_cast<uint32_t>(c));
    }
  }

#pragma unroll
  for (int q = 0; q < kQueries; ++q) {
    uint64_t a = k1[q], b = k2[q];
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      a = min_u64(a, shfl_xor_u64(a, m));
      b = min_u64(b, shfl_xor_u64(b, m));
    }
    if (lane == 0) {
      part[0][q][warp] = a;
      part[1][q][warp] = b;
    }
  }
  __syncthreads();

  if (threadIdx.x < 2 * kQueries) {
    const int tier = threadIdx.x / kQueries, q = threadIdx.x % kQueries;
    if (q0 + q < n1) {
      uint64_t a = part[tier][q][0];
      for (int w = 1; w < kWarps; ++w) a = min_u64(a, part[tier][q][w]);
      float* d_out = tier == 0 ? d1 : d2;
      int* i_out = tier == 0 ? i1 : i2;
      d_out[q0 + q] = dist_as_float(key_dist(a));
      i_out[q0 + q] = static_cast<int>(a & 0xffffffffu);
    }
  }
}

cudaError_t pack(const int8_t* signs, int n, uint32_t* bits, cudaStream_t s) {
  const int warps_a_block = kThreads / 32;
  const int blocks = (n * kWords + warps_a_block - 1) / warps_a_block;
  pack_signs<<<blocks, kThreads, 0, s>>>(signs, n, bits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// signs1: (n1, 256) int8, valid1: (n1,) bytes; signs2, valid2 alike for n2.
// bits1 / bits2: scratch of n1 * 8 / n2 * 8 words. best, second: (n1,)
// float32; idx: (n1,) int32. Launches on `stream`, returns cudaGetLastError().
int hamming_top2_launch(const int8_t* signs1, const uint8_t* valid1, int n1,
                        const int8_t* signs2, const uint8_t* valid2, int n2,
                        uint32_t* bits1, uint32_t* bits2,
                        float* best, float* second, int* idx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = pack(signs1, n1, bits1, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = pack(signs2, n2, bits2, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n1 + kQueries - 1) / kQueries;
  hamming_top2_kernel<<<blocks, kThreads, 0, s>>>(
      bits1, valid1, n1, bits2, valid2, n2, best, second, idx);
  return static_cast<int>(cudaGetLastError());
}

// q_meta: (n1, 8) float32 [u, v, z, valid, xw, yw, zw, |pw|^2];
// p_meta: (n2, 8) float32 [pu, pv, z, ok, x, y, z, |p|^2]. px2, z_rel_tol and
// mr2 are the gates, already squared where the kernel compares squares.
// d1, d2: (n1,) float32; i1, i2: (n1,) int32.
int gated_match_launch(const int8_t* signs1, const float* q_meta, int n1,
                       const int8_t* signs2, const float* p_meta, int n2,
                       float px2, float z_rel_tol, float mr2,
                       uint32_t* bits1, uint32_t* bits2,
                       float* d1, int* i1, float* d2, int* i2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = pack(signs1, n1, bits1, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = pack(signs2, n2, bits2, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n1 + kQueries - 1) / kQueries;
  gated_match_kernel<<<blocks, kThreads, 0, s>>>(
      bits1, q_meta, n1, bits2, p_meta, n2, Gates{px2, z_rel_tol, mr2},
      d1, i1, d2, i2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
