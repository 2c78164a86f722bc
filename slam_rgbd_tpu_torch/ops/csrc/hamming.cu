// All-pairs 256-bit Hamming matching on the int8 tensor cores, with the
// selection fused in.
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
// Distances. The TPU kernels take d = (256 - s1.s2) / 2 from a bf16 sign
// product on the matrix unit. Here the same product runs on the int8 tensor
// cores (mma.sync m16n8k32 s8.s8.s32) straight from the (K, 256) int8 rows
// as they lie in memory: no packing, no scratch copy. 256 - dot is an exact
// integer (twice the distance), so the selection compares integers and the
// output is 0.5f * that integer, as the sign product gives it for any int8
// rows. A valid row of zeros reads 128.
//
// The operands need no transpose. m16n8k32 takes A as 16 rows x 32 bytes
// and B as 8 columns x 32 bytes, each column one map row: both are sign
// rows. Since a dot product does not depend on the order of its 256 terms,
// every thread reads for each of its rows the four 16-byte pieces at
// j * 64 + tig * 16 (j = 0..3, tig = lane % 4) and k-step kk takes words
// 2kk and 2kk + 1 of them, for A and for B alike. So a thread loads whole
// 16-byte pieces, and the staged map rows are read from shared memory with
// a row pitch of 320 bytes, free of bank conflicts.
//
// Grid: (column splits, query tiles). A block takes 128 queries (a warp
// 16, its A fragments in 32 registers for the whole block) against every
// n_split-th stage of 32 map columns from its split on, staged through a
// ring of three shared-memory buffers by cp.async, two stages ahead of the
// one computed. Interleaving the stages spreads a map whose valid slots lie
// together (a session fills its map from slot 0 on) over all the splits.
// The split count comes from the shape alone: about one wave of blocks, two
// on each of the card's 132 SMs (264 at 1024 x 16384, 256 at 1024 x 1024),
// since every block pays a fixed chain of round trips to L2.
//
// Epilogue on the accumulator fragments. Each thread holds the dots of two
// query rows against two columns of an 8-column group. It keeps a running
// state a row under a strict '<' over its columns in ascending order (first
// index wins), then the four threads of a row and, across blocks, the
// column splits merge by the lexicographic minimum of (distance, index):
// top-2 also keeps `second`, the least distance over every column except
// the single argmin column. Tier 1 / tier 2 gates are float32 in the
// reference's order (the library is built with --fmad=false, and the 3-D
// cross term is three products summed left to right), so they decide as
// the plain torch versions decide.
//
// Skipping what is masked. A pair with an invalid side reads 1e9, and the
// state of every row starts at (distance 1e9, index 0, second 1e9): what the
// reference returns for a row with nothing valid (its first index of the
// minimum 1e9 is column 0). A masked pair therefore never changes a state,
// and the kernel leaves out whatever holds none: a stage whose 32 columns
// are all invalid (free map slots) is neither loaded nor computed, an
// invalid column of a live stage is passed over, and a query tile whose
// rows are all invalid (the 16384 x 1024 direction of relocalization, most
// of whose query rows are free slots) is not computed at all: its first
// split writes (1e9, 0, 1e9) for its rows and no block takes a ticket. Each
// block decides from the validity bytes it reads itself. Invalid rows of a
// live tile get the start values at the end.
//
// One launch a call, deterministic. Each block writes its per-row partials
// to a table, fences and takes a ticket from its query tile's counter; the
// block that draws the last ticket merges the splits in a fixed order,
// writes the outputs and sets the counter back to 0. The counters are zero
// between launches (the workspace's invariant, `ops/workspace.py`). Integer
// merges of a commutative minimum: two launches give identical bits.
//
// What bounds it on an H100. At 1024 x 16384 the inputs are 4.5 MB (1.3 us
// at 3.35 TB/s) and a full map is 8.6 G int8 operations (4.3 us at 1,979
// TOP/s). mma.sync reaches part of that peak, and the gated epilogue is ~25
// instructions a pair on the ALUs, more than the tensor work. On the maps
// the session builds most slots are free and skipped, so the time is the
// launch and a chain of dependent round trips to L2: the validity reads,
// the first stages and A, the partials and the ticket, the merge.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 16 * kWarps;    // queries a block: 16 a warp
constexpr int kRow = 256;           // bytes a sign row
constexpr int kPitch = 320;         // bytes a staged row in shared memory
constexpr int kBN = 32;             // map columns a stage
constexpr int kRing = 3;            // stage buffers: two in flight
constexpr int kMaxStages = 64;      // stages a block at most
constexpr int kTargetBlocks = 264;  // two blocks on each of 132 SMs
constexpr int kMeta = 8;            // floats of gate data a row
constexpr int kMasked = INT_MAX;    // twice the distance of a masked pair
constexpr float kBig = 1e9f;        // what a masked pair reads as
constexpr int kMergeThreads = kThreads / kBM;  // threads a row in the final merge

// ------------------------------------------------------------ the plan ----

struct Plan {
  int n_qtiles;  // query tiles of kBM rows: grid y, one counter each
  int n_split;   // stage interleaves: grid x
};

Plan make_plan(int n1, int n2) {
  const int n_stages = (n2 + kBN - 1) / kBN;
  const int n_qtiles = (n1 + kBM - 1) / kBM;
  int split = (kTargetBlocks + n_qtiles - 1) / n_qtiles;
  const int least = (n_stages + kMaxStages - 1) / kMaxStages;  // kMaxStages a block
  split = split > least ? split : least;
  return Plan{n_qtiles, split < n_stages ? split : n_stages};
}

// ------------------------------------------------------- device helpers ----

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// D += A (16 x 32 s8, rows) * B (32 x 8 s8, columns), s32 accumulate.
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Thread (g, tig)'s 16 words of one sign row: the pieces j * 64 + tig * 16.
__device__ __forceinline__ void load_row_words(const uint8_t* row, uint32_t (&w)[16]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint4 v = *reinterpret_cast<const uint4*>(row + j * 64);
    w[4 * j] = v.x;
    w[4 * j + 1] = v.y;
    w[4 * j + 2] = v.z;
    w[4 * j + 3] = v.w;
  }
}

// A fragments of this warp's 16 queries, rows r0 + g and r0 + g + 8; rows
// past n1 read zeros.
__device__ __forceinline__ void load_a(const int8_t* __restrict__ s1, int n1, int r0,
                                       uint32_t (&a)[2][16]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + h * 8 + g;
    if (r < n1) {
      load_row_words(reinterpret_cast<const uint8_t*>(s1) + (size_t)r * kRow + tig * 16, a[h]);
    } else {
#pragma unroll
      for (int k = 0; k < 16; ++k) a[h][k] = 0u;
    }
  }
}

// The warp's 16 x 8 dots against the 8 staged rows from `cb` on:
// acc[h * 2 + e] = row g + 8h, column cb + 2 tig + e. Two accumulators for
// the even and the odd k-steps halve the chain of dependent mma's; integer
// sums, so exact.
__device__ __forceinline__ void group_dots(const uint8_t* tile, int cb,
                                           const uint32_t (&a)[2][16], int (&acc)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  uint32_t b[16];
  load_row_words(tile + (cb + g) * kPitch + tig * 16, b);
  int odd[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < 4; ++k) acc[k] = 0;
#pragma unroll
  for (int w = 0; w < 16; w += 4) {
    mma_s8(acc, a[0][w], a[1][w], a[0][w + 1], a[1][w + 1], b[w], b[w + 1]);
    mma_s8(odd, a[0][w + 2], a[1][w + 2], a[0][w + 3], a[1][w + 3], b[w + 2], b[w + 3]);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) acc[k] += odd[k];
}

// b beats a: the lexicographic order of (distance, index).
__device__ __forceinline__ bool beats(int bd, int bi, int ad, int ai) {
  return bd < ad || (bd == ad && bi < ai);
}

__device__ __forceinline__ float as_distance(int twice) {
  return twice == kMasked ? kBig : 0.5f * static_cast<float>(twice);
}

struct Shared {
  uint8_t tiles[kRing][kBN * kPitch];  // staged map rows
  float metas[kRing][kBN * kMeta];     // their gate data (gated_match)
  uint32_t mask[kMaxStages];           // valid columns of each stage
  int list[kMaxStages];                // the stages with one, ascending
  int count;
  uint8_t row_ok[kBM];
  bool last;
};

// The body both kernels share. `Op` supplies the validity of rows and
// columns, the per-row and per-column data of the epilogue, its state and
// merge, and the outputs.
template <class Op>
__device__ __forceinline__ void match_body(const Op& op, int4* __restrict__ partial,
                                           unsigned* __restrict__ counters) {
  using State = typename Op::State;
  __shared__ __align__(16) Shared sh;
  const int qt = blockIdx.y, split = blockIdx.x, n_split = gridDim.x;
  const int q0 = qt * kBM, n1 = op.n1, n2 = op.n2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tig = lane & 3;
  // this block's stages: split, split + n_split, ...
  const int n_local = ((n2 + kBN - 1) / kBN - split + n_split - 1) / n_split;
  const State start = Op::start();

  // the validity of the rows and of this block's stages, read together
  int ok_here = 0;
  if (threadIdx.x < kBM) {
    ok_here = q0 + threadIdx.x < n1 && op.row_ok(q0 + threadIdx.x);
    sh.row_ok[threadIdx.x] = ok_here;
  }
  for (int s = warp; s < n_local; s += kWarps) {
    const int c = (split + s * n_split) * kBN + lane;
    const uint32_t m = __ballot_sync(0xffffffffu, c < n2 && op.col_ok(c));
    if (lane == 0) sh.mask[s] = m;
  }
  if (!__syncthreads_or(ok_here)) {  // no valid query: the start values
    if (split == 0 && threadIdx.x < kBM && q0 + threadIdx.x < n1)
      op.write(q0 + threadIdx.x, start);
    return;
  }
  // A is read whatever the stages hold: its loads overlap the list
  uint32_t a[2][16];
  load_a(op.s1, n1, q0 + warp * 16, a);
  typename Op::Rows rows;
  op.load_rows(rows, q0 + warp * 16 + g);
  if (warp == 0) {
    int base = 0;
    for (int s0 = 0; s0 < n_local; s0 += 32) {
      const bool live = s0 + lane < n_local && sh.mask[s0 + lane] != 0u;
      const uint32_t b = __ballot_sync(0xffffffffu, live);
      if (live) sh.list[base + __popc(b & ((1u << lane) - 1u))] = s0 + lane;
      base += __popc(b);
    }
    if (lane == 0) sh.count = base;
  }
  __syncthreads();
  const int live = sh.count;

  State st[2] = {start, start};
  if (live > 0) {
    auto stage = [&](int i) {
      const int c0 = (split + sh.list[i] * n_split) * kBN;
      uint8_t* dst = sh.tiles[i % kRing];
      for (int k = threadIdx.x; k < kBN * (kRow / 16); k += kThreads) {
        const int r = k / (kRow / 16), j = k % (kRow / 16);
        const bool ok = c0 + r < n2;
        cp_async16(dst + r * kPitch + j * 16,
                   ok ? op.s2 + (size_t)(c0 + r) * kRow + j * 16 : op.s2, ok);
      }
      op.stage_extra(sh.metas[i % kRing], c0);
    };
    for (int i = 0; i < kRing - 1; ++i) {
      if (i < live) stage(i);
      cp_async_commit();
    }
    for (int i = 0; i < live; ++i) {
      cp_async_wait<kRing - 2>();  // stage i is in
      __syncthreads();             // and the buffer of stage i - 1 is free
      if (i + kRing - 1 < live) stage(i + kRing - 1);
      cp_async_commit();
      const uint8_t* tile = sh.tiles[i % kRing];
      const float* metas = sh.metas[i % kRing];
      const int c0 = (split + sh.list[i] * n_split) * kBN;
      const uint32_t m = sh.mask[sh.list[i]];
#pragma unroll
      for (int cb = 0; cb < kBN; cb += 8) {
        int acc[4];
        group_dots(tile, cb, a, acc);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cl = cb + 2 * tig + e;
          if (!((m >> cl) & 1u)) continue;
          const typename Op::Col col = op.column(metas, cl);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            op.update(st[h], kRow - acc[h * 2 + e], c0 + cl, rows, h, col);
        }
      }
    }
  }

  // the four threads of a row, then one partial a row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    st[h] = Op::merge(st[h], Op::shfl_xor(st[h], 1));
    st[h] = Op::merge(st[h], Op::shfl_xor(st[h], 2));
  }
  if (tig == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      partial[(size_t)(qt * n_split + split) * kBM + warp * 16 + h * 8 + g] = Op::pack(st[h]);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) sh.last = atomicAdd(&counters[qt], 1u) == (unsigned)(n_split - 1);
  __syncthreads();
  if (!sh.last) return;
  __threadfence();

  // the last block: kMergeThreads threads a row, each over every
  // kMergeThreads-th split (loads in flight together), then a shuffle
  const int r = threadIdx.x / kMergeThreads, p = threadIdx.x % kMergeThreads;
  const int4* row = partial + (size_t)qt * n_split * kBM + r;
  State t = start;
#pragma unroll 16
  for (int s = p; s < n_split; s += kMergeThreads)
    t = Op::merge(t, Op::unpack(__ldcg(row + (size_t)s * kBM)));
#pragma unroll
  for (int m = 1; m < kMergeThreads; m <<= 1) t = Op::merge(t, Op::shfl_xor(t, m));
  if (p == 0 && q0 + r < n1) op.write(q0 + r, sh.row_ok[r] ? t : start);
  if (threadIdx.x == 0) counters[qt] = 0;  // ready for the next launch
}

// ---------------------------------------------------------------- top-2 ----

struct Top2 {
  int best, idx, second;  // twice the distances
};

struct Top2Op {
  const int8_t* s1;
  const uint8_t* v1;
  int n1;
  const int8_t* s2;
  const uint8_t* v2;
  int n2;
  float* best;
  float* second;
  int* idx;

  using State = Top2;
  struct Rows {};
  struct Col {};

  __device__ bool row_ok(int r) const { return v1[r] != 0; }
  __device__ bool col_ok(int c) const { return v2[c] != 0; }
  __device__ void load_rows(Rows&, int) const {}
  __device__ void stage_extra(float*, int) const {}
  __device__ Col column(const float*, int) const { return Col{}; }

  // a valid column c at twice-distance d, after every earlier column
  __device__ void update(Top2& s, int d, int c, const Rows&, int, const Col&) const {
    if (d < s.best) {
      s.second = s.best;
      s.best = d;
      s.idx = c;
    } else {
      s.second = min(s.second, d);
    }
  }

  __device__ void write(int r, const Top2& t) const {
    best[r] = as_distance(t.best);
    second[r] = as_distance(t.second);
    idx[r] = t.idx;
  }

  __device__ static Top2 start() { return Top2{kMasked, 0, kMasked}; }

  // the lexicographic winner gives best and index; second is the least of
  // the loser's best and both seconds
  __device__ static Top2 merge(const Top2& a, const Top2& o) {
    const bool o_wins = beats(o.best, o.idx, a.best, a.idx);
    const int loser = o_wins ? a.best : o.best;
    return Top2{o_wins ? o.best : a.best, o_wins ? o.idx : a.idx,
                min(loser, min(a.second, o.second))};
  }

  __device__ static Top2 shfl_xor(const Top2& t, int m) {
    return Top2{__shfl_xor_sync(0xffffffffu, t.best, m),
                __shfl_xor_sync(0xffffffffu, t.idx, m),
                __shfl_xor_sync(0xffffffffu, t.second, m)};
  }

  __device__ static int4 pack(const Top2& t) { return make_int4(t.best, t.idx, t.second, 0); }
  __device__ static Top2 unpack(const int4& v) { return Top2{v.x, v.y, v.z}; }
};

__global__ void __launch_bounds__(kThreads, 2)
hamming_top2_kernel(Top2Op op, int4* __restrict__ partial, unsigned* __restrict__ counters) {
  match_body(op, partial, counters);
}

// ---------------------------------------------------------- gated match ----

struct Tiers {
  int d1, i1, d2, i2;  // twice the distances
};

struct GatedOp {
  const int8_t* s1;
  const float* q_meta;  // (n1, 8): u, v, z, valid, xw, yw, zw, |pw|^2
  int n1;
  const int8_t* s2;
  const float* p_meta;  // (n2, 8): pu, pv, z, ok, x, y, z, |p|^2
  int n2;
  float px2;        // pixel radius squared
  float z_rel_tol;  // relative depth tolerance
  float mr2;        // merge radius, signed square: negative turns tier 2 off
  float* d1;
  int* i1;
  float* d2;
  int* i2;

  using State = Tiers;
  // a thread's two rows: u, v, z and the depth tolerance tol * max(z, 0.3)
  // (the reference's rounding), then x, y, z, |p|^2
  struct Rows {
    float4 a[2], b[2];
  };
  struct Col {
    float4 a, b;  // pu, pv, z, ok; x, y, z, |p|^2
  };

  __device__ bool row_ok(int r) const { return q_meta[(size_t)r * kMeta + 3] > 0.5f; }
  __device__ bool col_ok(int c) const { return p_meta[(size_t)c * kMeta + 3] > 0.5f; }

  __device__ void load_rows(Rows& q, int r) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4* m = reinterpret_cast<const float4*>(
          q_meta + (size_t)min(r + 8 * h, n1 - 1) * kMeta);
      q.a[h] = m[0];
      q.b[h] = m[1];
      q.a[h].w = z_rel_tol * fmaxf(q.a[h].z, 0.3f);
    }
  }

  __device__ void stage_extra(float* dst, int c0) const {
    if (threadIdx.x < kBN * 2) {
      const int r = threadIdx.x >> 1, j = threadIdx.x & 1;
      const bool ok = c0 + r < n2;
      cp_async16(dst + r * kMeta + j * 4, ok ? p_meta + (size_t)(c0 + r) * kMeta + j * 4 : p_meta,
                 ok);
    }
  }

  __device__ Col column(const float* metas, int cl) const {
    const float4* m = reinterpret_cast<const float4*>(metas + cl * kMeta);
    return Col{m[0], m[1]};
  }

  __device__ void update(Tiers& s, int d, int c, const Rows& q, int h, const Col& p) const {
    // tier 1: reprojection pixel gate and relative depth agreement
    const float du = q.a[h].x - p.a.x, dv = q.a[h].y - p.a.y;
    if (du * du + dv * dv < px2 && fabsf(q.a[h].z - p.a.z) < q.a[h].w && d < s.d1) {
      s.d1 = d;
      s.i1 = c;
    }
    // tier 2: 3-D distance by |q|^2 + |p|^2 - 2 q.p, summed left to right
    const float cross = q.b[h].x * p.b.x + q.b[h].y * p.b.y + q.b[h].z * p.b.z;
    const float dist2 = q.b[h].w + p.b.w - 2.0f * cross;
    if (dist2 < mr2 && d < s.d2) {
      s.d2 = d;
      s.i2 = c;
    }
  }

  __device__ void write(int r, const Tiers& t) const {
    d1[r] = as_distance(t.d1);
    i1[r] = t.i1;
    d2[r] = as_distance(t.d2);
    i2[r] = t.i2;
  }

  __device__ static Tiers start() { return Tiers{kMasked, 0, kMasked, 0}; }

  __device__ static Tiers merge(const Tiers& a, const Tiers& o) {
    const bool w1 = beats(o.d1, o.i1, a.d1, a.i1), w2 = beats(o.d2, o.i2, a.d2, a.i2);
    return Tiers{w1 ? o.d1 : a.d1, w1 ? o.i1 : a.i1, w2 ? o.d2 : a.d2, w2 ? o.i2 : a.i2};
  }

  __device__ static Tiers shfl_xor(const Tiers& t, int m) {
    return Tiers{__shfl_xor_sync(0xffffffffu, t.d1, m), __shfl_xor_sync(0xffffffffu, t.i1, m),
                 __shfl_xor_sync(0xffffffffu, t.d2, m), __shfl_xor_sync(0xffffffffu, t.i2, m)};
  }

  __device__ static int4 pack(const Tiers& t) { return make_int4(t.d1, t.i1, t.d2, t.i2); }
  __device__ static Tiers unpack(const int4& v) { return Tiers{v.x, v.y, v.z, v.w}; }
};

__global__ void __launch_bounds__(kThreads, 2)
gated_match_kernel(GatedOp op, int4* __restrict__ partial, unsigned* __restrict__ counters) {
  match_body(op, partial, counters);
}

template <class Op, class Kernel>
int launch(Kernel kernel, const Op& op, int* scratch, unsigned* counters, void* stream) {
  const Plan p = make_plan(op.n1, op.n2);
  if (op.n1 < 1 || op.n2 < 1 || p.n_qtiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<dim3(p.n_split, p.n_qtiles), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      op, reinterpret_cast<int4*>(scratch), counters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The workspace a launch at (n1, n2) needs: `words` int32 words of partial
// table and `counters` ticket counters (zeroed, left zeroed by every launch).
void hamming_workspace(int n1, int n2, long* words, int* counters) {
  const Plan p = make_plan(n1, n2);
  *words = (long)p.n_qtiles * p.n_split * kBM * 4;
  *counters = p.n_qtiles;
}

// signs1: (n1, 256) int8, valid1: (n1,) bytes; signs2, valid2 alike for n2;
// every pointer 16-byte aligned. scratch / counters: `hamming_workspace`'s.
// best, second: (n1,) float32; idx: (n1,) int32. One launch on `stream`;
// returns cudaGetLastError().
int hamming_top2_launch(const int8_t* signs1, const uint8_t* valid1, int n1,
                        const int8_t* signs2, const uint8_t* valid2, int n2,
                        int* scratch, unsigned* counters,
                        float* best, float* second, int* idx, void* stream) {
  return launch(hamming_top2_kernel,
                Top2Op{signs1, valid1, n1, signs2, valid2, n2, best, second, idx},
                scratch, counters, stream);
}

// q_meta: (n1, 8) float32 [u, v, z, valid, xw, yw, zw, |pw|^2];
// p_meta: (n2, 8) float32 [pu, pv, z, ok, x, y, z, |p|^2]. px2, z_rel_tol and
// mr2 are the gates, already squared where the kernel compares squares.
// d1, d2: (n1,) float32; i1, i2: (n1,) int32. As `hamming_top2_launch`.
int gated_match_launch(const int8_t* signs1, const float* q_meta, int n1,
                       const int8_t* signs2, const float* p_meta, int n2,
                       float px2, float z_rel_tol, float mr2,
                       int* scratch, unsigned* counters,
                       float* d1, int* i1, float* d2, int* i2, void* stream) {
  return launch(gated_match_kernel,
                GatedOp{signs1, q_meta, n1, signs2, p_meta, n2, px2, z_rel_tol, mr2,
                        d1, i1, d2, i2},
                scratch, counters, stream);
}

}  // extern "C"
