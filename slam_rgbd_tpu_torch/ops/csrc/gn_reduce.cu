// One Gauss-Newton iteration of dense point-to-plane + photometric ICP in
// one launch: the reduction and, where asked, the damped 6x6 solve and the
// pose update.
//
// Replaces the TPU kernels `gn_reduce` and `gn_reduce_batched` in
// slam_rgbd_tpu/ops/icp_pallas.py (body `_make_kernel`, pallas_calls at lines
// 413 and 493). It computes the same sums as that kernel and as
// `odometry/icp._normal_equations` with a fixed dominant-flow shift
// (mu_u, mu_v):
//
//   M_geo = sum_p w  a a^T,  a = [n, y x n, r]       (point-to-plane)
//   M_pho = sum_p wi b b^T,  b = [g, y x g, r_i]     (photometric, DVO)
//
// and returns H = (M_geo + M_pho)[:6, :6], g = (M_geo + M_pho)[:6, 6], the
// inlier count and sq_sum = M_geo[6, 6]. With `do_step` the same launch goes
// on to what `odometry/icp._apply_update` does with them (damping, Cholesky,
// two triangular solves, se3 exp, the product with T, two passes of rotation
// normalisation) and writes the next pose.
//
// Sampling. The TPU kernel rolls the target by -mu, streams row tiles through
// VMEM and evaluates bilinear sampling as a (2R+2)^2 shift-FMA stencil,
// because gathers are slow there. Here a thread gathers the four bilinear
// corners of the ten target channels directly at the absolute projected
// point. It reproduces the stencil's gates: a corner counts only where its
// offset from (u + mu_u, v + mu_v) lies in [-R, R+1] and inside the image,
// and the pixel is kept only where the sum of those weights and the weighted
// validity both exceed 0.999.
//
// What bounds it on an H100, and what the design does about it.
//  * At 120x160 the 18 planes are 1.4 MB: the bytes take 0.4 us and an
//    empty launch takes ~5 us between two events, so the time is latency:
//    the launch, then a chain of dependent round trips to L2. The whole call
//    is therefore ONE launch: T and mu are read where they lie, the
//    cross-block sum happens in the launch (each block writes its partials,
//    fences, and takes a ticket from its problem's counter; the block that
//    draws the last ticket sums the table in a fixed order, eight threads a
//    row with all their loads in flight together, and resets the counter),
//    and the pose update runs in that last block, which holds H and g in
//    shared memory anyway (one thread, ~500 dependent operations, ~3 us).
//  * At 480x640 with several problems the planes (22 MB a problem) leave the
//    50 MB L2. The bound by bytes is 0.0066 ms a problem, but a pixel is
//    ~500 instructions without contraction (precise divisions and a square
//    root among them), so instruction rate and the latency of the gathers
//    set the time, and what helps is warps in flight. A thread takes four
//    pixels and keeps its 28 sums and its count in registers over them, so
//    the shuffle trees run once a thread and not once a pixel; the geometric
//    and the photometric block share one set of 28 sums (their [6, 6] entry
//    takes the geometric term only: it is sq_sum, and the photometric one is
//    needed nowhere), added with explicit fused multiply-adds.
//  * Which four pixels: the thread's pixels interleave with its neighbours'
//    (t, t + 256, ...), so that the lanes of a warp hold neighbouring pixels
//    at every load: a source plane is read in whole lines and a warp's
//    gather from a target plane falls on one or two lines. This map runs in
//    80 registers, three blocks of 256 threads a multiprocessor. Two
//    alternatives were measured and dropped (`PERF.md` section 6 has the
//    times): four neighbours of a row a thread with the source read as one
//    float4 a plane (112-126 registers, two blocks, 4-32% slower: a float4 a
//    lane is four lines a warp, as four scalar loads are), and a pixel-major
//    (H, W, 12) copy of the target (12 loads a pixel instead of 40, 3-6%
//    faster in the kernel, which the pass that builds the copy every frame
//    takes back).
//
// Repeatability. No float atomics. The block count and the map from pixels
// to threads depend on (H, W) only, and every problem has its own partial
// table, counter and outputs, so two launches give identical bits and
// problem b of a batched launch equals, bit for bit, a single launch on the
// same inputs (the TPU kernel's contract).
//
// Numerics. Built with --fmad=false, so every product and sum of a pixel's
// values and of the pose update rounds as the plain torch versions
// (`gn_reduce_reference`, `solve_update_written_out`) round them: per-pixel
// values and gates agree bit for bit, and only the sums over pixels (their
// order, and a fused rounding a term) differ.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;   // a block
constexpr int kWarps = kThreads / 32;
constexpr int kQuad = 4;        // pixels a thread takes
constexpr int kTri = 28;        // upper triangle of a 7x7 block
constexpr int kRow = kTri + 1;  // + inlier count (as float bits)
constexpr int kOut = 64;        // floats a problem: H 36, g 6, sq_sum,
                                // inliers (int bits), T_next 16, 4 unused

}  // namespace

extern "C" {

struct GnParams {
  int height, width, radius;
  float fx, fy, cx, cy;
  float min_depth, max_dist_sq, cos_thresh;
  float huber, rgb_w, rgb_huber;
  float damping;
};

}  // extern "C"

namespace {

// jnp.maximum semantics: a NaN operand propagates.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// 1-D bilinear weight of corner offset `d` (integer valued) for residual
// displacement `df`, zero outside the window [-R, R+1] or the image.
__device__ __forceinline__ float corner_weight(float df, float d, float base,
                                               int radius, int extent) {
  const float t = base + d;  // absolute target coordinate
  const bool ok = d >= (float)(-radius) && d <= (float)(radius + 1) &&
                  t >= 0.0f && t < (float)extent;
  return ok ? max_nan(1.0f - fabsf(df - d), 0.0f) : 0.0f;
}

// Index of entry (i, j), i <= j, in the row-major upper triangle of a 7x7.
__device__ constexpr int tri(int i, int j) {
  return i * 7 - i * (i - 1) / 2 + (j - i);
}

// One source pixel (u, v): adds its terms to the 28 sums and the count.
__device__ __forceinline__ void pixel(const GnParams& p, const float* t,
                                      float mu_u, float mu_v, int u, int v,
                                      const float* s,  // its 8 source values
                                      const float* __restrict__ tgt,
                                      float* sum, int& count) {
  const float px = s[0], py = s[1], pz = s[2];
  const float snx = s[3], sny = s[4], snz = s[5];
  const float sval = s[6], sint = s[7];

  const float yx = t[0] * px + t[1] * py + t[2] * pz + t[3];
  const float yy = t[4] * px + t[5] * py + t[6] * pz + t[7];
  const float yz = t[8] * px + t[9] * py + t[10] * pz + t[11];
  const float rnx = t[0] * snx + t[1] * sny + t[2] * snz;
  const float rny = t[4] * snx + t[5] * sny + t[6] * snz;
  const float rnz = t[8] * snx + t[9] * sny + t[10] * snz;

  const float z_safe = max_nan(yz, 1e-6f);
  const float inv_z = 1.0f / z_safe;
  const float up = p.fx * yx * inv_z + p.cx;
  const float vp = p.fy * yy * inv_z + p.cy;
  const bool in_front = yz > p.min_depth;

  // residual displacement after the dominant-flow shift
  const float du_f = up - (float)u - mu_u;
  const float dv_f = vp - (float)v - mu_v;
  const float du0 = floorf(du_f), dv0 = floorf(dv_f);
  const float ubase = (float)u + mu_u, vbase = (float)v + mu_v;
  const float wu0 = corner_weight(du_f, du0, ubase, p.radius, p.width);
  const float wu1 = corner_weight(du_f, du0 + 1.0f, ubase, p.radius, p.width);
  const float wv0 = corner_weight(dv_f, dv0, vbase, p.radius, p.height);
  const float wv1 = corner_weight(dv_f, dv0 + 1.0f, vbase, p.radius, p.height);
  const float wsum = (wu0 + wu1) * (wv0 + wv1);

  // corners in (row, column) order: (v0,u0) (v0,u1) (v1,u0) (v1,u1)
  float acc[10];
#pragma unroll
  for (int c = 0; c < 10; ++c) acc[c] = 0.0f;
  const float wc[4] = {wu0 * wv0, wu1 * wv0, wu0 * wv1, wu1 * wv1};
  const int n = p.height * p.width;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (wc[k] != 0.0f) {  // a zero weight adds nothing
      const int tu = (int)(ubase + du0) + (k & 1);
      const int tv = (int)(vbase + dv0) + (k >> 1);
      const int at = tv * p.width + tu;
      float q[10];
#pragma unroll
      for (int c = 0; c < 10; ++c) q[c] = __ldg(tgt + (size_t)c * n + at);
#pragma unroll
      for (int c = 0; c < 10; ++c) acc[c] = acc[c] + wc[k] * q[c];
    }
  }
  const bool samp_ok = wsum > 0.999f && acc[6] > 0.999f;

  const float n_norm = max_nan(
      sqrtf(acc[3] * acc[3] + acc[4] * acc[4] + acc[5] * acc[5]), 1e-9f);
  const float nx = acc[3] / n_norm, ny = acc[4] / n_norm, nz = acc[5] / n_norm;
  const float dx = yx - acc[0], dy = yy - acc[1], dz = yz - acc[2];
  const bool dist_ok = dx * dx + dy * dy + dz * dz < p.max_dist_sq;
  const bool angle_ok = nx * rnx + ny * rny + nz * rnz > p.cos_thresh;
  const bool mask = sval > 0.5f && in_front && samp_ok && dist_ok && angle_ok;
  if (!mask) return;  // both weights are zero: the pixel adds nothing

  // geometric point-to-plane row
  float a[7], b[7];
  const float r = nx * dx + ny * dy + nz * dz;
  a[0] = nx; a[1] = ny; a[2] = nz;
  a[3] = yy * nz - yz * ny;
  a[4] = yz * nx - yx * nz;
  a[5] = yx * ny - yy * nx;
  a[6] = r;
  const float abs_r = fabsf(r);
  const float w = abs_r <= p.huber ? 1.0f : p.huber / max_nan(abs_r, 1e-12f);

  // photometric row
  const float ri = acc[7] - sint;
  const float ga = acc[8] * p.fx * inv_z;
  const float gb = acc[9] * p.fy * inv_z;
  const float gc = -(ga * yx + gb * yy) * inv_z;
  b[0] = ga; b[1] = gb; b[2] = gc;
  b[3] = yy * gc - yz * gb;
  b[4] = yz * ga - yx * gc;
  b[5] = yx * gb - yy * ga;
  b[6] = ri;
  const float abs_ri = fabsf(ri);
  float wi = abs_ri <= p.rgb_huber ? 1.0f : p.rgb_huber / max_nan(abs_ri, 1e-12f);
  wi = wi * p.rgb_w;

  int e = 0;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    const float wa = w * a[i];
    const float wb = wi * b[i];
#pragma unroll
    for (int j = i; j < 7; ++j, ++e) {
      // fused multiply-adds, written out: these feed no gate, only sums
      // whose order differs from the plain version's anyway. [6, 6] is
      // sq_sum: the geometric term alone
      if (e != kTri - 1) sum[e] = __fmaf_rn(wb, b[j], sum[e]);
      sum[e] = __fmaf_rn(wa, a[j], sum[e]);
    }
  }
  count += 1;
}

// What `odometry/icp._apply_update` does, on the totals of one problem:
// damped Cholesky solve, identity step where it fails, T_next =
// normalize_rotation(exp(delta) @ T). One thread; every sum in the order of
// `ops/gn_reduce.solve_update_written_out`.
__device__ void pose_update(const float* tot, int inliers, const float* T,
                            float damping, float* T_next) {
  float A[6][6], g[6], L[6][6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) A[i][j] = tot[i <= j ? tri(i, j) : tri(j, i)];
    g[i] = tot[tri(i, 6)];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) A[i][i] = A[i][i] + damping * max_nan(A[i][i], 1.0f);

  bool ok = inliers > 6;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = A[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - L[j][k] * L[j][k];
    ok = ok && s > 0.0f;  // a pivot that is not positive (or NaN) fails
    const float d = sqrtf(s);
    L[j][j] = d;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float r = A[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) r = r - L[i][k] * L[j][k];
      L[i][j] = r / d;
    }
  }
  float y[6], x[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {  // L y = -g
    float s = -g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {  // L^T x = y
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) ok = ok && isfinite(x[i]);
#pragma unroll
  for (int i = 0; i < 6; ++i) x[i] = ok ? x[i] : 0.0f;

  // se3 exp of (v, w) = (x[0:3], x[3:6]), Taylor branch near zero
  const float wx = x[3], wy = x[4], wz = x[5];
  const float tsq = wx * wx + wy * wy + wz * wz;
  const float ts = max_nan(tsq, 1e-8f);
  const float theta = sqrtf(ts);
  const bool small = tsq < 1e-8f;
  const float sin_t = sinf(theta);
  const float ca = small ? 1.0f - tsq / 6.0f : sin_t / theta;
  const float cb = small ? 0.5f - tsq / 24.0f : (1.0f - cosf(theta)) / ts;
  const float cc = small ? (float)(1.0 / 6.0) - tsq / 120.0f
                         : (theta - sin_t) / (ts * theta);
  const float W[3][3] = {{0.0f, -wz, wy}, {wz, 0.0f, -wx}, {-wy, wx, 0.0f}};
  float E[4][4];  // exp(delta)
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float V[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float ww = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
      const float eye = i == j ? 1.0f : 0.0f;
      E[i][j] = eye + ca * W[i][j] + cb * ww;
      V[j] = eye + cb * W[i][j] + cc * ww;
    }
    E[i][3] = V[0] * x[0] + V[1] * x[1] + V[2] * x[2];
  }
  E[3][0] = 0.0f; E[3][1] = 0.0f; E[3][2] = 0.0f; E[3][3] = 1.0f;

  float N[4][4];  // exp(delta) @ T
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      N[i][j] = E[i][0] * T[j] + E[i][1] * T[4 + j] + E[i][2] * T[8 + j] +
                E[i][3] * T[12 + j];

  // normalize_rotation: R <- R (1.5 I - 0.5 R^T R), twice
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    float Q[3][3], R[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float m = N[0][i] * N[0][j] + N[1][i] * N[1][j] + N[2][i] * N[2][j];
        Q[i][j] = (i == j ? 1.5f : 0.0f) - 0.5f * m;
      }
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        R[i][j] = N[i][0] * Q[0][j] + N[i][1] * Q[1][j] + N[i][2] * Q[2][j];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) N[i][j] = R[i][j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) T_next[4 * i + j] = N[i][j];
}

// Grid (n_blocks, batch), kThreads a block. Problem b reads T + b *
// T_stride, mu + b * mu_stride and the planes of set b / share. A block
// takes kQuad * kThreads pixels, thread t the pixels t, t + kThreads, ... of
// them. 80 registers: three blocks fit a multiprocessor.
__global__ void __launch_bounds__(kThreads, 3)
gn_kernel(GnParams p, const float* __restrict__ T_all, long T_stride,
          const float* __restrict__ mu_all, long mu_stride,
          const float* __restrict__ src_all, long src_stride,
          const float* __restrict__ tgt_all, long tgt_stride, int share,
          int do_step, float* __restrict__ partial_all,
          unsigned* __restrict__ counters, float* __restrict__ out_all) {
  __shared__ float sh[kRow][kWarps];
  __shared__ float tot[kRow];
  __shared__ bool is_last;

  const int n = p.height * p.width;
  const int prob = blockIdx.y;
  const int n_blocks = gridDim.x;
  const float* __restrict__ T = T_all + prob * T_stride;
  const float* __restrict__ mu = mu_all + prob * mu_stride;
  const float* __restrict__ src = src_all + (prob / share) * src_stride;
  const float* __restrict__ tgt = tgt_all + (prob / share) * tgt_stride;
  float* __restrict__ partial = partial_all + (size_t)prob * n_blocks * kRow;
  float* __restrict__ out = out_all + (size_t)prob * kOut;

  float sum[kTri];
#pragma unroll
  for (int e = 0; e < kTri; ++e) sum[e] = 0.0f;
  int count = 0;

  float t[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) t[k] = T[k];
  const float mu_u = mu[0], mu_v = mu[1];

  const int first = blockIdx.x * kThreads * kQuad + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kQuad; ++k) {
    const int idx = first + k * kThreads;
    if (idx < n) {
      const int v = idx / p.width;
      float s[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) s[c] = __ldg(src + (size_t)c * n + idx);
      pixel(p, t, mu_u, mu_v, idx - v * p.width, v, s, tgt, sum, count);
    }
  }

  // block sums: a shuffle tree a warp, then the warps in order
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int e = 0; e < kTri; ++e) {
    const float v = warp_sum(sum[e]);
    if (lane == 0) sh[e][warp] = v;
  }
  const int c = warp_sum_int(count);
  if (lane == 0) sh[kTri][warp] = __int_as_float(c);
  __syncthreads();

  // partial layout: [entry][block], entries 0..27 then the count
  if (threadIdx.x < kTri) {
    float v = sh[threadIdx.x][0];
    for (int k = 1; k < kWarps; ++k) v += sh[threadIdx.x][k];
    partial[threadIdx.x * n_blocks + blockIdx.x] = v;
    __threadfence();
  } else if (threadIdx.x == kTri) {
    int v = 0;
    for (int k = 0; k < kWarps; ++k) v += __float_as_int(sh[kTri][k]);
    partial[kTri * n_blocks + blockIdx.x] = __int_as_float(v);
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(&counters[prob], 1u) == (unsigned)(n_blocks - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // the last block of the problem: eight threads a table row, each over
  // every eighth block (independent loads, all in flight together), then a
  // fixed shuffle tree over the eight
  const int part = threadIdx.x & 7;
  constexpr int rows_a_pass = kThreads >> 3;
  for (int e0 = 0; e0 < kRow; e0 += rows_a_pass) {
    const int e = e0 + (threadIdx.x >> 3);
    float v = 0.0f;
    int c = 0;
    if (e < kTri) {
      const float* row = partial + e * n_blocks;
#pragma unroll 4
      for (int blk = part; blk < n_blocks; blk += 8) v += __ldcg(row + blk);
    } else if (e == kTri) {
      const float* row = partial + e * n_blocks;
#pragma unroll 4
      for (int blk = part; blk < n_blocks; blk += 8) c += __float_as_int(__ldcg(row + blk));
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off, 8);
      c += __shfl_down_sync(0xffffffffu, c, off, 8);
    }
    if (part == 0 && e < kTri) tot[e] = v;
    if (part == 0 && e == kTri) tot[e] = __int_as_float(c);
  }
  __syncthreads();

  // out: H (6x6 row-major), g (6), sq_sum, inliers
  if (threadIdx.x < 36) {
    const int i = threadIdx.x / 6, j = threadIdx.x % 6;
    out[threadIdx.x] = tot[i <= j ? tri(i, j) : tri(j, i)];
  } else if (threadIdx.x < 42) {
    out[threadIdx.x] = tot[tri(threadIdx.x - 36, 6)];
  } else if (threadIdx.x == 42) {
    out[42] = tot[kTri - 1];
  } else if (threadIdx.x == 43) {
    out[43] = tot[kTri];
  } else if (threadIdx.x == 44) {
    counters[prob] = 0;  // ready for the next launch on this stream
  } else if (threadIdx.x == 45 && do_step) {
    float T_in[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) T_in[k] = T[k];
    pose_update(tot, __float_as_int(tot[kTri]), T_in, p.damping, out + 44);
  }
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// One launch for `batch` problems on `stream`; returns cudaGetLastError().
//   T: 16 floats a problem, T_stride floats apart; mu: 2 floats, mu_stride.
//   src: (8, H, W) a plane set, src_stride floats apart (0: one set for all);
//   tgt: (10, H, W) likewise; problem b reads set b / share.
//   n_blocks: blocks a problem, the least that cover H * W pixels at 1024 a
//   block (the caller sizes the scratch by it, so it is the caller's to give).
//   scratch: batch * n_blocks * 29 floats; counters: batch zeroed uint32,
//   left zeroed; out: batch * 64 floats (H 36, g 6, sq_sum, inliers as int32
//   bits, then T_next 16 where do_step, else untouched).
int gn_reduce_launch(const GnParams* p, const float* T, long T_stride,
                     const float* mu, long mu_stride,
                     const float* src, long src_stride,
                     const float* tgt, long tgt_stride,
                     int batch, int share, int do_step, int n_blocks,
                     float* scratch, unsigned* counters, float* out,
                     void* stream) {
  constexpr int per_block = kQuad * kThreads;
  if (batch < 1 || batch > 65535 || share < 1 ||
      n_blocks != (p->height * p->width + per_block - 1) / per_block)
    return static_cast<int>(cudaErrorInvalidValue);
  gn_kernel<<<dim3(n_blocks, batch), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *p, T, T_stride, mu, mu_stride, src, src_stride, tgt, tgt_stride, share,
      do_step, scratch, counters, out);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel on `stream`: the least a launch costs on this card.
int gn_reduce_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* gn_reduce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
