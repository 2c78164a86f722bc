// One Gauss-Newton reduction of dense point-to-plane + photometric ICP.
//
// Replaces the TPU kernels `gn_reduce` and `gn_reduce_batched` in
// slam_rgbd_tpu/ops/icp_pallas.py (body `_make_kernel`, pallas_calls at lines
// 413 and 493). It computes the same sums
// as that kernel and as `odometry/icp._normal_equations` with a fixed
// dominant-flow shift (mu_u, mu_v):
//
//   M_geo = sum_p w  a a^T,  a = [n, y x n, r]       (point-to-plane)
//   M_pho = sum_p wi b b^T,  b = [g, y x g, r_i]     (photometric, DVO)
//
// and returns H = (M_geo + M_pho)[:6, :6], g = (M_geo + M_pho)[:6, 6], the
// inlier count and sq_sum = M_geo[6, 6].
//
// Design. The TPU kernel rolls the target by -mu, streams row tiles through
// VMEM and evaluates bilinear sampling as a (2R+2)^2 shift-FMA stencil,
// because gathers are slow there. Here one thread takes one source pixel and
// gathers the four bilinear corners of the ten target channels directly at
// the absolute projected point. It reproduces the stencil's gates: a corner
// counts only where its offset from (u + mu_u, v + mu_v) lies in [-R, R+1]
// and inside the image, and the pixel is kept only where the sum of those
// weights and the weighted validity both exceed 0.999.
//
// What bounds it on an H100: the gathers. A 640x480 target level is
// 10 x 307200 floats = 12 MB, which stays resident in the 50 MB L2 across
// the GN iterations of a level, so the corner reads are L2 hits; neighbouring
// threads read neighbouring corners, so a warp's loads fall on few lines.
// The arithmetic (~300 flops a pixel) and the source read (8 planes, one
// coalesced pass) are small beside it.
//
// Reduction. Each block reduces its 28 + 28 upper-triangle entries and its
// inlier count with warp shuffles, then across warps through shared memory,
// and writes one column of a [entry][block] partial table. A second
// one-block kernel sums each row with one warp, in a fixed order. No float
// atomics: repeated runs give identical output.
//
// Batch. `blockIdx.y` of the pixel kernel and `blockIdx.x` of the finalize
// kernel name the problem: each problem has its own 18 scalars, planes,
// partial table and outputs, and the per-block partials and the order of the
// final sums do not depend on how many problems a launch holds. Problem b of
// a batched launch therefore equals, bit for bit, a single launch on the same
// inputs (the TPU kernel's contract). A single 640x480 launch is mostly launch
// gaps and its one-block finalize; eight problems read 8 x 22 MB of planes,
// more than L2 holds, and the batched launch moves toward its device-memory
// bound (`PERF.md` has the times beside the bounds).
//
// Numerics. Built with --fmad=false, so every product and sum rounds as the
// plain torch version (`gn_reduce_reference`) rounds it, and per-pixel
// values and gates agree bit for bit; only the order of the final sums
// differs.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTri = 28;           // upper triangle of a 7x7 block
constexpr int kEntries = 2 * kTri; // geometric block, then photometric
constexpr int kPartialRow = kEntries + 1;  // + inlier count (as float bits)
constexpr int kFinalThreads = 1024;
constexpr int kScalars = 18;  // T row-major, mu_u, mu_v
constexpr int kOut = 43;      // H 6x6, g 6, sq_sum

struct Params {
  int height, width, radius;
  float fx, fy, cx, cy;
  float min_depth, max_dist_sq, cos_thresh;
  float huber, rgb_w, rgb_huber;
};

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

__global__ void __launch_bounds__(kThreads)
gn_pixels(const float* __restrict__ scal_all, const float* __restrict__ src_all,
          const float* __restrict__ tgt_all, Params p,
          float* __restrict__ partial_all) {
  __shared__ float sh[kEntries][kWarps];
  __shared__ int sh_cnt[kWarps];

  const int n = p.height * p.width;
  // this block's problem
  const size_t prob = blockIdx.y;
  const float* __restrict__ scal = scal_all + prob * kScalars;
  const float* __restrict__ src = src_all + prob * 8 * n;
  const float* __restrict__ tgt = tgt_all + prob * 10 * n;
  float* __restrict__ partial = partial_all + prob * gridDim.x * kPartialRow;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  float a[7], b[7];
  float w = 0.0f, wi = 0.0f;
  int inlier = 0;
#pragma unroll
  for (int k = 0; k < 7; ++k) { a[k] = 0.0f; b[k] = 0.0f; }

  if (idx < n) {
    const int v = idx / p.width;
    const int u = idx - v * p.width;
    float t[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) t[k] = scal[k];
    const float mu_u = scal[16], mu_v = scal[17];

    const float px = src[idx], py = src[n + idx], pz = src[2 * n + idx];
    const float snx = src[3 * n + idx], sny = src[4 * n + idx], snz = src[5 * n + idx];
    const float sval = src[6 * n + idx], sint = src[7 * n + idx];

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
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (wc[k] != 0.0f) {  // a zero weight adds nothing
        const int tu = (int)(ubase + du0) + (k & 1);
        const int tv = (int)(vbase + dv0) + (k >> 1);
        const float* q = tgt + tv * p.width + tu;
#pragma unroll
        for (int c = 0; c < 10; ++c) acc[c] = acc[c] + wc[k] * q[c * n];
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

    // geometric point-to-plane row
    const float r = nx * dx + ny * dy + nz * dz;
    a[0] = nx; a[1] = ny; a[2] = nz;
    a[3] = yy * nz - yz * ny;
    a[4] = yz * nx - yx * nz;
    a[5] = yx * ny - yy * nx;
    a[6] = r;
    const float abs_r = fabsf(r);
    w = abs_r <= p.huber ? 1.0f : p.huber / max_nan(abs_r, 1e-12f);
    w = mask ? w : 0.0f;

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
    wi = abs_ri <= p.rgb_huber ? 1.0f : p.rgb_huber / max_nan(abs_ri, 1e-12f);
    wi = mask ? wi * p.rgb_w : 0.0f;
    inlier = mask ? 1 : 0;
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int e = 0;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    const float wa = w * a[i];
    const float wb = wi * b[i];
#pragma unroll
    for (int j = i; j < 7; ++j, ++e) {
      const float sg = warp_sum(wa * a[j]);
      const float sp = warp_sum(wb * b[j]);
      if (lane == 0) { sh[e][warp] = sg; sh[kTri + e][warp] = sp; }
    }
  }
  const int cnt = warp_sum_int(inlier);
  if (lane == 0) sh_cnt[warp] = cnt;
  __syncthreads();

  // partial layout: [entry][block], entries 0..55 then the count
  if (threadIdx.x < kEntries) {
    float s = sh[threadIdx.x][0];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) s += sh[threadIdx.x][k];
    partial[threadIdx.x * gridDim.x + blockIdx.x] = s;
  } else if (threadIdx.x == kEntries) {
    int s = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) s += sh_cnt[k];
    partial[kEntries * gridDim.x + blockIdx.x] = __int_as_float(s);
  }
}

__global__ void __launch_bounds__(kFinalThreads)
gn_finalize(const float* __restrict__ partial_all, int n_blocks,
            float* __restrict__ out_all, int* __restrict__ inliers_all) {
  __shared__ float tot[kEntries];
  __shared__ int count;
  // one block a problem
  const float* __restrict__ partial =
      partial_all + (size_t)blockIdx.x * n_blocks * kPartialRow;
  float* __restrict__ out = out_all + blockIdx.x * kOut;
  int* __restrict__ inliers = inliers_all + blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // one warp per partial row: lanes stride over the blocks in a fixed
  // order, then a fixed shuffle tree
  for (int e = warp; e < kPartialRow; e += kFinalThreads / 32) {
    const float* row = partial + e * n_blocks;
    if (e < kEntries) {
      float s = 0.0f;
      for (int blk = lane; blk < n_blocks; blk += 32) s += row[blk];
      s = warp_sum(s);
      if (lane == 0) tot[e] = s;
    } else {
      int s = 0;
      for (int blk = lane; blk < n_blocks; blk += 32) s += __float_as_int(row[blk]);
      s = warp_sum_int(s);
      if (lane == 0) count = s;
    }
  }
  __syncthreads();

  // out: H (6x6 row-major), g (6), sq_sum
  if (threadIdx.x < 36) {
    int i = threadIdx.x / 6, j = threadIdx.x % 6;
    if (i > j) { const int s = i; i = j; j = s; }
    const int e = i * 7 - i * (i - 1) / 2 + (j - i);
    out[threadIdx.x] = tot[e] + tot[kTri + e];
  } else if (threadIdx.x < 42) {
    const int i = threadIdx.x - 36;
    const int e = i * 7 - i * (i - 1) / 2 + (6 - i);
    out[threadIdx.x] = tot[e] + tot[kTri + e];
  } else if (threadIdx.x == 42) {
    out[42] = tot[kTri - 1];  // M_geo[6, 6]
  } else if (threadIdx.x == 43) {
    *inliers = count;
  }
}

// Both kernels for `batch` problems laid out one after another.
int launch(const float* scal, const float* src, const float* tgt, int batch,
           const Params& p, float* scratch, float* out, int* inliers,
           void* stream) {
  const int n_blocks = (p.height * p.width + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gn_pixels<<<dim3(n_blocks, batch), kThreads, 0, s>>>(scal, src, tgt, p, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gn_finalize<<<batch, kFinalThreads, 0, s>>>(scratch, n_blocks, out, inliers);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Length of the scratch buffer `gn_reduce_launch` needs, in floats.
int gn_reduce_scratch_floats(int height, int width) {
  const int n_blocks = (height * width + kThreads - 1) / kThreads;
  return n_blocks * kPartialRow;
}

// Length of the scratch buffer `gn_reduce_batched_launch` needs, in floats.
int gn_reduce_batched_scratch_floats(int batch, int height, int width) {
  return batch * gn_reduce_scratch_floats(height, width);
}

// scal: 18 floats on the device (T row-major, mu_u, mu_v).
// src: (8, H, W), tgt: (10, H, W), both float32, contiguous.
// out: 43 floats (H 6x6, g 6, sq_sum); inliers: one int32.
// Launches on `stream` and returns cudaGetLastError().
int gn_reduce_launch(const float* scal, const float* src, const float* tgt,
                     int height, int width, int radius,
                     float fx, float fy, float cx, float cy,
                     float min_depth, float max_dist_sq, float cos_thresh,
                     float huber, float rgb_w, float rgb_huber,
                     float* scratch, float* out, int* inliers, void* stream) {
  const Params p{height, width, radius, fx, fy, cx, cy,
                 min_depth, max_dist_sq, cos_thresh, huber, rgb_w, rgb_huber};
  return launch(scal, src, tgt, 1, p, scratch, out, inliers, stream);
}

// `batch` independent problems in one launch of each kernel.
// scal: (batch, 18); src: (batch, 8, H, W); tgt: (batch, 10, H, W);
// out: (batch, 43); inliers: (batch,) int32; scratch:
// gn_reduce_batched_scratch_floats(batch, H, W) floats. batch <= 65535.
int gn_reduce_batched_launch(const float* scal, const float* src,
                             const float* tgt, int batch,
                             int height, int width, int radius,
                             float fx, float fy, float cx, float cy,
                             float min_depth, float max_dist_sq, float cos_thresh,
                             float huber, float rgb_w, float rgb_huber,
                             float* scratch, float* out, int* inliers,
                             void* stream) {
  const Params p{height, width, radius, fx, fy, cx, cy,
                 min_depth, max_dist_sq, cos_thresh, huber, rgb_w, rgb_huber};
  return launch(scal, src, tgt, batch, p, scratch, out, inliers, stream);
}

const char* gn_reduce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
