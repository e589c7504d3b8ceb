// K4 + K6: FAST-9/16 with the OpenCV score, the 7x7 detection mask built
// in-kernel from the tracked-point list, and the strict 3x3 non-max
// suppression.
//
// Replaces uav_airvision_tpu/ops/fast.py::detect_fast (fast_score_map :37,
// nonmax_3x3 :90) and models/frontend/pipeline.py::_detection_mask :145.
// The JAX package builds 16 shifted bf16 planes, a log-depth sliding-min
// tree and a (H,F)@(F,W) mask matmul; here one thread owns one pixel:
//   pass 1: the 16 ring differences in registers; bright/dark = max over the
//           16 arc starts of the min over 9 consecutive differences;
//           corner = bright > thr | dark > thr; score = max(bright, dark) - 1;
//           3-px border; then the mask (pixel excluded iff some valid point
//           with floor(x) >= 3 and floor(y) >= 3 lies within 3 px in both
//           axes; the point list sits in shared memory) zeroes score and
//           corner BEFORE the NMS, as fast.py:107-110 does;
//   pass 2: keep = corner & score > 0 & score > all 8 neighbours (zero
//           outside the image).
// Integer arithmetic throughout, so the result is exact.
//
// Bound on the card: the mask test (up to 104 points per pixel, from shared
// memory) and the 16 ring loads per pixel; a 480x752 frame is 0.36 M pixels.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__constant__ int c_dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int c_dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

constexpr int kMaxPts = 1024;

__global__ void fast_score_masked_kernel(const uint8_t* __restrict__ img, int H,
                                         int W, int thr,
                                         const float* __restrict__ pts,
                                         const uint8_t* __restrict__ pvalid,
                                         int n_pts, int* __restrict__ score_out,
                                         uint8_t* __restrict__ corner_out) {
  __shared__ int s_ix[kMaxPts];
  __shared__ int s_iy[kMaxPts];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int k = tid; k < n_pts; k += blockDim.x * blockDim.y) {
    const int ix = (int)floorf(pts[2 * k]);
    const int iy = (int)floorf(pts[2 * k + 1]);
    const bool ok = pvalid[k] && ix >= 3 && iy >= 3;
    s_ix[k] = ok ? ix : -10;  // the strip then lies fully outside the image
    s_iy[k] = ok ? iy : -10;
  }
  __syncthreads();
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;

  int score = 0;
  bool corner = false;
  if (y >= 3 && y < H - 3 && x >= 3 && x < W - 3) {
    const int c = img[y * W + x];
    int d[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) d[k] = (int)img[(y + c_dy[k]) * W + x + c_dx[k]] - c;
    // bright = max over arcs of min(d), dark = max over arcs of min(-d)
    //       = -(min over arcs of max(d))
    int bright = -1024, dark_neg = 1024;
    for (int s = 0; s < 16; ++s) {
      int mn = 1024, mx = -1024;
      for (int k = 0; k < 9; ++k) {
        const int v = d[(s + k) & 15];
        mn = v < mn ? v : mn;
        mx = v > mx ? v : mx;
      }
      bright = mn > bright ? mn : bright;
      dark_neg = mx < dark_neg ? mx : dark_neg;
    }
    const int dark = -dark_neg;
    corner = bright > thr || dark > thr;
    score = corner ? max(bright, dark) - 1 : 0;
  }
  for (int k = 0; k < n_pts; ++k) {
    if (abs(y - s_iy[k]) <= 3 && abs(x - s_ix[k]) <= 3) {
      score = 0;
      corner = false;
      break;
    }
  }
  score_out[y * W + x] = score;
  corner_out[y * W + x] = corner;
}

__global__ void nms3x3_kernel(const int* __restrict__ score,
                              const uint8_t* __restrict__ corner, int H, int W,
                              uint8_t* __restrict__ keep_out,
                              int* __restrict__ score_out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const int s = score[y * W + x];
  bool keep = corner[y * W + x] && s > 0;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      if (dy == 0 && dx == 0) continue;
      const int ny = y + dy, nx = x + dx;
      const int nb = (ny >= 0 && ny < H && nx >= 0 && nx < W) ? score[ny * W + nx] : 0;
      keep = keep && s > nb;
    }
  }
  keep_out[y * W + x] = keep;
  score_out[y * W + x] = keep ? s : 0;
}

}  // namespace

extern "C" int fast_detect_masked(const void* img, int H, int W, int thr,
                                  const void* pts, const void* pts_valid,
                                  int n_pts, void* score_tmp, void* corner_tmp,
                                  void* keep_out, void* score_out,
                                  void* stream) {
  if (n_pts > kMaxPts) return (int)cudaErrorInvalidValue;
  const dim3 block(32, 8);
  const dim3 grid((W + 31) / 32, (H + 7) / 8);
  cudaStream_t s = (cudaStream_t)stream;
  fast_score_masked_kernel<<<grid, block, 0, s>>>(
      (const uint8_t*)img, H, W, thr, (const float*)pts,
      (const uint8_t*)pts_valid, n_pts, (int*)score_tmp, (uint8_t*)corner_tmp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms3x3_kernel<<<grid, block, 0, s>>>((const int*)score_tmp,
                                       (const uint8_t*)corner_tmp, H, W,
                                       (uint8_t*)keep_out, (int*)score_out);
  return (int)cudaGetLastError();
}
