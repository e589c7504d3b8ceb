// K7: the pinhole camera model with radtan / equidistant distortion, one
// thread per point.
//
// Replaces uav_airvision_tpu/ops/camera.py::undistort_points (:99),
// distort_points (:114) and homography_warp_points (:123).  Three entry
// points; a fourth fuses the stereo prologue (undistort + rectify, then
// distort with the same camera, models/frontend/stereo.py) and returns what
// the two calls return.  Two more fuse the camera model with the glue around
// it, each one launch where eager PyTorch made ~40 and ~25:
//   - camera_predict_warp: the IMU-rotation prediction (the JAX package's
//     models/frontend/pipeline.py::predicted_rotations, cam0 only) and the
//     K R K^-1 warp of the previous frame's points;
//   - camera_stereo_gate: the stereo matcher's cuts after the backward LK
//     (JAX models/frontend/stereo.py:97-125): the fwd/bwd error, the
//     vertical disparity, the bounds and the epipolar residual with both
//     sides undistorted by the cam0 model.
// Intrinsics [fx fy cx cy] and coefficients arrive as four values shared by
// all points (point stride 0) or as a (4, n) array (point stride 1, field
// stride n); the two fused entry points take one camera's four values.
//
// The device functions are in camera_common.cuh, which keeps the plain
// version's operation order (radtan bit-exact).  The plain version forms
// its 3x3 products (R' w, K K, K R K^-1, the epipolar line) with library
// products that may fuse multiply-adds, so those round within a few ulps of
// it, not to its bits.
//
// Bound on the card: bytes (16 B per point in and out; ~100 FLOP per point),
// at most 408 points: a launch-latency kernel.

#include <cuda_runtime.h>
#include <math.h>

#include "camera_common.cuh"

namespace {

using camera::Params;

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
undistort_kernel(const float* __restrict__ pts, int n, Params intr, Params coef, int model,
                 const float* __restrict__ R, const float* __restrict__ new_intr,
                 float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float x = pts[2 * i], y = pts[2 * i + 1];
  camera::undistort_point(i, &x, &y, intr, coef, model, R, new_intr);
  out[2 * i] = x;
  out[2 * i + 1] = y;
}

__global__ void __launch_bounds__(kThreads)
distort_kernel(const float* __restrict__ pts, int n, Params intr, Params coef, int model,
               float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float x = pts[2 * i], y = pts[2 * i + 1];
  camera::distort_point(i, &x, &y, intr, coef, model);
  out[2 * i] = x;
  out[2 * i + 1] = y;
}

// out_und = undistort(pts, R), out_dis = distort(out_und), same camera
__global__ void __launch_bounds__(kThreads)
undistort_distort_kernel(const float* __restrict__ pts, int n, Params intr, Params coef,
                         int model, const float* __restrict__ R, float* __restrict__ out_und,
                         float* __restrict__ out_dis) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float x = pts[2 * i], y = pts[2 * i + 1];
  camera::undistort_point(i, &x, &y, intr, coef, model, R, nullptr);
  out_und[2 * i] = x;
  out_und[2 * i + 1] = y;
  camera::distort_point(i, &x, &y, intr, coef, model);
  out_dis[2 * i] = x;
  out_dis[2 * i + 1] = y;
}

// w = (K R K^-1) [x y 1]', out = w[:2] / w[2]
__global__ void __launch_bounds__(kThreads)
warp_kernel(const float* __restrict__ pts, int n, Params intr, const float* __restrict__ R,
            float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float Hm[9];
  camera::homography(intr.get(0, i), intr.get(1, i), intr.get(2, i), intr.get(3, i), R, Hm);
  float x = pts[2 * i], y = pts[2 * i + 1];
  camera::warp_point(Hm, &x, &y);
  out[2 * i] = x;
  out[2 * i + 1] = y;
}

// The predicted rotation and its homography, once per block: R_p_c =
// rodrigues(R_cam_imu' w dt)' (the identity for an angle <= 1e-12), Hm =
// K R_p_c K^-1; then one thread per point warps it.  The rotation's
// expressions follow the plain version's (ops/camera.py::rodrigues):
// R = (I + sin(t) K) + (1 - cos(t)) K K with K the skew matrix of the unit
// axis.  out: the n warped points, then R_p_c (row-major).  Instances:
// blockIdx.y is the instance (its points, rate, dt and output row each at
// its own instance stride), and block (0, b) writes instance b's R_p_c.
__global__ void __launch_bounds__(kThreads)
predict_warp_kernel(const float* __restrict__ pts, int n, const float* __restrict__ w,
                    const float* __restrict__ dt, const float* __restrict__ R_cam_imu,
                    const float* __restrict__ intr, float* __restrict__ out, long long pts_s,
                    long long w_s, long long dt_s, long long out_s) {
  __shared__ float s_H[9];
  const long long b = blockIdx.y;
  pts += b * pts_s;
  w += b * w_s;
  dt += b * dt_s;
  out += b * out_s;
  if (threadIdx.x == 0) {
    const float t = *dt;
    float r[3];
    for (int c = 0; c < 3; ++c)  // (R' w)[c] * dt
      r[c] = (R_cam_imu[c] * w[0] + R_cam_imu[3 + c] * w[1] + R_cam_imu[6 + c] * w[2]) * t;
    const float theta = sqrtf(r[0] * r[0] + r[1] * r[1] + r[2] * r[2]);
    float Rpc[9] = {1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 1.0f};
    if (theta > 1e-12f) {
      const float kx = r[0] / theta, ky = r[1] / theta, kz = r[2] / theta;
      const float K[9] = {0.0f, -kz, ky, kz, 0.0f, -kx, -ky, kx, 0.0f};
      float KK[9];
      camera::mat3_mul(K, K, KK);
      const float s = sinf(theta), c1 = 1.0f - cosf(theta);
      for (int a = 0; a < 3; ++a)
        for (int b = 0; b < 3; ++b)  // transposed: R_p_c = R'
          Rpc[3 * b + a] = ((a == b ? 1.0f : 0.0f) + s * K[3 * a + b]) + c1 * KK[3 * a + b];
    }
    camera::homography(intr[0], intr[1], intr[2], intr[3], Rpc, s_H);
    if (blockIdx.x == 0)
      for (int k = 0; k < 9; ++k) out[2 * n + k] = Rpc[k];
  }
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float x = pts[2 * i], y = pts[2 * i + 1];
  camera::warp_point(s_H, &x, &y);
  out[2 * i] = x;
  out[2 * i + 1] = y;
}

// The stereo matcher's cuts after the backward LK, one thread per point:
// valid & st_fwd & |cam0 - p0r| < fwd_bwd & |proj1_y - p1_y| < max_vdisp &
// p1 inside [0, w) x [0, h) & the epipolar residual |u1_x l_0| / |l[:2]| <=
// thresh * 4 / (2 fx + 2 fy), with l = E [u0 1]' and u0, u1 the cam0 and the
// cam1 point undistorted by the cam0 model (the reference's quirk).
__global__ void __launch_bounds__(kThreads)
stereo_gate_kernel(const float* __restrict__ cam0, const float* __restrict__ p1,
                   const float* __restrict__ p0r, const float* __restrict__ proj1,
                   const bool* __restrict__ valid, const bool* __restrict__ st_fwd, int n,
                   Params intr, Params coef, int model, const float* __restrict__ E,
                   float fwd_bwd, float max_vdisp, float thresh, int h, int w,
                   bool* __restrict__ inlier) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float x0 = cam0[2 * i], y0 = cam0[2 * i + 1];
  const float x1 = p1[2 * i], y1 = p1[2 * i + 1];
  const float dx = x0 - p0r[2 * i], dy = y0 - p0r[2 * i + 1];
  const float err = sqrtf(dx * dx + dy * dy);
  const float disp = fabsf(proj1[2 * i + 1] - y1);
  bool ok = valid[i] && st_fwd[i] && err < fwd_bwd && disp < max_vdisp;
  ok = ok && x1 >= 0.0f && x1 < (float)w && y1 >= 0.0f && y1 < (float)h;
  float u0x = x0, u0y = y0, u1x = x1, u1y = y1;
  camera::undistort_point(i, &u0x, &u0y, intr, coef, model, nullptr, nullptr);
  camera::undistort_point(i, &u1x, &u1y, intr, coef, model, nullptr, nullptr);
  const float l0 = E[0] * u0x + E[1] * u0y + E[2] * 1.0f;
  const float l1 = E[3] * u0x + E[4] * u0y + E[5] * 1.0f;
  const float err_epi = fabsf(u1x * l0) / sqrtf(l0 * l0 + l1 * l1);
  const float norm_unit = 4.0f / (2.0f * intr.get(0, i) + 2.0f * intr.get(1, i));
  inlier[i] = ok && err_epi <= thresh * norm_unit;
}

inline int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int camera_undistort(const void* pts, int n, const void* intr, int intr_fs,
                                int intr_ps, const void* coef, int coef_fs, int coef_ps,
                                int model, const void* R, const void* new_intr, void* out,
                                void* stream) {
  if (n == 0) return 0;
  undistort_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)pts, n, Params{(const float*)intr, intr_fs, intr_ps},
      Params{(const float*)coef, coef_fs, coef_ps}, model, (const float*)R,
      (const float*)new_intr, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int camera_distort(const void* pts, int n, const void* intr, int intr_fs,
                              int intr_ps, const void* coef, int coef_fs, int coef_ps,
                              int model, void* out, void* stream) {
  if (n == 0) return 0;
  distort_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)pts, n, Params{(const float*)intr, intr_fs, intr_ps},
      Params{(const float*)coef, coef_fs, coef_ps}, model, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int camera_undistort_distort(const void* pts, int n, const void* intr, int intr_fs,
                                        int intr_ps, const void* coef, int coef_fs,
                                        int coef_ps, int model, const void* R, void* out_und,
                                        void* out_dis, void* stream) {
  if (n == 0) return 0;
  undistort_distort_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)pts, n, Params{(const float*)intr, intr_fs, intr_ps},
      Params{(const float*)coef, coef_fs, coef_ps}, model, (const float*)R, (float*)out_und,
      (float*)out_dis);
  return (int)cudaGetLastError();
}

extern "C" int camera_warp(const void* pts, int n, const void* intr, int intr_fs, int intr_ps,
                           const void* R, void* out, void* stream) {
  if (n == 0) return 0;
  warp_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)pts, n, Params{(const float*)intr, intr_fs, intr_ps}, (const float*)R,
      (float*)out);
  return (int)cudaGetLastError();
}

// pts (n_inst, n, 2), w (n_inst, 3), dt (n_inst), out (n_inst, 2 n + 9), each
// instance at its stride (strides: 4 host int64, in floats: pts, w, dt, out)
extern "C" int camera_predict_warp(const void* pts, int n, const void* w, const void* dt,
                                   const void* R_cam_imu, const void* intr, void* out,
                                   int n_inst, const void* strides, void* stream) {
  if (n_inst < 1 || n_inst > 65535) return (int)cudaErrorInvalidValue;
  const long long* st = (const long long*)strides;
  predict_warp_kernel<<<dim3(blocks(n > 0 ? n : 1), n_inst), kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const float*)pts, n, (const float*)w, (const float*)dt, (const float*)R_cam_imu,
      (const float*)intr, (float*)out, st[0], st[1], st[2], st[3]);
  return (int)cudaGetLastError();
}

extern "C" int camera_stereo_gate(const void* cam0, const void* p1, const void* p0r,
                                  const void* proj1, const void* valid, const void* st_fwd, int n,
                                  const void* intr, const void* coef, int model, const void* E,
                                  float fwd_bwd, float max_vdisp, float thresh, int h, int w,
                                  void* inlier, void* stream) {
  if (n == 0) return 0;
  stereo_gate_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)cam0, (const float*)p1, (const float*)p0r, (const float*)proj1,
      (const bool*)valid, (const bool*)st_fwd, n, Params{(const float*)intr, 1, 0},
      Params{(const float*)coef, 1, 0}, model, (const float*)E, fwd_bwd, max_vdisp, thresh, h, w,
      (bool*)inlier);
  return (int)cudaGetLastError();
}
