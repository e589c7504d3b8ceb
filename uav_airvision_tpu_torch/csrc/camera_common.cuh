// Device functions of K7, the pinhole camera model with radtan /
// equidistant distortion (uav_airvision_tpu/ops/camera.py), shared by the
// entry points of camera.cu.
//
// Every expression keeps the operation order of the plain PyTorch version
// (ops/camera.py) and the library builds with -fmad=false, so radtan results
// are the plain version's bits; the equidistant model goes through atanf /
// tanf / powf, the functions PyTorch's own CUDA kernels call.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace camera {

constexpr int kIters = 5;  // cv2.undistortPoints' fixed-point iterations

struct Params {  // four values per point
  const float* p;
  int field_stride, point_stride;
  __device__ float get(int field, int i) const {
    return p[(size_t)field * field_stride + (size_t)i * point_stride];
  }
};

__device__ inline void radtan_delta(float x, float y, float k1, float k2, float p1, float p2,
                                    float* radial, float* dx, float* dy) {
  const float r2 = x * x + y * y;
  *radial = 1.0f + k1 * r2 + k2 * r2 * r2;
  *dx = 2.0f * p1 * x * y + p2 * (r2 + 2.0f * x * x);
  *dy = p1 * (r2 + 2.0f * y * y) + 2.0f * p2 * x * y;
}

__device__ inline float equidistant_poly(float t2, float k1, float k2, float k3, float k4) {
  return 1.0f + k1 * t2 + k2 * (t2 * t2) + k3 * (t2 * t2 * t2) + k4 * powf(t2, 4.0f);
}

__device__ inline void undistort_normalized(int model, float* x, float* y, float c1, float c2,
                                            float c3, float c4) {
  if (model == 0) {
    const float x0 = *x, y0 = *y;
    float xx = x0, yy = y0;
    for (int it = 0; it < kIters; ++it) {
      float radial, dx, dy;
      radtan_delta(xx, yy, c1, c2, c3, c4, &radial, &dx, &dy);
      const float inv = 1.0f / radial;
      xx = (x0 - dx) * inv;
      yy = (y0 - dy) * inv;
    }
    *x = xx;
    *y = yy;
  } else {
    const float theta_d = sqrtf(*x * *x + *y * *y);
    float theta = theta_d;
    for (int it = 0; it < kIters; ++it)
      theta = theta_d / equidistant_poly(theta * theta, c1, c2, c3, c4);
    const float scale = theta_d > 1e-12f ? tanf(theta) / fmaxf(theta_d, 1e-12f) : 1.0f;
    *x = *x * scale;
    *y = *y * scale;
  }
}

__device__ inline void distort_normalized(int model, float* x, float* y, float c1, float c2,
                                          float c3, float c4) {
  if (model == 0) {
    float radial, dx, dy;
    radtan_delta(*x, *y, c1, c2, c3, c4, &radial, &dx, &dy);
    const float xd = *x * radial + dx, yd = *y * radial + dy;
    *x = xd;
    *y = yd;
  } else {
    const float r = sqrtf(*x * *x + *y * *y);
    const float r_safe = r > 1e-12f ? r : 1.0f;
    const float theta = atanf(r);
    const float theta_d = theta * equidistant_poly(theta * theta, c1, c2, c3, c4);
    const float scale = r > 1e-12f ? theta_d / r_safe : 1.0f;
    *x = *x * scale;
    *y = *y * scale;
  }
}

// pixel -> normalized -> undistorted -> (rectified) -> new intrinsics
__device__ inline void undistort_point(int i, float* x, float* y, Params intr, Params coef,
                                       int model, const float* R, const float* new_intr) {
  *x = (*x - intr.get(2, i)) / intr.get(0, i);
  *y = (*y - intr.get(3, i)) / intr.get(1, i);
  undistort_normalized(model, x, y, coef.get(0, i), coef.get(1, i), coef.get(2, i),
                       coef.get(3, i));
  if (R != nullptr) {
    const float hx = R[0] * *x + R[1] * *y + R[2];
    const float hy = R[3] * *x + R[4] * *y + R[5];
    const float hz = R[6] * *x + R[7] * *y + R[8];
    *x = hx / hz;
    *y = hy / hz;
  }
  if (new_intr != nullptr) {
    *x = *x * new_intr[0] + new_intr[2];
    *y = *y * new_intr[1] + new_intr[3];
  } else {  // (1, 1, 0, 0), with the plain version's x * 1 + 0 (-0 becomes +0)
    *x = *x * 1.0f + 0.0f;
    *y = *y * 1.0f + 0.0f;
  }
}

__device__ inline void distort_point(int i, float* x, float* y, Params intr, Params coef,
                                     int model) {
  distort_normalized(model, x, y, coef.get(0, i), coef.get(1, i), coef.get(2, i),
                     coef.get(3, i));
  *x = *x * intr.get(0, i) + intr.get(2, i);
  *y = *y * intr.get(1, i) + intr.get(3, i);
}

__device__ inline void mat3_mul(const float* A, const float* B, float* C) {
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      C[3 * r + c] = A[3 * r] * B[c] + A[3 * r + 1] * B[3 + c] + A[3 * r + 2] * B[6 + c];
}

// Hm = K R K^-1 for intrinsics [fx fy cx cy]
__device__ inline void homography(float fx, float fy, float cx, float cy, const float* R,
                                  float* Hm) {
  const float K[9] = {fx, 0.0f, cx, 0.0f, fy, cy, 0.0f, 0.0f, 1.0f};
  const float Kinv[9] = {1.0f / fx, 0.0f, -cx / fx, 0.0f, 1.0f / fy, -cy / fy, 0.0f, 0.0f, 1.0f};
  float Rl[9], KR[9];
  for (int k = 0; k < 9; ++k) Rl[k] = R[k];
  mat3_mul(K, Rl, KR);
  mat3_mul(KR, Kinv, Hm);
}

// w = Hm [x y 1]', (x, y) <- w[:2] / w[2]
__device__ inline void warp_point(const float* Hm, float* x, float* y) {
  const float wx = Hm[0] * *x + Hm[1] * *y + Hm[2];
  const float wy = Hm[3] * *x + Hm[4] * *y + Hm[5];
  const float wz = Hm[6] * *x + Hm[7] * *y + Hm[8];
  *x = wx / wz;
  *y = wy / wz;
}

}  // namespace camera
