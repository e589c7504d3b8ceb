// Device helpers shared by the MSCKF kernels: the JPL quaternion ->
// rotation of utils/quaternion.py, warp / block sums, shared-memory limits
// and the error-state injection that ends both EKF updates (K11, K12).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace msckf {

template <typename T>
__device__ inline void quat_normalize(T q[4]) {
  const T n = sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  for (int k = 0; k < 4; ++k) q[k] = q[k] / n;
}

// JPL quaternion -> rotation (R = (2w^2-1) I - 2w [v]x + 2 v v^T), q normalized.
template <typename T>
__device__ inline void to_rotation(const T qin[4], T R[9]) {
  T q[4] = {qin[0], qin[1], qin[2], qin[3]};
  quat_normalize(q);
  const T x = q[0], y = q[1], z = q[2], w = q[3];
  const T a = T(2) * w * w - T(1);
  R[0] = a + T(2) * x * x;
  R[1] = T(2) * w * z + T(2) * x * y;
  R[2] = -T(2) * w * y + T(2) * x * z;
  R[3] = -T(2) * w * z + T(2) * y * x;
  R[4] = a + T(2) * y * y;
  R[5] = T(2) * w * x + T(2) * y * z;
  R[6] = T(2) * w * y + T(2) * z * x;
  R[7] = -T(2) * w * x + T(2) * z * y;
  R[8] = a + T(2) * z * z;
}

// Sum over the 32 lanes of a warp; every lane gets lane 0's result.
template <typename T>
__device__ inline T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return __shfl_sync(0xffffffffu, v, 0);
}

// Sum over the block (blockDim.x a multiple of 32); every thread gets the
// same value.  ``scratch`` holds 32 values in shared memory.
template <typename T>
__device__ inline T block_sum(T v, T* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // a previous call may still be reading scratch
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  T s = T(0);
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += scratch[w];
  return s;
}

// Asynchronous copy of BYTES (4, 8 or 16, both addresses aligned to it)
// from global to shared memory (cp.async); cp_async_wait_all() waits for
// this thread's copies, a barrier after it for the block's.
template <int BYTES>
__device__ inline void cp_async(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(gmem),
                 "n"(BYTES)
                 : "memory");
}

__device__ inline void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Close this thread's group of copies issued since the last commit; wait
// until at most N of its groups are still in flight (groups land in order).
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 1 / x, correctly rounded (the value of T(1) / x), without the division's
// slow path
__device__ inline float rcp(float x) { return __frcp_rn(x); }
__device__ inline double rcp(double x) { return __drcp_rn(x); }

// Raise a kernel's dynamic shared memory limit where it and the kernel's
// static shared memory pass the default 48 KB (once per kernel and size).
template <typename K>
inline int allow_smem(K kernel, size_t bytes, size_t* done) {
  if (bytes <= *done) return 0;
  cudaFuncAttributes attr;
  int err = (int)cudaFuncGetAttributes(&attr, kernel);
  if (err != 0) return err;
  if (bytes + attr.sharedSizeBytes > 48 * 1024)
    err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)bytes);
  if (err == 0) *done = bytes;
  return err;
}

// The dynamic shared memory a block of ``kernel`` can take: the device's
// opt-in limit less the kernel's static shared memory.
template <typename K>
inline size_t smem_budget(K kernel) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess ||
      cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) {
    cudaGetLastError();
    return 48 * 1024;
  }
  return (size_t)optin - attr.sharedSizeBytes;
}

// ---- The error-state injection (uav_airvision_tpu/models/msckf/update.py
// :359-383, the port's update.py::_inject_delta) ----

// small_angle_quaternion of dtheta[0..2]
template <typename T>
__device__ inline void small_angle_quaternion(const T* dtheta, T q[4]) {
  const T dq[3] = {dtheta[0] / T(2), dtheta[1] / T(2), dtheta[2] / T(2)};
  const T nsq = dq[0] * dq[0] + dq[1] * dq[1] + dq[2] * dq[2];
  if (nsq <= T(1)) {
    const T w = T(1) - nsq;
    q[0] = dq[0];
    q[1] = dq[1];
    q[2] = dq[2];
    q[3] = sqrt(w > T(0) ? w : T(0));
  } else {
    const T s = T(1) / sqrt(T(1) + nsq);
    q[0] = dq[0] * s;
    q[1] = dq[1] * s;
    q[2] = dq[2] * s;
    q[3] = T(1) * s;
  }
}

// The JPL product q1 * q2 of the normalized inputs, normalized
template <typename T>
__device__ inline void quat_multiply(const T q1in[4], const T q2in[4], T out[4]) {
  T q1[4] = {q1in[0], q1in[1], q1in[2], q1in[3]};
  T q2[4] = {q2in[0], q2in[1], q2in[2], q2in[3]};
  quat_normalize(q1);
  quat_normalize(q2);
  const T x1 = q1[0], y1 = q1[1], z1 = q1[2], w1 = q1[3];
  const T a = q2[0], b = q2[1], c = q2[2], d = q2[3];
  out[0] = ((w1 * a + z1 * b) - y1 * c) + x1 * d;
  out[1] = ((-z1 * a + w1 * b) + x1 * c) + y1 * d;
  out[2] = ((y1 * a - x1 * b) + w1 * c) + z1 * d;
  out[3] = ((-x1 * a - y1 * b) - z1 * c) + w1 * d;
  quat_normalize(out);
}

// The state fields an update changes, as they were before it.
template <typename T>
struct InjectIn {
  const T *q, *bg, *v, *ba, *p;  // IMU: (4) (3) (3) (3) (3)
  const T *R, *t;                // extrinsic R_imu_cam0 (3, 3), t_cam0_imu (3)
  const T *cam_q, *cam_p;        // window: (N, 4), (N, 3)
  const int* count;              // live window slots
  int N;
};

// Floats of the injected state after delta in an update's output:
// q 4, bg 3, v 3, ba 3, p 3, R 9, t 3, cam_q 4N, cam_p 3N.
__host__ __device__ inline int inject_size(int N) { return 28 + 7 * N; }

// The boxplus of delta (21 + 6N) into the state, by the whole block (of at
// least 128 threads): quaternions by small-angle products, the rest by
// addition; window slots past count keep their pose.  The chains of
// divisions and square roots run side by side: thread 0 the IMU
// quaternion, thread 32 the extrinsic rotation, thread 64 the additions
// and too_large = |dv| > 0.5 | |dp| > 1, threads from 96 on a window slot
// each.  Writes the new fields to ``out`` (the layout of inject_size).
template <typename T>
__device__ void inject(const T* delta, const InjectIn<T>& s, T* out, uint8_t* too_large) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    T dq[4];
    small_angle_quaternion(delta, dq);
    quat_multiply(dq, s.q, out);
  } else if (tid == 32) {
    T dqe[4], Rd[9];
    small_angle_quaternion(delta + 15, dqe);
    to_rotation(dqe, Rd);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        out[16 + 3 * i + j] =
            (Rd[3 * i] * s.R[j] + Rd[3 * i + 1] * s.R[3 + j]) + Rd[3 * i + 2] * s.R[6 + j];
  } else if (tid == 64) {
    for (int k = 0; k < 3; ++k) {
      out[4 + k] = s.bg[k] + delta[3 + k];
      out[7 + k] = s.v[k] + delta[6 + k];
      out[10 + k] = s.ba[k] + delta[9 + k];
      out[13 + k] = s.p[k] + delta[12 + k];
      out[25 + k] = s.t[k] + delta[18 + k];
    }
    const T nv = sqrt(delta[6] * delta[6] + delta[7] * delta[7] + delta[8] * delta[8]);
    const T np = sqrt(delta[12] * delta[12] + delta[13] * delta[13] + delta[14] * delta[14]);
    *too_large = (nv > T(0.5)) || (np > T(1));
  }
  const int count = *s.count;
  T* cq = out + 28;
  T* cp = cq + 4 * s.N;
  for (int c = tid - 96; c < s.N; c += (int)blockDim.x - 96) {
    if (c < 0) break;
    const T* d = delta + 21 + 6 * c;
    if (c < count) {
      T dq[4];
      small_angle_quaternion(d, dq);
      quat_multiply(dq, s.cam_q + 4 * c, cq + 4 * c);
      for (int k = 0; k < 3; ++k) cp[3 * c + k] = s.cam_p[3 * c + k] + d[3 + k];
    } else {
      for (int k = 0; k < 4; ++k) cq[4 * c + k] = s.cam_q[4 * c + k];
      for (int k = 0; k < 3; ++k) cp[3 * c + k] = s.cam_p[3 * c + k];
    }
  }
}

}  // namespace msckf
