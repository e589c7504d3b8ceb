// Device helpers shared by the MSCKF kernels: the JPL quaternion ->
// rotation of utils/quaternion.py and warp / block sums.
#pragma once

#include <cuda_runtime.h>

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

// Raise a kernel's dynamic shared memory limit above the default 48 KB
// (once per kernel and size).
template <typename K>
inline int allow_smem(K kernel, size_t bytes, size_t* done) {
  if (bytes <= 48 * 1024 || bytes <= *done) return 0;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == 0) *done = bytes;
  return err;
}

}  // namespace msckf
