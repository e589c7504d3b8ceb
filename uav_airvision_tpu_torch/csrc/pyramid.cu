// K2: one padded pyramid level (cv2 pyrDown semantics + REFLECT_101 pad).
//
// Replaces uav_airvision_tpu/ops/pyramid.py::build_pyramid_padded
// (pyr_down :66, build_pyramid :85): the JAX package decimates with two
// banded matmuls on the MXU and rounds floor(k/256 + 0.5); here one thread
// computes one pixel of the PADDED output level directly:
//   * the padded coordinate maps to the unpadded one by REFLECT_101 (the
//     triangle wave of jnp.pad(mode="reflect"), valid for any pad width),
//   * down=1: the 5x5 integer sum of [1 4 6 4 1] x [1 4 6 4 1] over the
//     source level with REFLECT_101 borders, rounded as (k + 128) >> 8 --
//     exactly cv2's uint8 pyrDown and the JAX floor(k/256 + 0.5),
//   * down=0: a plain reflect copy (level 0).
// All integer arithmetic, so the result is exact.
//
// Bound on the card: memory.  A 480x752 level reads ~25 source taps per
// output pixel, all from L1/L2; the four levels of one camera write 0.6 MB.
// The launch is tiny (~0.4 M threads for level 0) and latency-bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  int m = i % period;
  if (m < 0) m += period;
  return m < n ? m : period - m;
}

// The fold of _decimation_matrix (pyramid.py:56-61): one reflection.
__device__ __forceinline__ int fold(int s, int n) {
  if (s < 0) s = -s;
  if (s >= n) s = 2 * (n - 1) - s;
  return s;
}

template <typename SrcT>
__global__ void pyr_level_kernel(const SrcT* __restrict__ src, int src_stride,
                                 int src_off, int Hs, int Ws,
                                 float* __restrict__ dst, int Ho, int Wo,
                                 int pad, int down) {
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y * blockDim.y + threadIdx.y;
  const int WP = Wo + 2 * pad, HP = Ho + 2 * pad;
  if (px >= WP || py >= HP) return;
  const int y = reflect101(py - pad, Ho);
  const int x = reflect101(px - pad, Wo);
  int v;
  if (!down) {
    v = (int)src[(size_t)(y + src_off) * src_stride + x + src_off];
  } else {
    const int w[5] = {1, 4, 6, 4, 1};
    int sx[5];
#pragma unroll
    for (int j = 0; j < 5; ++j) sx[j] = fold(2 * x + j - 2, Ws);
    int acc = 0;
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const SrcT* row =
          src + (size_t)(fold(2 * y + i - 2, Hs) + src_off) * src_stride + src_off;
      int r = 0;
#pragma unroll
      for (int j = 0; j < 5; ++j) r += w[j] * (int)row[sx[j]];
      acc += w[i] * r;
    }
    v = (acc + 128) >> 8;
  }
  dst[(size_t)py * WP + px] = (float)v;
}

template <typename SrcT>
int launch_level(const void* src, int src_stride, int src_off, int Hs, int Ws,
                 void* dst, int Ho, int Wo, int pad, int down, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((Wo + 2 * pad + 31) / 32, (Ho + 2 * pad + 7) / 8);
  pyr_level_kernel<SrcT><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const SrcT*)src, src_stride, src_off, Hs, Ws, (float*)dst, Ho, Wo, pad,
      down);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pyr_level_u8(const void* src, int src_stride, int src_off,
                            int Hs, int Ws, void* dst, int Ho, int Wo, int pad,
                            int down, void* stream) {
  return launch_level<uint8_t>(src, src_stride, src_off, Hs, Ws, dst, Ho, Wo,
                               pad, down, stream);
}

extern "C" int pyr_level_f32(const void* src, int src_stride, int src_off,
                             int Hs, int Ws, void* dst, int Ho, int Wo, int pad,
                             int down, void* stream) {
  return launch_level<float>(src, src_stride, src_off, Hs, Ws, dst, Ho, Wo,
                             pad, down, stream);
}
