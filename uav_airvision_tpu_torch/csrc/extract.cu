// P1: per-window extract, F windows of n x n at per-window integer origins.
//
// Replaces scripts/exp_gather.py::pallas_extract (the Pallas kernel
// ``_kernel``: one DMA per window from HBM into VMEM, 8 windows per grid
// step).  The JAX package computes the same function inside LK when
// frontend.lk_compact_windows is set (ops/lk.py::_iterate_level, the exact
// 32-px search span by ``_shift_extract``); the port's compact-window LK
// fetches each level's search windows with this kernel.
//
//   out[f, i, j] = img[oy[f] + i, ox[f] + j],  0 <= i, j < n,
//   with the origins clamped to [0, HP - n] x [0, WP - n] (the compact LK
//   passes des = clip(floor(corner0) - 8, 0, HP - 32), already in range).
//
// One block per window, a warp per row at a time: neighbouring threads read
// neighbouring pixels of a row (n = 32: one 128-byte row per warp) and write
// the window contiguously.  A pure copy, exact.
//
// Bound on the card: bytes (n^2 floats read and written per window, ~8 KB
// at n = 32), far below one wave of the card's bandwidth at F ~ 200; in
// practice the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
extract_kernel(const float* __restrict__ img, int HP, int WP,
               const int32_t* __restrict__ oy, const int32_t* __restrict__ ox,
               int o_stride, int n, float* __restrict__ out) {
  const int f = blockIdx.x;
  const int y0 = min(max(oy[(size_t)f * o_stride], 0), HP - n);
  const int x0 = min(max(ox[(size_t)f * o_stride], 0), WP - n);
  const float* src = img + (size_t)y0 * WP + x0;
  float* dst = out + (size_t)f * n * n;
  for (int k = threadIdx.x; k < n * n; k += kThreads) {
    const int i = k / n, j = k - i * n;
    dst[k] = src[(size_t)i * WP + j];
  }
}

}  // namespace

extern "C" int extract_windows(const void* img, int HP, int WP, const void* oy,
                               const void* ox, int o_stride, int F, int n, void* out,
                               void* stream) {
  if (F == 0) return 0;
  extract_kernel<<<F, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)img, HP, WP, (const int32_t*)oy, (const int32_t*)ox, o_stride, n,
      (float*)out);
  return (int)cudaGetLastError();
}
