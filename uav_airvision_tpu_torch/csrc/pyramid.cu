// K2: the padded image pyramids of one or two cameras in one launch (cv2
// pyrDown semantics + REFLECT_101 pad).
//
// Replaces uav_airvision_tpu/ops/pyramid.py::build_pyramid_padded
// (pyr_down :66, build_pyramid :85-98, :115): the JAX package decimates
// with two banded matmuls on the MXU and rounds floor(k/256 + 0.5); here
// the arithmetic is integer and exact:
//   * level L+1 at (y, x) = (k + 128) >> 8 with k the 5x5 sum of
//     [1 4 6 4 1] x [1 4 6 4 1] over level L, source rows and columns
//     2y-2 .. 2y+2 mapped by the decimation matrix's one reflection (fold);
//   * every level is written padded by LK_PAD, the padded coordinate mapped
//     to the unpadded one by REFLECT_101 (the triangle wave of
//     jnp.pad(mode="reflect"), valid for any pad width), as float32, which
//     holds the integers exactly;
//   * level shapes ceil(n/2).
//
// Layout, in one launch: per camera one thread-block cluster of 8 band
// blocks (the portable cluster size) for levels 1 and up, and 24 blocks
// that write the padded level 0 (70% of the bytes written) straight from
// the image, a run of rows each, so that the largest write is spread over
// more SMs than the 8 that build the pyramid.  The coarsest level's rows
// are cut into 8 bands (fewer when it has fewer rows); a band block owns
// the same band at every level (2^(n-1-L) times as many rows at level L:
// 60, 30, 15 and 7-8 rows at 480x752).  Its band of the uint8 image, with
// the two rows above and the one below that the 5-tap fold reaches, is
// staged in shared memory by ONE bulk asynchronous copy (cp.async.bulk,
// completion on an mbarrier): a run of full rows is one contiguous range,
// 16-byte aligned and sized when the width is a multiple of 16 (752 px:
// 47 KB).  Otherwise, as at odd widths, the block copies the range with
// byte loads.  Each next level is computed into shared memory as uint8 (a
// rounded level never exceeds 255), one warp per output row; the rows
// above and below the band that the next level reads come from the
// neighbouring blocks' shared memory (distributed shared memory,
// cluster.map_shared_rank) after one cluster.sync() per level.  Each band
// block writes every padded row of levels 1 and up whose REFLECT_101
// source row lies in its band, once.  No level is read back from device
// memory.
//
// Past what a block's shared memory holds (the band buffers grow with the
// image: at 4 levels 1440x1080 needs 268,208 B, 2048x1536 more than
// 500 KB), the same entry builds the levels in passes instead: one launch
// writes level 0 of both cameras from the images, then one launch a level
// computes it from the previous padded level in device memory (L2), a
// thread per padded pixel, with the same integer arithmetic, so the result
// is the same bit for bit.  752x480 and every size up to 1280x1024 at 4
// levels take the one cluster launch.
//
// Bound on the card: bytes.  At 480x752 one camera reads 0.36 MB and
// writes four padded float32 levels of 562,564 px in all, 2.25 MB (0.78 us
// at 3.35 TB/s; 1.56 us for the pair).  At this size the launch and the
// wrapper's host time dominate; on the device the band blocks' chain of
// levels (three cluster barriers) is the critical path.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "msckf_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBands = 8;   // band blocks per camera: one cluster
constexpr int kCopy = 24;   // level-0 blocks per camera: three clusters
constexpr int kThreads = 1024;
constexpr int kMaxLevels = 8;

__device__ __forceinline__ int reflect101(int i, int n) {
  if (i >= 0 && i < n) return i;
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

// Shapes, bands and offsets, the same on the host and in every block.
struct Plan {
  int n;                       // levels
  int h[kMaxLevels], w[kMaxLevels];
  int nb;                      // bands with rows (<= kBands)
  int cb;                      // most rows of a band at the coarsest level
  unsigned buf[kMaxLevels];    // byte offset of level L's band buffer in shared memory
  long long out[kMaxLevels];   // float offset of padded level L in one pyramid
  long long size;              // floats of one padded pyramid
  unsigned smem;               // bytes of shared memory
};

__host__ __device__ Plan make_plan(int H, int W, int n, int pad) {
  Plan p;
  p.n = n;
  p.h[0] = H;
  p.w[0] = W;
  for (int L = 1; L < n; ++L) {
    p.h[L] = (p.h[L - 1] + 1) / 2;
    p.w[L] = (p.w[L - 1] + 1) / 2;
  }
  const int Hc = p.h[n - 1];
  p.nb = Hc < kBands ? Hc : kBands;
  p.cb = (Hc + p.nb - 1) / p.nb;
  unsigned off = 0;
  long long o = 0;
  for (int L = 0; L < n; ++L) {
    // the band's rows and the two above and one below it: row g of the
    // image at level L is buffer row g - (a - 2)
    const unsigned rows = (unsigned)(p.cb << (n - 1 - L)) + 3u;
    p.buf[L] = off;
    off += (rows * (unsigned)p.w[L] + 15u) & ~15u;
    p.out[L] = o;
    o += (long long)(p.h[L] + 2 * pad) * (p.w[L] + 2 * pad);
  }
  p.size = o;
  p.smem = off;
  return p;
}

// Band b's rows [a, e) at level L: the coarsest level's band scaled up.
__device__ void band(const Plan& p, int b, int L, int* a, int* e) {
  const int Hc = p.h[p.n - 1], s = p.n - 1 - L;
  *a = min(p.h[L], (b * Hc / p.nb) << s);
  *e = b + 1 < p.nb ? min(p.h[L], ((b + 1) * Hc / p.nb) << s) : p.h[L];
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// Copy bytes from the image into shared memory: one bulk asynchronous copy
// when both ends are 16-byte aligned and the size a multiple of 16, byte
// loads otherwise.
__device__ void stage(uint8_t* dst, const uint8_t* src, unsigned bytes, uint64_t* mbar) {
  const bool bulk = bytes > 0 && (uintptr_t)src % 16 == 0 && (uintptr_t)dst % 16 == 0 &&
                    bytes % 16 == 0;
  if (bulk) {
    const uint32_t bar = smem_addr(mbar);
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                   "r"(bytes)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(smem_addr(dst)),
          "l"(src), "r"(bytes), "r"(bar)
          : "memory");
    }
    __syncthreads();  // the barrier is initialised before anyone waits on it
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar)
          : "memory");
    }
  } else {
    for (unsigned i = threadIdx.x; i < bytes; i += kThreads) dst[i] = src[i];
  }
  __syncthreads();
}

// Level L's band from level L-1's buffer (band and halo rows), in shared
// memory: one warp per output row, its five source rows found once; the
// columns away from the border need no fold.
__device__ void down(const Plan& p, int L, int rank, unsigned char* smem) {
  int a, e, as, es;
  band(p, rank, L, &a, &e);
  band(p, rank, L - 1, &as, &es);
  const int hs = p.h[L - 1], ws = p.w[L - 1], w = p.w[L];
  const uint8_t* src = smem + p.buf[L - 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kw[5] = {1, 4, 6, 4, 1};
  for (int y = a + warp; y < e; y += kThreads / 32) {
    const uint8_t* rows[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) rows[k] = src + (fold(2 * y + k - 2, hs) - (as - 2)) * ws;
    uint8_t* out = smem + p.buf[L] + (y - a + 2) * w;
    for (int x = lane; x < w; x += 32) {
      int acc = 0;
      if (x >= 1 && 2 * x + 2 < ws) {
#pragma unroll
        for (int k = 0; k < 5; ++k) {
          const uint8_t* r = rows[k] + 2 * x - 2;
          acc += kw[k] * (r[0] + 4 * r[1] + 6 * r[2] + 4 * r[3] + r[4]);
        }
      } else {
        int sx[5];
#pragma unroll
        for (int j = 0; j < 5; ++j) sx[j] = fold(2 * x + j - 2, ws);
#pragma unroll
        for (int k = 0; k < 5; ++k) {
          int s = 0;
#pragma unroll
          for (int j = 0; j < 5; ++j) s += kw[j] * (int)rows[k][sx[j]];
          acc += kw[k] * s;
        }
      }
      out[x] = (uint8_t)((acc + 128) >> 8);
    }
  }
}

// The rows of level L next to the band, from the neighbouring blocks:
// a-2 and a-1 from the band above, e from the band below.
__device__ void fetch_halo(const Plan& p, int L, int rank, unsigned char* smem,
                           cg::cluster_group& cluster) {
  int a, e;
  band(p, rank, L, &a, &e);
  const int w = p.w[L];
  uint8_t* buf = smem + p.buf[L];
  if (a > 0) {
    int a_up, e_up;
    band(p, rank - 1, L, &a_up, &e_up);
    const uint8_t* up = cluster.map_shared_rank(buf, rank - 1) + (a - a_up) * w;
    for (int i = threadIdx.x; i < 2 * w; i += kThreads) buf[i] = up[i];
  }
  if (e < p.h[L]) {
    const uint8_t* below = cluster.map_shared_rank(buf, rank + 1) + 2 * w;
    for (int i = threadIdx.x; i < w; i += kThreads) buf[(e - a + 2) * w + i] = below[i];
  }
}

// Every padded row of level L whose source row lies in the band, one warp
// per row.
__device__ void write_padded(const Plan& p, int L, int rank, int pad, const unsigned char* smem,
                             float* dst) {
  int a, e;
  band(p, rank, L, &a, &e);
  const int h = p.h[L], w = p.w[L], HP = h + 2 * pad, WP = w + 2 * pad;
  const uint8_t* buf = smem + p.buf[L];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int py = warp; py < HP; py += kThreads / 32) {
    const int y = reflect101(py - pad, h);
    if (y < a || y >= e) continue;
    const uint8_t* row = buf + (y - a + 2) * w;
    float* out = dst + (long long)py * WP;
    for (int px = lane; px < WP; px += 32) out[px] = (float)row[reflect101(px - pad, w)];
  }
}

// Padded level-0 rows [r0, r1) straight from the image in global memory,
// one warp per row, eight loads of a lane in flight before its stores.
__device__ void copy_level0(const uint8_t* img, int H, int W, int pad, int r0, int r1,
                            float* dst) {
  const int WP = W + 2 * pad;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int py = r0 + warp; py < r1; py += kThreads / 32) {
    const uint8_t* row = img + (size_t)reflect101(py - pad, H) * W;
    float* out = dst + (long long)py * WP;
    for (int px0 = lane; px0 < WP; px0 += 8 * 32) {
      uint8_t v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int px = px0 + 32 * u;
        v[u] = px < WP ? row[reflect101(px - pad, W)] : 0;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (px0 + 32 * u < WP) out[px0 + 32 * u] = (float)v[u];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
pyramid_kernel(const uint8_t* __restrict__ img0, const uint8_t* __restrict__ img1, int n_cam,
               int H, int W, int n, int pad, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t mbar;
  __shared__ Plan plan;
  if (threadIdx.x == 0) plan = make_plan(H, W, n, pad);
  __syncthreads();
  const Plan& p = plan;
  const int bands = n_cam * kBands;
  if ((int)blockIdx.x >= bands) {  // a level-0 block: a run of padded rows, no cluster work
    const int k = (int)blockIdx.x - bands, cam = k / kCopy, part = k % kCopy;
    const int HP = H + 2 * pad;
    copy_level0(cam ? img1 : img0, H, W, pad, part * HP / kCopy, (part + 1) * HP / kCopy,
                out + cam * p.size);
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cam = (int)blockIdx.x / kBands;
  float* pyr = out + cam * p.size;
  const bool active = rank < p.nb && n > 1;  // uniform over the block

  if (active) {  // level 0: the band and its halo rows [a-2, e] from the image
    int a, e;
    band(p, rank, 0, &a, &e);
    const int lo = max(0, a - 2), hi = min(H, e + 1);
    stage(smem + p.buf[0] + (lo - (a - 2)) * W, (cam ? img1 : img0) + (size_t)lo * W,
          (unsigned)((hi - lo) * W), &mbar);
  }
  for (int L = 1; L < n; ++L) {
    if (L >= 2) {  // level L-1 is complete in every block of the cluster
      cluster.sync();
      if (active) fetch_halo(p, L - 1, rank, smem, cluster);
      __syncthreads();
    }
    if (active) down(p, L, rank, smem);
    __syncthreads();
    if (active) write_padded(p, L, rank, pad, smem, pyr + p.out[L]);
  }
  cluster.sync();  // no block leaves while a neighbour may still read its shared memory
}

// The level-by-level plan's passes.  Level 0 of camera blockIdx.y, a run of
// padded rows a block, from the image.
__global__ void __launch_bounds__(kThreads)
level0_kernel(const uint8_t* __restrict__ img0, const uint8_t* __restrict__ img1, int H, int W,
              int pad, long long size, float* __restrict__ out) {
  const int cam = blockIdx.y, HP = H + 2 * pad;
  copy_level0(cam ? img1 : img0, H, W, pad, (int)blockIdx.x * HP / (int)gridDim.x,
              ((int)blockIdx.x + 1) * HP / (int)gridDim.x, out + cam * size);
}

// Padded level L of camera blockIdx.y from padded level L-1 (hs x ws
// unpadded) in device memory: a thread per padded pixel, grid-strided.
__global__ void __launch_bounds__(kThreads)
level_kernel(float* __restrict__ out, long long size, long long src_off, int hs, int ws,
             long long dst_off, int h, int w, int pad) {
  const float* src = out + blockIdx.y * size + src_off;
  float* dst = out + blockIdx.y * size + dst_off;
  const int WPs = ws + 2 * pad, WP = w + 2 * pad;
  const long long n = (long long)(h + 2 * pad) * WP;
  const int kw[5] = {1, 4, 6, 4, 1};
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const int y = reflect101((int)(e / WP) - pad, h), x = reflect101((int)(e % WP) - pad, w);
    int acc = 0;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const float* row = src + (long long)(fold(2 * y + k - 2, hs) + pad) * WPs + pad;
      int sum = 0;
#pragma unroll
      for (int j = 0; j < 5; ++j) sum += kw[j] * (int)row[fold(2 * x + j - 2, ws)];
      acc += kw[k] * sum;
    }
    dst[e] = (float)((acc + 128) >> 8);
  }
}

// The passes: level 0, then one launch a level.
int pyramid_passes(const Plan& p, const uint8_t* img0, const uint8_t* img1, int n_cam, int pad,
                   float* out, cudaStream_t stream) {
  level0_kernel<<<dim3(kCopy, n_cam), kThreads, 0, stream>>>(img0, img1, p.h[0], p.w[0], pad,
                                                              p.size, out);
  int err = (int)cudaGetLastError();
  for (int L = 1; L < p.n && err == 0; ++L) {
    level_kernel<<<dim3(64, n_cam), kThreads, 0, stream>>>(out, p.size, p.out[L - 1],
                                                          p.h[L - 1], p.w[L - 1], p.out[L],
                                                          p.h[L], p.w[L], pad);
    err = (int)cudaGetLastError();
  }
  return err;
}

}  // namespace

// img0, img1 (uint8 (H, W), contiguous; img1 unused for one camera),
// n_cam (1 or 2), H, W, n_levels, pad, out (n_cam pyramids back to back),
// stream
extern "C" int pyramid_u8(const void* img0, const void* img1, int n_cam, int H, int W,
                          int n_levels, int pad, void* out, void* stream) {
  static unsigned smem_allowed = 0;
  static size_t budget = 0;
  if (n_levels < 1 || n_levels > kMaxLevels || n_cam < 1 || n_cam > 2)
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(H, W, n_levels, pad);
  if (budget == 0) budget = msckf::smem_budget(pyramid_kernel);
  if (p.smem > budget)
    return pyramid_passes(p, (const uint8_t*)img0, (const uint8_t*)img1, n_cam, pad,
                          (float*)out, (cudaStream_t)stream);
  if (p.smem > 48 * 1024 && p.smem > smem_allowed) {
    const int err = (int)cudaFuncSetAttribute(
        pyramid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != 0) return err;
    smem_allowed = p.smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((kBands + kCopy) * n_cam);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kBands;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int err = (int)cudaLaunchKernelEx(&cfg, pyramid_kernel, (const uint8_t*)img0,
                                          (const uint8_t*)img1, n_cam, H, W, n_levels, pad,
                                          (float*)out);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
