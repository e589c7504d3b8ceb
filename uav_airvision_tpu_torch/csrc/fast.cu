// K4 + K6: FAST-9/16 with the OpenCV score, the 7x7 detection mask built
// in-kernel from the tracked-point list, and the strict 3x3 non-max
// suppression, in one launch.
//
// Replaces uav_airvision_tpu/ops/fast.py::detect_fast (fast_score_map :37,
// nonmax_3x3 :90) and models/frontend/pipeline.py::_detection_mask :145.
// The JAX package builds 16 shifted bf16 planes, a log-depth sliding-min
// tree and a (H,F)@(F,W) mask matmul; here one block owns a 32x16 output
// tile:
//   1. it stages the uint8 image over the tile plus a 4-px halo in shared
//      memory (3 px for the ring, 1 px for the NMS): 16-byte loads where the
//      rows are 16-byte aligned (752 B rows are), byte loads otherwise;
//   2. each thread takes its share of the mask points and ORs the 7x7 box of
//      every one that meets the tile plus its 1-px ring into a shared bit
//      mask, one 64-bit row mask per row (points with floor(x) < 3 or
//      floor(y) < 3, and invalid points, mask nothing: the reference's
//      numpy negative-slice quirk); any number of points runs;
//   3. it scores the tile plus the 1-px ring into shared memory: first the
//      candidates (inside the 3-px border, not under the mask, and past the
//      quick rejection below) go into a list by warp ballots, then each
//      thread takes a candidate: the 16 ring differences; bright/dark = max
//      over the 16 arc starts of the min over 9 consecutive differences (a
//      log-depth sliding min on d and -d packed in the two 16-bit halves
//      of a word, exact in integers); corner = bright > thr | dark > thr;
//      score = max(bright, dark) - 1; 0 where no corner, in the border,
//      outside the image and under the mask (the mask applies BEFORE the
//      NMS, as fast.py:107-110 does);
//   4. the strict 3x3 NMS from shared memory: keep = score > 0 & score > all
//      8 neighbours (zero outside the image); keep and score go out once.
// Integer arithmetic throughout, so the result is exact.
//
// Instances: gridDim.z = B images of one shape, back to back; block z reads
// image z, its mask points (pts and pts_valid of B x n_pts) and writes
// keep and score of image z.  B = 1 is the single-image launch.
//
// The quick rejection: a 9-long arc of the 16-ring covers 9 consecutive
// positions, and any 8 consecutive positions
// of the ring hold exactly two of the compass positions 0, 4, 8, 12 (they
// are 4 apart).  A bright corner needs all 9 differences of some arc above
// thr, so at least two compass differences above thr; a dark one likewise
// below -thr.  A pixel with fewer than two compass differences above thr
// and fewer than two below -thr therefore has bright <= thr and dark <= thr:
// no corner, score 0, which is what the full test gives it, and stays off
// the candidate list.  (Listing every pixel inside the border, with no
// rejection, measured slower on the card.)
//
// Bound on the card: bytes (the image in, keep and score out: 2.2 MB at
// 752x480, 0.65 us).  Without the candidate list the arc test of every
// pixel of the region (~200 operations each) made the kernel issue-bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 32, TH = 16;       // output tile
constexpr int kThreads = 256;
constexpr int RW = TW + 2, RH = TH + 2;  // scored region: the tile + 1-px ring
constexpr int SW = 64, SH = TH + 8;      // staged image: 16 + TW + 16 columns
constexpr int SX = 16;                   // staged column of the tile's x0

// bright = max over the 16 arc starts s of min(d[s], ..., d[s + 8]) and
// dark = the same of -d (indices mod 16), both at once: d and -d ride in
// the two signed 16-bit halves of a word (|d| <= 255)
__device__ inline void best_arcs(const int d[16], int& bright, int& dark) {
  unsigned v[16], m2[16], m4[16], m8[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) v[k] = ((unsigned)d[k] & 0xffffu) | ((unsigned)(-d[k]) << 16);
#pragma unroll
  for (int k = 0; k < 16; ++k) m2[k] = __vmins2(v[k], v[(k + 1) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) m4[k] = __vmins2(m2[k], m2[(k + 2) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) m8[k] = __vmins2(m4[k], m4[(k + 4) & 15]);
  unsigned best = __vmins2(m8[0], v[8]);
#pragma unroll
  for (int k = 1; k < 16; ++k) best = __vmaxs2(best, __vmins2(m8[k], v[(k + 8) & 15]));
  bright = (int)(short)(best & 0xffffu);
  dark = (int)(short)(best >> 16);
}

__global__ void __launch_bounds__(kThreads)
fast_tile_kernel(const uint8_t* __restrict__ img, int H, int W, int thr, bool vec,
                 const float* __restrict__ pts, const uint8_t* __restrict__ pvalid, int n_pts,
                 uint8_t* __restrict__ keep_out, int* __restrict__ score_out,
                 long long* __restrict__ clocks) {
  __shared__ __align__(16) uint8_t s_img[SH][SW];
  __shared__ int s_score[RH][RW];
  __shared__ unsigned long long s_mask[RH];
  __shared__ short s_cand[RH * RW];  // the region's candidates, by index
  __shared__ int s_ncand;
  const int tid = threadIdx.x, lane = tid & 31;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const bool timed = clocks != nullptr && blockIdx.x == gridDim.x / 2 &&
                     blockIdx.y == gridDim.y / 2 && blockIdx.z == 0 && tid == 0;
  {  // instance blockIdx.z: its image, mask points and outputs
    const size_t z = blockIdx.z;
    img += z * H * W;
    pts += z * 2 * n_pts;
    pvalid += z * n_pts;
    keep_out += z * H * W;
    score_out += z * H * W;
  }
  if (timed) clocks[0] = clock64();
  // the first mask point of each thread, fetched with the image
  float px = 0.f, py = 0.f;
  bool pv = false;
  if (tid < n_pts) {
    pv = pvalid[tid];
    px = pts[2 * tid];
    py = pts[2 * tid + 1];
  }

  // 1. the image over rows y0-4 .. y0+TH+3, columns x0-16 .. x0+TW+15
  if (tid < RH) s_mask[tid] = 0ull;
  if (tid == 0) s_ncand = 0;
  if (vec) {  // W and the image address are multiples of 16: whole 16-byte chunks
    for (int e = tid; e < SH * (SW / 16); e += kThreads) {
      const int sy = e / (SW / 16), cx = e % (SW / 16);
      const int y = y0 - 4 + sy, x = x0 - SX + 16 * cx;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (y >= 0 && y < H && x >= 0 && x < W)
        v = *reinterpret_cast<const uint4*>(img + (size_t)y * W + x);
      *reinterpret_cast<uint4*>(&s_img[sy][16 * cx]) = v;
    }
  } else {
    for (int e = tid; e < SH * (TW + 8); e += kThreads) {
      const int sy = e / (TW + 8), sx = e % (TW + 8) + SX - 4;
      const int y = y0 - 4 + sy, x = x0 - SX + sx;
      s_img[sy][sx] = (y >= 0 && y < H && x >= 0 && x < W) ? img[(size_t)y * W + x] : 0;
    }
  }
  __syncthreads();  // s_mask and s_ncand zeroed
  if (timed) clocks[1] = clock64();

  // 2. the mask: each point's 7x7 box, where it meets the scored region
  //    (rows y0-1 .. y0+TH, columns x0-1 .. x0+TW), as row bit masks
  for (int k = tid; k < n_pts; k += kThreads) {
    if (k != tid) {
      pv = pvalid[k];
      px = pts[2 * k];
      py = pts[2 * k + 1];
    }
    if (!pv) continue;
    const int ix = (int)floorf(px), iy = (int)floorf(py);
    if (ix < 3 || iy < 3) continue;
    if (ix < x0 - 4 || ix > x0 + TW + 3 || iy < y0 - 4 || iy > y0 + TH + 3) continue;
    const int c0 = max(ix - 3 - (x0 - 1), 0), c1 = min(ix + 3 - (x0 - 1), RW - 1);
    const int r0 = max(iy - 3 - (y0 - 1), 0), r1 = min(iy + 3 - (y0 - 1), RH - 1);
    const unsigned long long bits = (2ull << c1) - (1ull << c0);
    for (int r = r0; r <= r1; ++r) atomicOr(&s_mask[r], bits);
  }
  __syncthreads();
  if (timed) clocks[2] = clock64();

  // 3. score and corner over the region, zeroed under the mask: first the
  //    candidates (interior, unmasked and past the compass test) into a
  //    list, then the arc test on the list, so that every lane of a warp
  //    scores a candidate
  for (int e0 = 0; e0 < RH * RW; e0 += kThreads) {
    const int e = e0 + tid, ry = e / RW, rx = e % RW;
    const int y = y0 - 1 + ry, x = x0 - 1 + rx;
    bool cand = e < RH * RW && y >= 3 && y < H - 3 && x >= 3 && x < W - 3 &&
                !((s_mask[ry] >> rx) & 1ull);
    if (cand) {
      const int sy = ry + 3, sx = rx + SX - 1, c = s_img[sy][sx];
      const int d0 = s_img[sy - 3][sx] - c, d4 = s_img[sy][sx + 3] - c;
      const int d8 = s_img[sy + 3][sx] - c, d12 = s_img[sy][sx - 3] - c;
      const int nb = (d0 > thr) + (d4 > thr) + (d8 > thr) + (d12 > thr);
      const int nd = (d0 < -thr) + (d4 < -thr) + (d8 < -thr) + (d12 < -thr);
      cand = nb >= 2 || nd >= 2;
    }
    if (e < RH * RW) s_score[ry][rx] = 0;
    const unsigned bal = __ballot_sync(0xffffffffu, cand);
    int at = 0;
    if (lane == 0 && bal != 0u) at = atomicAdd(&s_ncand, __popc(bal));
    at = __shfl_sync(0xffffffffu, at, 0);
    if (cand) s_cand[at + __popc(bal & ((1u << lane) - 1u))] = (short)e;
  }
  __syncthreads();
  if (timed) clocks[3] = clock64();
  const int ncand = s_ncand;
  for (int i = tid; i < ncand; i += kThreads) {
    const int e = s_cand[i], ry = e / RW, rx = e % RW;
    const int sy = ry + 3, sx = rx + SX - 1;
    const int c = s_img[sy][sx];
    // the Bresenham circle of radius 3 in ring order, (dy, dx)
    const int d[16] = {
        s_img[sy - 3][sx] - c,     s_img[sy - 3][sx + 1] - c, s_img[sy - 2][sx + 2] - c,
        s_img[sy - 1][sx + 3] - c, s_img[sy][sx + 3] - c,     s_img[sy + 1][sx + 3] - c,
        s_img[sy + 2][sx + 2] - c, s_img[sy + 3][sx + 1] - c, s_img[sy + 3][sx] - c,
        s_img[sy + 3][sx - 1] - c, s_img[sy + 2][sx - 2] - c, s_img[sy + 1][sx - 3] - c,
        s_img[sy][sx - 3] - c,     s_img[sy - 1][sx - 3] - c, s_img[sy - 2][sx - 2] - c,
        s_img[sy - 3][sx - 1] - c};
    int bright, dark;
    best_arcs(d, bright, dark);
    if (bright > thr || dark > thr) s_score[ry][rx] = max(bright, dark) - 1;
  }
  __syncthreads();
  if (timed) clocks[4] = clock64();

  // 4. the strict 3x3 NMS; the score map is zero outside the image
  for (int e = tid; e < TH * TW; e += kThreads) {
    const int ty = e / TW, tx = e % TW;
    const int y = y0 + ty, x = x0 + tx;
    if (y >= H || x >= W) continue;
    const int s = s_score[ty + 1][tx + 1];
    bool keep = s > 0;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        if (dy != 1 || dx != 1) keep = keep && s > s_score[ty + dy][tx + dx];
    keep_out[(size_t)y * W + x] = keep;
    score_out[(size_t)y * W + x] = keep ? s : 0;
  }
  if (timed) clocks[5] = clock64();
}

}  // namespace

// img (B, H, W), pts (B, n_pts, 2), pts_valid (B, n_pts), keep_out and
// score_out (B, H, W).  clocks (6 int64, or null): the SM clock of the
// middle block of image 0 at its start and at the end of each phase
// (staging, mask, candidates, scores, NMS).
extern "C" int fast_detect_masked(const void* img, int B, int H, int W, int thr, const void* pts,
                                  const void* pts_valid, int n_pts, void* keep_out,
                                  void* score_out, void* clocks, void* stream) {
  if (n_pts < 0 || H < 0 || W < 0 || B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  if (H == 0 || W == 0) return 0;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  const bool vec = W % 16 == 0 && (uintptr_t)img % 16 == 0;  // then every image is aligned
  fast_tile_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)img, H, W, thr, vec, (const float*)pts, (const uint8_t*)pts_valid, n_pts,
      (uint8_t*)keep_out, (int*)score_out, (long long*)clocks);
  return (int)cudaGetLastError();
}
