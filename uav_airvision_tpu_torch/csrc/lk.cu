// K1: OpenCV-semantics pyramidal Lucas-Kanade, one thread block per point.
//
// Replaces uav_airvision_tpu/ops/lk.py::pyramidal_lk_banded (with
// _iterate_level :145, _patches_from_raw :87, _bilinear_axis_weights :134
// and ops/extract.py::block_of :164).  The JAX package pre-tiles every level
// into 48x48 bands and samples with one-hot matmuls because TPU gathers are
// slow; on the card a block simply reads its window taps through L1.  The
// band layout disappears, but the search-window FREEZE bounds it implied are
// part of the result and are reproduced exactly:
//   des = clip(floor(corner0) - 8, 0, HP - 32), o = 16 * min(des / 16, nbr - 1)
//   with nbr = max(1, ceil((HP - 48) / 16) + 1), ub = min(32, HP - 16 - o);
//   the sample corner is clamped to [o, o + ub] and a Gauss-Newton step is
//   taken only while the new corner stays inside it.
//
// Per level (coarse to fine, all inside the block):
//   template: the 18x18 raw window at clip(floor(c) - 1, 0, HP - 18) of the
//     PREVIOUS level, bilinear-shifted to 17x17, Scharr/32 on it, gradients
//     zeroed outside [17, HP-18] x [17, WP-18]; G = [a11 a12; a12 a22],
//     good = valid & corner in image & det > 1e-12; at level 0 also the
//     min-eigenvalue status;
//   iterations: J re-sampled bilinearly from the CURRENT level, b = <grad,J>
//     - <grad,I>, the OpenCV delta, flip-flop halving, eps convergence.
//     A converged point is frozen for good, so the block exits early.
// Thread t < 225 owns window pixel (t / 15, t % 15); the sums over the
// window are block reductions.  Sums run in another order than the JAX
// package's matmuls, so positions agree to rounding, not bit for bit.
//
// Bound on the card: latency.  Each point is one block of 256 threads and
// each Gauss-Newton step is one dependent round of loads + a reduction; a
// frame launches ~104-204 blocks, under two waves of the 132 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPad = 17;
constexpr int kWin = 15;
constexpr int kN = kWin + 3;       // raw template side
constexpr int kT = kWin + 2;       // shifted template side
constexpr int kNeed = kWin + 1 + 16;  // search span (LK_MARGIN = 8)
constexpr int kStride = 16;
constexpr int kBw = 48;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Level {
  const float* img;
  int H, W, HP, WP;
};

__device__ Level level_of(const float* base, int H0, int W0, int L) {
  int H = H0, W = W0;
  size_t off = 0;
  for (int l = 0; l < L; ++l) {
    off += (size_t)(H + 2 * kPad) * (W + 2 * kPad);
    H = (H + 1) / 2;
    W = (W + 1) / 2;
  }
  return Level{base + off, H, W, H + 2 * kPad, W + 2 * kPad};
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ceil(a / b) for b > 0 and any sign of a (Python's -(a // -b)).
__device__ __forceinline__ int ceil_div(int a, int b) {
  return a >= 0 ? (a + b - 1) / b : -((-a) / b);
}

// Sum K values over the block; every thread gets the totals.
template <int K>
__device__ void block_sum(float (&v)[K], float* scratch /* kWarps*K */) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float x = v[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    v[k] = x;
  }
  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) scratch[warp * K + k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += scratch[w * K + k];
    v[k] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
lk_kernel(const float* __restrict__ prev_pyr, const float* __restrict__ curr_pyr,
          int H0, int W0, const float* __restrict__ prev_pts,
          const float* __restrict__ init_pts, const uint8_t* __restrict__ valid,
          int n_levels, int max_iter, int max_iter_upper, float eps2,
          float min_eig_thr, float* __restrict__ out_pts,
          uint8_t* __restrict__ out_status) {
  __shared__ float s_raw[kN * kN];
  __shared__ float s_T[kT * kT];
  __shared__ float s_red[kWarps * 5];

  const int f = blockIdx.x;
  const int tid = threadIdx.x;
  const bool owner = tid < kWin * kWin;
  const int pi = owner ? tid / kWin : 0, pj = owner ? tid % kWin : 0;
  const bool is_valid = valid[f] != 0;
  const float half = 0.5f * (kWin - 1);
  const float prev_x = prev_pts[2 * f], prev_y = prev_pts[2 * f + 1];
  float next_x = init_pts[2 * f], next_y = init_pts[2 * f + 1];
  bool status = false;

  for (int L = n_levels - 1; L >= 0; --L) {
    const Level pl = level_of(prev_pyr, H0, W0, L);
    const Level cl = level_of(curr_pyr, H0, W0, L);
    const float scale = 1.0f / (float)(1 << L);

    // ---- template (lk.py:380-433) ----
    const float cx = (prev_x * scale - half) + (float)kPad;
    const float cy = (prev_y * scale - half) + (float)kPad;
    const float fcx = floorf(cx), fcy = floorf(cy);
    const int ry0 = clampi((int)fcy - 1, 0, pl.HP - kN);
    const int rx0 = clampi((int)fcx - 1, 0, pl.WP - kN);
    for (int k = tid; k < kN * kN; k += kThreads)
      s_raw[k] = pl.img[(size_t)(ry0 + k / kN) * pl.WP + rx0 + k % kN];
    __syncthreads();
    const float ax = cx - fcx, ay = cy - fcy;
    const float w00 = (1.f - ax) * (1.f - ay), w01 = ax * (1.f - ay);
    const float w10 = (1.f - ax) * ay, w11 = ax * ay;
    for (int k = tid; k < kT * kT; k += kThreads) {
      const int r = k / kT, c = k % kT;
      s_T[k] = w00 * s_raw[r * kN + c] + w01 * s_raw[r * kN + c + 1] +
               w10 * s_raw[(r + 1) * kN + c] + w11 * s_raw[(r + 1) * kN + c + 1];
    }
    __syncthreads();
    float gI = 0.f, gx = 0.f, gy = 0.f;
    if (owner) {
      const float sm0 = 3.f / 32.f, sm1 = 10.f / 32.f, sm2 = 3.f / 32.f;
      gI = s_T[(pi + 1) * kT + pj + 1];
      float v[3], w[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float t0 = s_T[pi * kT + pj + c], t1 = s_T[(pi + 1) * kT + pj + c],
                    t2 = s_T[(pi + 2) * kT + pj + c];
        v[c] = sm0 * t0 + sm1 * t1 + sm2 * t2;
        w[c] = (-1.f * t0 + 0.f * t1) + 1.f * t2;
      }
      gx = (-1.f * v[0] + 0.f * v[1]) + 1.f * v[2];
      gy = sm0 * w[0] + sm1 * w[1] + sm2 * w[2];
      const float ys = cy + (float)pi, xs = cx + (float)pj;
      const bool inside = ys >= (float)kPad && ys <= (float)(pl.HP - 1 - kPad) &&
                          xs >= (float)kPad && xs <= (float)(pl.WP - 1 - kPad);
      if (!inside) {
        gx = 0.f;
        gy = 0.f;
      }
    }
    float sums[5] = {gx * gx, gx * gy, gy * gy, gI * gx, gI * gy};
    block_sum<5>(sums, s_red);
    const float a11 = sums[0], a12 = sums[1], a22 = sums[2];
    const float bt1 = sums[3], bt2 = sums[4];
    const float det = a11 * a22 - a12 * a12;
    const float inv_det = det > 1e-12f ? 1.f / det : 0.f;
    const float ipx = fcx - (float)kPad, ipy = fcy - (float)kPad;
    const bool in_prev = ipx >= (float)(-kWin) && ipx < (float)pl.W &&
                         ipy >= (float)(-kWin) && ipy < (float)pl.H;
    const bool good = is_valid && in_prev && det > 1e-12f;
    if (L == 0) {
      const float d = a11 - a22;
      const float min_eig =
          (a22 + a11 - sqrtf(d * d + 4.f * a12 * a12)) / (2.f * kWin * kWin);
      status = is_valid && in_prev && min_eig >= min_eig_thr && det > 1e-12f;
    }

    // ---- search window (lk.py:188-219, extract.py:164-173) ----
    float px = next_x * scale, py = next_y * scale;
    const float c0x = (px - half) + (float)kPad, c0y = (py - half) + (float)kPad;
    const int des_y = clampi((int)floorf(c0y) - 8, 0, cl.HP - kNeed);
    const int des_x = clampi((int)floorf(c0x) - 8, 0, cl.WP - kNeed);
    const int nbr = max(1, ceil_div(cl.HP - kBw, kStride) + 1);
    const int nbc = max(1, ceil_div(cl.WP - kBw, kStride) + 1);
    const int oy = kStride * min(des_y / kStride, nbr - 1);
    const int ox = kStride * min(des_x / kStride, nbc - 1);
    const float uby = (float)min(kBw - (kWin + 1), cl.HP - (kWin + 1) - oy);
    const float ubx = (float)min(kBw - (kWin + 1), cl.WP - (kWin + 1) - ox);

    // ---- Gauss-Newton (lk.py:248-288) ----
    const int it_max = (L == 0 || max_iter_upper <= 0) ? max_iter : max_iter_upper;
    bool conv = !good;
    float pdx = 0.f, pdy = 0.f;
    for (int it = 0; it < it_max && !conv; ++it) {
      const float sx = fminf(fmaxf(((px - half) + (float)kPad) - (float)ox, 0.f), ubx);
      const float sy = fminf(fmaxf(((py - half) + (float)kPad) - (float)oy, 0.f), uby);
      const float bx = floorf(sx), by = floorf(sy);
      const float fx = sx - bx, fy = sy - by;
      float bj[2] = {0.f, 0.f};
      if (owner) {
        const int r0 = oy + (int)by + pi, c0 = ox + (int)bx + pj;
        const float* row0 = cl.img + (size_t)r0 * cl.WP + c0;
        const float* row1 = row0 + cl.WP;
        const float t0 = (1.f - fy) * row0[0] + fy * row1[0];
        const float t1 = (1.f - fy) * row0[1] + fy * row1[1];
        const float J = t0 * (1.f - fx) + t1 * fx;
        bj[0] = J * gx;
        bj[1] = J * gy;
      }
      block_sum<2>(bj, s_red);
      const float b1 = bj[0] - bt1, b2 = bj[1] - bt2;
      const float dx = (a12 * b2 - a22 * b1) * inv_det;
      const float dy = (a12 * b1 - a11 * b2) * inv_det;
      const float nx = px + dx, ny = py + dy;
      const bool inb = floorf(nx - half) >= (float)(-kWin) &&
                       floorf(nx - half) < (float)cl.W &&
                       floorf(ny - half) >= (float)(-kWin) &&
                       floorf(ny - half) < (float)cl.H;
      const float ncx = (nx - half) + (float)kPad, ncy = (ny - half) + (float)kPad;
      const bool in_win = ncx - (float)ox >= 0.f && ncx - (float)ox <= ubx &&
                          ncy - (float)oy >= 0.f && ncy - (float)oy <= uby;
      const bool step = in_win;  // conv is false and good holds inside the loop
      if (step) {
        px = nx;
        py = ny;
      }
      const bool small = dx * dx + dy * dy <= eps2;
      const bool flip = it > 0 && fabsf(dx + pdx) < 0.01f && fabsf(dy + pdy) < 0.01f;
      if (step && flip) {
        px = px - dx * 0.5f;
        py = py - dy * 0.5f;
      }
      conv = small || flip || !inb || !in_win;
      pdx = dx;
      pdy = dy;
    }
    next_x = px * (float)(1 << L);
    next_y = py * (float)(1 << L);
    __syncthreads();  // s_raw / s_T are rewritten by the next level
  }

  if (tid == 0) {
    const float half0 = 0.5f * (kWin - 1);
    const bool inb = floorf(next_x - half0) >= (float)(-kWin) &&
                     floorf(next_x - half0) < (float)W0 &&
                     floorf(next_y - half0) >= (float)(-kWin) &&
                     floorf(next_y - half0) < (float)H0;
    out_pts[2 * f] = next_x;
    out_pts[2 * f + 1] = next_y;
    out_status[f] = status && inb;
  }
}

}  // namespace

extern "C" int pyramidal_lk(const void* prev_pyr, const void* curr_pyr, int H0,
                            int W0, const void* prev_pts, const void* init_pts,
                            const void* valid, int F, int n_levels, int max_iter,
                            int max_iter_upper, float eps2, float min_eig,
                            void* out_pts, void* out_status, void* stream) {
  if (F == 0) return 0;
  lk_kernel<<<F, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)prev_pyr, (const float*)curr_pyr, H0, W0,
      (const float*)prev_pts, (const float*)init_pts, (const uint8_t*)valid,
      n_levels, max_iter, max_iter_upper, eps2, min_eig, (float*)out_pts,
      (uint8_t*)out_status);
  return (int)cudaGetLastError();
}
