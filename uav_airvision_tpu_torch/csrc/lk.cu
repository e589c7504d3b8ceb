// K1: OpenCV-semantics pyramidal Lucas-Kanade, one thread block per point.
//
// Replaces uav_airvision_tpu/ops/lk.py::pyramidal_lk_banded (with
// _iterate_level :145, _patches_from_raw :87, _bilinear_axis_weights :134
// and ops/extract.py::block_of :164).  The JAX package pre-tiles every level
// into 48x48 bands and samples with one-hot matmuls because TPU gathers are
// slow; on the card a block simply reads its window taps through L1.  The
// band layout disappears, but the search-window FREEZE bounds it implied are
// part of the result and are reproduced exactly:
//   des = clip(floor(corner0) - 8, 0, HP - (side + 17)),
//   o = 16 * min(des / 16, nbr - 1) with nbr = max(1, ceil((HP - 48) / 16) + 1),
//   ub = min(48 - (side + 1), HP - (side + 1) - o) (32 at side 15);
//   the sample corner is clamped to [o, o + ub] and a Gauss-Newton step is
//   taken only while the new corner stays inside it.
//
// Per level (coarse to fine, all inside the block):
//   template: the (side+3)^2 raw window at clip(floor(c) - 1, 0, HP - side - 3)
//     of the PREVIOUS level, bilinear-shifted to (side+2)^2, Scharr/32 on
//     it, gradients zeroed outside [17, HP-18] x [17, WP-18]; G = [a11 a12; a12 a22],
//     good = valid & corner in image & det > 1e-12; at level 0 also the
//     min-eigenvalue status;
//   iterations: J re-sampled bilinearly from the CURRENT level, b = <grad,J>
//     - <grad,I>, the OpenCV delta, flip-flop halving, eps convergence.
//     A converged point is frozen for good, so the block exits early.
// The window side is a template parameter, instantiated for every odd side
// 3 to 31: thread t < side^2 owns window pixel (t / side, t % side) and the
// block has side^2 threads rounded up to a warp (256 at 15).  Any other side
// (even, or past 31) takes the instantiation with a runtime side and 1024
// threads that loop over the pixels.  The template's gradients sit in
// shared memory; the sums over the window are block reductions.  Sums run
// in another order than the JAX package's matmuls, so positions agree to
// rounding, not bit for bit.
//
// Bound on the card: latency.  Each point is one block (256 threads at 15) and
// each Gauss-Newton step is one dependent round of loads + a reduction; a
// frame launches ~104-204 blocks, under two waves of the 132 SMs.
//
// Second entry point, ``pyramidal_lk_level``: ONE level of the same
// tracker for frontend.lk_compact_windows (lk.py:199-218).  There the JAX
// package cuts each level's exact search span (side + 17 px: 32 at 15) at
// des = clip(floor(corner0) - 8, 0, HP - span) out of its band and iterates
// on that window, so the freeze bounds become uniform: origin des and
// ub = min(16, HP - (side + 1) - des).  The caller fetches the windows with
// kernel P1 (csrc/extract.cu) and this entry reads its samples from them;
// it also writes the next finer level's des, so the host computes des once
// per LK call, for the coarsest level.  That route (2 launches a level and
// the host's des) stays as the witness of the third entry.
//
// Third entry point, ``pyramidal_lk_compact``: the whole compact-window
// tracker in ONE launch, a block per point looping over the levels coarse
// to fine as ``pyramidal_lk`` does.  At each level the block computes des
// itself (compact_origin), copies the (side + 17)^2 search window at des
// out of the current level into its shared memory (P1's function, done by
// its consumer: cp.async, 4 bytes a thread, issued before the template and
// waited for before the first Gauss-Newton step, so the copy runs under
// the template's loads and sums), builds the template from the previous
// pyramid and iterates on the staged window with the uniform freeze
// bounds.  Every sample it reads is the float P1 would have copied, and the
// template, the steps and the sums are the level entry's: points, status
// and des equal the witness route's bit for bit.  Not TMA: a padded
// level's row pitch is W / 2^L + 34 floats (786 at level 0, 3,144 bytes,
// not a multiple of 16) and the levels start at arbitrary offsets of
// Pyramid.flat, while a TMA tensor map needs 16-byte strides and base; the
// pyramid's layout is K2's, K1's and the tests' and stays.

#include <cuda_runtime.h>
#include <stdint.h>

#include "msckf_common.cuh"

namespace {

constexpr int kPad = 17;
constexpr int kMargin = 8;  // LK_MARGIN: the search span is side + 1 + 16
constexpr int kStride = 16;
constexpr int kBw = 48;
constexpr int kLoopThreads = 1024;  // the runtime-side instantiation

// The window side: the template's, or the runtime one (kWin = 0).
template <int kWin>
__device__ __forceinline__ int side(int win) {
  return kWin > 0 ? kWin : win;
}


// Floats of dynamic shared memory: the raw and shifted templates, the two
// gradient windows, the reduction scratch.
inline size_t smem_floats(int win) {
  return (size_t)(win + 3) * (win + 3) + (size_t)(win + 2) * (win + 2) + 2 * (size_t)win * win +
         32 * 5;
}

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
__device__ void block_sum(float (&v)[K], float* scratch /* 32*K */) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
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
    for (int w = 0; w < warps; ++w) s += scratch[w * K + k];
    v[k] = s;
  }
}

// The block's shared memory: raw (n x n) and shifted (t x t) templates, the
// gradients of the win x win window, the reduction scratch.
struct Smem {
  float *raw, *T, *gx, *gy, *red;
};

__device__ Smem carve(float* base, int win) {
  Smem m;
  m.raw = base;
  m.T = m.raw + (win + 3) * (win + 3);
  m.gx = m.T + (win + 2) * (win + 2);
  m.gy = m.gx + win * win;
  m.red = m.gy + win * win;
  return m;
}

struct Template {
  float a11, a12, a22, bt1, bt2, inv_det;
  bool good;     // valid & corner in the image & det > 1e-12
  bool status;   // the level-0 gate (min eigenvalue), meaningful at level 0
};

// The template of one level (lk.py:380-433): the (win+3)^2 raw window of
// the PREVIOUS image around the point, bilinear-shifted, Scharr/32, G and
// the template part of b; the gradients go to shared memory.  Every thread
// returns the same sums.
template <int kWin>
__device__ Template level_template(const Level& pl, float prev_x, float prev_y, float scale,
                                   bool is_valid, float min_eig_thr, int win_rt,
                                   const Smem& sm) {
  const int win = side<kWin>(win_rt), n = win + 3, nt = win + 2;
  const int tid = threadIdx.x;
  const float half = 0.5f * (win - 1);
  const float cx = (prev_x * scale - half) + (float)kPad;
  const float cy = (prev_y * scale - half) + (float)kPad;
  const float fcx = floorf(cx), fcy = floorf(cy);
  const int ry0 = clampi((int)fcy - 1, 0, pl.HP - n);
  const int rx0 = clampi((int)fcx - 1, 0, pl.WP - n);
  for (int k = tid; k < n * n; k += blockDim.x)
    sm.raw[k] = pl.img[(size_t)(ry0 + k / n) * pl.WP + rx0 + k % n];
  __syncthreads();
  const float ax = cx - fcx, ay = cy - fcy;
  const float w00 = (1.f - ax) * (1.f - ay), w01 = ax * (1.f - ay);
  const float w10 = (1.f - ax) * ay, w11 = ax * ay;
  for (int k = tid; k < nt * nt; k += blockDim.x) {
    const int r = k / nt, c = k % nt;
    sm.T[k] = w00 * sm.raw[r * n + c] + w01 * sm.raw[r * n + c + 1] +
              w10 * sm.raw[(r + 1) * n + c] + w11 * sm.raw[(r + 1) * n + c + 1];
  }
  __syncthreads();
  float sums[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int q = tid; q < win * win; q += blockDim.x) {
    const int pi = q / win, pj = q % win;
    const float sm0 = 3.f / 32.f, sm1 = 10.f / 32.f, sm2 = 3.f / 32.f;
    const float gI = sm.T[(pi + 1) * nt + pj + 1];
    float v[3], w[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float t0 = sm.T[pi * nt + pj + c], t1 = sm.T[(pi + 1) * nt + pj + c],
                  t2 = sm.T[(pi + 2) * nt + pj + c];
      v[c] = sm0 * t0 + sm1 * t1 + sm2 * t2;
      w[c] = (-1.f * t0 + 0.f * t1) + 1.f * t2;
    }
    float gx = (-1.f * v[0] + 0.f * v[1]) + 1.f * v[2];
    float gy = sm0 * w[0] + sm1 * w[1] + sm2 * w[2];
    const float ys = cy + (float)pi, xs = cx + (float)pj;
    const bool inside = ys >= (float)kPad && ys <= (float)(pl.HP - 1 - kPad) &&
                        xs >= (float)kPad && xs <= (float)(pl.WP - 1 - kPad);
    if (!inside) {
      gx = 0.f;
      gy = 0.f;
    }
    sm.gx[q] = gx;
    sm.gy[q] = gy;
    sums[0] += gx * gx;
    sums[1] += gx * gy;
    sums[2] += gy * gy;
    sums[3] += gI * gx;
    sums[4] += gI * gy;
  }
  block_sum<5>(sums, sm.red);  // its barriers publish the gradients
  Template t;
  t.a11 = sums[0];
  t.a12 = sums[1];
  t.a22 = sums[2];
  t.bt1 = sums[3];
  t.bt2 = sums[4];
  const float det = t.a11 * t.a22 - t.a12 * t.a12;
  t.inv_det = det > 1e-12f ? 1.f / det : 0.f;
  const float ipx = fcx - (float)kPad, ipy = fcy - (float)kPad;
  const bool in_prev = ipx >= (float)(-win) && ipx < (float)pl.W &&
                       ipy >= (float)(-win) && ipy < (float)pl.H;
  t.good = is_valid && in_prev && det > 1e-12f;
  const float d = t.a11 - t.a22;
  const float min_eig =
      (t.a22 + t.a11 - sqrtf(d * d + 4.f * t.a12 * t.a12)) / (2.f * win * win);
  t.status = is_valid && in_prev && min_eig >= min_eig_thr && det > 1e-12f;
  return t;
}

// The gated Gauss-Newton steps of one level (lk.py:248-288) from (px, py),
// level coordinates.  The sample corner is clamped to [o, o + ub] (padded
// coordinates) and read from ``src``: the pixel of padded row o_y + s has
// row index r_off + s there, row stride ``ld`` (the whole level: r_off =
// o_y; a search window cut at o: r_off = 0).
template <int kWin>
__device__ void gauss_newton(const Template& t, const float* src, int ld, int r_off,
                             int c_off, int oy, int ox, float uby, float ubx, int H,
                             int W, int it_max, float eps2, int win_rt, const Smem& sm,
                             float& px, float& py) {
  const int win = side<kWin>(win_rt);
  const int tid = threadIdx.x;
  const float half = 0.5f * (win - 1);
  bool conv = !t.good;
  float pdx = 0.f, pdy = 0.f;
  for (int it = 0; it < it_max && !conv; ++it) {
    const float sx = fminf(fmaxf(((px - half) + (float)kPad) - (float)ox, 0.f), ubx);
    const float sy = fminf(fmaxf(((py - half) + (float)kPad) - (float)oy, 0.f), uby);
    const float bx = floorf(sx), by = floorf(sy);
    const float fx = sx - bx, fy = sy - by;
    float bj[2] = {0.f, 0.f};
    for (int q = tid; q < win * win; q += blockDim.x) {
      const int pi = q / win, pj = q % win;
      const float* row0 = src + (size_t)(r_off + (int)by + pi) * ld + c_off + (int)bx + pj;
      const float* row1 = row0 + ld;
      const float t0 = (1.f - fy) * row0[0] + fy * row1[0];
      const float t1 = (1.f - fy) * row0[1] + fy * row1[1];
      const float J = t0 * (1.f - fx) + t1 * fx;
      bj[0] += J * sm.gx[q];
      bj[1] += J * sm.gy[q];
    }
    block_sum<2>(bj, sm.red);
    const float b1 = bj[0] - t.bt1, b2 = bj[1] - t.bt2;
    const float dx = (t.a12 * b2 - t.a22 * b1) * t.inv_det;
    const float dy = (t.a12 * b1 - t.a11 * b2) * t.inv_det;
    const float nx = px + dx, ny = py + dy;
    const bool inb = floorf(nx - half) >= (float)(-win) && floorf(nx - half) < (float)W &&
                     floorf(ny - half) >= (float)(-win) && floorf(ny - half) < (float)H;
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
}

// OpenCV's final status drop on the level-0 point (lk.py:447-456).
__device__ bool in_image(float x, float y, int H0, int W0, int win) {
  const float half = 0.5f * (win - 1);
  return floorf(x - half) >= (float)(-win) && floorf(x - half) < (float)W0 &&
         floorf(y - half) >= (float)(-win) && floorf(y - half) < (float)H0;
}

// The compact search window's origin at a level (lk.py:188-194), [y, x].
__device__ int2 compact_origin(float x, float y, float scale, const Level& l, int win) {
  const float half = 0.5f * (win - 1);
  const int need = win + 1 + 2 * kMargin;
  const float cx = (x * scale - half) + (float)kPad, cy = (y * scale - half) + (float)kPad;
  return make_int2(clampi((int)floorf(cy) - kMargin, 0, l.HP - need),
                   clampi((int)floorf(cx) - kMargin, 0, l.WP - need));
}

// Threads of a block of the instantiation (its launch bound).
template <int kWin>
constexpr int block_threads() {
  return kWin > 0 ? (kWin * kWin + 31) / 32 * 32 : kLoopThreads;
}

template <int kWin>
__global__ void __launch_bounds__(block_threads<kWin>())
lk_kernel(const float* __restrict__ prev_pyr, const float* __restrict__ curr_pyr,
          int H0, int W0, const float* __restrict__ prev_pts,
          const float* __restrict__ init_pts, const uint8_t* __restrict__ valid,
          int n_levels, int max_iter, int max_iter_upper, float eps2,
          float min_eig_thr, float* __restrict__ out_pts,
          uint8_t* __restrict__ out_status, int win_rt) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  const int win = side<kWin>(win_rt);
  const Smem sm = carve(reinterpret_cast<float*>(dyn_smem), win);

  const int f = blockIdx.x;
  const bool is_valid = valid[f] != 0;
  const float prev_x = prev_pts[2 * f], prev_y = prev_pts[2 * f + 1];
  float next_x = init_pts[2 * f], next_y = init_pts[2 * f + 1];
  bool status = false;

  for (int L = n_levels - 1; L >= 0; --L) {
    const Level pl = level_of(prev_pyr, H0, W0, L);
    const Level cl = level_of(curr_pyr, H0, W0, L);
    const float scale = 1.0f / (float)(1 << L);
    const Template t = level_template<kWin>(pl, prev_x, prev_y, scale, is_valid, min_eig_thr,
                                            win_rt, sm);
    if (L == 0) status = t.status;

    // ---- search window (lk.py:188-219, extract.py:164-173) ----
    float px = next_x * scale, py = next_y * scale;
    const int2 des = compact_origin(next_x, next_y, scale, cl, win);
    const int nbr = max(1, ceil_div(cl.HP - kBw, kStride) + 1);
    const int nbc = max(1, ceil_div(cl.WP - kBw, kStride) + 1);
    const int oy = kStride * min(des.x / kStride, nbr - 1);
    const int ox = kStride * min(des.y / kStride, nbc - 1);
    const float uby = (float)min(kBw - (win + 1), cl.HP - (win + 1) - oy);
    const float ubx = (float)min(kBw - (win + 1), cl.WP - (win + 1) - ox);

    const int it_max = (L == 0 || max_iter_upper <= 0) ? max_iter : max_iter_upper;
    gauss_newton<kWin>(t, cl.img, cl.WP, oy, ox, oy, ox, uby, ubx, cl.H, cl.W, it_max, eps2,
                       win_rt, sm, px, py);
    next_x = px * (float)(1 << L);
    next_y = py * (float)(1 << L);
    __syncthreads();  // the templates are rewritten by the next level
  }

  if (threadIdx.x == 0) {
    out_pts[2 * f] = next_x;
    out_pts[2 * f + 1] = next_y;
    out_status[f] = status && in_image(next_x, next_y, H0, W0, win);
  }
}

// One level L of the compact-window tracker.  windows: (F, need, need)
// with need = side + 17, the search window of each point cut out of the
// current level at des (F, 2) [y, x]; pts_in / pts_out: full-resolution
// points before / after the level.  For L > 0 writes des_next, the origin
// at level L - 1 of pts_out; at L = 0 writes the status.
template <int kWin>
__global__ void __launch_bounds__(block_threads<kWin>())
lk_level_kernel(const float* __restrict__ prev_pyr, int H0, int W0,
                const float* __restrict__ prev_pts, const float* __restrict__ pts_in,
                const uint8_t* __restrict__ valid, const float* __restrict__ windows,
                const int32_t* __restrict__ des, int L, int it_max, float eps2,
                float min_eig_thr, float* __restrict__ pts_out,
                int32_t* __restrict__ des_next, uint8_t* __restrict__ out_status, int win_rt) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  const int win = side<kWin>(win_rt), need = win + 1 + 2 * kMargin;
  const Smem sm = carve(reinterpret_cast<float*>(dyn_smem), win);

  const int f = blockIdx.x;
  const Level pl = level_of(prev_pyr, H0, W0, L);  // the current level has its size
  const float scale = 1.0f / (float)(1 << L);
  const Template t = level_template<kWin>(pl, prev_pts[2 * f], prev_pts[2 * f + 1], scale,
                                          valid[f] != 0, min_eig_thr, win_rt, sm);
  float px = pts_in[2 * f] * scale, py = pts_in[2 * f + 1] * scale;
  const int oy = des[2 * f], ox = des[2 * f + 1];
  const float uby = (float)min(need - (win + 1), pl.HP - (win + 1) - oy);
  const float ubx = (float)min(need - (win + 1), pl.WP - (win + 1) - ox);
  gauss_newton<kWin>(t, windows + (size_t)f * need * need, need, 0, 0, oy, ox, uby, ubx,
                     pl.H, pl.W, it_max, eps2, win_rt, sm, px, py);
  if (threadIdx.x == 0) {
    const float nx = px * (float)(1 << L), ny = py * (float)(1 << L);
    pts_out[2 * f] = nx;
    pts_out[2 * f + 1] = ny;
    if (L > 0) {
      const int2 d = compact_origin(nx, ny, 1.0f / (float)(1 << (L - 1)),
                                    level_of(prev_pyr, H0, W0, L - 1), win);
      des_next[2 * f] = d.x;
      des_next[2 * f + 1] = d.y;
    } else {
      out_status[f] = t.status && in_image(nx, ny, H0, W0, win);
    }
  }
}

// The whole compact-window tracker of one point (see the note at the top).
// des_out (F, n_levels, 2) [y, x] or null: each level's window origin.
// clocks (1 + 3 n_levels int64) or null: block 0's SM clock at its start
// and, coarse to fine, after each level's template (its window's copy in
// flight), after the copy's wait and after its Gauss-Newton steps.
template <int kWin>
__global__ void __launch_bounds__(block_threads<kWin>())
lk_compact_kernel(const float* __restrict__ prev_pyr, const float* __restrict__ curr_pyr,
                  int H0, int W0, const float* __restrict__ prev_pts,
                  const float* __restrict__ init_pts, const uint8_t* __restrict__ valid,
                  int n_levels, int max_iter, int max_iter_upper, float eps2,
                  float min_eig_thr, float* __restrict__ out_pts,
                  uint8_t* __restrict__ out_status, int32_t* __restrict__ des_out,
                  long long* __restrict__ clocks, int win_rt) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  const int win = side<kWin>(win_rt), need = win + 1 + 2 * kMargin;
  const Smem sm = carve(reinterpret_cast<float*>(dyn_smem), win);
  float* window = sm.red + 32 * 5;  // need x need, the current level's search window

  const int f = blockIdx.x, tid = threadIdx.x;
  const bool timed = clocks != nullptr && f == 0 && tid == 0;
  if (timed) clocks[0] = clock64();
  const bool is_valid = valid[f] != 0;
  const float prev_x = prev_pts[2 * f], prev_y = prev_pts[2 * f + 1];
  float next_x = init_pts[2 * f], next_y = init_pts[2 * f + 1];
  bool status = false;

  for (int L = n_levels - 1; L >= 0; --L) {
    const Level pl = level_of(prev_pyr, H0, W0, L);
    const Level cl = level_of(curr_pyr, H0, W0, L);
    const float scale = 1.0f / (float)(1 << L);
    const int2 des = compact_origin(next_x, next_y, scale, cl, win);  // [y, x]
    if (des_out != nullptr && tid == 0) {
      des_out[((size_t)f * n_levels + L) * 2] = des.x;
      des_out[((size_t)f * n_levels + L) * 2 + 1] = des.y;
    }
    const float* src = cl.img + (size_t)des.x * cl.WP + des.y;
    for (int k = tid; k < need * need; k += blockDim.x) {
      const int i = k / need;
      msckf::cp_async<4>(window + k, src + (size_t)i * cl.WP + (k - i * need));
    }
    msckf::cp_async_commit();
    const Template t = level_template<kWin>(pl, prev_x, prev_y, scale, is_valid, min_eig_thr,
                                            win_rt, sm);
    const int c = 1 + 3 * (n_levels - 1 - L);
    if (timed) clocks[c] = clock64();
    msckf::cp_async_wait_all();
    __syncthreads();  // the block's window
    if (timed) clocks[c + 1] = clock64();
    if (L == 0) status = t.status;
    float px = next_x * scale, py = next_y * scale;
    const float uby = (float)min(need - (win + 1), pl.HP - (win + 1) - des.x);
    const float ubx = (float)min(need - (win + 1), pl.WP - (win + 1) - des.y);
    const int it_max = (L == 0 || max_iter_upper <= 0) ? max_iter : max_iter_upper;
    gauss_newton<kWin>(t, window, need, 0, 0, des.x, des.y, uby, ubx, pl.H, pl.W, it_max, eps2,
                       win_rt, sm, px, py);
    next_x = px * (float)(1 << L);
    next_y = py * (float)(1 << L);
    if (timed) clocks[c + 2] = clock64();
    __syncthreads();  // the window and the templates are rewritten by the next level
  }

  if (tid == 0) {
    out_pts[2 * f] = next_x;
    out_pts[2 * f + 1] = next_y;
    out_status[f] = status && in_image(next_x, next_y, H0, W0, win);
  }
}

// The instantiation for a side: one per odd side 3..31, else the looped one.
#define LK_SIDES(X) \
  X(3) X(5) X(7) X(9) X(11) X(13) X(15) X(17) X(19) X(21) X(23) X(25) X(27) X(29) X(31)

using LkFn = decltype(&lk_kernel<0>);
using LevelFn = decltype(&lk_level_kernel<0>);
using CompactFn = decltype(&lk_compact_kernel<0>);

LkFn pick_lk(int win) {
  switch (win) {
#define LK_CASE(w) \
  case w:          \
    return lk_kernel<w>;
    LK_SIDES(LK_CASE)
#undef LK_CASE
    default:
      return lk_kernel<0>;
  }
}

LevelFn pick_level(int win) {
  switch (win) {
#define LK_CASE(w) \
  case w:          \
    return lk_level_kernel<w>;
    LK_SIDES(LK_CASE)
#undef LK_CASE
    default:
      return lk_level_kernel<0>;
  }
}

CompactFn pick_compact(int win) {
  switch (win) {
#define LK_CASE(w) \
  case w:          \
    return lk_compact_kernel<w>;
    LK_SIDES(LK_CASE)
#undef LK_CASE
    default:
      return lk_compact_kernel<0>;
  }
}

inline bool looped(int win) { return win > 31 || win % 2 == 0; }

// Allow the looped instantiation's shared memory past 48 KB (large sides).
template <typename K>
int prepare(K kernel, int win, size_t* allowed, size_t floats) {
  return looped(win) ? msckf::allow_smem(kernel, floats * sizeof(float), allowed) : 0;
}

// The compact tracker's floats: smem_floats and the staged window.
inline size_t compact_floats(int win) {
  return smem_floats(win) + (size_t)(win + 1 + 2 * kMargin) * (win + 1 + 2 * kMargin);
}

}  // namespace

extern "C" int pyramidal_lk(const void* prev_pyr, const void* curr_pyr, int H0,
                            int W0, const void* prev_pts, const void* init_pts,
                            const void* valid, int F, int n_levels, int max_iter,
                            int max_iter_upper, float eps2, float min_eig,
                            void* out_pts, void* out_status, int win, void* stream) {
  static size_t allowed = 0;
  if (win < 1) return (int)cudaErrorInvalidValue;
  if (F == 0) return 0;
  const LkFn kernel = pick_lk(win);
  const int err = prepare(kernel, win, &allowed, smem_floats(win));
  if (err != 0) return err;
  const int threads = looped(win) ? kLoopThreads : (win * win + 31) / 32 * 32;
  kernel<<<F, threads, smem_floats(win) * sizeof(float), (cudaStream_t)stream>>>(
      (const float*)prev_pyr, (const float*)curr_pyr, H0, W0,
      (const float*)prev_pts, (const float*)init_pts, (const uint8_t*)valid,
      n_levels, max_iter, max_iter_upper, eps2, min_eig, (float*)out_pts,
      (uint8_t*)out_status, win);
  return (int)cudaGetLastError();
}

extern "C" int pyramidal_lk_level(const void* prev_pyr, int H0, int W0, const void* prev_pts,
                                  const void* pts_in, const void* valid, const void* windows,
                                  const void* des, int F, int L, int it_max, float eps2,
                                  float min_eig, void* pts_out, void* des_next,
                                  void* out_status, int win, void* stream) {
  static size_t allowed = 0;
  if (win < 1) return (int)cudaErrorInvalidValue;
  if (F == 0) return 0;
  const LevelFn kernel = pick_level(win);
  const int err = prepare(kernel, win, &allowed, smem_floats(win));
  if (err != 0) return err;
  const int threads = looped(win) ? kLoopThreads : (win * win + 31) / 32 * 32;
  kernel<<<F, threads, smem_floats(win) * sizeof(float), (cudaStream_t)stream>>>(
      (const float*)prev_pyr, H0, W0, (const float*)prev_pts, (const float*)pts_in,
      (const uint8_t*)valid, (const float*)windows, (const int32_t*)des, L, it_max, eps2,
      min_eig, (float*)pts_out, (int32_t*)des_next, (uint8_t*)out_status, win);
  return (int)cudaGetLastError();
}

extern "C" int pyramidal_lk_compact(const void* prev_pyr, const void* curr_pyr, int H0, int W0,
                                    const void* prev_pts, const void* init_pts,
                                    const void* valid, int F, int n_levels, int max_iter,
                                    int max_iter_upper, float eps2, float min_eig,
                                    void* out_pts, void* out_status, void* des_out,
                                    void* clocks, int win, void* stream) {
  static size_t allowed = 0;
  if (win < 1 || n_levels < 1) return (int)cudaErrorInvalidValue;
  if (F == 0) return 0;
  const CompactFn kernel = pick_compact(win);
  const int err = prepare(kernel, win, &allowed, compact_floats(win));
  if (err != 0) return err;
  const int threads = looped(win) ? kLoopThreads : (win * win + 31) / 32 * 32;
  kernel<<<F, threads, compact_floats(win) * sizeof(float), (cudaStream_t)stream>>>(
      (const float*)prev_pyr, (const float*)curr_pyr, H0, W0, (const float*)prev_pts,
      (const float*)init_pts, (const uint8_t*)valid, n_levels, max_iter, max_iter_upper, eps2,
      min_eig, (float*)out_pts, (uint8_t*)out_status, (int32_t*)des_out, (long long*)clocks,
      win);
  return (int)cudaGetLastError();
}
