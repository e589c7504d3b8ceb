// K13: feature triangulation by inverse-depth Levenberg-Marquardt, with the
// construction of the views fused in; 64 threads (two warps) per feature.
//
// Replaces uav_airvision_tpu/models/msckf/triangulation.py::triangulate
// (:159, in its static form _triangulate_static :235) together with
// build_views (:41); the row entry also replaces its call site, JAX
// step.py::_triangulate_one (:175) with check_motion (triangulation.py:294)
// and the back-end's gathers and scatters around it.  The JAX package
// materialises (B, 2N, 3, 3) view rotations and vmaps the solve over
// features.  Here a group of 64 threads takes one feature and each thread
// the views t, t + 64, ... (view v: camera v % 2 of window slot v / 2; in
// registers: kViews = 1, 2, 4 or 8 a thread, chosen from N at the launch;
// past 256 slots a thread rebuilds a view from the window each time it
// needs it, the same arithmetic).  The recurrence is the static form's:
//   - at most inner_loop_max_iteration damped solves in total, the inner
//     counter shared across outer iterations;
//   - a new linearisation only at a group start (the first step and after
//     every accepted step), gated by the outer count and the step norm;
//   - Huber weights eps / (2 e), lambda clamped to [1e-10, 1e12], the
//     Cramer 3x3 solve with the |det| > 1e-30 guard;
//   - a feature with active = 0 keeps the closed-form initial guess.
//
// What bounds it: a pass over the views (a cost, or the normal equations)
// is a chain of IEEE divisions and square roots, each behind its own
// slow-path branch, so they run one after another: the normal equations
// take ~11 of them a view, the cost 2 (the parent's phase clocks: ~2,500
// and ~590 SM cycles a pass with a slot's two views on one lane).  One
// view a thread halves the chain; the price is one exchange between the
// two warps a pass (each warp's butterfly, its sums through shared memory
// behind a named barrier of the 64 threads, added in warp order so every
// thread holds the same bits; a buffer a pass parity, so one barrier a
// pass).  The sum order is not the warp-per-feature kernel's: positions
// agree with it and with the plain version to rounding.
//
// The fused passes (the row entry): one pass at a point gives the cost AND
// the normal equations there, one round of sums: at x0, then at every
// trial point where an accepted step would start a group that goes on (not
// on the last step, past the outer count, or below the precision; there
// the pass is the cost's alone).  An accepted step's sums start the next
// group; a refused step's are dropped.  So a feature takes at most
// 1 + inner_loop_max_iteration rounds of sums.  Each view's arithmetic and
// the sums' order are those of a pass of each kind, so the results are the
// same bits as the separate passes'.  A group whose feature has stopped
// leaves the loop: nothing it holds changes after that, so the early exit
// is exact.
//
// Two entry points.  ``triangulate_*``: B features, row b of obs /
// obs_mask, positions and validity out, with the separate passes (a cost
// pass a step, a normal-equations pass a group): the row entry's witness,
// bit for bit, in the tests and in chip_smoke.py.  ``triangulate_rows_*``:
// the back-end's call site in the launch, with the fused passes.  Group b
// takes map row sel[b] of the feature table (obs (M, N, 4), obs_mask
// (M, N)); it is triangulated when need_init = sel_ok[b] &
// ~initialized[sel[b]] and, when the motion check is on (threshold >= 0),
// the camera's translation from the feature's first to its last observing
// slot, orthogonal to the first observation's ray in the world, exceeds the
// threshold (a warp's ballots find the slots).  It writes row sel[b] of the
// new position and initialized columns (the triangulated position where
// that succeeded, else the old row) and init_fail[b] = need_init &
// ~(motion & valid).  The launch's last blocks copy every other row of the
// two columns (each builds a bitmap of sel in shared memory), so that no
// row is written twice and the inputs stay as they were; sel holds
// distinct rows (the back-end's smallest-k selection).
//
// Bound on the card: bytes (a feature reads ~0.5 KB and does ~20 kFLOP),
// both far below a launch; the passes' chains set its time.
//
// ``clocks`` (9 int64 or null): the SM clock of block 0's first group at
// its start, after the anchor and the views, after the initial guess and
// its pass; the cycles it spent in the normal equations' own passes (none
// in the fused form), the solves and the trial passes (summed over its
// steps); the clock after the loop and after the finish; the number of
// steps it took.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "msckf_common.cuh"

namespace {

constexpr int kGroup = 64;  // threads per feature: two warps
constexpr int kGroups = 2;  // features per block
constexpr int kBlock = kGroup * kGroups;
constexpr int kCopyRows = 1024;  // rows a copy block of the row entry takes

template <typename T>
struct View {
  T R[9];  // x_view = R x_anchor + t
  T t[3];
};

template <typename T>
struct Args {
  const T *cam_q, *cam_p;
  int N;
  const T* obs;               // (B or M, N, 4)
  const uint8_t* obs_mask;    // (B or M, N)
  const T *R_c0c1, *t_c0c1;
  int B;
  T huber_eps, precision, damping, motion_thr;  // motion_thr < 0: no motion check
  int outer_max, inner_max;
  // triangulate_*: active (B,) or null; pos (B, 3), ok (B,)
  const uint8_t* active;
  T* pos;
  uint8_t* ok;
  // triangulate_rows_*: sel (B,) map rows, sel_ok (B,); the table's
  // position (M, 3) and initialized (M,); their new columns and init_fail (B,)
  const int64_t* sel;
  const uint8_t* sel_ok;
  const T* position;
  const uint8_t* initialized;
  int M;
  T* pos_out;
  uint8_t *init_out, *fail_out;
  long long* clocks;
};

// A camera's pose relative to the anchor (build_views' rel).
template <typename T>
__device__ void rel(const T Rp[9], const T tp[3], const T Ra[9], const T ta[3], View<T>& v) {
  for (int i = 0; i < 3; ++i) {
    for (int k = 0; k < 3; ++k)
      v.R[3 * i + k] = Rp[i] * Ra[k] + Rp[3 + i] * Ra[3 + k] + Rp[6 + i] * Ra[6 + k];
    v.t[i] = Rp[i] * (ta[0] - tp[0]) + Rp[3 + i] * (ta[1] - tp[1]) + Rp[6 + i] * (ta[2] - tp[2]);
  }
}

// One view (camera cam) of the window slot whose pose is q, tc0w, in the
// anchor frame (build_views: x_view = R x_anchor + t).
template <typename T>
__device__ void slot_view(const T* q, const T* tc0w, int cam, const T Ra[9], const T ta[3],
                          const T Rc1c0[9], const T tc1c0[3], View<T>& v) {
  T Rw[9], Rc0w[9];
  msckf::to_rotation(q, Rw);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) Rc0w[3 * i + j] = Rw[3 * j + i];
  if (cam == 0) {
    rel(Rc0w, tc0w, Ra, ta, v);
    return;
  }
  T Rc1w[9], tc1w[3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j)
      Rc1w[3 * i + j] = Rc0w[3 * i] * Rc1c0[j] + Rc0w[3 * i + 1] * Rc1c0[3 + j] +
                        Rc0w[3 * i + 2] * Rc1c0[6 + j];
    tc1w[i] = (Rc0w[3 * i] * tc1c0[0] + Rc0w[3 * i + 1] * tc1c0[1] +
               Rc0w[3 * i + 2] * tc1c0[2]) + tc0w[i];
  }
  rel(Rc1w, tc1w, Ra, ta, v);
}

// h = R [x0, x1, 1] + x2 t
template <typename T>
__device__ inline void project(const View<T>& v, const T x[3], T h[3]) {
  for (int i = 0; i < 3; ++i)
    h[i] = (v.R[3 * i] * x[0] + v.R[3 * i + 1] * x[1] + v.R[3 * i + 2]) + x[2] * v.t[i];
}

template <typename T>
__device__ inline void cross(const T a[3], const T b[3], T c[3]) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// The motion check (triangulation.py::check_motion) of a feature whose
// first observing slot has the pose q, p_first and its last p_last, z its
// first observation.
template <typename T>
__device__ bool motion_ok(const T q[4], const T p_first[3], const T p_last[3], const T* z,
                          T thr) {
  T Rw[9];
  msckf::to_rotation(q, Rw);
  const T d0 = z[0], d1 = z[1], d2 = T(1);
  const T n = sqrt(d0 * d0 + d1 * d1 + d2 * d2);
  const T u[3] = {d0 / n, d1 / n, d2 / n};
  T dir[3], tr[3];
  for (int i = 0; i < 3; ++i) {  // the ray in the world: Rw^T u
    dir[i] = Rw[i] * u[0] + Rw[3 + i] * u[1] + Rw[6 + i] * u[2];
    tr[i] = p_last[i] - p_first[i];
  }
  const T par = tr[0] * dir[0] + tr[1] * dir[1] + tr[2] * dir[2];
  const T o[3] = {tr[0] - par * dir[0], tr[1] - par * dir[1], tr[2] - par * dir[2]};
  return sqrt(o[0] * o[0] + o[1] * o[1] + o[2] * o[2]) > thr;
}

// The row entry's copy blocks: every row of position and initialized that
// sel does not name, as it is.
template <typename T>
__device__ void copy_rows(const Args<T>& a, int cb) {
  extern __shared__ uint32_t named[];  // a bit per map row
  const int words = (a.M + 31) / 32;
  for (int w = threadIdx.x; w < words; w += blockDim.x) named[w] = 0u;
  __syncthreads();
  for (int b = threadIdx.x; b < a.B; b += blockDim.x) {
    const int64_t m = a.sel[b];
    if (m >= 0 && m < a.M) atomicOr(&named[m >> 5], 1u << (m & 31));
  }
  __syncthreads();
  const int m0 = cb * kCopyRows, m1 = min(a.M, m0 + kCopyRows);
  for (int e = 3 * m0 + threadIdx.x; e < 3 * m1; e += blockDim.x) {
    const int m = e / 3;
    if (((named[m >> 5] >> (m & 31)) & 1u) == 0u) a.pos_out[e] = a.position[e];
  }
  for (int m = m0 + threadIdx.x; m < m1; m += blockDim.x)
    if (((named[m >> 5] >> (m & 31)) & 1u) == 0u) a.init_out[m] = a.initialized[m];
}

// The named barrier of group g's 64 threads (barrier 0 is __syncthreads).
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + g), "r"(kGroup) : "memory");
}

template <typename T, int kViews, bool kFused>
__global__ void __launch_bounds__(kBlock) triangulate_kernel(const Args<T> a) {
  // a group's two warps' partial sums, by pass parity, and their votes
  __shared__ T red[kGroups][2][2][10];
  __shared__ int votes[kGroups][2];
  const int n_blocks = (a.B + kGroups - 1) / kGroups;
  if ((int)blockIdx.x >= n_blocks) {  // uniform over the block
    copy_rows(a, (int)blockIdx.x - n_blocks);
    return;
  }
  const int g = (int)threadIdx.x / kGroup, t = (int)threadIdx.x % kGroup;
  const int lane = t & 31, half = t >> 5;
  const int b = blockIdx.x * kGroups + g;
  if (b >= a.B) return;  // the whole group
  const int N = a.N;
  const T *cam_q = a.cam_q, *cam_p = a.cam_p;
  // the phase clocks of block 0's first group (uniform over the group)
  const bool timed = a.clocks != nullptr && b == 0;
  const bool store = timed && t == 0;
  long long tick = timed ? clock64() : 0, ne_cyc = 0, solve_cyc = 0, trial_cyc = 0;
  if (store) a.clocks[0] = tick;
  const bool rows = a.sel != nullptr;
  const int64_t row = rows ? a.sel[b] : b;
  const T* z_b = a.obs + (size_t)row * N * 4;
  const uint8_t* m_b = a.obs_mask + (size_t)row * N;

  // the first and last observing slots (0 and N - 1 if none); each warp
  // finds them itself
  int first = -1, last = -1;
  for (int s0 = 0; s0 < N; s0 += 32) {
    const int s = s0 + lane;
    const unsigned bal = __ballot_sync(0xffffffffu, s < N && m_b[s] != 0);
    if (bal != 0u && first < 0) first = s0 + __ffs((int)bal) - 1;
    if (bal != 0u) last = s0 + 31 - __clz((int)bal);
  }
  if (first < 0) first = 0;
  if (last < 0) last = N - 1;
  const T* q_a = cam_q + 4 * first;  // the first observing slot's pose: the anchor
  const T* p_a = cam_p + 3 * first;
  bool alive = true, moved = true;
  if (rows) {  // the call site: need_init, then the motion check
    alive = a.sel_ok[b] != 0 && a.initialized[row] == 0;
    if (alive && a.motion_thr >= T(0))
      moved = motion_ok(q_a, p_a, cam_p + 3 * last, z_b + 4 * first, a.motion_thr);
    if (!(alive && moved)) {  // the row stays as it is
      if (t == 0) {
        for (int i = 0; i < 3; ++i) a.pos_out[3 * row + i] = a.position[3 * row + i];
        a.init_out[row] = a.initialized[row];
        a.fail_out[b] = alive ? 1 : 0;
      }
      return;
    }
  } else {
    alive = a.active == nullptr || a.active[b] != 0;
  }

  // cam1 -> cam0: R_c1_c0 = R_c0c1^T, t_c1_c0 = -R_c0c1^T t_c0c1
  T Rc1c0[9], tc1c0[3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) Rc1c0[3 * i + j] = a.R_c0c1[3 * j + i];
    tc1c0[i] = (-a.R_c0c1[i]) * a.t_c0c1[0] + (-a.R_c0c1[3 + i]) * a.t_c0c1[1] +
               (-a.R_c0c1[6 + i]) * a.t_c0c1[2];
  }
  T Rw[9], Ra[9], ta[3];
  msckf::to_rotation(q_a, Rw);
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) Ra[3 * i + j] = Rw[3 * j + i];
    ta[i] = p_a[i];
  }

  // this thread's views v = t + 64 j (view v: slot v / 2, camera v % 2),
  // their observations and masks (kViews = 0: rebuilt at each use)
  constexpr int kHeld = kViews > 0 ? kViews : 1;
  View<T> view[kHeld];
  T z[kHeld][2];
  bool m[kHeld];
#pragma unroll
  for (int j = 0; j < kViews; ++j) {
    const int v = t + kGroup * j, s = v >> 1;
    m[j] = s < N && m_b[s] != 0;
    if (m[j]) {
      slot_view(cam_q + 4 * s, cam_p + 3 * s, v & 1, Ra, ta, Rc1c0, tc1c0, view[j]);
      for (int c = 0; c < 2; ++c) z[j][c] = z_b[4 * s + 2 * (v & 1) + c];
    }
  }
  if (store) a.clocks[1] = clock64();
  // f(view, z) for each observing view of this thread, in view order
  auto for_views = [&](auto&& f) {
    if constexpr (kViews > 0) {
#pragma unroll
      for (int j = 0; j < kViews; ++j)
        if (m[j]) f(view[j], z[j]);
    } else {
      for (int v = t; v < 2 * N; v += kGroup) {
        const int s = v >> 1;
        if (m_b[s] == 0) continue;
        View<T> w;
        slot_view(cam_q + 4 * s, cam_p + 3 * s, v & 1, Ra, ta, Rc1c0, tc1c0, w);
        const T zs[2] = {z_b[4 * s + 2 * (v & 1)], z_b[4 * s + 2 * (v & 1) + 1]};
        f(w, zs);
      }
    }
  };

  // closed-form initial guess from the anchor slot's stereo pair
  T x[3];
  {
    View<T> v1;
    slot_view(q_a, p_a, 1, Ra, ta, Rc1c0, tc1c0, v1);
    const T z1h[3] = {z_b[4 * first], z_b[4 * first + 1], T(1)};
    const T z2[2] = {z_b[4 * first + 2], z_b[4 * first + 3]};
    T mm[3];
    for (int i = 0; i < 3; ++i)
      mm[i] = v1.R[3 * i] * z1h[0] + v1.R[3 * i + 1] * z1h[1] + v1.R[3 * i + 2] * z1h[2];
    const T a0 = mm[0] - z2[0] * mm[2], a1 = mm[1] - z2[1] * mm[2];
    const T b0 = z2[0] * v1.t[2] - v1.t[0], b1 = z2[1] * v1.t[2] - v1.t[1];
    const T depth = (a0 * b0 + a1 * b1) / (a0 * a0 + a1 * a1);
    const T p[3] = {z1h[0] * depth, z1h[1] * depth, z1h[2] * depth};
    x[0] = p[0] / p[2];
    x[1] = p[1] / p[2];
    x[2] = T(1) / p[2];
  }

  // The cost (kCost) and the Huber-weighted normal equations A (A00 A01 A02
  // A11 A12 A22), b (kNe) at xx: one pass over the thread's views, one
  // round of sums (each warp's butterfly, then the two warps' sums added
  // in warp order, the same bits in every thread of the group).  A pass of
  // either kind alone does the same arithmetic and sums as a pass of both.
  int parity = 0;
  auto pass = [&](auto cost_tag, auto ne_tag, const T xx[3], T& cost_out, T (&A_out)[6],
                  T (&b_out)[3]) {
    constexpr bool kCost = decltype(cost_tag)::value, kNe = decltype(ne_tag)::value;
    constexpr int lo = kNe ? 0 : 9, hi = kCost ? 10 : 9;
    T acc[10] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
    for_views([&](const View<T>& v, const T* zs) {
      T h[3];
      project(v, xx, h);
      const T h3 = h[2];
      const T r0 = h[0] / h3 - zs[0], r1 = h[1] / h3 - zs[1];
      if constexpr (kCost) acc[9] += r0 * r0 + r1 * r1;
      if constexpr (kNe) {
        const T hh = h3 * h3;
        const T W0[3] = {v.R[0], v.R[1], v.t[0]}, W1[3] = {v.R[3], v.R[4], v.t[1]};
        const T W2[3] = {v.R[6], v.R[7], v.t[2]};
        T J0[3], J1[3];
        for (int i = 0; i < 3; ++i) {
          J0[i] = W0[i] / h3 - W2[i] * (h[0] / hh);
          J1[i] = W1[i] / h3 - W2[i] * (h[1] / hh);
        }
        const T e = sqrt(r0 * r0 + r1 * r1);
        const T w = e <= a.huber_eps ? T(1) : a.huber_eps / (T(2) * e);
        const T w2 = w * w;
        acc[0] += w2 * J0[0] * J0[0] + w2 * J1[0] * J1[0];
        acc[1] += w2 * J0[0] * J0[1] + w2 * J1[0] * J1[1];
        acc[2] += w2 * J0[0] * J0[2] + w2 * J1[0] * J1[2];
        acc[3] += w2 * J0[1] * J0[1] + w2 * J1[1] * J1[1];
        acc[4] += w2 * J0[1] * J0[2] + w2 * J1[1] * J1[2];
        acc[5] += w2 * J0[2] * J0[2] + w2 * J1[2] * J1[2];
        for (int i = 0; i < 3; ++i) acc[6 + i] += w2 * J0[i] * r0 + w2 * J1[i] * r1;
      }
    });
#pragma unroll
    for (int i = lo; i < hi; ++i)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
    if (lane == 0)
#pragma unroll
      for (int i = lo; i < hi; ++i) red[g][parity][half][i] = acc[i];
    group_sync(g);
#pragma unroll
    for (int i = lo; i < hi; ++i) acc[i] = red[g][parity][0][i] + red[g][parity][1][i];
    parity ^= 1;  // the next pass writes the other half: no second barrier
    if constexpr (kNe) {
      for (int i = 0; i < 6; ++i) A_out[i] = acc[i];
      for (int i = 0; i < 3; ++i) b_out[i] = acc[6 + i];
    }
    if constexpr (kCost) cost_out = acc[9];
  };
  constexpr std::true_type kYes{};
  constexpr std::false_type kNo{};
  // the fused form's passes: both kinds at once; the parent's: the cost only
  constexpr std::bool_constant<kFused> kTrialNe{};

  T lam = a.damping, cost;
  T A[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};  // the normal equations of the current group
  T bv[3] = {T(0), T(0), T(0)};
  pass(kYes, kTrialNe, x, cost, A, bv);
  if (store) a.clocks[2] = clock64();
  int steps = 0;
  T dnorm = alive ? T(INFINITY) : T(0);
  bool group_start = true;
  int outer = 0;
  for (int it = 0; it < a.inner_max; ++it) {
    if (group_start) {
      alive = alive && outer < a.outer_max && dnorm > a.precision;
    }
    if (!alive) break;
    ++steps;
    if (timed) tick = clock64();
    if (group_start) {
      ++outer;
      if constexpr (!kFused) {  // the normal equations at x, a pass of their own
        T unused;
        pass(kNo, kYes, x, unused, A, bv);
        if (timed) {
          const long long t = clock64();
          ne_cyc += t - tick;
          tick = t;
        }
      }
    }
    // one damped solve (A + lam I) delta = b by Cramer's rule
    const T c0v[3] = {A[0] + lam, A[1], A[2]};
    const T c1v[3] = {A[1], A[3] + lam, A[4]};
    const T c2v[3] = {A[2], A[4], A[5] + lam};
    T k0[3], k1[3], k2[3];
    cross(c1v, c2v, k0);
    cross(c2v, c0v, k1);
    cross(c0v, c1v, k2);
    const T det = c0v[0] * k0[0] + c0v[1] * k0[1] + c0v[2] * k0[2];
    T delta[3] = {T(0), T(0), T(0)};
    if (fabs(det) > T(1e-30)) {
      delta[0] = (bv[0] * k0[0] + bv[1] * k0[1] + bv[2] * k0[2]) / det;
      delta[1] = (bv[0] * k1[0] + bv[1] * k1[1] + bv[2] * k1[2]) / det;
      delta[2] = (bv[0] * k2[0] + bv[1] * k2[1] + bv[2] * k2[2]) / det;
    }
    const T x_new[3] = {x[0] - delta[0], x[1] - delta[1], x[2] - delta[2]};
    const T dnorm_new = sqrt(delta[0] * delta[0] + delta[1] * delta[1] + delta[2] * delta[2]);
    if (timed) {
      const long long t = clock64();
      solve_cyc += t - tick;
      tick = t;
    }
    // the fused form sums the normal equations at x_new only where an
    // accepted step would start a group that goes on: not on the last step,
    // past the outer count, or below the precision
    T cost_new, A_new[6], b_new[3];
    if (kFused && it + 1 < a.inner_max && outer < a.outer_max && dnorm_new > a.precision)
      pass(kYes, kTrialNe, x_new, cost_new, A_new, b_new);
    else
      pass(kYes, kNo, x_new, cost_new, A_new, b_new);
    if (timed) trial_cyc += clock64() - tick;
    const bool better = cost_new < cost;
    if (better) {  // the fused form: a next group starts at x_new, with its sums
      for (int i = 0; i < 3; ++i) x[i] = x_new[i];
      cost = cost_new;
      if constexpr (kFused) {
        for (int i = 0; i < 6; ++i) A[i] = A_new[i];
        for (int i = 0; i < 3; ++i) bv[i] = b_new[i];
      }
      const T l = lam / T(10);
      lam = l < T(1e-10) ? T(1e-10) : l;
    } else {
      const T l = lam * T(10);
      lam = l > T(1e12) ? T(1e12) : l;
    }
    dnorm = dnorm_new;
    group_start = better;
  }
  if (store) {
    a.clocks[3] = ne_cyc;
    a.clocks[4] = solve_cyc;
    a.clocks[5] = trial_cyc;
    a.clocks[6] = clock64();
    a.clocks[8] = steps;
  }

  // back to the world frame; every observing view must see it in front
  const T fin[3] = {x[0] / x[2], x[1] / x[2], T(1) / x[2]};
  bool good = true;
  for_views([&](const View<T>& v, const T*) {
    const T depth = (v.R[6] * fin[0] + v.R[7] * fin[1] + v.R[8] * fin[2]) + v.t[2];
    good = good && depth > T(0);
  });
  good = __all_sync(0xffffffffu, good);
  if (lane == 0) votes[g][half] = good ? 1 : 0;
  group_sync(g);
  good = votes[g][0] != 0 && votes[g][1] != 0;
  if (t == 0) {
    T pw[3];
    for (int i = 0; i < 3; ++i)
      pw[i] = (Ra[3 * i] * fin[0] + Ra[3 * i + 1] * fin[1] + Ra[3 * i + 2] * fin[2]) + ta[i];
    if (rows) {  // alive and moved: the row takes the position where it is valid
      for (int i = 0; i < 3; ++i) a.pos_out[3 * row + i] = good ? pw[i] : a.position[3 * row + i];
      a.init_out[row] = good ? 1 : 0;
      a.fail_out[b] = good ? 0 : 1;
    } else {
      for (int i = 0; i < 3; ++i) a.pos[3 * b + i] = pw[i];
      a.ok[b] = good ? 1 : 0;
    }
    if (store) a.clocks[7] = clock64();
  }
}

// The instantiation for kViews index k (1, 2, 4, 8 views a thread, or rebuilt).
template <typename T, bool kFused>
auto pick(int k) {
  return k == 0 ? triangulate_kernel<T, 1, kFused>
         : k == 1 ? triangulate_kernel<T, 2, kFused>
         : k == 2 ? triangulate_kernel<T, 4, kFused>
         : k == 3 ? triangulate_kernel<T, 8, kFused> : triangulate_kernel<T, 0, kFused>;
}

template <typename T>
int launch(const Args<T>& a, void* stream) {
  static size_t allowed[5] = {0, 0, 0, 0, 0};  // the row entry's kernels
  if (a.N < 1) return (int)cudaErrorInvalidValue;
  const int n_blocks = (a.B + kGroups - 1) / kGroups;
  const int n_copy = a.sel != nullptr ? (a.M + kCopyRows - 1) / kCopyRows : 0;
  if (n_blocks + n_copy == 0) return 0;
  // views a thread holds in registers: 1, 2, 4 or 8; past 256 slots,
  // rebuilt at each use
  const int k = a.N <= 32 ? 0 : a.N <= 64 ? 1 : a.N <= 128 ? 2 : a.N <= 256 ? 3 : 4;
  auto kernel = pick<T, false>(k);
  if (a.sel != nullptr) kernel = pick<T, true>(k);  // the row entry: the fused passes
  // the copy blocks' bitmap of sel
  const size_t smem = n_copy > 0 ? (size_t)(a.M + 31) / 32 * sizeof(uint32_t) : 0;
  const int err = msckf::allow_smem(kernel, smem, &allowed[k]);
  if (err != 0) return err;
  kernel<<<n_blocks + n_copy, kBlock, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
Args<T> common(const void* cam_q, const void* cam_p, int N, const void* obs,
               const void* obs_mask, const void* R_c0c1, const void* t_c0c1, int B,
               double huber_eps, double precision, double damping, int outer_max,
               int inner_max, void* clocks) {
  Args<T> a = {};
  a.cam_q = (const T*)cam_q;
  a.cam_p = (const T*)cam_p;
  a.N = N;
  a.obs = (const T*)obs;
  a.obs_mask = (const uint8_t*)obs_mask;
  a.R_c0c1 = (const T*)R_c0c1;
  a.t_c0c1 = (const T*)t_c0c1;
  a.B = B;
  a.huber_eps = (T)huber_eps;
  a.precision = (T)precision;
  a.damping = (T)damping;
  a.motion_thr = T(-1);
  a.outer_max = outer_max;
  a.inner_max = inner_max;
  a.clocks = (long long*)clocks;
  return a;
}

template <typename T>
int triangulate(const void* cam_q, const void* cam_p, int N, const void* obs,
                const void* obs_mask, const void* R_c0c1, const void* t_c0c1,
                const void* active, int B, double huber_eps, double precision, double damping,
                int outer_max, int inner_max, void* pos, void* ok, void* clocks, void* stream) {
  Args<T> a = common<T>(cam_q, cam_p, N, obs, obs_mask, R_c0c1, t_c0c1, B, huber_eps,
                        precision, damping, outer_max, inner_max, clocks);
  a.active = (const uint8_t*)active;
  a.pos = (T*)pos;
  a.ok = (uint8_t*)ok;
  return launch(a, stream);
}

template <typename T>
int triangulate_rows(const void* cam_q, const void* cam_p, int N, const void* obs,
                     const void* obs_mask, int M, const void* position,
                     const void* initialized, const void* sel, const void* sel_ok, int B,
                     const void* R_c0c1, const void* t_c0c1, double huber_eps,
                     double precision, double damping, int outer_max, int inner_max,
                     double motion_thr, void* pos_out, void* init_out, void* fail_out,
                     void* clocks, void* stream) {
  Args<T> a = common<T>(cam_q, cam_p, N, obs, obs_mask, R_c0c1, t_c0c1, B, huber_eps,
                        precision, damping, outer_max, inner_max, clocks);
  a.motion_thr = (T)motion_thr;
  a.sel = (const int64_t*)sel;
  a.sel_ok = (const uint8_t*)sel_ok;
  a.position = (const T*)position;
  a.initialized = (const uint8_t*)initialized;
  a.M = M;
  a.pos_out = (T*)pos_out;
  a.init_out = (uint8_t*)init_out;
  a.fail_out = (uint8_t*)fail_out;
  return launch(a, stream);
}

}  // namespace

// cam_q, cam_p, N, obs, obs_mask, R_c0c1, t_c0c1, active, B, huber_eps,
// precision, damping, outer_max, inner_max, pos, ok, clocks, stream
#define TRIANGULATE_ENTRY(NAME, T)                                                          \
  extern "C" int NAME(const void* cam_q, const void* cam_p, int N, const void* obs,         \
                      const void* obs_mask, const void* R_c0c1, const void* t_c0c1,         \
                      const void* active, int B, double huber_eps, double precision,        \
                      double damping, int outer_max, int inner_max, void* pos, void* ok,    \
                      void* clocks, void* stream) {                                         \
    return triangulate<T>(cam_q, cam_p, N, obs, obs_mask, R_c0c1, t_c0c1, active, B,        \
                          huber_eps, precision, damping, outer_max, inner_max, pos, ok,     \
                          clocks, stream);                                                  \
  }
TRIANGULATE_ENTRY(triangulate_f32, float)
TRIANGULATE_ENTRY(triangulate_f64, double)

// cam_q, cam_p, N, obs, obs_mask, M, position, initialized, sel, sel_ok, B,
// R_c0c1, t_c0c1, huber_eps, precision, damping, outer_max, inner_max,
// motion_thr (< 0: off), position_out, initialized_out, init_fail_out,
// clocks, stream
#define TRIANGULATE_ROWS_ENTRY(NAME, T)                                                      \
  extern "C" int NAME(const void* cam_q, const void* cam_p, int N, const void* obs,          \
                      const void* obs_mask, int M, const void* position,                     \
                      const void* initialized, const void* sel, const void* sel_ok, int B,   \
                      const void* R_c0c1, const void* t_c0c1, double huber_eps,              \
                      double precision, double damping, int outer_max, int inner_max,        \
                      double motion_thr, void* pos_out, void* init_out, void* fail_out,      \
                      void* clocks, void* stream) {                                          \
    return triangulate_rows<T>(cam_q, cam_p, N, obs, obs_mask, M, position, initialized,     \
                               sel, sel_ok, B, R_c0c1, t_c0c1, huber_eps, precision,         \
                               damping, outer_max, inner_max, motion_thr, pos_out, init_out, \
                               fail_out, clocks, stream);                                    \
  }
TRIANGULATE_ROWS_ENTRY(triangulate_rows_f32, float)
TRIANGULATE_ROWS_ENTRY(triangulate_rows_f64, double)
