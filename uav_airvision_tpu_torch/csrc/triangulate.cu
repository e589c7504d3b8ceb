// K13: feature triangulation by inverse-depth Levenberg-Marquardt, with the
// construction of the views fused in; one warp per feature.
//
// Replaces uav_airvision_tpu/models/msckf/triangulation.py::triangulate
// (:159, in its static form _triangulate_static :235) together with
// build_views (:41).  The JAX package materialises (B, 2N, 3, 3) view
// rotations and vmaps the solve over features.  Here a warp takes one
// feature and each lane one camera slot (both stereo views of it, in
// registers); warp-shuffle sums give the 3x3 normal equations and the
// cost.  The recurrence is the static form's:
//   - at most inner_loop_max_iteration damped solves in total, the inner
//     counter shared across outer iterations;
//   - a new linearisation only at a group start (the first step and after
//     every accepted step), gated by the outer count and the step norm;
//   - Huber weights eps / (2 e), lambda clamped to [1e-10, 1e12], the
//     Cramer 3x3 solve with the |det| > 1e-30 guard;
//   - a feature with active = 0 keeps the closed-form initial guess.
// A warp whose feature has stopped leaves the loop: nothing it holds
// changes after that, so the early exit is exact.
//
// Bound on the card: bytes (a feature reads ~0.5 KB and does ~20 kFLOP),
// both far below a launch; the chain of ~15 dependent warp reductions
// sets its time.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "msckf_common.cuh"

namespace {

constexpr int kWarps = 4;  // features per block
constexpr int kSlots = 2;  // camera slots per lane: N <= 64

template <typename T>
struct View {
  T R[9];  // x_view = R x_anchor + t
  T t[3];
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

// The cam0 and cam1 views of window slot s in the anchor frame.
template <typename T>
__device__ void slot_views(const T* cam_q, const T* cam_p, int s, const T Ra[9],
                           const T ta[3], const T Rc1c0[9], const T tc1c0[3], View<T>& v0,
                           View<T>& v1) {
  T Rw[9], Rc0w[9], Rc1w[9], tc1w[3];
  msckf::to_rotation(cam_q + 4 * s, Rw);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) Rc0w[3 * i + j] = Rw[3 * j + i];
  const T* tc0w = cam_p + 3 * s;
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j)
      Rc1w[3 * i + j] = Rc0w[3 * i] * Rc1c0[j] + Rc0w[3 * i + 1] * Rc1c0[3 + j] +
                        Rc0w[3 * i + 2] * Rc1c0[6 + j];
    tc1w[i] = (Rc0w[3 * i] * tc1c0[0] + Rc0w[3 * i + 1] * tc1c0[1] +
               Rc0w[3 * i + 2] * tc1c0[2]) + tc0w[i];
  }
  rel(Rc0w, tc0w, Ra, ta, v0);
  rel(Rc1w, tc1w, Ra, ta, v1);
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

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
triangulate_kernel(const T* __restrict__ cam_q, const T* __restrict__ cam_p, int N,
                   const T* __restrict__ obs, const uint8_t* __restrict__ obs_mask,
                   const T* __restrict__ R_c0c1, const T* __restrict__ t_c0c1,
                   const uint8_t* __restrict__ active, int B, T huber_eps, T precision,
                   T damping, int outer_max, int inner_max, T* __restrict__ pos,
                   uint8_t* __restrict__ ok) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp
  const T* z_b = obs + (size_t)b * N * 4;
  const uint8_t* m_b = obs_mask + (size_t)b * N;

  // cam1 -> cam0: R_c1_c0 = R_c0c1^T, t_c1_c0 = -R_c0c1^T t_c0c1
  T Rc1c0[9], tc1c0[3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) Rc1c0[3 * i + j] = R_c0c1[3 * j + i];
    tc1c0[i] = (-R_c0c1[i]) * t_c0c1[0] + (-R_c0c1[3 + i]) * t_c0c1[1] +
               (-R_c0c1[6 + i]) * t_c0c1[2];
  }
  // the anchor: the first observing slot's cam0 (slot 0 if none)
  int first = -1;
  for (int s0 = 0; s0 < N; s0 += 32) {
    const int s = s0 + lane;
    const unsigned bal = __ballot_sync(0xffffffffu, s < N && m_b[s] != 0);
    if (bal != 0u && first < 0) first = s0 + __ffs((int)bal) - 1;
  }
  if (first < 0) first = 0;
  T Rw[9], Ra[9], ta[3];
  msckf::to_rotation(cam_q + 4 * first, Rw);
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) Ra[3 * i + j] = Rw[3 * j + i];
    ta[i] = cam_p[3 * first + i];
  }

  // this lane's slots: both views, observations, mask
  View<T> view[kSlots][2];
  T z[kSlots][4];
  bool m[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int s = lane + 32 * k;
    m[k] = s < N && m_b[s] != 0;
    if (m[k]) {
      slot_views(cam_q, cam_p, s, Ra, ta, Rc1c0, tc1c0, view[k][0], view[k][1]);
      for (int c = 0; c < 4; ++c) z[k][c] = z_b[4 * s + c];
    }
  }

  // closed-form initial guess from the anchor slot's stereo pair
  T x[3];
  {
    View<T> v0, v1;
    slot_views(cam_q, cam_p, first, Ra, ta, Rc1c0, tc1c0, v0, v1);
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

  auto total_cost = [&](const T xx[3]) -> T {
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      if (!m[k]) continue;
      for (int c = 0; c < 2; ++c) {
        T h[3];
        project(view[k][c], xx, h);
        const T d0 = h[0] / h[2] - z[k][2 * c], d1 = h[1] / h[2] - z[k][2 * c + 1];
        acc += d0 * d0 + d1 * d1;
      }
    }
    return msckf::warp_sum(acc);
  };

  T lam = damping;
  T cost = total_cost(x);
  bool alive = active == nullptr || active[b] != 0;
  T dnorm = alive ? T(INFINITY) : T(0);
  bool group_start = true;
  int outer = 0;
  T A[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};  // A00 A01 A02 A11 A12 A22
  T bv[3] = {T(0), T(0), T(0)};
  for (int it = 0; it < inner_max; ++it) {
    if (group_start) {
      alive = alive && outer < outer_max && dnorm > precision;
    }
    if (!alive) break;
    if (group_start) {  // Huber-weighted normal equations at x
      T acc[9] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        if (!m[k]) continue;
        for (int c = 0; c < 2; ++c) {
          const View<T>& v = view[k][c];
          T h[3];
          project(v, x, h);
          const T h3 = h[2], hh = h3 * h3;
          const T W0[3] = {v.R[0], v.R[1], v.t[0]}, W1[3] = {v.R[3], v.R[4], v.t[1]};
          const T W2[3] = {v.R[6], v.R[7], v.t[2]};
          T J0[3], J1[3];
          for (int i = 0; i < 3; ++i) {
            J0[i] = W0[i] / h3 - W2[i] * (h[0] / hh);
            J1[i] = W1[i] / h3 - W2[i] * (h[1] / hh);
          }
          const T r0 = h[0] / h3 - z[k][2 * c], r1 = h[1] / h3 - z[k][2 * c + 1];
          const T e = sqrt(r0 * r0 + r1 * r1);
          const T w = e <= huber_eps ? T(1) : huber_eps / (T(2) * e);
          const T w2 = w * w;
          acc[0] += w2 * J0[0] * J0[0] + w2 * J1[0] * J1[0];
          acc[1] += w2 * J0[0] * J0[1] + w2 * J1[0] * J1[1];
          acc[2] += w2 * J0[0] * J0[2] + w2 * J1[0] * J1[2];
          acc[3] += w2 * J0[1] * J0[1] + w2 * J1[1] * J1[1];
          acc[4] += w2 * J0[1] * J0[2] + w2 * J1[1] * J1[2];
          acc[5] += w2 * J0[2] * J0[2] + w2 * J1[2] * J1[2];
          for (int i = 0; i < 3; ++i) acc[6 + i] += w2 * J0[i] * r0 + w2 * J1[i] * r1;
        }
      }
      for (int i = 0; i < 6; ++i) A[i] = msckf::warp_sum(acc[i]);
      for (int i = 0; i < 3; ++i) bv[i] = msckf::warp_sum(acc[6 + i]);
      ++outer;
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
    const T cost_new = total_cost(x_new);
    const bool better = cost_new < cost;
    if (better) {
      for (int i = 0; i < 3; ++i) x[i] = x_new[i];
      cost = cost_new;
      const T l = lam / T(10);
      lam = l < T(1e-10) ? T(1e-10) : l;
    } else {
      const T l = lam * T(10);
      lam = l > T(1e12) ? T(1e12) : l;
    }
    dnorm = dnorm_new;
    group_start = better;
  }

  // back to the world frame; every observing view must see it in front
  const T fin[3] = {x[0] / x[2], x[1] / x[2], T(1) / x[2]};
  bool good = true;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    if (!m[k]) continue;
    for (int c = 0; c < 2; ++c) {
      const View<T>& v = view[k][c];
      const T depth = (v.R[6] * fin[0] + v.R[7] * fin[1] + v.R[8] * fin[2]) + v.t[2];
      good = good && depth > T(0);
    }
  }
  good = __all_sync(0xffffffffu, good);
  if (lane == 0) {
    for (int i = 0; i < 3; ++i)
      pos[3 * b + i] = (Ra[3 * i] * fin[0] + Ra[3 * i + 1] * fin[1] + Ra[3 * i + 2] * fin[2]) + ta[i];
    ok[b] = good ? 1 : 0;
  }
}

template <typename T>
int launch(const void* cam_q, const void* cam_p, int N, const void* obs, const void* obs_mask,
           const void* R_c0c1, const void* t_c0c1, const void* active, int B, double huber_eps,
           double precision, double damping, int outer_max, int inner_max, void* pos, void* ok,
           void* stream) {
  if (N > 32 * kSlots) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  triangulate_kernel<T><<<(B + kWarps - 1) / kWarps, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const T*)cam_q, (const T*)cam_p, N, (const T*)obs, (const uint8_t*)obs_mask,
      (const T*)R_c0c1, (const T*)t_c0c1, (const uint8_t*)active, B, (T)huber_eps,
      (T)precision, (T)damping, outer_max, inner_max, (T*)pos, (uint8_t*)ok);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int triangulate_f32(const void* cam_q, const void* cam_p, int N, const void* obs,
                               const void* obs_mask, const void* R_c0c1, const void* t_c0c1,
                               const void* active, int B, double huber_eps, double precision,
                               double damping, int outer_max, int inner_max, void* pos,
                               void* ok, void* stream) {
  return launch<float>(cam_q, cam_p, N, obs, obs_mask, R_c0c1, t_c0c1, active, B, huber_eps,
                       precision, damping, outer_max, inner_max, pos, ok, stream);
}

extern "C" int triangulate_f64(const void* cam_q, const void* cam_p, int N, const void* obs,
                               const void* obs_mask, const void* R_c0c1, const void* t_c0c1,
                               const void* active, int B, double huber_eps, double precision,
                               double damping, int outer_max, int inner_max, void* pos,
                               void* ok, void* stream) {
  return launch<double>(cam_q, cam_p, N, obs, obs_mask, R_c0c1, t_c0c1, active, B, huber_eps,
                        precision, damping, outer_max, inner_max, pos, ok, stream);
}
