// K9: the per-feature measurement block: stereo reprojection Jacobians of
// every observing camera, row compaction, and the three Householder
// reflections that project [H_f | r | H_x] onto the left nullspace of H_f,
// computed from the block's sparse structure without forming the tile.
//
// Replaces uav_airvision_tpu/models/msckf/update.py::feature_block (:103)
// with stereo_jacobian_per_cam (:48), and the call sites' gathers and
// masks around it (models/msckf/step.py: the lost features' blocks over
// rows ``sel`` of the map, masked by ``proc``; the prune's blocks over the
// two window slots ``rm``).  The JAX package builds the (4N, 4 + D) tile
// with one-hot compaction matmuls and reflects all of it.  Here the tile
// [H_f | r | H_x] is never held: H_x of a slot is nonzero only in the 4
// rows of its rank among the observing slots and its own 6 columns, and
// the reflectors v_j depend only on the 4n x 3 H_f (n observing slots).
// So with s_j = 2 / |v_j|^2 (0 when |v_j|^2 <= 1e-30) and
// w_j = v_j' T_j (T_0 the tile, T_{j+1} = T_j - s_j v_j w_j'):
//   w_j = v_j' T_0 - sum_{k<j} s_k (v_j . v_k) w_k,
//   T_3 = T_0 - sum_j s_j v_j w_j'      (applied as three steps, in order).
// A column of slot s has T_0 nonzero in the slot's 4 rows only: its w_j
// sums v_j' T_j there entry by entry, and adds the other rows' share of
// v_j . v_k (the product less the slot's own 4 rows), so that a one-view
// block, whose result is all cancellation, rounds as the plain version.
// Each block:
//   1. maps its slots to their window slots (``rm``) and its feature to its
//      map row (``sel``), stages their inputs in shared memory in one round
//      trip, and ranks the observing slots (warp ballots);
//   2. one thread per row of each observing slot computes the row of its
//      4x6 H_x (OC-EKF projected: A - (A u) u^T / (u.u), then H_f =
//      -H_x[:, 3:6] taken after the projection), of its 4x3 H_f and of its
//      residual, scrubs non-finite values to 0 and keeps them in shared
//      memory (O(N));
//   3. warp 0 runs the three reflections on the 4n x 4 [H_f | r] (sign +1
//      when x[j] >= 0, no reflection when |v|^2 <= 1e-30), keeping v_j, s_j
//      and the v_j . v_k;
//   4. one thread per H_x column forms w_j from the 4 rows of its slot and
//      the slot's share of the v_j . v_k;
//   5. its share of the output rows 3.. is written in one pass, a warp per
//      row: T_0 - s_0 v_0 w_0' - s_1 v_1 w_1' - s_2 v_2 w_2' (each step
//      rounded as the plain version rounds it), the 21 IMU columns zero,
//      rows past 4 n - 3 exact zeros.
// A fleet's instances are the launch's blockIdx.y: each runs the single
// launch's blocks on its own window, table and rows (every pointer moved by
// the instance's stride), so each instance's blocks are its single
// launch's, bit for bit (JAX backend_step_fleet :875 vmaps feature_block).
// A feature's output rows are split over several blocks that each repeat
// the small prologue, so that a batch of 16 features fills the card; a
// block whose ``proc`` is false writes zeros and rows 0.  Shared memory is
// ~73 N values (N up to ~390 in float64, ~770 in float32).
//
// Bound on the card: bytes.  A feature writes (4N - 3)(21 + 6N) values
// (43 KB at N = 20 in float32); its arithmetic is ~400 FLOP a slot for the
// Jacobians and ~6 an output value.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "msckf_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kImu = 21;  // IMU error-state columns of H_x
constexpr int kRowsPerBlock = 8;  // the least share of output rows a split block takes
constexpr int kStrides = 14;      // the per-instance pointers of Args

// Row i (0-1: cam0's u, v; 2-3: cam1's) of H_x (6), H_f (3) and r of one
// stereo observation z of the point p_w from window slot s
// (update.py::stereo_jacobian); the four rows of a slot share everything
// up to the camera's d p_c / d x_cam, which each row's thread repeats.
template <typename T>
__device__ void slot_jacobian_row(const T q[4], const T cp[3], const T qn[4], const T cpn[3],
                                  const T p[3], const T z[4], const T g[3], const T Rc[9],
                                  const T tc[3], int i, T Hx[6], T Hf[3], T& r) {
  T R0[9], R1[9], t1[3], pc0[3], pc1[3];
  msckf::to_rotation(q, R0);  // world -> cam0
  for (int a = 0; a < 3; ++a)
    for (int j = 0; j < 3; ++j)
      R1[3 * a + j] = Rc[3 * a] * R0[j] + Rc[3 * a + 1] * R0[3 + j] + Rc[3 * a + 2] * R0[6 + j];
  for (int a = 0; a < 3; ++a)
    t1[a] = cp[a] - (R1[a] * tc[0] + R1[3 + a] * tc[1] + R1[6 + a] * tc[2]);
  const T d0[3] = {p[0] - cp[0], p[1] - cp[1], p[2] - cp[2]};
  const T d1[3] = {p[0] - t1[0], p[1] - t1[1], p[2] - t1[2]};
  for (int a = 0; a < 3; ++a) {
    pc0[a] = R0[3 * a] * d0[0] + R0[3 * a + 1] * d0[1] + R0[3 * a + 2] * d0[2];
    pc1[a] = R1[3 * a] * d1[0] + R1[3 * a + 1] * d1[1] + R1[3 * a + 2] * d1[2];
  }
  const bool cam1 = i >= 2;
  // the row's coordinate (x for u, y for v) and depth in its camera
  const T pxy = cam1 ? ((i & 1) ? pc1[1] : pc1[0]) : ((i & 1) ? pc0[1] : pc0[0]);
  const T iz = T(1) / (cam1 ? pc1[2] : pc0[2]);
  // d z_i / d p_c: (iz, 0, -x iz^2) for u, (0, iz, -y iz^2) for v
  const T dz[3] = {(i & 1) ? T(0) : iz, (i & 1) ? iz : T(0), -pxy * iz * iz};
  // d p_c / d x_cam = [skew(p_c0) | -R] for cam0, [R_c0c1 skew(p_c0) | -R1] for cam1
  const T sk[9] = {T(0), -pc0[2], pc0[1], pc0[2], T(0), -pc0[0], -pc0[1], pc0[0], T(0)};
  T dp[3][6];
  for (int a = 0; a < 3; ++a)
    for (int c = 0; c < 3; ++c) {
      dp[a][c] = cam1 ? Rc[3 * a] * sk[c] + Rc[3 * a + 1] * sk[3 + c] + Rc[3 * a + 2] * sk[6 + c]
                      : sk[3 * a + c];
      dp[a][3 + c] = cam1 ? -R1[3 * a + c] : -R0[3 * a + c];
    }
  T A[6];
  for (int c = 0; c < 6; ++c) A[c] = dz[0] * dp[0][c] + dz[1] * dp[1][c] + dz[2] * dp[2][c];
  // OC-EKF: u = [R(q_null) g, skew(p - p_null) g]
  T Rn[9], u[6];
  msckf::to_rotation(qn, Rn);
  for (int a = 0; a < 3; ++a) u[a] = Rn[3 * a] * g[0] + Rn[3 * a + 1] * g[1] + Rn[3 * a + 2] * g[2];
  const T dn[3] = {p[0] - cpn[0], p[1] - cpn[1], p[2] - cpn[2]};
  u[3] = -dn[2] * g[1] + dn[1] * g[2];
  u[4] = dn[2] * g[0] - dn[0] * g[2];
  u[5] = -dn[1] * g[0] + dn[0] * g[1];
  T uu = T(0);
  for (int c = 0; c < 6; ++c) uu += u[c] * u[c];
  T au = T(0);
  for (int c = 0; c < 6; ++c) au += A[c] * u[c];
  for (int c = 0; c < 6; ++c) Hx[c] = A[c] - au * u[c] / uu;
  for (int c = 0; c < 3; ++c) Hf[c] = -Hx[3 + c];
  r = z[i] - pxy * iz;
}

template <typename T>
__device__ inline T finite_or_zero(T v) {
  return isfinite(v) ? v : T(0);
}

template <typename T>
struct Args {
  const T *cams_q, *cams_p, *cams_qn, *cams_pn;  // (Nw, 4) / (Nw, 3) window slots
  const int64_t* rm;      // (N,) window slot of each block slot, or null (slot s = s)
  int N, Nw;              // slots of a block, slots of the window (obs' row length)
  const T* obs;           // (M, Nw, 4)
  const uint8_t* obs_mask;  // (M, Nw)
  const T* p_w;           // (M, 3)
  const int64_t* sel;     // (B,) map row of each block, or null (block b = row b)
  const uint8_t* proc;    // (B,) blocks to compute, or null (all)
  const T *gravity, *R_c0c1, *t_c0c1;
  int B, split;           // blocks of features; blocks per feature (the launcher's)
  T *H_out, *r_out;       // (B, 4N - 3, 21 + 6N), (B, 4N - 3)
  int* rows_out;          // (B,)
  long long* clocks;      // (6,) SM clocks of block 0's phases, or null
  // instance b (blockIdx.y) of a fleet: cams_q, cams_p, cams_qn, cams_pn,
  // rm, obs, obs_mask, p_w, sel, proc, gravity, H_out, r_out and rows_out
  // moved by b times their strides (elements of their types)
  long long stride[kStrides];
};

// Instance b's arguments; only instance 0 stamps the clocks.
template <typename T>
__device__ Args<T> instance_args(Args<T> a, int b) {
  const long long* s = a.stride;
  a.cams_q += b * s[0];
  a.cams_p += b * s[1];
  a.cams_qn += b * s[2];
  a.cams_pn += b * s[3];
  if (a.rm != nullptr) a.rm += b * s[4];
  a.obs += b * s[5];
  a.obs_mask += b * s[6];
  a.p_w += b * s[7];
  if (a.sel != nullptr) a.sel += b * s[8];
  if (a.proc != nullptr) a.proc += b * s[9];
  a.gravity += b * s[10];
  a.H_out += b * s[11];
  a.r_out += b * s[12];
  a.rows_out += b * s[13];
  if (b != 0) a.clocks = nullptr;
  return a;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) feature_block_kernel(const Args<T> batch) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  const Args<T> a = instance_args(batch, (int)blockIdx.y);
  const int N = a.N, R = 4 * N, out_rows = R - 3, D = kImu + 6 * N;
  const int b = blockIdx.x / a.split, part = blockIdx.x % a.split;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // this block's output rows
  const int per = (out_rows + a.split - 1) / a.split;
  const int i0 = min(part * per, out_rows), i1 = min(i0 + per, out_rows);
  T* Hb = a.H_out + (size_t)b * out_rows * D;
  T* rb = a.r_out + (size_t)b * out_rows;

  if (a.proc != nullptr && !a.proc[b]) {  // a masked block: zeros, rows 0
    for (size_t e = (size_t)i0 * D + tid; e < (size_t)i1 * D; e += kThreads) Hb[e] = T(0);
    for (int i = i0 + tid; i < i1; i += kThreads) rb[i] = T(0);
    if (part == 0 && tid == 0) a.rows_out[b] = 0;
    return;
  }

  T* sHx = reinterpret_cast<T*>(dyn_smem);  // (n, 4, 6) by rank
  T* sA = sHx + 24 * N;                      // (4, 4N): [H_f | r] by rank, by column
  T* sV = sA + 4 * R;                        // (3, 4N): the reflectors
  T* sW = sV + 3 * R;                        // (3, 6N): w_j of the H_x columns
  T* sP = sW + 18 * N;                       // (n, 3): a slot's rows' share of the v_j . v_k
  int* rank = reinterpret_cast<int*>(sP + 3 * N);  // (N,)
  __shared__ T s_scale[3], s_g[3];  // s_j; v_1.v_0, v_2.v_0, v_2.v_1
  __shared__ int s_nobs;

  // the inputs, staged in one round trip after sel: per slot q, p, q_null,
  // p_null and z (18 values, in sW's room, free until step 4), the point,
  // gravity and the stereo extrinsics
  T* sIn = sW;
  __shared__ T s_com[18];  // p_w, gravity, R_c0c1, t_c0c1
  const bool timed = a.clocks != nullptr && blockIdx.x == 0 && tid == 0;
  if (timed) a.clocks[0] = clock64();
  const int64_t f = a.sel != nullptr ? a.sel[b] : b;
  for (int s = tid; s < N; s += kThreads) {
    const int w = a.rm != nullptr ? (int)a.rm[s] : s;
    T* in = sIn + 18 * s;
    for (int e = 0; e < 4; ++e) in[e] = a.cams_q[4 * w + e];
    for (int e = 0; e < 3; ++e) in[4 + e] = a.cams_p[3 * w + e];
    for (int e = 0; e < 4; ++e) in[7 + e] = a.cams_qn[4 * w + e];
    for (int e = 0; e < 3; ++e) in[11 + e] = a.cams_pn[3 * w + e];
    for (int e = 0; e < 4; ++e) in[14 + e] = a.obs[((size_t)f * a.Nw + w) * 4 + e];
    rank[s] = a.obs_mask[(size_t)f * a.Nw + w];
  }
  if (tid >= kThreads - 18) {
    const int e = tid - (kThreads - 18);
    s_com[e] = e < 3 ? a.p_w[3 * f + e]
                     : (e < 6 ? a.gravity[e - 3] : (e < 15 ? a.R_c0c1[e - 6] : a.t_c0c1[e - 15]));
  }
  __syncthreads();
  if (warp == 0) {  // 1. the observing slots' ranks, 32 slots a ballot
    int base = 0;
    for (int s0 = 0; s0 < N; s0 += 32) {
      const int s = s0 + lane;
      const bool seen = s < N && rank[s] != 0;
      const unsigned bal = __ballot_sync(0xffffffffu, seen);
      if (s < N) rank[s] = seen ? base + __popc(bal & ((1u << lane) - 1u)) : -1;
      base += __popc(bal);
    }
    if (lane == 0) s_nobs = base;
  }
  __syncthreads();
  if (timed) a.clocks[1] = clock64();
  const int n = s_nobs, R4 = 4 * n;

  // 2. each observing slot's Jacobians and residual, a thread per row,
  //    scrubbed
  for (int t = tid; t < 4 * N; t += kThreads) {
    const int s = t >> 2, i = t & 3, k = rank[s];
    if (k < 0) continue;
    const T* in = sIn + 18 * s;
    T Hx[6], Hf[3], r;
    slot_jacobian_row(in, in + 4, in + 7, in + 11, s_com, in + 14, s_com + 3, s_com + 6,
                      s_com + 15, i, Hx, Hf, r);
    for (int c = 0; c < 6; ++c) sHx[24 * k + 6 * i + c] = finite_or_zero(Hx[c]);
    for (int c = 0; c < 3; ++c) sA[c * R + 4 * k + i] = finite_or_zero(Hf[c]);
    sA[3 * R + 4 * k + i] = finite_or_zero(r);
  }
  __syncthreads();
  if (timed) a.clocks[2] = clock64();

  // 3. warp 0: the three reflections of [H_f | r] (rows past 4n are zero
  //    throughout, and so are the reflectors there).  One pass over the
  //    rows gives |x|^2 and x . A[:, c] together; |v|^2 and v . A[:, c] then
  //    follow from them and row j, so each reflection takes one warp
  //    reduction (of five sums) instead of three in a row.
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T part[5] = {T(0), T(0), T(0), T(0), T(0)};
      for (int r = lane + j; r < R4; r += 32) {
        const T x = sA[j * R + r];
        part[0] += x * x;
        for (int c = 0; c < 4; ++c) part[1 + c] += x * sA[c * R + r];
      }
      T aj[4] = {T(0), T(0), T(0), T(0)};  // row j before the reflection
      if (j < R4)
        for (int c = 0; c < 4; ++c) aj[c] = sA[c * R + j];
      for (int o = 16; o > 0; o >>= 1)
        for (int c = 0; c < 5; ++c) part[c] += __shfl_xor_sync(0xffffffffu, part[c], o);
      const T normx = sqrt(part[0]), xj = aj[j];  // j is static: the loop is unrolled
      const T signed_norm = (xj >= T(0) ? T(1) : T(-1)) * normx;
      const T vj = xj + signed_norm;
      const T vnorm2 = (part[0] - xj * xj) + vj * vj;
      const T scale = vnorm2 > T(1e-30) ? T(2) / vnorm2 : T(0);
      T w4[4];
      for (int c = 0; c < 4; ++c) w4[c] = part[1 + c] + signed_norm * aj[c];
      for (int r = lane; r < R4; r += 32) {
        const T v = r < j ? T(0) : (r == j ? vj : sA[j * R + r]);
        sV[j * R + r] = v;
        for (int c = 0; c < 4; ++c) sA[c * R + r] = sA[c * R + r] - scale * (v * w4[c]);
      }
      for (int r = R4 + lane; r < R; r += 32) sV[j * R + r] = T(0);
      if (lane == 0) s_scale[j] = scale;
      __syncwarp();
    }
    // v_j . v_k as the sum over slots of each slot's 4 rows (a lone slot's
    // share is then the whole product, exactly)
    T g[3] = {T(0), T(0), T(0)};
    for (int k = lane; k < n; k += 32) {
      T p[3] = {T(0), T(0), T(0)};
      for (int i = 4 * k; i < 4 * k + 4; ++i) {
        const T v0 = sV[i], v1 = sV[R + i], v2 = sV[2 * R + i];
        p[0] += v1 * v0;
        p[1] += v2 * v0;
        p[2] += v2 * v1;
      }
      for (int c = 0; c < 3; ++c) {
        sP[3 * k + c] = p[c];
        g[c] += p[c];
      }
    }
    for (int o = 16; o > 0; o >>= 1)
      for (int c = 0; c < 3; ++c) g[c] += __shfl_xor_sync(0xffffffffu, g[c], o);
    if (lane == 0)
      for (int c = 0; c < 3; ++c) s_g[c] = g[c];
  }
  __syncthreads();
  if (timed) a.clocks[3] = clock64();

  // 4. w_j of each H_x column, from the 4 rows of its slot
  const T s0 = s_scale[0], s1 = s_scale[1], s2 = s_scale[2];
  for (int c = tid; c < 6 * N; c += kThreads) {
    const int s = c / 6, cc = c - 6 * s, k = rank[s];
    T w0 = T(0), w1 = T(0), w2 = T(0);
    if (k >= 0) {
      // v_j' T_j over the slot's 4 rows, T_j's entries rounded as the
      // plain version rounds them; the other rows' share of T_j's column
      // is -sum_{l<j} s_l v_l w_l there, so they add -s_l w_l (v_j . v_l
      // less the slot's share)
      const T* h = sHx + 24 * k + cc;
      const T* v = sV + 4 * k;
      for (int i = 0; i < 4; ++i) w0 += v[i] * h[6 * i];
      for (int i = 0; i < 4; ++i) w1 += v[R + i] * (h[6 * i] - s0 * (v[i] * w0));
      w1 = w1 - s0 * (w0 * (s_g[0] - sP[3 * k]));
      for (int i = 0; i < 4; ++i)
        w2 += v[2 * R + i] * ((h[6 * i] - s0 * (v[i] * w0)) - s1 * (v[R + i] * w1));
      w2 = (w2 - s0 * (w0 * (s_g[1] - sP[3 * k + 1]))) - s1 * (w1 * (s_g[2] - sP[3 * k + 2]));
    }
    sW[c] = w0;
    sW[6 * N + c] = w1;
    sW[12 * N + c] = w2;
  }
  __syncthreads();
  if (timed) a.clocks[4] = clock64();

  // 5. this block's rows: a warp per row, the lanes along its columns
  for (int i = i0 + warp; i < i1; i += kThreads / 32) {
    const int t = i + 3;  // the tile's row
    T* Hrow = Hb + (size_t)i * D;
    if (t >= R4) {
      for (int c = lane; c < D; c += 32) Hrow[c] = T(0);
      if (lane == 0) rb[i] = T(0);
      continue;
    }
    const int k = t >> 2, ii = t & 3;
    const T v0 = sV[t], v1 = sV[R + t], v2 = sV[2 * R + t];
    for (int c = lane; c < D; c += 32) {
      T out = T(0);
      if (c >= kImu) {
        const int cx = c - kImu, s = cx / 6;
        out = rank[s] == k ? sHx[24 * k + 6 * ii + (cx - 6 * s)] : T(0);
        out = out - s0 * (v0 * sW[cx]);
        out = out - s1 * (v1 * sW[6 * N + cx]);
        out = out - s2 * (v2 * sW[12 * N + cx]);
      }
      Hrow[c] = out;
    }
    if (lane == 0) rb[i] = sA[3 * R + t];
  }
  if (part == 0 && tid == 0) a.rows_out[b] = 4 * n - 3;
  if (timed) a.clocks[5] = clock64();
}

template <typename T>
size_t smem_bytes(int N) {
  return (size_t)73 * N * sizeof(T) + (size_t)N * sizeof(int);
}

template <typename T>
int launch(const Args<T>& a, int n_inst, void* stream) {
  static size_t smem_allowed = 0;
  if (a.N < 1 || a.Nw < 1 || a.B < 0 || n_inst < 1 || n_inst > 65535)
    return (int)cudaErrorInvalidValue;
  if (a.B == 0) return 0;
  Args<T> k = a;
  // a feature's rows over enough blocks for two an SM, each block at least
  // kRowsPerBlock rows (at B = 16, N = 20: 10 blocks a feature, measured
  // faster than 1, 2, 4 or 8); the rows' values do not depend on the split
  const int out_rows = 4 * a.N - 3, feats = a.B * n_inst;
  k.split = max(1, min((264 + feats - 1) / feats, (out_rows + kRowsPerBlock - 1) / kRowsPerBlock));
  const size_t smem = smem_bytes<T>(a.N);
  const int err = msckf::allow_smem(feature_block_kernel<T>, smem, &smem_allowed);
  if (err != 0) return err;
  const dim3 grid((unsigned)a.B * k.split, (unsigned)n_inst);
  feature_block_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(k);
  return (int)cudaGetLastError();
}

template <typename T>
int entry(const void* cams_q, const void* cams_p, const void* cams_qn, const void* cams_pn,
          const void* rm, int N, int Nw, const void* obs, const void* obs_mask, const void* p_w,
          const void* sel, const void* proc, const void* gravity, const void* R_c0c1,
          const void* t_c0c1, int B, void* H_out, void* r_out, void* rows_out, int n_inst,
          const void* strides, void* clocks, void* stream) {
  Args<T> a{(const T*)cams_q,   (const T*)cams_p,        (const T*)cams_qn,
            (const T*)cams_pn,  (const int64_t*)rm,      N,
            Nw,                 (const T*)obs,           (const uint8_t*)obs_mask,
            (const T*)p_w,      (const int64_t*)sel,     (const uint8_t*)proc,
            (const T*)gravity,  (const T*)R_c0c1,        (const T*)t_c0c1,
            B,                  0,                       (T*)H_out,
            (T*)r_out,          (int*)rows_out,          (long long*)clocks,
            {}};
  const long long* st = (const long long*)strides;
  for (int k = 0; k < kStrides; ++k) a.stride[k] = st != nullptr ? st[k] : 0;
  return launch(a, n_inst, stream);
}

}  // namespace

// rm, sel, proc, strides (null for one instance) and clocks may be null;
// strides: kStrides int64 on the host, in the order of Args::stride.
#define FEATURE_BLOCK_ENTRY(NAME, T)                                                          \
  extern "C" int NAME(const void* cams_q, const void* cams_p, const void* cams_qn,            \
                      const void* cams_pn, const void* rm, int N, int Nw, const void* obs,    \
                      const void* obs_mask, const void* p_w, const void* sel,                 \
                      const void* proc, const void* gravity, const void* R_c0c1,              \
                      const void* t_c0c1, int B, void* H_out, void* r_out, void* rows_out,    \
                      int n_inst, const void* strides, void* clocks, void* stream) {          \
    return entry<T>(cams_q, cams_p, cams_qn, cams_pn, rm, N, Nw, obs, obs_mask, p_w, sel,     \
                    proc, gravity, R_c0c1, t_c0c1, B, H_out, r_out, rows_out, n_inst,         \
                    strides, clocks, stream);                                                 \
  }
FEATURE_BLOCK_ENTRY(feature_block_f32, float)
FEATURE_BLOCK_ENTRY(feature_block_f64, double)
