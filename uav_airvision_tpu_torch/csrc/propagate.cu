// K14: IMU propagation of the MSCKF state and covariance in one launch:
// block 0 (512 threads) propagates, in the JAX package's four phases; the
// launch's other blocks symmetrise the covariance's trailing block.  A
// fleet's instances are the launch's blockIdx.y, each a group of blocks
// that runs the single launch's code on its own state (every pointer moved
// by the instance's stride), so each instance's result is its single
// launch's, bit for bit (JAX backend_step_fleet :875 vmaps propagate).
//
// Replaces uav_airvision_tpu/models/msckf/propagation.py::propagate (with
// _omega_mat :67; the PROP_TIER slicing of propagate_tiered :36 is a TPU
// work-size tier whose result is identical, so it has no counterpart).
// Only the slots up to the last valid one (L of them) are touched: the
// slots past it are masked, and a masked slot is the identity of every
// phase.  The inputs (the IMU slice, the state, qc) are staged in shared
// memory first, in one round trip for the whole block.
//
// A. The state chain, by the block in steps a barrier apart (a thread a
//    task, a warp's lanes on one kind of task): dt, gyro, acc and the
//    closed-form integrators M_full (identity where masked) and M_half;
//    the orientations as the prefix products P_i <- P_i P_{i-d},
//    d = 1, 2, 4, ... (the port's plain version's Hillis-Steele order), an
//    entry a task, normalised; the five rotations of a sample (R(q_at),
//    R(dq_half), R(dq_full), R(q_null), R(q_next)) a task each, with the
//    RK4 stage each feeds; v and p as sequential sums (torch.cumsum's
//    order, accumulated in double as the host's cumsum does); per sample
//    the ingredients of its transition: F's 3x3 blocks, R(q_next)
//    R(q_null)^T and the OC-EKF constraint vectors, the anchors of sample
//    i being the state after sample i - 1.
// B. Phi_i and Q_i, a warp per sample.  Both are kept as their leading
//    15x15 blocks: rows and columns 15-20 (the extrinsics) of every Phi_i
//    are the identity's and of every Q_i zero, and stay so under
//    composition.  F is block-sparse (A = -[gyro]x, -I, B = -R^T [acc]x,
//    C = -R^T, I, each times dt), so F dt^2 and F dt^3 come block by block
//    rather than as dense 21x21 products, summed in the plain version's
//    order ((I + F dt) + (F dt)^2 / 2) + (F dt)^3 / 6; then the
//    R(q_next) R(q_null)^T block and the two constraint corrections, and
//    Q = (Phi G diag(qc)) (Phi G)^T dt with G's blocks (-I, I, -R^T, I).
// C. The pairwise fold (Phi_b Phi_a, (Phi_b Q_a) Phi_b^T + Q_b) of adjacent
//    pairs, level by level: the association of the plain version and of
//    the JAX package's fold.  It runs over the next power of two above L
//    only: the identity slots past it compose exactly (I X = X, X + 0 = X),
//    so the result is the 64-slot tree's.  Leaves are built and folded 16
//    at a time (a warp each); past 16 the chunks' roots, the tree's
//    level-4 nodes, fold in turn.  A thread computes a 3x3 tile, the
//    tiles of one unrolled dot on one warp.
// D. The covariance: P_ii = (Phi P_ii) Phi^T + Q and its symmetrisation;
//    P_ic = Phi P[:21, 21:] once, written to both halves (its transpose
//    through a shared-memory tile); (x + x) / 2 = x, so the symmetrisation
//    leaves P_ic as it is.  The trailing block, (P + P^T) / 2 of rows and
//    columns from 21 on, is the other blocks' work, on other SMs.
// The matrix products (the fold, Q, the covariance) use fused
// multiply-adds; the elementwise chain keeps the plain version's
// operations (the build's -fmad=false).
//
// The staged inputs, the slots (Slot<T>, 163 values each) and the chunk
// roots sit in shared memory after the fixed 24 nodes of phases B-D, or,
// past a block's shared memory (I > ~90 slots in float64), in a device
// workspace the wrapper allocates (models/msckf/propagation.py mirrors
// this layout).
//
// Bound on the card: latency.  A dependent chain over the samples (a
// log-depth scan, then the sequential sums), then log2(L) levels of two
// dependent 15x15 products each, each step a block barrier apart; the
// covariance pass reads and writes D^2 values once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "msckf_common.cuh"

namespace {

constexpr int kD = 21;            // IMU error-state dimension
constexpr int kN = 15;            // the non-trivial block of Phi and Q
constexpr int kNN = kN * kN;
constexpr int kNode = 2 * kNN;    // a (Phi, Q) node: Phi, then Q
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

constexpr int kChunk = kWarps;    // leaves built and folded at once
constexpr int kTemps = kChunk / 2;  // a fold level's products, per pair
constexpr int kFixed = (kChunk + kTemps) * kNode;  // values of phases B-D
constexpr int kTile = 16;         // the trailing symmetrisation's tiles
constexpr int kLeafScratch = kN * 12;  // a warp's Phi G (and 3x3 blocks) scratch
constexpr int kStrides = 20;       // the per-instance pointers of Args
constexpr int kState = 48;        // the state's 30 values and qc's 12, padded

static_assert(kWarps * 2 * kTile * (kTile + 1) <= kFixed, "tiles fit");
static_assert(kChunk * kLeafScratch <= kTemps * kNode, "leaf scratch fits the temps");

using msckf::quat_normalize;
using msckf::to_rotation;

// One IMU sample's state-chain values (163 values: an odd stride, so that
// threads reading their own slot hit distinct banks).
template <typename T>
struct Slot {
  T Mf[16], Mh[16];  // the integrators over dt and dt / 2 (M_full, M_half)
  T P[2][16];        // prefix products, ping-pong
  T q_next[4], v_next[3], p_next[3];
  T k[3][3];         // RK4: k1, k2, k4
  T dv[3], kk[3];    // RK4: dv and k1 + 2 k2
  T dt, gyro[3], acc[3], m;
  T skg[9];    // skew(gyro)
  T RtSa[9];   // R_at^T skew(acc)
  T Rt[9];     // R_at^T
  T Phi00[9];  // R(q_next) R(q_null)^T
  T R2[2][9];  // R(q_null), R(q_next)
  T u[3], s[3], w1[3], w2[3];
};

template <typename T>
struct Args {
  const T *t, *w, *a;
  const uint8_t* mask;
  int I;
  // the state: q (4), p, v, bg, ba (3 each), q_null (4), p_null, v_null,
  // timestamp (1), gravity (3); the sequence id
  const T *q, *p, *v, *bg, *ba, *qn, *pn, *vn, *ts, *g;
  const int32_t* sid;
  const T* qc;
  const T* cov;
  int D;
  // q 0..3, v 4..6, p 7..9, timestamp 10, q_null 11..14, v_null 15..17,
  // p_null 18..20
  T* out;
  int32_t* sid_out;
  T* cov_out;
  T* work;  // the inputs, slots and roots, when shared memory cannot hold them
  long long* clocks;  // null, or 10 SM clock readings (tools/kernel_probe.py)
  // instance b (blockIdx.y) of a batch: every pointer above, in this order
  // (t, w, a, mask, q .. g, sid, cov, out, sid_out, cov_out, work), moved by
  // b times its stride, in elements of its type
  long long stride[kStrides];
};

// Instance b's arguments; only instance 0 stamps the clocks.
template <typename T>
__device__ Args<T> instance_args(Args<T> a, int b) {
  const long long* s = a.stride;
  a.t += b * s[0];
  a.w += b * s[1];
  a.a += b * s[2];
  a.mask += b * s[3];
  a.q += b * s[4];
  a.p += b * s[5];
  a.v += b * s[6];
  a.bg += b * s[7];
  a.ba += b * s[8];
  a.qn += b * s[9];
  a.pn += b * s[10];
  a.vn += b * s[11];
  a.ts += b * s[12];
  a.g += b * s[13];
  a.sid += b * s[14];
  a.cov += b * s[15];
  a.out += b * s[16];
  a.sid_out += b * s[17];
  a.cov_out += b * s[18];
  if (a.work != nullptr) a.work += b * s[19];
  if (b != 0) a.clocks = nullptr;
  return a;
}

// The inputs staged once: the IMU slice (t, w, a, the mask as 0/1), the
// state at these offsets of ``st``, qc.
enum : int { kQ = 0, kP = 4, kV = 7, kBg = 10, kBa = 13, kQn = 16, kPn = 20, kVn = 23,
             kTs = 26, kG = 27, kQc = 30 };

template <typename T>
struct In {
  const T *t, *w, *a, *m, *st;
};

// _omega_mat: q(t+dt) = M q(t) for gyro g over half_dt.
template <typename T>
__device__ void omega_mat(const T g[3], T half_dt, T M[16]) {
  const T n = sqrt(g[0] * g[0] + g[1] * g[1] + g[2] * g[2]);
  // Omega = [[-skew(g), g], [-g^T, 0]]
  const T Om[16] = {T(0), g[2], -g[1], g[0],  -g[2], T(0), g[0], g[1],
                    g[1], -g[0], T(0), g[2],  -g[0], -g[1], -g[2], T(0)};
  const T c = cos(n * half_dt);
  if (n > T(1e-5)) {
    const T s = sin(n * half_dt) / n;
    for (int k = 0; k < 16; ++k) M[k] = c * ((k % 5 == 0) ? T(1) : T(0)) + s * Om[k];
  } else {
    for (int k = 0; k < 16; ++k) M[k] = c * (((k % 5 == 0) ? T(1) : T(0)) + Om[k] * half_dt);
  }
}

template <typename T>
__device__ void mat4vec(const T M[16], const T v[4], T out[4]) {
  for (int i = 0; i < 4; ++i)
    out[i] = M[4 * i] * v[0] + M[4 * i + 1] * v[1] + M[4 * i + 2] * v[2] + M[4 * i + 3] * v[3];
}

template <typename T>
__device__ void rt_mul(const T R[9], const T a[3], const T g[3], T out[3]) {
  // R^T a + g
  for (int i = 0; i < 3; ++i) out[i] = (R[i] * a[0] + R[3 + i] * a[1] + R[6 + i] * a[2]) + g[i];
}

template <typename T>
__device__ void skew_mul(const T v[3], const T g[3], T out[3]) {
  // skew(v) @ g = v x g
  out[0] = -v[2] * g[1] + v[1] * g[2];
  out[1] = v[2] * g[0] - v[0] * g[2];
  out[2] = -v[1] * g[0] + v[0] * g[1];
}

__device__ __forceinline__ void stamp(long long* clocks, int k) {
  if (clocks && threadIdx.x == 0) clocks[k] = clock64();
}


// Tasks of K kinds over n items, numbered so that a warp's lanes share a
// kind (each kind's items rounded up to whole warps): task e is item
// e % round_up(n, 32) of kind e / round_up(n, 32), idle past n.
__device__ __forceinline__ int round_warp(int n) { return (n + 31) & ~31; }

// ---- phase A: the state chain of the slots [0, L), by the block in steps
// a barrier apart, each step's tasks a thread each (a task's own dependent
// chain stays short: one integrator, one rotation, one product entry), a
// warp's lanes on one kind of task.
template <typename T>
__device__ void state_chain(const In<T>& in, Slot<T>* S, int L, long long* clocks) {
  const int tid = threadIdx.x;
  const T* st = in.st;
  const int Lr = round_warp(L);
  // 1. the samples and their integrators: a task per (slot, M_full | M_half)
  for (int e = tid; e < 2 * Lr; e += kThreads) {
    const int i = e % Lr;
    if (i >= L) continue;
    Slot<T>& s = S[i];
    const bool m = in.m[i] != T(0);
    const T dt = m ? in.t[i] - (i == 0 ? st[kTs] : in.t[i - 1]) : T(0);
    T gyro[3];
    for (int k = 0; k < 3; ++k) gyro[k] = m ? in.w[3 * i + k] - st[kBg + k] : T(0);
    if (e >= Lr) {
      omega_mat(gyro, dt * T(0.25), s.Mh);  // identity where masked (gyro 0, dt 0)
    } else {
      s.m = m ? T(1) : T(0);
      s.dt = dt;
      for (int k = 0; k < 3; ++k) {
        s.gyro[k] = gyro[k];
        s.acc[k] = m ? in.a[3 * i + k] - st[kBa + k] : T(0);
      }
      if (m) {
        omega_mat(gyro, dt * T(0.5), s.Mf);
      } else {
        for (int k = 0; k < 16; ++k) s.Mf[k] = (k % 5 == 0) ? T(1) : T(0);
      }
    }
  }
  __syncthreads();
  stamp(clocks, 2);
  // 2. prefix products P_i = M_i ... M_0: P_i <- P_i P_{i-d}, an entry a task
  int src = -1;  // -1: Mf, else P[src]
  for (int d = 1; d < L; d *= 2) {
    const int dst = src == 0 ? 1 : 0;
    for (int e = tid; e < 16 * L; e += kThreads) {
      const int i = e >> 4, ent = e & 15, r = ent >> 2, cc = ent & 3;
      const T* x = src < 0 ? S[i].Mf : S[i].P[src];
      T v = x[ent];
      if (i >= d) {
        const T* z = src < 0 ? S[i - d].Mf : S[i - d].P[src];
        v = x[4 * r] * z[cc] + x[4 * r + 1] * z[4 + cc] + x[4 * r + 2] * z[8 + cc] +
            x[4 * r + 3] * z[12 + cc];
      }
      S[i].P[dst][ent] = v;
    }
    __syncthreads();
    src = dst;
  }
  for (int i = tid; i < L; i += kThreads) {
    T qn[4];
    mat4vec(src < 0 ? S[i].Mf : S[i].P[src], st + kQ, qn);
    quat_normalize(qn);
    for (int k = 0; k < 4; ++k) S[i].q_next[k] = qn[k];
  }
  __syncthreads();
  stamp(clocks, 3);
  // 3. the rotations: a task per (slot, R_at | R(dq_half) | R(dq_full) |
  //    R(q_null) | R(q_next)), with the RK4 stage each feeds
  for (int e = tid; e < 5 * Lr; e += kThreads) {
    const int i = e % Lr, which = e / Lr;
    if (i >= L) continue;
    Slot<T>& s = S[i];
    const T* q_at = i == 0 ? st + kQ : S[i - 1].q_next;
    T R[9];
    if (which == 0) {
      to_rotation(q_at, R);
      rt_mul(R, s.acc, st + kG, s.k[0]);
      const T* gy = s.gyro;
      const T* ac = s.acc;
      const T sk[9] = {T(0), -gy[2], gy[1], gy[2], T(0), -gy[0], -gy[1], gy[0], T(0)};
      const T sa[9] = {T(0), -ac[2], ac[1], ac[2], T(0), -ac[0], -ac[1], ac[0], T(0)};
      for (int r = 0; r < 3; ++r)
        for (int cc = 0; cc < 3; ++cc) {
          s.skg[3 * r + cc] = sk[3 * r + cc];
          s.Rt[3 * r + cc] = R[3 * cc + r];
          s.RtSa[3 * r + cc] = (R[r] * sa[cc] + R[3 + r] * sa[3 + cc]) + R[6 + r] * sa[6 + cc];
        }
    } else if (which <= 2) {
      T dq[4];
      mat4vec(which == 1 ? s.Mh : s.Mf, q_at, dq);
      to_rotation(dq, R);
      rt_mul(R, s.acc, st + kG, s.k[which]);
    } else if (which == 3) {
      to_rotation(i == 0 ? st + kQn : S[i - 1].q_next, s.R2[0]);
    } else {
      to_rotation(s.q_next, s.R2[1]);
    }
  }
  __syncthreads();
  stamp(clocks, 4);
  // 4. per slot dv and k1 + 2 k2 (a task per slot and component), and
  //    R(q_next) R(q_null)^T and the constraint direction u = R(q_null) g
  //    (a task per slot)
  for (int e = tid; e < 4 * Lr; e += kThreads) {
    const int i = e % Lr, k = e / Lr;
    if (i >= L) continue;
    Slot<T>& s = S[i];
    if (k < 3) {
      s.dv[k] = s.m != T(0) ? (s.k[0][k] + T(4) * s.k[1][k] + s.k[2][k]) * (s.dt / T(6)) : T(0);
      s.kk[k] = s.k[0][k] + T(2) * s.k[1][k];
      continue;
    }
    const T* g = st + kG;
    const T* Rn = s.R2[0];
    const T* Rx = s.R2[1];
    for (int r = 0; r < 3; ++r)
      for (int cc = 0; cc < 3; ++cc)
        s.Phi00[3 * r + cc] = (Rx[3 * r] * Rn[3 * cc] + Rx[3 * r + 1] * Rn[3 * cc + 1]) +
                              Rx[3 * r + 2] * Rn[3 * cc + 2];
    T uu = T(0);
    for (int r = 0; r < 3; ++r) {
      s.u[r] = Rn[3 * r] * g[0] + Rn[3 * r + 1] * g[1] + Rn[3 * r + 2] * g[2];
      uu += s.u[r] * s.u[r];
    }
    for (int r = 0; r < 3; ++r) s.s[r] = s.u[r] / uu;
  }
  __syncthreads();
  //    v and p as sequential sums (threads 0-2, a component each, in double
  //    as the host's cumsum; the next slot's inputs loaded ahead)
  if (tid < 3) {
    const int k = tid;
    const T v0 = st[kV + k], p0 = st[kP + k];
    double sv = 0.0, sp = 0.0;
    T v_at = v0;
    T dv = L > 0 ? S[0].dv[k] : T(0), kk = L > 0 ? S[0].kk[k] : T(0);
    T dt = L > 0 ? S[0].dt : T(0), m = L > 0 ? S[0].m : T(0);
    for (int i = 0; i < L; ++i) {
      T dv_n = T(0), kk_n = T(0), dt_n = T(0), m_n = T(0);
      if (i + 1 < L) {
        dv_n = S[i + 1].dv[k];
        kk_n = S[i + 1].kk[k];
        dt_n = S[i + 1].dt;
        m_n = S[i + 1].m;
      }
      sv += (double)dv;
      const T vn = v0 + (T)sv;
      const T dp = m != T(0) ? v_at * dt + kk * (dt * dt / T(6)) : T(0);
      sp += (double)dp;
      S[i].v_next[k] = vn;
      S[i].p_next[k] = p0 + (T)sp;
      v_at = vn;
      dv = dv_n;
      kk = kk_n;
      dt = dt_n;
      m = m_n;
    }
  }
  __syncthreads();
  stamp(clocks, 5);
  // 5. the constraint targets w1, w2 (the anchors of sample i: the state
  //    after sample i - 1)
  for (int i = tid; i < L; i += kThreads) {
    Slot<T>& s = S[i];
    T d1[3], d2[3];
    for (int k = 0; k < 3; ++k) {
      const T vn = i == 0 ? st[kVn + k] : S[i - 1].v_next[k];
      const T pn = i == 0 ? st[kPn + k] : S[i - 1].p_next[k];
      d1[k] = vn - s.v_next[k];
      d2[k] = s.dt * vn + pn - s.p_next[k];
    }
    skew_mul(d1, st + kG, s.w1);
    skew_mul(d2, st + kG, s.w2);
  }
}

// ---- phase B: one warp builds the leaf (Phi_i, Q_i) of slot i into
// ``node``; ``scratch`` (kLeafScratch values) holds its 3x3 blocks, then
// Phi G.  Masked slots and slots past L are (I, 0).
//
// F dt's nonzero 3x3 blocks: (0,0) A = -[gyro]x dt, (0,1) -I dt,
// (2,0) B = -R^T [acc]x dt, (2,3) C = -R^T dt, (4,2) I dt.  (F dt)^2:
// (0,0) A A, (0,1) A (-dt), (2,0) B A, (2,1) B (-dt), (4,0) dt B, (4,3)
// dt C.  (F dt)^3 = (F dt)^2 (F dt): (0,0) (A A) A, (0,1) (A A)(-dt),
// (2,0) (B A) A, (2,1) (B A)(-dt), (4,0) (dt B) A, (4,1) (dt B)(-dt).
// Each product sums over its one nonzero block in the dense product's
// order, so every entry rounds as the 21x21 products round.
template <typename T>
__device__ void build_leaf(const Slot<T>* S, int i, int L, const T* qc, T* node, T* scratch,
                           int lane) {
  T* Phi = node;
  T* Q = node + kNN;
  if (i >= L || S[i].m == T(0)) {
    for (int e = lane; e < kNN; e += 32) {
      Phi[e] = (e / kN == e % kN) ? T(1) : T(0);
      Q[e] = T(0);
    }
    return;
  }
  const Slot<T>& s = S[i];
  const T dt = s.dt;
  // blocks: A 0, B 9, C 18, AA 27, BA 36, dB 45, AAA 54, BAA 63, dBA 72
  T* A = scratch;
  T* Bk = scratch + 9;
  T* Ck = scratch + 18;
  T* AA = scratch + 27;
  T* BA = scratch + 36;
  T* dB = scratch + 45;
  T* BAA = scratch + 63;
  T* dBA = scratch + 72;
  if (lane < 27) {
    const int k = lane % 9;
    scratch[lane] = lane < 9 ? -s.skg[k] * dt : (lane < 18 ? -s.RtSa[k] * dt : -s.Rt[k] * dt);
  }
  __syncwarp();
  if (lane < 27) {
    const int k = lane % 9, r = k / 3, cc = k % 3;
    if (lane < 18) {
      const T* X = lane < 9 ? A : Bk;
      T acc = T(0);
      for (int m = 0; m < 3; ++m) acc += X[3 * r + m] * A[3 * m + cc];
      scratch[27 + lane] = acc;
    } else {
      dB[k] = dt * Bk[k];
    }
  }
  __syncwarp();
  if (lane < 27) {
    const int k = lane % 9, r = k / 3, cc = k % 3;
    const T* X = lane < 9 ? AA : (lane < 18 ? BA : dB);
    T acc = T(0);
    for (int m = 0; m < 3; ++m) acc += X[3 * r + m] * A[3 * m + cc];
    scratch[54 + lane] = acc;
  }
  __syncwarp();
  // the identity's and zero blocks, then the nine others (81 entries,
  // the lanes of a round on three or four blocks)
  for (int e = lane; e < kNN; e += 32) Phi[e] = (e / kN == e % kN) ? T(1) : T(0);
  __syncwarp();
  for (int e = lane; e < 81; e += 32) {
    const int blk = e / 9, k = e % 9, i3 = k / 3, j3 = k % 3;
    const T id = i3 == j3 ? T(1) : T(0);
    // blocks (0,0) (0,1) (2,0) (2,1) (2,3) (4,0) (4,1) (4,2) (4,3)
    const int br = blk == 0 || blk == 1 ? 0 : (blk < 5 ? 2 : 4);
    const int bc = blk == 0 ? 0 : (blk == 1 ? 1 : (blk < 5 ? blk - 2 + (blk == 4) : blk - 5));
    const int r = 3 * br + i3, c = 3 * bc + j3;
    T f1 = T(0), f2 = T(0), f3 = T(0);
    switch (blk) {
      case 0:  // (0,0): R(q_next) R(q_null)^T
        Phi[r * kN + c] = s.Phi00[k];
        continue;
      case 1:  // (0,1)
        f1 = -id * dt;
        f2 = A[k] * -dt;
        f3 = AA[k] * -dt;
        break;
      case 2:  // (2,0)
        f1 = Bk[k];
        f2 = BA[k];
        f3 = BAA[k];
        break;
      case 3:  // (2,1)
        f2 = Bk[k] * -dt;
        f3 = BA[k] * -dt;
        break;
      case 4:  // (2,3)
        f1 = Ck[k];
        break;
      case 5:  // (4,0)
        f2 = dB[k];
        f3 = dBA[k];
        break;
      case 6:  // (4,1)
        f3 = dB[k] * -dt;
        break;
      case 7:  // (4,2)
        f1 = id * dt;
        break;
      default:  // (4,3)
        f2 = dt * Ck[k];
        break;
    }
    Phi[r * kN + c] = (((r == c ? T(1) : T(0)) + f1) + f2 / T(2)) + f3 / T(6);
  }
  __syncwarp();
  // the OC-EKF constraints on block column 0 of rows 6..8 (A1) and 12..14
  // (A2): A - (A u - w) s^T
  T corr = T(0);
  if (lane < 6) {
    const int r = lane < 3 ? 6 + lane : 9 + lane;
    const T* w = lane < 3 ? s.w1 : s.w2;
    corr = ((Phi[r * kN] * s.u[0] + Phi[r * kN + 1] * s.u[1]) + Phi[r * kN + 2] * s.u[2]) -
           w[lane % 3];
  }
  const int kc = lane / 3;
  const T ck = __shfl_sync(0xffffffffu, corr, kc < 6 ? kc : 0);
  __syncwarp();
  if (lane < 18) {
    const int r = kc < 3 ? 6 + kc : 9 + kc, c = lane % 3;
    Phi[r * kN + c] = Phi[r * kN + c] - ck * s.s[c];
  }
  __syncwarp();
  // Phi G (15 x 12): G = diag(-I, I, -R^T, I) on rows 0..11
  T* phig = scratch;
  for (int e = lane; e < kLeafScratch; e += 32) {
    const int r = e / 12, c = e % 12;
    T v;
    if (c < 3) {
      v = -Phi[r * kN + c];
    } else if (c >= 6 && c < 9) {
      v = T(0);
      for (int m = 0; m < 3; ++m) v += Phi[r * kN + 6 + m] * -s.Rt[3 * m + c - 6];
    } else {
      v = Phi[r * kN + c];
    }
    phig[e] = v;
  }
  __syncwarp();
  T q[12];
  for (int m = 0; m < 12; ++m) q[m] = qc[m];
#pragma unroll
  for (int j = 0; j < (kNN + 31) / 32; ++j) {
    const int e = lane + 32 * j;
    if (e >= kNN) break;
    const int r = e / kN, c = e % kN;
    T acc = T(0);
#pragma unroll
    for (int m = 0; m < 12; ++m) acc = fma(phig[r * 12 + m] * q[m], phig[c * 12 + m], acc);
    Q[e] = acc * dt;
  }
}

// ---- phase C: fold n (a power of two) nodes at nodes[k * kNode] into
// nodes[0], level by level: pair j of the level with stride st is (a, b) =
// (nodes 2 j st, (2 j + 1) st); its result replaces a.  ``temps`` holds
// kTemps pairs' products (Phi_b Q_a, Phi_b Phi_a).  Every thread calls it.
//
// A thread computes a 3x3 tile.  Every Phi keeps the leaves' structure:
// block rows 1 and 3 are unit rows, block row 0 is zero past column 5 and
// block row 2 past column 11 (products of such matrices keep it), so a
// product's tile in block row 1 or 3 is the right factor's rows, a
// product's dot stops at the left row's last nonzero column, and
// (T Phi_b^T) in block column 1 or 3 is T's column: the skipped terms are
// exact zeros, so every entry rounds as the dense product's.

// acc[r][c] += sum_{k < K} X[r0 + r][k] Y[k][c0 + c] (Y^T: Y[c0 + c][k]),
// unrolled so that the loads issue ahead of the sums.
template <int K, bool kYT, typename T>
__device__ __forceinline__ void tile_dot(const T* X, const T* Y, int r0, int c0, T (&acc)[3][3]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    T x[3], y[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) x[r] = X[(r0 + r) * kN + k];
#pragma unroll
    for (int c = 0; c < 3; ++c) y[c] = kYT ? Y[(c0 + c) * kN + k] : Y[k * kN + c0 + c];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) acc[r][c] = fma(x[r], y[c], acc[r][c]);
  }
}

// The tile of X Y (kYT: X Y^T) whose dot stops at the last nonzero column
// of Phi's block row ``block`` (X's rows, or Y's rows under kYT).
template <bool kYT, typename T>
__device__ __forceinline__ void phi_tile(int block, const T* X, const T* Y, int r0, int c0,
                                         T (&acc)[3][3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[r][c] = T(0);
  if (block == 0) tile_dot<6, kYT>(X, Y, r0, c0, acc);
  else if (block == 2) tile_dot<12, kYT>(X, Y, r0, c0, acc);
  else tile_dot<kN, kYT>(X, Y, r0, c0, acc);
}

template <typename T>
__device__ void fold(T* nodes, int n, T* temps) {
  for (int st = 1; st < n; st *= 2) {
    const int pairs = n / (2 * st);
    for (int p0 = 0; p0 < pairs; p0 += kTemps) {
      const int np = min(kTemps, pairs - p0);
      // (Phi_b Q_a, Phi_b Phi_a): task = (product, block row, pair, block
      // column), so that a warp's lanes mostly share the unrolled dot
      for (int e = threadIdx.x; e < np * 50; e += kThreads) {
        const int g = e / (5 * np), t = e % (5 * np);
        const int prod = g / 5, br = g % 5, j = t / 5, bc = t % 5;
        const T* na = nodes + (size_t)(2 * (p0 + j) * st) * kNode;
        const T* nb = na + (size_t)st * kNode;
        const T* rhs = prod == 0 ? na + kNN : na;  // Q_a, or Phi_a
        T* o = temps + j * kNode + prod * kNN;
        const int r0 = 3 * br, c0 = 3 * bc;
        T acc[3][3];
        if (br == 1 || br == 3) {
          for (int r = 0; r < 3; ++r)
            for (int c = 0; c < 3; ++c) acc[r][c] = rhs[(r0 + r) * kN + c0 + c];
        } else {
          phi_tile<false>(br, nb, rhs, r0, c0, acc);
        }
        for (int r = 0; r < 3; ++r)
          for (int c = 0; c < 3; ++c) o[(r0 + r) * kN + c0 + c] = acc[r][c];
      }
      __syncthreads();
      // Q = (Phi_b Q_a) Phi_b^T + Q_b, a tile a task (block column, pair,
      // block row); Phi_b Phi_a to a
      for (int f = threadIdx.x; f < np * kNN; f += kThreads) {
        const int j = f / kNN, idx = f % kNN;
        nodes[(size_t)(2 * (p0 + j) * st) * kNode + idx] = temps[j * kNode + kNN + idx];
      }
      for (int e = threadIdx.x; e < np * 25; e += kThreads) {
        const int bc = e / (5 * np), t = e % (5 * np), j = t / 5, br = t % 5;
        T* na = nodes + (size_t)(2 * (p0 + j) * st) * kNode;
        const T* nb = na + (size_t)st * kNode;
        const T* tj = temps + j * kNode;
        const int r0 = 3 * br, c0 = 3 * bc;
        T acc[3][3];
        if (bc == 1 || bc == 3) {
          for (int r = 0; r < 3; ++r)
            for (int c = 0; c < 3; ++c) acc[r][c] = tj[(r0 + r) * kN + c0 + c];
        } else {
          phi_tile<true>(bc, tj, nb, r0, c0, acc);
        }
        for (int r = 0; r < 3; ++r)
          for (int c = 0; c < 3; ++c)
            na[kNN + (r0 + r) * kN + c0 + c] = acc[r][c] + nb[kNN + (r0 + r) * kN + c0 + c];
      }
      __syncthreads();
    }
  }
}

// ---- phase D: the covariance's first 21 rows and columns: a task per
// (column, group of 7 rows), P_ic's columns written to the rows and,
// through a shared-memory tile, to the columns, and Phi P_ii's kept; then
// (Phi P_ii) Phi^T + Q and its symmetrisation.  ``scratch``: kFixed - kNode
// values past the result node.
template <typename T>
__device__ void covariance(const T* cov, T* out, int D, const T* tot, T* scratch) {
  const T* Phi = tot;
  const T* Q = tot + kNN;
  const int tid = threadIdx.x;
  T* M = scratch;           // Phi P_ii
  T* Pn = M + kD * kD;      // (Phi P_ii) Phi^T + Q
  T* tile = Pn + kD * kD;   // P_ic, kD x W
  const int W = (kFixed - kNode - 2 * kD * kD) / kD;  // columns a pass
  for (int c0 = 0; c0 < D; c0 += W) {
    const int w = min(W, D - c0);
    for (int e = tid; e < 3 * w; e += kThreads) {
      const int cc = e / 3, r0 = 7 * (e % 3), col = c0 + cc;
      T x[kN];
#pragma unroll
      for (int k = 0; k < kN; ++k) x[k] = cov[(size_t)k * D + col];
#pragma unroll
      for (int rr = 0; rr < 7; ++rr) {
        const int r = r0 + rr;
        T acc;
        if (r < kN) {
          acc = T(0);
#pragma unroll
          for (int k = 0; k < kN; ++k) acc = fma(Phi[r * kN + k], x[k], acc);
        } else {
          acc = cov[(size_t)r * D + col];
        }
        if (col < kD) {
          M[r * kD + col] = acc;
        } else {
          out[(size_t)r * D + col] = acc;
          tile[r * W + cc] = acc;
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < kD * w; e += kThreads) {  // P_ic^T, rows of 21
      const int cc = e / kD, r = e % kD;
      if (c0 + cc >= kD) out[((size_t)c0 + cc) * D + r] = tile[r * W + cc];
    }
    __syncthreads();
  }
  for (int e = tid; e < kD * kD; e += kThreads) {
    const int r = e / kD, c = e % kD;
    T acc;
    if (c < kN) {
      acc = T(0);
#pragma unroll
      for (int k = 0; k < kN; ++k) acc = fma(M[r * kD + k], Phi[c * kN + k], acc);
      if (r < kN) acc = acc + Q[r * kN + c];
    } else {
      acc = M[r * kD + c];
    }
    Pn[e] = acc;
  }
  __syncthreads();
  for (int e = tid; e < kD * kD; e += kThreads) {
    const int r = e / kD, c = e % kD;
    out[(size_t)r * D + c] = (Pn[r * kD + c] + Pn[c * kD + r]) / T(2);
  }
}

// Pairs of mirrored 16x16 tiles (one on the diagonal) of the trailing
// (D - 21)^2 block.
__host__ __device__ inline int trailing_pairs(int D) {
  const int nt = (D - kD + kTile - 1) / kTile;
  return nt * (nt + 1) / 2;
}

// out = (cov + cov^T) / 2 on rows and columns >= 21, which propagation
// leaves as it is, by the launch's blocks past the first, on other SMs
// while the first propagates: a warp per pair of mirrored 16x16 tiles,
// their loads in flight together, staged in ``scratch`` to write both
// tiles' rows.
template <typename T>
__device__ void symmetrise_trailing(const T* __restrict__ cov, T* __restrict__ out, int D,
                                    T* scratch) {
  constexpr int ld = kTile + 1, kPer = kTile * kTile / 32, kBatch = 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gw = (blockIdx.x - 1) * kWarps + warp, n_warps = (gridDim.x - 1) * kWarps;
  T* A = scratch + warp * kBatch * 2 * kTile * ld;
  const int pairs = trailing_pairs(D);
  const int nt = (D - kD + kTile - 1) / kTile;
  for (int p0 = gw * kBatch; p0 < pairs; p0 += n_warps * kBatch) {
    T ra[kBatch][kPer], rb[kBatch][kPer];
    int ti[kBatch], tj[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      int rem = min(p0 + b, pairs - 1);
      ti[b] = 0;
      while (rem >= nt - ti[b]) rem -= nt - ti[b]++;
      tj[b] = ti[b] + rem;
      const int r0 = kD + ti[b] * kTile, c0 = kD + tj[b] * kTile;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int e = lane + 32 * j, rr = e / kTile, cc = e % kTile;
        ra[b][j] = (r0 + rr < D && c0 + cc < D) ? cov[(size_t)(r0 + rr) * D + c0 + cc] : T(0);
        rb[b][j] = (c0 + rr < D && r0 + cc < D) ? cov[(size_t)(c0 + rr) * D + r0 + cc] : T(0);
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      T* tA = A + b * 2 * kTile * ld;
      T* tB = tA + kTile * ld;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int e = lane + 32 * j, rr = e / kTile, cc = e % kTile;
        tA[rr * ld + cc] = ra[b][j];
        tB[rr * ld + cc] = rb[b][j];
      }
    }
    __syncwarp();
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (p0 + b >= pairs) break;
      const T* tA = A + b * 2 * kTile * ld;
      const T* tB = tA + kTile * ld;
      const int r0 = kD + ti[b] * kTile, c0 = kD + tj[b] * kTile;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int e = lane + 32 * j, rr = e / kTile, cc = e % kTile;
        if (r0 + rr < D && c0 + cc < D)
          out[(size_t)(r0 + rr) * D + c0 + cc] = (tA[rr * ld + cc] + tB[cc * ld + rr]) / T(2);
        if (ti[b] != tj[b] && c0 + rr < D && r0 + cc < D)
          out[(size_t)(c0 + rr) * D + r0 + cc] = (tB[rr * ld + cc] + tA[cc * ld + rr]) / T(2);
      }
    }
    __syncwarp();
  }
}

// Value k of the staged state (the offsets above; 0 past qc).
template <typename T>
__device__ T state_value(const Args<T>& a, int k) {
  if (k < kP) return a.q[k - kQ];
  if (k < kV) return a.p[k - kP];
  if (k < kBg) return a.v[k - kV];
  if (k < kBa) return a.bg[k - kBg];
  if (k < kQn) return a.ba[k - kBa];
  if (k < kPn) return a.qn[k - kQn];
  if (k < kVn) return a.pn[k - kPn];
  if (k < kTs) return a.vn[k - kVn];
  if (k < kG) return a.ts[0];
  if (k < kQc) return a.g[k - kG];
  return k < kQc + 12 ? a.qc[k - kQc] : T(0);
}

// Values of the staged inputs, the slots and the chunk roots for I slots
// (a Slot<T> is an array of T).
template <typename T>
__host__ __device__ inline size_t rest_values(int I) {
  int n2 = 1;
  while (n2 < I) n2 *= 2;
  const int roots = n2 > kChunk ? n2 / kChunk : 0;
  return (size_t)8 * I + kState + (size_t)roots * kNode + (size_t)I * (sizeof(Slot<T>) / sizeof(T));
}

// kShared: the inputs, slots and roots in shared memory after the fixed
// nodes (else in a.work).
template <typename T, bool kShared>
__global__ void __launch_bounds__(kThreads, 1) propagate_kernel(const Args<T> batch) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  const Args<T> a = instance_args(batch, (int)blockIdx.y);
  T* leaves = reinterpret_cast<T*>(dyn_smem);
  if (blockIdx.x > 0) {
    symmetrise_trailing(a.cov, a.cov_out, a.D, leaves);
    return;
  }
  T* temps = leaves + kChunk * kNode;
  T* rest = kShared ? leaves + kFixed : a.work;
  const int I = a.I;
  T* in_base = rest;
  Slot<T>* S = reinterpret_cast<Slot<T>*>(rest + 8 * I + kState);
  T* roots = reinterpret_cast<T*>(S + I);
  const In<T> in{in_base, in_base + I, in_base + 4 * I, in_base + 7 * I, in_base + 8 * I};
  __shared__ int s_L, s_nv;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // SM clocks (thread 0 of block 0): 0 start; 1 inputs staged; 2-6 the
  // state chain's five steps; 7 the first leaves; 8 the fold; 9 the
  // covariance
  stamp(a.clocks, 0);
  {  // the inputs, one round trip for the whole block
    T* d = in_base;
    for (int e = tid; e < 8 * I + kState; e += kThreads) {
      T v = T(0);
      if (e < I) v = a.t[e];
      else if (e < 4 * I) v = a.w[e - I];
      else if (e < 7 * I) v = a.a[e - 4 * I];
      else if (e < 8 * I) v = a.mask[e - 7 * I] ? T(1) : T(0);
      else v = state_value(a, e - 8 * I);
      d[e] = v;
    }
  }
  __syncthreads();
  stamp(a.clocks, 1);
  if (warp == 0) {  // L = 1 + the last valid slot, and n_valid
    int last_valid = -1, nv = 0;
    for (int i0 = 0; i0 < I; i0 += 32) {
      const int i = i0 + lane;
      const unsigned b = __ballot_sync(0xffffffffu, i < I && in.m[i] != T(0));
      nv += __popc(b);
      if (b) last_valid = i0 + 31 - __clz(b);
    }
    if (lane == 0) {
      s_L = last_valid + 1;
      s_nv = nv;
    }
  }
  __syncthreads();
  const int L = s_L, nv = s_nv;
  state_chain(in, S, L, a.clocks);
  __syncthreads();
  stamp(a.clocks, 6);
  int n2 = 1;
  while (n2 < L) n2 *= 2;
  const T* qc = in.st + kQc;
  const T* tot = leaves;
  if (n2 <= kChunk) {
    if (warp < n2)
      build_leaf(S, warp, L, qc, leaves + warp * kNode, temps + warp * kLeafScratch, lane);
    __syncthreads();
    stamp(a.clocks, 7);
    fold(leaves, n2, temps);
  } else {
    for (int c0 = 0; c0 < n2; c0 += kChunk) {
      build_leaf(S, c0 + warp, L, qc, leaves + warp * kNode, temps + warp * kLeafScratch, lane);
      __syncthreads();
      if (c0 == 0) stamp(a.clocks, 7);
      fold(leaves, kChunk, temps);
      T* root = roots + (size_t)(c0 / kChunk) * kNode;
      for (int e = tid; e < kNode; e += kThreads) root[e] = leaves[e];
      __syncthreads();
    }
    fold(roots, n2 / kChunk, temps);
    tot = roots;
  }
  stamp(a.clocks, 8);
  covariance(a.cov, a.cov_out, a.D, tot, leaves + kNode);
  stamp(a.clocks, 9);
  if (tid == 0) {
    T* out = a.out;
    const T* st = in.st;
    if (nv > 0) {  // the anchors move to the new state
      const Slot<T>& s = S[nv - 1];
      for (int k = 0; k < 4; ++k) out[k] = out[11 + k] = s.q_next[k];
      for (int k = 0; k < 3; ++k) {
        out[4 + k] = out[15 + k] = s.v_next[k];
        out[7 + k] = out[18 + k] = s.p_next[k];
      }
      out[10] = in.t[nv - 1];
    } else {  // nothing ran: state and anchors stay
      for (int k = 0; k < 4; ++k) {
        out[k] = st[kQ + k];
        out[11 + k] = st[kQn + k];
      }
      for (int k = 0; k < 3; ++k) {
        out[4 + k] = st[kV + k];
        out[7 + k] = st[kP + k];
        out[15 + k] = st[kVn + k];
        out[18 + k] = st[kPn + k];
      }
      out[10] = st[kTs];
    }
    *a.sid_out = *a.sid + 1;
  }
}



template <typename T>
int launch(const void* t, const void* w, const void* acc, const void* mask, int I,
           const void* q, const void* p, const void* v, const void* bg, const void* ba,
           const void* qn, const void* pn, const void* vn, const void* ts, const void* g,
           const void* sid, const void* qc, const void* cov, int D, void* out,
           void* sid_out, void* cov_out, void* work, int n_inst, const long long* strides,
           void* clocks, void* stream) {
  static_assert(sizeof(Slot<T>) == 163 * sizeof(T), "models/msckf/propagation.py mirrors it");
  static size_t budget = 0, allowed[2] = {0, 0};
  if (budget == 0) budget = msckf::smem_budget(propagate_kernel<T, true>);
  if (I < 0 || D < kD || n_inst < 1 || n_inst > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (kFixed + (work ? 0 : rest_values<T>(I))) * sizeof(T);
  if (smem > budget) return (int)cudaErrorInvalidValue;
  auto kernel = work ? propagate_kernel<T, false> : propagate_kernel<T, true>;
  const int err = msckf::allow_smem(kernel, smem, &allowed[work ? 0 : 1]);
  if (err != 0) return err;
  Args<T> a{(const T*)t, (const T*)w, (const T*)acc, (const uint8_t*)mask, I,
            (const T*)q, (const T*)p, (const T*)v, (const T*)bg, (const T*)ba,
            (const T*)qn, (const T*)pn, (const T*)vn, (const T*)ts, (const T*)g,
            (const int32_t*)sid, (const T*)qc, (const T*)cov, D, (T*)out,
            (int32_t*)sid_out, (T*)cov_out, (T*)work, (long long*)clocks, {}};
  for (int k = 0; k < kStrides; ++k) a.stride[k] = strides != nullptr ? strides[k] : 0;
  // per instance (blockIdx.y) block 0 propagates; the others symmetrise
  // the trailing block, a warp per pair of tiles
  const int blocks = 1 + (trailing_pairs(D) + kWarps - 1) / kWarps;
  kernel<<<dim3(blocks, n_inst), kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

#define PROPAGATE_ENTRY(name, T)                                                              \
  extern "C" int name(const void* t, const void* w, const void* a, const void* mask, int I,   \
                      const void* q, const void* p, const void* v, const void* bg,            \
                      const void* ba, const void* qn, const void* pn, const void* vn,         \
                      const void* ts, const void* g, const void* sid, const void* qc,         \
                      const void* cov, int D, void* out, void* sid_out, void* cov_out,        \
                      void* work, int n_inst, const void* strides, void* clocks,              \
                      void* stream) {                                                         \
    return launch<T>(t, w, a, mask, I, q, p, v, bg, ba, qn, pn, vn, ts, g, sid, qc, cov, D,   \
                     out, sid_out, cov_out, work, n_inst, (const long long*)strides, clocks,  \
                     stream);                                                                 \
  }

PROPAGATE_ENTRY(propagate_f32, float)
PROPAGATE_ENTRY(propagate_f64, double)
