// K11: the EKF measurement update from the stacked Jacobian, with the
// error-state injection, in ONE launch: one block an instance (a fleet's
// updating instances side by side, a single state as a fleet of one).
//
// Replaces uav_airvision_tpu/models/msckf/update.py::apply_update (:296)
// together with _inject_delta (:359).  For H (m x D), r (m), P (D x D), s2:
//   HP = H P,  S = HP H' + s2 I = L L',  [Y | y] = L^-1 [HP | r],
//   delta = Y' y,  P_new = sym(P - Y' Y),
// which is the reference's non-Joseph P - K H P (K H P = HP' S^-1 HP =
// Y' Y) with one triangular solve instead of D columns solved forward and
// backward, and m D^2 multiply-adds for the covariance instead of 2 D^3.
// Then the injection (msckf_common.cuh: quaternion boxplus of the IMU, the
// extrinsic and the live window poses, the bias, velocity and position
// adds, too_large) writes the new state next to P_new and delta.
//
// Rows: the caller passes the true-row prefix of the stacked buffer on the
// T1 and T2 tiers (zero padding rows change nothing: their row of S is
// s2 e_i and their row of Y is 0), every row of a buffer no taller than T2,
// and on the QR tier the n rows to compress: the block first reflects the
// stack [H | r] (n x (D + 1), copied to the workspace) by Householder
// reflections down its D columns, then updates with H = R (the upper
// triangle of the first D rows) and r = their last column; X' H and X' r
// do not depend on the signs of R's rows, so no sign convention is matched.
//
// Instances: block s of a launch updates instance inst[s] of the caller's
// fleet (every pointer advanced by its instance stride), with its own rows
// m, its own tier and its own layout and shared-memory choice, exactly as
// its launch alone would: an instance's sums run in its own order whatever
// the others' tiers.  The per-instance values travel in the launch's
// arguments (__grid_constant__), up to kMaxInst instances a launch; a call
// with more takes ceil(n_inst / kMaxInst) launches.  The launch's dynamic
// shared memory is the most any of its instances takes.
//
// Layout, one block of 1024 threads (32 warps) an instance, phases
// separated by barriers:
//   staging: P, H transposed (rows padded to fours) and r into the working
//     arrays;
//   HP and S = HP H' + s2 I (its upper triangle): a warp a task of 4 rows
//     by 32 columns, a lane a column, per k one 4-wide load the same for
//     every lane and one entry along a row;
//   the factorisation S = U'U (U = L') and the solve [Y | y] = L^-1 [HP | r]
//     together, by panels of 32 rows with three barriers a panel: one warp
//     factors the panel's diagonal block (a lane a column, left-looking,
//     no block barrier), a thread a column right of it (of S and of
//     [HP | r]) takes the panel's rows by forward substitution, a warp a
//     trailing row subtracts the panel's rank-32 product;
//   delta a thread a column; P_new = (P + P')/2 - Y'Y a lane a column of
//     a 4-row task (G_ab and G_ba sum the same products in the same order:
//     P_new is exactly symmetric; stores along P_new's rows);
//   the injection: the IMU quaternion, the extrinsic rotation, the adds
//     and a window slot each on threads of different warps.
// The working arrays (``layout``: 114 KB in float32 at the main path's 26
// rows) live in shared memory when they fit (float32 up to 96 rows,
// float64 up to 28), else in the workspace in device memory, where
// they stay in L2; so do the QR tier's stack and, past the shared-memory
// limit, its reflection scratch.  The products are fused multiply-adds.  A
// pivot that is not > 0 becomes NaN (no clamp) and reaches every entry of
// delta and P_new, as the plain version's failed factorisation does.
//
// Bound on the card: at m = 26, D = 141 the work is ~0.9 M multiply-adds
// and the bytes P in, P_new out (0.16 MB in float32): ~0.05 us.  One SM
// does an instance's update, so the time is that SM's chain of dependent
// steps (a fleet's instances run side by side on their own SMs): the
// shared-memory loads of the products and the factorisation's short
// dependent inner products (tools/kernel_probe.py prints the cycles of
// each phase).  The design removes the parent's six launches over global
// memory (nine on the QR tier), its three allocations and the injection's
// ~150 small PyTorch launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "msckf_common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxInst = 64;  // instances of one launch
// instance strides, in elements: P, H, r, work, out, the injected state's
// q, bg, v, ba, p, R, t, cam_q, cam_p, count, then too_large (bytes)
constexpr int kStrides = 16;

// One instance's update, its pointers at that instance
template <typename T>
struct Args {
  const T* P;
  int D;
  const T* H;  // m x D (QR tier: n x D), rows of stride D
  const T* r;
  int m;       // rows to update with (QR tier: rows of the stack to reflect)
  int qr;
  const T* noise;
  T* work;     // device workspace: the QR stack, then whatever shared memory cannot hold
  int smem_update;  // the working arrays (layout) in shared memory
  int smem_qr;      // the reflection scratch in shared memory
  T* out;           // P_new (D x D), delta (D), then the injected state
  msckf::InjectIn<T> state;  // state.q == nullptr: no injection
  uint8_t* too_large;
  long long* clocks;  // optional: the SM clock at the phase boundaries (mark)
};

// A launch's instances: block s takes instance inst[s] (the pointers of
// ``base`` advanced by inst[s] strides), its rows m[s] and flags[s] (bit 0
// the QR tier, bit 1 the working arrays in shared memory, bit 2 the
// reflection scratch in shared memory)
template <typename T>
struct Fleet {
  Args<T> base;
  int n;
  int inst[kMaxInst];
  int m[kMaxInst];
  int flags[kMaxInst];
  long long stride[kStrides];
};

template <typename T, typename P>
__device__ __forceinline__ P* at(P* p, const Fleet<T>& f, int k, int b) {
  return p == nullptr ? p : p + f.stride[k] * b;
}

// Block s's instance, as its launch alone would take it (the clocks on
// block 0's only)
template <typename T>
__device__ __forceinline__ Args<T> instance(const Fleet<T>& f, int s) {
  const int b = f.inst[s], fl = f.flags[s];
  Args<T> a = f.base;
  a.P = at(a.P, f, 0, b);
  a.H = at(a.H, f, 1, b);
  a.r = at(a.r, f, 2, b);
  a.work = at(a.work, f, 3, b);
  a.out = at(a.out, f, 4, b);
  a.state.q = at(a.state.q, f, 5, b);
  a.state.bg = at(a.state.bg, f, 6, b);
  a.state.v = at(a.state.v, f, 7, b);
  a.state.ba = at(a.state.ba, f, 8, b);
  a.state.p = at(a.state.p, f, 9, b);
  a.state.R = at(a.state.R, f, 10, b);
  a.state.t = at(a.state.t, f, 11, b);
  a.state.cam_q = at(a.state.cam_q, f, 12, b);
  a.state.cam_p = at(a.state.cam_p, f, 13, b);
  a.state.count = at(a.state.count, f, 14, b);
  a.too_large = at(a.too_large, f, 15, b);
  a.m = f.m[s];
  a.qr = fl & 1;
  a.smem_update = (fl >> 1) & 1;
  a.smem_qr = (fl >> 2) & 1;
  if (s != 0) a.clocks = nullptr;
  return a;
}

// Thread 0 records the SM clock at phase boundary k when the caller asked:
// 0 start, 1 staged (after the QR tier's compression), 2 H P, 3 S, 4 the
// factorisation and solve, 5 delta and P_new, 6 the injection.
template <typename T>
__device__ __forceinline__ void mark(const Args<T>& a, int k) {
  if (a.clocks != nullptr && threadIdx.x == 0) a.clocks[k] = clock64();
}

// acc - sum_{k in [k0, k1)} x[k * ldx] y[k * ldy], four partial sums in
// flight (the factorisation's inner products are short dependent chains).
template <typename T>
__device__ __forceinline__ T minus_dot(T acc, const T* x, size_t ldx, const T* y, size_t ldy,
                                       int k0, int k1) {
  T s0 = acc, s1 = T(0), s2 = T(0), s3 = T(0);
  int k = k0;
  for (; k + 4 <= k1; k += 4) {
    s0 = fma(-x[k * ldx], y[k * ldy], s0);
    s1 = fma(-x[(k + 1) * ldx], y[(k + 1) * ldy], s1);
    s2 = fma(-x[(k + 2) * ldx], y[(k + 2) * ldy], s2);
    s3 = fma(-x[(k + 3) * ldx], y[(k + 3) * ldy], s3);
  }
  for (; k < k1; ++k) s0 = fma(-x[k * ldx], y[k * ldy], s0);
  return (s0 + s1) + (s2 + s3);
}

// Householder reflections down the D columns of A (n x C, C = D + 1,
// n >= D, row stride C): the warps split the rows, the lanes the columns
// right of j.  Scratch: v (n), part (32 x C), wsum (C), red (32).  Leaves
// R in the upper triangle of A's first D rows (zeros below it) and Q' r in
// their last column.
template <typename T>
__device__ __forceinline__ void householder(T* A, int n, int D, T* scratch) {
  const int C = D + 1;
  T* v = scratch;
  T* part = v + n;
  T* wsum = part + 32 * C;
  T* red = wsum + C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int j = 0; j < D; ++j) {
    const int rows = n - j, cols = C - j - 1;
    T sq = T(0);
    for (int q = tid; q < rows; q += kThreads) {
      const T x = A[(size_t)(j + q) * C + j];
      v[q] = x;
      sq += x * x;
    }
    const T norm2 = msckf::block_sum(sq, red);  // its barriers publish v
    const T x0 = v[0], normx = sqrt(norm2);
    const T sign = x0 >= T(0) ? T(1) : T(-1);
    // v = x + sign |x| e_0;  v'v = 2 |x| (|x| + |x_0|), without cancellation
    const T vnorm2 = T(2) * normx * (normx + fabs(x0));
    const T scale = vnorm2 > T(1e-30) ? T(2) / vnorm2 : T(0);
    __syncthreads();  // every thread has read x0
    if (tid == 0) {
      v[0] = x0 + sign * normx;
      A[(size_t)j * C + j] = -sign * normx;
    }
    __syncthreads();
    if (scale == T(0)) continue;  // a zero column: no reflection (uniform branch)
    for (int cb = 0; cb < cols; cb += 32) {
      const int c = cb + lane;
      T acc = T(0);
      if (c < cols)
        for (int q = warp; q < rows; q += 32) acc += v[q] * A[(size_t)(j + q) * C + j + 1 + c];
      if (c < cols) part[warp * C + c] = acc;
    }
    __syncthreads();
    for (int c = tid; c < cols; c += kThreads) {
      T s = T(0);
      for (int w = 0; w < 32; ++w) s += part[w * C + c];
      wsum[c] = s;
    }
    __syncthreads();
    for (int cb = 0; cb < cols; cb += 32) {
      const int c = cb + lane;
      if (c < cols) {
        const T wc = wsum[c];
        for (int q = warp; q < rows; q += 32) {
          T* a = A + (size_t)(j + q) * C + j + 1 + c;
          *a = *a - scale * v[q] * wc;
        }
      }
    }
    __syncthreads();
  }
  for (int e = tid; e < D * D; e += kThreads) {  // R: zeros below the diagonal
    const int i = e / D, k = e % D;
    if (k < i) A[(size_t)i * C + k] = T(0);
  }
  __syncthreads();
}

// Four consecutive values at a 16-byte aligned address.
template <typename T>
struct Four {
  T v[4];
};

__device__ __forceinline__ Four<float> load4(const float* p) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  return {{x.x, x.y, x.z, x.w}};
}

__device__ __forceinline__ Four<double> load4(const double* p) {
  const double2 x = reinterpret_cast<const double2*>(p)[0];
  const double2 y = reinterpret_cast<const double2*>(p)[1];
  return {{x.x, x.y, y.x, y.y}};
}

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// The update's working arrays, in elements of T: P (D x D), H transposed
// (D x mp, mp = m rounded up to four, zero columns past m), [HP | r] then
// [Y | y] (m x Cs, Cs = D + 1 rounded up to four: rows 16-byte aligned),
// S then U = L' (m x mp, the entries l >= i of each row), delta (D),
// 1 / U_jj (m).
struct Layout {
  size_t p, ht, y, s, delta, rinv, total;
};

__host__ __device__ inline Layout layout(int m, int D) {
  const size_t mp = round4(m), Cs = round4(D + 1);
  Layout l;
  l.p = 0;
  l.ht = round4(D * D);
  l.y = l.ht + (size_t)D * mp;
  l.s = l.y + (size_t)m * Cs;
  l.delta = l.s + (size_t)m * mp;
  l.rinv = l.delta + round4(D);
  l.total = l.rinv + mp;
  return l;
}

// The update (after the QR tier's compression) on working arrays at
// ``base``: shared memory (kShared) or the device workspace.  The products
// are fused multiply-adds (the build's -fmad=false keeps the rest of the
// arithmetic unfused); the plain version's products are the library's,
// whose order and rounding differ anyway.
template <typename T, bool kShared>
__device__ __forceinline__ void update_body(const Args<T>& a, T* base, const T* H, int ldh,
                                            const T* r, int rs, int m) {
  const int D = a.D, C = D + 1, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, warps = kThreads / 32;
  const int mp = round4(m), Cs = round4(C);
  const Layout lay = layout(m, D);
  T* __restrict__ Ps = base + lay.p;
  T* __restrict__ Ht = base + lay.ht;
  T* __restrict__ Y = base + lay.y;
  T* __restrict__ S = base + lay.s;
  T* __restrict__ delta = base + lay.delta;
  T* __restrict__ rinv = base + lay.rinv;  // 1 / U_jj
  const T s2 = *a.noise;

  // staging: P, H transposed, r as Y's last column
  for (int e = tid; e < D * D; e += kThreads) Ps[e] = a.P[e];
  for (int k = warp; k < D; k += warps)
    for (int i = lane; i < mp; i += 32)
      Ht[(size_t)k * mp + i] = i < m ? H[(size_t)i * ldh + k] : T(0);
  for (int i = tid; i < m; i += kThreads) Y[(size_t)i * Cs + D] = r[(size_t)i * rs];
  __syncthreads();
  mark(a, 1);

  // HP = H P into Y's first D columns: a warp a task of 4 rows by 32
  // columns, a lane a column (per k one 4-wide load of H', the same for
  // every lane, and one entry of P along its row)
  {
    const int tc = (D + 31) / 32, tasks = (mp / 4) * tc;
    for (int t = warp; t < tasks; t += warps) {
      const int i0 = 4 * (t / tc), c = 32 * (t % tc) + lane;
      const T* pc = Ps + (c < D ? c : 0);
      T acc[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll 8
      for (int k = 0; k < D; ++k) {
        const Four<T> h = load4(Ht + (size_t)k * mp + i0);
        const T p = pc[(size_t)k * D];
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[u] = fma(h.v[u], p, acc[u]);
      }
      if (c < D)
        for (int u = 0; u < 4 && i0 + u < m; ++u) Y[(size_t)(i0 + u) * Cs + c] = acc[u];
    }
  }
  __syncthreads();
  mark(a, 2);

  // S = HP H' + s2 I on and above the diagonal (S[i][l], l >= i): a warp a
  // task of 4 rows by 32 columns, a lane a column
  {
    const int tc = (m + 31) / 32, tasks = (mp / 4) * tc;
    for (int t = warp; t < tasks; t += warps) {
      const int i0 = 4 * (t / tc), l = 32 * (t % tc) + lane;
      if (32 * (t % tc) + 31 < i0) continue;  // the whole task below the diagonal
      const T* y[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) y[u] = Y + (size_t)min(i0 + u, m - 1) * Cs;
      T acc[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll 8
      for (int k = 0; k < D; ++k) {
        const T h = Ht[(size_t)k * mp + (l < mp ? l : 0)];
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[u] = fma(y[u][k], h, acc[u]);
      }
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u;
        if (i < m && l < m && l >= i) S[(size_t)i * mp + l] = i == l ? acc[u] + s2 : acc[u];
      }
    }
  }
  __syncthreads();
  mark(a, 3);

  // S = U' U (U = L' upper triangular, in S's rows) and [Y | y] = L^-1
  // [HP | r], blocked by panels of 32 rows, three barriers a panel:
  //  1. one warp factors the panel's diagonal block, lane t the panel's
  //     column p0 + t, left-looking: s = S_jl - sum_{p0<=k<j} U_kj U_kl,
  //     U_jj = sqrt(s_j), U_jl = s_l / U_jj (no block barrier inside);
  //  2. a thread a column right of the block, of S and of [HP | r]: the
  //     panel's rows by forward substitution with the block;
  //  3. a warp a trailing row, of S (entries l >= i) and of [HP | r]: minus
  //     the panel's rank-32 product.
  // A pivot that is not > 0 becomes NaN and reaches everything after it.
  const unsigned full = 0xffffffffu;
  for (int p0 = 0; p0 < m; p0 += 32) {
    const int p1 = min(p0 + 32, m);
    if (warp == 0) {
      const int l = p0 + lane;
      for (int j = p0; j < p1; ++j) {
        T acc = l >= j && l < p1 ? S[(size_t)j * mp + l] : T(0);
        acc = minus_dot(acc, S + j, (size_t)mp, S + (l < p1 ? l : j), (size_t)mp, p0, j);
        const T sj = __shfl_sync(full, acc, j - p0);
        const T d = sj > T(0) ? sqrt(sj) : T(NAN);
        const T inv = T(1) / d;
        if (l >= j && l < p1) S[(size_t)j * mp + l] = l == j ? d : acc * inv;
        if (lane == 0) rinv[j] = inv;
        __syncwarp();
      }
    }
    __syncthreads();
    for (int c = tid; c < (m - p1) + C; c += kThreads) {
      // column c of [S right of the block | [HP | r]]
      T* col = c < m - p1 ? S + p1 + c : Y + (c - (m - p1));
      const size_t ld = c < m - p1 ? mp : Cs;
      for (int j = p0; j < p1; ++j) {
        col[(size_t)j * ld] = minus_dot(col[(size_t)j * ld], S + j, (size_t)mp, col, ld, p0, j) *
                              rinv[j];
      }
    }
    __syncthreads();
    for (int i = p1 + warp; i < m; i += warps) {
      T* si = S + (size_t)i * mp;
      for (int l = i + lane; l < m; l += 32) {
        si[l] = minus_dot(si[l], S + i, (size_t)mp, S + l, (size_t)mp, p0, p1);
      }
      T* yi = Y + (size_t)i * Cs;
      for (int c = lane; c < C; c += 32) {
        yi[c] = minus_dot(yi[c], S + i, (size_t)mp, Y + c, (size_t)Cs, p0, p1);
      }
    }
    __syncthreads();
  }
  mark(a, 4);

  // delta = Y' y, a thread a column
  T* P_out = a.out;
  T* delta_out = a.out + (size_t)D * D;
  for (int c = tid; c < D; c += kThreads) {
    T acc = T(0);
    for (int i = 0; i < m; ++i) acc = fma(Y[(size_t)i * Cs + c], Y[(size_t)i * Cs + D], acc);
    delta[c] = acc;
    delta_out[c] = acc;
  }
  // P_new = (P + P') / 2 - Y'Y: a warp a task of 4 rows by 32 columns, a
  // lane a column (per i one 4-wide load of Y's row part, the same for
  // every lane, and one entry along the row); G_ab and G_ba sum the same
  // products in the same order, so P_new is exactly symmetric; the stores
  // run along P_new's rows, and P's transposed entries are read down a
  // column of odd stride D, one bank a lane
  {
    const int tc = (D + 31) / 32, tasks = (round4(D) / 4) * tc;
    for (int t = warp; t < tasks; t += warps) {
      const int a0 = 4 * (t / tc), c = 32 * (t % tc) + lane;
      const int cc = c < D ? c : 0;
      T g[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll 4
      for (int i = 0; i < m; ++i) {
        const Four<T> ya = load4(Y + (size_t)i * Cs + a0);
        const T yb = Y[(size_t)i * Cs + cc];
#pragma unroll
        for (int u = 0; u < 4; ++u) g[u] = fma(ya.v[u], yb, g[u]);
      }
      if (c < D)
        for (int u = 0; u < 4 && a0 + u < D; ++u) {
          const int row = a0 + u;
          P_out[(size_t)row * D + c] =
              (Ps[(size_t)row * D + c] + Ps[(size_t)c * D + row]) / T(2) - g[u];
        }
    }
  }
  __syncthreads();  // delta is complete
  mark(a, 5);
  if (a.state.q != nullptr) msckf::inject(delta, a.state, delta_out + D, a.too_large);
  __syncthreads();
  mark(a, 6);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) update_kernel(const __grid_constant__ Fleet<T> f) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  const Args<T> a = instance(f, (int)blockIdx.x);
  T* smem = reinterpret_cast<T*>(dyn_smem);
  const int D = a.D, C = D + 1, tid = threadIdx.x;
  const T* H = a.H;
  const T* r = a.r;
  int ldh = D, rs = 1, m = a.m;
  T* work = a.work;
  mark(a, 0);
  if (a.qr) {  // compress the stack to R (D x D) and Q' r
    const int n = a.m;
    T* A = work;
    for (size_t e = tid; e < (size_t)n * C; e += kThreads) {
      const int i = (int)(e / C), c = (int)(e % C);
      A[e] = c < D ? a.H[(size_t)i * D + c] : a.r[i];
    }
    __syncthreads();
    T* scratch = work + round4(n * C);
    if (a.smem_qr)  // two calls, so that each knows where its scratch lives
      householder(A, n, D, smem);
    else
      householder(A, n, D, scratch);
    H = A;
    r = A + D;
    ldh = C;
    rs = C;
    m = D;
    work = scratch;
  }
  if (a.smem_update)
    update_body<T, true>(a, smem, H, ldh, r, rs, m);
  else
    update_body<T, false>(a, work, H, ldh, r, rs, m);
}

template <typename T>
int update(const void* P, int D, const void* H, const void* r, const void* noise, void* work,
           void* out, const void* q, const void* bg, const void* v, const void* ba,
           const void* p, const void* R, const void* t, const void* cam_q, const void* cam_p,
           int N, const void* count, void* too_large, void* clocks, int n_inst, const int* inst,
           const long long* strides, void* stream) {
  static size_t budget = 0, smem_allowed = 0;
  if (D < 1 || n_inst < 1) return (int)cudaErrorInvalidValue;
  for (int s = 0; s < n_inst; ++s) {
    const int m = inst[3 * s + 1], qr = inst[3 * s + 2];
    if (m < 1 || (qr && m < D)) return (int)cudaErrorInvalidValue;
  }
  if (budget == 0) budget = msckf::smem_budget(update_kernel<T>);
  Fleet<T> f;
  Args<T>& a = f.base;
  a.P = (const T*)P;
  a.D = D;
  a.H = (const T*)H;
  a.r = (const T*)r;
  a.m = 0;
  a.qr = 0;
  a.noise = (const T*)noise;
  a.work = (T*)work;
  a.smem_update = 0;
  a.smem_qr = 0;
  a.out = (T*)out;
  a.state = msckf::InjectIn<T>{(const T*)q,     (const T*)bg,   (const T*)v,
                               (const T*)ba,    (const T*)p,    (const T*)R,
                               (const T*)t,     (const T*)cam_q, (const T*)cam_p,
                               (const int*)count, N};
  a.too_large = (uint8_t*)too_large;
  a.clocks = (long long*)clocks;
  for (int k = 0; k < kStrides; ++k) f.stride[k] = strides[k];
  for (int s0 = 0; s0 < n_inst; s0 += kMaxInst) {
    f.n = n_inst - s0 < kMaxInst ? n_inst - s0 : kMaxInst;
    size_t smem = 0;
    for (int s = 0; s < f.n; ++s) {
      const int* e = inst + 3 * (s0 + s);
      const int m = e[1], qr = e[2];
      const size_t up = layout(qr ? D : m, D).total * sizeof(T);
      const size_t qs = qr ? ((size_t)m + 33 * (size_t)(D + 1) + 32) * sizeof(T) : 0;
      const int su = up <= budget, sq = qs > 0 && qs <= budget;
      if (su && up > smem) smem = up;
      if (sq && qs > smem) smem = qs;
      f.inst[s] = e[0];
      f.m[s] = m;
      f.flags[s] = qr | (su << 1) | (sq << 2);
    }
    int err = msckf::allow_smem(update_kernel<T>, smem, &smem_allowed);
    if (err != 0) return err;
    update_kernel<T><<<f.n, kThreads, smem, (cudaStream_t)stream>>>(f);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    a.clocks = nullptr;  // the first launch's block 0 only
  }
  return 0;
}

}  // namespace

// P (D x D), H (rows x D, row stride D), r, obs_noise, work (16-byte
// aligned; an instance on the QR tier takes round4(m (D + 1)) + max(m +
// 33 (D + 1) + 32, layout(D, D).total) values, any other layout(m, D).total),
// out (P_new, delta, then the injected state), the state's q, bg, v, ba, p,
// R_imu_cam0, t_cam0_imu, cam_q, cam_p (all nullptr: no injection), N,
// count, too_large, clocks (7 int64 SM clock readings of the first
// instance's block at the phase boundaries, or nullptr), n_inst, inst
// (n_inst host triples: the instance's index, its rows m (QR: the stack's
// rows), its QR flag), strides (kStrides host int64: each pointer's
// instance stride, in elements), stream
#define EKF_ENTRY(NAME, T)                                                                   \
  extern "C" int NAME(const void* P, int D, const void* H, const void* r, const void* noise, \
                      void* work, void* out, const void* q, const void* bg, const void* v,   \
                      const void* ba, const void* p, const void* R, const void* t,           \
                      const void* cam_q, const void* cam_p, int N, const void* count,        \
                      void* too_large, void* clocks, int n_inst, const void* inst,           \
                      const void* strides, void* stream) {                                   \
    return update<T>(P, D, H, r, noise, work, out, q, bg, v, ba, p, R, t, cam_q, cam_p, N,   \
                     count, too_large, clocks, n_inst, (const int*)inst,                     \
                     (const long long*)strides, stream);                                     \
  }
EKF_ENTRY(ekf_update_f32, float)
EKF_ENTRY(ekf_update_f64, double)
