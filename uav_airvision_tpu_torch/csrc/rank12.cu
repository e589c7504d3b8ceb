// K12: the rank-12 EKF update of the camera prune, in push-through form.
//
// Replaces uav_airvision_tpu/models/msckf/update.py::apply_update_rank12
// (:239) with the error-state injection (_inject_delta :359), which a block
// runs once it has delta (msckf_common.cuh, shared with K11), and the
// masking of its call site (JAX step.py:548-549).  With B (n x 12) nonzero
// only in the 12 columns ``cols`` of the two pruned cameras, Pc = P[:, cols],
// P12 = Pc[cols]:
//   W = s2 I + B^T B P12 (not symmetric), [bsr | X] = W^-1 [B^T r | B^T B]
//   by LU with partial pivoting (never inverting P12, which can be exactly
//   singular after an IMU dropout), G = (X + X^T) / 2,
//   delta = Pc bsr, P_new = sym(P - (Pc G) Pc^T).
// B's rows come as ``n_feat`` features of ``rows_per`` rows each, read in
// place through their strides (the prune's H[:, :, 21:33] of K9's blocks),
// and a feature whose ``include`` is false is skipped: its rows are the
// zeros the JAX package masks them to, which change no sum.
//
// Layout: one block per 32x32 tile pair (I, J), I <= J, of P_new, in
// clusters of 8 (the grid padded to whole clusters).  Every block solves the
// small system itself, from the same sums added in the same order, so the
// same bits: no step across clusters.  At its start a block issues
// asynchronous copies (cp.async, neighbouring threads on neighbouring
// addresses) of its share of B's rows and r (cluster rank k takes features
// k, k + 8, ...), its two P tiles P[I, J] and P[J, I], and Pc.  Six warps
// sum the share's B'B (its 78 distinct entries) and B'r, one for each row
// pair (a, 11 - a) of [B'B | B'r] (15 sums), a feature a lane, then a
// butterfly of shuffles adds the lanes' sums; after one cluster barrier
// every block adds the 8 blocks' sums in rank order through distributed
// shared memory.  One warp runs the 12 x 25 LU on [W | B'r | B'B] with a
// column in each lane's registers (the pivot column is lane k's, so the
// pivot search, getrf's first largest |W_ik|, is one lane's; the row swap
// is each lane's own; the rows below scale by the pivot's reciprocal, as
// getf2 does), no block barrier inside; lanes 12-24 back-substitute their
// columns.  The tile pair is then written from the staged tiles: P_new[i,
// j] and P_new[j, i] are one value, written coalesced to both places.  One
// more block solves too and writes delta and the injected state, beside
// the tiles.
//
// Instances: a launch takes a fleet's pruning instances side by side, the
// grid (tile pairs and the injecting block, in whole clusters) x
// instances, blockIdx.y the instance; every pointer of instance inst[y]
// advanced by its instance stride.  Each instance keeps its own n_feat, and
// so its own feature split over the cluster (n_loc) and the order of its
// sums: its blocks compute exactly what its launch alone computes (the
// staging chunk, the same for all, changes no sum's order), and every block
// reaches every cluster barrier.  Up to kMaxInst instances a launch (in the
// launch's arguments); a call with more takes ceil(n_inst / kMaxInst).
//
// Bound on the card: bytes.  P is read and P_new written once (159 KB in
// float32 at D = 141); the work is ~1.2 MFLOP.  The time goes to the
// dependent chain of one block: the copies' round trip, the sums, the
// 12-step LU and the substitution.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "msckf_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;
constexpr int kPad = kTile + 1;    // a staged tile's row (no bank conflicts on its columns)
constexpr int kA = 25;             // augmented row: 12 of W, then B^T r, then 12 of B^T B
constexpr int kPairs = 6;          // rows (a, 11 - a) of [B^T B | B^T r]: 15 sums each, a warp each
constexpr int kSums = 90;          // 78 entries of B^T B (upper triangle), 12 of B^T r
constexpr int kCluster = 8;        // blocks sharing the sums: block rank r takes every 8th feature
constexpr int kStageBytes = 40 * 1024;  // B's rows and r, staged a chunk of features at a time
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxInst = 64;  // instances of one launch
// instance strides, in elements: P, B, r, include, cols, out, the injected
// state's q, bg, v, ba, p, R, t, cam_q, cam_p, count, then too_large
constexpr int kStrides = 17;

// A launch's instances: blockIdx.y = s takes instance inst[s] with n_feat[s]
// features
struct Inst12 {
  int n;
  int inst[kMaxInst];
  int n_feat[kMaxInst];
  long long stride[kStrides];
};

template <typename P>
__device__ __forceinline__ P* at(P* p, const Inst12& f, int k, int b) {
  return p == nullptr ? p : p + f.stride[k] * b;
}

// Index of B^T B's entry (a, c), a <= c, in the upper triangle row by row
__host__ __device__ constexpr int tri(int a, int c) { return a * 12 - a * (a - 1) / 2 + c - a; }

// Add a staged row [b | r] (13 values) to the 15 sums of row pair A:
// B^T B (A, A..11), B^T r (A), B^T B (11-A, 11-A..11), B^T r (11-A)
template <int A, typename T>
__device__ __forceinline__ void add_row(const T* row, T (&acc)[15]) {
  constexpr int A2 = 11 - A;
#pragma unroll
  for (int c = A; c < 12; ++c) acc[c - A] += row[A] * row[c];
  acc[12 - A] += row[A] * row[12];
#pragma unroll
  for (int c = A2; c < 12; ++c) acc[13 - A + c - A2] += row[A2] * row[c];
  acc[14] += row[A2] * row[12];
}

// The row pair's 15 sums over the warp (a butterfly: every lane, every
// block, the same order), written by lane 0 to ``part`` (the upper triangle
// of B^T B row by row, then B^T r).
template <int A, typename T>
__device__ __forceinline__ void store_sums(T (&acc)[15], int lane, T* part) {
  constexpr int A2 = 11 - A;
#pragma unroll
  for (int e = 0; e < 15; ++e)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc[e] += __shfl_xor_sync(kFull, acc[e], o);
  if (lane != 0) return;
#pragma unroll
  for (int c = A; c < 12; ++c) part[tri(A, c)] = acc[c - A];
  part[78 + A] = acc[12 - A];
#pragma unroll
  for (int c = A2; c < 12; ++c) part[tri(A2, c)] = acc[13 - A + c - A2];
  part[78 + A2] = acc[14];
}

// q / d for q < 2^16 and 1 < d < 2^16 with magic = 2^32 / d + 1 (d = 1: q)
__device__ __forceinline__ int div_rows(int q, int d, unsigned magic) {
  return d == 1 ? q : (int)__umulhi((unsigned)q, magic);
}

// This block's staged features [i0, i1) (its own, every kCluster-th) that
// fall to this lane (local feature i to lane i mod 32), included ones only
// (``flag``: nullptr, every one), a feature's rows in order.
template <int A, typename T>
__device__ __forceinline__ void add_rows(const T* stage, const int* flag, int i0, int i1,
                                         int rows_per, int lane, T (&acc)[15]) {
  for (int i = i0 + ((lane - i0) & 31); i < i1; i += 32) {
    if (flag != nullptr && flag[i] == 0) continue;
    const T* row = stage + (i - i0) * rows_per * 13;
    for (int j = 0; j < rows_per; ++j) add_row<A>(row + j * 13, acc);
  }
}

// One step of the LU on [W | B'r | B'B], a column a lane: getrf's pivot in
// lane K's column (the first largest |W_iK|), the row swap in every lane,
// then the rows below scaled by the pivot's reciprocal (getf2's scaling).
template <int K, typename T>
__device__ __forceinline__ void lu_step(T (&col)[12], int lane) {
  int p = K;
  T best = fabs(col[K]);
#pragma unroll
  for (int i = K + 1; i < 12; ++i) {
    const T v = fabs(col[i]);
    if (v > best) {
      best = v;
      p = i;
    }
  }
  p = __shfl_sync(kFull, p, K);
#pragma unroll
  for (int i = K + 1; i < 12; ++i) {
    if (p == i) {
      const T t = col[K];
      col[K] = col[i];
      col[i] = t;
    }
  }
  const T inv = msckf::rcp(__shfl_sync(kFull, col[K], K));
#pragma unroll
  for (int i = K + 1; i < 12; ++i) {
    const T m = __shfl_sync(kFull, col[i], K) * inv;
    if (lane > K) col[i] = col[i] - m * col[K];
  }
}

// Row I of the back substitution U x = y (U in the augmented rows, the
// reciprocals of its diagonal in rdiag)
template <int I, typename T>
__device__ __forceinline__ void back_step(const T (&col)[12], T (&x)[12], const T* U,
                                          const T* rdiag) {
  T s = col[I];
#pragma unroll
  for (int k = I + 1; k < 12; ++k) s -= U[I * kA + k] * x[k];
  x[I] = s * rdiag[I];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rank12_kernel(const T* P0, int D, const T* Bm0, int rows_per, long long hs_f, long long hs_r,
              const T* r0, long long rs_f, long long rs_r, const bool* include0,
              const int64_t* cols0, const T* __restrict__ obs_noise, int chunk, T* out0,
              const msckf::InjectIn<T> state0, uint8_t* too_large0, long long* clocks0,
              const __grid_constant__ Inst12 f) {
  // this block's instance
  const int inst = f.inst[blockIdx.y], n_feat = f.n_feat[blockIdx.y];
  const T* __restrict__ P = at(P0, f, 0, inst);
  const T* __restrict__ Bm = at(Bm0, f, 1, inst);
  const T* __restrict__ r = at(r0, f, 2, inst);
  const bool* __restrict__ include = at(include0, f, 3, inst);
  const int64_t* __restrict__ cols = at(cols0, f, 4, inst);
  T* __restrict__ P_out = at(out0, f, 5, inst);
  T* __restrict__ delta = P_out + (size_t)D * D;
  msckf::InjectIn<T> state = state0;
  state.q = at(state.q, f, 6, inst);
  state.bg = at(state.bg, f, 7, inst);
  state.v = at(state.v, f, 8, inst);
  state.ba = at(state.ba, f, 9, inst);
  state.p = at(state.p, f, 10, inst);
  state.R = at(state.R, f, 11, inst);
  state.t = at(state.t, f, 12, inst);
  state.cam_q = at(state.cam_q, f, 13, inst);
  state.cam_p = at(state.cam_p, f, 14, inst);
  state.count = at(state.count, f, 15, inst);
  uint8_t* __restrict__ too_large = at(too_large0, f, 16, inst);
  long long* __restrict__ clocks = blockIdx.y == 0 ? clocks0 : nullptr;
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  T* Pc = reinterpret_cast<T*>(dyn_smem);  // D x 12
  T* tA = Pc + D * 12;                      // P[I, J], then P_new there
  T* tB = tA + kTile * kPad;                // P[J, I]
  T* PcG = tB + kTile * kPad;               // (Pc G)[I], then (Pc G)[J]
  T* stage = PcG + 2 * kTile * 12;          // a chunk of this block's features' rows [b | r]
  int* flag = reinterpret_cast<int*>(stage + chunk * rows_per * 13);  // its include flags
  __shared__ T part[kSums], BtB[144], aug[12 * kA], G[144], bsr[12], rdiag[12];
  __shared__ int cidx[12];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = (D + kTile - 1) / kTile, n_pairs = nt * (nt + 1) / 2;
  // blocks 0 .. n_pairs - 1 write a tile pair each, block n_pairs delta and
  // the injected state; those past it only add their share of the sums
  const bool tiled = (int)blockIdx.x < n_pairs, injector = (int)blockIdx.x == n_pairs;
  const bool solver = tiled || injector;
  const bool timed = clocks != nullptr && (int)blockIdx.x == min(1, n_pairs - 1) && tid == 0;
  if (timed) clocks[0] = clock64();

  // this block's tile pair: the blockIdx.x-th of the upper triangle, row by row
  int ti = 0, b = tiled ? (int)blockIdx.x : 0;
  while (b >= nt - ti) b -= nt - ti++;
  const int tj = ti + b;
  const int I0 = ti * kTile, J0 = tj * kTile;
  const int ni = min(kTile, D - I0), nj = min(kTile, D - J0);

  // this block's features: rank, rank + kCluster, ... (local index i)
  const int n_loc = rank < n_feat ? (n_feat - rank + kCluster - 1) / kCluster : 0;
  const unsigned magic = 0xffffffffu / (unsigned)rows_per + 1u;
  auto stage_rows = [&](int i0, int i1) {  // neighbouring threads, neighbouring columns
    const int nrows = (i1 - i0) * rows_per;
    for (int e = tid; e < nrows * 12; e += kThreads) {
      const int q = e / 12, c = e - q * 12;
      const int fc = div_rows(q, rows_per, magic), j = q - fc * rows_per;
      const long long f = rank + (long long)kCluster * (i0 + fc);
      msckf::cp_async<sizeof(T)>(stage + q * 13 + c, Bm + f * hs_f + j * hs_r + c);
    }
    for (int q = tid; q < nrows; q += kThreads) {
      const int fc = div_rows(q, rows_per, magic), j = q - fc * rows_per;
      const long long f = rank + (long long)kCluster * (i0 + fc);
      msckf::cp_async<sizeof(T)>(stage + q * 13 + 12, r + f * rs_f + j * rs_r);
    }
  };
  // three groups of copies, in the order they are needed: the first chunk
  // of this block's rows of B and r (the sums), the two tiles (the band),
  // then Pc (W; issued once cols is in shared memory, its round trip under
  // the sums and the cluster's exchange)
  stage_rows(0, min(n_loc, chunk));
  msckf::cp_async_commit();
  for (int e = tid; tiled && e < kTile * kTile; e += kThreads) {
    const int a = e >> 5, c = e & 31;
    if (a < ni && c < nj)
      msckf::cp_async<sizeof(T)>(tA + a * kPad + c, P + (size_t)(I0 + a) * D + J0 + c);
    if (a < nj && c < ni)
      msckf::cp_async<sizeof(T)>(tB + a * kPad + c, P + (size_t)(J0 + a) * D + I0 + c);
  }
  msckf::cp_async_commit();
  if (tid < 12) cidx[tid] = (int)cols[tid];
  if (include != nullptr)
    for (int i = tid; i < n_loc; i += kThreads) flag[i] = include[rank + kCluster * i] ? 1 : 0;
  msckf::cp_async_wait<1>();  // this block's rows of B and r
  __syncthreads();            // and cidx and the flags
  for (int e = tid; solver && e < D * 12; e += kThreads) {
    const int i = e / 12, c = e - i * 12;
    msckf::cp_async<sizeof(T)>(Pc + e, P + (size_t)i * D + cidx[c]);
  }
  msckf::cp_async_commit();
  if (timed) clocks[1] = clock64();
  const int* fl = include != nullptr ? flag : nullptr;

  // this block's share of B^T B and B^T r: a row pair a warp, a feature a
  // lane, chunk by chunk
  T acc[15];
#pragma unroll
  for (int e = 0; e < 15; ++e) acc[e] = T(0);
  for (int i0 = 0; i0 < n_loc; i0 += chunk) {
    const int i1 = min(n_loc, i0 + chunk);
    if (i0 > 0) {
      __syncthreads();  // the previous chunk is summed
      stage_rows(i0, i1);
      msckf::cp_async_commit();
      msckf::cp_async_wait<0>();  // and the tiles
      __syncthreads();
    }
    switch (warp) {  // uniform over the warp
      case 0: add_rows<0>(stage, fl, i0, i1, rows_per, lane, acc); break;
      case 1: add_rows<1>(stage, fl, i0, i1, rows_per, lane, acc); break;
      case 2: add_rows<2>(stage, fl, i0, i1, rows_per, lane, acc); break;
      case 3: add_rows<3>(stage, fl, i0, i1, rows_per, lane, acc); break;
      case 4: add_rows<4>(stage, fl, i0, i1, rows_per, lane, acc); break;
      case 5: add_rows<5>(stage, fl, i0, i1, rows_per, lane, acc); break;
      default: break;
    }
  }
  switch (warp) {
    case 0: store_sums<0>(acc, lane, part); break;
    case 1: store_sums<1>(acc, lane, part); break;
    case 2: store_sums<2>(acc, lane, part); break;
    case 3: store_sums<3>(acc, lane, part); break;
    case 4: store_sums<4>(acc, lane, part); break;
    case 5: store_sums<5>(acc, lane, part); break;
    default: break;
  }
  // the cluster's partial sums, added in rank order by every block: the
  // same bits in every block
  cluster.sync();
  if (solver && tid < kSums) {
    T s = T(0);
#pragma unroll
    for (int k = 0; k < kCluster; ++k) s += cluster.map_shared_rank(part, k)[tid];
    if (tid < 78) {
      int a = 0;
      while (tid >= tri(a, 11) + 1) ++a;
      const int c = a + tid - tri(a, a);
      BtB[a * 12 + c] = s;
      BtB[c * 12 + a] = s;
    } else {
      aug[(tid - 78) * kA + 12] = s;
    }
  }
  // no block leaves while another may still read its partial sums (the
  // matching wait ends the kernel)
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  if (!solver) {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    return;
  }
  msckf::cp_async_wait<0>();  // Pc and the tiles
  __syncthreads();
  if (timed) clocks[2] = clock64();
  if (tid < 144) {
    const int a = tid / 12, c = tid % 12;
    T w = T(0);
    for (int k = 0; k < 12; ++k) w += BtB[a * 12 + k] * Pc[cidx[k] * 12 + c];
    aug[a * kA + c] = (a == c ? *obs_noise : T(0)) + w;
    aug[a * kA + 13 + c] = BtB[tid];
  }
  __syncthreads();
  if (timed) clocks[3] = clock64();

  if (warp == 0) {  // the LU and the substitution, a column of [W | B'r | B'B] a lane
    T col[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) col[i] = lane < kA ? aug[i * kA + lane] : T(0);
    lu_step<0>(col, lane);
    lu_step<1>(col, lane);
    lu_step<2>(col, lane);
    lu_step<3>(col, lane);
    lu_step<4>(col, lane);
    lu_step<5>(col, lane);
    lu_step<6>(col, lane);
    lu_step<7>(col, lane);
    lu_step<8>(col, lane);
    lu_step<9>(col, lane);
    lu_step<10>(col, lane);
    lu_step<11>(col, lane);
    T d = T(1);  // lane l < 12: U's diagonal entry l
#pragma unroll
    for (int i = 0; i < 12; ++i)
      if (lane == i) d = col[i];
    if (lane < 12) rdiag[lane] = msckf::rcp(d);
    if (lane < kA) {
#pragma unroll
      for (int i = 0; i < 12; ++i) aug[i * kA + lane] = col[i];
    }
    __syncwarp();
    if (lane >= 12 && lane < kA) {
      T x[12];
      back_step<11>(col, x, aug, rdiag);
      back_step<10>(col, x, aug, rdiag);
      back_step<9>(col, x, aug, rdiag);
      back_step<8>(col, x, aug, rdiag);
      back_step<7>(col, x, aug, rdiag);
      back_step<6>(col, x, aug, rdiag);
      back_step<5>(col, x, aug, rdiag);
      back_step<4>(col, x, aug, rdiag);
      back_step<3>(col, x, aug, rdiag);
      back_step<2>(col, x, aug, rdiag);
      back_step<1>(col, x, aug, rdiag);
      back_step<0>(col, x, aug, rdiag);
#pragma unroll
      for (int i = 0; i < 12; ++i) aug[i * kA + lane] = x[i];
    }
  }
  __syncthreads();
  if (timed) clocks[4] = clock64();
  if (tid < 144) {
    const int a = tid / 12, c = tid % 12;
    G[tid] = (aug[a * kA + 13 + c] + aug[c * kA + 13 + a]) / T(2);
  } else if (tid < 156) {
    bsr[tid - 144] = aug[(tid - 144) * kA + 12];
  }
  __syncthreads();

  if (injector) {  // delta = Pc bsr and the injection
    for (int i = tid; i < D; i += kThreads) {
      T acc2 = T(0);
      for (int a = 0; a < 12; ++a) acc2 += Pc[i * 12 + a] * bsr[a];
      delta[i] = acc2;
    }
    if (state.q != nullptr) {  // uniform over the block
      __syncthreads();         // delta is complete
      msckf::inject(delta, state, delta + D, too_large);
    }
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    return;
  }

  // (Pc G) of the tiles' rows
  const int n_rows = ti == tj ? ni : ni + nj;
  for (int e = tid; e < n_rows * 12; e += kThreads) {
    const int q = e / 12, c = e - q * 12;
    const int i = q < ni ? I0 + q : J0 + q - ni;
    T acc2 = T(0);
    for (int a = 0; a < 12; ++a) acc2 += Pc[i * 12 + a] * G[a * 12 + c];
    PcG[e] = acc2;
  }
  __syncthreads();
  if (timed) clocks[5] = clock64();

  // the tile pair: x = ((P_ij - m_ij) + (P_ji - m_ji)) / 2 to (i, j) and (j, i)
  const T* PcGJ = ti == tj ? PcG : PcG + ni * 12;
  for (int e = tid; e < kTile * kTile; e += kThreads) {
    const int a = e >> 5, c = e & 31;  // row in I, column in J
    if (a >= ni || c >= nj) continue;
    const int i = I0 + a, j = J0 + c;
    T mij = T(0), mji = T(0);
    for (int k = 0; k < 12; ++k) {
      mij += PcG[a * 12 + k] * Pc[j * 12 + k];
      mji += PcGJ[c * 12 + k] * Pc[i * 12 + k];
    }
    const T xij = tA[a * kPad + c] - mij, xji = tB[c * kPad + a] - mji;
    const T x = (xij + xji) / T(2);
    P_out[(size_t)i * D + j] = x;
    tA[a * kPad + c] = x;
  }
  if (ti != tj) {
    __syncthreads();
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      const int a = e >> 5, c = e & 31;  // row in J, column in I
      if (a < nj && c < ni) P_out[(size_t)(J0 + a) * D + I0 + c] = tA[c * kPad + a];
    }
  }
  if (clocks != nullptr && (int)blockIdx.x == min(1, n_pairs - 1)) {
    __syncthreads();
    if (tid == 0) clocks[6] = clock64();
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <typename T>
int launch(const void* P, int D, const void* Bm, int rows_per, long long hs_f, long long hs_r,
           const void* r, long long rs_f, long long rs_r, const void* include, const void* cols,
           const void* obs_noise, void* out, const void* q, const void* bg, const void* v,
           const void* ba, const void* p, const void* R, const void* t, const void* cam_q,
           const void* cam_p, int N, const void* count, void* too_large, void* clocks,
           int n_inst, const int* inst, const long long* strides, void* stream) {
  static size_t smem_allowed = 0;
  if (D < 12 || rows_per < 1 || n_inst < 1) return (int)cudaErrorInvalidValue;
  for (int s = 0; s < n_inst; ++s)
    if (inst[2 * s + 1] < 1) return (int)cudaErrorInvalidValue;
  const int nt = (D + kTile - 1) / kTile, n_pairs = nt * (nt + 1) / 2;
  const msckf::InjectIn<T> state{(const T*)q, (const T*)bg, (const T*)v, (const T*)ba,
                                 (const T*)p, (const T*)R, (const T*)t, (const T*)cam_q,
                                 (const T*)cam_p, (const int*)count, N};
  Inst12 f;
  for (int k = 0; k < kStrides; ++k) f.stride[k] = strides[k];
  for (int s0 = 0; s0 < n_inst; s0 += kMaxInst) {
    f.n = n_inst - s0 < kMaxInst ? n_inst - s0 : kMaxInst;
    int n_loc = 1;  // rank 0's features, the most of any rank, of the widest instance
    for (int s = 0; s < f.n; ++s) {
      f.inst[s] = inst[2 * (s0 + s)];
      f.n_feat[s] = inst[2 * (s0 + s) + 1];
      const int loc = (f.n_feat[s] + kCluster - 1) / kCluster;
      if (loc > n_loc) n_loc = loc;
    }
    const int per_chunk = kStageBytes / (13 * (int)sizeof(T) * rows_per);
    const int chunk = per_chunk < 1 ? 1 : (per_chunk < n_loc ? per_chunk : n_loc);
    const size_t smem = ((size_t)D * 12 + 2 * kTile * kPad + 2 * kTile * 12 +
                         (size_t)chunk * rows_per * 13) * sizeof(T) +
                        (include != nullptr ? (size_t)n_loc * sizeof(int) : 0);
    int err = msckf::allow_smem(rank12_kernel<T>, smem, &smem_allowed);
    if (err != 0) return err;
    cudaLaunchConfig_t cfg = {};
    // the tile pairs and the injecting block, in whole clusters, by the instances
    cfg.gridDim = dim3((n_pairs + kCluster) / kCluster * kCluster, f.n);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaLaunchKernelEx(&cfg, rank12_kernel<T>, (const T*)P, D, (const T*)Bm, rows_per, hs_f,
                       hs_r, (const T*)r, rs_f, rs_r, (const bool*)include,
                       (const int64_t*)cols, (const T*)obs_noise, chunk, (T*)out, state,
                       (uint8_t*)too_large, (long long*)clocks, f);
    err = (int)cudaGetLastError();  // the launch's error, cleared for the next launch
    if (err != 0) return err;
    clocks = nullptr;  // the first launch's only
  }
  return 0;
}

}  // namespace

// P, D, B, rows_per, B's feature and row strides (its columns contiguous),
// r, r's feature and row strides, include (n_feat bools an instance or
// nullptr: every feature), cols, obs_noise, out (P_new, delta, then the
// injected state), the state's q, bg, v, ba, p, R_imu_cam0, t_cam0_imu,
// cam_q, cam_p (all nullptr: no injection), N, count, too_large, clocks (7
// int64 or null: the first instance's block 1 (the first off-diagonal tile
// pair's) SM clock at its start and at the end of each of its six phases),
// n_inst, inst (n_inst host pairs: the instance's index, its n_feat),
// strides (kStrides host int64: each pointer's instance stride, in
// elements), stream
#define RANK12_ENTRY(NAME, T)                                                                 \
  extern "C" int NAME(const void* P, int D, const void* Bm, int rows_per, long long hs_f,    \
                      long long hs_r, const void* r, long long rs_f, long long rs_r,          \
                      const void* include, const void* cols, const void* obs_noise,           \
                      void* out, const void* q, const void* bg, const void* v,                \
                      const void* ba, const void* p, const void* R, const void* t,            \
                      const void* cam_q, const void* cam_p, int N, const void* count,         \
                      void* too_large, void* clocks, int n_inst, const void* inst,            \
                      const void* strides, void* stream) {                                    \
    return launch<T>(P, D, Bm, rows_per, hs_f, hs_r, r, rs_f, rs_r, include, cols, obs_noise, \
                     out, q, bg, v, ba, p, R, t, cam_q, cam_p, N, count, too_large, clocks,   \
                     n_inst, (const int*)inst, (const long long*)strides, stream);            \
  }
RANK12_ENTRY(rank12_f32, float)
RANK12_ENTRY(rank12_f64, double)
