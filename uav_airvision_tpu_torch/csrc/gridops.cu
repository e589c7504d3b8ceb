// K5 + K8: per-cell top-k of a dense score map, and the stable per-cell
// ranking, kept-order statistics and compaction of flat feature arrays.
//
// Replaces uav_airvision_tpu/ops/gridops.py: dense_grid_topk (:147),
// smallest_k_indices (:17), stable_compact_indices (:36), rank_in_cell
// (:58), kept_order_stats (:91) and compact_kept (:129).  Every result
// equals a stable lexsort's, bit for bit.
//
// K5: one block per grid cell.  A pixel's key packs (value, ~in-cell flat
// index) into 64 bits, so the larger key is the larger value and, on a tie,
// the smaller index; keys are unique.  Each thread keeps the k largest keys
// of its strided share in registers, then k rounds of a block-wide maximum
// over the threads' best remaining keys give the cell's winners in order.
// Pixels of a cell past the image edge hold -1, as the padded map does.
//
// K8: n is a few hundred, so one block holds the keys in shared memory and
// thread i counts its predecessors under the strict total order; no sort.
//
// Bound on the card: bytes (K5 reads the 480 x 752 int32 map once, 1.4 MB;
// K8 a few KB), each far below a microsecond: launch-latency kernels.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTopkThreads = 1024;
constexpr int kMaxK = 8;
constexpr int kMaxN = 1024;  // K8: one thread per element, one block

__device__ inline unsigned long long topk_key(int value, int index) {
  return ((unsigned long long)((unsigned)value ^ 0x80000000u) << 32) | (unsigned)(~index);
}

__global__ void __launch_bounds__(kTopkThreads)
grid_topk_kernel(const int* __restrict__ score, int H, int W, int grid_col, int cell_h,
                 int cell_w, int k, int* __restrict__ ys, int* __restrict__ xs,
                 int* __restrict__ vals) {
  __shared__ unsigned long long warp_best[kTopkThreads / 32];
  __shared__ unsigned long long s_winner;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cell = blockIdx.x;
  const int y0 = (cell / grid_col) * cell_h, x0 = (cell % grid_col) * cell_w;
  const int cell_sz = cell_h * cell_w;

  unsigned long long best[kMaxK];  // descending; 0 is below every real key
#pragma unroll
  for (int s = 0; s < kMaxK; ++s) best[s] = 0ull;
  for (int idx = tid; idx < cell_sz; idx += kTopkThreads) {
    const int y = y0 + idx / cell_w, x = x0 + idx % cell_w;
    const int v = (y < H && x < W) ? score[(size_t)y * W + x] : -1;
    unsigned long long key = topk_key(v, idx);
    if (key > best[kMaxK - 1]) {
#pragma unroll
      for (int s = 0; s < kMaxK; ++s) {
        if (key > best[s]) {
          const unsigned long long t = best[s];
          best[s] = key;
          key = t;
        }
      }
    }
  }

  for (int round = 0; round < k; ++round) {
    unsigned long long m = best[0];
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long other = __shfl_xor_sync(0xffffffffu, m, o);
      m = other > m ? other : m;
    }
    if (lane == 0) warp_best[warp] = m;
    __syncthreads();
    if (warp == 0) {
      unsigned long long w = warp_best[lane];
      for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long other = __shfl_xor_sync(0xffffffffu, w, o);
        w = other > w ? other : w;
      }
      if (lane == 0) s_winner = w;
    }
    __syncthreads();
    const unsigned long long win = s_winner;
    if (best[0] == win && win != 0ull) {  // keys are unique: one owner
#pragma unroll
      for (int s = 0; s + 1 < kMaxK; ++s) best[s] = best[s + 1];
      best[kMaxK - 1] = 0ull;
      const int idx = (int)(~(unsigned)(win & 0xffffffffull));
      const int v = (int)((unsigned)(win >> 32) ^ 0x80000000u);
      const int o = cell * k + round;
      ys[o] = y0 + idx / cell_w;
      xs[o] = x0 + idx % cell_w;
      vals[o] = v;
    }
    __syncthreads();  // s_winner is rewritten next round
  }
}

// (cell asc, primary desc, arrival asc, index asc), invalid entries in cell
// n_cells: rank inside the cell, and the global sorted permutation
__global__ void __launch_bounds__(kMaxN)
rank_in_cell_kernel(const int* __restrict__ cell, const float* __restrict__ primary,
                    const int* __restrict__ arrival, const bool* __restrict__ valid, int n,
                    int n_cells, int* __restrict__ rank, int* __restrict__ perm) {
  __shared__ int s_cell[kMaxN], s_arr[kMaxN];
  __shared__ float s_pri[kMaxN];
  const int i = threadIdx.x;
  if (i < n) {
    s_cell[i] = valid[i] ? cell[i] : n_cells;
    s_pri[i] = primary[i];
    s_arr[i] = arrival[i];
  }
  __syncthreads();
  if (i >= n) return;
  const int ci = s_cell[i], ai = s_arr[i];
  const float pi = s_pri[i];
  int grank = 0, crank = 0;
  for (int j = 0; j < n; ++j) {
    const int cj = s_cell[j], aj = s_arr[j];
    const float pj = s_pri[j];
    const bool tie_pa = (pj == pi) && ((aj < ai) || ((aj == ai) && (j < i)));
    const bool in_cell_before = (pj > pi) || tie_pa;
    const bool same = cj == ci;
    grank += (cj < ci) || (same && in_cell_before);
    crank += same && in_cell_before;
  }
  rank[i] = crank;
  perm[grank] = i;
}

// ranks of the kept subset in perm order: among all kept, among the kept of
// the same cell (0 where not kept), and the kept count
__global__ void __launch_bounds__(kMaxN)
kept_order_stats_kernel(const int* __restrict__ perm, const bool* __restrict__ keep,
                        const int* __restrict__ cell, const bool* __restrict__ valid, int n,
                        int n_cells, int* __restrict__ global_rank,
                        int* __restrict__ cell_rank, int* __restrict__ n_kept) {
  __shared__ int s_pos[kMaxN], s_cell[kMaxN];
  __shared__ bool s_keep[kMaxN];
  const int i = threadIdx.x;
  if (i < n) {
    s_pos[perm[i]] = i;
    s_cell[i] = valid[i] ? cell[i] : n_cells;
    s_keep[i] = keep[i];
  }
  const int total = __syncthreads_count(i < n && keep[i]);
  if (i == 0) *n_kept = total;
  if (i >= n) return;
  const int pi = s_pos[i], ci = s_cell[i];
  int g = 0, c = 0;
  for (int j = 0; j < n; ++j) {
    const bool kept_before = s_keep[j] && s_pos[j] < pi;
    g += kept_before;
    c += kept_before && s_cell[j] == ci;
  }
  global_rank[i] = s_keep[i] ? g : 0;
  cell_rank[i] = s_keep[i] ? c : 0;
}

// the kept entries, in perm order, into the first slots of an n_slots table
__global__ void __launch_bounds__(kMaxN)
compact_kept_kernel(const int* __restrict__ perm, const bool* __restrict__ keep, int n,
                    int n_slots, int* __restrict__ sel, bool* __restrict__ selm) {
  __shared__ int s_pos[kMaxN];
  __shared__ bool s_keep[kMaxN];
  const int i = threadIdx.x;
  if (i < n) {
    s_pos[perm[i]] = i;
    s_keep[i] = keep[i];
  }
  const int total = __syncthreads_count(i < n && keep[i]);
  for (int s = i; s < n_slots; s += blockDim.x) {
    sel[s] = 0;
    selm[s] = s < total;
  }
  __syncthreads();
  if (i >= n || !s_keep[i]) return;
  const int pi = s_pos[i];
  int r = 0;
  for (int j = 0; j < n; ++j) r += s_keep[j] && s_pos[j] < pi;
  if (r < n_slots) sel[r] = i;
}

// the indices of the k smallest (key, index) pairs, ascending
__global__ void __launch_bounds__(kMaxN)
smallest_k_kernel(const int* __restrict__ key, int n, int k, int* __restrict__ out) {
  __shared__ int s_key[kMaxN];
  const int i = threadIdx.x;
  if (i < n) s_key[i] = key[i];
  for (int s = n + i; s < k; s += blockDim.x) out[s] = 0;  // slots past the keys
  __syncthreads();
  if (i >= n) return;
  const int ki = s_key[i];
  int r = 0;
  for (int j = 0; j < n; ++j) r += (s_key[j] < ki) || (s_key[j] == ki && j < i);
  if (r < k) out[r] = i;
}

// the indices where mask is set, ascending, padded with fill
__global__ void __launch_bounds__(kMaxN)
stable_compact_kernel(const bool* __restrict__ mask, int n, int fill, int* __restrict__ out) {
  __shared__ bool s_mask[kMaxN];
  const int i = threadIdx.x;
  if (i < n) s_mask[i] = mask[i];
  const int total = __syncthreads_count(i < n && mask[i]);
  if (i >= n) return;
  if (i >= total) out[i] = fill;
  if (!s_mask[i]) return;
  int r = 0;
  for (int j = 0; j < i; ++j) r += s_mask[j];
  out[r] = i;
}

inline int block_for(int n) { return n <= 32 ? 32 : (n + 31) / 32 * 32; }

}  // namespace

extern "C" int grid_topk_i32(const void* score, int H, int W, int grid_row, int grid_col,
                             int cell_h, int cell_w, int k, void* ys, void* xs, void* vals,
                             void* stream) {
  if (k < 1 || k > kMaxK || k > cell_h * cell_w) return (int)cudaErrorInvalidValue;
  grid_topk_kernel<<<grid_row * grid_col, kTopkThreads, 0, (cudaStream_t)stream>>>(
      (const int*)score, H, W, grid_col, cell_h, cell_w, k, (int*)ys, (int*)xs, (int*)vals);
  return (int)cudaGetLastError();
}

extern "C" int grid_rank_in_cell(const void* cell, const void* primary, const void* arrival,
                                 const void* valid, int n, int n_cells, void* rank, void* perm,
                                 void* stream) {
  if (n < 1 || n > kMaxN) return (int)cudaErrorInvalidValue;
  rank_in_cell_kernel<<<1, block_for(n), 0, (cudaStream_t)stream>>>(
      (const int*)cell, (const float*)primary, (const int*)arrival, (const bool*)valid, n,
      n_cells, (int*)rank, (int*)perm);
  return (int)cudaGetLastError();
}

extern "C" int grid_kept_order_stats(const void* perm, const void* keep, const void* cell,
                                     const void* valid, int n, int n_cells, void* global_rank,
                                     void* cell_rank, void* n_kept, void* stream) {
  if (n < 1 || n > kMaxN) return (int)cudaErrorInvalidValue;
  kept_order_stats_kernel<<<1, block_for(n), 0, (cudaStream_t)stream>>>(
      (const int*)perm, (const bool*)keep, (const int*)cell, (const bool*)valid, n, n_cells,
      (int*)global_rank, (int*)cell_rank, (int*)n_kept);
  return (int)cudaGetLastError();
}

extern "C" int grid_compact_kept(const void* perm, const void* keep, int n, int n_slots,
                                 void* sel, void* selm, void* stream) {
  if (n < 1 || n > kMaxN || n_slots < 1) return (int)cudaErrorInvalidValue;
  compact_kept_kernel<<<1, block_for(n), 0, (cudaStream_t)stream>>>(
      (const int*)perm, (const bool*)keep, n, n_slots, (int*)sel, (bool*)selm);
  return (int)cudaGetLastError();
}

extern "C" int grid_smallest_k(const void* key, int n, int k, void* out, void* stream) {
  if (n < 1 || n > kMaxN || k < 1) return (int)cudaErrorInvalidValue;
  smallest_k_kernel<<<1, block_for(n), 0, (cudaStream_t)stream>>>((const int*)key, n, k,
                                                                  (int*)out);
  return (int)cudaGetLastError();
}

extern "C" int grid_stable_compact(const void* mask, int n, int fill, void* out, void* stream) {
  if (n < 1 || n > kMaxN) return (int)cudaErrorInvalidValue;
  stable_compact_kernel<<<1, block_for(n), 0, (cudaStream_t)stream>>>((const bool*)mask, n, fill,
                                                                      (int*)out);
  return (int)cudaGetLastError();
}
