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
// the smaller index; keys are unique.  Each thread keeps the 8 largest keys
// of its strided share in registers, then k rounds of a block-wide maximum
// over the threads' best remaining keys give the cell's winners in order.
// A thread whose 8 keys are all taken while its share holds more rescans
// the share for the 8 largest keys below its last winner, so any k up to
// the cell's pixel count runs (a k <= 8 never rescans).  Pixels of a cell
// past the image edge hold -1, as the padded map does.
//
// K8: n is a few hundred to a few thousand, so one block of up to 1024
// threads counts, for each element it owns (a strided share), its
// predecessors under the strict total order; no sort.  The keys sit in
// dynamic shared memory sized to n, or, past what a block's shared memory
// holds, are read from device memory (L2).  kept_order_stats and
// compact_kept walk the sorted order (positions q, element perm[q]) so they
// need no inverse permutation.
//
// grid_select_track_f32 is the front-end's whole per-cell selection of a
// tracked frame in one launch of one block (the JAX package's
// models/frontend/pipeline.py:388-440, where eager PyTorch took ~60
// launches): the cells of the tracked points and the new candidates, the
// candidates' rank, ids and insertion order, the per-cell counts and their
// overflow, the prune rank, and the compaction of the kept entries in prune
// order into the F slots, gathered.  Each phase counts predecessors as the
// entry points above do, on keys staged in shared memory (or a device
// workspace past it), with a barrier between phases.
//
// Bound on the card: bytes (K5 reads the 480 x 752 int32 map once, 1.4 MB;
// K8 a few KB), each far below a microsecond: launch-latency kernels.

#include <cuda_runtime.h>
#include <stdint.h>

#include "msckf_common.cuh"

namespace {

constexpr int kTopkThreads = 1024;
constexpr int kBest = 8;  // keys a thread keeps between rescans of its share
constexpr int kMaxThreads = 1024;

__device__ inline unsigned long long topk_key(int value, int index) {
  return ((unsigned long long)((unsigned)value ^ 0x80000000u) << 32) | (unsigned)(~index);
}

// The kBest largest keys of this thread's strided share of the cell,
// descending, of those below ``below`` when ``bounded``; 0 pads (below every
// real key).
__device__ void best_of_share(const int* __restrict__ score, int H, int W, int y0, int x0,
                              int cell_w, int cell_sz, bool bounded, unsigned long long below,
                              unsigned long long (&best)[kBest]) {
#pragma unroll
  for (int s = 0; s < kBest; ++s) best[s] = 0ull;
  for (int idx = threadIdx.x; idx < cell_sz; idx += kTopkThreads) {
    const int y = y0 + idx / cell_w, x = x0 + idx % cell_w;
    const int v = (y < H && x < W) ? score[(size_t)y * W + x] : -1;
    unsigned long long key = topk_key(v, idx);
    if ((!bounded || key < below) && key > best[kBest - 1]) {
#pragma unroll
      for (int s = 0; s < kBest; ++s) {
        if (key > best[s]) {
          const unsigned long long t = best[s];
          best[s] = key;
          key = t;
        }
      }
    }
  }
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
  const int share = tid < cell_sz ? (cell_sz - 1 - tid) / kTopkThreads + 1 : 0;

  unsigned long long best[kBest];  // descending; 0 is below every real key
  best_of_share(score, H, W, y0, x0, cell_w, cell_sz, false, 0ull, best);
  int taken = 0;  // winners from this thread's share so far

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
      for (int s = 0; s + 1 < kBest; ++s) best[s] = best[s + 1];
      best[kBest - 1] = 0ull;
      ++taken;
      if (best[0] == 0ull && taken < share)  // refill below the last winner
        best_of_share(score, H, W, y0, x0, cell_w, cell_sz, true, win, best);
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

// Number of elements with a nonzero ``local`` over the block (every thread
// gets it); ``s_total`` is shared.
__device__ inline int block_count(int local, int* s_total) {
  if (threadIdx.x == 0) *s_total = 0;
  __syncthreads();
  if (local != 0) atomicAdd(s_total, local);
  __syncthreads();
  return *s_total;
}

// (cell asc, primary desc, arrival asc, index asc), invalid entries in cell
// n_cells: rank inside the cell, and the global sorted permutation
__global__ void __launch_bounds__(kMaxThreads)
rank_in_cell_kernel(const int* __restrict__ cell, const float* __restrict__ primary,
                    const int* __restrict__ arrival, const bool* __restrict__ valid, int n,
                    int n_cells, int* __restrict__ rank, int* __restrict__ perm, int staged) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  int* s_cell = reinterpret_cast<int*>(dyn_smem);
  int* s_arr = s_cell + n;
  float* s_pri = reinterpret_cast<float*>(s_arr + n);
  if (staged) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      s_cell[i] = valid[i] ? cell[i] : n_cells;
      s_pri[i] = primary[i];
      s_arr[i] = arrival[i];
    }
    __syncthreads();
  }
  auto key = [&](int j, int& c, float& p, int& a) {
    c = staged ? s_cell[j] : (valid[j] ? cell[j] : n_cells);
    p = staged ? s_pri[j] : primary[j];
    a = staged ? s_arr[j] : arrival[j];
  };
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int ci, ai;
    float pi;
    key(i, ci, pi, ai);
    int grank = 0, crank = 0;
    for (int j = 0; j < n; ++j) {
      int cj, aj;
      float pj;
      key(j, cj, pj, aj);
      const bool tie_pa = (pj == pi) && ((aj < ai) || ((aj == ai) && (j < i)));
      const bool in_cell_before = (pj > pi) || tie_pa;
      const bool same = cj == ci;
      grank += (cj < ci) || (same && in_cell_before);
      crank += same && in_cell_before;
    }
    rank[i] = crank;
    perm[grank] = i;
  }
}

// ranks of the kept subset in perm order: among all kept, among the kept of
// the same cell (0 where not kept), and the kept count.  The thread of
// position q counts the kept entries at positions before q.
__global__ void __launch_bounds__(kMaxThreads)
kept_order_stats_kernel(const int* __restrict__ perm, const bool* __restrict__ keep,
                        const int* __restrict__ cell, const bool* __restrict__ valid, int n,
                        int n_cells, int* __restrict__ global_rank, int* __restrict__ cell_rank,
                        int* __restrict__ n_kept, int staged) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  __shared__ int s_total;
  int* s_cell = reinterpret_cast<int*>(dyn_smem);  // of the element at position q
  bool* s_keep = reinterpret_cast<bool*>(s_cell + n);
  int local = 0;
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    const int i = perm[q];
    if (staged) {
      s_cell[q] = valid[i] ? cell[i] : n_cells;
      s_keep[q] = keep[i];
    }
    local += keep[q];
  }
  const int total = block_count(local, &s_total);  // its barriers publish the staging
  if (threadIdx.x == 0) *n_kept = total;
  auto at = [&](int q, int& c, bool& k) {
    if (staged) {
      c = s_cell[q];
      k = s_keep[q];
    } else {
      const int i = perm[q];
      c = valid[i] ? cell[i] : n_cells;
      k = keep[i];
    }
  };
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    const int i = perm[q];
    int ci;
    bool ki;
    at(q, ci, ki);
    int g = 0, c = 0;
    for (int p = 0; p < q; ++p) {
      int cp;
      bool kp;
      at(p, cp, kp);
      g += kp;
      c += kp && cp == ci;
    }
    global_rank[i] = ki ? g : 0;
    cell_rank[i] = ki ? c : 0;
  }
}

// the kept entries, in perm order, into the first slots of an n_slots table
__global__ void __launch_bounds__(kMaxThreads)
compact_kept_kernel(const int* __restrict__ perm, const bool* __restrict__ keep, int n,
                    int n_slots, int* __restrict__ sel, bool* __restrict__ selm, int staged) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  __shared__ int s_total;
  bool* s_keep = reinterpret_cast<bool*>(dyn_smem);  // of the element at position q
  int local = 0;
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    if (staged) s_keep[q] = keep[perm[q]];
    local += keep[q];
  }
  const int total = block_count(local, &s_total);
  for (int s = threadIdx.x; s < n_slots; s += blockDim.x) {
    sel[s] = 0;
    selm[s] = s < total;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    const int i = perm[q];
    if (!keep[i]) continue;
    int r = 0;
    for (int p = 0; p < q; ++p) r += staged ? s_keep[p] : keep[perm[p]];
    if (r < n_slots) sel[r] = i;
  }
}

// the indices of the k smallest (key, index) pairs, ascending
__global__ void __launch_bounds__(kMaxThreads)
smallest_k_kernel(const int* __restrict__ key, int n, int k, int* __restrict__ out,
                  int staged) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  int* s_key = reinterpret_cast<int*>(dyn_smem);
  if (staged) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) s_key[i] = key[i];
    __syncthreads();
  }
  for (int s = n + threadIdx.x; s < k; s += blockDim.x) out[s] = 0;  // slots past the keys
  const int* kk = staged ? s_key : key;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int ki = kk[i];
    int r = 0;
    for (int j = 0; j < n; ++j) r += (kk[j] < ki) || (kk[j] == ki && j < i);
    if (r < k) out[r] = i;
  }
}

// the indices where mask is set, ascending, padded with fill
__global__ void __launch_bounds__(kMaxThreads)
stable_compact_kernel(const bool* __restrict__ mask, int n, int fill, int* __restrict__ out,
                      int staged) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  __shared__ int s_total;
  bool* s_mask = reinterpret_cast<bool*>(dyn_smem);
  int local = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (staged) s_mask[i] = mask[i];
    local += mask[i];
  }
  const int total = block_count(local, &s_total);
  const bool* mm = staged ? s_mask : mask;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (i >= total) out[i] = fill;
    if (!mm[i]) continue;
    int r = 0;
    for (int j = 0; j < i; ++j) r += mm[j];
    out[r] = i;
  }
}

// The selection's key of an entry: its cell (n_cells where it takes no
// part, kOut once a phase has excluded it), its arrival and its primary key,
// one 16-byte load.
struct __align__(16) SelKey {
  int cell;
  int arr;
  float pri;
  int pad;
};
constexpr int kOut = 0x7fffffff;  // a cell after every real one

// Does entry j (key kj) come before entry i (key ki) under (cell asc,
// primary desc, arrival asc, index asc)?
__device__ inline bool key_before(const SelKey& kj, int j, const SelKey& ki, int i) {
  return kj.cell < ki.cell ||
         (kj.cell == ki.cell &&
          (kj.pri > ki.pri || (kj.pri == ki.pri && (kj.arr < ki.arr || (kj.arr == ki.arr && j < i)))));
}

// Entries of [j0, j1) before entry i within i's cell / in the whole order,
// counted by the ``sub`` lanes of a group (a power of two, aligned in its
// warp), each taking every sub-th entry; every lane of the warp calls it
// (an idle group with j1 = j0).
template <bool kInCell>
__device__ inline int count_before(const SelKey* key, int j0, int j1, int i, int lane, int sub) {
  const SelKey ki = key[i];
  int r = 0;
#pragma unroll 4
  for (int j = j0 + lane; j < j1; j += sub) {
    const SelKey kj = key[j];
    r += (kInCell ? kj.cell == ki.cell : true) && key_before(kj, j, ki, i);
  }
  for (int o = sub >> 1; o > 0; o >>= 1) r += __shfl_xor_sync(0xffffffffu, r, o);
  return r;
}

// The selection's working arrays for n = F + C entries: the keys (n), the
// candidates' rank and id (C each), the per-cell counts, the kept entries
// in order (F), the flags (n bytes).
__host__ __device__ inline size_t select_bytes(int F, int C, int n_cells) {
  return (size_t)16 * (F + C) + (size_t)4 * (2 * C + n_cells + F) + (F + C);
}

// Flags of an entry of the selection (tracked slots, then candidates)
constexpr unsigned char kInlier = 1;  // tracked, or a stereo-matched candidate
constexpr unsigned char kNew = 2;     // a candidate among its cell's best grid_min
constexpr unsigned char kKeep = 4;    // survives the per-cell prune

struct SelectIn {
  const float* curr;       // (F, 2) tracked points in this frame
  const float* cam1_curr;  // (F, 2)
  const bool* tracked;     // (F,)
  const int* ids;          // (F,)
  const int* lifetime;     // (F,)
  const float* apts;       // (C, 2) candidates
  const int* ascore;       // (C,)
  const int* aarrival;     // (C,)
  const bool* ainlier;     // (C,)
  const float* acam1;      // (C, 2)
  const int* next_id;      // ()
};

// Output: ids (F,) int32, lifetime (F,) int32, cam0 (F, 2), cam1 (F, 2),
// next_id () int32, valid (F,) bool, packed in this order in ``out``.  The
// working arrays sit in dynamic shared memory (kStaged) or in ``work``.
// The counting phases give each entry a group of ``sub`` lanes, which
// count the entries before it (a 16-byte key a step, every group of a warp
// on the same key) and sum by shuffles; an entry a phase has ruled out gets
// the cell kOut, so later counts need no flag.
template <bool kStaged>
__global__ void __launch_bounds__(kMaxThreads)
select_track_kernel(SelectIn in, int F, int C, int grid_row, int grid_col, int H, int W,
                    int grid_min, int grid_max, int sub, unsigned char* __restrict__ out,
                    unsigned char* work) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  __shared__ int s_kept[2];  // candidates kept (new ids), entries kept by the prune
  const int n = F + C, n_cells = grid_row * grid_col, tid = threadIdx.x;
  const int lane = tid & (sub - 1), group = tid / sub, groups = blockDim.x / sub;
  unsigned char* base = kStaged ? dyn_smem : work;
  SelKey* key = reinterpret_cast<SelKey*>(base);
  int* arank = reinterpret_cast<int*>(key + n);
  int* aid = arank + C;
  int* count = aid + C;
  int* sel = count + n_cells;
  unsigned char* flag = reinterpret_cast<unsigned char*>(sel + F);
  // gridops.cell_of_points: floor(coordinate / cell size), IEEE division
  const float cell_h = (float)((H + grid_row - 1) / grid_row);
  const float cell_w = (float)((W + grid_col - 1) / grid_col);

  // 1. cells (n_cells for entries not inlier), the candidates' keys
  if (tid < 2) s_kept[tid] = 0;
  for (int c = tid; c < n_cells; c += blockDim.x) count[c] = 0;
  for (int i = tid; i < n; i += blockDim.x) {
    const bool cand = i >= F;
    const int j = cand ? i - F : i;
    const float* pts = cand ? in.apts : in.curr;
    const bool v = cand ? in.ainlier[j] : in.tracked[j];
    SelKey k;
    k.cell = v ? (int)floorf(pts[2 * j + 1] / cell_h) * grid_col +
                     (int)floorf(pts[2 * j] / cell_w)
               : n_cells;
    k.arr = cand ? in.aarrival[j] : 0;
    k.pri = cand ? (float)in.ascore[j] : 0.0f;
    k.pad = 0;
    key[i] = k;
    flag[i] = v ? kInlier : 0;
  }
  __syncthreads();

  // 2. the candidates' rank in their cell under (score desc, arrival,
  // index): the best grid_min of each cell are new features
  for (int i0 = F; i0 < n; i0 += groups) {
    const int i = i0 + group;
    const int r = count_before<true>(key, F, i < n ? n : F, i < n ? i : F, lane, sub);
    if (i < n && lane == 0) {
      arank[i - F] = r;
      if ((flag[i] & kInlier) && r < grid_min) flag[i] |= kNew;
    }
  }
  __syncthreads();
  for (int i = F + tid; i < n; i += blockDim.x)  // only the new features from here on
    if (!(flag[i] & kNew)) key[i].cell = kOut;
  __syncthreads();

  // 3. the per-cell counts of the combined set (tracked + new), and the
  // new features' ids in candidate order
  int n_new = 0;
  for (int i = tid; i < n; i += blockDim.x) {
    const int ci = key[i].cell;  // a cell outside the grid counts nowhere, as in the one-hot sum
    if ((i < F ? (flag[i] & kInlier) : (flag[i] & kNew)) && ci >= 0 && ci < n_cells)
      atomicAdd(&count[ci], 1);
    n_new += i >= F && (flag[i] & kNew);
  }
  if (n_new != 0) atomicAdd(&s_kept[0], n_new);
  const int base_id = *in.next_id;
  for (int i0 = F; i0 < n; i0 += groups) {
    const int i = i0 + group;
    const bool act = i < n && (flag[i] & kNew);
    const int g = count_before<false>(key, F, act ? n : F, act ? i : F, lane, sub);
    if (i < n && lane == 0) aid[i - F] = act ? base_id + g : -1;
  }
  __syncthreads();

  // 4. the prune's keys: lifetime first (desc) where the cell overflows,
  // then the insertion order (tracked slots, then the new features by cell
  // and rank), then the index
  for (int i = tid; i < n; i += blockDim.x) {
    const bool cand = i >= F;
    const unsigned char fi = flag[i];
    const bool v = cand ? (fi & kNew) : (fi & kInlier);
    SelKey k = key[i];
    const int life = cand ? 1 : in.lifetime[i] + 1;
    k.pri = v && count[min(max(k.cell, 0), n_cells - 1)] > grid_max ? (float)life : 0.0f;
    k.arr = cand ? F + ((fi & kNew) ? arank[i - F] : 0) : i;
    k.cell = v ? k.cell : n_cells;
    key[i] = k;
    flag[i] = v ? fi : 0;
  }
  __syncthreads();

  // 5. the prune: the best grid_max of each cell stay
  for (int i0 = 0; i0 < n; i0 += groups) {
    const int i = i0 + group;
    const bool act = i < n && flag[i];
    const int r = count_before<true>(key, 0, act ? n : 0, act ? i : 0, lane, sub);
    if (act && lane == 0 && r < grid_max) flag[i] |= kKeep;
  }
  __syncthreads();
  for (int i = tid; i < n; i += blockDim.x)  // only the kept entries from here on
    if (!(flag[i] & kKeep)) key[i].cell = kOut;
  __syncthreads();

  // 6. the kept entries in prune order: the r-th goes to slot r
  int n_kept = 0;
  for (int i = tid; i < n; i += blockDim.x) n_kept += (flag[i] & kKeep) != 0;
  if (n_kept != 0) atomicAdd(&s_kept[1], n_kept);
  for (int i0 = 0; i0 < n; i0 += groups) {
    const int i = i0 + group;
    const bool act = i < n && (flag[i] & kKeep);
    const int r = count_before<false>(key, 0, act ? n : 0, act ? i : 0, lane, sub);
    if (act && lane == 0 && r < F) sel[r] = i;
  }
  __syncthreads();

  // 7. gather into the F slots; empty slots hold -1, 0 and 0.0
  int* o_ids = reinterpret_cast<int*>(out);
  int* o_life = o_ids + F;
  float* o_cam0 = reinterpret_cast<float*>(o_life + F);
  float* o_cam1 = o_cam0 + 2 * F;
  int* o_next = reinterpret_cast<int*>(o_cam1 + 2 * F);
  bool* o_valid = reinterpret_cast<bool*>(o_next + 1);
  const int total = s_kept[1];
  for (int s = tid; s < F; s += blockDim.x) {
    int id = -1, life = 0;
    float x0 = 0.0f, y0 = 0.0f, x1 = 0.0f, y1 = 0.0f;
    if (s < total) {
      const int i = sel[s];
      const bool cand = i >= F;
      const int j = cand ? i - F : i;
      const float* p0 = cand ? in.apts : in.curr;
      const float* p1 = cand ? in.acam1 : in.cam1_curr;
      id = cand ? aid[j] : in.ids[j];
      life = cand ? 1 : in.lifetime[j] + 1;
      x0 = p0[2 * j];
      y0 = p0[2 * j + 1];
      x1 = p1[2 * j];
      y1 = p1[2 * j + 1];
    }
    o_ids[s] = id;
    o_life[s] = life;
    o_cam0[2 * s] = x0;
    o_cam0[2 * s + 1] = y0;
    o_cam1[2 * s] = x1;
    o_cam1[2 * s + 1] = y1;
    o_valid[s] = s < total;
  }
  if (tid == 0) *o_next = base_id + s_kept[0];
}

inline int block_for(int n) {
  return n <= 32 ? 32 : (n >= kMaxThreads ? kMaxThreads : (n + 31) / 32 * 32);
}

// Launch a K8 kernel with its keys staged in ``bytes`` of shared memory when
// they fit, else read from device memory.
template <typename K, typename... A>
int launch_k8(K kernel, size_t* budget, size_t* allowed, int n, size_t bytes, void* stream,
              A... args) {
  if (*budget == 0) *budget = msckf::smem_budget(kernel);
  const int staged = bytes <= *budget;
  const size_t smem = staged ? bytes : 0;
  const int err = msckf::allow_smem(kernel, smem, allowed);
  if (err != 0) return err;
  kernel<<<1, block_for(n), smem, (cudaStream_t)stream>>>(args..., staged);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int grid_topk_i32(const void* score, int H, int W, int grid_row, int grid_col,
                             int cell_h, int cell_w, int k, void* ys, void* xs, void* vals,
                             void* stream) {
  if (k < 1 || k > cell_h * cell_w) return (int)cudaErrorInvalidValue;
  grid_topk_kernel<<<grid_row * grid_col, kTopkThreads, 0, (cudaStream_t)stream>>>(
      (const int*)score, H, W, grid_col, cell_h, cell_w, k, (int*)ys, (int*)xs, (int*)vals);
  return (int)cudaGetLastError();
}

extern "C" int grid_rank_in_cell(const void* cell, const void* primary, const void* arrival,
                                 const void* valid, int n, int n_cells, void* rank, void* perm,
                                 void* stream) {
  static size_t budget = 0, allowed = 0;
  if (n < 1) return (int)cudaErrorInvalidValue;
  return launch_k8(rank_in_cell_kernel, &budget, &allowed, n, (size_t)n * 12, stream,
                   (const int*)cell, (const float*)primary, (const int*)arrival,
                   (const bool*)valid, n, n_cells, (int*)rank, (int*)perm);
}

extern "C" int grid_kept_order_stats(const void* perm, const void* keep, const void* cell,
                                     const void* valid, int n, int n_cells, void* global_rank,
                                     void* cell_rank, void* n_kept, void* stream) {
  static size_t budget = 0, allowed = 0;
  if (n < 1) return (int)cudaErrorInvalidValue;
  return launch_k8(kept_order_stats_kernel, &budget, &allowed, n, (size_t)n * 5, stream,
                   (const int*)perm, (const bool*)keep, (const int*)cell, (const bool*)valid, n,
                   n_cells, (int*)global_rank, (int*)cell_rank, (int*)n_kept);
}

extern "C" int grid_compact_kept(const void* perm, const void* keep, int n, int n_slots,
                                 void* sel, void* selm, void* stream) {
  static size_t budget = 0, allowed = 0;
  if (n < 1 || n_slots < 1) return (int)cudaErrorInvalidValue;
  return launch_k8(compact_kept_kernel, &budget, &allowed, n, (size_t)n, stream,
                   (const int*)perm, (const bool*)keep, n, n_slots, (int*)sel, (bool*)selm);
}

extern "C" int grid_smallest_k(const void* key, int n, int k, void* out, void* stream) {
  static size_t budget = 0, allowed = 0;
  if (n < 1 || k < 1) return (int)cudaErrorInvalidValue;
  return launch_k8(smallest_k_kernel, &budget, &allowed, n, (size_t)n * 4, stream,
                   (const int*)key, n, k, (int*)out);
}

extern "C" int grid_stable_compact(const void* mask, int n, int fill, void* out, void* stream) {
  static size_t budget = 0, allowed = 0;
  if (n < 1) return (int)cudaErrorInvalidValue;
  return launch_k8(stable_compact_kernel, &budget, &allowed, n, (size_t)n, stream,
                   (const bool*)mask, n, fill, (int*)out);
}

extern "C" int grid_select_track_f32(const void* curr, const void* cam1_curr, const void* tracked,
                                     const void* ids, const void* lifetime, int F,
                                     const void* apts, const void* ascore, const void* aarrival,
                                     const void* ainlier, const void* acam1, int C,
                                     const void* next_id, int grid_row, int grid_col, int H,
                                     int W, int grid_min, int grid_max, void* out, void* work,
                                     void* stream) {
  static size_t allowed = 0;
  if (F < 1 || C < 1 || grid_row < 1 || grid_col < 1) return (int)cudaErrorInvalidValue;
  const SelectIn in{(const float*)curr, (const float*)cam1_curr, (const bool*)tracked,
                    (const int*)ids, (const int*)lifetime, (const float*)apts,
                    (const int*)ascore, (const int*)aarrival, (const bool*)ainlier,
                    (const float*)acam1, (const int*)next_id};
  // lanes per entry: as many as a 1024-thread block gives every entry
  int sub = 1;
  while (sub < 32 && block_for(F + C) * sub * 2 <= kMaxThreads) sub *= 2;
  const int threads = block_for(F + C) * sub;
  if (work != nullptr) {
    select_track_kernel<false><<<1, threads, 0, (cudaStream_t)stream>>>(
        in, F, C, grid_row, grid_col, H, W, grid_min, grid_max, sub, (unsigned char*)out,
        (unsigned char*)work);
  } else {
    const size_t smem = select_bytes(F, C, grid_row * grid_col);
    const int err = msckf::allow_smem(select_track_kernel<true>, smem, &allowed);
    if (err != 0) return err;
    select_track_kernel<true><<<1, threads, smem, (cudaStream_t)stream>>>(
        in, F, C, grid_row, grid_col, H, W, grid_min, grid_max, sub, (unsigned char*)out,
        nullptr);
  }
  return (int)cudaGetLastError();
}
