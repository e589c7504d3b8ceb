// K5 + K8: per-cell top-k of a dense score map, and the stable per-cell
// ranking, kept-order statistics and compaction of flat feature arrays.
//
// Replaces uav_airvision_tpu/ops/gridops.py: dense_grid_topk (:147),
// smallest_k_indices (:17), stable_compact_indices (:36), rank_in_cell
// (:58), kept_order_stats (:91) and compact_kept (:129).  Every result
// equals a stable lexsort's, bit for bit.
//
// K5, k <= 32 (the main path's 5 and 8): a thread-block cluster of 8 band
// blocks per grid cell (of 1 to 8 blocks, 8 and 5 were the fastest on the
// bench world's maps), each block a band of the cell's rows.  A pixel's key packs (value,
// ~in-cell flat index) into 64 bits, so the larger key is the larger value
// and, on a tie, the smaller index; keys are unique, so the union of the
// bands' top-k holds the cell's top-k and the merge below is exact.  A
// block stages its band by asynchronous copies (cp.async, 16 bytes where a
// row's segment is aligned, 4 at its ragged ends; each staged row shifted so
// that its alignment is the map's), rows past the image padded with -1.
// Each warp then walks rows and columns (no division per pixel): a pixel
// whose key is at or below the k-th best key the warp holds is rejected by
// one ballot (most of a FAST map is 0 and fails at once), the survivors are
// appended to the warp's list of candidates, and when that list nears its
// 64 keys each lane ranks two of them against all, which keeps the k best
// and raises the threshold.  A warp's first 32 keys are sorted by a
// bitonic network of shuffles instead: its first k candidates and
// threshold.  The warps' lists merge by rank (a key's rank
// is the number of keys above it among all of them) into the block's k,
// which go to block rank 0's shared memory (distributed shared memory);
// after one cluster barrier rank 0 merges the G lists the same way and
// writes ys, xs, vals.  A band larger than the staging buffer takes
// several passes.
//
// K5, any other k (up to the cell's pixel count) or a cell wider than the
// staging buffer: one 1024-thread block per cell.  Each thread keeps the 8
// largest keys of its strided share in registers, then k rounds of a
// block-wide maximum over the threads' best remaining keys give the cell's
// winners in order.  A thread whose 8 keys are all taken while its share
// holds more rescans the share for the 8 largest keys below its last
// winner.  Pixels of a cell past the image edge hold -1, as the padded map
// does.
//
// K5's instances: B score maps of one shape back to back (a fleet's batch),
// one launch for all of them: global cell g (a block, or a cluster of band
// blocks) is cell g mod n_cells of map g / n_cells, and its outputs go to
// row g of (B * n_cells, k).  B = 1 is the single-map launch.
//
// K8: n is a few hundred to a few thousand, so one block of up to 1024
// threads counts, for each element it owns (a strided share), its
// predecessors under the strict total order; no sort.  The keys sit in
// dynamic shared memory sized to n, or, past what a block's shared memory
// holds, are read from device memory (L2).  kept_order_stats and
// compact_kept walk the sorted order (positions q, element perm[q]) so they
// need no inverse permutation.  Every K8 entry point takes a fleet's
// instances in one launch, a block an instance (the block computes exactly
// what a launch of that instance alone computes); one instance is the
// launch of one block.
//
// grid_select_track_f32 is the front-end's whole per-cell selection of a
// tracked frame in one launch of one block an instance (the JAX package's
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "msckf_common.cuh"

namespace cg = cooperative_groups;

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
grid_topk_kernel(const int* __restrict__ score, int H, int W, int n_cells, int grid_col,
                 int cell_h, int cell_w, int k, int* __restrict__ ys, int* __restrict__ xs,
                 int* __restrict__ vals, long long* __restrict__ clocks) {
  __shared__ unsigned long long warp_best[kTopkThreads / 32];
  const bool timed = clocks != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
  if (timed) clocks[0] = clock64();
  __shared__ unsigned long long s_winner;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gcell = blockIdx.x, cell = gcell % n_cells;  // cell of map gcell / n_cells
  score += (size_t)(gcell / n_cells) * H * W;
  const int y0 = (cell / grid_col) * cell_h, x0 = (cell % grid_col) * cell_w;
  const int cell_sz = cell_h * cell_w;
  const int share = tid < cell_sz ? (cell_sz - 1 - tid) / kTopkThreads + 1 : 0;

  unsigned long long best[kBest];  // descending; 0 is below every real key
  best_of_share(score, H, W, y0, x0, cell_w, cell_sz, false, 0ull, best);
  int taken = 0;  // winners from this thread's share so far
  if (timed) clocks[1] = clock64();

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
      const int o = gcell * k + round;
      ys[o] = y0 + idx / cell_w;
      xs[o] = x0 + idx % cell_w;
      vals[o] = v;
    }
    __syncthreads();  // s_winner is rewritten next round
  }
  if (timed) clocks[2] = clock64();
}

constexpr int kBandThreads = 256;
constexpr int kBandWarps = kBandThreads / 32;
constexpr int kBandMaxK = 32;     // the band path's k
constexpr int kBands = 8;         // band blocks a cell (the cluster's size), at most 8
constexpr int kWarpBuf = 64;      // a warp's candidate keys: its k best, then the survivors
constexpr int kStageInts = 9216;  // the staging buffer (36 KB; 45 KB with the keys)
constexpr unsigned kFull = 0xffffffffu;

// Keys above ``x`` among n keys: independent loads, no branch.
__device__ inline int count_above(const unsigned long long* keys, int n, unsigned long long x) {
  int above = 0;
#pragma unroll 8
  for (int i = 0; i < n; ++i) above += keys[i] > x;
  return above;
}

// A staged row's shift: its element c sits at row[shift + c], so that its
// 16-byte groups are the map's.  Rows past the image (no real pixel) take 0.
__device__ inline int row_shift(const int* score, int y, int H, int W, int x0) {
  return (y < H && x0 < W) ? (int)(((uintptr_t)(score + (size_t)y * W + x0) >> 2) & 3) : 0;
}

// The warp's 32 keys (one a lane) sorted descending across the lanes
// (a bitonic network of shuffles).
__device__ inline unsigned long long warp_sort_desc(unsigned long long x, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const unsigned long long y = __shfl_xor_sync(kFull, x, stride);
      const bool keep_max = ((lane & size) == 0) == ((lane & stride) == 0);
      x = keep_max ? (x > y ? x : y) : (x < y ? x : y);
    }
  }
  return x;
}

// A warp's m candidate keys (unique, nonzero) in buf -> its min(m, k)
// largest, descending, at the front (0 pads to k); returns that count.
// Each lane ranks two candidates against all of them.
__device__ inline int warp_keep_best(unsigned long long* buf, int m, int k, int lane) {
  __syncwarp();
  const unsigned long long a = lane < m ? buf[lane] : 0ull;
  const unsigned long long b = lane + 32 < m ? buf[lane + 32] : 0ull;
  int ra = 0, rb = 0;
#pragma unroll 8
  for (int j = 0; j < m; ++j) {
    const unsigned long long v = buf[j];
    ra += v > a;
    rb += v > b;
  }
  __syncwarp();
  if (a != 0ull && ra < k) buf[ra] = a;
  if (b != 0ull && rb < k) buf[rb] = b;
  const int kept = min(m, k);
  if (lane >= kept && lane < k) buf[lane] = 0ull;
  __syncwarp();
  return kept;
}

// The k largest of n keys (unique; 0 pads, never taken) by rank: the
// thread of key t counts the keys above it and calls emit(rank, key) when
// that is under k.  Threads past n do nothing.
template <typename Emit>
__device__ inline void keep_best(const unsigned long long* keys, int n, int k, Emit emit) {
  const int t = threadIdx.x;
  if (t >= n) return;
  const unsigned long long x = keys[t];
  if (x == 0ull) return;
  const int rank = count_above(keys, n, x);
  if (rank < k) emit(rank, x);
}

// One cluster of ``bands`` blocks per cell (cluster rank = band); rows_pass
// rows of the band are staged at a time, ``stride`` ints a staged row.
__global__ void __launch_bounds__(kBandThreads)
grid_topk_band_kernel(const int* __restrict__ score, int H, int W, int n_cells, int grid_col,
                      int cell_h, int cell_w, int k, int bands, int rows_pass, int stride,
                      int* __restrict__ ys, int* __restrict__ xs, int* __restrict__ vals,
                      long long* __restrict__ clocks) {
  extern __shared__ __align__(16) int stage[];
  __shared__ unsigned long long s_buf[kBandWarps * kWarpBuf], s_warp[kBandWarps * kBandMaxK];
  __shared__ unsigned long long s_block[kBandMaxK];
  __shared__ unsigned long long s_cluster[8 * kBandMaxK];  // rank 0's: every band's k keys
  // the blocks of a cluster have all started before any writes into rank 0's
  // shared memory (the wait below, long after this arrive)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int band = (int)cluster.block_rank(), gcell = blockIdx.x / bands;
  const int cell = gcell % n_cells;  // of map gcell / n_cells
  score += (size_t)(gcell / n_cells) * H * W;
  const bool timed = clocks != nullptr && blockIdx.x == 0;
  if (timed && tid == 0) clocks[0] = clock64();
  const int y0 = (cell / grid_col) * cell_h, x0 = (cell % grid_col) * cell_w;
  const int r_begin = band * cell_h / bands, r_end = (band + 1) * cell_h / bands;
  const int nreal_x = max(0, min(cell_w, W - x0));  // columns inside the image

  // the warp's candidates: m keys in buf, all above thr, the k-th best key
  // held so far (0 until k are held)
  unsigned long long* buf = s_buf + warp * kWarpBuf;
  unsigned long long thr = 0ull;
  int m = 0;
  bool first = true;  // uniform over the warp
  for (int ra = r_begin; ra < r_end; ra += rows_pass) {
    const int nr = min(rows_pass, r_end - ra);
    for (int r = warp; r < nr; r += kBandWarps) {  // stage: a warp a row
      const int y = y0 + ra + r;
      const int nreal = y < H ? nreal_x : 0;
      const int sh = row_shift(score, y, H, W, x0);
      const int* g = score + (size_t)y * W + x0;  // read only where nreal > 0
      int* row = stage + r * stride + sh;
      const int head = min((4 - sh) & 3, nreal);
      const int nvec = (nreal - head) >> 2;
      const int tail = nreal - head - 4 * nvec;
      const int units = nvec + head + tail + (cell_w - nreal);
      for (int u = lane; u < units; u += 32) {
        if (u < nvec) {
          msckf::cp_async<16>(row + head + 4 * u, g + head + 4 * u);
        } else {
          int c = u - nvec;  // the ragged head, the tail, then the padding
          if (c >= head) c += 4 * nvec;
          if (c < nreal) msckf::cp_async<4>(row + c, g + c);
          else row[c] = -1;
        }
      }
    }
    msckf::cp_async_wait_all();
    __syncthreads();
    if (timed && tid == 0 && ra == r_begin) clocks[1] = clock64();
    for (int r = warp; r < nr; r += kBandWarps) {  // filter: a warp a row
      const int row_idx = (ra + r) * cell_w;     // in-cell index of column 0
      const int* row = stage + r * stride + row_shift(score, y0 + ra + r, H, W, x0);
      for (int c0 = 0; c0 < cell_w; c0 += 128) {  // four columns a lane, loaded first
        int v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = c0 + 32 * u + lane;
          v[u] = c < cell_w ? row[c] : 0;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = c0 + 32 * u + lane;
          if (c0 + 32 * u >= cell_w) break;  // uniform over the warp
          const unsigned long long key = c < cell_w ? topk_key(v[u], row_idx + c) : 0ull;
          if (first) {  // the warp's first 32 keys: its first k candidates, sorted
            first = false;
            const unsigned long long sorted = warp_sort_desc(key, lane);
            m = min(__popc(__ballot_sync(kFull, sorted != 0ull)), k);
            if (lane < m) buf[lane] = sorted;
            if (m == k) thr = __shfl_sync(kFull, sorted, k - 1);
            continue;
          }
          const bool keep = key > thr;  // rejected at or below the k-th key held
          const unsigned ball = __ballot_sync(kFull, keep);
          if (keep) buf[m + __popc(ball & ((1u << lane) - 1u))] = key;
          m += __popc(ball);
          if (m > kWarpBuf - 32) {  // room for the next 32: keep the k best
            m = warp_keep_best(buf, m, k, lane);
            if (m == k) thr = buf[k - 1];
          }
        }
      }
    }
    __syncthreads();  // the next pass restages the buffer
  }
  warp_keep_best(buf, m, k, lane);  // the warp's k best, descending, 0 padded
  if (lane < k) s_warp[warp * k + lane] = buf[lane];
  if (tid < k) s_block[tid] = 0ull;
  __syncthreads();
  if (timed && tid == 0) clocks[2] = clock64();
  keep_best(s_warp, kBandWarps * k, k, [&](int rank, unsigned long long x) { s_block[rank] = x; });
  __syncthreads();
  if (timed && tid == 0) clocks[3] = clock64();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (tid < k) cluster.map_shared_rank(s_cluster, 0)[band * k + tid] = s_block[tid];
  if (timed && tid == 0) clocks[4] = clock64();
  cluster.sync();
  if (timed && tid == 0) clocks[5] = clock64();
  if (band != 0) return;
  keep_best(s_cluster, bands * k, k, [&](int rank, unsigned long long x) {
    const int idx = (int)(~(unsigned)(x & 0xffffffffull));
    const int o = gcell * k + rank;
    ys[o] = y0 + idx / cell_w;
    xs[o] = x0 + idx % cell_w;
    vals[o] = (int)((unsigned)(x >> 32) ^ 0x80000000u);
  });
  if (timed) {
    __syncthreads();
    if (tid == 0) clocks[6] = clock64();
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
// n_cells: rank inside the cell, and the global sorted permutation; a block
// an instance (its n entries of each array back to back)
__global__ void __launch_bounds__(kMaxThreads)
rank_in_cell_kernel(const int* __restrict__ cell, const float* __restrict__ primary,
                    const int* __restrict__ arrival, const bool* __restrict__ valid, int n,
                    int n_cells, int* __restrict__ rank, int* __restrict__ perm, int staged) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  const size_t o = (size_t)blockIdx.x * n;
  cell += o;
  primary += o;
  arrival += o;
  valid += o;
  rank += o;
  perm += o;
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
// position q counts the kept entries at positions before q.  A block an
// instance (its n entries back to back, its one n_kept).
__global__ void __launch_bounds__(kMaxThreads)
kept_order_stats_kernel(const int* __restrict__ perm, const bool* __restrict__ keep,
                        const int* __restrict__ cell, const bool* __restrict__ valid, int n,
                        int n_cells, int* __restrict__ global_rank, int* __restrict__ cell_rank,
                        int* __restrict__ n_kept, int staged) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  __shared__ int s_total;
  const size_t o = (size_t)blockIdx.x * n;
  perm += o;
  keep += o;
  cell += o;
  valid += o;
  global_rank += o;
  cell_rank += o;
  n_kept += blockIdx.x;
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

// the kept entries, in perm order, into the first slots of an n_slots table;
// a block an instance (its n entries and n_slots slots back to back)
__global__ void __launch_bounds__(kMaxThreads)
compact_kept_kernel(const int* __restrict__ perm, const bool* __restrict__ keep, int n,
                    int n_slots, int* __restrict__ sel, bool* __restrict__ selm, int staged) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  __shared__ int s_total;
  perm += (size_t)blockIdx.x * n;
  keep += (size_t)blockIdx.x * n;
  sel += (size_t)blockIdx.x * n_slots;
  selm += (size_t)blockIdx.x * n_slots;
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

// the indices of the k smallest (key, index) pairs, ascending; a block an
// instance (its n keys and k outputs back to back)
__global__ void __launch_bounds__(kMaxThreads)
smallest_k_kernel(const int* __restrict__ key, int n, int k, int* __restrict__ out,
                  int staged) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  int* s_key = reinterpret_cast<int*>(dyn_smem);
  key += (size_t)blockIdx.x * n;
  out += (size_t)blockIdx.x * k;
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

// the indices where mask is set, ascending, padded with fill; a block an
// instance
__global__ void __launch_bounds__(kMaxThreads)
stable_compact_kernel(const bool* __restrict__ mask, int n, int fill, int* __restrict__ out,
                      int staged) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  __shared__ int s_total;
  bool* s_mask = reinterpret_cast<bool*>(dyn_smem);
  mask += (size_t)blockIdx.x * n;
  out += (size_t)blockIdx.x * n;
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

// Instance strides of the selection's inputs (in elements, in SelectIn's
// order) and of its output and workspace rows (bytes)
struct SelectStrides {
  long long in[11];
  long long out, work;
};

template <typename P>
__device__ __forceinline__ P* inst_ptr(P* p, long long stride, int b) {
  return p + stride * b;
}

// Output: ids (F,) int32, lifetime (F,) int32, cam0 (F, 2), cam1 (F, 2),
// next_id () int32, valid (F,) bool, packed in this order in ``out``.  The
// working arrays sit in dynamic shared memory (kStaged) or in ``work``.  A
// block an instance: block b selects instance b's entries (each input, its
// output row and its workspace row at their instance strides).
// The counting phases give each entry a group of ``sub`` lanes, which
// count the entries before it (a 16-byte key a step, every group of a warp
// on the same key) and sum by shuffles; an entry a phase has ruled out gets
// the cell kOut, so later counts need no flag.
template <bool kStaged>
__global__ void __launch_bounds__(kMaxThreads)
select_track_kernel(SelectIn in, int F, int C, int grid_row, int grid_col, int H, int W,
                    int grid_min, int grid_max, int sub, unsigned char* __restrict__ out,
                    unsigned char* work, const SelectStrides st) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  __shared__ int s_kept[2];  // candidates kept (new ids), entries kept by the prune
  {
    const int b = blockIdx.x;
    in.curr = inst_ptr(in.curr, st.in[0], b);
    in.cam1_curr = inst_ptr(in.cam1_curr, st.in[1], b);
    in.tracked = inst_ptr(in.tracked, st.in[2], b);
    in.ids = inst_ptr(in.ids, st.in[3], b);
    in.lifetime = inst_ptr(in.lifetime, st.in[4], b);
    in.apts = inst_ptr(in.apts, st.in[5], b);
    in.ascore = inst_ptr(in.ascore, st.in[6], b);
    in.aarrival = inst_ptr(in.aarrival, st.in[7], b);
    in.ainlier = inst_ptr(in.ainlier, st.in[8], b);
    in.acam1 = inst_ptr(in.acam1, st.in[9], b);
    in.next_id = inst_ptr(in.next_id, st.in[10], b);
    out += st.out * b;
    if (!kStaged) work += st.work * b;
  }
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

// Launch a K8 kernel, a block for each of n_inst instances, with its keys
// staged in ``bytes`` of shared memory when they fit, else read from device
// memory.
template <typename K, typename... A>
int launch_k8_instances(K kernel, size_t* budget, size_t* allowed, int n_inst, int n,
                        size_t bytes, void* stream, A... args) {
  if (*budget == 0) *budget = msckf::smem_budget(kernel);
  const int staged = bytes <= *budget;
  const size_t smem = staged ? bytes : 0;
  const int err = msckf::allow_smem(kernel, smem, allowed);
  if (err != 0) return err;
  kernel<<<n_inst, block_for(n), smem, (cudaStream_t)stream>>>(args..., staged);
  return (int)cudaGetLastError();
}

}  // namespace

// score (B, H, W); ys, xs, vals (B, grid_row * grid_col, k).  clocks (7
// int64 or null): the SM clock of the first cell's block (band 0) at its
// start and at the end of each phase (the 1024-thread path: three stamps)
extern "C" int grid_topk_i32(const void* score, int B, int H, int W, int grid_row, int grid_col,
                             int cell_h, int cell_w, int k, void* ys, void* xs, void* vals,
                             void* clocks, void* stream) {
  if (k < 1 || k > cell_h * cell_w || B < 1) return (int)cudaErrorInvalidValue;
  const int n_cells = grid_row * grid_col;
  const int stride = (cell_w + 3 + 3) & ~3;  // a row and its shift, whole 16-byte groups
  if (k > kBandMaxK || stride > kStageInts) {
    grid_topk_kernel<<<n_cells * B, kTopkThreads, 0, (cudaStream_t)stream>>>(
        (const int*)score, H, W, n_cells, grid_col, cell_h, cell_w, k, (int*)ys, (int*)xs,
        (int*)vals, (long long*)clocks);
    return (int)cudaGetLastError();
  }
  const int b = max(1, min(kBands, cell_h));
  const int rows_pass = min((cell_h + b - 1) / b, kStageInts / stride);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_cells * B * b);
  cfg.blockDim = dim3(kBandThreads);
  cfg.dynamicSmemBytes = (size_t)rows_pass * stride * sizeof(int);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = b;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, grid_topk_band_kernel, (const int*)score, H, W, n_cells, grid_col,
                     cell_h, cell_w, k, b, rows_pass, stride, (int*)ys, (int*)xs, (int*)vals,
                     (long long*)clocks);
  return (int)cudaGetLastError();  // the launch's error, cleared for the next launch
}

// cell, primary, arrival, valid, rank, perm (n_inst, n)
extern "C" int grid_rank_in_cell(const void* cell, const void* primary, const void* arrival,
                                 const void* valid, int n_inst, int n, int n_cells, void* rank,
                                 void* perm, void* stream) {
  static size_t budget = 0, allowed = 0;
  if (n_inst < 1 || n < 1) return (int)cudaErrorInvalidValue;
  return launch_k8_instances(rank_in_cell_kernel, &budget, &allowed, n_inst, n, (size_t)n * 12,
                             stream,
                   (const int*)cell, (const float*)primary, (const int*)arrival,
                   (const bool*)valid, n, n_cells, (int*)rank, (int*)perm);
}

// perm, keep, cell, valid, global_rank, cell_rank (n_inst, n), n_kept (n_inst)
extern "C" int grid_kept_order_stats(const void* perm, const void* keep, const void* cell,
                                     const void* valid, int n_inst, int n, int n_cells,
                                     void* global_rank, void* cell_rank, void* n_kept,
                                     void* stream) {
  static size_t budget = 0, allowed = 0;
  if (n_inst < 1 || n < 1) return (int)cudaErrorInvalidValue;
  return launch_k8_instances(kept_order_stats_kernel, &budget, &allowed, n_inst, n,
                             (size_t)n * 5, stream,
                   (const int*)perm, (const bool*)keep, (const int*)cell, (const bool*)valid, n,
                   n_cells, (int*)global_rank, (int*)cell_rank, (int*)n_kept);
}

// perm, keep (n_inst, n), sel, selm (n_inst, n_slots)
extern "C" int grid_compact_kept(const void* perm, const void* keep, int n_inst, int n,
                                 int n_slots, void* sel, void* selm, void* stream) {
  static size_t budget = 0, allowed = 0;
  if (n_inst < 1 || n < 1 || n_slots < 1) return (int)cudaErrorInvalidValue;
  return launch_k8_instances(compact_kept_kernel, &budget, &allowed, n_inst, n, (size_t)n,
                             stream,
                   (const int*)perm, (const bool*)keep, n, n_slots, (int*)sel, (bool*)selm);
}

// key (n_inst, n), out (n_inst, k)
extern "C" int grid_smallest_k(const void* key, int n_inst, int n, int k, void* out,
                               void* stream) {
  static size_t budget = 0, allowed = 0;
  if (n_inst < 1 || n < 1 || k < 1) return (int)cudaErrorInvalidValue;
  return launch_k8_instances(smallest_k_kernel, &budget, &allowed, n_inst, n, (size_t)n * 4,
                             stream, (const int*)key, n, k, (int*)out);
}

// mask (n_inst, n), out (n_inst, n)
extern "C" int grid_stable_compact(const void* mask, int n_inst, int n, int fill, void* out,
                                   void* stream) {
  static size_t budget = 0, allowed = 0;
  if (n_inst < 1 || n < 1) return (int)cudaErrorInvalidValue;
  return launch_k8_instances(stable_compact_kernel, &budget, &allowed, n_inst, n, (size_t)n,
                             stream, (const bool*)mask, n, fill, (int*)out);
}

// n_inst instances' selections, a block each: the inputs at their instance
// strides (strides: 13 host int64, the 11 inputs' in elements, then the
// output's and the workspace's rows in bytes)
extern "C" int grid_select_track_f32(const void* curr, const void* cam1_curr, const void* tracked,
                                     const void* ids, const void* lifetime, int F,
                                     const void* apts, const void* ascore, const void* aarrival,
                                     const void* ainlier, const void* acam1, int C,
                                     const void* next_id, int grid_row, int grid_col, int H,
                                     int W, int grid_min, int grid_max, void* out, void* work,
                                     int n_inst, const void* strides, void* stream) {
  static size_t allowed = 0;
  if (F < 1 || C < 1 || grid_row < 1 || grid_col < 1 || n_inst < 1)
    return (int)cudaErrorInvalidValue;
  const SelectIn in{(const float*)curr, (const float*)cam1_curr, (const bool*)tracked,
                    (const int*)ids, (const int*)lifetime, (const float*)apts,
                    (const int*)ascore, (const int*)aarrival, (const bool*)ainlier,
                    (const float*)acam1, (const int*)next_id};
  SelectStrides st;
  const long long* sv = (const long long*)strides;
  for (int k = 0; k < 11; ++k) st.in[k] = sv[k];
  st.out = sv[11];
  st.work = sv[12];
  // lanes per entry: as many as a 1024-thread block gives every entry
  int sub = 1;
  while (sub < 32 && block_for(F + C) * sub * 2 <= kMaxThreads) sub *= 2;
  const int threads = block_for(F + C) * sub;
  if (work != nullptr) {
    select_track_kernel<false><<<n_inst, threads, 0, (cudaStream_t)stream>>>(
        in, F, C, grid_row, grid_col, H, W, grid_min, grid_max, sub, (unsigned char*)out,
        (unsigned char*)work, st);
  } else {
    const size_t smem = select_bytes(F, C, grid_row * grid_col);
    const int err = msckf::allow_smem(select_track_kernel<true>, smem, &allowed);
    if (err != 0) return err;
    select_track_kernel<true><<<n_inst, threads, smem, (cudaStream_t)stream>>>(
        in, F, C, grid_row, grid_col, H, W, grid_min, grid_max, sub, (unsigned char*)out,
        nullptr, st);
  }
  return (int)cudaGetLastError();
}
