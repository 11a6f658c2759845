// Top-k selection over the vocab axis, for Hopper (sm_90a): a warp per
// vocab tile, barrier-free rounds, the merge in the same launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/topk_logits/kernel.py
// (topk_logits_tiles, body _kernel) and the lax.top_k merge of its
// wrapper (ops.py:29-30).
//
// The selection, one warp over one tile of `width` columns: each lane
// holds PER values in registers (columns lane + 32 j, or with 16-byte
// loads 128 (j / 4) + 4 lane + j % 4), read once, coalesced.  A round is
// a warp argmax on (value, -column) in two warp reductions
// (__reduce_max_sync on an order-preserving key of the lanes' bests,
// then __reduce_min_sync on the columns of the lanes holding that key),
// after which every lane knows the winner; lane 0 writes it, and only the
// lane that owns it masks its slot and recomputes its own best.  To keep
// that cheap each lane caches the best of every group of 8 of its slots,
// so a round re-reduces one group and the group bests (two trees of
// depth 3, not a scan of PER).  No block barrier is taken in a round.
// Two rules:
//   stage 1 (the reference's tile kernel): the winner is overwritten
//     with NEG and stays eligible, and columns past the row's width read
//     as NEG (the reference's jnp.pad, done without a padded copy), so a
//     tile with fewer than k values above NEG repeats its first NEG
//     column, as the reference does;
//   distinct (lax.top_k): the winner is removed; a round that finds
//     nothing left emits (-inf, INT_MAX).
// Ties go to the smallest column, or candidate position: candidates are
// laid out tile by tile in id order, and each tile's are sorted with
// ties by id, so the smallest position is the smallest id.
//
// The merge needs no rounds: each warp's winners are a run sorted by
// (value desc, position asc), so an entry's rank in the row is its index
// in its run plus, for each other run, a binary search for the entries
// that come before it; the entries of rank < k are the row's top-k, and
// every thread of the block ranks entries at once (rank_merge).
//
// Three kernels:
//   topk_rows_kernel (a row in one block: V <= 8 tiles and at most 2048
//     candidates, as for the AM's V = 3183): warp t selects tile t's
//     top-k into shared memory; after one __syncthreads the block merges
//     the runs by rank.  One launch per call.
//   topk_tiles_kernel (stage 1 alone, for wide rows such as the LM
//     sampler's V = 151,936 in 75 tiles): a warp per (row, tile), writing
//     the (R, n_tiles * k) candidates that topk_sample's stage 2 merges.
//   topk_merge_kernel (the merge of wide rows' candidates): up to 8
//     warps per row each take a chunk of at most 2048 candidates by the
//     distinct rule, then the block merges their runs by rank, ids read
//     through the candidates' ids.
//
// What bounds it on an H100: bytes.  The logits are read once (R*V*4
// bytes) and the candidates are small; the k rounds run on registers.
// With a warp per tile the rounds of many tiles overlap on each SM, so
// the rounds' latency hides behind other warps' loads.  What is left is
// the rounds' dependent latency (k rounds of two warp reductions, a
// shuffle and the owner's rescan per tile) when few tiles are in flight
// (small R), and the scalar loads of rows whose width is not a multiple
// of 4 (V = 3183).  Fusing the selection into the unembedding
// GEMM's epilogue is later work.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr float kNeg = -3.4e38f;        // the reference's NEG, as f32
constexpr int kMaxTile = 2048;          // columns one warp holds (64 a lane)
constexpr int kMaxWarps = 8;            // warps of a row's block
constexpr int kTileWarps = 4;           // warps of a stage-1 block: at
                                        // ~170 registers a lane, 3 blocks
                                        // an SM, so 1,200 warps are one wave
constexpr int kMaxEntries = 2048;       // candidates a block merges

__device__ __forceinline__ bool better(float v1, int c1, float v2, int c2) {
  return v1 > v2 || (v1 == v2 && c1 < c2);
}

// An unsigned key in the order of the floats (-0 keyed as +0, which
// compares equal to it), so a warp's max is one __reduce_max_sync.
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f == 0.f ? 0.f : f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The top-k of columns [base, base + width) of row x (n_cols wide) by one
// warp; lane 0 calls emit(r, value, column - base) for r = 0 .. k-1.
// DISTINCT: the distinct rule, and with `excl`, entries whose excl[] is
// INT_MAX are no elements; else the stage-1 rule.  VEC: 16-byte loads
// (x + base 16-byte aligned, width and n_cols multiples of 4).
template <int PER, bool VEC, bool DISTINCT, typename Emit>
__device__ __forceinline__ void warp_topk(const float* x, int base,
                                          int width, int n_cols, int k,
                                          const int* excl, Emit emit) {
  constexpr int GS = PER < 8 ? PER : 8;         // slots per group
  constexpr int NG = PER / GS;
  const int lane = threadIdx.x & 31;
  float v[PER];
  unsigned long long taken = 0;                 // DISTINCT: not elements
  if (VEC) {
#pragma unroll
    for (int q = 0; q < PER / 4; ++q) {
      const int c0 = 128 * q + 4 * lane;
      float4 t;
      if (c0 < width && base + c0 < n_cols) {
        t = *reinterpret_cast<const float4*>(x + base + c0);
      } else {
        const float f = c0 < width ? kNeg : -INFINITY;
        t = make_float4(f, f, f, f);
      }
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = lane + 32 * j;
      const int col = base + c;
      const bool in = c < width && col < n_cols;
      if (DISTINCT) {
        const bool el = in && (excl == nullptr || excl[col] != INT_MAX);
        v[j] = el ? x[col] : -INFINITY;
        if (!el) taken |= 1ull << j;
      } else {
        v[j] = in ? x[col] : (c < width ? kNeg : -INFINITY);
      }
    }
  }
  // columns in slot order are ascending
  auto col_of = [&](int j) {
    return VEC ? 128 * (j >> 2) + 4 * lane + (j & 3) : lane + 32 * j;
  };
  float gv[NG];
  int gc[NG];
  auto group_best = [&](int gg) {       // a tree over the group's slots
    float bv[GS];
    int bc[GS];
#pragma unroll
    for (int e = 0; e < GS; ++e) {
      const int j = gg * GS + e;
      const bool gone = DISTINCT && ((taken >> j) & 1ull);
      bv[e] = gone ? -INFINITY : v[j];
      bc[e] = gone ? INT_MAX : col_of(j);   // sentinel: loses to any element
    }
#pragma unroll
    for (int w = 1; w < GS; w <<= 1) {
#pragma unroll
      for (int e = 0; e + w < GS; e += 2 * w) {
        if (better(bv[e + w], bc[e + w], bv[e], bc[e])) {
          bv[e] = bv[e + w];
          bc[e] = bc[e + w];
        }
      }
    }
    gv[gg] = bv[0];
    gc[gg] = bc[0];
  };
  float lv;
  int lc;
  unsigned lkey;
  auto lane_best = [&]() {              // a tree over the group bests
    float bv[NG];
    int bc[NG];
#pragma unroll
    for (int gg = 0; gg < NG; ++gg) {
      bv[gg] = gv[gg];
      bc[gg] = gc[gg];
    }
#pragma unroll
    for (int w = 1; w < NG; w <<= 1) {
#pragma unroll
      for (int e = 0; e + w < NG; e += 2 * w) {
        if (better(bv[e + w], bc[e + w], bv[e], bc[e])) {
          bv[e] = bv[e + w];
          bc[e] = bc[e + w];
        }
      }
    }
    lv = bv[0];
    lc = bc[0];
    lkey = order_key(lv);
  };
#pragma unroll
  for (int gg = 0; gg < NG; ++gg) group_best(gg);
  lane_best();

  for (int r = 0; r < k; ++r) {
    // the warp's best (value, -column): the largest key, then among the
    // lanes holding it the smallest column (INT_MAX: nothing left)
    const unsigned kmax = __reduce_max_sync(0xffffffffu, lkey);
    const int wc = (int)__reduce_min_sync(
        0xffffffffu, lkey == kmax ? (unsigned)lc : 0xffffffffu);
    const int owner = VEC ? (wc & 127) >> 2 : wc & 31;
    const float wv = __shfl_sync(0xffffffffu, lv, owner);
    if (lane == 0) emit(r, wc == INT_MAX ? -INFINITY : wv, wc);
    if (wc == INT_MAX) continue;        // nothing left (DISTINCT only)
    if (lane == owner) {
      const int slot = VEC ? ((wc >> 7) << 2) | (wc & 3) : wc >> 5;
      const int gi = slot / GS;
#pragma unroll
      for (int gg = 0; gg < NG; ++gg) {
        if (gg == gi) {
          if (DISTINCT) {
            taken |= 1ull << slot;
          } else {
#pragma unroll
            for (int e = 0; e < GS; ++e)
              if (gg * GS + e == slot) v[gg * GS + e] = kNeg;
          }
          group_best(gg);
        }
      }
      lane_best();
    }
  }
}

// The merge of sorted runs, by rank: s_v holds n_runs runs of `len`
// entries, run t sorted by (value desc, position asc) with its
// n_real(t) entries first.  An entry's rank in the union, in the order
// (value desc, run asc, index asc), is its index plus, for every other
// run, the entries that come before it there (a binary search); the
// entries of rank < k are the merge, emit(rank, value, entry) writes
// them.  Every thread of the block takes entries; no rounds.
template <typename NReal, typename Emit>
__device__ __forceinline__ void rank_merge(const float* s_v, int n_runs,
                                           int len, int k, NReal n_real,
                                           Emit emit) {
  for (int m = threadIdx.x; m < n_runs * len; m += blockDim.x) {
    const int t = m / len, i = m - t * len;
    if (i >= n_real(t)) continue;
    const float v = s_v[m];
    int rank = i;
    for (int u = 0; u < n_runs && rank < k; ++u) {
      if (u == t) continue;
      const float* run = s_v + u * len;
      int lo = 0, hi = n_real(u);        // entries of run u before (t, i)
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (u < t ? run[mid] >= v : run[mid] > v) lo = mid + 1;
        else hi = mid;
      }
      rank += lo;
    }
    if (rank < k) emit(rank, v, m);
  }
}

// A row in one block: n_tiles warps select, the block merges.
template <int PER, bool VEC, int ENT>
__global__ void __launch_bounds__(kMaxWarps * 32)
topk_rows_kernel(const float* __restrict__ x, float* __restrict__ out_v,
                 int* __restrict__ out_i, int n_cols, int tile, int n_tiles,
                 int k_tile, int k) {
  __shared__ float s_v[ENT];
  __shared__ int s_c[ENT];
  const long long row = blockIdx.x;
  const int t = threadIdx.x >> 5;
  const float* xr = x + row * n_cols;
  warp_topk<PER, VEC, false>(xr, t * tile, tile, n_cols, k_tile, nullptr,
                             [&](int r, float v, int c) {
                               s_v[t * k_tile + r] = v;
                               s_c[t * k_tile + r] = t * tile + c;
                             });
  __syncthreads();
  rank_merge(s_v, n_tiles, k_tile, k, [&](int) { return k_tile; },
             [&](int r, float v, int m) {
               out_v[row * k + r] = v;
               out_i[row * k + r] = s_c[m];
             });
}

// Stage 1 alone: a warp per (row, tile), kTileWarps warps a block.
template <int PER, bool VEC>
__global__ void __launch_bounds__(kTileWarps * 32)
topk_tiles_kernel(const float* __restrict__ x, float* __restrict__ out_v,
                  int* __restrict__ out_i, long long n_warps, int n_cols,
                  int tile, int n_tiles, int k) {
  const long long w = (long long)blockIdx.x * kTileWarps + (threadIdx.x >> 5);
  if (w >= n_warps) return;             // the whole warp
  const long long row = w / n_tiles;
  const int t = (int)(w - row * n_tiles);
  warp_topk<PER, VEC, false>(x + row * n_cols, t * tile, tile, n_cols, k,
                             nullptr, [&](int r, float v, int c) {
                               out_v[w * k + r] = v;
                               out_i[w * k + r] = t * tile + c;
                             });
}

// The distinct merge of a row's n_cols candidates: n_chunks warps take
// `chunk` candidates each by rounds, then the block merges their sorted
// winners by rank.
template <int PER, int ENT>
__global__ void __launch_bounds__(kMaxWarps * 32)
topk_merge_kernel(const float* __restrict__ cand_v,
                  const int* __restrict__ ids, float* __restrict__ out_v,
                  int* __restrict__ out_i, int n_cols, int chunk,
                  int n_chunks, int k) {
  __shared__ float s_v[ENT];
  __shared__ int s_c[ENT];
  const long long row = blockIdx.x;
  const int t = threadIdx.x >> 5;
  warp_topk<PER, false, true>(cand_v + row * n_cols, t * chunk, chunk,
                              n_cols, k, nullptr,
                              [&](int r, float v, int c) {
                                s_v[t * k + r] = v;
                                s_c[t * k + r] =
                                    c == INT_MAX ? INT_MAX : t * chunk + c;
                              });
  __syncthreads();
  // chunk u's winners: min(k, its candidates), then (-inf, INT_MAX)s
  rank_merge(s_v, n_chunks, k, k,
             [&](int u) { return min(k, min(chunk, n_cols - u * chunk)); },
             [&](int r, float v, int m) {
               out_v[row * k + r] = v;
               out_i[row * k + r] = ids[row * n_cols + s_c[m]];
             });
}

// Register slots per lane for `n` columns (n <= kMaxTile).
int per_for(int n) { return n <= 128 ? 4 : n <= 512 ? 16 : 64; }
// Shared-memory entries of a block's merge for `n` candidates.
int ent_for(int n) { return n <= 64 ? 64 : n <= 256 ? 256 : kMaxEntries; }

template <int PER, bool VEC>
void rows_launch(int ent, const float* x, float* ov, int* oi,
                 long long rows, int n_cols, int tile, int n_tiles,
                 int k_tile, int k, cudaStream_t s) {
  const dim3 grid((unsigned)rows), block(32 * n_tiles);
  if (ent == 64)
    topk_rows_kernel<PER, VEC, 64><<<grid, block, 0, s>>>(
        x, ov, oi, n_cols, tile, n_tiles, k_tile, k);
  else if (ent == 256)
    topk_rows_kernel<PER, VEC, 256><<<grid, block, 0, s>>>(
        x, ov, oi, n_cols, tile, n_tiles, k_tile, k);
  else
    topk_rows_kernel<PER, VEC, kMaxEntries><<<grid, block, 0, s>>>(
        x, ov, oi, n_cols, tile, n_tiles, k_tile, k);
}

template <bool VEC>
void rows_dispatch(const float* x, float* ov, int* oi, long long rows,
                   int n_cols, int tile, int n_tiles, int k_tile, int k,
                   cudaStream_t s) {
  const int per = per_for(tile), ent = ent_for(n_tiles * k_tile);
  if (per == 4)
    rows_launch<4, VEC>(ent, x, ov, oi, rows, n_cols, tile, n_tiles,
                        k_tile, k, s);
  else if (per == 16)
    rows_launch<16, VEC>(ent, x, ov, oi, rows, n_cols, tile, n_tiles,
                         k_tile, k, s);
  else
    rows_launch<64, VEC>(ent, x, ov, oi, rows, n_cols, tile, n_tiles,
                         k_tile, k, s);
}

template <bool VEC>
void tiles_dispatch(const float* x, float* ov, int* oi, long long rows,
                    int n_cols, int tile, int n_tiles, int k,
                    cudaStream_t s) {
  const long long n_warps = rows * n_tiles;
  const unsigned blocks = (unsigned)((n_warps + kTileWarps - 1) / kTileWarps);
  const int per = per_for(tile);
  if (per == 4)
    topk_tiles_kernel<4, VEC><<<blocks, 32 * kTileWarps, 0, s>>>(
        x, ov, oi, n_warps, n_cols, tile, n_tiles, k);
  else if (per == 16)
    topk_tiles_kernel<16, VEC><<<blocks, 32 * kTileWarps, 0, s>>>(
        x, ov, oi, n_warps, n_cols, tile, n_tiles, k);
  else
    topk_tiles_kernel<64, VEC><<<blocks, 32 * kTileWarps, 0, s>>>(
        x, ov, oi, n_warps, n_cols, tile, n_tiles, k);
}

template <int PER>
void merge_launch(int ent, const float* cv, const int* ids, float* ov,
                  int* oi, long long rows, int n_cols, int chunk,
                  int n_chunks, int k, cudaStream_t s) {
  const dim3 grid((unsigned)rows), block(32 * n_chunks);
  if (ent == 64)
    topk_merge_kernel<PER, 64><<<grid, block, 0, s>>>(cv, ids, ov, oi,
                                                      n_cols, chunk,
                                                      n_chunks, k);
  else if (ent == 256)
    topk_merge_kernel<PER, 256><<<grid, block, 0, s>>>(cv, ids, ov, oi,
                                                       n_cols, chunk,
                                                       n_chunks, k);
  else
    topk_merge_kernel<PER, kMaxEntries><<<grid, block, 0, s>>>(
        cv, ids, ov, oi, n_cols, chunk, n_chunks, k);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

}  // namespace

extern "C" {

// The limits of one launch: columns of a tile (one warp), warps of a
// row's block, and candidates one warp merges.
int topk_max_tile() { return kMaxTile; }
int topk_max_warps() { return kMaxWarps; }
int topk_max_entries() { return kMaxEntries; }

// x (rows, n_cols) f32, row-major and contiguous, in tiles of `tile`
// columns (the last one past n_cols reads NEG).  Each call launches on
// `stream` and returns cudaGetLastError() (0 on success).
//
// Stage 1 and the merge in one launch: n_tiles = ceil(n_cols / tile) <=
// topk_max_warps(), n_tiles * k_tile <= topk_max_entries(); each tile
// gives k_tile candidates, the row's top-k goes to out (rows, k).
int topk_rows(const float* x, float* out_v, int* out_i, long long rows,
              int n_cols, int tile, int k_tile, int k, void* stream) {
  if (rows == 0) return 0;
  const int n_tiles = (n_cols + tile - 1) / tile;
  if (rows > INT_MAX || n_cols < 1 || tile < 1 || tile > kMaxTile ||
      n_tiles > kMaxWarps || k_tile < 1 || k_tile > tile || k < 1 ||
      k > n_tiles * k_tile || n_tiles * k_tile > kMaxEntries)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_cols % 4 == 0 && tile % 4 == 0 && aligned16(x))
    rows_dispatch<true>(x, out_v, out_i, rows, n_cols, tile, n_tiles,
                        k_tile, k, s);
  else
    rows_dispatch<false>(x, out_v, out_i, rows, n_cols, tile, n_tiles,
                         k_tile, k, s);
  return (int)cudaGetLastError();
}

// Stage 1 alone: out (rows, n_tiles * k), candidate ids as columns.
int topk_tiles(const float* x, float* out_v, int* out_i, long long rows,
               int n_cols, int tile, int k, void* stream) {
  if (rows == 0) return 0;
  const int n_tiles = (n_cols + tile - 1) / tile;
  if (n_cols < 1 || tile < 1 || tile > kMaxTile || k < 1 || k > tile ||
      (rows * n_tiles + kTileWarps - 1) / kTileWarps > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_cols % 4 == 0 && tile % 4 == 0 && aligned16(x))
    tiles_dispatch<true>(x, out_v, out_i, rows, n_cols, tile, n_tiles, k, s);
  else
    tiles_dispatch<false>(x, out_v, out_i, rows, n_cols, tile, n_tiles, k,
                          s);
  return (int)cudaGetLastError();
}

// The merge: cand_v (rows, n_cols) f32 and ids (rows, n_cols) i32 ->
// out (rows, k), distinct positions, ties to the smallest position, ids
// read through `ids`.  n_cols <= topk_max_warps() * topk_max_tile() and
// ceil(n_cols / topk_max_tile()) * k <= topk_max_entries().
int topk_merge(const float* cand_v, const int* ids, float* out_v,
               int* out_i, long long rows, int n_cols, int k,
               void* stream) {
  if (rows == 0) return 0;
  const int n_chunks = (n_cols + kMaxTile - 1) / kMaxTile;
  if (rows > INT_MAX || n_cols < 1 || k < 1 || k > n_cols ||
      n_chunks > kMaxWarps || n_chunks * k > kMaxEntries)
    return (int)cudaErrorInvalidValue;
  const int chunk = (n_cols + n_chunks - 1) / n_chunks;
  const int per = per_for(chunk), ent = ent_for(n_chunks * k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (per == 4)
    merge_launch<4>(ent, cand_v, ids, out_v, out_i, rows, n_cols, chunk,
                    n_chunks, k, s);
  else if (per == 16)
    merge_launch<16>(ent, cand_v, ids, out_v, out_i, rows, n_cols, chunk,
                     n_chunks, k, s);
  else
    merge_launch<64>(ent, cand_v, ids, out_v, out_i, rows, n_cols, chunk,
                     n_chunks, k, s);
  return (int)cudaGetLastError();
}

const char* topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
