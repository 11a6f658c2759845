// Fused logsumexp + top-k gather over vocab tiles, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/sparse_ce/kernel.py
// (sparse_ce_tiles, body _kernel) and the padding of its wrapper
// (ops.py:26-45).  For h (T, D), w (D, V) and teacher ids idx (T, K), all
// row-major, it returns per row the logsumexp of the logits h @ w over
// the vocab, and the K logits at the ids, without writing the (T, V)
// logits to device memory.  An optional tanh softcap applies to every
// logit first, as in the reference.
//
// Two kernels:
//   tiles (grid: vocab tiles x row tiles): one block computes a 64 x 128
//     tile of logits in its own body -- h and w staged through shared
//     memory 16 deep along D, each thread holding an 8 x 4 sub-tile of
//     float32 FMA sums (no TF32, no tensor cores: the reference runs
//     Precision.HIGHEST) -- applies the softcap, masks the columns at or
//     past V to NEG, and writes the tile's per-row max m and sum
//     l = sum exp(logit - m) as partials.  Each (row, k) whose id lies in
//     the tile is gathered here; the vocab tile 0 writes NEG for ids
//     past every tile, as the reference's gather leaves them.  Columns
//     past V are read as masked, without a padded copy of w.
//   merge (one thread per row): the online (m, l) merge of the row's
//     partials and lse = m + log(max(l, 1e-30)), as the reference's
//     last grid step does.
// The reference walks the vocab sequentially inside one program; here
// the vocab tiles run in parallel blocks and the merge is the second
// pass, so the sum order differs (lse agrees to float32 rounding).
//
// What bounds it on an H100: operations.  2*T*D*V flops at the float32
// rate outside the tensor cores (67 TFLOP/s), against a few MB of h, w
// and ids.  This first design is a plain shared-memory SGEMM tile with
// the online-softmax epilogue fused; wgmma with 3xTF32 splitting, larger
// tiles and vector loads are later speed work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int BM = 64;            // rows of a tile
constexpr int BN = 128;           // vocab columns of a tile
constexpr int BK = 16;            // depth staged per step
constexpr int TM = 8;             // rows per thread
constexpr int TN = 4;             // columns per thread (strided by 32)
constexpr float kNeg = -1e30f;    // the reference's NEG

// a warp per TM-row stripe, a lane per column (strided by 32)
static_assert((kThreads / 32) * TM == BM && 32 * TN == BN, "thread layout");
static_assert((BM * BK) % kThreads == 0 && (BK * BN) % kThreads == 0,
              "tile loads");

__global__ void __launch_bounds__(kThreads)
sparse_ce_tiles_kernel(const float* __restrict__ h,
                       const float* __restrict__ w,
                       const int* __restrict__ idx,
                       float* __restrict__ part_m,
                       float* __restrict__ part_l,
                       float* __restrict__ z,
                       int T, int D, int V, int K, int n_vt, float softcap) {
  __shared__ float As[BK][BM + 1];          // h tile, transposed
  __shared__ float Bs[BK][BN];              // w tile
  __shared__ float Ct[BM][BN + 1];          // the logits tile

  const int vt = blockIdx.x;
  const int row0 = blockIdx.y * BM;
  const int col0 = vt * BN;
  const int tid = threadIdx.x;
  const int tr = tid >> 5;                  // rows tr*TM .. +TM
  const int tc = tid & 31;                  // columns tc + 32*j

  float acc[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[m][n] = 0.0f;

  for (int k0 = 0; k0 < D; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int m = e / BK, kk = e % BK;
      const int gr = row0 + m, gk = k0 + kk;
      As[kk][m] = (gr < T && gk < D) ? h[(long long)gr * D + gk] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < (BK * BN) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int kk = e / BN, n = e % BN;
      const int gk = k0 + kk, gc = col0 + n;
      Bs[kk][n] = (gk < D && gc < V) ? w[(long long)gk * V + gc] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int m = 0; m < TM; ++m) a[m] = As[kk][tr * TM + m];
#pragma unroll
      for (int n = 0; n < TN; ++n) b[n] = Bs[kk][tc + 32 * n];
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int n = 0; n < TN; ++n) acc[m][n] = fmaf(a[m], b[n], acc[m][n]);
    }
    __syncthreads();
  }

  // epilogue 1: softcap, mask the columns past V, stage the tile
#pragma unroll
  for (int m = 0; m < TM; ++m) {
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const int c = tc + 32 * n;
      float x = acc[m][n];
      if (softcap != 0.0f) x = tanhf(x / softcap) * softcap;
      Ct[tr * TM + m][c] = (col0 + c < V) ? x : kNeg;
    }
  }
  __syncthreads();

  // epilogue 2: per-row (max, sum of exp) of this tile, a warp per row
  const int warp = tid >> 5, lane = tid & 31;
  for (int rr = 0; rr < BM / (kThreads / 32); ++rr) {
    const int r = warp * (BM / (kThreads / 32)) + rr;
    const int gr = row0 + r;
    float v[BN / 32];
    float mx = kNeg;
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) {
      v[j] = Ct[r][lane + 32 * j];
      mx = fmaxf(mx, v[j]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) s += expf(v[j] - mx);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0 && gr < T) {
      part_m[(long long)gr * n_vt + vt] = mx;
      part_l[(long long)gr * n_vt + vt] = s;
    }
  }

  // epilogue 3: gather the teacher ids that fall in this tile
  const long long cover = (long long)n_vt * BN;
  for (int e = tid; e < BM * K; e += kThreads) {
    const int r = e / K;
    const int gr = row0 + r;
    if (gr >= T) continue;
    const long long at = (long long)gr * K + (e % K);
    const int id = idx[at];
    const int loc = id - col0;
    if (loc >= 0 && loc < BN) {
      z[at] = Ct[r][loc];
    } else if (vt == 0 && (id < 0 || (long long)id >= cover)) {
      z[at] = kNeg;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
sparse_ce_merge_kernel(const float* __restrict__ part_m,
                       const float* __restrict__ part_l,
                       float* __restrict__ lse, int T, int n_vt) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= T) return;
  const float* pm = part_m + (long long)r * n_vt;
  const float* pl = part_l + (long long)r * n_vt;
  float m = kNeg;
  for (int j = 0; j < n_vt; ++j) m = fmaxf(m, pm[j]);
  float l = 0.0f;
  for (int j = 0; j < n_vt; ++j) l += pl[j] * expf(pm[j] - m);
  lse[r] = m + logf(fmaxf(l, 1e-30f));
}

}  // namespace

extern "C" {

// Vocab columns of one tile: partials are (T, ceil(V / this)).
int sparse_ce_tile_cols() { return BN; }

// h (T, D), w (D, V) f32 and idx (T, K) i32, row-major and contiguous.
// Writes the per-tile partials part_m, part_l (T, n_vt) and z (T, K).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int sparse_ce_tiles(const float* h, const float* w, const int* idx,
                    float* part_m, float* part_l, float* z, int T, int D,
                    int V, int K, float softcap, void* stream) {
  if (T == 0) return 0;
  if (T < 0 || D < 1 || V < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const int n_vt = (V + BN - 1) / BN;
  const long long row_tiles = (T + BM - 1) / BM;
  if (row_tiles > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)n_vt, (unsigned)row_tiles);
  sparse_ce_tiles_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      h, w, idx, part_m, part_l, z, T, D, V, K, n_vt, softcap);
  return (int)cudaGetLastError();
}

// The second pass: lse (T,) from the partials of sparse_ce_tiles.
int sparse_ce_merge(const float* part_m, const float* part_l, float* lse,
                    int T, int n_vt, void* stream) {
  if (T == 0) return 0;
  if (T < 0 || n_vt < 1) return (int)cudaErrorInvalidValue;
  sparse_ce_merge_kernel<<<(T + kThreads - 1) / kThreads, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      part_m, part_l, lse, T, n_vt);
  return (int)cudaGetLastError();
}

const char* sparse_ce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
