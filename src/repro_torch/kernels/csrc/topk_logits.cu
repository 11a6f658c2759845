// Top-k selection over the vocab axis, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/topk_logits/kernel.py
// (topk_logits_tiles, body _kernel) and the lax.top_k merge of its
// wrapper (ops.py:29-30).  One kernel serves both stages:
//
//   stage 1 (ids == nullptr): one thread block per (row, vocab tile).  The
//     tile's values sit in registers, spread over 256 threads; k rounds
//     of a block-wide argmax on (value, -column) pick the tile's local
//     top-k, and each round's winner is overwritten with NEG and stays
//     eligible, exactly as the Pallas kernel masks it.  Columns past the
//     row's width read as NEG: the tile padding of the reference's
//     jnp.pad, done without a padded copy.
//   stage 2, the merge (ids != nullptr): one block per row over its
//     (n_tiles * k) candidates, each a distinct element: a round's winner
//     is removed, as lax.top_k never returns one position twice.  Ties go
//     to the smallest candidate position, which is the smallest vocab id
//     (tiles are laid out in id order and each tile's candidates are
//     sorted with ties by id), and the id is read through `ids`.
//
// What bounds it on an H100: bytes.  The logits are read once (R*V*4
// bytes) and the candidates are small; the k rounds run on registers and
// shared memory.  This first design spends one __syncthreads per round
// (the warps' winners are double-buffered in shared memory by round
// parity, so one barrier suffices) and runs well above the memory bound
// for k=20; a warp per row for small V, a cluster-wide merge, or fusing
// the selection into the unembedding GEMM's epilogue are later work.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -3.4e38f;        // the reference's NEG, as f32

__device__ __forceinline__ bool better(float v1, int c1, float v2, int c2) {
  return v1 > v2 || (v1 == v2 && c1 < c2);
}

template <int PER>
__device__ __forceinline__ void local_best(const float (&v)[PER],
                                           unsigned taken, int tid,
                                           float& bv, int& bc) {
  bv = -INFINITY;
  bc = INT_MAX;                         // sentinel: loses to any element
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int col = tid + j * kThreads;
    if (!(taken & (1u << j)) && better(v[j], col, bv, bc)) {
      bv = v[j];
      bc = col;
    }
  }
}

template <int PER>
__global__ void __launch_bounds__(kThreads)
topk_select_kernel(const float* __restrict__ x, const int* __restrict__ ids,
                   float* __restrict__ out_v, int* __restrict__ out_i,
                   int n_cols, int tile, int n_tiles, int k) {
  const long long row = blockIdx.x / n_tiles;
  const int t = blockIdx.x % n_tiles;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int base = t * tile;
  const bool distinct = ids != nullptr;
  const float* xr = x + row * n_cols;

  float v[PER];
  unsigned taken = 0;                   // bit j: slot j is not an element
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int col = tid + j * kThreads;
    const int g = base + col;
    if (col >= tile) {
      v[j] = -INFINITY;
      taken |= 1u << j;
    } else {
      v[j] = g < n_cols ? xr[g] : kNeg;
    }
  }
  float bv;
  int bc;
  local_best<PER>(v, taken, tid, bv, bc);

  __shared__ float s_v[2][kWarps];
  __shared__ int s_c[2][kWarps];
  for (int r = 0; r < k; ++r) {
    float wv = bv;
    int wc = bc;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, wv, off);
      const int oc = __shfl_xor_sync(0xffffffffu, wc, off);
      if (better(ov, oc, wv, wc)) {
        wv = ov;
        wc = oc;
      }
    }
    const int buf = r & 1;
    if (lane == 0) {
      s_v[buf][warp] = wv;
      s_c[buf][warp] = wc;
    }
    __syncthreads();
    float mv = s_v[buf][0];
    int mc = s_c[buf][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      if (better(s_v[buf][w], s_c[buf][w], mv, mc)) {
        mv = s_v[buf][w];
        mc = s_c[buf][w];
      }
    }
    if (tid == 0) {
      if (distinct) {
        out_v[row * k + r] = mv;
        out_i[row * k + r] =
            mc == INT_MAX ? -1 : ids[row * n_cols + mc];
      } else {
        const long long o = (row * n_tiles + t) * k + r;
        out_v[o] = mv;
        out_i[o] = base + mc;
      }
    }
    if (mc != INT_MAX && mc % kThreads == tid) {    // the owner masks it
      const int slot = mc / kThreads;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        if (j == slot) {
          if (distinct) {
            taken |= 1u << j;
          } else {
            v[j] = kNeg;
          }
        }
      }
      local_best<PER>(v, taken, tid, bv, bc);
    }
  }
}

template <int PER>
void launch(const float* x, const int* ids, float* out_v, int* out_i,
            long long blocks, int n_cols, int tile, int n_tiles, int k,
            cudaStream_t stream) {
  topk_select_kernel<PER><<<(unsigned)blocks, kThreads, 0, stream>>>(
      x, ids, out_v, out_i, n_cols, tile, n_tiles, k);
}

}  // namespace

extern "C" {

// Largest tile one block holds: 32 register slots per thread.
int topk_max_tile() { return 32 * kThreads; }

// x (rows, n_cols) f32, row-major and contiguous.
//   stage 1: ids == nullptr; tiles of `tile` columns (n_tiles of them,
//     the last one past n_cols reads NEG); out (rows, n_tiles * k).
//   merge:   ids (rows, n_cols) i32, tile == n_cols, n_tiles == 1;
//     out (rows, k).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int topk_select(const float* x, const int* ids, float* out_v, int* out_i,
                long long rows, int n_cols, int tile, int n_tiles, int k,
                void* stream) {
  if (rows == 0) return 0;
  const long long blocks = rows * n_tiles;
  if (blocks > INT_MAX || k < 1 || k > tile || tile > topk_max_tile())
    return (int)cudaErrorInvalidValue;
  const int per = (tile + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (per <= 1) launch<1>(x, ids, out_v, out_i, blocks, n_cols, tile, n_tiles, k, s);
  else if (per <= 2) launch<2>(x, ids, out_v, out_i, blocks, n_cols, tile, n_tiles, k, s);
  else if (per <= 4) launch<4>(x, ids, out_v, out_i, blocks, n_cols, tile, n_tiles, k, s);
  else if (per <= 8) launch<8>(x, ids, out_v, out_i, blocks, n_cols, tile, n_tiles, k, s);
  else if (per <= 16) launch<16>(x, ids, out_v, out_i, blocks, n_cols, tile, n_tiles, k, s);
  else launch<32>(x, ids, out_v, out_i, blocks, n_cols, tile, n_tiles, k, s);
  return (int)cudaGetLastError();
}

const char* topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
