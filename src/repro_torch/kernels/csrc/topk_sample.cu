// Candidate merge + Gumbel-max sampling, one pass per row, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/topk_sample/kernel.py
// (topk_sample_tiles, body _kernel): stage 2 of the fused sampler.  Stage
// 1 is topk_logits.cu at k = k_cap (per vocab tile, the tile's top k_cap).
// For every row of (R, C) candidates this kernel
//   1. merges them to the row's top k_cap: k_cap rounds of a block-wide
//      argmax on (value, -position), the winner removed each round, so
//      ties go to the smallest position (= the smallest vocab id: tiles
//      are laid out in id order, each tile's candidates sorted with ties
//      by id), as lax.top_k breaks them;
//   2. unless `greedy`, in one warp (lane j = rank j): the safe
//      temperature, exp(s - s0) and its normalisation, the exclusive mass
//      excl[j] = sum_{i<j} p[i] summed in rank order (what the reference's
//      strict-upper-triangular f32 matmul computes: products with 0 and 1
//      are exact), keep = rank < min(top_k or k_cap, k_cap) & excl < top_p
//      | rank == 0, score = where(keep, s, -1e30) + gumbel, and the argmax
//      with ties to the lower rank; rows with temperature <= 0 emit rank 0;
//   3. writes vals (R, k_cap) f32, idx (R, k_cap) i32 and token (R,) i32.
// The greedy variant writes idx[:, 0] as the token, which equals the
// first-maximum argmax of the row bitwise.  The noise comes in as an
// input (made per (seed, position) by the wrapper's threefry twin).
//
// Rounding: the scaling is a correctly rounded division, the shifts and
// sums are __fadd_rn/__fsub_rn, exp is expf (no fast math), so vals, idx
// and the scaled scores equal the plain PyTorch version bitwise; the
// softmax denominator is summed in another order than torch's reduction,
// so a probability may differ in its last bit, which can move a token
// only where an excl lies within an ulp of its top_p.
//
// What bounds it on an H100: nothing of note — it reads R * C * 8 bytes
// of candidates (2,400 per row at V = 151,936) and does k_cap rounds of
// a block reduction per row.  The whole sampler is bound by stage 1's
// read of the (R, V) logits.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 32;
constexpr float kNegInf = -1e30f;     // the sampling keep-mask value

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
topk_sample_kernel(const float* __restrict__ cand_v,
                   const int* __restrict__ cand_i, int c, int k,
                   const float* __restrict__ temp,
                   const int* __restrict__ top_k,
                   const float* __restrict__ top_p,
                   const float* __restrict__ gumbel,
                   float* __restrict__ out_v, int* __restrict__ out_i,
                   int* __restrict__ token, int greedy) {
  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* xr = cand_v + row * c;
  const int* ir = cand_i + row * c;

  // 1. the merge: k rounds of block-wide argmax, winners removed
  float v[PER];
  unsigned taken = 0;                   // bit j: slot j is not a candidate
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int col = tid + j * kThreads;
    if (col < c) {
      v[j] = xr[col];
    } else {
      v[j] = -INFINITY;
      taken |= 1u << j;
    }
  }
  float bv;
  int bc;
  local_best<PER>(v, taken, tid, bv, bc);

  __shared__ float s_v[2][kWarps];
  __shared__ int s_c[2][kWarps];
  __shared__ float win_v[kMaxK];
  __shared__ int win_i[kMaxK];
  __shared__ float prob[kMaxK];
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
    const int buf = r & 1;              // double-buffered: one barrier
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
      win_v[r] = mv;
      win_i[r] = mc == INT_MAX ? -1 : ir[mc];
    }
    if (mc != INT_MAX && mc % kThreads == tid) {    // the owner removes it
      const int slot = mc / kThreads;
#pragma unroll
      for (int j = 0; j < PER; ++j)
        if (j == slot) taken |= 1u << j;
      local_best<PER>(v, taken, tid, bv, bc);
    }
  }
  __syncthreads();
  if (warp != 0) return;

  // 2. the sampling arithmetic, lane j = rank j
  const bool in = lane < k;
  const float val = in ? win_v[lane] : 0.f;
  const int id = in ? win_i[lane] : 0;
  if (in) {
    out_v[row * k + lane] = val;
    out_i[row * k + lane] = id;
  }
  const int id0 = __shfl_sync(0xffffffffu, id, 0);
  if (greedy) {
    if (lane == 0) token[row] = id0;
    return;
  }
  const float t = temp[row];
  const float safe_t = t > 0.f ? t : 1.f;
  const float sv = in ? __fdiv_rn(val, safe_t) : 0.f;
  const float s0 = __shfl_sync(0xffffffffu, sv, 0);
  const float e = in ? expf(__fsub_rn(sv, s0)) : 0.f;
  float sum = e;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
  if (in) prob[lane] = __fdiv_rn(e, sum);
  __syncwarp();
  float excl = 0.f;
  for (int i = 0; i < lane && i < k; ++i) excl = __fadd_rn(excl, prob[i]);
  const int tk = top_k[row];
  const int k_eff = tk > 0 ? min(tk, k) : k;
  const bool keep = (lane < k_eff && excl < top_p[row]) || lane == 0;
  float sc = in ? __fadd_rn(keep ? sv : kNegInf, gumbel[row * k + lane])
                : -INFINITY;
  int rank = in ? lane : INT_MAX;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_xor_sync(0xffffffffu, sc, off);
    const int orank = __shfl_xor_sync(0xffffffffu, rank, off);
    if (better(os, orank, sc, rank)) {
      sc = os;
      rank = orank;
    }
  }
  const int picked = __shfl_sync(0xffffffffu, id, rank & 31);
  if (lane == 0) token[row] = t > 0.f ? picked : id0;
}

template <int PER>
void launch(const float* cand_v, const int* cand_i, long long rows, int c,
            int k, const float* temp, const int* top_k, const float* top_p,
            const float* gumbel, float* out_v, int* out_i, int* token,
            int greedy, cudaStream_t stream) {
  topk_sample_kernel<PER><<<(unsigned)rows, kThreads, 0, stream>>>(
      cand_v, cand_i, c, k, temp, top_k, top_p, gumbel, out_v, out_i, token,
      greedy);
}

}  // namespace

extern "C" {

// Most candidates one row may have (32 register slots per thread), and
// the largest k_cap.
int topk_sample_max_candidates() { return 32 * kThreads; }
int topk_sample_max_k() { return kMaxK; }

// cand_v (rows, c) f32, cand_i (rows, c) i32, contiguous; k <= min(c, 32).
// Unless greedy: temp, top_p (rows,) f32, top_k (rows,) i32 and gumbel
// (rows, k) f32.  Writes out_v (rows, k) f32, out_i (rows, k) i32 and
// token (rows,) i32.  Launches on `stream` and returns cudaGetLastError().
int topk_sample(const float* cand_v, const int* cand_i, long long rows,
                int c, int k, const float* temp, const int* top_k,
                const float* top_p, const float* gumbel, float* out_v,
                int* out_i, int* token, int greedy, void* stream) {
  if (rows == 0) return 0;
  if (rows < 0 || rows > INT_MAX || k < 1 || k > kMaxK || k > c ||
      c > 32 * kThreads)
    return (int)cudaErrorInvalidValue;
  const int per = (c + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TS_LAUNCH(P)                                                      \
  launch<P>(cand_v, cand_i, rows, c, k, temp, top_k, top_p, gumbel, out_v, \
            out_i, token, greedy, s)
  if (per <= 1) TS_LAUNCH(1);
  else if (per <= 2) TS_LAUNCH(2);
  else if (per <= 4) TS_LAUNCH(4);
  else if (per <= 8) TS_LAUNCH(8);
  else if (per <= 16) TS_LAUNCH(16);
  else TS_LAUNCH(32);
#undef TS_LAUNCH
  return (int)cudaGetLastError();
}

const char* topk_sample_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
