// Candidate merge + Gumbel-max sampling for Hopper (sm_90a): a warp per
// row merging stage 1's sorted runs.
//
// Replaces the Pallas TPU kernel src/repro/kernels/topk_sample/kernel.py:91
// (topk_sample_tiles, body _kernel): stage 2 of the fused sampler.  Stage
// 1 is topk_logits.cu's topk_tiles_kernel at k = k_cap: each vocab tile's
// top k_cap, in tile order.  So a row's C candidates are n_runs = C / k_cap
// runs of k_cap, each sorted by (value desc, position asc) -- the
// precondition this kernel relies on (it holds for every row whose logits
// lie above stage 1's NEG mask, all finite logits: a tile's NEG repeats
// come after its real values and at later positions).  The row's top
// k_cap by (value desc, position asc) is then a k_cap-way merge of run
// heads; no search over all C values is needed.  Ties go to the smallest
// position, which is the smallest vocab id (tiles are laid out in id
// order, each run's ties by id), as lax.top_k breaks them.  -0 and +0
// compare equal (the key below), each winner keeps its own value.
//
// Chosen over a warp running topk_logits.cu's distinct rule over all C
// values (no precondition), where each lane holds ~75 values and a round
// re-reduces its group: here a lane holds at most 4 heads in registers.
//
// One warp a row and a block (packing 2-8 rows a block was no faster at
// R = 16 and 128, PERF.md), no block barrier:
//   1. the warp copies the row's C values into shared memory with
//      cp.async, all in flight at once (16 bytes a copy when C % 4 == 0);
//   2. the merge: lane l owns runs l, l + 32, l + 64, ... .  Its first
//      four ("hot" runs l + 32j, j < 4: every run while C / k_cap <= 128,
//      V <= 262,144 at 2,048-wide tiles) it keeps in registers, each
//      run's head (its key and position, as one 64-bit rank) with the next
//      value of the run read ahead; any further runs ("cold": up to 8,064
//      of them, C <= 8,192 at k_cap = 1) keep their head offsets in shared
//      memory, one byte a run, with the best cold head cached in a
//      register (a second instantiation: rows without cold runs compile
//      that code out).  A lane's best head is the best of these.  A round is a
//      warp argmax in two redux.sync: __reduce_max_sync on the heads'
//      order-preserving keys (order_key of topk_logits.cu, -0 keyed as
//      +0), then __reduce_min_sync on the positions of the lanes holding
//      that key.  Lane r keeps round r's position; the owning lane
//      advances that run's head -- a hot run promotes its read-ahead value
//      and reads the one after it (off the round's critical path), a cold
//      run bumps its offset and the lane rescans its cold runs -- and
//      re-picks its best.  k_cap rounds;
//   3. lane j = rank j reads its winner's value (shared memory) and id
//      (cand_i), writes vals and idx and, unless greedy, runs the sampling
//      arithmetic in the same warp: the safe temperature, exp(s - s0) and
//      its normalisation, the exclusive mass excl[j] = sum_{i<j} p[i]
//      summed in rank order (what the reference's strict-upper-triangular
//      f32 matmul computes: products with 0 and 1 are exact), keep = rank
//      < min(top_k or k_cap, k_cap) & excl < top_p | rank == 0, score =
//      where(keep, s, -1e30) + gumbel, and the argmax with ties to the
//      lower rank; rows with temperature <= 0 emit rank 0.  The greedy
//      variant writes idx[:, 0] as the token, which equals the
//      first-maximum argmax of the row bitwise.  The noise comes in as an
//      input (made per (seed, position) by the wrapper's threefry twin).
//
// Rounding: the scaling is a correctly rounded division, the shifts and
// sums are __fadd_rn/__fsub_rn, exp is expf (no fast math), so vals, idx
// and the scaled scores equal the plain PyTorch version bitwise; the
// softmax denominator is summed in another order than torch's reduction,
// so a probability may differ in its last bit, which can move a token
// only where an excl lies within an ulp of its top_p.
//
// What bounds it on an H100: latency.  Its bytes are R * C * 8 of
// candidates in (2,400 a row at V = 151,936: 0.3 MB at R = 16, 0.00009 ms
// at the memory rate) and R * (2 k_cap + 1) * 4 out.  What takes the time
// is one warp's dependent chain: the launch, the row's copy (one L2 round
// trip, fresh from stage 1), then k_cap rounds of two redux.sync and the
// owner's update (the larger part), the id gather and the sampling.  Rows
// run in parallel, so R = 16 and R = 128 take about the same time.  The
// earlier design (one 256-thread block a row searching all C values:
// k_cap rounds of a 5-level shuffle tree, a block barrier and a rescan)
// took ~0.019 ms; this one needs no barrier, no search and, while every
// run is hot, no shared-memory read on a round's critical path.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kMaxK = 32;
constexpr int kMaxCandidates = 8192;  // C: 32 KB of values in shared memory
constexpr int kHot = 4;               // runs a lane keeps in registers
constexpr int kHotRuns = 32 * kHot;   // runs past these are cold
constexpr float kNegInf = -1e30f;     // the sampling keep-mask value
constexpr unsigned kNone = 0xffffffffu;  // the position of no head

__device__ __forceinline__ bool better(float v1, int c1, float v2, int c2) {
  return v1 > v2 || (v1 == v2 && c1 < c2);
}

// An unsigned key in the order of the floats (-0 keyed as +0, which
// compares equal to it), so a warp's max is one __reduce_max_sync; every
// non-NaN float keys above 0, the key of no head.
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f == 0.f ? 0.f : f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// A head's rank: its key above its complemented position, so that the
// larger of two ranks is the better head, ties to the smaller position.
__device__ __forceinline__ unsigned long long rank_of(float v, unsigned pos) {
  return (unsigned long long)order_key(v) << 32 | ~pos;
}

// BYTES (4 or 16, aligned) from device to shared memory, asynchronously
// (cp.async): a thread's copies are all in flight until its wait_all.
template <int BYTES>
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d),
                 "l"(src)
                 : "memory");
}

// COLD: the row has runs past kHotRuns (otherwise the cold-run code is
// compiled out, and a round is the registers' alone).
template <bool COLD>
__global__ void __launch_bounds__(32)
topk_sample_kernel(const float* __restrict__ cand_v,
                   const int* __restrict__ cand_i, int c, int k,
                   const float* __restrict__ temp,
                   const int* __restrict__ top_k,
                   const float* __restrict__ top_p,
                   const float* __restrict__ gumbel,
                   float* __restrict__ out_v, int* __restrict__ out_i,
                   int* __restrict__ token, int greedy) {
  // the row's C values, then a byte a cold run: its head's offset
  extern __shared__ float4 s_row[];
  __shared__ float prob[kMaxK];
  const int lane = threadIdx.x;
  const long long row = blockIdx.x;
  const int c4 = (c + 3) >> 2;
  float* s = reinterpret_cast<float*>(s_row);
  unsigned char* coff = reinterpret_cast<unsigned char*>(s_row + c4);
  const float* xr = cand_v + row * c;

  // 1. the row's values into shared memory, every copy in flight at once
  if ((c & 3) == 0 && (reinterpret_cast<uintptr_t>(xr) & 15) == 0) {
    for (int i = lane; i < c4; i += 32)
      copy_async<16>(s + 4 * i, xr + 4 * i);
  } else {
    for (int i = lane; i < c; i += 32) copy_async<4>(s + i, xr + i);
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncwarp();

  // 2. the merge of the runs' heads.  A head is one 64-bit rank, key << 32
  // | ~position (the larger key, then the smaller position, ranks higher;
  // 0: no head).  A hot head keeps the next value of its run read ahead,
  // so a round's critical path holds no shared-memory read; a lane reads
  // and writes only its own cold runs' offsets.
  const int n_runs = c / k;
  unsigned long long head[kHot];
  unsigned hend[kHot];                          // the run's end position
  float nval[kHot];
#pragma unroll
  for (int j = 0; j < kHot; ++j) {
    const int run = lane + 32 * j;
    const bool live = run < n_runs;
    head[j] = live ? rank_of(s[run * k], run * k) : 0ull;
    hend[j] = (unsigned)((run + 1) * k);
    nval[j] = live && k > 1 ? s[run * k + 1] : -INFINITY;
  }
  auto cold_best = [&]() {
    unsigned long long b = 0ull;
    for (int run = kHotRuns + lane; run < n_runs; run += 32) {
      const int o = coff[run - kHotRuns];
      if (o < k) b = max(b, rank_of(s[run * k + o], run * k + o));
    }
    return b;
  };
  unsigned long long cbest = 0ull;              // this lane's best cold head
  if (COLD) {
    for (int run = kHotRuns + lane; run < n_runs; run += 32)
      coff[run - kHotRuns] = 0;
    cbest = cold_best();
  }
  unsigned long long best = cbest;              // this lane's best head
#pragma unroll
  for (int j = 0; j < kHot; ++j) best = max(best, head[j]);
  unsigned mine = 0;                            // lane r: round r's position
  for (int r = 0; r < k; ++r) {
    const unsigned lkey = (unsigned)(best >> 32), lpos = ~(unsigned)best;
    const unsigned kmax = __reduce_max_sync(0xffffffffu, lkey);
    const unsigned wpos =
        __reduce_min_sync(0xffffffffu, lkey == kmax ? lpos : kNone);
    if (lane == r) mine = wpos;
    if (lpos == wpos) {                         // the owner advances
      const unsigned long long won = best;      // ranks are distinct
      if (COLD && won == cbest) {
        ++coff[wpos / k - kHotRuns];
        cbest = cold_best();
      }
      best = cbest;
#pragma unroll
      for (int j = 0; j < kHot; ++j) {
        if (head[j] == won) {
          head[j] = wpos + 1 < hend[j] ? rank_of(nval[j], wpos + 1) : 0ull;
          if (wpos + 2 < hend[j]) nval[j] = s[wpos + 2];
        }
        best = max(best, head[j]);
      }
    }
  }

  // 3. the winners, lane j = rank j, and the sampling arithmetic
  const bool in = lane < k;
  const float val = in ? s[mine] : 0.f;
  const int id = in ? __ldg(cand_i + row * c + mine) : 0;
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

}  // namespace

extern "C" {

// cand_v (rows, c) f32, cand_i (rows, c) i32, contiguous: c / k runs of
// k, each sorted by (value desc, position asc); 1 <= k <= min(c, 32),
// c <= 8,192.  Unless greedy: temp, top_p (rows,) f32, top_k (rows,) i32
// and gumbel (rows, k) f32.  Writes out_v (rows, k) f32, out_i (rows, k)
// i32 and token (rows,) i32, a block (one warp) a row.  Launches on
// `stream` and returns cudaGetLastError().
int topk_sample(const float* cand_v, const int* cand_i, long long rows,
                int c, int k, const float* temp, const int* top_k,
                const float* top_p, const float* gumbel, float* out_v,
                int* out_i, int* token, int greedy, void* stream) {
  if (rows == 0) return 0;
  if (rows < 0 || rows > INT_MAX || k < 1 || k > kMaxK || c < k ||
      c % k || c > kMaxCandidates)
    return (int)cudaErrorInvalidValue;
  const int cold = c / k > kHotRuns ? c / k - kHotRuns : 0;
  const size_t smem = (size_t)((c + 3) / 4) * 16 + cold;   // <= 40,832 B
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cold)
    topk_sample_kernel<true><<<(unsigned)rows, 32, smem, s>>>(
        cand_v, cand_i, c, k, temp, top_k, top_p, gumbel, out_v, out_i,
        token, greedy);
  else
    topk_sample_kernel<false><<<(unsigned)rows, 32, smem, s>>>(
        cand_v, cand_i, c, k, temp, top_k, top_p, gumbel, out_v, out_i,
        token, greedy);
  return (int)cudaGetLastError();
}

const char* topk_sample_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
