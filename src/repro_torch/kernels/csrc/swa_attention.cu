// Causal sliding-window attention over a whole sequence (prefill), for
// Hopper (sm_90a), on the tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/swa_attention/kernel.py
// (swa_attention_tiles, body _kernel).  For q (B, Hq, S, hd) and k, v
// (B, Hkv, S, hd), query head h reads kv head h / (Hq / Hkv), and key j is
// visible to query i iff i - window < j <= i.  In float32: scores q.k
// scaled by `scale`, an optional tanh softcap, *then* the mask to -1e30,
// an online softmax, and o = (p . v) / max(l, 1e-30), written as float32.
// A window of at least S is plain causal attention.  The TPU kernel's
// matmuls run at Precision.HIGHEST; here both products keep float32
// accuracy as 3xTF32 on wgmma: each operand x is split into
// big = cvt.rna.tf32(x) and small = cvt.rna.tf32(x - big), and
// small.big + big.small + big.big is accumulated in float32 (the
// small.small term is below float32's last bit).
//
// Two launches per call:
//   1. swa_split_kv (the prepass) writes, for every (b, kv head) and tile
//      of kTk keys, one contiguous image of what the main loop's shared
//      memory holds for that tile: k big, k small (kTk x HDP) and v^T
//      big, v^T small (HDP x kTk), each in wgmma's K-major core-matrix
//      layout without swizzle (8 rows x 16 bytes a core matrix, the
//      contraction's core matrices of an 8-row group side by side), bf16
//      widened, zero past S and past hd.  v is transposed here because a
//      .tf32 wgmma takes its B operand only K-major (keys contiguous for
//      p.v) and TMA does not transpose 32-bit data.  Within each 8 keys
//      the columns of v^T are permuted (column t holds key 2t, column
//      t + 4 key 2t + 1), so that the score accumulator's registers are
//      the A fragment of p.v as they stand: no shuffles.
//   2. swa_attention_tc: one block per (b, q head, tile of 64 query rows):
//      one consumer warpgroup and one producer warp.  The producer keeps
//      a ring of kStages key tiles in flight with bulk asynchronous copies
//      (cp.async.bulk, four per tile) on mbarriers; the consumers split
//      their q tile into shared memory once, then for each key tile
//      issue q.k^T as 3 x HDP/8 wgmma m64n{kTk}k8 (both operands from
//      shared memory), scale, softcap and mask in registers, run the
//      online softmax on the accumulator (a row's values sit in the four
//      lanes of a quad: two shuffles), split p in registers and issue
//      p.v as 3 x kTk/8 wgmma m64n{kHn}k8 for each kHn-column chunk of
//      HDP, with p as the register A operand, and release the stage.
// Accuracy: the tensor cores' float32 accumulation drifts with every
// product added to a large sum, so no accumulator takes many: q.k^T
// goes to three (the two halves of big.big, and the small terms),
// summed in float32, and each tile's p.v to a fresh one, added to o
// with one FMA (o * corr + p.v).
// The band-limited key loop stays: the query tile at q0 walks the key
// tiles that hold [max(0, q0 - window + 1), min(S, q0 + 64)); the keys of
// the band's first tile that lie before the band get v = 0 in shared
// memory (their scores are masked, but the tensor cores would turn
// 0 * NaN into NaN), so nothing before the band reaches the output.
// Blocks run in the order (b, kv head, query tile from the last, q head
// of the group): the G heads of a kv head and neighbouring query tiles
// run together and share k/v in L2, and under a causal mask the longest
// bands start first.  GQA is by index; nothing is repeated in memory.
//
// Shared memory (HDP = the head dim the tiles are built for, hd rounded
// up to 64, 120, 128 or 256; kTk keys a tile; a ring of kStages):
//   q big + small 2 x 64 x HDP x 4 B, a stage 4 x kTk x HDP x 4 B:
//   HDP 120, kTk 32: 60 KB + 2 x 60 KB = 180 KB (hd = 120);
//   HDP 64, kTk 32: 32 KB + 3 x 32 KB = 128 KB; HDP 128, kTk 32: 192 KB;
//   HDP 256, kTk 8: 128 KB + 2 x 32 KB = 192 KB (the smaller tile of the
//   same design for hd > 128, p.v in four chunks of 64 columns).
// The prepass's images take B x Hkv x ceil(S / kTk) x kTk x HDP x 16 B of
// device memory (252 MB at the prefill shape below).
//
// What bounds it on an H100: operations.  4 * hd flops per visible
// (query, key) pair (q.k and p.v), ~S * window pairs per head; as 3xTF32
// that is three tensor-core products per float32 product.  At
// h2o-danube-3-4b's prefill shape (B=2, Hq=32, Hkv=8, hd=120, S=8192,
// window 4096): 773 GFLOP, x 3 at the 495 TFLOP/s dense TF32 rate =
// 4.69 ms, against 0.63 GB of q, k, v and o (0.19 ms at the memory
// rate).  Per key tile, most of the time goes to the q.k^T wgmmas: each
// reads its 2 KB slice of q and 1 KB of k from shared memory, ~1.5x
// longer than its tensor-core math at N = 32, while p.v runs at the
// tensor-core rate and the softmax is the smaller part.  So overlapping
// the softmax with the next tile's products gains little (a pipelined
// variant, at 255 registers with spills, was no faster); holding q's big
// half in registers for two of the three q.k^T products would, but
// needs ~60 registers that the accumulators above do not leave.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "tc_common.cuh"

namespace {

constexpr int kTq = 64;                   // query rows a block: one m64
constexpr int kConsumers = 128;           // the consumer warpgroup
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kMaxHd = 256;
constexpr float kNeg = -1e30f;            // the reference's NEG

// Key tile, ring depth and p.v column chunk for each head dim the tiles
// are built for.
template <int HDP> struct Tile;
template <> struct Tile<64> {
  static constexpr int kTk = 32, kStages = 3, kHn = 64;
};
template <> struct Tile<120> {
  static constexpr int kTk = 32, kStages = 2, kHn = 120;
};
template <> struct Tile<128> {
  static constexpr int kTk = 32, kStages = 2, kHn = 128;
};
template <> struct Tile<256> {
  static constexpr int kTk = 8, kStages = 2, kHn = 64;
};

template <int HDP> struct Layout {
  static constexpr int kTk = Tile<HDP>::kTk;
  static constexpr int kStages = Tile<HDP>::kStages;
  static constexpr int kHn = Tile<HDP>::kHn;   // p.v columns a product
  static constexpr int kOpFloats = kTk * HDP;       // one operand of a tile
  static constexpr int kStageFloats = 4 * kOpFloats;  // kb, ks, vtb, vts
  static constexpr int kQFloats = kTq * HDP;
  static constexpr int kSmemBytes =
      (2 * kQFloats + kStages * kStageFloats) * 4 + 2 * kStages * 8;
};

// The key (within its tile) that column kk of v^T holds: within each 8
// keys, column t holds key 2t and column t + 4 key 2t + 1, the order in
// which a score accumulator's registers serve as p.v's A fragment.
__host__ __device__ constexpr int key_of(int kk) {
  return (kk & ~7) | ((kk & 3) << 1) | ((kk >> 2) & 1);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ---------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed.  A wait that
// outlasts ~2^26 polls (seconds) traps: a launch fault, not a hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// `bytes` (a multiple of 16) from device memory to shared memory, both
// 16-byte aligned; completion counts on `bar`'s transaction bytes.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The consumer warpgroup's own barrier (barrier 0 is __syncthreads').
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// ------------------------------------------------------------- prepass

// One block per (key tile, b * Hkv + kv head): the tile's image, each
// thread four consecutive floats of it (one 16-byte store a value kind).
template <typename T, int HDP>
__global__ void __launch_bounds__(256)
swa_split_kv(const T* __restrict__ k, const T* __restrict__ v,
             float4* __restrict__ img, int s, int hd, int n_kt) {
  using L = Layout<HDP>;
  constexpr int kTk = L::kTk;
  constexpr int kOp4 = L::kOpFloats / 4;
  const long long bkv = blockIdx.y;
  const int key0 = blockIdx.x * kTk;
  const T* kb = k + bkv * s * hd;
  const T* vb = v + bkv * s * hd;
  float4* out = img + (bkv * n_kt + blockIdx.x) * (L::kStageFloats / 4);
  for (int i = threadIdx.x; i < 2 * kOp4; i += blockDim.x) {
    const bool is_v = i >= kOp4;
    const int j = is_v ? i - kOp4 : i;     // float4 of the operand
    const int kcols = is_v ? kTk : HDP;
    const int f = 4 * j;
    const int rg = f / (kcols * 8), rem = f - rg * kcols * 8;
    const int row = rg * 8 + ((rem & 31) >> 2), col0 = (rem >> 5) * 4;
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // k: row = key, col = d; v^T: row = d, col = the permuted key
      const int key = key0 + (is_v ? key_of(col0 + e) : row);
      const int d = is_v ? row : col0 + e;
      const T* src = is_v ? vb : kb;
      x[e] = key < s && d < hd ? to_f(src[(long long)key * hd + d]) : 0.f;
    }
    uint32_t bg[4], sm[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split(x[e], bg[e], sm[e]);
    const int base = is_v ? 2 * kOp4 : 0;
    out[base + j] =
        make_float4(__uint_as_float(bg[0]), __uint_as_float(bg[1]),
                    __uint_as_float(bg[2]), __uint_as_float(bg[3]));
    out[base + kOp4 + j] =
        make_float4(__uint_as_float(sm[0]), __uint_as_float(sm[1]),
                    __uint_as_float(sm[2]), __uint_as_float(sm[3]));
  }
}

// ---------------------------------------------------------- main kernel

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
swa_attention_tc(const void* __restrict__ q, int q_bf16,
                 const float4* __restrict__ img, float* __restrict__ out,
                 int hq, int hkv, int s, int hd, int window, float scale,
                 float softcap, int n_qt, int n_kt) {
  using L = Layout<HDP>;
  constexpr int kTk = L::kTk;
  constexpr int kSt = L::kStages;
  constexpr int kOpBytes = L::kOpFloats * 4;
  constexpr int kSteps = HDP / 8;           // k-steps of q.k^T
  constexpr int kHn = L::kHn;
  extern __shared__ __align__(128) float smem[];
  float* q_big = smem;
  float* q_small = q_big + L::kQFloats;
  float* ring = q_small + L::kQFloats;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kSt * L::kStageFloats);
  uint64_t* empty = full + kSt;

  // block -> (b, kv head, query tile from the last, q head of the group)
  const int g = hq / hkv;
  int id = blockIdx.x;
  const int gi = id % g;
  id /= g;
  const int qt = n_qt - 1 - id % n_qt;
  id /= n_qt;
  const int kvh = id % hkv;
  const int b = id / hkv;
  const int h = kvh * g + gi;
  const int q0 = qt * kTq;
  const int k_lo = max(0, q0 - window + 1);
  const int k_hi = min(s, q0 + kTq);
  const int t_lo = k_lo / kTk, t_hi = (k_hi + kTk - 1) / kTk;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i < kSt; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // the producer: one lane keeps the ring full
    if (tid == kConsumers) {
      const char* src = reinterpret_cast<const char*>(
          img + ((long long)b * hkv + kvh) * n_kt * (L::kStageFloats / 4));
      for (int t = t_lo, it = 0; t < t_hi; ++t, ++it) {
        const int st = it % kSt;
        mbar_wait(&empty[st], ((it / kSt) & 1) ^ 1);
        mbar_expect_tx(&full[st], 4 * kOpBytes);
        const char* tile = src + (long long)t * 4 * kOpBytes;
        float* dst = ring + st * L::kStageFloats;
#pragma unroll
        for (int o = 0; o < 4; ++o)
          bulk_load(dst + o * L::kOpFloats, tile + o * kOpBytes, kOpBytes,
                    &full[st]);
      }
    }
    return;
  }

  // ---- the consumer warpgroup
  const int warp = tid >> 5, lane = tid & 31;
  const int t4 = lane & 3;
  const int i_a = q0 + warp * 16 + (lane >> 2);   // this thread's rows
  const int i_b = i_a + 8;

  // the q tile, split, in the operand layout (rows past S and columns
  // past hd zero): every load in flight first, then the splits and
  // stores (a loop that waited on each load took microseconds a block)
  {
    constexpr int kIters = L::kQFloats / 4 / kConsumers;   // HDP / 8
    static_assert(L::kQFloats % (4 * kConsumers) == 0, "whole float4 rounds");
    const long long qbase = ((long long)b * hq + h) * s * hd;
    float x[kIters][4];
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int f = 4 * (tid + it * kConsumers);
      const int rg = f / (HDP * 8), rem = f - rg * HDP * 8;
      const int qi = q0 + rg * 8 + ((rem & 31) >> 2), d0 = (rem >> 5) * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = d0 + e;
        x[it][e] = 0.f;
        if (qi < s && d < hd) {
          const long long at = qbase + (long long)qi * hd + d;
          x[it][e] = q_bf16 ? to_f(static_cast<const __nv_bfloat16*>(q)[at])
                            : static_cast<const float*>(q)[at];
        }
      }
    }
    float4* qb4 = reinterpret_cast<float4*>(q_big);
    float4* qs4 = reinterpret_cast<float4*>(q_small);
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      uint32_t bg[4], sm[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(x[it][e], bg[e], sm[e]);
      const int j = tid + it * kConsumers;
      qb4[j] = make_float4(__uint_as_float(bg[0]), __uint_as_float(bg[1]),
                           __uint_as_float(bg[2]), __uint_as_float(bg[3]));
      qs4[j] = make_float4(__uint_as_float(sm[0]), __uint_as_float(sm[1]),
                           __uint_as_float(sm[2]), __uint_as_float(sm[3]));
    }
  }
  fence_proxy_async();
  consumers_sync();
  const uint32_t qb_addr = smem_u32(q_big), qs_addr = smem_u32(q_small);

  float o[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
  float m_a = kNeg, m_b = kNeg, l_a = 0.f, l_b = 0.f;

  for (int t = t_lo, it = 0; t < t_hi; ++t, ++it) {
    const int st = it % kSt;
    float* stage = ring + st * L::kStageFloats;
    const int k0 = t * kTk;
    mbar_wait(&full[st], (it / kSt) & 1);
    if (k0 < k_lo) {
      // the band's first tile: the keys before the band get v = 0
      float* vt = stage + 2 * L::kOpFloats;
      const int n0 = k_lo - k0;
      for (int i = tid; i < HDP * kTk; i += kConsumers) {
        const int d = i / kTk, kk = i - d * kTk;
        if (key_of(kk) < n0) {
          vt[core_off(d, kk, kTk)] = 0.f;
          vt[L::kOpFloats + core_off(d, kk, kTk)] = 0.f;
        }
      }
      fence_proxy_async();
      consumers_sync();
    }
    const uint32_t kb = smem_u32(stage), ks = kb + kOpBytes;
    const uint32_t vb = ks + kOpBytes, vs = vb + kOpBytes;

    // scores: q.k^T as 3xTF32 in three accumulators, each of at most
    // HDP/16 big products: the two halves of big.big and the small
    // terms, summed in float32 (the tensor cores' float32 accumulation
    // drifts with every product added to a large sum)
    float sb0[kTk / 2], sb1[kTk / 2], sc[kTk / 2];
#pragma unroll
    for (int i = 0; i < kTk / 2; ++i) sb0[i] = sb1[i] = sc[i] = 0.f;
    fence_regs(sb0);
    fence_regs(sb1);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      if (j < kSteps / 2)
        wgmma_ss(sb0, desc(qb_addr + 256 * j, HDP), desc(kb + 256 * j, HDP));
      else
        wgmma_ss(sb1, desc(qb_addr + 256 * j, HDP), desc(kb + 256 * j, HDP));
    }
#pragma unroll
    for (int j = 0; j < kSteps; ++j)
      wgmma_ss(sc, desc(qs_addr + 256 * j, HDP), desc(kb + 256 * j, HDP));
#pragma unroll
    for (int j = 0; j < kSteps; ++j)
      wgmma_ss(sc, desc(qb_addr + 256 * j, HDP), desc(ks + 256 * j, HDP));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sb0);
    fence_regs(sb1);
    fence_regs(sc);
#pragma unroll
    for (int i = 0; i < kTk / 2; ++i) sc[i] = (sb0[i] + sc[i]) + sb1[i];

    // scale, softcap, mask; the online softmax of rows i_a and i_b
    float mx_a = kNeg, mx_b = kNeg;
#pragma unroll
    for (int c = 0; c < kTk / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + 8 * c + 2 * t4 + e;
        float xa = sc[4 * c + e] * scale, xb = sc[4 * c + 2 + e] * scale;
        if (softcap != 0.f) {
          xa = tanhf(xa / softcap) * softcap;
          xb = tanhf(xb / softcap) * softcap;
        }
        xa = (col <= i_a && i_a - col < window) ? xa : kNeg;
        xb = (col <= i_b && i_b - col < window) ? xb : kNeg;
        sc[4 * c + e] = xa;
        sc[4 * c + 2 + e] = xb;
        mx_a = fmaxf(mx_a, xa);
        mx_b = fmaxf(mx_b, xb);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float corr_a = expf(m_a - mn_a), corr_b = expf(m_b - mn_b);
    float sum_a = 0.f, sum_b = 0.f;
    uint32_t pb[kTk / 8][4], ps[kTk / 8][4];
#pragma unroll
    for (int c = 0; c < kTk / 8; ++c) {
      const float p0 = expf(sc[4 * c] - mn_a), p1 = expf(sc[4 * c + 1] - mn_a);
      const float p2 = expf(sc[4 * c + 2] - mn_b);
      const float p3 = expf(sc[4 * c + 3] - mn_b);
      sum_a += p0 + p1;
      sum_b += p2 + p3;
      // A fragment: (row a, key 2t), (row b, key 2t), (row a, key 2t + 1),
      // (row b, key 2t + 1) -- v^T's columns t and t + 4
      split(p0, pb[c][0], ps[c][0]);
      split(p2, pb[c][1], ps[c][1]);
      split(p1, pb[c][2], ps[c][2]);
      split(p3, pb[c][3], ps[c][3]);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, off);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, off);
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
    m_a = mn_a;
    m_b = mn_b;
    // o = o * corr + p.v, p.v as 3xTF32 in a fresh accumulator for each
    // chunk of kHn columns (the small terms first), added in float32
    fence_regs(pb);
    fence_regs(ps);
#pragma unroll
    for (int n = 0; n < HDP / kHn; ++n) {
      const uint32_t vcol = (uint32_t)(n * (kHn / 8) * kTk * 32);
      float ot[kHn / 2];
#pragma unroll
      for (int i = 0; i < kHn / 2; ++i) ot[i] = 0.f;
      fence_regs(ot);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kTk / 8; ++c)
        wgmma_rs(ot, ps[c], desc(vb + vcol + 256 * c, kTk));
#pragma unroll
      for (int c = 0; c < kTk / 8; ++c)
        wgmma_rs(ot, pb[c], desc(vs + vcol + 256 * c, kTk));
#pragma unroll
      for (int c = 0; c < kTk / 8; ++c)
        wgmma_rs(ot, pb[c], desc(vb + vcol + 256 * c, kTk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(ot);
#pragma unroll
      for (int i = 0; i < kHn / 2; ++i) {
        const int at = n * (kHn / 2) + i;
        o[at] = fmaf(o[at], (i & 2) ? corr_b : corr_a, ot[i]);
      }
    }
    fence_regs(pb);
    fence_regs(ps);
    mbar_arrive(&empty[st]);
  }

  // o / max(l, 1e-30) for the rows inside S and the columns inside hd
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  float* ob = out + ((long long)b * hq + h) * s * hd;
#pragma unroll
  for (int c = 0; c < HDP / 8; ++c) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * c + 2 * t4 + e;
      if (col < hd) {
        if (i_a < s) ob[(long long)i_a * hd + col] = o[4 * c + e] / den_a;
        if (i_b < s) ob[(long long)i_b * hd + col] = o[4 * c + 2 + e] / den_b;
      }
    }
  }
}

template <int HDP>
long long scratch_floats(int b, int hkv, int s) {
  using L = Layout<HDP>;
  return (long long)b * hkv * ((s + L::kTk - 1) / L::kTk) * L::kStageFloats;
}

template <typename T, int HDP>
int launch_split(const void* k, const void* v, float* img, int b, int hkv,
                 int s, int hd, cudaStream_t st) {
  const int n_kt = (s + Layout<HDP>::kTk - 1) / Layout<HDP>::kTk;
  swa_split_kv<T, HDP><<<dim3(n_kt, b * hkv), 256, 0, st>>>(
      static_cast<const T*>(k), static_cast<const T*>(v),
      reinterpret_cast<float4*>(img), s, hd, n_kt);
  return (int)cudaGetLastError();
}

template <int HDP>
int launch_main(const void* q, int bf16, const float* img, float* out, int b,
                int hq, int hkv, int s, int hd, int window, float scale,
                float softcap, cudaStream_t st) {
  using L = Layout<HDP>;
  static bool attr = false;        // the dynamic limit is set once
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        swa_attention_tc<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const int n_qt = (s + kTq - 1) / kTq;
  const int n_kt = (s + L::kTk - 1) / L::kTk;
  swa_attention_tc<HDP><<<b * hq * n_qt, kThreads, L::kSmemBytes, st>>>(
      q, bf16, reinterpret_cast<const float4*>(img), out, hq, hkv, s, hd,
      window, scale, softcap, n_qt, n_kt);
  return (int)cudaGetLastError();
}

// The head dim the tiles are built for: hd rounded up to 64, 120, 128 or
// 256 (zero-padded in the images and the q tile).
int padded_hd(int hd) {
  return hd <= 64 ? 64 : hd <= 120 ? 120 : hd <= 128 ? 128 : 256;
}

}  // namespace

#define SWA_HDP(hd, CALL)                  \
  switch (padded_hd(hd)) {                 \
    case 64: { constexpr int H = 64; CALL; } \
    case 120: { constexpr int H = 120; CALL; } \
    case 128: { constexpr int H = 128; CALL; } \
    default: { constexpr int H = 256; CALL; } \
  }

extern "C" {

// Largest head dim a launch takes.
int swa_attention_max_head_dim() { return kMaxHd; }

// Floats of the key images one call needs for (B, Hkv, S, hd).
long long swa_attention_scratch_floats(int b, int hkv, int s, int hd) {
  SWA_HDP(hd, return scratch_floats<H>(b, hkv, s));
}

// The prepass: k and v (B, Hkv, S, hd), both bf16 (bf16 != 0) or f32,
// contiguous, into `img` (swa_attention_scratch_floats floats, 16-byte
// aligned).  Launches on `stream` and returns cudaGetLastError().
int swa_attention_split_kv(const void* k, const void* v, float* img, int b,
                           int hkv, int s, int hd, int bf16, void* stream) {
  if (b == 0 || s == 0) return 0;
  if (b < 0 || hkv < 1 || s < 0 || hd < 1 || hd > kMaxHd ||
      (long long)b * hkv > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    SWA_HDP(hd, return (launch_split<__nv_bfloat16, H>(k, v, img, b, hkv, s,
                                                       hd, st)));
  }
  SWA_HDP(hd, return (launch_split<float, H>(k, v, img, b, hkv, s, hd, st)));
}

// q (B, Hq, S, hd), bf16 (bf16 != 0) or f32, contiguous; Hq a multiple
// of Hkv; `img` the prepass's images of k and v; out (B, Hq, S, hd) f32,
// contiguous.  Key j is visible to query i iff i - window < j <= i
// (window >= 1).  Launches on `stream` and returns cudaGetLastError() (0
// on success).
int swa_attention(const void* q, const float* img, float* out, int b, int hq,
                  int hkv, int s, int hd, int bf16, int window, float scale,
                  float softcap, void* stream) {
  if (b == 0 || s == 0) return 0;
  if (b < 0 || hq < 1 || hkv < 1 || hq % hkv || s < 0 || hd < 1 ||
      hd > kMaxHd || window < 1 ||
      (long long)b * hq * ((s + kTq - 1) / kTq) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  SWA_HDP(hd, return (launch_main<H>(q, bf16, img, out, b, hq, hkv, s, hd,
                                     window, scale, softcap, st)));
}

const char* swa_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
