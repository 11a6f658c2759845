// Fused logsumexp + top-k gather over vocab tiles, for Hopper (sm_90a), on
// the tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/sparse_ce/kernel.py:79
// (sparse_ce_tiles, body _kernel) and the padding of its wrapper
// (ops.py:26-45).  For h (T, D), w (D, V) and teacher ids idx (T, K), all
// row-major, it returns per row the logsumexp of the logits h @ w over
// the vocab, and the K logits at the ids, without writing the (T, V)
// logits to device memory.  An optional tanh softcap applies to every
// logit first, as in the reference.  The TPU kernel's product runs at
// Precision.HIGHEST; here it keeps float32 accuracy as 3xTF32 on wgmma:
// each operand x is split into big = cvt.rna.tf32(x) and small =
// cvt.rna.tf32(x - big), and small.big + big.small + big.big is summed in
// float32 (small.small is below float32's last bit).
//
// Two launches per call:
//   1. sparse_ce_tc (grid: vocab tiles of kBV = 128 x row tiles of kBT =
//      72; one 256-thread block an SM): two warpgroups, each computing the
//      transposed logits of its 64 vocab columns x the block's 72 rows,
//      w^T . h^T (M = vocab, N = rows, K = D), as wgmma m64n72k8 (route (a)
//      of the layout problem: no prepass).  The block streams D in 32-deep
//      chunks through a 6-stage ring of raw chunks copied with cp.async,
//      four chunks ahead of use: a 32 x 128 slice of w, each row the
//      16-byte-aligned cover of its 128 columns (w's rows, V floats long,
//      need not be aligned), and a 72 x 32 slice of h; ragged T, V and D
//      are zero-filled by the copies.  w is the *register* A operand: each
//      thread reads its fragment (2 vocab columns x 2 depths a k-step) from
//      the raw slice and splits it in registers.  h^T is the shared-memory
//      B operand, K-major as h lies (D contiguous in each row), shared by
//      both warpgroups: the block splits each raw h slice into big and
//      small images in the no-swizzle core-matrix layout (3 slots).
//      Per chunk and warpgroup, two wgmma groups: big.big into a fresh
//      accumulator, then the small terms.  wgmma_wait<1> waits for the
//      first alone, so while the small terms run the threads fold big.big
//      into the running sum, split the next chunk's images and A fragments
//      (two alternating sets), and the next chunk's products queue behind:
//      one block barrier a chunk.  Then softcap and the columns at or past
//      V masked to NEG; each row's (max, sum of exp) over a warp's 16
//      columns from the accumulator registers (shuffles), merged over the
//      8 warps into this vocab tile's partial (max m, sum l); the tile
//      staged in shared memory, and each (row, k) whose id lies in the
//      tile gathered; vocab tile 0 writes NEG for ids past every tile, as
//      the reference's gather leaves them.
//   2. sparse_ce_merge (a warp per row): the (m, l) merge of the row's
//      partials, m = max over tiles, l = sum of l_j exp(m_j - m) (lanes
//      over tiles, then a shuffle tree), and lse = m + log(max(l, 1e-30)),
//      as the reference's last grid step computes it.
// Accuracy: the tensor cores' float32 accumulation drifts with every
// product added to a large sum, so big.big goes to a fresh accumulator for
// each 32-deep chunk of D (4 k-steps), added to a running sum on the CUDA
// cores in float32; the small terms (small.big then big.small, in k-step
// order), ~2^-11 of the logits, have their own accumulator over all of D,
// added last.  The split rounds in integer arithmetic (split_int: the
// bits of cvt.rna for every finite input).  ref.sparse_ce_tiled_ref is
// this schedule on the host.
//
// Budget: shared memory 217 KB (the raw ring, 6 x (32 x 136 + 72 x 36)
// floats = 163 KB, rows padded so that fragment reads and split reads are
// (nearly) conflict-free; the images, 3 slots x big + small x 72 x 32
// floats = 54 KB; the 72 x 129 epilogue tile reuses them); registers a
// thread: the running sum and two accumulators (36 floats each at
// N = 72), two sets of A fragments (2 x 2 x 16): ~220.  So one block an
// SM, and the tile sizes are the budget's: N = 72 keeps 1,024 rows at 375
// blocks (2.84 rounds of 132) where N = 64 gave 400 (a fourth round of 4).
//
// What bounds it on an H100: operations.  2*T*D*V flops, x 3 as 3xTF32 at
// the dense TF32 rate (495 TFLOP/s): 0.0303 ms at T = 1,024, D = 768,
// V = 3,183, against 13 MB of h and w (0.004 ms).  What this design leaves
// on the table (measured by taking parts out, PERF.md): the loop is bound
// by the raw chunks' copies from L2 -- w is re-read once per row tile and
// h once per vocab tile, ~230 MB a call -- more than by its products or
// splits; a larger tile needs more accumulator registers than a thread
// has, and a thread block cluster sharing h or w over distributed shared
// memory or TMA multicast would cut the reads.  The earlier design
// (float32 FMAs on the CUDA cores, 64 x 128 tiles) took ~0.24 ms.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "tc_common.cuh"

namespace {

constexpr int kThreads = 256;     // two warpgroups
constexpr int kWarps = kThreads / 32;
constexpr int kBV = 128;          // vocab columns a block: 64 a warpgroup
constexpr int kBT = 72;           // rows a block: wgmma's N (1,024 rows
                                  // are 15 tiles: 375 blocks at V = 3,183,
                                  // under three rounds of 132)
constexpr int kBK = 32;           // depth a chunk: 4 k-steps
constexpr int kSteps = kBK / 8;
constexpr int kStages = 6;        // raw chunks in flight: 4 ahead of use
constexpr int kSlots = 3;         // image slots (big + small of a chunk)
constexpr int kImg = kBT * kBK;   // floats of one image (big or small)
constexpr int kWq = kBV / 4 + 1;  // float4 of a raw w row (aligned cover)
constexpr int kLdW = kBV + 8;     // raw w rows: fragment reads ~conflict-free
constexpr int kLdH = kBK + 4;     // raw h rows: split reads conflict-free
constexpr int kRawW = kBK * kLdW;
constexpr int kRaw = kRawW + kBT * kLdH;   // floats of one raw stage
constexpr int kLd = kBV + 1;      // the epilogue tile's row stride
constexpr int kSmemFloats = kSlots * 2 * kImg + kStages * kRaw;
constexpr int kSmemBytes = kSmemFloats * 4;
constexpr float kNeg = -1e30f;    // the reference's NEG
constexpr int kRowsPerWarp = kBT / kWarps;   // in the epilogue
constexpr int kWRow = kThreads / kBK;   // threads copying a raw w row
constexpr int kH4 = kBT * kBK / 4;      // float4 of a raw h chunk

static_assert(kBK * kWRow == kThreads, "w: kWRow threads a row");
static_assert(kBT % 8 == 0 && kBT % kWarps == 0, "row tiles");
static_assert(kLdW >= 4 * kWq && kLdW % 4 == 0, "raw w rows");
static_assert(kBT * kLd + 2 * kWarps * kBT <= kSmemFloats, "epilogue tile");

// w[gd][v0] and where it sits in its row's raw copy (floats past the
// 16-byte boundary below it).
__device__ __forceinline__ const float* w_at(const float* w, int gd, int V,
                                             int v0) {
  return w + (long long)gd * V + v0;
}
__device__ __forceinline__ int w_shift(const float* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) & 15) >> 2);
}

// BYTES (4 or 16, aligned) from device to shared memory asynchronously;
// `n` < BYTES bytes read, the rest zero-filled (n = 0: src is not read).
template <int BYTES>
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           int n) {
  const uint32_t d = smem_u32(dst);
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Wait until at most N of this thread's newest copy groups are pending.
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The raw chunk at depth k0 into a stage.  w: rows k0 .. k0 + 31, each
// the 16-byte-aligned run of kWq float4 that covers vocab columns v0 ..
// v0 + 127 (w's rows, V floats long, need not be aligned), so row d's
// column v0 + m sits at d * kLdW + w_shift(w_at(w, k0 + d, V, v0)) + m;
// rows past D zero, reads past the end of w zero-filled, columns past V
// hold whatever follows (the epilogue masks their logits).  h: rows row0
// .. row0 + 71 of those depths, rows past T and depths past D zero.
template <bool VEC>
__device__ __forceinline__ void copy_chunk(float* raw, const float* h,
                                           const float* w, int T, int D,
                                           int V, int row0, int v0, int k0) {
  const int tid = threadIdx.x;
  {  // w: kWRow threads a row, float4 q = tid % kWRow + kWRow u of the
     // row's cover
    const int d = tid / kWRow, gd = k0 + d, q0 = tid % kWRow;
    const uintptr_t end = reinterpret_cast<uintptr_t>(w + (long long)D * V);
    uintptr_t a =
        (reinterpret_cast<uintptr_t>(w_at(w, gd, V, v0)) & ~uintptr_t(15)) +
        16 * q0;
    // bytes of w from a on (0 past the last row), capped: 32-bit from here
    const int left =
        gd < D && a < end ? (int)min(end - a, uintptr_t(1) << 20) : 0;
    if (left == 0) a = reinterpret_cast<uintptr_t>(w);
    float* dst = raw + d * kLdW + 4 * q0;
#pragma unroll
    for (int u = 0; u < (kWq + kWRow - 1) / kWRow; ++u) {
      if (q0 + kWRow * u < kWq) {
        const int n = min(max(left - 16 * kWRow * u, 0), 16);
        copy_async<16>(
            dst + 4 * kWRow * u,
            reinterpret_cast<const float*>(n ? a + 16 * kWRow * u : a), n);
      }
    }
  }
  // h: eight threads a row (128 contiguous bytes a copy)
  float* rh = raw + kRawW;
  if (VEC) {
#pragma unroll
    for (int u = 0; u < (kH4 + kThreads - 1) / kThreads; ++u) {
      const int f = tid + kThreads * u, n = f >> 3, c = 4 * (f & 7);
      const bool in = f < kH4 && row0 + n < T && k0 + c < D;
      if (f < kH4)
        copy_async<16>(rh + n * kLdH + c,
                       in ? h + (long long)(row0 + n) * D + k0 + c : h,
                       in ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int u = 0; u < (4 * kH4 + kThreads - 1) / kThreads; ++u) {
      const int f = tid + kThreads * u, n = f >> 5, c = f & 31;
      const bool in = f < 4 * kH4 && row0 + n < T && k0 + c < D;
      if (f < 4 * kH4)
        copy_async<4>(rh + n * kLdH + c,
                      in ? h + (long long)(row0 + n) * D + k0 + c : h,
                      in ? 4 : 0);
    }
  }
}

// A raw h chunk split into big and small images, K-major in core
// matrices: float4 f = tid + 256u is depths 4q .. 4q + 3 of row n, with
// n = f % kBT and q = f / kBT, so eight consecutive threads read 8 rows
// and write one 128-byte run.
__device__ __forceinline__ void split_h(const float* raw, float* big) {
  const float* rh = raw + kRawW;
#pragma unroll
  for (int u = 0; u < (kH4 + kThreads - 1) / kThreads; ++u) {
    const int f = threadIdx.x + kThreads * u;
    if (f >= kH4) break;
    const int n = f % kBT, q = f / kBT;
    const float4 x = *reinterpret_cast<const float4*>(rh + n * kLdH + 4 * q);
    const float v[4] = {x.x, x.y, x.z, x.w};
    uint32_t b[4], s[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_int(v[e], b[e], s[e]);
    float* out = big + core_off(n, 4 * q, kBK);
    *reinterpret_cast<float4*>(out) =
        make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]),
                    __uint_as_float(b[2]), __uint_as_float(b[3]));
    *reinterpret_cast<float4*>(out + kImg) =
        make_float4(__uint_as_float(s[0]), __uint_as_float(s[1]),
                    __uint_as_float(s[2]), __uint_as_float(s[3]));
  }
}

// This thread's A fragments of a raw chunk, split: k-step j holds (vocab
// m0, depth d), (m0 + 8, d), (m0, d + 4), (m0 + 8, d + 4), d = 8j + t;
// woff[j][i] is where (m0, d + 4i) sits in any raw chunk (a row's shift
// is the same in every chunk: 32 rows of w are 128 V bytes).
__device__ __forceinline__ void w_frags(const float* raw,
                                        const int (&woff)[kSteps][2],
                                        uint32_t (&ab)[kSteps][4],
                                        uint32_t (&as)[kSteps][4]) {
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const float* r0 = raw + woff[j][0];
    const float* r1 = raw + woff[j][1];
    split_int(r0[0], ab[j][0], as[j][0]);
    split_int(r0[8], ab[j][1], as[j][1]);
    split_int(r1[0], ab[j][2], as[j][2]);
    split_int(r1[8], ab[j][3], as[j][3]);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
sparse_ce_tc(const float* __restrict__ h, const float* __restrict__ w,
             const int* __restrict__ idx, float* __restrict__ part_m,
             float* __restrict__ part_l, float* __restrict__ z, int T, int D,
             int V, int K, int n_vt, float softcap) {
  extern __shared__ __align__(128) float smem[];
  float* img = smem;                          // kSlots x (big, small)
  float* raw = smem + kSlots * 2 * kImg;      // kStages raw chunks
  const int vt = blockIdx.x;
  const int v0 = vt * kBV, row0 = blockIdx.y * kBT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = 16 * warp + g;     // this thread's vocab columns m0, m0 + 8
  const int n_kc = (D + kBK - 1) / kBK;
  int woff[kSteps][2];
#pragma unroll
  for (int j = 0; j < kSteps; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int d = 8 * j + t + 4 * i;
      woff[j][i] = d * kLdW + w_shift(w_at(w, d, V, v0)) + m0;
    }

  auto stage = [&](int c) { return raw + ((unsigned)c % kStages) * kRaw; };
  auto slot = [&](int c) { return img + ((unsigned)c % kSlots) * 2 * kImg; };

  // chunks 0 .. kStages - 2 in flight; chunk 0's operands ready
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_kc) copy_chunk<VEC>(stage(c), h, w, T, D, V, row0, v0, c * kBK);
    copy_commit();
  }
  copy_wait<kStages - 2>();
  __syncthreads();
  split_h(stage(0), slot(0));
  fence_proxy_async();

  // Each chunk is two wgmma groups a warpgroup: big.big into the fresh
  // acc_b, then the small terms onto acc_s.  wgmma_wait<1> waits for the
  // first alone (and everything before it), so acc_b is folded into run
  // and the next chunk's operands are prepared while the small terms run
  // on, and the next chunk's products queue behind them: the tensor cores
  // stay busy across the barrier.  A thread's A fragments alternate
  // between two sets.  The images, which both warpgroups read, rotate
  // over three slots: while either warpgroup may still read chunk kc's
  // and chunk kc - 1's, chunk kc + 1's go to chunk kc - 2's slot, which
  // both waited for before this iteration's barrier.
  uint32_t ab0[kSteps][4], as0[kSteps][4], ab1[kSteps][4], as1[kSteps][4];
  w_frags(stage(0), woff, ab0, as0);
  constexpr int kAcc = kBT / 2;               // accumulator floats
  float run[kAcc], acc_s[kAcc], acc_b[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) run[i] = 0.f;
  auto iteration = [&](int kc, uint32_t (&ab)[kSteps][4],
                       uint32_t (&as)[kSteps][4], uint32_t (&nb)[kSteps][4],
                       uint32_t (&ns)[kSteps][4]) {
    // chunk kc + 1 has landed for every thread, chunk kc's images are
    // published, and the stage of chunk kc - 1 is free
    copy_wait<kStages - 3>();
    __syncthreads();
    const uint32_t hb = smem_u32(slot(kc)), hs = hb + kImg * 4;
    fence_regs(ab);
    fence_regs(as);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kSteps; ++j)
      wgmma_rs(acc_b, ab[j], desc(hb + 256 * j, kBK), j > 0);
    wgmma_commit();
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      wgmma_rs(acc_s, as[j], desc(hb + 256 * j, kBK), kc > 0 || j > 0);
      wgmma_rs(acc_s, ab[j], desc(hs + 256 * j, kBK));
    }
    wgmma_commit();
    // while the products run: chunk kc + kStages - 1's copies, then (once
    // chunk kc - 1's small terms are done, its A fragment set is free)
    // chunk kc + 1's images, into chunk kc - 2's slot, and A fragments
    const int ahead = kc + kStages - 1;
    if (ahead < n_kc)
      copy_chunk<VEC>(stage(ahead), h, w, T, D, V, row0, v0, ahead * kBK);
    copy_commit();
    wgmma_wait<1>();                    // only chunk kc's small terms run
    fence_regs(acc_b);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) run[i] += acc_b[i];
    if (kc + 1 < n_kc) {
      split_h(stage(kc + 1), slot(kc + 1));
      fence_proxy_async();
      w_frags(stage(kc + 1), woff, nb, ns);
    }
  };
  for (int kc = 0; kc < n_kc; kc += 2) {
    iteration(kc, ab0, as0, ab1, as1);
    if (kc + 1 < n_kc) iteration(kc + 1, ab1, as1, ab0, as0);
  }
  wgmma_wait<0>();
  fence_regs(acc_s);
#pragma unroll
  for (int i = 0; i < kAcc; ++i) run[i] += acc_s[i];
  copy_wait<0>();
  __syncthreads();

  // this warp's rows' first 32 ids in flight (gathered below)
  int id[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int gr = row0 + warp + kWarps * i;
    id[i] = gr < T && lane < K ? idx[(long long)gr * K + lane] : 0;
  }

  // softcap and mask; the tile (rows n, vocab columns m) for the gather,
  // and each row's (max, sum of exp) over this warp's 16 vocab columns:
  // a row's values sit in the 8 lanes of one t (3 shuffles)
  float* tile = smem;
  float* wm = smem + kBT * kLd;               // (warp, row) max
  float* wl = wm + kWarps * kBT;              // (warp, row) sum of exp
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int m = m0 + 8 * ((i >> 1) & 1);
    float x = run[i];
    if (softcap != 0.0f) x = tanhf(x / softcap) * softcap;
    run[i] = v0 + m < V ? x : kNeg;
    tile[(8 * (i >> 2) + 2 * t + (i & 1)) * kLd + m] = run[i];
  }
#pragma unroll
  for (int c = 0; c < kBT / 8; ++c) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float a = run[4 * c + e], b = run[4 * c + 2 + e];
      float mx = fmaxf(a, b);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float l = expf(a - mx) + expf(b - mx);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        l += __shfl_xor_sync(0xffffffffu, l, off);
      if (g == 0) {
        wm[warp * kBT + 8 * c + 2 * t + e] = mx;
        wl[warp * kBT + 8 * c + 2 * t + e] = l;
      }
    }
  }
  __syncthreads();

  // the tile's partial of row tid: the warps' (max, sum) merged
  if (tid < kBT && row0 + tid < T) {
    float mx = wm[tid];
#pragma unroll
    for (int q = 1; q < kWarps; ++q) mx = fmaxf(mx, wm[q * kBT + tid]);
    float l = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q)
      l += wl[q * kBT + tid] * expf(wm[q * kBT + tid] - mx);
    part_m[(long long)(row0 + tid) * n_vt + vt] = mx;
    part_l[(long long)(row0 + tid) * n_vt + vt] = l;
  }

  // a warp a row: the row's ids (lane kk of its K, the first 32 loaded
  // above) gathered where they fall in the tile; vocab tile 0 writes NEG
  // for ids past every tile (negative ids compare as large unsigned)
  const unsigned cover = (unsigned)n_vt * kBV;
  auto gather = [&](int r, int kk, int ident) {
    float* out = z + (long long)(row0 + r) * K + kk;
    const unsigned loc = (unsigned)(ident - v0);
    if (loc < (unsigned)kBV)
      *out = tile[r * kLd + loc];
    else if (vt == 0 && (unsigned)ident >= cover)
      *out = kNeg;
  };
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + kWarps * i;
    if (row0 + r < T && lane < K) gather(r, lane, id[i]);
  }
  for (int r = warp; K > 32 && r < kBT && row0 + r < T; r += kWarps)
    for (int kk = 32 + lane; kk < K; kk += 32)
      gather(r, kk, idx[(long long)(row0 + r) * K + kk]);
}

template <bool VEC>
int launch_tiles(dim3 grid, cudaStream_t s, const float* h, const float* w,
                 const int* idx, float* part_m, float* part_l, float* z,
                 int T, int D, int V, int K, int n_vt, float softcap) {
  static bool attr = false;        // the dynamic limit is set once
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        sparse_ce_tc<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  sparse_ce_tc<VEC><<<grid, kThreads, kSmemBytes, s>>>(
      h, w, idx, part_m, part_l, z, T, D, V, K, n_vt, softcap);
  return (int)cudaGetLastError();
}

constexpr int kMergeThreads = 256;   // 8 rows a block, a warp a row

__global__ void __launch_bounds__(kMergeThreads)
sparse_ce_merge_kernel(const float* __restrict__ part_m,
                       const float* __restrict__ part_l,
                       float* __restrict__ lse, int T, int n_vt) {
  const int r = blockIdx.x * (kMergeThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= T) return;                          // the whole warp
  const float* pm = part_m + (long long)r * n_vt;
  const float* pl = part_l + (long long)r * n_vt;
  float m = kNeg;
  for (int j = lane; j < n_vt; j += 32) m = fmaxf(m, pm[j]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float l = 0.0f;
  for (int j = lane; j < n_vt; j += 32) l += pl[j] * expf(pm[j] - m);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    l += __shfl_xor_sync(0xffffffffu, l, off);
  if (lane == 0) lse[r] = m + logf(fmaxf(l, 1e-30f));
}

}  // namespace

extern "C" {

// Vocab columns of one tile: partials are (T, ceil(V / this)).
int sparse_ce_tile_cols() { return kBV; }

// h (T, D), w (D, V) f32 and idx (T, K) i32, row-major and contiguous.
// Writes the per-tile partials part_m, part_l (T, n_vt) and z (T, K).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int sparse_ce_tiles(const float* h, const float* w, const int* idx,
                    float* part_m, float* part_l, float* z, int T, int D,
                    int V, int K, float softcap, void* stream) {
  if (T == 0) return 0;
  if (T < 0 || D < 1 || V < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const int n_vt = (V + kBV - 1) / kBV;
  const long long row_tiles = (T + kBT - 1) / kBT;
  if (row_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)n_vt, (unsigned)row_tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 4 == 0 && (reinterpret_cast<uintptr_t>(h) & 15) == 0)
    return launch_tiles<true>(grid, s, h, w, idx, part_m, part_l, z, T, D,
                              V, K, n_vt, softcap);
  return launch_tiles<false>(grid, s, h, w, idx, part_m, part_l, z, T, D, V,
                             K, n_vt, softcap);
}

// The second pass: lse (T,) from the partials of sparse_ce_tiles.
int sparse_ce_merge(const float* part_m, const float* part_l, float* lse,
                    int T, int n_vt, void* stream) {
  if (T == 0) return 0;
  if (T < 0 || n_vt < 1) return (int)cudaErrorInvalidValue;
  constexpr int rows = kMergeThreads / 32;
  sparse_ce_merge_kernel<<<(T + rows - 1) / rows, kMergeThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      part_m, part_l, lse, T, n_vt);
  return (int)cudaGetLastError();
}

const char* sparse_ce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
