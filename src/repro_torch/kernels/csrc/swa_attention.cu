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

// The float offset of element (r, c) of a K-major operand with kcols
// contraction columns (a multiple of 8): 8 x 4 core matrices of 128
// contiguous bytes, the kcols / 4 of an 8-row group side by side.  A
// k-step of 8 columns is two core matrices 128 bytes apart (the
// descriptor's leading byte offset); 8-row groups are kcols * 32 bytes
// apart (its stride byte offset).
__host__ __device__ constexpr int core_off(int r, int c, int kcols) {
  return (r >> 3) * (kcols * 8) + (c >> 2) * 32 + (r & 7) * 4 + (c & 3);
}

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

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small to 3xTF32 accuracy, both rounded to nearest (ties away)
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// Shared-memory writes of this thread become visible to wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// --------------------------------------------------------------- wgmma

// A shared-memory matrix descriptor: no swizzle, the leading byte offset
// (between the two core matrices of a k-step) 128 bytes, the stride byte
// offset (between 8-row groups) kcols * 32 bytes.
__device__ __forceinline__ uint64_t desc(uint32_t addr, int kcols) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((kcols * 32) >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Pin registers that an asynchronous wgmma reads or writes, so that the
// compiler neither reads nor reuses them across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// wgmma m64nNk8, f32 += tf32 * tf32: `wgmma_ss` with A and B in shared
// memory, `wgmma_rs` with A in registers (a0 (row g, col t), a1 (row
// g + 8, col t), a2 (row g, col t + 4), a3 (row g + 8, col t + 4) for lane
// 4g + t of each warp's 16 rows).  D, per warp's 16 rows: d[4c + e] is
// row g, column 8c + 2t + e and d[4c + 2 + e] row g + 8 (e = 0, 1).  The
// shapes the kernel uses: N = kTk (8, 32) for q.k^T from shared memory,
// N = kHn (64, 120, 128) for p.v with p in registers.  The scale of D is
// 1: every accumulator starts at zero in registers.
__device__ __forceinline__ void wgmma_ss(float (&d)[4], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[60],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %65, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n120k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59}, "
      "{%60, %61, %62, %63}, %64, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
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
