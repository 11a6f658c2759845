// Causal sliding-window attention over a whole sequence (prefill), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/swa_attention/kernel.py
// (swa_attention_tiles, body _kernel).  For q (B, Hq, S, hd) and k, v
// (B, Hkv, S, hd), query head h reads kv head h / (Hq / Hkv), and key j is
// visible to query i iff i - window < j <= i.  In float32: scores q.k
// scaled by `scale`, an optional tanh softcap, *then* the mask to -1e30,
// an online softmax, and o = (p . v) / max(l, 1e-30), written as float32.
// A window of at least S is plain causal attention.
//
// What is carried over and what is not:
//   * the band-limited key loop: the block of query rows [q0, q0 + Tq)
//     walks keys [max(0, q0 - window + 1), min(S, q0 + Tq)) and reads
//     nothing outside that band, so a call costs O(S * window), as the
//     TPU kernel's grid makes it;
//   * grouped-query attention by indexing: the TPU wrapper repeats k and
//     v G-fold in device memory; here each block reads its kv head;
//   * no padding: any S (the tail of the last query tile is masked and
//     never written) and any head dim up to 256 read in place with
//     scale = 1/sqrt(hd) (the TPU wrapper pads hd to 128 lanes and
//     rescales q to make up for it);
//   * the TPU kernel's matmuls run at Precision.HIGHEST: here every
//     product is a float32 FMA on the CUDA cores, no TF32.
//
// Design: one block of 256 threads per (b * Hq + h, tile of 64 query
// rows).  The q tile sits transposed in shared memory for the whole
// loop; each 64-key tile of k (transposed) and v is staged in shared
// memory.  A thread owns 4 query rows and, for the scores, 4 keys (a 4x4
// register tile of q.k: two 16-byte shared loads per 16 FMAs); the 16
// threads that share rows are 16 lanes of one warp, so the row max and
// sum of the online softmax are warp shuffles and every thread keeps its
// rows' running max, sum and rescale in registers.  The probabilities go
// through shared memory (transposed) to the p.v product, where the same
// thread owns its 4 rows x hd/16 output columns in registers.
//
// What bounds it on an H100: operations.  4 * hd flops per visible
// (query, key) pair (q.k and p.v), ~S * window pairs per head, against
// q, k, v read once and o written once: at h2o-danube-3-4b's prefill
// shape (B=2, Hq=32, Hkv=8, hd=120, S=8192, window 4096) that is 773
// GFLOP against 0.63 GB, 11.5 ms at the float32 CUDA-core peak and
// 0.19 ms at the memory rate.  This simple kernel runs on the CUDA cores
// only; the tensor cores (wgmma with 3xTF32 splitting to keep float32
// accuracy), a ring of TMA-fed tiles and two blocks per SM are later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTq = 64;               // query rows per block
constexpr int kTk = 64;               // keys per tile
constexpr int kLd = kTq + 4;          // row stride of the transposed tiles:
                                      // 16-byte aligned, fewer bank clashes
constexpr int kMaxHd = 256;
constexpr float kNeg = -1e30f;        // the reference's NEG

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int HDP>
constexpr int smem_bytes() {
  // q_t and k_t (HDP x kLd), v_s (kTk x HDP), p_t (kTk x kLd)
  return (2 * HDP * kLd + kTk * HDP + kTk * kLd) * (int)sizeof(float);
}

// HDP >= hd: the head dim the shared tiles and the output registers are
// sized for (64, 128 or 256); columns past hd are zero and never written.
template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads, 1)
swa_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, float* __restrict__ out,
                     int hq, int hkv, int s, int hd, int window,
                     float scale, float softcap) {
  extern __shared__ __align__(16) float smem[];
  float* q_t = smem;                  // q_t[d * kLd + r] = q[q0 + r][d]
  float* k_t = q_t + HDP * kLd;       // k_t[d * kLd + c] = k[k0 + c][d]
  float* v_s = k_t + HDP * kLd;       // v_s[c * HDP + d] = v[k0 + c][d]
  float* p_t = v_s + kTk * HDP;       // p_t[c * kLd + r] = p[r][c]
  constexpr int kC4 = HDP / 64;       // float4 output groups per thread

  const int q0 = blockIdx.x * kTq;
  const int bh = blockIdx.y;          // b * hq + h
  const int b = bh / hq;
  const int kvh = (bh - b * hq) / (hq / hkv);
  const long long q_base = (long long)bh * s * hd;
  const long long kv_base = ((long long)b * hkv + kvh) * s * hd;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rg = tid >> 4;            // rows rg*4 .. rg*4+3 of the tile
  const int cg = tid & 15;            // keys cg*4 .. cg*4+3 of a key tile;
                                      // output columns c4*64 + cg*4 + e

  // the q tile (rows past S zero) and the zero v columns past hd
  for (int r = warp; r < kTq; r += kWarps) {
    const bool in = q0 + r < s;
    const T* qr = q + q_base + (long long)(q0 + r) * hd;
    for (int d = lane; d < hd; d += 32) q_t[d * kLd + r] = in ? to_f(qr[d]) : 0.f;
  }
  for (int i = tid; i < kTk * (HDP - hd); i += kThreads) {
    const int c = i / (HDP - hd);
    v_s[c * HDP + hd + (i - c * (HDP - hd))] = 0.f;
  }

  float m[4], l[4], acc[4][4 * kC4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kC4; ++c) acc[i][c] = 0.f;
  }
  const int row0 = q0 + rg * 4;
  const int k_lo = max(0, q0 - window + 1);
  const int k_hi = min(s, q0 + kTq);

  for (int k0 = k_lo; k0 < k_hi; k0 += kTk) {
    __syncthreads();       // the previous tile is consumed; q_t is written
    // stage the key tile: keys past the band are zero, never read
    for (int c = warp; c < kTk; c += kWarps) {
      const bool in = k0 + c < k_hi;
      const long long row = kv_base + (long long)(k0 + c) * hd;
      for (int d = lane; d < hd; d += 32) {
        k_t[d * kLd + c] = in ? to_f(k[row + d]) : 0.f;
        v_s[c * HDP + d] = in ? to_f(v[row + d]) : 0.f;
      }
    }
    __syncthreads();

    // scores: a 4x4 register tile of q.k over the head dim
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(q_t + d * kLd + rg * 4);
      const float4 c = *reinterpret_cast<const float4*>(k_t + d * kLd + cg * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(av[i], cv[j], sc[i][j]);
    }

    // scale, softcap, mask; then the online softmax, row by row
    const int col0 = k0 + cg * 4;
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = sc[i][j] * scale;
        if (softcap != 0.f) x = tanhf(x / softcap) * softcap;
        const int c = col0 + j;
        sc[i][j] = (c <= r && r - c < window) ? x : kNeg;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = expf(sc[i][j] - m_new);
        sum += p[i][j];
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kC4; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(p_t + (cg * 4 + j) * kLd + rg * 4) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();

    // o += p . v: 4 rows x 4*kC4 columns per thread
#pragma unroll 4
    for (int j = 0; j < kTk; ++j) {
      const float4 a = *reinterpret_cast<const float4*>(p_t + j * kLd + rg * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int c4 = 0; c4 < kC4; ++c4) {
        const float4 w = *reinterpret_cast<const float4*>(
            v_s + j * HDP + c4 * 64 + cg * 4);
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][c4 * 4 + e] = fmaf(av[i], wv[e], acc[i][c4 * 4 + e]);
      }
    }
  }

  // o = acc / max(l, 1e-30) for the rows inside S and the columns inside hd
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + i;
    if (r >= s) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = out + q_base + (long long)r * hd;
#pragma unroll
    for (int c4 = 0; c4 < kC4; ++c4)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c4 * 64 + cg * 4 + e;
        if (col < hd) orow[col] = acc[i][c4 * 4 + e] / den;
      }
  }
}

template <typename T, int HDP>
int launch(const void* q, const void* k, const void* v, float* out, int b,
           int hq, int hkv, int s, int hd, int window, float scale,
           float softcap, cudaStream_t stream) {
  auto kern = swa_attention_kernel<T, HDP>;
  constexpr int bytes = smem_bytes<HDP>();    // above the 48 KB static cap
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((s + kTq - 1) / kTq, b * hq);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), out, hq, hkv, s, hd, window, scale, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, float* out, int b,
             int hq, int hkv, int s, int hd, int window, float scale,
             float softcap, cudaStream_t st) {
  if (hd <= 64)
    return launch<T, 64>(q, k, v, out, b, hq, hkv, s, hd, window, scale,
                         softcap, st);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, out, b, hq, hkv, s, hd, window, scale,
                          softcap, st);
  return launch<T, 256>(q, k, v, out, b, hq, hkv, s, hd, window, scale,
                        softcap, st);
}

}  // namespace

extern "C" {

// Largest head dim one block takes.
int swa_attention_max_head_dim() { return kMaxHd; }

// q (B, Hq, S, hd), k and v (B, Hkv, S, hd), all bf16 (bf16 != 0) or all
// f32, contiguous; Hq a multiple of Hkv; out (B, Hq, S, hd) f32,
// contiguous.  Key j is visible to query i iff i - window < j <= i
// (window >= 1).  Launches on `stream` and returns cudaGetLastError() (0
// on success).
int swa_attention(const void* q, const void* k, const void* v, float* out,
                  int b, int hq, int hkv, int s, int hd, int bf16,
                  int window, float scale, float softcap, void* stream) {
  if (b == 0 || s == 0) return 0;
  if (b < 0 || hq < 1 || hkv < 1 || hq % hkv || s < 0 || hd < 1 ||
      hd > kMaxHd || window < 1 || (long long)b * hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, out, b, hq, hkv, s, hd, window,
                                   scale, softcap, st);
  return dispatch<float>(q, k, v, out, b, hq, hkv, s, hd, window, scale,
                         softcap, st);
}

const char* swa_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
