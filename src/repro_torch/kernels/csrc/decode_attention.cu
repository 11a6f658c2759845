// Single-token decode attention over a per-row KV cache, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention/
// kernel.py (decode_attention_tiles, body _kernel): for every batch row b
// and kv head h, with G grouped query rows,
//   1. rotate q (G rows) and the new k by RoPE at the row's position, in
//      float32, from cos/sin tables computed by the wrapper;
//   2. write the new k and v into ring slot pos % S of the caller's cache,
//      in place (the TPU kernel's input_output_aliases), rounded to the
//      cache type;
//   3. score q against every slot of the written cache (so slot pos % S
//      scores the new k as rounded to the cache type, while q stays
//      float32), scale, optional tanh softcap, mask (linear j <= pos or
//      the SWA-ring arithmetic), softmax, and the product with V, all in
//      float32.
// Every variant the TPU kernel has is here: window 0 or W, softcap on or
// off, rope on or off, write on or off.  Any even head dim up to 256 is
// read in place (the TPU's pad to 128 lanes is a layout artifact).
//
// Design: one block per (b, h).  The rotated q rows sit in shared memory.
// The cache is walked in tiles of kTile slots with an online softmax: a
// warp per slot takes the G dot products (lanes split the head dim), one
// warp per query row rescales its running max and sum, and every thread
// owns one head-dim column of the output for all G rows, accumulating
// p * v over its share of the tile's slots; the shares are summed once at
// the end.  Nothing of size S is kept, so any cache length works.
//
// Rounding: the rotation uses __fmul_rn/__fadd_rn/__fsub_rn so that the
// compiler cannot contract it into FMAs: the written k then equals,
// bitwise, the plain PyTorch version's x1*cos - x2*sin rounded to bf16.
// No fast-math intrinsics: expf and tanhf are the accurate ones.
//
// What bounds it on an H100: bytes.  Each (b, h) reads its K and V rows
// once (2 * S * hd * 2 bytes in bf16) and writes one slot of each; the
// operations are 4 * G * S * hd flops, ~4 per byte read.  At the serving
// shape (16 rows x 2 kv heads) there are only 32 blocks, so one launch
// uses a quarter of the SMs: splitting S across blocks (flash-decoding)
// is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;             // cache slots per tile
constexpr int kMaxHd = 256;
constexpr float kNegInf = -1e30f;     // the reference's NEG_INF

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Element d of x (hd values) rotated by paired halves: the first half is
// x1*cos - x2*sin, the second x2*cos + x1*sin, each product rounded.
__device__ __forceinline__ float rotate(const float* x, int d, int hd2,
                                        const float* c, const float* s) {
  if (d < hd2) {
    return __fsub_rn(__fmul_rn(x[d], c[d]), __fmul_rn(x[d + hd2], s[d]));
  }
  const int e = d - hd2;
  return __fadd_rn(__fmul_rn(x[d], c[e]), __fmul_rn(x[e], s[e]));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// GM >= G: the number of query rows the block's registers and shared
// arrays are sized for (rows past G are zero and never written out).
template <typename T, int GM>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const float* __restrict__ q,
                        const float* __restrict__ k_new,
                        const float* __restrict__ v_new,
                        T* cache_k, T* cache_v,      // written, then read
                        const int* __restrict__ pos,
                        const float* __restrict__ cos_t,
                        const float* __restrict__ sin_t,
                        float* __restrict__ out,
                        int hkv, int g, int s, int hd, int window,
                        float scale, float softcap, int rope, int write) {
  __shared__ float q_s[GM * kMaxHd];
  __shared__ float p_s[GM * kTile];
  __shared__ float red_s[GM * kMaxHd];   // the column shares, summed last
  __shared__ float m_s[GM], l_s[GM], corr_s[GM];

  const int bh = blockIdx.x;             // b * hkv + h
  const int b = bh / hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p = pos[b];
  const int hd2 = hd / 2;
  const float* cb = rope ? cos_t + (long long)b * hd2 : nullptr;
  const float* sb = rope ? sin_t + (long long)b * hd2 : nullptr;
  T* ck = cache_k + (long long)bh * s * hd;
  T* cv = cache_v + (long long)bh * s * hd;

  // 1. the query rows, rotated; rows past g are zero
  const float* qb = q + (long long)bh * g * hd;
  for (int i = tid; i < GM * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    float v = 0.f;
    if (r < g) v = rope ? rotate(qb + r * hd, d, hd2, cb, sb) : qb[r * hd + d];
    q_s[r * kMaxHd + d] = v;
  }
  if (tid < GM) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  // 2. the ring write of the new token
  if (write) {
    const int slot = p % s;
    const float* kn = k_new + (long long)bh * hd;
    const float* vn = v_new + (long long)bh * hd;
    for (int d = tid; d < hd; d += kThreads) {
      const float kv = rope ? rotate(kn, d, hd2, cb, sb) : kn[d];
      ck[(long long)slot * hd + d] = from_f<T>(kv);
      cv[(long long)slot * hd + d] = from_f<T>(vn[d]);
    }
  }
  __syncthreads();       // the written slot is visible to the whole block

  // the output column this thread owns, and its share of each tile's slots
  const int nsplit = hd >= kThreads ? 1 : kThreads / hd;
  const int split = tid / hd;
  const int col = tid - split * hd;
  const bool owner = split < nsplit;
  float acc[GM];
#pragma unroll
  for (int r = 0; r < GM; ++r) acc[r] = 0.f;

  for (int t0 = 0; t0 < s; t0 += kTile) {
    const int n = min(kTile, s - t0);
    // 3a. scores: a warp per slot, lanes over the head dim
    for (int jj = warp; jj < n; jj += kWarps) {
      const int j = t0 + jj;
      const T* kr = ck + (long long)j * hd;
      float part[GM];
#pragma unroll
      for (int r = 0; r < GM; ++r) part[r] = 0.f;
      for (int d = lane; d < hd; d += 32) {
        const float kf = to_f(kr[d]);
#pragma unroll
        for (int r = 0; r < GM; ++r) part[r] += q_s[r * kMaxHd + d] * kf;
      }
      bool valid;
      if (window) {
        int kpos = p - (p - j) % s;      // C remainder, as lax.rem
        if (kpos > p) kpos -= s;
        valid = kpos >= 0 && p - kpos < window && kpos <= p;
      } else {
        valid = j <= p;
      }
#pragma unroll
      for (int r = 0; r < GM; ++r) {
        float sc = warp_sum(part[r]) * scale;
        if (softcap != 0.f) sc = tanhf(sc / softcap) * softcap;
        if (lane == 0) p_s[r * kTile + jj] = valid ? sc : kNegInf;
      }
    }
    __syncthreads();
    // 3b. online softmax: a warp per query row
    for (int r = warp; r < g; r += kWarps) {
      float mx = -INFINITY;
      for (int jj = lane; jj < n; jj += 32) mx = fmaxf(mx, p_s[r * kTile + jj]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int jj = lane; jj < n; jj += 32) {
        const float e = expf(p_s[r * kTile + jj] - m_new);
        p_s[r * kTile + jj] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);   // 0 on the first tile
        corr_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    // 3c. p @ V: each owner thread takes one column for all rows
    if (owner) {
#pragma unroll
      for (int r = 0; r < GM; ++r)
        if (r < g) acc[r] *= corr_s[r];
      for (int jj = split; jj < n; jj += nsplit) {
        const float vf = to_f(cv[(long long)(t0 + jj) * hd + col]);
#pragma unroll
        for (int r = 0; r < GM; ++r) acc[r] += p_s[r * kTile + jj] * vf;
      }
    }
    __syncthreads();     // p_s is overwritten by the next tile
  }

  // 4. sum the column shares, normalise, write o (B, Hkv, G, hd)
  for (int sp = 0; sp < nsplit; ++sp) {
    if (owner && split == sp) {
#pragma unroll
      for (int r = 0; r < GM; ++r)
        red_s[r * kMaxHd + col] = sp == 0 ? acc[r] : red_s[r * kMaxHd + col] + acc[r];
    }
    __syncthreads();
  }
  float* ob = out + (long long)bh * g * hd;
  for (int i = tid; i < g * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    ob[i] = red_s[r * kMaxHd + d] / l_s[r];
  }
}

template <typename T, int GM>
void launch(const float* q, const float* k_new, const float* v_new,
            void* cache_k, void* cache_v, const int* pos, const float* cos_t,
            const float* sin_t, float* out, int blocks, int hkv, int g,
            int s, int hd, int window, float scale, float softcap, int rope,
            int write, cudaStream_t stream) {
  decode_attention_kernel<T, GM><<<blocks, kThreads, 0, stream>>>(
      q, k_new, v_new, static_cast<T*>(cache_k), static_cast<T*>(cache_v),
      pos, cos_t, sin_t, out, hkv, g, s, hd, window, scale, softcap, rope,
      write);
}

template <typename T>
int dispatch(const float* q, const float* k_new, const float* v_new,
             void* cache_k, void* cache_v, const int* pos,
             const float* cos_t, const float* sin_t, float* out, int blocks,
             int hkv, int g, int s, int hd, int window, float scale,
             float softcap, int rope, int write, cudaStream_t st) {
#define DA_LAUNCH(GM)                                                       \
  launch<T, GM>(q, k_new, v_new, cache_k, cache_v, pos, cos_t, sin_t, out, \
                blocks, hkv, g, s, hd, window, scale, softcap, rope, write, \
                st)
  if (g <= 1) DA_LAUNCH(1);
  else if (g <= 2) DA_LAUNCH(2);
  else if (g <= 4) DA_LAUNCH(4);
  else if (g <= 8) DA_LAUNCH(8);
  else DA_LAUNCH(16);
#undef DA_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest grouped-query count and head dim one block takes.
int decode_attention_max_group() { return 16; }
int decode_attention_max_head_dim() { return kMaxHd; }

// q (B, Hkv, G, hd) f32; k_new, v_new (B, Hkv, hd) f32; cache_k, cache_v
// (B, Hkv, S, hd) bf16 (cache_bf16 != 0) or f32, written in place at slot
// pos % S when `write`; pos (B,) i32; cos_t, sin_t (B, hd/2) f32 when
// `rope` (else unused); out (B, Hkv, G, hd) f32.  All contiguous.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int decode_attention(const float* q, const float* k_new, const float* v_new,
                     void* cache_k, void* cache_v, const int* pos,
                     const float* cos_t, const float* sin_t, float* out,
                     int b, int hkv, int g, int s, int hd, int cache_bf16,
                     int window, float scale, float softcap, int rope,
                     int write, void* stream) {
  if (b == 0) return 0;
  if (b < 0 || hkv < 1 || g < 1 || g > 16 || s < 1 || hd < 2 || hd % 2 ||
      hd > kMaxHd || window < 0 || (long long)b * hkv > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = b * hkv;
  if (cache_bf16)
    return dispatch<__nv_bfloat16>(q, k_new, v_new, cache_k, cache_v, pos,
                                   cos_t, sin_t, out, blocks, hkv, g, s, hd,
                                   window, scale, softcap, rope, write, st);
  return dispatch<float>(q, k_new, v_new, cache_k, cache_v, pos, cos_t,
                         sin_t, out, blocks, hkv, g, s, hd, window, scale,
                         softcap, rope, write, st);
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
