// Single-token decode attention over a per-row KV cache, for Hopper
// (sm_90a): flash-decoding, split over the valid slots.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention/
// kernel.py (decode_attention_tiles, body _kernel): for every batch row b
// and kv head h, with G grouped query rows,
//   1. rotate q (G rows) and the new k by RoPE at the row's position, in
//      float32, from cos/sin tables computed by the caller (once per
//      decode step, not here: torch's cos and CUDA's cosf may differ in
//      the last bit, and the written k must equal the plain version's);
//   2. write the new k and v into ring slot pos % S of the caller's cache,
//      in place (the TPU kernel's input_output_aliases), rounded to the
//      cache type;
//   3. score q against the written cache (slot pos % S scores the new k
//      as rounded to the cache type, while q stays float32), scale,
//      optional tanh softcap, mask (linear j <= pos or the SWA-ring
//      arithmetic), softmax, and the product with V, all in float32.
// Every variant the TPU kernel has is here: window 0 or W, softcap on or
// off, rope on or off, write on or off.  Any even head dim up to 256 is
// read in place (the TPU's pad to 128 lanes is a layout artifact).
//
// Design.  Both masks keep one ring interval per row: the A slots ending
// at slot pos % S, oldest first, with A = min(pos + 1, S) for the linear
// mask and min(pos + 1, S, window) for the SWA ring (pos >= 0; at
// pos < 0 every slot is masked: all S slots, each score 0).  Only
// those slots are read; the masked ones would add exp(-1e30 - m) = 0
// exactly.  The grid is (nsplit, B * Hkv) in clusters of nsplit blocks,
// one cluster per (b, h): block `sp` takes the sp-th of nsplit equal
// chunks of the row's interval, so every block of a row does the same
// work and the grid fills the SMs (nsplit <= 8 comes from B * Hkv and S
// on the host, kernel.py:split_plan).  A chunk past the interval's end is
// empty: its block reads nothing and holds the empty partial (m = -inf,
// l = 0).  Only the block holding the newest slot writes the new token,
// and no other block reads that slot.
// A block is 128 threads; it walks its chunk in tiles of 64 slots:
//   - k and v rows of the tile go to shared memory by 16-byte cp.async
//     (k rows padded to an odd number of 16-byte units, so the 8 lanes
//     of a quarter-warp reading 16 bytes of 8 rows hit distinct banks);
//     while the first tile is in flight the block rotates q and, if it
//     holds slot pos % S, writes the new token to the cache and straight
//     into the tile (that row is not read back);
//   - warp w owns query rows w, w+4, ...; each lane takes slots lane and
//     lane+32 and computes full-length dot products from shared memory
//     (16-byte k reads, q broadcast), so a row's max and sum are warp
//     shuffles on registers: no barrier between scores and softmax;
//   - thread (slot group, column pair) accumulates p·v for its two
//     columns of every row over its share of the tile's slots; the
//     probabilities sit slot-major, so a slot's G of them are one or two
//     16-byte reads.
// Three barriers per tile (tile loaded; probabilities written; tile
// consumed).  At the end the slot groups are summed through shared
// memory into the block's partial (acc, m, l).  With nsplit == 1 the
// block divides by l and writes o.  Else, after a cluster barrier, block
// sp reads every block's m and l and its 1/nsplit of the acc columns
// through distributed shared memory (all of a value's nsplit reads in
// flight at once), scales each partial by
// exp(m_sp - M) (an empty one by exactly 0), sums, divides by the summed
// l and writes its share of o; a second cluster barrier keeps every
// partial alive until it has been read.  No scratch in device memory, no
// atomics, no second launch.
//
// Rounding: the rotation uses __fmul_rn/__fadd_rn/__fsub_rn so that the
// compiler cannot contract it into FMAs: the written k then equals,
// bitwise, the plain PyTorch version's x1*cos - x2*sin rounded to bf16.
// No fast-math intrinsics: expf and tanhf are the accurate ones.
//
// What bounds it on an H100: bytes in principle (2 * A * hd * 2 bytes of
// bf16 cache per (b, h), ~4 flops per byte), but at the serving shape
// (B=16, Hkv=2, S=512: 8 MB at most) the bytes take ~2.5 us, so one
// launch is bound by its latency chain: the first tile's load, three
// barriers, the dot products of 64 slots, the two cluster barriers and
// the distributed-shared-memory reads of the combine.  Prefetching the
// next tile (chunks of more than 64 slots, S > 512 at B * Hkv = 32) is
// later work.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;             // cache slots per tile
constexpr int kMaxHd = 256;
constexpr int kMaxSplit = 8;          // blocks per (b, h): a portable
                                      // cluster

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

// 8 consecutive cache elements from 16-byte-aligned shared memory.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// N consecutive floats of 16-byte-aligned shared memory (N*4-aligned
// when N < 4).
template <int N>
__device__ __forceinline__ void load_rows(const float* p, float (&f)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      f[i] = t.x; f[i + 1] = t.y; f[i + 2] = t.z; f[i + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    f[0] = t.x; f[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = p[i];
  }
}

// Columns 2c and 2c+1 of a cache row in shared memory.
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Columns d and d + hd/2 (x1, x2) rotated by paired halves: x1*cos -
// x2*sin and x2*cos + x1*sin, each product rounded.
__device__ __forceinline__ void rotate_pair(float& x1, float& x2, float c,
                                            float s) {
  const float o1 = __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s));
  x2 = __fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s));
  x1 = o1;
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

// Makes `device` current for the launch and restores the caller's.
struct DeviceGuard {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceGuard(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
    else prev = -1;
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

__host__ __device__ __forceinline__ int align16(int x) {
  return (x + 15) & ~15;
}

// Shared-memory layout of one block, in bytes (host and device agree).
struct Layout {
  int qs;        // q row stride, floats
  int kstride;   // k row stride, bytes: an odd number of 16-byte units
  int vstride;   // v row stride, bytes
  int groups;    // slot groups of the p·v step
  int p_off, kv_off, v_off, total;
  __host__ __device__ Layout(int gm, int hd, int sz) {
    qs = (hd + 3) & ~3;
    vstride = align16(hd * sz);
    kstride = (vstride / 16) % 2 ? vstride : vstride + 16;
    groups = kThreads / (hd / 2);
    p_off = align16(gm * qs * 4);
    kv_off = p_off + align16(gm * kTile * 4);
    v_off = kv_off + kTile * kstride;
    const int kv_bytes = kTile * (kstride + vstride);
    const int red_bytes = groups * gm * hd * 4;   // the slot groups' sums
    total = kv_off + (kv_bytes > red_bytes ? kv_bytes : red_bytes);
  }
};

// GM >= G: the query rows the registers are sized for (rows past G are
// never computed or written).  Grid (nsplit, B * Hkv) in clusters of
// (nsplit, 1): the blocks of one (b, h) are one cluster.
template <typename T, int GM>
__global__ void __launch_bounds__(kThreads)
decode_attention_split(const float* __restrict__ q,
                       const float* __restrict__ k_new,
                       const float* __restrict__ v_new,
                       T* cache_k, T* cache_v,      // written, then read
                       const int* __restrict__ pos,
                       const float* __restrict__ cos_t,
                       const float* __restrict__ sin_t,
                       float* __restrict__ out, int hkv, int g, int s,
                       int hd, int window, float scale, float softcap,
                       int rope, int write, int vec) {
  constexpr int kRpw = (GM + kWarps - 1) / kWarps;   // rows per warp
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float m_s[GM], l_s[GM], corr_s[GM];
  __shared__ float w_s[kMaxSplit * GM];

  cg::cluster_group cluster = cg::this_cluster();
  const Layout lay(GM, hd, (int)sizeof(T));
  float* q_s = reinterpret_cast<float*>(smem);     // then the partial o
  float* p_s = reinterpret_cast<float*>(smem + lay.p_off);
  unsigned char* k_s = smem + lay.kv_off;
  unsigned char* v_s = smem + lay.v_off;
  float* red_s = reinterpret_cast<float*>(smem + lay.kv_off);

  const int nsplit = (int)cluster.num_blocks();
  const int sp = (int)cluster.block_rank();
  const int bh = blockIdx.y;             // b * hkv + h
  const int b = bh / hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int hd2 = hd / 2;

  // q, the new token and the tables in flight before pos is known:
  // thread (row r0 + i * qstep, column pair qd, qd + hd2)
  const int qstep = kThreads / hd2;
  const int qd = tid % hd2, qr0 = tid / hd2;
  const bool qthread = qr0 < qstep;
  const float* qb = q + (size_t)bh * g * hd;
  float qx1[GM], qx2[GM];
#pragma unroll
  for (int i = 0; i < GM; ++i) {
    const int r = qr0 + i * qstep;
    const bool in = qthread && r < g;
    qx1[i] = in ? qb[r * hd + qd] : 0.f;
    qx2[i] = in ? qb[r * hd + qd + hd2] : 0.f;
  }
  float rc = 1.f, rs = 0.f, kx1 = 0.f, kx2 = 0.f, vx1 = 0.f, vx2 = 0.f;
  if (qthread && rope) {
    rc = cos_t[(size_t)b * hd2 + qd];
    rs = sin_t[(size_t)b * hd2 + qd];
  }
  if (write && tid < hd2) {
    kx1 = k_new[(size_t)bh * hd + tid];
    kx2 = k_new[(size_t)bh * hd + tid + hd2];
    vx1 = v_new[(size_t)bh * hd + tid];
    vx2 = v_new[(size_t)bh * hd + tid + hd2];
  }
  const int p = pos[b];

  // the row's valid ring interval: n_valid slots ending at slot e.  A
  // negative position writes nothing and masks every slot, so each of
  // the S slots weighs the same (the plain version's softmax over
  // scores that are all -1e30): the interval is then the whole ring and
  // every score reads as 0.
  const bool before = p < 0;
  int n_valid = before ? s : min(p + 1, s);
  if (window && !before) n_valid = min(n_valid, window);
  const int e = before ? s - 1 : p % s;
  const int first = e - n_valid + 1;     // the oldest slot, before wrap
  const int chunk = (n_valid + nsplit - 1) / nsplit;
  const int i0 = sp * chunk;
  const int i1 = min(i0 + chunk, n_valid);
  const bool writer = write && !before && i0 < i1 && i1 == n_valid;
  const size_t row0 = (size_t)bh * s * hd;
  T* ck = cache_k + row0;
  T* cv = cache_v + row0;

  if (i0 < i1) {
    float m_run[kRpw], l_run[kRpw];
#pragma unroll
    for (int i = 0; i < kRpw; ++i) {
      m_run[i] = -INFINITY;
      l_run[i] = 0.f;
    }
    const int pairs = hd / 2;
    const int grp = tid / pairs;
    const int pr = tid - grp * pairs;
    const bool pv_thread = grp < lay.groups;
    float acc[GM][2];
#pragma unroll
    for (int r = 0; r < GM; ++r) acc[r][0] = acc[r][1] = 0.f;
    const int hd8 = hd & ~7;
    const int row_bytes = hd * (int)sizeof(T);

    for (int t0 = i0; t0 < i1; t0 += kTile) {
      const int n = min(kTile, i1 - t0);
      // the first tile of the writer: slot e's row is filled in below,
      // from the values written, not read back
      const int own = writer && t0 == i0 && t0 + n == i1 ? n - 1 : -1;
      // 3a. the tile's k and v rows into shared memory
      if (vec) {
        const int cpr = row_bytes / 16;
        for (int c = tid; c < 2 * n * cpr; c += kThreads) {
          const int which = c >= n * cpr;          // 0: k, 1: v
          const int cc = c - which * n * cpr;
          const int jj = cc / cpr, w = cc - jj * cpr;
          if (jj == own) continue;
          int slot = first + t0 + jj;
          if (slot < 0) slot += s;
          const unsigned char* src = reinterpret_cast<const unsigned char*>(
              (which ? cv : ck) + (size_t)slot * hd) + w * 16;
          unsigned char* dst = which ? v_s + jj * lay.vstride + w * 16
                                     : k_s + jj * lay.kstride + w * 16;
          cp_async16(dst, src);
        }
      } else {
        for (int c = tid; c < 2 * n * hd; c += kThreads) {
          const int which = c >= n * hd;
          const int cc = c - which * n * hd;
          const int jj = cc / hd, d = cc - jj * hd;
          if (jj == own) continue;
          int slot = first + t0 + jj;
          if (slot < 0) slot += s;
          T* dst = reinterpret_cast<T*>(which ? v_s + jj * lay.vstride
                                              : k_s + jj * lay.kstride);
          dst[d] = (which ? cv : ck)[(size_t)slot * hd + d];
        }
      }
      if (t0 == i0) {
        // 1. the query rows, rotated, while the first tile is in flight
#pragma unroll
        for (int i = 0; i < GM; ++i) {
          const int r = qr0 + i * qstep;
          if (qthread && r < g) {
            float a = qx1[i], c = qx2[i];
            if (rope) rotate_pair(a, c, rc, rs);
            q_s[r * lay.qs + qd] = a;
            q_s[r * lay.qs + qd + hd2] = c;
          }
        }
        // 2. the ring write of the new token, by the block holding slot e
        if (writer && tid < hd2) {
          if (rope) rotate_pair(kx1, kx2, rc, rs);
          const T w[4] = {from_f<T>(kx1), from_f<T>(kx2), from_f<T>(vx1),
                          from_f<T>(vx2)};
          const int d = tid;
          ck[(size_t)e * hd + d] = w[0];
          ck[(size_t)e * hd + d + hd2] = w[1];
          cv[(size_t)e * hd + d] = w[2];
          cv[(size_t)e * hd + d + hd2] = w[3];
          if (own >= 0) {
            T* kr = reinterpret_cast<T*>(k_s + own * lay.kstride);
            T* vr = reinterpret_cast<T*>(v_s + own * lay.vstride);
            kr[d] = w[0];
            kr[d + hd2] = w[1];
            vr[d] = w[2];
            vr[d + hd2] = w[3];
          }
        }
      }
      if (vec) cp_async_wait_all();
      __syncthreads();   // the tile, q and the written slot are visible

      // 3b. scores and the online softmax: warp w owns rows w + 4 i,
      // lane l the tile's slots l and l + 32
      float part_s[kRpw][2];
#pragma unroll
      for (int i = 0; i < kRpw; ++i) part_s[i][0] = part_s[i][1] = 0.f;
      const T* k0 = reinterpret_cast<const T*>(k_s + lane * lay.kstride);
      const T* k1 = reinterpret_cast<const T*>(k_s + (lane + 32) * lay.kstride);
      if (warp < g) {
        for (int d = 0; d < hd8; d += 8) {
          float ka[8], kb[8];
          load8(k0 + d, ka);
          load8(k1 + d, kb);
#pragma unroll
          for (int i = 0; i < kRpw; ++i) {
            const int r = warp + i * kWarps;
            if (r < g) {
              const float4 qa = *reinterpret_cast<const float4*>(
                  q_s + r * lay.qs + d);
              const float4 qc = *reinterpret_cast<const float4*>(
                  q_s + r * lay.qs + d + 4);
              const float qv[8] = {qa.x, qa.y, qa.z, qa.w,
                                   qc.x, qc.y, qc.z, qc.w};
#pragma unroll
              for (int u = 0; u < 8; ++u) {
                part_s[i][0] += qv[u] * ka[u];
                part_s[i][1] += qv[u] * kb[u];
              }
            }
          }
        }
        for (int d = hd8; d < hd; ++d) {
          const float ka = to_f(k0[d]), kb = to_f(k1[d]);
#pragma unroll
          for (int i = 0; i < kRpw; ++i) {
            const int r = warp + i * kWarps;
            if (r < g) {
              part_s[i][0] += q_s[r * lay.qs + d] * ka;
              part_s[i][1] += q_s[r * lay.qs + d] * kb;
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRpw; ++i) {
        const int r = warp + i * kWarps;
        if (r < g) {                      // warp-uniform
          float sc[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            float v = part_s[i][u] * scale;
            if (softcap != 0.f) v = tanhf(v / softcap) * softcap;
            sc[u] = lane + 32 * u < n ? (before ? 0.f : v) : -INFINITY;
          }
          const float m_new = fmaxf(m_run[i], warp_max(fmaxf(sc[0], sc[1])));
          const float corr = expf(m_run[i] - m_new);  // 0 on the first tile
          const float e0 = expf(sc[0] - m_new), e1 = expf(sc[1] - m_new);
          l_run[i] = l_run[i] * corr + warp_sum(e0 + e1);
          m_run[i] = m_new;
          p_s[lane * GM + r] = e0;          // slot-major: a slot's rows
          p_s[(lane + 32) * GM + r] = e1;   // are one vector read below
          if (lane == 0) corr_s[r] = corr;
        }
      }
      __syncthreads();

      // 3c. p @ V: columns 2 pr, 2 pr + 1 of every row, slots grp + k G
      if (pv_thread) {
#pragma unroll
        for (int r = 0; r < GM; ++r) {
          if (r < g) {
            acc[r][0] *= corr_s[r];
            acc[r][1] *= corr_s[r];
          }
        }
        for (int jj = grp; jj < n; jj += lay.groups) {
          const float2 v2 = load2(reinterpret_cast<const T*>(
              v_s + jj * lay.vstride) + 2 * pr);
          float pj[GM];
          load_rows<GM>(p_s + jj * GM, pj);
#pragma unroll
          for (int r = 0; r < GM; ++r) {
            if (r < g) {
              acc[r][0] += pj[r] * v2.x;
              acc[r][1] += pj[r] * v2.y;
            }
          }
        }
      }
      __syncthreads();     // the tile's buffers are free again
    }

    // 4. sum the slot groups into the block's partial o (over q_s)
    if (pv_thread) {
#pragma unroll
      for (int r = 0; r < GM; ++r) {
        if (r < g) {
          red_s[(grp * g + r) * hd + 2 * pr] = acc[r][0];
          red_s[(grp * g + r) * hd + 2 * pr + 1] = acc[r][1];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRpw; ++i) {
      const int r = warp + i * kWarps;
      if (r < g && lane == 0) {
        m_s[r] = m_run[i];
        l_s[r] = l_run[i];
      }
    }
    __syncthreads();
    for (int i = tid; i < g * hd; i += kThreads) {
      float v = red_s[i];
      for (int gg = 1; gg < lay.groups; ++gg) v += red_s[gg * g * hd + i];
      if (nsplit == 1) {
        out[(size_t)bh * g * hd + i] = v / l_s[i / hd];
      } else {
        q_s[i] = v;
      }
    }
  } else if (tid < g) {                   // the empty partial
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  if (nsplit == 1) return;

  // 5. combine the cluster's partials through distributed shared memory:
  // block sp writes outputs [sp * per, (sp + 1) * per) of the g * hd
  cluster.sync();
  if (tid < g) {         // every partial's m and l in flight at once
    float mj[kMaxSplit], lj[kMaxSplit];
#pragma unroll
    for (int j = 0; j < kMaxSplit; ++j) {
      mj[j] = j < nsplit ? *cluster.map_shared_rank(m_s + tid, j) : -INFINITY;
      lj[j] = j < nsplit ? *cluster.map_shared_rank(l_s + tid, j) : 0.f;
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxSplit; ++j) mx = fmaxf(mx, mj[j]);
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxSplit; ++j) {
      // an empty partial weighs exactly 0 (no -inf - -inf)
      const float w = mj[j] == -INFINITY ? 0.f : expf(mj[j] - mx);
      w_s[j * GM + tid] = w;
      l += w == 0.f ? 0.f : w * lj[j];
    }
    corr_s[tid] = l;
  }
  __syncthreads();
  const int per = (g * hd + nsplit - 1) / nsplit;
  for (int i = sp * per + tid; i < min(g * hd, (sp + 1) * per);
       i += kThreads) {
    const int r = i / hd;
    float pj[kMaxSplit];
#pragma unroll
    for (int j = 0; j < kMaxSplit; ++j)
      pj[j] = j < nsplit && w_s[j * GM + r] != 0.f
                  ? *cluster.map_shared_rank(q_s + i, j) : 0.f;
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxSplit; ++j) v += w_s[j * GM + r] * pj[j];
    out[(size_t)bh * g * hd + i] = v / corr_s[r];
  }
  cluster.sync();        // no block leaves while its partial is read
}

template <typename T, int GM>
int launch(const float* q, const float* k_new, const float* v_new,
           void* cache_k, void* cache_v, const int* pos, const float* cos_t,
           const float* sin_t, float* out, int bh, int hkv, int g, int s,
           int hd, int window, int nsplit, float scale, float softcap,
           int rope, int write, int vec, cudaStream_t stream) {
  const Layout lay(GM, hd, (int)sizeof(T));
  static int attr_bytes = 48 * 1024;    // the default dynamic limit
  if (lay.total > attr_bytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attention_split<T, GM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
    if (err != cudaSuccess) return (int)err;
    attr_bytes = lay.total;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, bh);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = lay.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, decode_attention_split<T, GM>, q, k_new, v_new,
      static_cast<T*>(cache_k), static_cast<T*>(cache_v), pos, cos_t,
      sin_t, out, hkv, g, s, hd, window, scale, softcap, rope, write, vec);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <typename T>
int dispatch(const float* q, const float* k_new, const float* v_new,
             void* cache_k, void* cache_v, const int* pos,
             const float* cos_t, const float* sin_t, float* out, int bh,
             int hkv, int g, int s, int hd, int window, int nsplit,
             float scale, float softcap, int rope, int write, int vec,
             cudaStream_t st) {
#define DA_LAUNCH(GM)                                                     \
  return launch<T, GM>(q, k_new, v_new, cache_k, cache_v, pos, cos_t,     \
                       sin_t, out, bh, hkv, g, s, hd, window, nsplit,     \
                       scale, softcap, rope, write, vec, st)
  if (g <= 1) DA_LAUNCH(1);
  if (g <= 2) DA_LAUNCH(2);
  if (g <= 4) DA_LAUNCH(4);
  if (g <= 8) DA_LAUNCH(8);
  DA_LAUNCH(16);
#undef DA_LAUNCH
}

}  // namespace

extern "C" {

// Largest grouped-query count and head dim one launch takes.
int decode_attention_max_group() { return 16; }
int decode_attention_max_head_dim() { return kMaxHd; }

// q (B, Hkv, G, hd) f32; k_new, v_new (B, Hkv, hd) f32; cache_k, cache_v
// (B, Hkv, S, hd) bf16 (cache_bf16 != 0) or f32, written in place at slot
// pos % S when `write`; pos (B,) i32 (a row at pos < 0 writes nothing
// and returns the mean of its S value rows); cos_t, sin_t
// (B, hd/2) f32 when `rope` (else unused); out (B, Hkv, G, hd) f32.  All
// contiguous, on CUDA device `device`.  nsplit blocks (one cluster) per
// (b, h).  `vec` != 0: both caches are 16-byte aligned and hd * element
// size is a multiple of 16.  Launches on `stream` and returns the launch
// error (0 on success).
int decode_attention(const float* q, const float* k_new, const float* v_new,
                     void* cache_k, void* cache_v, const int* pos,
                     const float* cos_t, const float* sin_t, float* out,
                     int b, int hkv, int g, int s, int hd, int nsplit,
                     int cache_bf16, int window, float scale, float softcap,
                     int rope, int write, int vec, int device,
                     void* stream) {
  if (b == 0) return 0;
  if (b < 0 || hkv < 1 || g < 1 || g > 16 || s < 1 || hd < 2 || hd % 2 ||
      hd > kMaxHd || window < 0 || nsplit < 1 || nsplit > kMaxSplit ||
      (long long)b * hkv > 65535)
    return (int)cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bh = b * hkv;
  if (cache_bf16)
    return dispatch<__nv_bfloat16>(q, k_new, v_new, cache_k, cache_v, pos,
                                   cos_t, sin_t, out, bh, hkv, g, s, hd,
                                   window, nsplit, scale, softcap, rope,
                                   write, vec, st);
  return dispatch<float>(q, k_new, v_new, cache_k, cache_v, pos, cos_t,
                         sin_t, out, bh, hkv, g, s, hd, window, nsplit,
                         scale, softcap, rope, write, vec, st);
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
