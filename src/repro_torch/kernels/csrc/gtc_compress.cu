// GTC error-feedback threshold compression, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gtc_compress/kernel.py
// (gtc_compress_flat, body _kernel) and the pad-to-tile of its wrapper
// (ops.py:14-22).  One elementwise pass over a flat float32 view:
//
//   acc          = residual + grad
//   send         = sign(acc) * tau  where |acc| > tau, else 0
//   new_residual = acc - send
//
// It matches the plain version bitwise: send is exactly +-tau or 0, it is
// 0 at |acc| == tau, and a NaN acc gives send 0 and a NaN residual (the
// comparison is false).  copysignf(tau, acc) equals sign(acc) * tau
// wherever |acc| > tau holds, because the wrapper only passes tau >= 0:
// acc is then non-zero (or infinite), and its sign is the product's.
//
// What bounds it on an H100: bytes.  Each value reads grad and residual
// and writes send and the new residual (16 bytes) for one compare and two
// adds.  The design is a grid-stride loop of float4 loads and stores
// where all four pointers are 16-byte aligned (the tail, and unaligned
// views, take the scalar loop), so any length runs without the padded
// copy the reference makes.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;   // 16 resident blocks per SM

__device__ __forceinline__ void compress(float g, float r, float tau,
                                         float& send, float& new_r) {
  const float acc = r + g;
  send = fabsf(acc) > tau ? copysignf(tau, acc) : 0.0f;
  new_r = acc - send;
}

__global__ void __launch_bounds__(kThreads)
gtc_compress_kernel(const float* __restrict__ g, const float* __restrict__ r,
                    float* __restrict__ send, float* __restrict__ new_r,
                    long long n, float tau, bool vec) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long n4 = n / 4;
    const float4* g4 = reinterpret_cast<const float4*>(g);
    const float4* r4 = reinterpret_cast<const float4*>(r);
    float4* s4 = reinterpret_cast<float4*>(send);
    float4* nr4 = reinterpret_cast<float4*>(new_r);
    for (long long i = first; i < n4; i += stride) {
      const float4 gv = g4[i];
      const float4 rv = r4[i];
      float4 sv, nv;
      compress(gv.x, rv.x, tau, sv.x, nv.x);
      compress(gv.y, rv.y, tau, sv.y, nv.y);
      compress(gv.z, rv.z, tau, sv.z, nv.z);
      compress(gv.w, rv.w, tau, sv.w, nv.w);
      s4[i] = sv;
      nr4[i] = nv;
    }
    done = n4 * 4;
  }
  for (long long i = done + first; i < n; i += stride) {
    compress(g[i], r[i], tau, send[i], new_r[i]);
  }
}

}  // namespace

extern "C" {

// g, r, send, new_r: n float32 values each, contiguous; tau >= 0.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int gtc_compress(const float* g, const float* r, float* send, float* new_r,
                 long long n, float tau, void* stream) {
  if (n == 0) return 0;
  if (n < 0 || !(tau >= 0.0f)) return (int)cudaErrorInvalidValue;
  const bool vec = ((reinterpret_cast<uintptr_t>(g) |
                     reinterpret_cast<uintptr_t>(r) |
                     reinterpret_cast<uintptr_t>(send) |
                     reinterpret_cast<uintptr_t>(new_r)) & 15) == 0;
  const long long work = vec ? (n + 3) / 4 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  gtc_compress_kernel<<<(unsigned)blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      g, r, send, new_r, n, tau, vec);
  return (int)cudaGetLastError();
}

const char* gtc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
