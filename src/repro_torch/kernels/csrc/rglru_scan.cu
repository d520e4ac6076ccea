// Hand-written Hopper (sm_90a) kernel for the RG-LRU linear recurrence.
//
// Replaces the TPU kernel repro/kernels/rglru_scan.py::rglru_scan, which
// tiles channels into 128-lane blocks, keeps the carry in VMEM and walks
// sequence chunks along the sequential grid axis.  Per (batch b, channel r):
//
//   h_t = a_t * h_{t-1} + x_t,   h_{-1} = h0[b, r] (zeros if none)
//
// in f32, the product and the sum rounded separately (no fused multiply-
// add; the port builds every source with -fmad=false and the kernel says
// so with __fmul_rn / __fadd_rn), so the result equals the plain version
// bit for bit.  Every h_t is written in a's type.
//
// Layout: a, x and the output are [B, S, R] contiguous, of one type (f32
// or bf16); h0 is [B, R] f32 contiguous, or null.  Any S >= 1 and any R:
// ragged shapes need no padding (the TPU kernel asserts that S and R
// divide its blocks).
//
// What bounds it on this card: each element of a and x is read once and
// each h_t written once, and the recurrence does two operations per
// element.  At the serving shape (B=8, S=256, R=2560, f32) that is
// 3 x 21.0 MB = 62.9 MB, 0.0188 ms at 3.35 TB/s; the operations take far
// less.  The chain over S is serial per lane, so the card is fed only by
// the B * R lanes (20,480 threads, 160 blocks of 128 on 132 SMs) and by
// loads kept in flight ahead of the chain.
//
// What the design does: one thread per (batch, channel) lane, h in a
// register; neighbouring threads take neighbouring channels, so each
// step's loads and stores are coalesced across the warp.  The time loop
// loads kUnroll steps of a and x into registers before it runs their
// updates, so kUnroll loads per operand are in flight at once.  A chunked
// two-pass scan (more lanes busy at small B * R) and 16-byte loads are
// the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;       // time steps whose loads are in flight

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ x,
                      const float* __restrict__ h0, T* __restrict__ out,
                      int B, int S, int R) {
  const long long lane =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= static_cast<long long>(B) * R) return;
  const long long b = lane / R, r = lane % R;
  const long long base = b * S * R + r;
  const T* ap = a + base;
  const T* xp = x + base;
  T* op = out + base;
  float h = h0 != nullptr ? h0[lane] : 0.0f;

  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long off = static_cast<long long>(t + u) * R;
      av[u] = to_f32(ap[off]);
      xv[u] = to_f32(xp[off]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), xv[u]);
      op[static_cast<long long>(t + u) * R] = from_f32<T>(h);
    }
  }
  for (; t < S; ++t) {
    const long long off = static_cast<long long>(t) * R;
    h = __fadd_rn(__fmul_rn(to_f32(ap[off]), h), to_f32(xp[off]));
    op[off] = from_f32<T>(h);
  }
}

template <typename T>
int launch(const void* a, const void* x, const float* h0, void* out, int B,
           int S, int R, void* stream) {
  const long long lanes = static_cast<long long>(B) * R;
  const unsigned blocks =
      static_cast<unsigned>((lanes + kThreads - 1) / kThreads);
  rglru_scan_kernel<T><<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(x), h0,
      static_cast<T*>(out), B, S, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out[b, t, r] = h_t of the recurrence h_t = a_t * h_{t-1} + x_t per
// (b, r), on `stream`.  a, x, out: [B, S, R] contiguous, f32 (bf16 = 0) or
// bf16 (bf16 = 1), all of one type; h0: [B, R] f32 contiguous, or null for
// zeros.  B, S, R >= 1.  Returns the cudaError_t of the launch
// (0 = success).
int rglru_scan_launch(const void* a, const void* x, const void* h0,
                      void* out, int B, int S, int R, int bf16, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* h = static_cast<const float*>(h0);
  if (bf16) return launch<__nv_bfloat16>(a, x, h, out, B, S, R, stream);
  return launch<float>(a, x, h, out, B, S, R, stream);
}

const char* rglru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
