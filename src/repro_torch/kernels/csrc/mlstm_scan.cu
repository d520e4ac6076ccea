// Hand-written Hopper (sm_90a) kernel for the mLSTM matrix-memory scan.
//
// Replaces the TPU kernel repro/kernels/mlstm_scan.py::mlstm_scan, which
// keeps each (batch, head)'s [dh, dh] memory C and its normalizer n
// resident in VMEM while it streams q / k / v / gate tiles along a
// sequential grid axis.  Per (batch, head) and step t, with the stabilized
// exponential gates of the xLSTM paper:
//
//   log f = -softplus(-f~),  m' = max(log f + m, i~)
//   i' = exp(i~ - m'),       f' = exp(log f + m - m')
//   C <- f' C + i' v k^T,    n <- f' n + i' k
//   h  = C q / max(|n . q|, 1)
//
// It takes an optional carry (C, n, m) and returns the final one.
//
// What bounds it on this card: per step a head does ~6 dh^2 f32
// operations on a state that it reads and writes whole, and the steps are
// a dependent chain.  Counted over the whole launch the work is small
// (at B=8, H=4, S=256, dh=192: ~1.8 GFLOP, ~30 MB), so the bound is tens
// of microseconds; what holds the kernel back is the serial step chain
// and the few heads (B*H blocks) available to fill 132 SMs.
//
// What the design does about it: one block per (batch, head), one thread
// per row i of C.  C lives in shared memory for the whole scan (dh = 192
// needs 148 KB, above the 48 KB default, so the launch raises the block's
// dynamic shared-memory limit).  Rows are padded to dh + 1 floats, so the
// threads of a warp, walking the same column j of different rows, hit 32
// different banks.  Thread i keeps n[i] in a register and accumulates
// (C q)[i] while it updates row i, so a step needs one block-wide
// reduction (n . q) and one __syncthreads.  k_t and q_t are staged in a
// double-buffered shared array; the next step's q, k, v are loaded into
// registers before the current step's row update, which hides their
// latency behind it.  Every thread computes the scalar gates itself.
// The state is read from and written to device memory once per launch.
//
// Numerics: f32 throughout, in the reference's operation order
// (f' * C + i' * (v * k)); built with -fmad=false like every source of
// the port, so nothing is contracted into an FMA.  q, k, v are f32 or
// bf16 (h is written in their type); gates and the carry are f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 32;

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

// jax.nn.softplus(x) == logaddexp(x, 0) == max(x, 0) + log1p(exp(-|x|)).
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

template <typename T>
__global__ void mlstm_scan_kernel(const T* __restrict__ q,
                                  const T* __restrict__ k,
                                  const T* __restrict__ v,
                                  const float* __restrict__ ig,
                                  const float* __restrict__ fg,
                                  const float* __restrict__ c0,
                                  const float* __restrict__ n0,
                                  const float* __restrict__ m0,
                                  T* __restrict__ h, float* __restrict__ cT,
                                  float* __restrict__ nT,
                                  float* __restrict__ mT, int s, int dh) {
  extern __shared__ float smem[];
  const int ld = dh + 1;                       // padded row stride
  float* C = smem;                             // [dh][ld]
  float* kq = C + dh * ld;                     // [2][2][dh]: k, q per buffer
  float* red = kq + 4 * dh;                    // [2][kMaxWarps]

  const int bh = blockIdx.x;
  const int i = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = i % kWarp, warp = i / kWarp, nwarp = nthr / kWarp;
  const bool row = i < dh;
  const size_t seq = static_cast<size_t>(bh) * s * dh;
  const size_t mat = static_cast<size_t>(bh) * dh * dh;

  // The carry, or zeros and m = -1e30.
  for (int e = i; e < dh * dh; e += nthr) {
    C[(e / dh) * ld + e % dh] = c0 ? c0[mat + e] : 0.0f;
  }
  float n_i = (row && n0) ? n0[static_cast<size_t>(bh) * dh + i] : 0.0f;
  float m = m0 ? m0[bh] : -1e30f;

  // Step 0's k, q into buffer 0; its v into a register.
  float v_next = 0.0f;
  if (row) {
    kq[i] = to_f32(k[seq + i]);
    kq[dh + i] = to_f32(q[seq + i]);
    v_next = to_f32(v[seq + i]);
  }
  __syncthreads();

  for (int t = 0; t < s; ++t) {
    const int buf = t & 1;
    const float* kb = kq + buf * 2 * dh;
    const float* qb = kb + dh;
    const float v_i = v_next;
    float k_next = 0.0f, q_next = 0.0f;
    if (row && t + 1 < s) {
      const size_t o = seq + static_cast<size_t>(t + 1) * dh + i;
      k_next = to_f32(k[o]);
      q_next = to_f32(q[o]);
      v_next = to_f32(v[o]);
    }
    const float i_t = ig[static_cast<size_t>(bh) * s + t];
    const float f_t = fg[static_cast<size_t>(bh) * s + t];
    const float log_f = -softplus(-f_t);
    const float m_new = fmaxf(log_f + m, i_t);
    const float i_p = expf(i_t - m_new);
    const float f_p = expf(log_f + m - m_new);
    m = m_new;

    float num = 0.0f, nq = 0.0f;
    if (row) {
      float* Ci = C + i * ld;
      for (int j = 0; j < dh; ++j) {
        const float c = f_p * Ci[j] + i_p * (v_i * kb[j]);
        Ci[j] = c;
        num = num + c * qb[j];
      }
      n_i = f_p * n_i + i_p * kb[i];
      nq = n_i * qb[i];
    }
    // n . q: warp sums, then the warps' partials in a fixed order.
    for (int off = kWarp / 2; off > 0; off /= 2) {
      nq += __shfl_down_sync(0xffffffffu, nq, off);
    }
    float* rb = red + buf * kMaxWarps;
    if (lane == 0) rb[warp] = nq;
    if (row && t + 1 < s) {
      float* nb = kq + (buf ^ 1) * 2 * dh;
      nb[i] = k_next;
      nb[dh + i] = q_next;
    }
    __syncthreads();
    if (row) {
      float den = 0.0f;
      for (int w = 0; w < nwarp; ++w) den += rb[w];
      h[seq + static_cast<size_t>(t) * dh + i] =
          from_f32<T>(num / fmaxf(fabsf(den), 1.0f));
    }
  }

  for (int e = i; e < dh * dh; e += nthr) {
    cT[mat + e] = C[(e / dh) * ld + e % dh];
  }
  if (row) nT[static_cast<size_t>(bh) * dh + i] = n_i;
  if (i == 0) mT[bh] = m;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* ig,
           const void* fg, const void* c0, const void* n0, const void* m0,
           void* h, void* cT, void* nT, void* mT, int n_heads, int s, int dh,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = (dh + kWarp - 1) / kWarp * kWarp;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(dh) * (dh + 1) + 4 * dh +
                       2 * kMaxWarps);
  err = cudaFuncSetAttribute(mlstm_scan_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_scan_kernel<T><<<n_heads, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(ig),
      static_cast<const float*>(fg), static_cast<const float*>(c0),
      static_cast<const float*>(n0), static_cast<const float*>(m0),
      static_cast<T*>(h), static_cast<float*>(cT), static_cast<float*>(nT),
      static_cast<float*>(mT), s, dh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Scan `n_heads` = B*H independent heads of `s` steps on `stream`.
// q, k, v, h: [n_heads, s, dh] in f32 (bf16 = 0) or bf16 (bf16 = 1);
// ig, fg: [n_heads, s] f32; c0/cT: [n_heads, dh, dh], n0/nT: [n_heads, dh],
// m0/mT: [n_heads] f32.  c0, n0, m0 are all null (no carry) or all set.
// Returns the cudaError_t of the launch (0 = success).
int mlstm_scan_launch(const void* q, const void* k, const void* v,
                      const void* ig, const void* fg, const void* c0,
                      const void* n0, const void* m0, void* h, void* cT,
                      void* nT, void* mT, int n_heads, int s, int dh,
                      int bf16, int device, void* stream) {
  if (bf16) {
    return launch<__nv_bfloat16>(q, k, v, ig, fg, c0, n0, m0, h, cT, nT, mT,
                                 n_heads, s, dh, device, stream);
  }
  return launch<float>(q, k, v, ig, fg, c0, n0, m0, h, cT, nT, mT, n_heads,
                       s, dh, device, stream);
}

const char* mlstm_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
