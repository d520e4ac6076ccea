// Hand-written Hopper (sm_90a) kernel for single-token decode attention.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::decode_attention,
// which streams the KV cache of one (batch, kv head) in blocks along a
// sequential grid axis, with the GQA group's g query heads as the rows of
// the tile and scalar-prefetched lengths to skip blocks past a sequence's
// end.  Per batch row b, kv head kh and query head h = kh * g + i:
//
//   s_ij = (q_h . k_j) * scale over the row's valid slots j
//   o_h  = sum_j softmax_j(s_ij) v_j,   f32 throughout, written in q's type
//
// Layout: q and o are [B, H, dh], the caches [B, K, T, dh], each given by
// its outer strides in elements (the head dim is contiguous), so the model
// passes its [B, T, K, dh] caches as transposed views and nothing is
// copied per step.  lengths: [B] int32 and starts: [B] int32 or null
// (zeros): row b's valid slots are the ring run (starts[b] + j) mod T for
// j < lengths[b], a prefix when the start is 0.  A local-attention block's
// cache is a ring of window + 1 slots, and once it wraps its valid slots
// are such a run that does not begin at slot 0.  f32 or bf16 q and caches.
//
// What bounds it on this card: one query reads each valid cache row once.
// At the serving shape (B=8, H=32, K=4, T=512, 257 valid rows, dh=128,
// bf16) that is 2.1 MB each of k and v plus q and o, 4.34 MB in all,
// 0.0013 ms at 3.35 TB/s; the operations, 2 x 2 x 32 x 257 x 128 per
// batch row on the tensor cores, take far less.  At
// this size one launch is about a launch's latency, and B*K = 32 blocks
// leave most of the 132 SMs idle; splitting T across blocks
// (flash-decoding, a second pass to merge) is the next step.
//
// What the design does: one block of 256 threads per (kv head, batch).
// The group's q rows are staged once in shared memory as f32; the block
// walks only the ceil(length / 64) kv tiles that hold valid rows (the TPU
// kernel's skip of invalid blocks, decode_attention.py:41-44), in ring
// order from the row's start (softmax does not depend on the order of the
// slots), staging each as f32 (k rows padded to dh + 1 floats so threads
// reading different rows at one column hit different banks).  Per tile:
// every (row, key) score by one thread; one warp per q row updates that
// row's running max and denominator and turns its scores into
// probabilities; then every thread accumulates its (row, column) outputs
// in registers, rescaled by the row's alpha.  Rows past the length (or
// past T) are zero-filled and never weigh.
//
// Numerics: f32 scores and accumulation (explicit fmaf; the port builds
// every source with -fmad=false); softmax in the TPU kernel's order:
// m' = max(m, max_j s), alpha = exp(m - m'), l' = alpha l + sum p,
// o = acc / max(l, 1e-30) (zeros for a length of 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;          // keys per kv tile
constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxOut = 16;      // outputs (g * dh / 256) per thread, at most
constexpr float kNegInf = -1e30f;

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

struct Strides {
  long long b, h, s;             // elements; the head dim is contiguous
};

size_t smem_bytes(int g, int dh) {
  return sizeof(float) * (static_cast<size_t>(g) * dh +
                          static_cast<size_t>(kBK) * (dh + 1) +
                          static_cast<size_t>(kBK) * dh +
                          static_cast<size_t>(g) * kBK + 3 * g);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                            const T* __restrict__ vc,
                            const int* __restrict__ lengths,
                            const int* __restrict__ starts, T* __restrict__ o,
                            int g, int T_len, Strides sq, Strides sk,
                            Strides sv, Strides so, float scale) {
  constexpr int LD = DH + 1;     // padded row stride of the k tile
  extern __shared__ float smem[];
  float* Qs = smem;              // [g][DH]
  float* Ks = Qs + g * DH;       // [kBK][LD]
  float* Vs = Ks + kBK * LD;     // [kBK][DH]
  float* Ps = Vs + kBK * DH;     // [g][kBK]
  float* m_row = Ps + g * kBK;   // [g] running max
  float* l_row = m_row + g;      // [g] running denominator
  float* a_row = l_row + g;      // [g] this tile's rescale

  const int kh = blockIdx.x;
  const int bb = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp, warp = tid / kWarp;
  const int n_out = g * DH;
  const int len = min(lengths[bb], T_len);
  // The run's first slot, in [0, T): slot (start + j) mod T for j < len.
  const int start =
      starts != nullptr ? ((starts[bb] % T_len) + T_len) % T_len : 0;

  const T* qb = q + bb * sq.b + (kh * g) * sq.h;
  const T* kb = kc + bb * sk.b + kh * sk.h;
  const T* vb = vc + bb * sv.b + kh * sv.h;
  T* ob = o + bb * so.b + (kh * g) * so.h;

  for (int e = tid; e < n_out; e += kThreads) {
    const int i = e / DH, d = e % DH;
    Qs[e] = to_f32(qb[i * sq.h + d]);
  }
  for (int i = tid; i < g; i += kThreads) {
    m_row[i] = kNegInf;
    l_row[i] = 0.0f;
  }
  float acc[kMaxOut];
#pragma unroll
  for (int r = 0; r < kMaxOut; ++r) acc[r] = 0.0f;

  for (int k0 = 0; k0 < len; k0 += kBK) {
    __syncthreads();             // the last tile is consumed; Qs, m, l set
    for (int e = tid; e < kBK * DH; e += kThreads) {
      const int r = e / DH, d = e % DH;
      const int jk = k0 + r;
      const bool in = jk < len;
      const int slot = start + jk < T_len ? start + jk : start + jk - T_len;
      Ks[r * LD + d] = in ? to_f32(kb[slot * sk.s + d]) : 0.0f;
      Vs[r * DH + d] = in ? to_f32(vb[slot * sv.s + d]) : 0.0f;
    }
    __syncthreads();

    for (int e = tid; e < g * kBK; e += kThreads) {
      const int i = e / kBK, j = e % kBK;
      const float* qi = Qs + i * DH;
      const float* kj = Ks + j * LD;
      float s = 0.0f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) s = fmaf(qi[d], kj[d], s);
      Ps[e] = k0 + j < len ? s * scale : kNegInf;
    }
    __syncthreads();

    for (int i = warp; i < g; i += kWarps) {
      float* pi = Ps + i * kBK;
      float mx = kNegInf;
      for (int j = lane; j < kBK; j += kWarp) mx = fmaxf(mx, pi[j]);
#pragma unroll
      for (int off = kWarp / 2; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_row[i];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int j = lane; j < kBK; j += kWarp) {
        const float p = k0 + j < len ? expf(pi[j] - m_new) : 0.0f;
        pi[j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = kWarp / 2; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_row[i] = alpha;
        l_row[i] = alpha * l_row[i] + sum;
        m_row[i] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kMaxOut; ++r) {
      const int e = tid + r * kThreads;
      if (e < n_out) {
        const int i = e / DH, d = e % DH;
        const float* pi = Ps + i * kBK;
        float a = acc[r] * a_row[i];
#pragma unroll 8
        for (int j = 0; j < kBK; ++j) a = fmaf(pi[j], Vs[j * DH + d], a);
        acc[r] = a;
      }
    }
  }
  __syncthreads();               // l is final (also when no tile ran)

#pragma unroll
  for (int r = 0; r < kMaxOut; ++r) {
    const int e = tid + r * kThreads;
    if (e < n_out) {
      const int i = e / DH, d = e % DH;
      ob[i * so.h + d] = from_f32<T>(acc[r] / fmaxf(l_row[i], 1e-30f));
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* kc, const void* vc, const int* lengths,
           const int* starts, void* o, int B, int H, int KH, int T_len,
           const long long* st, float scale, void* stream) {
  const int g = H / KH;
  const size_t smem = smem_bytes(g, DH);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides sq{st[0], st[1], 0}, sk{st[2], st[3], st[4]},
      sv{st[5], st[6], st[7]}, so{st[8], st[9], 0};
  const dim3 grid(KH, B);
  decode_attention_kernel<T, DH>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(q), static_cast<const T*>(kc),
          static_cast<const T*>(vc), lengths, starts, static_cast<T*>(o), g,
          T_len, sq, sk, sv, so, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* kc, const void* vc,
             const int* lengths, const int* starts, void* o, int B, int H,
             int KH, int T_len, int dh, const long long* st, float scale,
             void* stream) {
  switch (dh) {
    case 32:
      return launch<T, 32>(q, kc, vc, lengths, starts, o, B, H, KH, T_len,
                           st, scale, stream);
    case 64:
      return launch<T, 64>(q, kc, vc, lengths, starts, o, B, H, KH, T_len,
                           st, scale, stream);
    case 128:
      return launch<T, 128>(q, kc, vc, lengths, starts, o, B, H, KH, T_len,
                            st, scale, stream);
    case 256:
      return launch<T, 256>(q, kc, vc, lengths, starts, o, B, H, KH, T_len,
                            st, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// o = decode attention of q against the valid slots of each row's caches,
// on `stream`: (starts[b] + j) mod T for j < lengths[b], where starts may
// be null (zeros).  The group's g * dh outputs are at most 16 x 256
// (kMaxOut per thread), and its shared memory within a block's limit; the
// wrapper checks both.  q, o: [B, H, dh]; k_cache, v_cache: [B, KH, T, dh],
// H % KH == 0; lengths, starts: [B] int32 on the device.  f32 (bf16 = 0)
// or bf16 (bf16 = 1), all of one type.  `strides` holds 10 element
// strides: (batch, head) of q, (batch, head, row) of k_cache and v_cache,
// (batch, head) of o; the head dim is contiguous.  dh is 32, 64, 128 or
// 256.  Returns the cudaError_t of the launch (0 = success).
int decode_attention_launch(const void* q, const void* k_cache,
                            const void* v_cache, const void* lengths,
                            const void* starts, void* o,
                            int B, int H, int KH, int T_len, int dh,
                            const long long* strides, float scale, int bf16,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int* lens = static_cast<const int*>(lengths);
  const int* st = static_cast<const int*>(starts);
  if (bf16) {
    return dispatch<__nv_bfloat16>(q, k_cache, v_cache, lens, st, o, B, H,
                                   KH, T_len, dh, strides, scale, stream);
  }
  return dispatch<float>(q, k_cache, v_cache, lens, st, o, B, H, KH, T_len,
                         dh, strides, scale, stream);
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
