// Hand-written Hopper (sm_90a) kernel for forward flash attention.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention,
// which walks the kv blocks of one (batch, q head, q block) output tile
// along a sequential grid axis and keeps the online-softmax state (running
// max m, denominator l, f32 accumulator) in VMEM scratch.  Per query row i
// against keys j of kv head h // g (GQA, no repeat of k / v):
//
//   s_ij = (q_i . k_j) * scale,  masked to -1e30 where j >= T, and under
//          `causal` where j > i, and with a `window` where j <= i - window
//   o_i  = sum_j softmax_j(s_ij) v_j,   f32 throughout, written in q's type
//
// Layout: q and o are [B, H, S, dh], k and v [B, K, T, dh], each given by
// its three outer strides in elements (the head dim is contiguous), so the
// model passes its [B, S, H, dh] / [B, T, K, dh] tensors as transposed
// views without a copy.  f32 or bf16 inputs.
//
// What bounds it on this card: at the serving shape (B=8, H=32, K=4,
// S=T=256, dh=128, bf16, causal) the bytes are ~37.7 MB (q, o 16.8 MB
// each, k, v 2.1 MB each), 0.0113 ms at 3.35 TB/s, above the ~4.3 GFLOP
// of the causal products on the tensor cores (0.0043 ms).  This first
// kernel does the products on the f32 pipes (no tensor cores), so the
// operations, not the bytes, hold it back: it is a correct baseline, and
// wgmma tiles fed by TMA are the next step.
//
// What the design does: one block of 256 threads per (q tile of 64 rows,
// q head, batch); a loop over kv tiles of 64 rows takes the place of the
// TPU's sequential grid axis.  The q tile is staged once in shared memory
// as f32; each kv tile is staged as f32 (k rows padded to dh + 1 floats,
// so the 16 threads reading 16 different k rows at one column hit 16
// banks).  Thread (ty, tx) of a 16 x 16 grid owns query rows ty + 16 r
// (r < 4): it computes their scores against keys tx + 16 c (c < 4), keeps
// their running max and denominator in registers (replicated across the
// 16 threads of the half-warp that share the rows, which reduce by
// shuffles), and accumulates output columns tx + 16 c (c < dh / 16).  The
// probabilities go through shared memory from the score layout to the
// P.V layout; only the half-warp that owns a row reads it, so a warp
// barrier suffices there.  A kv tile wholly above the diagonal or wholly
// left of the window is never visited (the TPU kernel's block test,
// flash_attention.py:51-56, on this kernel's tiles).  Ragged S and T are
// masked here, not asserted: rows past S are never stored, keys past T
// never weigh.  A row that no key may see gets zeros (the TPU kernel
// returns a mean of masked values there, the plain version NaN).
//
// Training also asks for the softmax's log-sum-exp rows, lse_i = m_i +
// log(l_i) in the scaled-score units, which the backward kernels
// (flash_attention_bwd.cu) recompute the probabilities from.  The block
// already holds m and l of its rows, so it writes them when `lse` is not
// NULL ([B, H, S] f32, contiguous); a row that no key may see gets +inf,
// so every probability and gradient of it is 0.  Serving passes NULL.
//
// Numerics: f32 scores and accumulation; the products accumulate with
// explicit fmaf (the port builds every source with -fmad=false, which
// only stops the compiler from contracting a separate multiply and add);
// softmax in the TPU kernel's order: m' = max(m, max_j s), alpha =
// exp(m - m'), l' = alpha l + sum p, o = acc / max(l, 1e-30).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per kv tile
constexpr int kTX = 16;          // thread grid: 16 x 16
constexpr int kTY = 16;
constexpr int kThreads = kTX * kTY;
constexpr int kRQ = kBQ / kTY;   // query rows per thread
constexpr int kCK = kBK / kTX;   // score columns per thread
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

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kBQ) * (DH + 1) +
                          static_cast<size_t>(kBK) * (DH + 1) +
                          static_cast<size_t>(kBK) * DH +
                          static_cast<size_t>(kBQ) * (kBK + 1));
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           float* __restrict__ lse, int g, int S, int T_len,
                           Strides sq, Strides sk, Strides sv, Strides so,
                           float scale, int causal, int window) {
  constexpr int LD = DH + 1;     // padded row stride of q and k tiles
  constexpr int LP = kBK + 1;    // row stride of the probabilities
  constexpr int CD = DH / kTX;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // [kBQ][LD]
  float* Ks = Qs + kBQ * LD;     // [kBK][LD]
  float* Vs = Ks + kBK * LD;     // [kBK][DH]
  float* Ps = Vs + kBK * DH;     // [kBQ][LP]

  const int q0 = blockIdx.x * kBQ;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;

  const T* qb = q + bb * sq.b + hh * sq.h;
  const T* kb = k + bb * sk.b + (hh / g) * sk.h;
  const T* vb = v + bb * sv.b + (hh / g) * sv.h;
  T* ob = o + bb * so.b + hh * so.h;

  for (int e = tid; e < kBQ * DH; e += kThreads) {
    const int r = e / DH, d = e % DH;
    const int iq = q0 + r;
    Qs[r * LD + d] = iq < S ? to_f32(qb[iq * sq.s + d]) : 0.0f;
  }

  float m[kRQ], l[kRQ], acc[kRQ][CD];
#pragma unroll
  for (int r = 0; r < kRQ; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[r][c] = 0.0f;
  }

  // The kv tiles this q tile sees: causal stops at its last row's
  // diagonal; a window starts at the tile holding its first row's
  // earliest key.
  int k_begin = 0, k_end = T_len;
  if (causal) {
    k_end = min(T_len, q0 + kBQ);
    if (window) k_begin = max(0, q0 - window + 1) / kBK * kBK;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();             // the last tile's k, v are consumed
    for (int e = tid; e < kBK * DH; e += kThreads) {
      const int r = e / DH, d = e % DH;
      const int jk = k0 + r;
      const bool in = jk < T_len;
      Ks[r * LD + d] = in ? to_f32(kb[jk * sk.s + d]) : 0.0f;
      Vs[r * DH + d] = in ? to_f32(vb[jk * sv.s + d]) : 0.0f;
    }
    __syncthreads();

    float sc[kRQ][kCK];
#pragma unroll
    for (int r = 0; r < kRQ; ++r)
#pragma unroll
      for (int c = 0; c < kCK; ++c) sc[r][c] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qv[kRQ], kv[kCK];
#pragma unroll
      for (int r = 0; r < kRQ; ++r) qv[r] = Qs[(ty + r * kTY) * LD + d];
#pragma unroll
      for (int c = 0; c < kCK; ++c) kv[c] = Ks[(tx + c * kTX) * LD + d];
#pragma unroll
      for (int r = 0; r < kRQ; ++r)
#pragma unroll
        for (int c = 0; c < kCK; ++c) sc[r][c] = fmaf(qv[r], kv[c], sc[r][c]);
    }

#pragma unroll
    for (int r = 0; r < kRQ; ++r) {
      const int row = ty + r * kTY;
      const int iq = q0 + row;
      bool ok[kCK];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kCK; ++c) {
        const int jk = k0 + tx + c * kTX;
        ok[c] = jk < T_len &&
                (!causal || (jk <= iq && (!window || jk > iq - window)));
        sc[r][c] = ok[c] ? sc[r][c] * scale : kNegInf;
        mx = fmaxf(mx, sc[r][c]);
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < kCK; ++c) {
        const float p = ok[c] ? expf(sc[r][c] - m_new) : 0.0f;
        Ps[row * LP + tx + c * kTX] = p;
        sum += p;
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = alpha * l[r] + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[r][c] *= alpha;
    }
    __syncwarp();                // a row's probabilities: its half-warp's

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[kRQ], vv[CD];
#pragma unroll
      for (int r = 0; r < kRQ; ++r) pv[r] = Ps[(ty + r * kTY) * LP + kk];
#pragma unroll
      for (int c = 0; c < CD; ++c) vv[c] = Vs[kk * DH + tx + c * kTX];
#pragma unroll
      for (int r = 0; r < kRQ; ++r)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[r][c] = fmaf(pv[r], vv[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < kRQ; ++r) {
    const int iq = q0 + ty + r * kTY;
    if (iq >= S) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < CD; ++c)
      ob[iq * so.s + tx + c * kTX] = from_f32<T>(acc[r][c] / den);
    if (lse != nullptr && tx == 0) {
      lse[(static_cast<long long>(bb) * gridDim.y + hh) * S + iq] =
          l[r] > 0.0f ? m[r] + logf(l[r]) : __int_as_float(0x7f800000);
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int KH, int S, int T_len, const long long* st,
           float scale, int causal, int window, void* stream) {
  const size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, DH>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(o), lse, H / KH, S, T_len,
          sq, sk, sv, so, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, int B, int H, int KH, int S, int T_len, int dh,
             const long long* st, float scale, int causal, int window,
             void* stream) {
  switch (dh) {
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, H, KH, S, T_len, st, scale,
                           causal, window, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, H, KH, S, T_len, st, scale,
                           causal, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, H, KH, S, T_len, st, scale,
                            causal, window, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, lse, B, H, KH, S, T_len, st, scale,
                            causal, window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// o = attention(q, k, v) on `stream`.  q, o: [B, H, S, dh]; k, v:
// [B, KH, T, dh], H % KH == 0; f32 (bf16 = 0) or bf16 (bf16 = 1), all of
// one type.  `strides` holds 12 element strides: (batch, head, row) of q,
// k, v and o in that order; the head dim is contiguous.  dh is 32, 64, 128
// or 256.  `lse` is NULL or a contiguous [B, H, S] f32 output of the
// rows' log-sum-exp.  Returns the cudaError_t of the launch (0 = success).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, float* lse, int B, int H, int KH, int S,
                           int T_len, int dh, const long long* strides,
                           float scale, int causal, int window, int bf16,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bf16) {
    return dispatch<__nv_bfloat16>(q, k, v, o, lse, B, H, KH, S, T_len, dh,
                                   strides, scale, causal, window, stream);
  }
  return dispatch<float>(q, k, v, o, lse, B, H, KH, S, T_len, dh, strides,
                         scale, causal, window, stream);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
