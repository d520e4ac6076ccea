// Hand-written Hopper (sm_90a) kernels for the backward of flash attention.
//
// Replaces the TPU kernel repro/kernels/flash_attention_bwd.py::
// flash_attention_bwd, which runs two Pallas kernels (FlashAttention-2):
// _dq_kernel walks the kv blocks of one q tile along a sequential grid
// axis, _dkv_kernel the q blocks of one kv tile, each accumulating in VMEM
// scratch, over the *expanded* H heads, and the wrapper then sums dk, dv
// over each GQA group.  Per query row i and key j of kv head h // g:
//
//   delta_i = sum_d o_id do_id                       (f32)
//   p_ij    = exp(s_ij - lse_i) under the forward's mask, else 0, with
//             s_ij = (q_i . k_j) * scale recomputed as the forward does
//   ds_ij   = p_ij (do_i . v_j - delta_i) * scale
//   dq_i    = sum_j ds_ij k_j,  dk_j = sum_i ds_ij q_i,  dv_j = sum_i p_ij do_i
//
// The mask is the forward's: j < T, i < S, and under `causal` j <= i and,
// with a `window`, j > i - window.  A row that no key may see has lse =
// +inf (flash_attention.cu), so its p, and every gradient of it, is 0.
//
// Layout: q, o, do, dq are [B, H, S, dh] and k, v, dk, dv [B, K, T, dh],
// each given by its three outer strides in elements (the head dim is
// contiguous), so the model's transposed views pass without a copy; lse
// and delta are contiguous [B, H, S] f32.  f32 or bf16 inputs; dq comes out
// in q's type, dk and dv in k's.
//
// What bounds it on this card: at recurrentgemma-2b's training shape
// (B=1, H=10, K=1, S=T=4096, dh=256, window 2048, bf16) one call moves
// 92.6 MB (0.028 ms at 3.35 TB/s) and does 5 products over 6,292,480
// visible (i, j) pairs per head, 1.61e11 FLOP (0.163 ms on the bf16 tensor
// cores): it is bound by operations.  This first version does the products
// on the f32 pipes with explicit fmaf and stages tiles in shared memory as
// f32 (no tensor cores, no TMA); wgmma tiles come in a later change.
//
// What the design does:
// * delta: one warp per row, a shuffle sum; a launch of its own.
// * dq: one block of 256 threads per (q tile of 64 rows, q head, batch);
//   a loop over the kv tiles that the mask reaches takes the place of the
//   TPU's sequential grid axis.  Thread (ty, tx) of a 16 x 16 grid owns
//   query rows ty + 16 r and keys tx + 16 c of each score tile, and dq
//   columns tx + 16 c, accumulated in registers over the whole loop.
// * dk/dv: one block per (kv tile, *kv* head, batch); it loops over the g
//   q heads of the group and, for each, over the q tiles that the mask
//   reaches, and accumulates dk and dv in registers across the whole
//   group, so the group sum happens in the kernel and nothing of size
//   [B, H, T, dh] is written.  Thread (ty, tx) owns keys ty + 16 r and
//   queries tx + 16 c of each score tile, and dk, dv columns tx + 16 c.
// * No atomics: every output element is written by one thread once, so
//   the result is deterministic (a resumed run repeats an uninterrupted
//   one).
// * A tile wholly above the diagonal or wholly left of the window is never
//   visited (the TPU kernel's block test, flash_attention_bwd.py:86-90, on
//   this kernel's tiles).  Ragged S and T are masked, not asserted: the
//   TPU kernel floors S and T to its blocks.
// * Shared memory: tiles are staged as f32 with rows padded to dh + 1
//   floats (16 threads reading 16 rows at one column hit 16 banks).  At
//   dh 256 the kv tile is 32 rows, so dq takes 205,824 B and dk/dv
//   214,016 B of the 232,448 a block may have, and the register
//   accumulators stay at 64 floats a thread; below dh 256 both tiles are
//   64 rows.
// * The probabilities (dk/dv) and dS go through shared memory from the
//   score layout to the product layout; only the half-warp that owns a
//   row reads it, so a warp barrier suffices there.
//
// Numerics: f32 throughout; the score products accumulate over d in order
// with fmaf, exactly as the forward kernel's, so p is the forward's
// softmax; the scale enters the scores and dS once each and is not applied
// again to dq or dk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTX = 16;          // thread grid: 16 x 16
constexpr int kTY = 16;
constexpr int kThreads = kTX * kTY;

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

__device__ __forceinline__ bool visible(int i, int j, int S, int T_len,
                                        int causal, int window) {
  return i < S && j < T_len &&
         (!causal || (j <= i && (!window || j > i - window)));
}

// Stage rows [r0, r0 + ROWS) of one head into a padded f32 tile (zeros
// past `n`).
template <typename T, int DH, int ROWS>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      long long stride, int r0, int n) {
  constexpr int LD = DH + 1;
  for (int e = threadIdx.x; e < ROWS * DH; e += kThreads) {
    const int r = e / DH, d = e % DH;
    const int row = r0 + r;
    dst[r * LD + d] = row < n ? to_f32(src[row * stride + d]) : 0.0f;
  }
}

// delta_i = rowsum(o_i * do_i) in f32: one warp per row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, int S, int dh, Strides so,
                 Strides sdo) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int iq = blockIdx.x * (kThreads / 32) + warp;
  if (iq >= S) return;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const T* ob = o + bb * so.b + hh * so.h + iq * so.s;
  const T* db = dout + bb * sdo.b + hh * sdo.h + iq * sdo.s;
  float sum = 0.0f;
  for (int d = lane; d < dh; d += 32)
    sum = fmaf(to_f32(ob[d]), to_f32(db[d]), sum);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0)
    delta[(static_cast<long long>(bb) * gridDim.y + hh) * S + iq] = sum;
}

template <int DH, int BQ, int BK>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * static_cast<size_t>(BQ) * (DH + 1) +
                          2 * static_cast<size_t>(BK) * (DH + 1) +
                          static_cast<size_t>(BQ) * (BK + 1));
}

template <typename T, int DH, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int g, int S, int T_len, Strides sq,
              Strides sk, Strides sv, Strides sdo, Strides sdq, float scale,
              int causal, int window) {
  constexpr int LD = DH + 1;     // padded row stride of the staged tiles
  constexpr int LS = BK + 1;     // row stride of dS
  constexpr int RQ = BQ / kTY;   // query rows per thread
  constexpr int CK = BK / kTX;   // score columns per thread
  constexpr int CD = DH / kTX;   // dq columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][LD]
  float* Os = Qs + BQ * LD;      // do, [BQ][LD]
  float* Ks = Os + BQ * LD;      // [BK][LD]
  float* Vs = Ks + BK * LD;      // [BK][LD]
  float* Ss = Vs + BK * LD;      // dS, [BQ][LS]

  const int q0 = blockIdx.x * BQ;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const long long row0 = (static_cast<long long>(bb) * gridDim.y + hh) * S;

  stage<T, DH, BQ>(Qs, q + bb * sq.b + hh * sq.h, sq.s, q0, S);
  stage<T, DH, BQ>(Os, dout + bb * sdo.b + hh * sdo.h, sdo.s, q0, S);
  const T* kb = k + bb * sk.b + (hh / g) * sk.h;
  const T* vb = v + bb * sv.b + (hh / g) * sv.h;

  float lse_r[RQ], delta_r[RQ], acc[RQ][CD];
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int iq = q0 + ty + r * kTY;
    lse_r[r] = iq < S ? lse[row0 + iq] : __int_as_float(0x7f800000);
    delta_r[r] = iq < S ? delta[row0 + iq] : 0.0f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[r][c] = 0.0f;
  }

  // The kv tiles this q tile sees: causal stops at its last row's
  // diagonal; a window starts at the tile holding its first row's
  // earliest key.
  int k_begin = 0, k_end = T_len;
  if (causal) {
    k_end = min(T_len, q0 + BQ);
    if (window) k_begin = max(0, q0 - window + 1) / BK * BK;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();             // the last tile's k, v, dS are consumed
    stage<T, DH, BK>(Ks, kb, sk.s, k0, T_len);
    stage<T, DH, BK>(Vs, vb, sv.s, k0, T_len);
    __syncthreads();

    float sc[RQ][CK], dp[RQ][CK];
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int c = 0; c < CK; ++c) sc[r][c] = dp[r][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[RQ], ov[RQ], kv[CK], vv[CK];
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        qv[r] = Qs[(ty + r * kTY) * LD + d];
        ov[r] = Os[(ty + r * kTY) * LD + d];
      }
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        kv[c] = Ks[(tx + c * kTX) * LD + d];
        vv[c] = Vs[(tx + c * kTX) * LD + d];
      }
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int c = 0; c < CK; ++c) {
          sc[r][c] = fmaf(qv[r], kv[c], sc[r][c]);
          dp[r][c] = fmaf(ov[r], vv[c], dp[r][c]);
        }
    }

#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      const int row = ty + r * kTY;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const int col = tx + c * kTX;
        const float p = visible(q0 + row, k0 + col, S, T_len, causal, window)
                            ? expf(sc[r][c] * scale - lse_r[r])
                            : 0.0f;
        Ss[row * LS + col] = p * (dp[r][c] - delta_r[r]) * scale;
      }
    }
    __syncwarp();                // a row's dS: its half-warp's

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float sv[RQ], kv[CD];
#pragma unroll
      for (int r = 0; r < RQ; ++r) sv[r] = Ss[(ty + r * kTY) * LS + kk];
#pragma unroll
      for (int c = 0; c < CD; ++c) kv[c] = Ks[kk * LD + tx + c * kTX];
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[r][c] = fmaf(sv[r], kv[c], acc[r][c]);
    }
  }

  T* db = dq + bb * sdq.b + hh * sdq.h;
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int iq = q0 + ty + r * kTY;
    if (iq >= S) continue;
#pragma unroll
    for (int c = 0; c < CD; ++c)
      db[iq * sdq.s + tx + c * kTX] = from_f32<T>(acc[r][c]);
  }
}

template <int DH, int BQ, int BK>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (2 * static_cast<size_t>(BK) * (DH + 1) +
                          2 * static_cast<size_t>(BQ) * (DH + 1) +
                          2 * static_cast<size_t>(BK) * (BQ + 1) +
                          2 * static_cast<size_t>(BQ));
}

template <typename T, int DH, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk,
               T* __restrict__ dv, int H, int g, int S, int T_len,
               Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
               Strides sdv, float scale, int causal, int window) {
  constexpr int LD = DH + 1;     // padded row stride of the staged tiles
  constexpr int LP = BQ + 1;     // row stride of P^T and dS^T
  constexpr int RK = BK / kTY;   // keys per thread
  constexpr int CQ = BQ / kTX;   // score columns (queries) per thread
  constexpr int CD = DH / kTX;   // dk, dv columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;              // [BK][LD]
  float* Vs = Ks + BK * LD;      // [BK][LD]
  float* Qs = Vs + BK * LD;      // [BQ][LD]
  float* Os = Qs + BQ * LD;      // do, [BQ][LD]
  float* Ps = Os + BQ * LD;      // P^T, [BK][LP]
  float* Ss = Ps + BK * LP;      // dS^T, [BK][LP]
  float* Ls = Ss + BK * LP;      // lse of the q tile's rows, [BQ]
  float* Dl = Ls + BQ;           // delta of the q tile's rows, [BQ]

  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y;
  const int bb = blockIdx.z;
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;

  stage<T, DH, BK>(Ks, k + bb * sk.b + kvh * sk.h, sk.s, k0, T_len);
  stage<T, DH, BK>(Vs, v + bb * sv.b + kvh * sv.h, sv.s, k0, T_len);

  float acc_k[RK][CD], acc_v[RK][CD];
#pragma unroll
  for (int r = 0; r < RK; ++r)
#pragma unroll
    for (int c = 0; c < CD; ++c) acc_k[r][c] = acc_v[r][c] = 0.0f;

  // The q tiles that see this kv tile: causal starts at the tile holding
  // its first key's diagonal and, with a window, ends past its last key's
  // latest query.
  int q_begin = 0, q_end = S;
  if (causal) {
    q_begin = k0 / BQ * BQ;
    if (window) q_end = min(S, k0 + BK - 1 + window);
  }

  for (int gi = 0; gi < g; ++gi) {
    const int hh = kvh * g + gi;
    const T* qb = q + bb * sq.b + hh * sq.h;
    const T* ob = dout + bb * sdo.b + hh * sdo.h;
    const long long row0 = (static_cast<long long>(bb) * H + hh) * S;
    for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
      __syncthreads();           // the last tile's q, do, P, dS consumed
      stage<T, DH, BQ>(Qs, qb, sq.s, q0, S);
      stage<T, DH, BQ>(Os, ob, sdo.s, q0, S);
      for (int r = threadIdx.x; r < BQ; r += kThreads) {
        const int iq = q0 + r;
        Ls[r] = iq < S ? lse[row0 + iq] : __int_as_float(0x7f800000);
        Dl[r] = iq < S ? delta[row0 + iq] : 0.0f;
      }
      __syncthreads();

      float sc[RK][CQ], dp[RK][CQ];
#pragma unroll
      for (int r = 0; r < RK; ++r)
#pragma unroll
        for (int c = 0; c < CQ; ++c) sc[r][c] = dp[r][c] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < DH; ++d) {
        float kv[RK], vv[RK], qv[CQ], ov[CQ];
#pragma unroll
        for (int r = 0; r < RK; ++r) {
          kv[r] = Ks[(ty + r * kTY) * LD + d];
          vv[r] = Vs[(ty + r * kTY) * LD + d];
        }
#pragma unroll
        for (int c = 0; c < CQ; ++c) {
          qv[c] = Qs[(tx + c * kTX) * LD + d];
          ov[c] = Os[(tx + c * kTX) * LD + d];
        }
#pragma unroll
        for (int r = 0; r < RK; ++r)
#pragma unroll
          for (int c = 0; c < CQ; ++c) {
            sc[r][c] = fmaf(qv[c], kv[r], sc[r][c]);
            dp[r][c] = fmaf(ov[c], vv[r], dp[r][c]);
          }
      }

#pragma unroll
      for (int r = 0; r < RK; ++r) {
        const int row = ty + r * kTY;
#pragma unroll
        for (int c = 0; c < CQ; ++c) {
          const int col = tx + c * kTX;
          const float p =
              visible(q0 + col, k0 + row, S, T_len, causal, window)
                  ? expf(sc[r][c] * scale - Ls[col])
                  : 0.0f;
          Ps[row * LP + col] = p;
          Ss[row * LP + col] = p * (dp[r][c] - Dl[col]) * scale;
        }
      }
      __syncwarp();              // a key's P and dS: its half-warp's

#pragma unroll 2
      for (int ii = 0; ii < BQ; ++ii) {
        float pv[RK], sv[RK], ov[CD], qv[CD];
#pragma unroll
        for (int r = 0; r < RK; ++r) {
          pv[r] = Ps[(ty + r * kTY) * LP + ii];
          sv[r] = Ss[(ty + r * kTY) * LP + ii];
        }
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          ov[c] = Os[ii * LD + tx + c * kTX];
          qv[c] = Qs[ii * LD + tx + c * kTX];
        }
#pragma unroll
        for (int r = 0; r < RK; ++r)
#pragma unroll
          for (int c = 0; c < CD; ++c) {
            acc_v[r][c] = fmaf(pv[r], ov[c], acc_v[r][c]);
            acc_k[r][c] = fmaf(sv[r], qv[c], acc_k[r][c]);
          }
      }
    }
  }

  T* kout = dk + bb * sdk.b + kvh * sdk.h;
  T* vout = dv + bb * sdv.b + kvh * sdv.h;
#pragma unroll
  for (int r = 0; r < RK; ++r) {
    const int jk = k0 + ty + r * kTY;
    if (jk >= T_len) continue;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      kout[jk * sdk.s + tx + c * kTX] = from_f32<T>(acc_k[r][c]);
      vout[jk * sdv.s + tx + c * kTX] = from_f32<T>(acc_v[r][c]);
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int H, int KH, int S, int T_len,
           const long long* st, float scale, int causal, int window,
           cudaStream_t stream) {
  constexpr int BQ = 64;
  constexpr int BK = DH == 256 ? 32 : 64;
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]},
      sdo{st[12], st[13], st[14]}, sdq{st[15], st[16], st[17]},
      sdk{st[18], st[19], st[20]}, sdv{st[21], st[22], st[23]};
  const int g = H / KH;

  delta_kernel<T><<<dim3((S + kThreads / 32 - 1) / (kThreads / 32), H, B),
                    kThreads, 0, stream>>>(static_cast<const T*>(o),
                                           static_cast<const T*>(dout),
                                           delta, S, DH, so, sdo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t dq_smem = dq_smem_bytes<DH, BQ, BK>();
  err = cudaFuncSetAttribute(dq_kernel<T, DH, BQ, BK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dq_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<T, DH, BQ, BK>
      <<<dim3((S + BQ - 1) / BQ, H, B), kThreads, dq_smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
          static_cast<T*>(dq), g, S, T_len, sq, sk, sv, sdo, sdq, scale,
          causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t dkv_smem = dkv_smem_bytes<DH, BQ, BK>();
  err = cudaFuncSetAttribute(dkv_kernel<T, DH, BQ, BK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dkv_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_kernel<T, DH, BQ, BK>
      <<<dim3((T_len + BK - 1) / BK, KH, B), kThreads, dkv_smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
          static_cast<T*>(dk), static_cast<T*>(dv), H, g, S, T_len, sq, sk,
          sv, sdo, sdk, sdv, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* delta, void* dq,
             void* dk, void* dv, int B, int H, int KH, int S, int T_len,
             int dh, const long long* st, float scale, int causal,
             int window, cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H,
                           KH, S, T_len, st, scale, causal, window, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H,
                           KH, S, T_len, st, scale, causal, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H,
                            KH, S, T_len, st, scale, causal, window, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H,
                            KH, S, T_len, st, scale, causal, window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// (dq, dk, dv) of attention on `stream`: three launches (delta, dq, dk/dv).
// q, o, do, dq: [B, H, S, dh]; k, v, dk, dv: [B, KH, T, dh], H % KH == 0;
// f32 (bf16 = 0) or bf16 (bf16 = 1), all of one type.  `strides` holds 24
// element strides: (batch, head, row) of q, k, v, o, do, dq, dk and dv in
// that order; the head dim is contiguous.  lse (the forward's) and delta
// (scratch, written here) are contiguous [B, H, S] f32.  dh is 32, 64, 128
// or 256.  Returns the cudaError_t of the launches (0 = success).
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const float* lse, float* delta, void* dq,
                               void* dk, void* dv, int B, int H, int KH,
                               int S, int T_len, int dh,
                               const long long* strides, float scale,
                               int causal, int window, int bf16, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return dispatch<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                   B, H, KH, S, T_len, dh, strides, scale,
                                   causal, window, s);
  }
  return dispatch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, KH,
                         S, T_len, dh, strides, scale, causal, window, s);
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
